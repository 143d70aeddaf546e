"""Single-host serving of the port (``repro_torch.serve``) against the
reference's (``repro.serve``) on ``make_dataset("cora", seed=0,
scale=0.1)``.

* ``graphs/sampling.py`` arrays identical to the reference's;
* a port ``GraphStore`` answers ``serve_subgraph`` and ``full_logits`` like
  the reference store for GCN, SAGE and SAINT: logits rtol = atol = 1e-4
  (summation order), predictions identical;
* bucket padding never changes an answer; zero programs added after warmup
  (the port's counterpart of zero jit retraces); incremental feature
  updates equal a frozen-stats full recompute;
* artifacts cross packages: a reference-saved artifact restores into the
  port and serves identical predictions, and the other way round;
* plan JSON, tuner cache and typed artifact errors as the reference's.
"""
import json

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402

from repro.graphs import sampling as js  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import GraphStore as JStore  # noqa: E402
from repro.serve import session_core as jsc  # noqa: E402
ts = lazy("repro_torch.graphs.sampling")
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")
tsc = lazy("repro_torch.serve.session_core")
tgs = lazy("repro_torch.serve.gnn_session")
ttc = lazy("repro_torch.serve.tuner_cache")

jax.config.update("jax_platform_name", "cpu")

BATCH = 8
HIDDEN = 16
FAMILIES = ["gcn", "sage", "saint"]


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.1)


def _params(family, data, seed=0):
    pj = getattr(jg, f"init_{family}")(jax.random.PRNGKey(seed),
                                       data.x.shape[1], HIDDEN, data.n_classes)
    return pj, tg.params_from_numpy(family, [np.asarray(w) for w in pj],
                                    "cpu")


def _stores(family, data, jkw=None, tkw=None):
    pj, pt = _params(family, data)
    jst = JStore(max_batch=BATCH, **(jkw or {}))
    jst.register_graph("g", data)
    jst.register_model("m", family, pj)
    tst = tserve.GraphStore(max_batch=BATCH, device="cpu", **(tkw or {}))
    tst.register_graph("g", td.make_dataset("cora", seed=0, scale=0.1))
    tst.register_model("m", family, pt)
    return jst, tst


def _same_plan(a, b) -> bool:
    """Equal plans (JSON text, so NaN latencies compare equal)."""
    return json.dumps(a.to_json()) == json.dumps(b.to_json())


def _port_bn(jsess):
    return tuple((torch.from_numpy(np.array(m)), torch.from_numpy(np.array(s)))
                 for m, s in jsess.bn)


def test_sampling_arrays_identical(data):
    csr_j = js.to_csr(data.edges, data.n_nodes)
    csr_t = ts.to_csr(data.edges, data.n_nodes)
    np.testing.assert_array_equal(csr_t.indptr, csr_j.indptr)
    np.testing.assert_array_equal(csr_t.indices, csr_j.indices)
    seeds = np.array([5, 1, 5, 200, 3])
    for k in (0, 1, 2):
        np.testing.assert_array_equal(ts.khop_nodes(csr_t, seeds, k),
                                      js.khop_nodes(csr_j, seeds, k))
    for got, want in zip(ts.extract_khop(csr_t, seeds, 2),
                         js.extract_khop(csr_j, seeds, 2)):
        np.testing.assert_array_equal(got, want)
    sub, edges, _ = js.khop_subgraph(csr_j, seeds, 2)
    np.testing.assert_array_equal(ts.induced_edges(csr_t, sub),
                                  js.induced_edges(csr_j, sub))
    for kind in ("gcn", "mean", "binary"):
        mj = js.subgraph_adjacency(sub, edges, kind)
        mt = ts.subgraph_adjacency(sub, edges, kind, device="cpu")
        for f, a in tsc.frdc_to_host(mt).items():
            np.testing.assert_array_equal(
                a, np.asarray(jsc.frdc_arrays(mj)[f]), err_msg=(kind, f))


@pytest.mark.parametrize("family", FAMILIES)
def test_store_serves_like_reference(data, family):
    jst, tst = _stores(family, data)
    jsess, tsess = jst.session("g", "m"), tst.session("g", "m")
    assert _same_plan(tsess.plan, jsess.plan)
    want_full = jsess.full_logits()
    got_full = tsess.full_logits()
    np.testing.assert_allclose(got_full, want_full, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_full.argmax(1), want_full.argmax(1))
    seeds = np.random.default_rng(1).integers(0, data.n_nodes, size=BATCH)
    tsess.bn = _port_bn(jsess)            # serve both under one calibration
    got = tsess.serve_subgraph(seeds)
    want = np.asarray(jsess.serve_subgraph(seeds))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_array_equal(got.argmax(1), want_full[seeds].argmax(1))


def test_bucket_padding_never_changes_answers():
    d = td.make_dataset("cora", seed=0, scale=0.1)
    _, pt = _params("gcn", make_dataset("cora", seed=0, scale=0.1))
    st = tserve.GraphStore(max_batch=BATCH, device="cpu")
    st.register_graph("g", d)
    st.register_model("m", "gcn", pt)
    sess = st.session("g", "m")
    seeds = np.array([3, 9, 11])
    small = sess.serve_subgraph(seeds)
    n_small = sess.core._n_water
    sess.core.preset_water(4 * n_small, {"adj": 4000, "bin": 4000}, 1.0)
    assert sess.core._n_water > n_small
    big = sess.serve_subgraph(seeds)
    np.testing.assert_array_equal(big, small)
    np.testing.assert_allclose(small, sess.full_logits()[seeds], rtol=1e-4,
                               atol=1e-4)


def test_zero_steady_state_recompiles():
    d = td.make_dataset("cora", seed=0, scale=0.1)
    _, pt = _params("sage", make_dataset("cora", seed=0, scale=0.1))
    st = tserve.GraphStore(max_batch=BATCH, device="cpu", use_pallas=True,
                           bspmm_block=(8, 32))
    st.register_graph("g", d)
    st.register_model("m", "sage", pt)
    sess = st.session("g", "m")
    seen = []
    sess.set_trace_hook(lambda label, shape: seen.append(shape))
    assert sess.warmup() >= 1 and len(seen) == sess.compile_count
    c0, rng = sess.compile_count, np.random.default_rng(5)
    for _ in range(6):
        sess.serve_subgraph(rng.integers(0, d.n_nodes,
                                         rng.integers(1, BATCH + 1)))
    assert sess.compile_count == c0 and len(seen) == c0
    # the prepare / launch / finish split adds no program either
    batch = sess.prepare_batch(rng.integers(0, d.n_nodes, BATCH))
    np.testing.assert_array_equal(batch.finish(batch.launch()),
                                  batch.finish(batch.launch()))
    assert sess.compile_count == c0


def test_incremental_update_matches_full_recompute():
    d = td.make_dataset("cora", seed=0, scale=0.1)
    _, pt = _params("gcn", make_dataset("cora", seed=0, scale=0.1))
    st = tserve.GraphStore(max_batch=BATCH, incremental=True, device="cpu")
    st.register_graph("g", d)
    st.register_model("m", "gcn", pt)
    sess = st.session("g", "m")
    before = sess.full_logits().copy()
    bn0 = sess.bn
    changed = np.array([3, 17, 40])
    x2 = d.x.copy()
    x2[changed] += 1.0
    st.update_features("g", x2)
    inc = sess.full_logits()
    assert sess.incremental_refreshes == 1 and sess.bn is bn0
    ref = sess.full_forward(torch.from_numpy(x2), bn0).numpy()
    affected = ts.khop_nodes(sess.graph.csr_rev, changed, 2)
    unaffected = np.setdiff1d(np.arange(d.n_nodes), affected)
    assert 0 < affected.size < d.n_nodes
    np.testing.assert_array_equal(inc[unaffected], before[unaffected])
    np.testing.assert_allclose(inc, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(inc.argmax(1), ref.argmax(1))
    x3 = x2.copy()                  # a large update: the full-pass branch
    x3[: d.n_nodes // 2] -= 0.5
    st.update_features("g", x3)
    np.testing.assert_allclose(
        sess.full_logits(), sess.full_forward(torch.from_numpy(x3),
                                              bn0).numpy(),
        rtol=1e-5, atol=1e-5)
    assert sess.incremental_refreshes == 2


@pytest.mark.parametrize("family", FAMILIES)
def test_artifacts_cross_packages(tmp_path, data, family):
    """A reference-saved artifact restores into the port (no re-encode,
    same plan) and serves identical predictions; a port-saved one restores
    into the reference."""
    kw = dict(use_pallas=True, bspmm_block=(8, 32))
    jst, tst = _stores(family, data, dict(cache_dir=str(tmp_path / "j"), **kw),
                       dict(cache_dir=str(tmp_path / "j"), **kw))
    jsess = jst.session("g", "m")
    loaded = tgs.CompiledGraphSession.load(
        tmp_path / "j" / "g__m", tst.graphs["g"], tst.models["m"],
        khop=2, max_batch=BATCH, device="cpu")
    assert loaded is not None
    assert _same_plan(loaded.plan, jsess.plan)
    tsess = tst.session("g", "m")
    seeds = np.random.default_rng(3).integers(0, data.n_nodes, size=BATCH)
    want = np.asarray(jsess.serve_subgraph(seeds))
    tsess.sync()
    tsess.bn = _port_bn(jsess)
    got = tsess.serve_subgraph(seeds)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))

    tsess.save(tmp_path / "t" / "g__m")
    back = JStore(max_batch=BATCH, cache_dir=str(tmp_path / "t"), **kw)
    back.register_graph("g", data)
    back.register_model("m", family, jst.models["m"].params)
    from repro.serve.gnn_session import CompiledGraphSession as JSession
    assert JSession.load(tmp_path / "t" / "g__m", back.graphs["g"],
                         back.models["m"]) is not None
    np.testing.assert_array_equal(
        np.asarray(back.session("g", "m").serve_subgraph(seeds)).argmax(1),
        want.argmax(1))


def test_plan_json_tuner_and_artifact_errors(tmp_path):
    p = tsc.SessionPlan("gcn", "bin", bspmm_block=(8, 64), fused=True)
    q = jsc.SessionPlan("gcn", "bin", bspmm_block=(8, 64), fused=True)
    assert p.name() == q.name() and _same_plan(p, q)
    assert _same_plan(tsc.SessionPlan.from_json(
        json.loads(json.dumps(q.to_json()))), p)
    d = td.make_dataset("cora", seed=0, scale=0.05)
    _, pt = _params("gcn", make_dataset("cora", seed=0, scale=0.05))
    plan = tsc.tune_plan(d, "gcn", tsc.quantize_family("gcn", pt), repeats=1,
                         device="cpu")
    assert plan.scheme in ("bin", "full") and np.isfinite(plan.tuned_latency_s)
    # typed corruption errors; a missing artifact is None (rebuild)
    assert tsc.load_sidecar(tmp_path / "plan.json") is None
    (tmp_path / "plan.json").write_text("{trunc")
    with pytest.raises(tsc.ArtifactError, match="field 'json'"):
        tsc.load_sidecar(tmp_path / "plan.json")
    (tmp_path / "plan.json").write_text('{"plan": {}}')
    with pytest.raises(tsc.ArtifactError, match="field 'khop'"):
        tsc.load_sidecar(tmp_path / "plan.json", required=("plan", "khop"))
    step = tmp_path / "step_00000000"
    step.mkdir()
    (step / "manifest.json").write_text('{"keys": []}')
    with pytest.raises(tsc.ArtifactError, match="n_leaves"):
        tsc.restore_artifact_state(tmp_path, tsc.adj_like("saint"))


def test_tuner_cache_roundtrip_and_store_seeding(tmp_path):
    path = tmp_path / "cache.json"
    cache = ttc.TunerCache(path)
    stats = dict(n_nodes=100, n_edges=400, n_feat=32)
    cache.record(stats, (8, 64), 2e-3, fused=False, backend="cpu")
    cache.record(stats, None, 1e-3, fused=False, backend="cpu")
    cache.record(stats, (4, 32), 3e-3, fused=True, backend="cpu")
    reloaded = ttc.TunerCache(path)
    assert reloaded.lookup(stats, fused=False, backend="cpu") is None
    assert reloaded.lookup(stats, fused=True, backend="cpu") == (4, 32)
    assert reloaded.lookup(stats, fused=False, backend="cuda") is None
    from repro.serve.tuner_cache import entry_key
    assert set(reloaded.entries) == {
        entry_key(stats, b, "cpu", f)
        for b, f in (((8, 64), False), (None, False), ((4, 32), True))}
    path.write_text("not json")
    assert ttc.TunerCache(path).entries == {}
    d = td.make_dataset("cora", seed=0, scale=0.05)
    cache = ttc.TunerCache(path)
    cache.record(ttc.graph_stats(d), (8, 64), 1e-3, backend="cpu")
    cache.record(ttc.graph_stats(d), (4, 32), 9e-3, backend="cpu")
    _, pt = _params("gcn", make_dataset("cora", seed=0, scale=0.05))
    for block, want in ((None, (8, 64)), ((4, 32), (4, 32))):
        st = tserve.GraphStore(max_batch=BATCH, use_pallas=True,
                               tuner_cache=str(path), bspmm_block=block,
                               device="cpu")
        st.register_graph("g", d)
        st.register_model("m", "gcn", pt)
        assert st.session("g", "m").plan.bspmm_block == want
