"""Sharded serving of the port (``repro_torch.serve.sharded``) against the
reference's (``repro.serve.sharded``) on ``make_dataset("cora", seed=0,
scale=0.1)`` at hidden 16, as ``tests/test_sharded_serve.py`` runs it.

* routing: routed k-hop subgraphs and the routing table equal the
  reference's; ``gather_rows`` and the ``HaloStats`` bytes too;
* planning: bounds, halo nodes, every FRDC field of every shard, the
  uniform dims and the ring schedule equal the reference's at P = 2 and 4;
  ``partition_rows``, ``align_tile`` and ``pad_frdc_uniform`` likewise;
* the layer program over one shard equals the family forward;
* the host executor's distributed pass against the reference's
  ``ShardedGraphSession(executor="host")`` at P = 2 and 4 for GCN "bin",
  GCN "full", SAGE and SAINT, unfused and fused: layer-1 packed words of
  GCN "bin" bit-equal, logits within rtol = atol = 1e-4 (fp32 summation
  order), predictions identical, ``HaloStats`` bytes per tag equal;
* ``bn_mode="distributed"`` stats against the reference's at 1e-5;
* routed ``serve_subgraph`` bit-exact against the port's single-host
  session for the same per-owner micro-batches, with no program added
  after warmup, and after a feature update;
* artifacts restore across the two packages both ways;
* ``executor="spmd"`` raises outside a world of P ranks.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402

from repro.core import frdc as jf  # noqa: E402
from repro.graphs import partition as jpart, sampling as js  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import GraphStore as JStore  # noqa: E402
from repro.serve import session_core as jsc  # noqa: E402
from repro.serve import sharded as jsh  # noqa: E402
tf = lazy("repro_torch.core.frdc")
td = lazy("repro_torch.graphs.datasets")
tpart = lazy("repro_torch.graphs.partition")
tg = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")
tsc = lazy("repro_torch.serve.session_core")
tsh = lazy("repro_torch.serve.sharded")
tsess_mod = lazy("repro_torch.serve.sharded.session")

jax.config.update("jax_platform_name", "cpu")

BATCH = 8
HIDDEN = 16
SHARD_COUNTS = (2, 4)
CONFIGS = [("gcn", "bin"), ("gcn", "full"), ("sage", "fixed"),
           ("saint", "fixed")]


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.1)


def _plan(mod, family, scheme, **kw):
    variants = (mod.GCN_SCHEME_VARIANTS[scheme] if family == "gcn"
                else mod.FIXED_VARIANTS)
    return mod.SessionPlan(family, scheme, layer_variants=variants, **kw)


def _params(family, data):
    pj = getattr(jg, f"init_{family}")(jax.random.PRNGKey(0),
                                       data.x.shape[1], HIDDEN,
                                       data.n_classes)
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


def _sessions(family, scheme, n_shards, data, fused=False, bn_mode=None):
    """(reference, port) sharded host sessions of one configuration."""
    jst, tst = _stores(family, data)
    kw = {} if bn_mode is None else dict(bn_mode=bn_mode)
    js_ = jsh.ShardedGraphSession(
        jst.graphs["g"], jst.models["m"], _plan(jsc, family, scheme),
        jsc.quantize_family(family, jst.models["m"].params),
        jsh.ShardPlanner(n_shards).plan(data, family), max_batch=BATCH, **kw)
    ts_ = tsh.ShardedGraphSession(
        tst.graphs["g"], tst.models["m"],
        _plan(tsc, family, scheme, fused=fused),
        tsc.quantize_family(family, tst.models["m"].params),
        tsh.ShardPlanner(n_shards).plan(tst.graphs["g"].data, family),
        max_batch=BATCH, use_pallas=True, device="cpu", **kw)
    return js_, ts_


def _port_bn(bn):
    return tuple((torch.from_numpy(np.array(m)), torch.from_numpy(np.array(s)))
                 for m, s in bn)


def _frdc_equal(tm, jm, what):
    assert (tm.n_rows, tm.n_cols, tm.nnz) == (jm.n_rows, jm.n_cols, jm.nnz), \
        what
    for f, a in tsc.frdc_to_host(tm).items():
        np.testing.assert_array_equal(a, np.asarray(jsc.frdc_arrays(jm)[f]),
                                      err_msg=f"{what} {f}")


def test_routing_matches_reference(data):
    """Routed k-hop subgraphs, the routing table and ``partition_rows``."""
    csr = js.to_csr(data.edges, data.n_nodes)
    rng = np.random.default_rng(0)
    for p in SHARD_COUNTS:
        bounds = tpart.shard_node_bounds(data.edges[0], data.n_nodes, p)
        np.testing.assert_array_equal(bounds, jpart.shard_node_bounds(
            data.edges[0], data.n_nodes, p))
        rt = tsh.RoutingTable(bounds)
        scsr = tsh.ShardedCSR.from_edges(data.edges, rt)
        for _ in range(4):
            seeds = np.unique(rng.integers(0, data.n_nodes, BATCH))
            want = js.khop_subgraph(csr, seeds, 2)
            for a, b in zip(tsh.routing.khop_subgraph(scsr, seeds, 2), want):
                np.testing.assert_array_equal(a, b)
        assert scsr.requests_by_shard.sum() > 0
        nodes = np.arange(data.n_nodes)
        owner = rt.owner(nodes)
        jrt = jsh.RoutingTable(bounds)
        np.testing.assert_array_equal(owner, jrt.owner(nodes))
        np.testing.assert_array_equal(rt.local(nodes), jrt.local(nodes))
        assert rt.to_json() == jrt.to_json()
        for kind in ("gcn", "mean", "binary"):
            tparts = tpart.partition_rows(data.edges[0], data.edges[1],
                                          data.n_nodes, p, kind, device="cpu")
            jparts = jpart.partition_rows(data.edges[0], data.edges[1],
                                          data.n_nodes, p, kind)
            for a, b in zip(tparts, jparts):
                assert (a.row_start, a.row_end) == (b.row_start, b.row_end)
                _frdc_equal(a.adj, b.adj, kind)
            assert tpart.shard_stats(tparts) == jpart.shard_stats(jparts)


def test_gather_rows_and_halo_stats():
    rt = tsh.RoutingTable(np.array([0, 8, 20, 32]))
    rng = np.random.default_rng(0)
    full = rng.standard_normal((32, 5)).astype(np.float32)
    blocks = [full[0:8], full[8:20], full[20:32]]
    nodes = np.array([31, 2, 9, 9, 19, 0])
    ts_, js_ = tsh.HaloStats(), jsh.HaloStats()
    out = tsh.gather_rows(blocks, rt, nodes, home=1, stats=ts_)
    want = jsh.gather_rows(blocks, jsh.RoutingTable(rt.bounds), nodes,
                           home=1, stats=js_)
    np.testing.assert_array_equal(out, want)
    assert ts_.snapshot() == js_.snapshot()
    vec = np.arange(32, dtype=np.float64)
    np.testing.assert_array_equal(
        tsh.gather_rows([vec[0:8], vec[8:20], vec[20:32]], rt, nodes),
        vec[nodes])


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_planner_matches_reference(data, n_shards):
    """Bounds, halo nodes, CSR rows, factorization slices, every FRDC field
    of every shard, the uniform dims and the ring schedule; the padded
    operands of ``pad_frdc_uniform`` too."""
    tdata = td.make_dataset("cora", seed=0, scale=0.1)
    for family in ("gcn", "sage", "saint"):
        tp = tsh.ShardPlanner(n_shards).plan(tdata, family)
        jp = jsh.ShardPlanner(n_shards).plan(data, family)
        np.testing.assert_array_equal(tp.routing.bounds, jp.routing.bounds)
        assert tp.spmd_plan().to_json() == jp.spmd_plan().to_json()
        assert tp.stats() == jp.stats()
        for a, b in zip(tp.parts, jp.parts):
            np.testing.assert_array_equal(a.halo_nodes, b.halo_nodes)
            np.testing.assert_array_equal(a.indptr, b.indptr)
            np.testing.assert_array_equal(a.indices, b.indices)
            if b.dinv is None:
                assert a.dinv is None
            else:
                np.testing.assert_array_equal(a.dinv, b.dinv)
            for kind in b.intra:
                _frdc_equal(a.intra[kind], b.intra[kind], (family, kind))
                _frdc_equal(a.halo[kind], b.halo[kind], (family, kind))
        sp = tp.spmd_plan()
        assert sp.mesh_plan.payload_bytes(7, 4) \
            == jp.spmd_plan().mesh_plan.payload_bytes(7, 4)
        assert tsh.halo.ring_perms(n_shards) == jsh.halo.ring_perms(n_shards)
        kind = next(iter(jp.parts[0].halo))
        assert tf.align_tile(5) == jf.align_tile(5) == 8
        padded = tf.pad_frdc_uniform([p.halo[kind] for p in tp.parts],
                                     sp.n_local_pad, sp.n_halo_pad,
                                     sp.halo_groups[kind])
        want = jf.pad_frdc_uniform([p.halo[kind] for p in jp.parts],
                                   sp.n_local_pad, sp.n_halo_pad,
                                   sp.halo_groups[kind])
        for a, b in zip(padded, want):
            _frdc_equal(a, b, (family, "padded"))


def test_layer_program_over_one_shard_is_the_forward(data):
    """At P = 1 (no halo) the layer program, run by the host executor
    under the session's BN, equals the family forward."""
    for family, scheme in CONFIGS:
        _, ts_ = _sessions(family, scheme, 1, data)
        got = ts_.full_logits()
        x = torch.from_numpy(data.x)
        d = ts_.graph.data
        adjs = {"gcn": {"adj": d.adjacency("gcn", "cpu"),
                        "bin": d.adjacency("binary", "cpu")},
                "sage": {"mean": d.adjacency("mean", "cpu")},
                "saint": {"sum": d.adjacency("binary", "cpu")}}[family]
        want = tsc.family_forward(ts_.plan, ts_.qparams, x, adjs,
                                  bn_stats=ts_.bn).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=scheme)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_host_pass_matches_reference(data, n_shards):
    """The distributed pass, unfused and fused, under the reference's BN."""
    for family, scheme in CONFIGS:
        for fused in (False, True):
            js_, ts_ = _sessions(family, scheme, n_shards, data, fused)
            want = js_.full_logits()
            ts_.sync()
            ts_.bn = _port_bn(js_.bn)
            got = np.concatenate(ts_.run_distributed_pass())
            what = (family, scheme, fused)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=str(what))
            np.testing.assert_array_equal(got.argmax(1), want.argmax(1),
                                          err_msg=str(what))
            # each pass added the same bytes under the same tags, and ran
            # the programs of the first
            half = {t: b // 2 for t, b in ts_.halo_stats.bytes_by_tag.items()}
            assert half == js_.halo_stats.bytes_by_tag, what
            assert ts_.executor_compile_count == 2 * len(ts_.program) - (
                family == "saint"), what
            if scheme == "bin":   # the packed layer-1 words, bit for bit
                tw, _ = ts_.layer_executor.run_pass(
                    ts_.program[:1], ts_._x_blocks(), ts_.bn)
                jw, _ = js_.layer_executor.run_pass(
                    js_.program[:1], js_._x_blocks(), js_.bn)
                for a, b in zip(tw, jw):
                    np.testing.assert_array_equal(a.view(np.uint32), b)
                assert ts_.halo_stats.bytes_by_tag["layer1/packed"] \
                    < ts_.halo_stats.bytes_by_tag["layer2/fp"]


def test_distributed_bn_matches_reference(data):
    """bn_mode="distributed": the stats come from the pass (moments over
    the shards' rows), equal to the reference's at 1e-5, and serve the
    same predictions."""
    for family in ("gcn", "sage"):
        js_, ts_ = _sessions(family, "bin" if family == "gcn" else "fixed",
                             2, data, bn_mode="distributed")
        want, got = js_.full_logits(), ts_.full_logits()
        assert len(ts_.bn) == len([s for s in ts_.program
                                   if s.bn_site is not None])
        for (tm, tsd), (jm, jsd) in zip(ts_.bn, js_.bn):
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    # the first site's stats are the moments of the graph's features
    x = torch.from_numpy(data.x)
    mu, sd = tsc.distributed_moments([x[:100], x[100:]])
    np.testing.assert_allclose(mu.numpy(), data.x.mean(0, keepdims=True),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sd.numpy(), data.x.std(0, keepdims=True)
                               + tsc.BN_EPS, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts_.bn[0][1].numpy(), sd.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_routed_serve_bit_exact_vs_single_host(data):
    """Each owner's micro-batch equals the single-host session's answer for
    it, bit for bit, at P = 2 and 4, for every family; warmup leaves no
    program to add."""
    nodes = np.random.default_rng(1).integers(0, data.n_nodes, 3 * BATCH)
    for family in ("gcn", "sage", "saint"):
        _, tst = _stores(family, data)
        single = tst.session("g", "m")
        for p in SHARD_COUNTS:
            sess = tst.sharded_session("g", "m", p)
            sess.warmup(np.random.default_rng(0), probes=2)
            c0 = sess.compile_count_by_shard
            for i in range(0, nodes.size, BATCH):
                batch = nodes[i:i + BATCH]
                owners = sess.routing.owner(batch)
                got = sess.serve_subgraph(batch)
                for o in np.unique(owners):
                    sel = owners == o
                    np.testing.assert_array_equal(
                        got[sel], single.serve_subgraph(batch[sel]))
            assert sess.compile_count_by_shard == c0, (family, p)
            assert sess.halo_stats.bytes_by_tag.get("serve/x", 0) > 0
    # a feature update recalibrates both sessions; the answers still match
    x2 = tst.graphs["g"].data.x.copy()
    x2[: data.n_nodes // 5] = 0.0
    tst.update_features("g", x2)
    got = sess.serve_subgraph(nodes[:BATCH])
    assert sess.invalidations == 1
    owners = sess.routing.owner(nodes[:BATCH])
    for o in np.unique(owners):
        sel = owners == o
        np.testing.assert_array_equal(
            got[sel], single.serve_subgraph(nodes[:BATCH][sel]))


@pytest.mark.parametrize("family", ["gcn", "saint"])
def test_artifacts_cross_packages(tmp_path, data, family):
    """A reference-saved sharded artifact restores into the port without
    re-partitioning (same routing, parts and plan) and serves the same
    predictions; a port-saved one restores into the reference."""
    jst, tst = _stores(family, data, dict(cache_dir=str(tmp_path / "j")),
                       dict(cache_dir=str(tmp_path / "j")))
    jsess = jst.sharded_session("g", "m", 2)
    tsess = tsh.ShardedGraphSession.load(
        tmp_path / "j" / "g__m__P2", tst.graphs["g"], tst.models["m"],
        khop=2, max_batch=BATCH, device="cpu")
    assert tsess is not None
    assert tsess.plan.to_json().keys() == jsess.plan.to_json().keys()
    np.testing.assert_array_equal(tsess.routing.bounds, jsess.routing.bounds)
    for a, b in zip(tsess.parts, jsess.parts):
        np.testing.assert_array_equal(a.halo_nodes, b.halo_nodes)
        for kind in b.intra:
            _frdc_equal(a.intra[kind], b.intra[kind], kind)
            _frdc_equal(a.halo[kind], b.halo[kind], kind)
    seeds = np.random.default_rng(3).integers(0, data.n_nodes, BATCH)
    for n in seeds:   # the halo-aware batching signature
        assert tsess.seed_halo_tiles(n) == jsess.seed_halo_tiles(n)
    want = np.asarray(jsess.serve_subgraph(seeds))
    tsess.sync()
    tsess.bn = _port_bn(jsess.bn)
    got = tsess.serve_subgraph(seeds)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    # and back: the port's save restores into the reference
    tsess.save(tmp_path / "t" / "g__m__P2")
    back = JStore(max_batch=BATCH, cache_dir=str(tmp_path / "t"))
    back.register_graph("g", data)
    back.register_model("m", family, jst.models["m"].params)
    restored = jsh.ShardedGraphSession.load(
        tmp_path / "t" / "g__m__P2", back.graphs["g"], back.models["m"])
    assert restored is not None
    np.testing.assert_array_equal(restored.routing.bounds,
                                  tsess.routing.bounds)
    np.testing.assert_array_equal(
        np.asarray(back.sharded_session("g", "m", 2)
                   .serve_subgraph(seeds)).argmax(1), want.argmax(1))
    # the port's store restores its own artifact without planning
    st2 = tserve.GraphStore(max_batch=BATCH, device="cpu",
                            cache_dir=str(tmp_path / "t"))
    st2.register_graph("g", td.make_dataset("cora", seed=0, scale=0.1))
    st2.register_model("m", family, tst.models["m"].params)
    s2 = st2.sharded_session("g", "m", 2)
    assert s2.shard_plan.spmd_plan().to_json() \
        == tsess.shard_plan.spmd_plan().to_json()
    np.testing.assert_array_equal(s2.serve_subgraph(seeds).argmax(1),
                                  want.argmax(1))


def test_spmd_executor_raises(data):
    """``executor="spmd"`` outside a world of P ranks raises
    ``RuntimeError``, naming the ranks it needs and ``run_ranks``, and
    never runs the host executor in its place; unknown names still raise
    ``ValueError``. (``tests/test_torch_spmd.py`` runs it in gloo worlds.)"""
    _, tst = _stores("gcn", data)
    with pytest.raises(RuntimeError, match="2 ranks.*run_ranks"):
        tst.sharded_session("g", "m", 2, executor="spmd")
    tsess_mod.check_modes("spmd", "single_host")
    with pytest.raises(ValueError, match="executor"):
        tst.sharded_session("g", "m", 2, executor="mesh")
    with pytest.raises(ValueError, match="bn_mode"):
        tst.sharded_session("g", "m", 2, bn_mode="frozen")
    assert tsess_mod.EXECUTORS == jsh.session.EXECUTORS
    assert not tst._sharded_sessions
    sess = tsh.ShardedGraphSession(
        tst.graphs["g"], tst.models["m"], _plan(tsc, "gcn", "bin"),
        tsc.quantize_family("gcn", tst.models["m"].params),
        tsh.ShardPlanner(2).plan(tst.graphs["g"].data, "gcn"),
        max_batch=BATCH, executor="spmd", device="cpu")
    with pytest.raises(RuntimeError, match="run_ranks"):
        sess.full_logits()
    assert sess._executor_obj is None and sess._caches is None
