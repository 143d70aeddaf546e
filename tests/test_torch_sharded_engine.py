"""The port's sharded engine (``repro_torch.serve.ShardedServeEngine``)
against the reference's on ``make_dataset("cora", seed=0, scale=0.1)``,
the port on the CPU with the host layer executor.

Identical in both packages for the same submissions: the served batches
(single-owner, halo-aware formation under the staleness bound, or strict
FIFO), ``halo_tiles_shared`` / ``halo_bytes_saved``, halo bytes by tag,
per-shard compile counters, dispatches, cost units with halo rows, and
predictions; logits within rtol = atol = 1e-4 under the reference's
calibration. Within the port: pipelined answers bit-equal to serial ones
and to the single-host session replaying ``batch_log``. The sessions'
observability hooks fire the reference's labels and shape keys.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402

from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import CostEstimator as JCost  # noqa: E402
from repro.serve import GraphStore as JStore  # noqa: E402
from repro.serve import ShardedServeEngine as JSharded  # noqa: E402
from repro.serve import session_core as jsc  # noqa: E402
from repro.serve.sharded import ShardedGraphSession as JSession  # noqa: E402
from repro.serve.sharded import ShardPlanner as JPlanner  # noqa: E402
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")
tsc = lazy("repro_torch.serve.session_core")
tgs = lazy("repro_torch.serve.gnn_session")
tsh = lazy("repro_torch.serve.sharded")

jax.config.update("jax_platform_name", "cpu")

BATCH = 8
HIDDEN = 16


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.1)


@pytest.fixture(scope="module")
def stores(data):
    jst = JStore(max_batch=BATCH)
    jst.register_graph("g", data)
    tst = tserve.GraphStore(max_batch=BATCH, device="cpu")
    tst.register_graph("g", td.make_dataset("cora", seed=0, scale=0.1))
    for fam in ("gcn", "sage"):
        pj = getattr(jg, f"init_{fam}")(jax.random.PRNGKey(0),
                                        data.x.shape[1], HIDDEN,
                                        data.n_classes)
        jst.register_model(fam, fam, pj)
        tst.register_model(fam, fam, tg.params_from_numpy(
            fam, [np.asarray(w) for w in pj], "cpu"))
    return jst, tst


def _port_bn(bn):
    return tuple((torch.from_numpy(np.array(m)),
                  torch.from_numpy(np.array(s))) for m, s in bn)


def _align(jst, tst, model, n_shards):
    """Serve the port's sharded and single-host subgraph paths under the
    reference's frozen BN stats."""
    tst.sharded_session("g", model, n_shards).bn = _port_bn(
        jst.sharded_session("g", model, n_shards).bn)
    tst.session("g", model).bn = _port_bn(jst.session("g", model).bn)


def _halo_bytes(engine, model):
    sess = engine._get_session(("g", model))
    return dict(sess.halo_stats.bytes_by_tag)


def _run(engine, model, nodes, align=None):
    engine.warmup("g", model, probes=4)
    if align is not None:
        align()
    h0 = _halo_bytes(engine, model)
    d0 = engine.dispatch_count
    qs = engine.submit_many("g", model, nodes)
    engine.run_until_drained()
    engine.close()
    assert all(q.done for q in qs)
    snap = engine.snapshot()
    return dict(
        keys=set(snap), config=set(engine.engine_config()),
        halo={k: b - h0.get(k, 0)
              for k, b in _halo_bytes(engine, model).items()},
        logits=np.stack([q.logits for q in qs]),
        preds=[q.pred for q in qs],
        log=[[q.qid for q in b] for b in engine.batch_log],
        units=[None if q.cost is None else q.cost.units for q in qs],
        stats={k: snap[k] for k in (
            "batches", "queries", "subgraph_queries", "compiles_by_shard",
            "halo_tiles_shared", "halo_bytes_saved",
            "whale_splits", "executor_compiles")},
        dispatches=engine.dispatch_count - d0)


def _same(got, want):
    for k in ("log", "units", "stats", "halo", "dispatches", "preds", "keys",
              "config"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("model,n_shards", [("gcn", 2), ("gcn", 4),
                                            ("sage", 2)])
def test_sharded_engine_matches_reference(stores, data, model, n_shards):
    """Serial sharded engines with a cost model in both packages serve the
    same batches with the same halo and compile counters, snapshot and
    config keys; the port's pipelined engine is bit-equal to its serial
    one and to the single-host session replaying each batch."""
    jst, tst = stores
    nodes = np.random.default_rng(2).integers(0, data.n_nodes,
                                              size=5 * BATCH)
    kw = dict(max_batch=BATCH, staleness_s=600.0)
    want = _run(JSharded(jst, n_shards, cost=JCost(), **kw), model, nodes)
    align = lambda: _align(jst, tst, model, n_shards)  # noqa: E731
    got = _run(tserve.ShardedServeEngine(tst, n_shards,
                                         cost=tserve.CostEstimator(), **kw),
               model, nodes, align)
    _same(got, want)
    assert got["stats"]["halo_tiles_shared"] > 0
    engine = tserve.ShardedServeEngine(tst, n_shards, pipeline_depth=2, **kw)
    piped = _run(engine, model, nodes, align)
    np.testing.assert_array_equal(piped["logits"], got["logits"])
    single = tst.session("g", model)
    sess = tst.sharded_session("g", model, n_shards)
    for batch in engine.batch_log:
        seeds = np.asarray([q.node for q in batch])
        assert np.unique(sess.routing.owner(seeds)).size == 1
        np.testing.assert_array_equal(np.stack([q.logits for q in batch]),
                                      single.serve_subgraph(seeds))


def _halo_trio(sess):
    """(head, buddy, loner) of owner 0: buddy shares halo tiles with head,
    loner shares none."""
    lo, hi = sess.routing.shard_range(0)
    sigs = {n: sess.seed_halo_tiles(n) for n in range(lo, hi)}
    for a in sigs:
        for b in sigs:
            if a != b and sigs[a] & sigs[b]:
                for c in sigs:
                    if c not in (a, b) and not sigs[c] & sigs[a]:
                        return a, b, c
    raise AssertionError("no overlapping signatures")


@pytest.mark.parametrize("overdue", [False, True])
def test_halo_aware_formation_matches_reference(stores, overdue):
    """Formation co-batches the head's halo buddy ahead of an older
    non-overlapping seed, unless that seed is overdue past the staleness
    bound; both packages form the same batches and count the same shared
    tiles."""
    jst, tst = stores
    out = []
    for eng_cls, store in ((JSharded, jst),
                           (tserve.ShardedServeEngine, tst)):
        head, buddy, loner = _halo_trio(store.sharded_session("g", "gcn", 2))
        engine = eng_cls(store, 2, max_batch=2, staleness_s=0.5)
        engine.warmup("g", "gcn", probes=4)
        s0 = (engine.halo_tiles_shared, engine.halo_bytes_saved)
        engine.submit("g", "gcn", head)
        q_loner = engine.submit("g", "gcn", loner)
        engine.submit("g", "gcn", buddy)
        if overdue:
            q_loner.t_submit -= 10.0
        engine.run_until_drained()
        engine.close()
        out.append(([[q.node for q in b] for b in engine.batch_log],
                    engine.halo_tiles_shared - s0[0],
                    engine.halo_bytes_saved - s0[1]))
    assert out[1] == out[0]
    first = out[1][0][0]
    assert first == ([head, loner] if overdue else [head, buddy])


def test_fifo_fallback_and_multi_bucket(stores, data):
    """``halo_aware=False`` pops each owner queue in submission order and
    saves nothing; a pipelined multi-bucket sharded engine counts the
    reference's dispatches and programs and stays bit-equal to serial."""
    jst, tst = stores
    nodes = np.random.default_rng(3).integers(0, data.n_nodes,
                                              size=6 * BATCH)
    fifo = tserve.ShardedServeEngine(tst, 4, max_batch=BATCH,
                                     halo_aware=False)
    fifo.warmup("g", "gcn", probes=4)
    qs = fifo.submit_many("g", "gcn", nodes)
    fifo.run_until_drained()
    assert fifo.halo_bytes_saved == 0
    owner = tst.sharded_session("g", "gcn", 4).routing.owner
    want, got = {}, {}
    for q in qs:
        want.setdefault(int(owner(np.asarray([q.node]))[0]), []).append(q.qid)
    for b in fifo.batch_log:
        got.setdefault(int(owner(np.asarray([b[0].node]))[0]), []).extend(
            q.qid for q in b)
    assert got == want
    kw = dict(max_batch=BATCH, staleness_s=600.0, pipeline_depth=2,
              multi_bucket=True)
    jres = _run(JSharded(jst, 2, **kw), "gcn", nodes)
    align = lambda: _align(jst, tst, "gcn", 2)  # noqa: E731
    tres = _run(tserve.ShardedServeEngine(tst, 2, **kw), "gcn", nodes, align)
    _same(tres, jres)
    # one launch_many per serve core a tick touches: single-owner batches
    # of different owners do not share a dispatch
    assert tres["dispatches"] <= tres["stats"]["batches"]
    serial = _run(tserve.ShardedServeEngine(tst, 2, max_batch=BATCH,
                                            staleness_s=600.0), "gcn", nodes,
                  align)
    np.testing.assert_array_equal(tres["logits"], serial["logits"])


def test_session_trace_hooks_match_reference(stores):
    """A hook set before the first sync sees the host executor's layer
    programs (``executor/host/operand<i>`` then ``.../stage<i>``) and,
    in warmup, the per-shard cores' new shapes (``shard<i>/core``), with
    the reference's shape keys; ``dispatch_count`` moves with launches."""
    jst, tst = stores
    events = []
    for store, sc, planner, cls, kw in (
            (jst, jsc, JPlanner, JSession, {}),
            (tst, tsc, tsh.ShardPlanner, tsh.ShardedGraphSession,
             dict(device="cpu"))):
        g, m = store.graphs["g"], store.models["gcn"]
        params = m.params if store is jst else tgs._params_on(m.params,
                                                               "cpu")
        sess = cls(g, m, sc.default_plan("gcn"),
                   sc.quantize_family("gcn", params),
                   planner(2).plan(g.data, "gcn"), max_batch=BATCH, **kw)
        seen = []
        sess.set_trace_hook(lambda label, shape: seen.append((label, shape)))
        sess.sync()
        sess.warmup(np.random.default_rng(0), probes=2)
        assert sess.dispatch_count >= 1
        events.append(seen)
    assert events[1] == events[0]
    labels = [lb for lb, _ in events[1]]
    assert labels[:4] == ["executor/host/operand0", "executor/host/stage0",
                          "executor/host/operand1", "executor/host/stage1"]
    assert any(lb.startswith("shard") and lb.endswith("/core")
               for lb in labels)


def test_mesh_refused(stores):
    """A device mesh is refused until the multi-card slice ports its
    transport; ``mesh=None`` rides in ``engine_config`` as the
    reference's does."""
    _, tst = stores
    with pytest.raises(NotImplementedError, match="mesh"):
        tserve.ShardedServeEngine(tst, 2, mesh=object())
    cfg = tserve.ShardedServeEngine(tst, 2).engine_config()
    assert cfg["mesh"] is None and cfg["executor"] == "host"
