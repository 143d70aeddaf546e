"""The port's node-query engine (``repro_torch.serve.GNNServeEngine``)
against the reference's (``repro.serve.GNNServeEngine``) on
``make_dataset("cora", seed=0, scale=0.1)``, the port on the CPU.

The same submissions go to both engines. Identical: the served batches'
qids (``batch_log``), the counters ``batches`` / ``queries`` /
``full_cache_hits`` / ``subgraph_queries`` / ``compiles`` /
``dispatches``, the retry path's requeues and typed failures, the drain
report, and the predictions; logits within rtol = atol = 1e-4. Both
sessions serve under the reference's calibration (``_align_bn``), as
``test_torch_serve.py`` does. Within the port: the pipelined engine is
bit-equal to the serial one, a multi-bucket co-launch is bit-equal to
serial launches and counts one dispatch, light traffic drains through
``tick``, feature updates add no program after warmup, and the pipelined
engines adopt feature updates on the main thread only.
"""
import concurrent.futures
import threading

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402

from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import GNNServeEngine as JEngine  # noqa: E402
from repro.serve import GraphStore as JStore  # noqa: E402
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")

jax.config.update("jax_platform_name", "cpu")

BATCH = 8
HIDDEN = 16
FAMILIES = ["gcn", "sage", "saint"]
COUNTERS = ("batches", "queries", "full_cache_hits", "subgraph_queries",
            "requeues", "retry_shed", "drain_shed")


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.1)


def _stores(data, families=FAMILIES):
    jst = JStore(max_batch=BATCH)
    jst.register_graph("g", data)
    tst = tserve.GraphStore(max_batch=BATCH, device="cpu")
    tst.register_graph("g", td.make_dataset("cora", seed=0, scale=0.1))
    for fam in families:
        pj = getattr(jg, f"init_{fam}")(jax.random.PRNGKey(0),
                                        data.x.shape[1], HIDDEN,
                                        data.n_classes)
        jst.register_model(fam, fam, pj)
        tst.register_model(fam, fam, tg.params_from_numpy(
            fam, [np.asarray(w) for w in pj], "cpu"))
    return jst, tst


@pytest.fixture(scope="module")
def stores(data):
    return _stores(data)


def _align_bn(jst, tst, model):
    """Serve the port's subgraph path under the reference's frozen BN
    stats (independent calibrations differ at ~1e-6, which can flip a
    sign bit of a binarized activation)."""
    jsess, tsess = jst.session("g", model), tst.session("g", model)
    tsess.bn = tuple((torch.from_numpy(np.array(m)),
                      torch.from_numpy(np.array(s))) for m, s in jsess.bn)


def _drain(engine, model, nodes, align=None):
    c0, d0 = engine.compile_count, engine.dispatch_count
    engine.warmup("g", model, probes=4)
    if align is not None:
        align()
    qs = engine.submit_many("g", model, nodes)
    engine.run_until_drained()
    engine.close()
    assert all(q.done for q in qs)
    return dict(qs=qs, logits=np.stack([q.logits for q in qs]),
                preds=[q.pred for q in qs],
                log=[[q.qid for q in b] for b in engine.batch_log],
                counters={k: getattr(engine.metrics, k) for k in COUNTERS},
                compiles=engine.compile_count - c0,
                dispatches=engine.dispatch_count - d0)


def _same(got, want):
    """Port run ``got`` serves like reference run ``want``."""
    assert got["log"] == want["log"]
    assert got["counters"] == want["counters"]
    assert (got["compiles"], got["dispatches"]) == \
        (want["compiles"], want["dispatches"])
    assert got["preds"] == want["preds"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_matches_reference(stores, data, family):
    """Serial and pipelined port engines against the serial reference: the
    same batches, counters and answers; pipelining changes no bit."""
    jst, tst = stores
    nodes = np.random.default_rng(1).integers(0, data.n_nodes,
                                              size=5 * BATCH)
    want = _drain(JEngine(jst, max_batch=BATCH, mode="subgraph"), family,
                  nodes)
    align = lambda: _align_bn(jst, tst, family)  # noqa: E731
    serial = _drain(tserve.GNNServeEngine(tst, max_batch=BATCH,
                                          mode="subgraph"), family, nodes,
                    align)
    _same(serial, want)
    piped = _drain(tserve.GNNServeEngine(tst, max_batch=BATCH,
                                         mode="subgraph", pipeline_depth=2),
                   family, nodes, align)
    np.testing.assert_array_equal(piped["logits"], serial["logits"])
    assert piped["log"] == serial["log"]


def test_multi_bucket_dispatches_and_config(stores, data):
    """Depth 2 with ``multi_bucket``: fewer dispatches than batches, the
    reference's compile and dispatch counts and recompile warnings, answers
    bit-equal to the serial port engine; ``engine_config`` and
    ``snapshot`` carry the reference's keys."""
    jst, tst = stores
    nodes = np.random.default_rng(4).integers(0, data.n_nodes,
                                              size=6 * BATCH)
    kw = dict(max_batch=BATCH, mode="subgraph", pipeline_depth=2,
              multi_bucket=True)
    jeng = JEngine(jst, **kw)
    want = _drain(jeng, "gcn", nodes)
    align = lambda: _align_bn(jst, tst, "gcn")  # noqa: E731
    teng = tserve.GNNServeEngine(tst, **kw)
    got = _drain(teng, "gcn", nodes, align)
    _same(got, want)
    assert got["dispatches"] - 1 < got["counters"]["batches"]  # 1: warmup
    serial = _drain(tserve.GNNServeEngine(tst, max_batch=BATCH,
                                          mode="subgraph"), "gcn", nodes,
                    align)
    np.testing.assert_array_equal(got["logits"], serial["logits"])
    assert set(teng.engine_config()) == set(jeng.engine_config())
    tsnap, jsnap = teng.snapshot(), jeng.snapshot()
    assert set(tsnap) == set(jsnap)
    # warmup runs single launches: each new co-launch composition is a new
    # program after it, in the reference (a jit trace) as in the port
    assert tsnap["watchdogs"]["recompile"] == jsnap["watchdogs"]["recompile"]
    assert "multi" in tsnap["watchdogs"]["recompile"]["last"]["shape"]


def test_light_traffic_drains_through_tick(stores, data):
    """One batch in a depth-2 pipeline completes through non-blocking
    ``tick`` calls once the queue is empty (a CPU launch is ready when it
    returns)."""
    _, tst = stores
    engine = tserve.GNNServeEngine(tst, max_batch=BATCH, mode="subgraph",
                                   pipeline_depth=2)
    engine.warmup("g", "gcn", probes=4)
    qs = engine.submit_many("g", "gcn", np.arange(BATCH))
    served = 0
    for _ in range(4):
        served += engine.tick()
    engine.close()
    assert served == BATCH and all(q.done for q in qs)
    want = tst.session("g", "gcn").serve_subgraph(np.arange(BATCH))
    np.testing.assert_array_equal(np.stack([q.logits for q in qs]), want)


class _Faults:
    """The ``faults=`` seam: raise at ``op`` on the first ``times`` checks."""

    def __init__(self, op, times):
        self.op, self.left = op, times

    def check(self, op, scope=None):
        if op == self.op and self.left > 0:
            self.left -= 1
            raise RuntimeError(f"injected {op} fault")


class _GatedWorker:
    """An extract worker whose extraction starts only when the main thread
    asks for its result.

    Both engines hand the next batch's extraction to their worker before
    they launch the current batch, and the worker pops its batch from the
    queue when it runs. A launch or complete fault requeues the current
    batch from the main thread. Whether that requeue or the worker's pop
    comes first is up to the thread scheduler, in the reference engine as in
    the port: the requeued batch is then served first or second by chance
    (the port's CPU launch holds the GIL, so it often loses the race the
    reference's asynchronous dispatch wins). Under this worker the pop always
    comes after the requeue, so the requeued batch is served next, as the
    retry path means it to be, and both engines take the same path."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._gates = []

    def submit(self, fn, *args):
        gate = threading.Event()
        self._gates.append(gate)

        def gated():
            gate.wait()
            return fn(*args)
        return _GatedFuture(gate, self._pool.submit(gated))

    def shutdown(self, wait=True):
        for gate in self._gates:
            gate.set()
        self._pool.shutdown(wait=wait)


class _GatedFuture:
    def __init__(self, gate, future):
        self._gate, self._future = gate, future

    def result(self):
        self._gate.set()
        return self._future.result()


def _serve_faulty(engine_cls, store, model, nodes, op, times):
    engine = engine_cls(store, max_batch=BATCH, mode="subgraph",
                        pipeline_depth=1, faults=_Faults(op, times),
                        max_retries=2, retry_backoff_s=0.0)
    engine.warmup("g", model, probes=4)
    engine.close()
    engine._pool = _GatedWorker()
    qs = engine.submit_many("g", model, nodes)
    raised = 0
    for _ in range(20):
        try:
            engine.run_until_drained()
            break
        except RuntimeError:
            raised += 1
    engine.close()
    return engine, qs, raised


@pytest.mark.parametrize("op,times", [("extract", 1), ("launch", 1),
                                      ("complete", 1), ("launch", 3)])
def test_fault_requeue_and_retries(stores, data, op, times):
    """An injected stage fault requeues its batch at the front of its
    queue; the retry serves it and the serve-path counters count it once.
    Three launch faults exhaust ``max_retries=2``: the batch's queries end
    with a typed ``QueryFailure``. Both packages take the same path."""
    jst, tst = stores
    nodes = np.arange(2 * BATCH)
    jeng, jqs, jraised = _serve_faulty(JEngine, jst, "gcn", nodes, op, times)
    teng, tqs, traised = _serve_faulty(tserve.GNNServeEngine, tst, "gcn",
                                       nodes, op, times)
    assert traised == jraised == times
    for k in COUNTERS:
        assert getattr(teng.metrics, k) == getattr(jeng.metrics, k), k
    assert [[q.qid for q in b] for b in teng.batch_log] == \
        [[q.qid for q in b] for b in jeng.batch_log]
    assert [q.pred for q in tqs] == [q.pred for q in jqs]
    fails = [(q.failure.reason, q.failure.stage, q.failure.attempts)
             for q in tqs if q.failed]
    assert fails == [(q.failure.reason, q.failure.stage, q.failure.attempts)
                     for q in jqs if q.failed]
    assert len(fails) == (BATCH if times > 2 else 0)
    assert teng.pending == 0


def test_heap_order_matches_reference(stores, data):
    """Interleaved submission and ``tick`` over two models' queues on the
    full-cache path: the port serves the reference's batches in the
    reference's order."""
    jst, tst = stores
    rng = np.random.default_rng(7)
    plan = [(str(rng.choice(["gcn", "sage"])), int(rng.integers(
        0, data.n_nodes))) for _ in range(40)]

    def run(engine):
        it = iter(plan)
        done = False
        while not done or engine.pending:
            for _ in range(2):
                nxt = next(it, None)
                if nxt is None:
                    done = True
                    break
                engine.submit("g", *nxt)
            engine.tick()
        engine.run_until_drained()
        return ([[(q.qid, q.model, q.node) for q in b]
                 for b in engine.batch_log],
                [[q.pred for q in b] for b in engine.batch_log])

    got = run(tserve.GNNServeEngine(tst, max_batch=3, mode="full"))
    want = run(JEngine(jst, max_batch=3, mode="full"))
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_zero_steady_recompiles_across_updates(data):
    """Pipelined serving across two feature updates adds no program after
    warmup and fires no recompile warning; each update invalidates the
    session once."""
    _, tst = _stores(data, ["gcn"])
    engine = tserve.GNNServeEngine(tst, max_batch=BATCH, mode="subgraph",
                                   pipeline_depth=2)
    engine.warmup("g", "gcn")
    rng = np.random.default_rng(5)
    engine.submit_many("g", "gcn", rng.integers(0, data.n_nodes, 3 * BATCH))
    engine.run_until_drained()
    c0 = engine.compile_count
    x = tst.graphs["g"].data.x
    for round_ in range(2):
        x2 = x.copy()
        x2[: data.n_nodes // 7] = float(round_)
        tst.update_features("g", x2)
        engine.submit_many("g", "gcn",
                           rng.integers(0, data.n_nodes, 2 * BATCH))
        engine.run_until_drained()
    engine.close()
    assert engine.compile_count == c0
    assert engine.recompile_watchdog.steady_recompiles == 0
    assert tst.session("g", "gcn").invalidations == 2


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_feature_updates_adopted_on_the_main_thread(data, kind):
    """A pipelined engine adopts feature updates (the session's ``sync``:
    upload, recalibration and cache refresh, card work on a CUDA store) on
    the main thread only, so its extract worker stays host-only; after
    each update the batches answer as the session does on the new
    features, with no extract failure."""
    _, tst = _stores(data, ["gcn"])
    if kind == "single":
        engine = tserve.GNNServeEngine(tst, max_batch=BATCH,
                                       mode="subgraph", pipeline_depth=2)
    else:
        engine = tserve.ShardedServeEngine(tst, n_shards=2, max_batch=BATCH,
                                           pipeline_depth=2)
    engine.warmup("g", "gcn", probes=4)
    session = engine._get_session(("g", "gcn"))
    on_main, real = [], session.sync

    def sync():
        on_main.append(threading.current_thread() is threading.main_thread())
        real()

    session.sync = sync
    rng = np.random.default_rng(6)
    x = tst.graphs["g"].data.x
    for round_ in range(2):
        x2 = x.copy()
        x2[: data.n_nodes // 5] = float(round_ + 1)
        tst.update_features("g", x2)
        n0 = len(engine.batch_log)
        engine.submit_many("g", "gcn",
                           rng.integers(0, data.n_nodes, 3 * BATCH))
        engine.run_until_drained()
        for b in list(engine.batch_log)[n0:]:
            np.testing.assert_array_equal(
                np.stack([q.logits for q in b]),
                session.serve_subgraph(np.asarray([q.node for q in b])))
    engine.close()
    assert on_main and all(on_main)
    assert session.invalidations == 2
    assert engine.metrics.requeues == 0
    assert engine.transfer_watchdog.device_in_extract == 0


def test_drain_evacuate_and_resume(stores, data):
    """``drain`` answers the backlog and sheds new intake, ``evacuate``
    hands back the queued queries in submit order, ``resume_intake``
    re-opens intake: the reference's reports and counts."""
    jst, tst = stores

    def run(engine_cls, store):
        engine = engine_cls(store, max_batch=BATCH, mode="subgraph",
                            pipeline_depth=1)
        engine.warmup("g", "gcn", probes=4)
        engine.submit_many("g", "gcn", np.arange(3 * BATCH))
        rep = engine.drain(timeout_s=600.0)
        shed = engine.submit("g", "gcn", 1)
        engine.resume_intake()
        qs = engine.submit_many("g", "gcn", np.arange(5, 5 + 2 * BATCH))
        out = engine.evacuate()
        return (rep.answered, rep.shed, rep.failed, rep.timed_out,
                shed.admission.action, shed.admission.reason,
                [q.qid for q in out] == [q.qid for q in qs],
                engine.pending, engine.metrics.queries)

    got = run(tserve.GNNServeEngine, tst)
    assert got == run(JEngine, jst)
    assert got[0] == 3 * BATCH and got[6] and got[7] == 0
