"""Card-only tests of the replica tier (``repro_torch.serve.replica``):
failover, the live reshard, and the strict guard beside a background
reshard build. The replicas sit on the card, ``build_replica``'s default.

They need a CUDA device and nvcc (the kernels build on first use) and skip
elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_replica.py

* a replica killed mid-wave: every query is answered on the survivor, and
  every batch either replica served replays bit for bit on a single-host
  card session launched at the replica's buckets;
* a reshard P = 2 -> 4 under load sheds nothing, and each side of the swap
  replays bit for bit on a freshly built stack of its shard count;
* torch's sync debug mode is one setting for the process, so a strict
  guard and a background reshard build exclude each other through
  ``trace.SYNC_EXCLUSIVE``: a guarded engine that serves while another
  replica builds waits for the build, raises nothing and counts no sync.
"""
import threading
import time

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

gnn = lazy("repro_torch.models.gnn")
datasets = lazy("repro_torch.graphs.datasets")
ops = lazy("repro_torch.kernels.ops")
serve = lazy("repro_torch.serve")

BATCH = 16
FORWARD = ("binarize_pack", "bmm_xnor", "bspmm_bits", "bspmm_fp")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def data(cuda):
    return datasets.make_dataset("cora", seed=0, scale=0.25)


@pytest.fixture
def models(data):
    return {"gcn": ("gcn", gnn.init_gcn(0, data.x.shape[1], 64,
                                        data.n_classes, "cuda"))}


def _replica(name, data, models, **kw):
    return serve.build_replica(name, data, models,
                               store_kw=dict(use_pallas=True),
                               max_batch=BATCH, mode="subgraph",
                               retry_backoff_s=0.001, **kw)


def _store(data, models):
    st = serve.GraphStore(max_batch=BATCH, use_pallas=True)
    st.register_graph("g", data)
    st.register_model("gcn", *models["gcn"])
    return st


def _cores(sess):
    return sess.cores if hasattr(sess, "cores") else [sess.core]


def _replay_bit_exact(engine, served_on, fresh):
    """Every batch of ``engine`` served again on ``fresh``, its cores at
    the buckets of ``served_on`` (the engine's session), bit for bit. With
    no program after warmup, those are the buckets every batch used."""
    assert engine.recompile_watchdog.steady_recompiles == 0
    for a, b in zip(_cores(served_on), _cores(fresh)):
        b._n_water, b._g_water = a._n_water, dict(a._g_water)
    assert engine.batch_log
    for batch in engine.batch_log:
        seeds = np.asarray([q.node for q in batch], np.int64)
        np.testing.assert_array_equal(np.stack([q.logits for q in batch]),
                                      fresh.serve_subgraph(seeds))


@pytest.mark.gpu
def test_failover_on_the_card(data, models):
    faults = serve.FaultInjector(seed=0)
    tracer = serve.SpanTracer()
    reps = [_replica(f"r{i}", data, models, faults=faults, tracer=tracer,
                     pipeline_depth=1) for i in range(2)]
    for r in reps:
        r.engine.warmup("g", "gcn")
    assert reps[0].store.device.type == "cuda"
    fd = serve.FrontDoor(reps, faults=faults, tracer=tracer, spread="query",
                         policy=serve.HealthPolicy(deadline_s=0.05))
    rng = np.random.default_rng(1)
    qs = fd.submit_many("g", "gcn", rng.integers(0, data.n_nodes,
                                                 size=6 * BATCH))
    fd.tick()
    compiles = reps[0].engine.compile_count
    faults.kill("r1")
    time.sleep(0.06)
    ops.reset_launch_counts()
    fd.run_until_drained()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(counts[k] for k in FORWARD), counts
    assert all(q.done for q in qs) and fd.pending == 0
    moved = [q for q in qs if q.failovers]
    assert fd.failovers == 1 and fd.failover_queries == len(moved) > 0
    assert {q.replica for q in moved} == {"r0"}
    assert reps[0].engine.compile_count == compiles
    fresh = _store(data, models).session("g", "gcn")
    for r in reps:
        _replay_bit_exact(r.engine, r.store.session("g", "gcn"), fresh)
        r.engine.close()


@pytest.mark.gpu
def test_live_reshard_on_the_card(data, models, tmp_path):
    tracer = serve.SpanTracer()
    rep = _replica("s0", data, models, n_shards=2, tracer=tracer)
    rep.engine.warmup("g", "gcn")
    old = rep.engine
    fd = serve.FrontDoor([rep], tracer=tracer, spread="query",
                         policy=serve.HealthPolicy(deadline_s=10.0))
    rng = np.random.default_rng(2)
    nodes = lambda n: rng.integers(0, data.n_nodes, size=n)  # noqa: E731
    qs = fd.submit_many("g", "gcn", nodes(4 * BATCH))
    fd.tick()
    rs = serve.Resharder(rep, "g", "gcn", 4, artifact_dir=tmp_path,
                         tracer=tracer)
    rs.prepare(block=False)
    while not rs.ready:
        if not fd.tick():
            time.sleep(0.005)
    qs += fd.submit_many("g", "gcn", nodes(BATCH))
    report = rs.swap()
    assert report.drain.shed == 0 and report.drain.answered == BATCH
    qs += fd.submit_many("g", "gcn", nodes(4 * BATCH))
    fd.run_until_drained()
    assert all(q.done for q in qs) and fd.pending == 0
    assert rep.engine.n_shards == 4 and rep.engine is not old
    assert (tmp_path / "g__gcn__P2" / "routing.json").exists()
    assert [w.attrs["phase"] for w in tracer.warning_events()
            if w.name == "reshard"] == ["prepared", "swap_begin", "swap_end"]
    fresh = _store(data, models)
    _replay_bit_exact(old, rep.store.sharded_session("g", "gcn", 2),
                      fresh.sharded_session("g", "gcn", 2))
    _replay_bit_exact(rep.engine, rep.store.sharded_session("g", "gcn", 4),
                      fresh.sharded_session("g", "gcn", 4))
    rep.engine.close()


@pytest.mark.gpu
def test_strict_guard_waits_for_a_background_build(data, models, tmp_path):
    # the premise: the mode set on this thread makes a blocking copy on
    # another thread raise
    x = torch.ones(4, device="cuda")
    errors = []

    def copy_back():
        try:
            x.cpu()
        except RuntimeError as e:
            errors.append(str(e))

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = threading.Thread(target=copy_back)
        t.start()
        t.join(timeout=60)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert not t.is_alive() and errors and "synchroniz" in errors[0]

    guards = []

    class Guarded(serve.GNNServeEngine):
        def _launch_stage(self, inf):
            with self.transfer_watchdog.strict_guard():
                t0 = time.perf_counter()
                super()._launch_stage(inf)
                guards.append((t0, time.perf_counter()))

    st = _store(data, models)
    guarded = Guarded(st, max_batch=BATCH, mode="subgraph", max_retries=1,
                      retry_backoff_s=0.0)
    guarded.warmup("g", "gcn", probes=2)
    rep = _replica("s0", data, models, n_shards=2)
    rep.engine.warmup("g", "gcn", probes=2)
    rs = serve.Resharder(rep, "g", "gcn", 4, artifact_dir=tmp_path)
    building = threading.Event()
    span = []
    build = rs._build

    def timed_build():
        span.append(time.perf_counter())
        building.set()
        build()
        span.append(time.perf_counter())

    rs._build = timed_build
    rs.prepare(block=False)
    assert building.wait(timeout=60)
    qs = guarded.submit_many("g", "gcn", np.arange(3 * BATCH))
    guarded.run_until_drained()
    report = rs.swap()                 # raises what the build raised
    assert report.to_shards == 4 and report.drain.shed == 0
    assert all(q.done for q in qs)
    assert guarded.transfer_watchdog.host_sync_in_launch == 0
    assert len(span) == 2 and guards
    assert all(t1 <= span[0] or t0 >= span[1] for t0, t1 in guards)
    assert guards[0][0] >= span[1]     # the first launch waited
    sess = st.session("g", "gcn")
    for batch in guarded.batch_log:
        seeds = np.asarray([q.node for q in batch], np.int64)
        np.testing.assert_array_equal(np.stack([q.logits for q in batch]),
                                      sess.serve_subgraph(seeds))
    rep.engine.close()
