"""Card-only tests of the node-query engine (``repro_torch.serve.
GNNServeEngine``): the in-flight batch's CUDA event, the transfer
watchdog's strict guard, and the multi-bucket co-launch.

They need a CUDA device and nvcc (the kernels build on first use) and skip
elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_engine.py

* ``_oldest_ready`` is False while a launched batch sits behind a
  ``torch.cuda._sleep`` spin put on the stream just before it, and True
  after ``torch.cuda.synchronize()``: the light-traffic completion never
  blocks on the card;
* ``strict_guard`` around the launch stage raises on a forced ``.item()``
  inside the launch and counts it, restores the sync debug mode, and lets
  the clean launch path through without a count;
* feature updates between batches of a pipelined engine whose launch
  stage runs under ``strict_guard`` are adopted on the main thread: no
  guard error, no extract failure, 0 ``device_in_extract``, and the
  answers are the session's on the new features;
* ``launch_prepared_many`` is bit-equal to serial launches on the card and
  counts one dispatch and one new program for the composition.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

gnn = lazy("repro_torch.models.gnn")
datasets = lazy("repro_torch.graphs.datasets")
serve = lazy("repro_torch.serve")
session_core = lazy("repro_torch.serve.session_core")

BATCH = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def store(cuda):
    data = datasets.make_dataset("cora", seed=0, scale=0.25)
    st = serve.GraphStore(max_batch=BATCH, use_pallas=True, device="cuda")
    st.register_graph("g", data)
    st.register_model("gcn", "gcn",
                      gnn.init_gcn(0, data.x.shape[1], 64, data.n_classes,
                                   "cuda"))
    return st


@pytest.mark.gpu
def test_oldest_ready_follows_the_card(store):
    engine = serve.GNNServeEngine(store, max_batch=BATCH, mode="subgraph",
                                  pipeline_depth=2)
    engine.warmup("g", "gcn", probes=2)
    session = engine._get_session(("g", "gcn"))
    real = session.launch_batch

    def behind_a_spin(prep):
        torch.cuda._sleep(1_000_000_000)      # ~0.5 s of the card's clock
        return real(prep)

    session.launch_batch = behind_a_spin
    try:
        qs = engine.submit_many("g", "gcn", np.arange(BATCH))
        assert engine.tick() == 0             # launched, not ready
    finally:
        session.launch_batch = real
    assert len(engine._inflight) == 1
    assert engine._inflight[0].ready is not None
    assert engine._oldest_ready() is False
    torch.cuda.synchronize()
    assert engine._oldest_ready() is True
    assert engine.tick() == BATCH
    engine.close()
    want = session.serve_subgraph(np.arange(BATCH))
    np.testing.assert_array_equal(np.stack([q.logits for q in qs]), want)


def _guarded_engine(store, **kw):
    class Guarded(serve.GNNServeEngine):
        def _launch_stage(self, inf):
            with self.transfer_watchdog.strict_guard():
                super()._launch_stage(inf)

    return Guarded(store, max_batch=BATCH, mode="subgraph",
                   retry_backoff_s=0.0, **kw)


@pytest.mark.gpu
def test_strict_guard_raises_and_counts(store):
    engine = _guarded_engine(store)
    engine.warmup("g", "gcn", probes=2)
    session = engine._get_session(("g", "gcn"))
    real = session.launch_batch

    def syncing(prep):
        devs = real(prep)
        devs[0].sum().item()                  # a device->host sync
        return devs

    mode = torch.cuda.get_sync_debug_mode()
    session.launch_batch = syncing
    try:
        qs = engine.submit_many("g", "gcn", np.arange(BATCH))
        with pytest.raises(RuntimeError, match="synchroniz"):
            engine.run_until_drained()
    finally:
        session.launch_batch = real
    assert torch.cuda.get_sync_debug_mode() == mode
    assert engine.transfer_watchdog.host_sync_in_launch == 1
    warns = [e for e in engine.tracer.warning_events()
             if e.name == "transfer"]
    assert warns and warns[0].attrs["source"] == "transfer_guard"
    engine.run_until_drained()                # the clean launch: no sync
    assert all(q.done for q in qs)
    assert engine.transfer_watchdog.host_sync_in_launch == 1
    assert engine.transfer_watchdog.device_in_extract == 0


@pytest.mark.gpu
def test_feature_updates_under_strict_guard(store):
    engine = _guarded_engine(store, pipeline_depth=1)
    engine.warmup("g", "gcn", probes=2)
    session = engine._get_session(("g", "gcn"))
    x = store.graphs["g"].data.x
    rng = np.random.default_rng(2)
    n = x.shape[0]
    for round_ in range(2):
        x2 = x.copy()
        x2[: n // 5] = float(round_ + 1)
        store.update_features("g", x2)
        n0 = len(engine.batch_log)
        qs = engine.submit_many("g", "gcn", rng.integers(0, n, 3 * BATCH))
        engine.run_until_drained()
        assert all(q.done for q in qs)
        for b in list(engine.batch_log)[n0:]:
            np.testing.assert_array_equal(
                np.stack([q.logits for q in b]),
                session.serve_subgraph(np.asarray([q.node for q in b])))
    engine.close()
    assert session.invalidations == 2
    assert engine.metrics.requeues == 0
    assert engine.transfer_watchdog.snapshot()["device_in_extract"] == 0
    assert engine.transfer_watchdog.host_sync_in_launch == 0


@pytest.mark.gpu
def test_launch_many_bit_equal_to_serial(store):
    session = store.session("g", "gcn")
    session.warmup(np.random.default_rng(0), probes=2)
    rng = np.random.default_rng(1)
    n = store.graphs["g"].data.n_nodes
    preps = [session.prepare_batch(rng.integers(0, n, BATCH))
             for _ in range(3)]
    d0 = session.dispatch_count
    serial = [session.finish_batch(p, session.launch_batch(p)) for p in preps]
    assert session.dispatch_count - d0 == 3
    c0 = session.compile_count
    devs = session_core.launch_prepared_many(preps)
    assert session.dispatch_count - d0 == 4
    assert session.compile_count == c0 + 1    # the (3, shapes) composition
    assert all(d.is_cuda for ds in devs for d in ds)
    for p, ds, want in zip(preps, devs, serial):
        np.testing.assert_array_equal(session.finish_batch(p, ds), want)
