"""The port's serving telemetry (``repro_torch.serve.trace``, ``export``,
``metrics``) against the reference's, on ``make_dataset("cora", seed=0,
scale=0.1)``, the port on the CPU.

Identical in both packages: the span tracer's retained records and
counters (sampling, outliers, errors, warnings, ring wrap-around) when fed
the same spans; the Chrome trace and the Prometheus text derived from them
(one HELP line differs: the port names new programs where the reference
names XLA retraces); the metrics snapshots of the same latency stream; the
engines' batch traces for the same submissions; the recompile watchdog's
silence across feature updates and its warning on a forced new shape.
Port-only: the transfer watchdog's torch rules (a tensor off the CPU in a
staged batch; a numpy result, or a CPU tensor from a core on the card, out
of a launch) and ``strict_guard`` on a host without CUDA, which counts an
exception out of its block as the reference's does; submitter threads
beside the engine's extract worker and tracer writers beside a reader,
under a short switch interval. The tracing overhead is read on the card
(``chip_smoke.py``), not timed here.
"""
import json
import time

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
from repro.serve import export as jexp  # noqa: E402
from repro.serve import metrics as jmet  # noqa: E402
from repro.serve import trace as jtr  # noqa: E402
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
texp = lazy("repro_torch.serve.export")
tmet = lazy("repro_torch.serve.metrics")
ttr = lazy("repro_torch.serve.trace")
tserve = lazy("repro_torch.serve")

jax.config.update("jax_platform_name", "cpu")

BATCH = 8
HIDDEN = 16
RECOMPILE_HELP = "serve_steady_recompiles_total"


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.1)


def _stores(data):
    pj = jg.init_gcn(jax.random.PRNGKey(0), data.x.shape[1], HIDDEN,
                     data.n_classes)
    jst = JStore(max_batch=BATCH)
    jst.register_graph("g", data)
    jst.register_model("gcn", "gcn", pj)
    tst = tserve.GraphStore(max_batch=BATCH, device="cpu")
    tst.register_graph("g", td.make_dataset("cora", seed=0, scale=0.1))
    tst.register_model("gcn", "gcn", tg.params_from_numpy(
        "gcn", [np.asarray(w) for w in pj], "cpu"))
    return jst, tst


@pytest.fixture(scope="module")
def stores(data):
    return _stores(data)


@pytest.fixture
def clock(monkeypatch):
    """``time.perf_counter`` replaced by a clock the test sets."""
    now = [1000.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    return now


class _Q:
    def __init__(self, qid, node, t):
        self.qid, self.node, self.t_submit = qid, node, t
        self.trace_id = -1


def _feed(mod, clock, capacity=16, sample_every=3):
    """A seeded stream of batch traces, errors and warnings into a tracer
    of package ``mod``."""
    rng = np.random.default_rng(0)
    tracer = mod.SpanTracer(capacity=capacity, sample_every=sample_every,
                            outlier_window=64)
    t = 10.0
    for i in range(90):
        batch = [_Q(4 * i + j, int(rng.integers(0, 500)),
                    t - float(rng.uniform(0, 0.01))) for j in range(4)]
        shard = None if i % 3 else int(rng.integers(0, 2))
        tr = tracer.begin(("g", "m", "default"), "default", shard, batch, t,
                          vtime=0.1 * i, overdue=bool(i % 11 == 0))
        ext = float(rng.exponential(0.002))
        comp = float(rng.exponential(0.004)) * (20.0 if i % 17 == 16 else 1)
        tr.bucket = dict(groups=[dict(n_pad=256, g_pad={"adj": 64})])
        tr.span("extract", t, t + ext)
        tr.span("launch", t + ext, t + ext + 1e-4, coalesced=1 + i % 2)
        tr.span("compute", t + ext + 1e-4, t + ext + comp,
                attributed_s=comp)
        tr.t_end = t + ext + comp
        tracer.commit(tr, error="RuntimeError('x')" if i % 23 == 5 else "",
                      requeued=i % 23 == 5)
        if i % 29 == 7:
            clock[0] = t
            tracer.warning("recompile", family="gnn", label="core",
                           shape=dict(n_pad=512))
        if i % 31 == 3:
            clock[0] = t
            tracer.event("drain", answered=i)
        t += ext + comp + 0.001
    return tracer


def test_tracer_records_match_reference(clock):
    """Sampling, outlier capture, error paths, warnings and ring
    wrap-around keep the same records in both packages."""
    jt, tt = _feed(jtr, clock), _feed(ttr, clock)
    assert [r.to_json() for r in tt.records()] == \
        [r.to_json() for r in jt.records()]
    assert tt.snapshot() == jt.snapshot()
    assert tt.outliers_recorded > 0 and tt.errors_recorded > 0
    assert len(tt.records()) == 16
    assert ttr.STAGES == jtr.STAGES


def test_chrome_trace_matches_reference(clock, tmp_path):
    """The Chrome-trace objects of tracers fed the same spans are equal;
    the written file loads back; empty and warnings-only tracers export
    as the reference's do."""
    jt, tt = _feed(jtr, clock, capacity=64), _feed(ttr, clock, capacity=64)
    got = texp.write_chrome_trace(tt, str(tmp_path / "t.json"))
    assert got == jexp.chrome_trace(jt)
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert texp.chrome_trace(tt.records()) == got
    for mod, exp in ((ttr, texp), (jtr, jexp)):
        empty = mod.SpanTracer()
        assert exp.chrome_trace(empty)["traceEvents"] == []
    tw, jw = ttr.SpanTracer(), jtr.SpanTracer()
    for tr in (tw, jw):
        tr.warning("recompile", label="core", shape=dict(n_pad=64))
    assert texp.chrome_trace(tw) == jexp.chrome_trace(jw)


def _metrics(mod, clock):
    rng = np.random.default_rng(1)
    m = mod.ServeMetrics(family="gnn")
    clock[0] = 50.0
    m.start_clock()
    for i in range(200):
        tenant = ("gold", "hog")[i % 2]
        action = ("accept", "throttle", "shed")[int(rng.integers(0, 3))]
        m.record_admission(tenant, action, cost=float(i % 5),
                           cost_limited=bool(i % 13 == 0))
        if action == "accept":
            lat = float(rng.exponential(0.01))
            m.queries += 1
            m.latency.record(lat)
            m.record_tenant_query(tenant, lat)
            m.record_tenant_cost_attributed(tenant, lat / 2)
        if i % 8 == 7:
            m.batches += 1
            m.subgraph_queries += 8
            m.batch_latency.record(float(rng.exponential(0.02)))
            m.record_stages(float(rng.exponential(0.01)),
                            float(rng.exponential(0.01)))
    m.serve_wall_s = 0.5
    clock[0] = 52.0
    m.stop_clock()
    return m


def _extra():
    return dict(compiles=3, invalidations=1, dispatches=25, pending=0,
                pipeline_depth=2, multi_bucket=False, halo_bytes=4096,
                halo_bytes_by_tag={"serve/x": 4096},
                watchdogs=dict(recompile=dict(armed=True, family="gnn",
                                              steady_recompiles=0,
                                              last=None),
                               transfer=dict(family="gnn",
                                             device_in_extract=0,
                                             host_sync_in_launch=2)))


def test_metrics_and_prometheus_match_reference(clock):
    """The same admission/latency/stage stream gives the same metrics
    snapshot, and the same Prometheus text from it, but for the HELP line
    of the recompile counter."""
    jm, tm = _metrics(jmet, clock), _metrics(tmet, clock)
    tsnap = tm.snapshot(extra=_extra())
    assert tsnap == jm.snapshot(extra=_extra())
    jt, tt = _feed(jtr, clock), _feed(ttr, clock)
    got = texp.prometheus_text(tsnap, tt).splitlines()
    want = jexp.prometheus_text(tsnap, jt).splitlines()
    assert len(got) == len(want)
    diff = [(g, w) for g, w in zip(got, want) if g != w]
    assert len(diff) == 1
    assert diff[0][0].startswith(f"# HELP {RECOMPILE_HELP} ")
    assert "new programs" in diff[0][0]
    ls = tmet.LatencyStats(max_samples=4)
    for i in range(10):
        ls.record(i * 1e-3)
    s = ls.summary()
    assert s["count"] == 10 and s["window"] == 4
    assert s["max_ms"] == pytest.approx(9.0)


class _G:
    def __init__(self, x):
        self.staged = type("S", (), {"x_pad": x})()


class _P:
    def __init__(self, xs):
        self.groups = [_G(x) for x in xs]


def test_transfer_watchdog_torch_rules():
    """Host arrays are numpy arrays and CPU tensors; a staged tensor off
    the CPU (a ``meta`` tensor stands in for the card here) is device work
    in the extract stage; out of a launch, a numpy array is a host sync
    and so is a CPU tensor from a core whose device is the card.
    ``strict_guard`` without CUDA sets no mode and counts an exception out
    of its block, as the reference's guard does on the CPU backend."""
    wd = ttr.TransferWatchdog(ttr.SpanTracer())
    wd.check_prepared(_P([np.zeros((4, 4)), torch.zeros(4, 4)]))
    assert wd.device_in_extract == 0
    wd.check_prepared(_P([torch.zeros(4, 4, device="meta")]))
    assert wd.device_in_extract == 1
    wd.check_launched([torch.zeros(4)], torch.device("cpu"))
    wd.check_launched([torch.zeros(4, device="meta")], torch.device("cuda"))
    assert wd.host_sync_in_launch == 0
    wd.check_launched([np.zeros(4)])
    wd.check_launched([torch.zeros(4)], torch.device("cuda"))
    assert wd.host_sync_in_launch == 2
    assert {e.attrs["kind"] for e in wd.tracer.warning_events()} == \
        {"device_in_extract", "host_sync_in_launch"}
    if torch.cuda.is_available():
        pytest.skip("the CPU rule of strict_guard")
    counts = []
    for mod in (ttr, jtr):
        w = mod.TransferWatchdog()
        with w.strict_guard():
            np.zeros(3).sum()
        with pytest.raises(RuntimeError):
            with w.strict_guard():
                raise RuntimeError("sync")
        counts.append(w.snapshot()["host_sync_in_launch"])
    assert counts == [1, 1]


def _serve(engine, data, n=4 * BATCH, seed=0):
    engine.warmup("g", "gcn", probes=4)
    qs = engine.submit_many("g", "gcn", np.random.default_rng(seed).integers(
        0, data.n_nodes, size=n))
    engine.run_until_drained()
    assert all(q.done for q in qs)
    return qs


def _trace_view(tr):
    return (tr.key, tr.tenant, tr.shard, tr.full_cache, tr.bucket,
            tr.kept, [(q["qid"], q["node"]) for q in tr.queries],
            [s.name for s in tr.spans])


def test_engine_traces_match_reference(stores, data):
    """Every served batch leaves a trace with the reference's key, bucket,
    members and span names; the spans reconstruct the metrics' stage sums
    and each query links to its batch's trace."""
    jst, tst = stores
    jeng = JEngine(jst, max_batch=BATCH, mode="subgraph",
                   tracer=jtr.SpanTracer(sample_every=1))
    teng = tserve.GNNServeEngine(tst, max_batch=BATCH, mode="subgraph",
                                 tracer=ttr.SpanTracer(sample_every=1))
    _serve(jeng, data)
    qs = _serve(teng, data)
    trs = teng.tracer.batch_traces()
    assert [_trace_view(t) for t in trs] == \
        [_trace_view(t) for t in jeng.tracer.batch_traces()]
    m = teng.metrics
    assert len(trs) == m.batches
    assert abs(sum(t.stage_s("extract") for t in trs) - m.extract_s) < 1e-6
    assert abs(sum(t.stage_s("compute") for t in trs) - m.compute_s) < 1e-6
    ids = {t.trace_id for t in trs}
    assert all(q.trace_id in ids for q in qs)
    txt = texp.prometheus_text(teng.snapshot(), teng.tracer)
    assert f'serve_queries_total{{family="gnn"}} {4 * BATCH}' in txt
    off = tserve.GNNServeEngine(tst, max_batch=BATCH, mode="subgraph",
                                trace=False)
    _serve(off, data, n=BATCH)
    assert off.tracer.records() == [] and off.tracer.batches_seen == 0


def test_recompile_watchdog_silent_then_fires(data):
    """Pipelined serving across two feature updates: no warning. A forced
    new shape (the node water mark doubled behind the engine's back): the
    watchdog fires with the reference's label and shape key."""
    events = []
    for eng_cls, store in zip((JEngine, tserve.GNNServeEngine),
                              _stores(data)):
        engine = eng_cls(store, max_batch=BATCH, mode="subgraph",
                         pipeline_depth=2)
        _serve(engine, data, n=2 * BATCH)
        assert engine.recompile_watchdog.armed
        rng = np.random.default_rng(1)
        x = store.graphs["g"].data.x
        for i in (1, 2):
            store.update_features("g", x + np.float32(1e-3 * i))
            engine.submit_many("g", "gcn",
                               rng.integers(0, data.n_nodes, 2 * BATCH))
            engine.run_until_drained()
        assert engine.recompile_watchdog.steady_recompiles == 0
        assert engine.tracer.warning_events() == []
        store.session("g", "gcn").core._n_water *= 2
        engine.submit_many("g", "gcn",
                           rng.integers(0, data.n_nodes, 2 * BATCH))
        engine.run_until_drained()
        engine.close()
        events.append([(e.name, e.attrs["label"], e.attrs["shape"])
                       for e in engine.tracer.warning_events()])
    assert events[1] == events[0]
    assert events[1] and events[1][0][:2] == ("recompile", "core")


def test_error_and_host_sync_paths(stores, data):
    """A failed launch leaves an ``error`` trace even with sampling off;
    a core on the card that hands back CPU tensors is flagged as a host
    sync in the launch (the session's device is relabelled to stand in for
    the card)."""
    _, tst = stores
    engine = tserve.GNNServeEngine(tst, max_batch=BATCH, mode="subgraph",
                                   pipeline_depth=2,
                                   tracer=ttr.SpanTracer(sample_every=10**9),
                                   retry_backoff_s=0.0)
    engine.warmup("g", "gcn", probes=4)
    session = engine._get_session(("g", "gcn"))
    real = session.launch_batch
    calls = {"n": 0}

    def flaky(prep):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient compute failure")
        return real(prep)

    session.launch_batch = flaky
    try:
        qs = engine.submit_many("g", "gcn", np.arange(BATCH))
        with pytest.raises(RuntimeError, match="transient"):
            engine.run_until_drained()
        engine.run_until_drained()
    finally:
        session.launch_batch = real
    assert all(q.done for q in qs)
    errors = [t for t in engine.tracer.batch_traces() if t.error]
    assert len(errors) == 1 and errors[0].kept == "error"
    assert engine.transfer_watchdog.host_sync_in_launch == 0
    session.device = torch.device("cuda")
    try:
        engine.submit_many("g", "gcn", np.arange(BATCH))
        engine.run_until_drained()
    finally:
        session.device = torch.device("cpu")
    engine.close()
    assert engine.transfer_watchdog.host_sync_in_launch == 1
    assert engine.transfer_watchdog.device_in_extract == 0


def test_concurrent_submitters_and_tracer_writers(stores, data):
    """Threads submit to a depth-2 engine while the main thread drives
    ``tick`` (the extract worker runs beside both), and threads commit to
    a tracer while another reads it, under a short switch interval: every
    query is answered once, and the tracer's counters and ids stay
    coherent."""
    import sys
    import threading
    _, tst = stores
    engine = tserve.GNNServeEngine(tst, max_batch=BATCH, mode="subgraph",
                                   pipeline_depth=2)
    engine.warmup("g", "gcn", probes=4)
    tracer = ttr.SpanTracer(capacity=32, sample_every=1)
    submitted, errors = [], []
    stop = threading.Event()
    nodes = np.random.default_rng(9).integers(0, data.n_nodes, 4 * 24)

    def submitter(chunk):
        try:
            for n in chunk:
                submitted.append(engine.submit("g", "gcn", int(n)))
        except Exception as e:             # pragma: no cover
            errors.append(e)

    def writer(w):
        try:
            i = 0
            while not stop.is_set():
                q = _Q(i, w, 0.0)
                tr = tracer.begin(("g", "m", "default"), "default", None,
                                  [q], 0.0)
                tr.span("extract", 0.0, 1e-4)
                tracer.commit(tr)
                tracer.warning("w", k=w)
                i += 1
        except Exception as e:             # pragma: no cover
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                ids = [r.trace_id for r in tracer.records()]
                if len(ids) != len(set(ids)):
                    raise AssertionError("duplicate trace ids")
        except Exception as e:             # pragma: no cover
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(c,))
                   for c in np.array_split(nodes, 4)]
        threads += [threading.Thread(target=writer, args=(w,))
                    for w in range(3)]
        threads.append(threading.Thread(target=reader))
        for t in threads:
            t.start()
        for t in threads[:4]:
            while t.is_alive():
                engine.tick()
                t.join(timeout=0.01)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        engine.run_until_drained()
    finally:
        sys.setswitchinterval(switch)
        engine.close()
    assert not errors
    assert len(submitted) == nodes.size and all(q.done for q in submitted)
    served = [q.qid for b in engine.batch_log for q in b]
    assert sorted(served) == sorted(q.qid for q in submitted)
    assert engine.pending == 0 and engine.metrics.queries == nodes.size
    assert tracer.batches_recorded == tracer.batches_seen
    assert len(tracer.records()) <= tracer.capacity
