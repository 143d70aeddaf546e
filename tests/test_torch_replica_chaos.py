"""Chaos and live reshard: the port's replica tier and engine fault paths
(``repro_torch.serve``) against the reference's (``repro.serve``) on the
same submissions, the port on the CPU at the reference's sizes
(``make_dataset("cora", seed=0, scale=0.05)``, hidden 16, batch 8).

Identical in both packages: bounded retries (requeues, attempts, typed
``QueryFailure`` fields), backoff fairness, drain and drain timeout (the
``DrainReport`` fields and typed-shed reasons), the front door's failover
(``failovers``, ``failover_queries``, the moved queries and where they end),
readmission, and the live reshard P = 2 -> 4 (the ``ReshardReport`` fields
but its times, ``batch_log`` of both engines); the warning events' names
in order; predictions, with logits within rtol = atol = 1e-4 (the port
calibrates its own BN). The reshard ticks a fixed number of times while
P' builds on its thread, so both packages serve the same batches before
the swap. Within the port, as ``tests/test_replica.py`` holds the
reference: every served batch replays bit-exact through the single-host
session, across the swap too, the new engine's also through a freshly
built P = 4 stack, and the survivor of a failover adds no program.
"""
import time

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")

jax.config.update("jax_platform_name", "cpu")

HIDDEN = 16
BATCH = 8


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.05)


@pytest.fixture(scope="module")
def packages(data):
    """(serve module, its GraphData, its models, its GraphStore kwargs) for
    the reference, then for the port on the CPU."""
    pj = jg.init_gcn(jax.random.PRNGKey(0), data.x.shape[1], HIDDEN,
                     data.n_classes)
    pt = tg.params_from_numpy("gcn", [np.asarray(w) for w in pj], "cpu")
    return ((jserve, data, {"gcn": ("gcn", pj)}, {}),
            (tserve, td.make_dataset("cora", seed=0, scale=0.05),
             {"gcn": ("gcn", pt)}, dict(device="cpu")))


def _store(pkg):
    serve, d, models, kw = pkg
    st = serve.GraphStore(max_batch=BATCH, **kw)
    st.register_graph("g", d)
    st.register_model("gcn", *models["gcn"])
    return st


def _engine(pkg, **kw):
    return pkg[0].GNNServeEngine(_store(pkg), mode="subgraph", **kw)


def _tier(pkg, n_replicas=2, n_shards=2, spread="query", deadline_s=0.05):
    serve, d, models, kw = pkg
    faults = serve.FaultInjector(seed=0)
    tracer = serve.SpanTracer()
    # strict-FIFO staleness: batch formation must not depend on either
    # package's speed
    extra = dict(staleness_s=600.0) if n_shards else {}
    reps = [serve.build_replica(f"r{i}", d, models, n_shards=n_shards,
                                faults=faults, tracer=tracer,
                                max_batch=BATCH, mode="subgraph",
                                retry_backoff_s=0.001, **extra, **kw)
            for i in range(n_replicas)]
    fd = serve.FrontDoor(reps, faults=faults, tracer=tracer, spread=spread,
                         policy=serve.HealthPolicy(deadline_s=deadline_s))
    for r in reps:
        r.engine.warmup("g", "gcn")
    return fd, reps, faults


def _same_answers(jqs, tqs):
    assert [q.done for q in tqs] == [q.done for q in jqs]
    done = [i for i, q in enumerate(jqs) if q.done]
    assert [int(tqs[i].pred) for i in done] == [int(jqs[i].pred)
                                                for i in done]
    np.testing.assert_allclose(
        np.stack([np.asarray(tqs[i].logits) for i in done]),
        np.stack([np.asarray(jqs[i].logits) for i in done]),
        rtol=1e-4, atol=1e-4)


def _log(engine):
    return [[q.qid for q in b] for b in engine.batch_log]


def _events(tracer):
    return [w.name for w in tracer.warning_events()]


def _replay_bit_exact(engine, session):
    """Every logged batch re-served on ``session`` reproduces its answers
    bit for bit (the port only)."""
    assert engine.batch_log, "nothing served to replay"
    for batch in engine.batch_log:
        seeds = np.asarray([q.node for q in batch], np.int64)
        np.testing.assert_array_equal(
            np.stack([q.logits for q in batch]),
            np.asarray(session.serve_subgraph(seeds)))


# ------------------------------------------- bounded retry / poison query ---

def test_transient_fault_retries_to_success(packages):
    runs = []
    for pkg in packages:
        faults = pkg[0].FaultInjector(seed=0)
        eng = _engine(pkg, faults=faults, retry_backoff_s=0.001)
        eng.warmup("g", "gcn")
        faults.fail_next("extract", 1)
        qs = eng.submit_many("g", "gcn", np.arange(6))
        with pytest.raises(pkg[0].InjectedFault):
            eng.tick()
        eng.run_until_drained()
        assert all(q.done for q in qs)
        runs.append((eng, qs, dict(
            requeues=eng.metrics.requeues, shed=eng.metrics.retry_shed,
            attempts=[q.attempts for q in qs], log=_log(eng))))
    (_, jqs, want), (teng, tqs, got) = runs
    assert got == want and want["requeues"] == 1 and want["shed"] == 0
    _same_answers(jqs, tqs)
    _replay_bit_exact(teng, teng.store.session("g", "gcn"))


def test_poison_query_typed_shed_after_max_retries(packages):
    runs = []
    for pkg in packages:
        faults = pkg[0].FaultInjector(seed=0)
        eng = _engine(pkg, faults=faults, max_retries=3,
                      retry_backoff_s=0.001, retry_backoff_max_s=0.01)
        eng.warmup("g", "gcn")
        faults.fail("launch", rate=1.0)
        qs = eng.submit_many("g", "gcn", np.arange(4))
        report = eng.drain(timeout_s=10.0)
        failures = [(q.failure.reason, q.failure.stage, q.failure.attempts,
                     "InjectedFault" in q.failure.error, q.settled, q.done)
                    for q in qs]
        faults.clear()
        eng.resume_intake()
        q2 = eng.submit("g", "gcn", 0)
        eng.run_until_drained()
        ev = [w.attrs["stage"] for w in eng.tracer.warning_events()
              if w.name == "retry_exhausted"]
        runs.append(dict(failures=failures, shed=eng.metrics.retry_shed,
                         report=(report.answered, report.shed,
                                 report.failed, report.timed_out),
                         q2=q2.done, stages=ev,
                         events=_events(eng.tracer)))
    want, got = runs
    assert got == want
    assert want["failures"] == [("max_retries", "launch", 4, True, True,
                                 False)] * 4
    assert want["report"] == (0, 0, 4, False) and want["q2"]
    assert want["stages"][0] == "launch"


def test_backoff_does_not_starve_other_queues(packages):
    runs = []
    for pkg in packages:
        serve = pkg[0]
        faults = serve.FaultInjector(seed=0)
        adm = serve.AdmissionController(policies={
            "bad": serve.TenantPolicy(), "good": serve.TenantPolicy()})
        eng = _engine(pkg, faults=faults, admission=adm, max_retries=5,
                      retry_backoff_s=0.2, retry_backoff_max_s=0.5)
        eng.warmup("g", "gcn")
        faults.fail("extract", rate=1.0)
        bad = eng.submit("g", "gcn", 1, tenant="bad")
        with pytest.raises(serve.InjectedFault):
            eng.tick()
        faults.clear()
        good = eng.submit_many("g", "gcn", np.arange(4), tenant="good")
        eng.tick()                       # served despite bad's backoff
        good_done = [q.done for q in good]
        eng.run_until_drained()
        runs.append((good_done, bad.done, bad.attempts, _log(eng),
                     good + [bad]))
    want, got = runs
    assert got[:4] == want[:4] and want[0] == [True] * 4 and want[1]
    _same_answers(want[4], got[4])


# ------------------------------------------------------ graceful drain ------

@pytest.mark.parametrize("case", ["backlog", "timeout"])
def test_drain(packages, case):
    """``backlog``: a drain answers everything and stops intake until
    resumed. ``timeout``: nothing can be served, so the drain typed-sheds
    the queue at its deadline and returns promptly."""
    runs = []
    for pkg in packages:
        faults = pkg[0].FaultInjector(seed=0)
        if case == "backlog":
            eng = _engine(pkg)
        else:
            eng = _engine(pkg, faults=faults, max_retries=1000,
                          retry_backoff_s=0.05, retry_backoff_max_s=0.2)
        eng.warmup("g", "gcn")
        if case == "timeout":
            faults.fail("extract", rate=1.0)
        qs = eng.submit_many("g", "gcn", np.arange(10 if case == "backlog"
                                                   else 6))
        t0 = time.perf_counter()
        report = eng.drain(timeout_s=30.0 if case == "backlog" else 0.3)
        assert time.perf_counter() - t0 < 5.0
        out = dict(report=(report.answered, report.shed, report.failed,
                           report.timed_out),
                   drain_shed=eng.metrics.drain_shed, pending=eng.pending,
                   reasons=[None if q.done else q.admission.reason
                            for q in qs],
                   events=[(w.name, w.attrs.get("timed_out"))
                           for w in eng.tracer.warning_events()])
        if case == "backlog":
            late = eng.submit("g", "gcn", 0)
            eng.resume_intake()
            q = eng.submit("g", "gcn", 0)
            eng.run_until_drained()
            out.update(late=(late.rejected, "draining"
                             in late.admission.reason), resumed=q.done)
        runs.append((out, qs))
    (want, jqs), (got, tqs) = runs
    assert got == want
    if case == "backlog":
        assert want["report"] == (10, 0, 0, False)
        assert want["late"] == (True, True) and want["resumed"]
        _same_answers(jqs, tqs)
    else:
        assert want["report"] == (0, 6, 0, True) and want["drain_shed"] == 6
        assert all("drain timeout" in r for r in want["reasons"])
        assert want["pending"] == 0 and want["events"][-1] == ("drain", True)


# ----------------------------------------------------------- front door -----

def test_chaos_kill_replica_mid_wave(packages):
    """P = 2 replicas x 2 shards, r1 killed while a wave is in flight:
    every accepted query is answered on the survivor, the same queries
    move in both packages, and in the port every batch either replica
    served replays bit-exact on the single-host session with no program
    added on the survivor."""
    runs = []
    for pkg in packages:
        fd, reps, faults = _tier(pkg)
        rng = np.random.default_rng(1)
        n = pkg[1].n_nodes
        qs = fd.submit_many("g", "gcn", rng.integers(0, n, size=48))
        accepted = [q for q in qs if not q.rejected]
        assert {q.replica for q in accepted} == {"r0", "r1"}
        fd.tick()                        # both replicas mid-wave
        compiles = reps[0].engine.compile_count
        faults.kill("r1")
        time.sleep(0.06)                 # let the deadline lapse
        fd.run_until_drained(max_ticks=20_000)
        assert fd.pending == 0 and all(q.done for q in accepted)
        runs.append((reps, qs, compiles, dict(
            failovers=fd.failovers, moved_queries=fd.failover_queries,
            moved=[q.qid for q in qs if q.failovers],
            replicas=[q.replica for q in qs],
            logs=[_log(r.engine) for r in reps],
            events=_events(fd.tracer))))
    (_, jqs, _, want), (reps, tqs, compiles, got) = runs
    assert got == want
    assert want["failovers"] == 1 and want["moved_queries"] > 0
    assert all(want["replicas"][i] == "r0" for i in want["moved"])
    assert "replica_unhealthy" in want["events"] \
        and "failover" in want["events"]
    _same_answers(jqs, tqs)
    single = _store(packages[1]).session("g", "gcn")
    for r in reps:
        _replay_bit_exact(r.engine, single)
    assert reps[0].engine.compile_count == compiles


@pytest.mark.parametrize("case", ["survivor", "orphans"])
def test_replica_recovery_readmission(packages, case):
    """``survivor``: r1 dies, r0 answers its queries; r1 revived is
    readmitted after ``recovery_beats`` and serves again. ``orphans``: the
    only replica dies, its queries park as orphans and are answered once
    it is readmitted."""
    runs = []
    for pkg in packages:
        fd, reps, faults = _tier(pkg, n_replicas=2 if case == "survivor"
                                 else 1, n_shards=0, deadline_s=0.02)
        dead = reps[-1].name
        qs = fd.submit_many("g", "gcn", np.arange(8))
        faults.kill(dead)
        time.sleep(0.03)
        if case == "survivor":
            fd.run_until_drained(max_ticks=10_000)
        else:
            fd.tick()
            assert fd.snapshot()["orphans"] == fd.pending == 8
        assert not fd.health.healthy(dead)
        faults.revive(dead)
        for _ in range(4):               # recovery_beats good beats
            fd.tick()
        assert fd.health.healthy(dead)
        qs2 = fd.submit_many("g", "gcn", np.arange(16))
        fd.run_until_drained(max_ticks=10_000)
        assert all(q.done for q in qs + qs2)
        runs.append((qs + qs2, dict(
            readmissions=fd.readmissions, failovers=fd.failovers,
            moved_queries=fd.failover_queries,
            replicas=[q.replica for q in qs + qs2],
            moves=[q.failovers for q in qs + qs2],
            events=_events(fd.tracer))))
    (jqs, want), (tqs, got) = runs
    assert got == want and want["readmissions"] == 1
    assert want["failovers"] == 1 and want["moved_queries"] > 0
    assert set(want["replicas"][8:]) == {r.name for r in reps}
    assert "replica_recovered" in want["events"]
    if case == "orphans":
        assert want["moved_queries"] == 8 and want["moves"][:8] == [1] * 8
    _same_answers(jqs, tqs)


# ---------------------------------------------------------- live reshard ----

def test_live_reshard_under_load(packages, tmp_path):
    """Reshard P = 2 -> 4 while queries are in flight: the old engine
    serves while P' builds on the resharder's thread, the swap drains it
    with zero shed, and both packages report, log and answer alike. In
    the port both engines' batches replay bit-exact on the single-host
    session, and the new engine's on a freshly built P = 4 stack."""
    runs = []
    for i, pkg in enumerate(packages):
        fd, reps, _ = _tier(pkg, n_replicas=1, deadline_s=10.0)
        handle = reps[0]
        old_engine = handle.engine
        rng = np.random.default_rng(2)
        n = pkg[1].n_nodes
        warm = fd.submit_many("g", "gcn", rng.integers(0, n, size=24))
        fd.run_until_drained(max_ticks=20_000)
        steady_p99 = float(np.percentile([q.latency_s for q in warm], 99))
        pre = fd.submit_many("g", "gcn", rng.integers(0, n, size=24))
        for _ in range(2):
            fd.tick()                    # old engine mid-wave
        rs = pkg[0].Resharder(handle, "g", "gcn", 4,
                              artifact_dir=tmp_path / f"pkg{i}",
                              drain_timeout_s=30.0, tracer=fd.tracer)
        rs.prepare(block=False)
        served = sum(fd.tick() for _ in range(2))   # while P' builds
        report = rs.swap()
        assert handle.engine is not old_engine
        assert handle.engine.n_shards == 4
        post = fd.submit_many("g", "gcn", rng.integers(0, n, size=24))
        fd.run_until_drained(max_ticks=20_000)
        assert fd.pending == 0 and all(q.done for q in warm + pre + post)
        blip_p99 = float(np.percentile([q.latency_s for q in pre + post],
                                       99))
        assert blip_p99 < max(5.0 * steady_p99, 1.0)
        assert (tmp_path / f"pkg{i}" / "g__gcn__P2" / "routing.json").exists()
        rep = report.to_json()
        for k in ("prepare_s", "swap_s"):
            assert rep.pop(k) > 0
        assert rep["drain"].pop("elapsed_s") >= 0
        runs.append((warm + pre + post, old_engine, handle.engine, dict(
            report=rep, served=served, logs=(_log(old_engine),
                                             _log(handle.engine)),
            phases=[w.attrs.get("phase") for w in fd.tracer.warning_events()
                    if w.name == "reshard"],
            events=_events(fd.tracer))))
    (jqs, _, _, want), (tqs, old_engine, new_engine, got) = runs
    assert got == want
    assert want["report"]["from_shards"] == 2 and want["served"] > 0
    assert want["report"]["drain"]["shed"] == 0
    assert want["phases"] == ["prepared", "swap_begin", "swap_end"]
    _same_answers(jqs, tqs)
    fresh = _store(packages[1])
    _replay_bit_exact(old_engine, fresh.session("g", "gcn"))
    _replay_bit_exact(new_engine, fresh.session("g", "gcn"))
    _replay_bit_exact(new_engine, fresh.sharded_session("g", "gcn", 4))


def test_front_door_reshard_convenience(packages):
    runs = []
    for pkg in packages:
        fd, reps, _ = _tier(pkg, n_replicas=1, deadline_s=10.0)
        qs = fd.submit_many("g", "gcn", np.arange(12))
        report = fd.reshard("r0", "g", "gcn", 4)
        fd.run_until_drained(max_ticks=10_000)
        assert all(q.done for q in qs)
        runs.append((qs, (report.from_shards, report.to_shards,
                          report.drain.answered, report.drain.shed),
                     _log(reps[0].engine)))
    (jqs, want, wlog), (tqs, got, glog) = runs
    assert got == want and want[1] == 4 and want[3] == 0
    assert glog == wlog
    _same_answers(jqs, tqs)
