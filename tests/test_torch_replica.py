"""The port's replica tier (``repro_torch.serve.replica``) against the
reference's (``repro.serve.replica``): the fault injector, the health
protocol, ``planner.validate_reshard`` and the front door's admission,
version pinning and placement, the port on the CPU.

The same calls go to both packages. Identical: the injector's decision
sequences (counted, scoped, seeded rates, kills, heartbeat drops) and its
snapshot, the health monitor's transitions and events under the same
``now`` sequence, ``validate_reshard``'s errors, the replica each query is
routed to, admission rejections and the tier snapshot's counters, and the
predictions; logits within rtol = atol = 1e-4. The port calibrates its own
BN (within 1e-8 of the reference's on this graph). Sizes are the
reference's ``tests/test_replica.py``: ``make_dataset("cora", seed=0,
scale=0.05)``, hidden 16, batch 8.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve.replica import router as jrouter  # noqa: E402
from repro.serve.sharded import planner as jplanner  # noqa: E402
from repro.serve.sharded.routing import RoutingTable as JRouting  # noqa: E402
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")
trouter = lazy("repro_torch.serve.replica.router")
tplanner = lazy("repro_torch.serve.sharded.planner")
trouting = lazy("repro_torch.serve.sharded.routing")

jax.config.update("jax_platform_name", "cpu")

HIDDEN = 16
BATCH = 8


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.05)


@pytest.fixture(scope="module")
def models(data):
    pj = jg.init_gcn(jax.random.PRNGKey(0), data.x.shape[1], HIDDEN,
                     data.n_classes)
    pt = tg.params_from_numpy("gcn", [np.asarray(w) for w in pj], "cpu")
    return {"gcn": ("gcn", pj)}, {"gcn": ("gcn", pt)}


def _tiers(data, models, n_replicas=2, spread="query", deadline_s=0.05):
    """The same tier in both packages: (front door, replicas, injector)
    for the reference, then for the port on the CPU."""
    out = []
    for serve, build, kw, d, m in (
            (jserve, jserve.build_replica, {}, data, models[0]),
            (tserve, tserve.build_replica, dict(device="cpu"),
             td.make_dataset("cora", seed=0, scale=0.05), models[1])):
        faults = serve.FaultInjector(seed=0)
        tracer = serve.SpanTracer()
        reps = [build(f"r{i}", d, m, n_shards=0, faults=faults,
                      tracer=tracer, max_batch=BATCH, mode="subgraph",
                      retry_backoff_s=0.001, **kw)
                for i in range(n_replicas)]
        fd = serve.FrontDoor(reps, faults=faults, tracer=tracer,
                             spread=spread,
                             policy=serve.HealthPolicy(deadline_s=deadline_s))
        for r in reps:
            r.engine.warmup("g", "gcn")
        out.append((fd, reps, faults))
    return out


def _answers(qs):
    done = [q for q in qs if q.done]
    return (np.stack([np.asarray(q.logits) for q in done]),
            [int(q.pred) for q in done])


def _same_answers(jqs, tqs):
    assert [q.done for q in tqs] == [q.done for q in jqs]
    (jl, jp), (tl, tp) = _answers(jqs), _answers(tqs)
    assert tp == jp
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def _decisions(f, calls):
    """Run ``calls`` (method name, args, kwargs) on injector ``f``;
    record each return value, or the raised InjectedFault's op and scope."""
    out = []
    for name, args, kw in calls:
        try:
            out.append(("ok", getattr(f, name)(*args, **kw)))
        except Exception as e:      # InjectedFault of either package
            out.append((type(e).__name__, e.op, e.scope))
    return out


def _both(calls, seed=0):
    want = _decisions(jserve.FaultInjector(seed=seed), calls)
    got = _decisions(tserve.FaultInjector(seed=seed), calls)
    return got, want


# --------------------------------------------------------- fault seam ------

def test_injector_counted_and_scoped_rules_match():
    """Counted rules disarm after n fires, rate-1 rules fire until
    cleared, scoped rules trip only their replica, global ones every
    replica; both packages decide the same and snapshot the same."""
    c = lambda *a, **k: ("check", a, k)  # noqa: E731
    calls = [("fail_next", ("launch", 2), {}), c("launch"), c("launch"),
             c("launch"), ("fail", ("extract",), dict(rate=1.0)),
             c("extract"), ("clear", ("extract",), {}), c("extract"),
             ("fail_next", ("extract", 1), dict(scope="r1")),
             c("extract", scope="r0"), c("extract", scope="r1"),
             c("extract", scope="r1"),
             ("fail_next", ("complete", 3), {}), c("complete", scope="r0"),
             ("fail", ("complete",), dict(rate=1.0, scope="r1")),
             c("complete", scope="r1"), c("complete", scope="r0"),
             ("snapshot", (), {}), ("clear", (), {}), c("complete"),
             ("snapshot", (), {})]
    got, want = _both(calls)
    assert got == want
    assert want[1][0] == want[2][0] == "InjectedFault" and want[3][0] == "ok"
    assert want[-4][1]["fired"] == {"launch": 2, "extract": 2,
                                    "complete": 3}
    for mod in (jserve, tserve):
        with pytest.raises(ValueError, match="unknown op"):
            mod.FaultInjector().fail("nope")


@pytest.mark.parametrize("seed,rate,scope", [(7, 0.5, None), (0, 0.2, "r1")])
def test_injector_seeded_rates_match(seed, rate, scope):
    """A seeded rate rule fires on the same checks in both packages (one
    ``default_rng(seed)`` draw per matching check)."""
    calls = [("fail", ("complete",), dict(rate=rate, scope=scope))]
    calls += [("check", ("complete",), dict(scope=s))
              for s in ["r0", "r1"] * 32]
    got, want = _both(calls, seed=seed)
    assert got == want
    fired = sum(d[0] == "InjectedFault" for d in want)
    assert 0 < fired < 64


def test_injector_kill_heartbeat_drop_and_corrupt_match(tmp_path):
    calls = [("kill", ("r1",), {}), ("is_killed", ("r1",), {}),
             ("is_killed", ("r0",), {}), ("revive", ("r1",), {}),
             ("is_killed", ("r1",), {}), ("drop_heartbeats", ("r0", 2), {}),
             ("take_heartbeat_drop", ("r0",), {}),
             ("take_heartbeat_drop", ("r1",), {}),
             ("take_heartbeat_drop", ("r0",), {}),
             ("take_heartbeat_drop", ("r0",), {}), ("kill", ("r2",), {}),
             ("snapshot", (), {})]
    got, want = _both(calls)
    assert got == want
    assert [d[1] for d in want[6:10]] == [True, False, True, False]
    out = []
    for i, mod in enumerate((jserve, tserve)):
        for keep in (None, 7, 0):
            p = tmp_path / f"blob{i}_{keep}.bin"
            p.write_bytes(bytes(range(100)))
            mod.FaultInjector().corrupt_artifact(p, keep_bytes=keep)
            out.append(p.read_bytes())
    assert out[3:] == out[:3] and out[0] == bytes(range(50))


# ----------------------------------------------------- health protocol ------

def _health_script(mod):
    """The reference tests' deadline, hysteresis and fault-threshold
    scenarios on one monitor; every return value, snapshot and event."""
    tracer = mod.SpanTracer()
    hm = mod.HealthMonitor(mod.HealthPolicy(deadline_s=1.0,
                                            fault_threshold=3,
                                            recovery_beats=2),
                           tracer=tracer)
    hm.register("r0", now=0.0)
    hm.register("r1", now=0.0)
    seq = [hm.check(now=0.5), hm.check(now=2.0), hm.healthy("r0"),
           hm.check(now=3.0), hm.beat("r0", ok=False, now=3.05),
           hm.beat("r0", ok=True, now=3.1), hm.beat("r0", ok=False, now=3.15),
           hm.beat("r0", ok=True, now=3.2), hm.beat("r0", ok=True, now=3.3),
           hm.healthy("r0"), hm.healthy_names()]
    hm.beat("r1", ok=True, now=3.4)
    hm.beat("r1", ok=True, now=3.5)
    seq += [hm.fault("r0", "boom", now=3.6), hm.fault("r0", "boom", now=3.7)]
    hm.served("r0")
    seq += [hm.fault("r0", "boom", now=3.8), hm.fault("r0", "boom", now=3.9),
            hm.fault("r0", "boom", now=4.0), hm.fault("r0", "boom", now=4.1),
            hm.healthy("r0"), hm.check(now=4.2), hm.snapshot()]
    events = [(w.name, w.attrs.get("replica"), w.attrs.get("reason"))
              for w in tracer.warning_events()]
    return seq, events


def test_health_transitions_match():
    got, want = _health_script(tserve), _health_script(jserve)
    assert got == want
    seq, events = want
    assert seq[1] == ["r0", "r1"] and seq[7:9] == [None, "up"]
    assert [e[0] for e in events] == ["replica_unhealthy", "replica_unhealthy",
                                      "replica_recovered", "replica_recovered",
                                      "replica_unhealthy"]


# ---------------------------------------------------- validate_reshard ------

@pytest.mark.parametrize("new,match", [
    ([0, 2, 5, 8, 10], None), ([0, 5, 9], "covers"),
    ([0, 7, 5, 10], "monotone")])
def test_validate_reshard_matches(new, match):
    """The same covers pass and the same invariants fail, with the
    reference's messages."""
    old = np.array([0, 5, 10], np.int64)
    msgs = []
    for planner, routing in ((jplanner, JRouting),
                             (tplanner, trouting.RoutingTable)):
        try:
            planner.validate_reshard(routing(old),
                                     routing(np.array(new, np.int64)), 10)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[1] == msgs[0]
    assert (msgs[0] is None) == (match is None)
    if match:
        assert match in msgs[0]


# ----------------------------------------------------------- front door -----

def test_front_door_owns_admission_matches(data, models):
    """One admission controller at the front door: the same submissions
    are rejected before any replica sees them, the rest answered alike."""
    runs = []
    for fd, reps, _ in _tiers(data, models):
        serve = jserve if isinstance(fd, jserve.FrontDoor) else tserve
        fd.admission.set_policy("t0", serve.TenantPolicy(max_queue_depth=2))
        qs = [fd.submit("g", "gcn", i, tenant="t0") for i in range(5)]
        qs += fd.submit_many("g", "gcn", np.arange(5, 12), tenant="t1")
        rejected = [q.qid for q in qs if q.rejected]
        assert rejected and all(q.inner is None for q in qs if q.rejected)
        fd.run_until_drained()
        snap = fd.snapshot()
        runs.append(dict(qs=qs, rejected=rejected,
                         actions=[q.admission.action for q in qs],
                         replicas=[q.replica for q in qs],
                         shed=snap["metrics"]["tenants"]["t0"]["shed"],
                         counts={k: snap[k] for k in (
                             "pending", "orphans", "failovers",
                             "failover_queries", "readmissions",
                             "versions")}))
    want, got = runs
    for k in ("rejected", "actions", "replicas", "shed", "counts"):
        assert got[k] == want[k], k
    assert got["shed"] == len(got["rejected"])
    _same_answers(want["qs"], got["qs"])


def test_front_door_version_pinning_matches(data, models):
    """A feature update fans out to every replica and bumps the pin: the
    query after it is pinned one version later and answered on the new
    features, in both packages alike."""
    runs = []
    for fd, reps, _ in _tiers(data, models):
        x = reps[0].store.graphs["g"].data.x
        orig = x.copy()         # GraphData is shared by the replicas
        try:
            q0 = fd.submit("g", "gcn", 0)
            fd.run_until_drained()
            fd.update_features("g", -orig)
            q1 = fd.submit("g", "gcn", 0)
            assert q1.pinned_version == q0.pinned_version + 1
            assert all(r.graph_version("g") == q1.pinned_version
                       for r in reps)
            fd.run_until_drained()
            assert q0.done and q1.done
            assert not np.array_equal(np.asarray(q0.logits),
                                      np.asarray(q1.logits))
            runs.append(([q0, q1], fd.snapshot()["versions"]))
        finally:
            fd.update_features("g", orig)
    assert runs[1][1] == runs[0][1]
    _same_answers(runs[0][0], runs[1][0])


@pytest.mark.parametrize("spread", ["tenant", "query"])
def test_front_door_placement_matches(data, models, spread):
    """``spread="tenant"``: each tenant lands on its rendezvous-hash
    replica (one replica per tenant); ``spread="query"``: queries
    round-robin. The same replica per query in both packages."""
    tenants = ["alice", "bob", "carol", "dave", "erin", "frank"]
    runs = []
    for fd, reps, _ in _tiers(data, models, spread=spread):
        qs = []
        for t in tenants:
            qs += [fd.submit("g", "gcn", i, tenant=t) for i in range(4)]
        fd.run_until_drained()
        runs.append(qs)
    want, got = runs
    assert [q.replica for q in got] == [q.replica for q in want]
    _same_answers(want, got)
    by_tenant = {}
    for q in got:
        by_tenant.setdefault(q.tenant, set()).add(q.replica)
    if spread == "tenant":
        assert all(len(v) == 1 for v in by_tenant.values())
        assert len(set().union(*by_tenant.values())) == 2
    else:
        assert [q.replica for q in got[:4]] == ["r1", "r0", "r1", "r0"]
    names = [f"r{i}" for i in range(5)]
    assert [trouter._rendezvous(t, names) for t in tenants] \
        == [jrouter._rendezvous(t, names) for t in tenants]
