"""The port's serving control plane (``repro_torch.serve.admission``,
``cost``, ``slo``) against the reference's, and the engine driving it, on
``make_dataset("cora", seed=0, scale=0.1)``, the port on the CPU.

Identical in both packages: admission decisions (action, reason, retry
hint, cost-limited flag) under an injected ``now``; the weighted
virtual-time pick order; ``CostEstimate`` fields and the calibration
state; SLO alert sequences and depth feedback on a replayed latency
stream; and, through the engines with ``time.perf_counter`` replaced by a
clock the test sets, the per-query admission decisions, cost units,
served batches and predictions of a multi-tenant run.
"""
import dataclasses
import time
from collections import deque

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402

from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import admission as jadm  # noqa: E402
from repro.serve import cost as jcost  # noqa: E402
from repro.serve import slo as jslo  # noqa: E402
from repro.serve import GNNServeEngine as JEngine  # noqa: E402
from repro.serve import GraphStore as JStore  # noqa: E402
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
tadm = lazy("repro_torch.serve.admission")
tcost = lazy("repro_torch.serve.cost")
tslo = lazy("repro_torch.serve.slo")
tserve = lazy("repro_torch.serve")

jax.config.update("jax_platform_name", "cpu")

BATCH = 8
HIDDEN = 16


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.1)


@pytest.fixture(scope="module")
def stores(data):
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


def _decision(d):
    return (d.action, d.tenant, d.reason, d.retry_after_s, d.cost,
            d.cost_limited)


def _policies(mod):
    return {"hog": mod.TenantPolicy(rate_qps=20.0, burst=4, weight=1,
                                    max_queue_depth=6),
            "gold": mod.TenantPolicy(weight=3),
            "costed": mod.TenantPolicy(cost_rate=50.0, cost_burst=80.0)}


def test_admission_decisions_match_reference():
    """A seeded stream of submissions, services and requeues across a
    rate-limited, a weighted and a cost-budgeted tenant: every decision
    and the backlog after it are the reference's."""
    rng = np.random.default_rng(0)
    ctls = [mod.AdmissionController(policies=_policies(mod))
            for mod in (jadm, tadm)]
    now = 0.0
    for _ in range(400):
        now += float(rng.exponential(0.02))
        tenant = str(rng.choice(["hog", "gold", "costed", "other"]))
        cost = float(rng.uniform(1.0, 40.0))
        out = []
        for ctl in ctls:
            d = ctl.admit(tenant, now=now, cost=cost)
            if d.accepted:
                ctl.on_enqueued(tenant)
            out.append((_decision(d), ctl.backlog(tenant),
                        ctl.effective_depth(tenant)))
        assert out[1] == out[0]
        served = int(rng.integers(0, 3))
        requeued = int(rng.integers(0, 2))
        for ctl in ctls:
            n = min(served, ctl.backlog(tenant))
            if n:
                ctl.on_served(tenant, n, cost=cost * n)
                if requeued:
                    ctl.on_requeued(tenant, 1)
    assert ctls[1].backlog("hog") == ctls[0].backlog("hog")


class _Q:
    def __init__(self, t):
        self.t_submit = t


def test_weighted_pick_matches_reference():
    """Start-time fair queueing with the staleness bound: the same queues
    give the same pick sequence and pick decisions (vtime, overdue)."""
    rng = np.random.default_rng(1)
    arrivals = sorted((float(rng.uniform(0, 2.0)),
                       str(rng.choice(["hog", "gold", "costed"])))
                      for _ in range(90))
    runs = []
    for mod in (jadm, tadm):
        ctl = mod.AdmissionController(policies=_policies(mod),
                                      staleness_bound_s=0.5)
        queues = {}
        for t, tenant in arrivals:
            key = ("g", "m", tenant)
            dq = queues.setdefault(key, deque())
            dq.append(_Q(t))
            if len(dq) == 1:
                ctl.push_head(key, tenant, t)
        order = []
        for step in range(90):
            key = ctl.pick(queues, now=0.02 * step)
            if key is None:
                break
            n = min(2, len(queues[key]))
            for _ in range(n):
                queues[key].popleft()
            ctl.on_served(key[-1], n, cost=float(n * (step % 5 + 1)))
            if queues[key]:
                ctl.push_head(key, key[-1], queues[key][0].t_submit)
            order.append((key, dict(ctl.last_pick)))
        runs.append(order)
    assert runs[1] == runs[0]
    assert len(runs[0]) > 30


def test_cost_estimates_match_reference(stores, data):
    """``CostEstimate`` fields for full-cache, k-hop and halo-charged
    queries, and the calibration state after the same observed batches."""
    jst, tst = stores
    jcsr, tcsr = jst.graphs["g"].csr, tst.graphs["g"].csr
    ests = [jcost.CostEstimator(), tcost.CostEstimator()]
    rng = np.random.default_rng(2)
    for node in rng.integers(0, data.n_nodes, 40):
        for kw in (dict(full_cache=True), dict(khop=2),
                   dict(khop=2, halo_rows=int(node % 7) * 16,
                        row_bytes=4 * data.x.shape[1])):
            got = ests[1].estimate("g", int(node), tcsr, **kw)
            want = ests[0].estimate("g", int(node), jcsr, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert ests[1].is_whale(got) == ests[0].is_whale(want)
    for _ in range(12):
        units, secs = float(rng.uniform(10, 900)), float(rng.uniform(0.001,
                                                                     0.1))
        n_pad = int(rng.choice([64, 128, 256]))
        for est in ests:
            est.observe_batch(units, secs, n_pad=n_pad)
    shares = [est.attribute([1.0, 5.0, 0.0, 2.5], 0.04) for est in ests]
    assert shares[1] == shares[0]
    assert ests[1].snapshot() == ests[0].snapshot()
    a = rng.integers(0, 5, 30).astype(float)
    b = a + rng.normal(0, 1, 30)
    assert tcost.spearman_rho(a, b) == jcost.spearman_rho(a, b)


def test_slo_alerts_match_reference():
    """A replayed latency/rejection stream: the same alerts fire at the
    same checks, the depth feedback lands on the admission controllers
    alike, and the snapshots agree."""
    rng = np.random.default_rng(3)
    stream = []
    t = 0.0
    for i in range(600):
        t += float(rng.exponential(0.01))
        bad_phase = 200 <= i < 320
        stream.append((t, str(rng.choice(["hog", "gold"])),
                       float(rng.exponential(0.05 if bad_phase else 0.004)),
                       bool(bad_phase and rng.random() < 0.3)))
    out = []
    for adm_mod, slo_mod in ((jadm, jslo), (tadm, tslo)):
        adm = adm_mod.AdmissionController(policies=_policies(adm_mod))
        slo = slo_mod.SLOTracker(
            {"hog": slo_mod.SLOPolicy(target_p99_ms=20.0, availability=0.95,
                                      window_s=2.0, short_window_s=0.25),
             "gold": slo_mod.SLOPolicy(target_p99_ms=10.0,
                                       availability=0.99, window_s=2.0,
                                       short_window_s=0.25)})
        alerts, depths = [], []
        for i, (now, tenant, lat, rej) in enumerate(stream):
            if rej:
                slo.observe(tenant, now, rejected=True)
            else:
                slo.observe(tenant, now, latency_s=lat)
            if i % 10 == 9:
                alerts.append(slo.check(now, adm))
                depths.append(adm.effective_depth("hog"))
        out.append((alerts, depths, slo.snapshot(stream[-1][0])))
    assert out[1] == out[0]
    assert sum(len(a) for a in out[0][0]) > 0


def _engine_run(engine_cls, adm_mod, cost_mod, slo_mod, store, nodes,
                clock):
    adm = adm_mod.AdmissionController(policies=_policies(adm_mod),
                                      staleness_bound_s=0.05)
    slo = slo_mod.SLOTracker({"gold": slo_mod.SLOPolicy(
        target_p99_ms=1.0, availability=0.99, window_s=1.0,
        short_window_s=0.1)})
    engine = engine_cls(store, max_batch=BATCH, mode="full",
                        admission=adm, cost=cost_mod.CostEstimator(),
                        slo=slo)
    engine.warmup("g", "gcn")
    qs = []
    for i, (tenant, node) in enumerate(nodes):
        clock[0] = 100.0 + 0.004 * i
        qs.append(engine.submit("g", "gcn", node, tenant=tenant))
        if i % 5 == 4:
            clock[0] += 0.002
            engine.tick()
    clock[0] += 1.0
    engine.run_until_drained()
    snap = engine.snapshot()
    return dict(
        decisions=[_decision(q.admission) for q in qs],
        units=[q.cost.units for q in qs],
        log=[[q.qid for q in b] for b in engine.batch_log],
        preds=[q.pred for q in qs],
        tenants={t: {k: v for k, v in st.items()
                     if k in ("accepted", "throttled", "shed", "queries",
                              "cost_throttled", "cost_units")}
                 for t, st in snap["tenants"].items()},
        counters=(snap["batches"], snap["queries"], snap["full_cache_hits"],
                  snap["subgraph_queries"], snap["compiles"],
                  snap["dispatches"]),
        alerts=snap["slo"]["tenants"]["gold"]["alerts"])


def test_engine_admission_cost_slo_match_reference(stores, data,
                                                   monkeypatch):
    """A multi-tenant engine run with admission, cost and SLO wired in,
    under a clock the test sets: the port's decisions, cost units, batches,
    per-tenant counts, counters and predictions are the reference's."""
    jst, tst = stores
    rng = np.random.default_rng(4)
    nodes = [(str(rng.choice(["hog", "gold", "costed"])),
              int(rng.integers(0, data.n_nodes))) for _ in range(60)]
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    want = _engine_run(JEngine, jadm, jcost, jslo, jst, nodes, clock)
    got = _engine_run(tserve.GNNServeEngine, tadm, tcost, tslo, tst, nodes,
                      clock)
    monkeypatch.undo()
    for k in want:
        assert got[k] == want[k], k
    actions = {d[0] for d in got["decisions"]}
    assert {"accept", "throttle"} <= actions
