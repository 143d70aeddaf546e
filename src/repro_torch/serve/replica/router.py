"""Front-door routing over a tier of serving replicas (reference:
``repro/serve/replica/router.py``).

A **replica** is one complete serving stack — its own
:class:`~repro_torch.serve.gnn_session.GraphStore` (own sessions, own
caches, on its own device) plus one engine — wrapped in a
:class:`ReplicaHandle`. The :class:`FrontDoor` owns what the replicas must
agree on:

* **Admission** — ONE :class:`AdmissionController` at the front door makes
  every accept/throttle/shed decision (the per-replica engines run
  permissive default controllers), so a tenant's token budget is global
  across the tier instead of multiplying with the replica count.
* **Consistency pinning** — the front door tracks a per-graph feature
  version; every accepted query is pinned to the version current at submit
  and only routes to replicas whose store is AT that version. A feature
  update (:meth:`FrontDoor.update_features`) fans out to every replica and
  bumps the pin, so a query never mixes pre- and post-update features even
  while replicas converge.
* **Placement** — ``spread="tenant"`` routes each tenant to a stable
  replica by rendezvous hashing (cache affinity: one tenant's working set
  warms one replica); ``spread="query"`` round-robins individual queries
  (uniform load; chaos tests use it to guarantee the killed replica holds
  work).
* **Failover** — the :class:`~repro_torch.serve.replica.health.HealthMonitor`
  watches heartbeats and serve faults; when a replica goes down the front
  door evacuates its accepted-but-unanswered queries (in service order) and
  resubmits them to surviving replicas at the same pinned version. A query
  whose replica dies is answered by a survivor — the submitting caller
  keeps polling the SAME :class:`RoutedQuery` and never learns the
  difference. When no survivor is eligible the queries park in an orphan
  list and re-dispatch as soon as a replica recovers.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..admission import (DEFAULT_TENANT, AdmissionController,
                         AdmissionDecision)
from ..gnn_engine import DrainReport, GNNServeEngine, NodeQuery
from ..gnn_session import GraphStore
from ..metrics import ServeMetrics
from ..trace import SpanTracer
from .health import HealthMonitor, HealthPolicy


class ReplicaHandle:
    """One replica: a name, its private store, and its serving engine.
    The engine can be atomically swapped (the live-reshard path) — new
    submits route to the new engine the instant :meth:`swap_engine`
    returns."""

    def __init__(self, name: str, store: GraphStore,
                 engine: GNNServeEngine):
        self.name = name
        self.store = store
        self.engine = engine
        engine.fault_scope = name

    def beat(self, now: float, faults=None) -> bool:
        """One heartbeat probe: False when the replica is (injected) dead
        or this beat was injected away."""
        if faults is not None:
            if faults.is_killed(self.name):
                return False
            if faults.take_heartbeat_drop(self.name):
                return False
        return True

    def graph_version(self, graph: str) -> int:
        return self.store.graphs[graph].version

    def swap_engine(self, new_engine: GNNServeEngine) -> GNNServeEngine:
        """Atomic intake redirect: returns the OLD engine (the caller
        drains it)."""
        old, self.engine = self.engine, new_engine
        new_engine.fault_scope = self.name
        return old


@dataclasses.dataclass
class RoutedQuery:
    """The front door's view of one query: the caller-facing object that
    survives failover. ``inner`` is the NodeQuery on whichever replica
    currently owns the work (re-pointed on failover); answers delegate to
    it, latency is measured from the FRONT DOOR submit."""
    graph: str
    model: str
    node: int
    tenant: str
    qid: int
    t_submit: float
    pinned_version: int
    replica: Optional[str] = None
    admission: Optional[AdmissionDecision] = None
    inner: Optional[NodeQuery] = None
    failovers: int = 0

    @property
    def done(self) -> bool:
        return self.inner is not None and self.inner.done

    @property
    def logits(self):
        return None if self.inner is None else self.inner.logits

    @property
    def pred(self):
        return None if self.inner is None else self.inner.pred

    @property
    def rejected(self) -> bool:
        return self.admission is not None and not self.admission.accepted

    @property
    def failed(self) -> bool:
        return self.inner is not None and (self.inner.failed
                                           or self.inner.rejected)

    @property
    def settled(self) -> bool:
        return self.rejected or self.done or self.failed

    @property
    def latency_s(self) -> float:
        if self.inner is None or not self.inner.t_done:
            return float("nan")
        return self.inner.t_done - self.t_submit


def _rendezvous(tenant: str, names: List[str]) -> List[str]:
    """Replica preference order for a tenant: highest-random-weight
    (rendezvous) hashing — stable under membership change (losing one
    replica only moves that replica's tenants)."""
    def w(name: str) -> int:
        h = hashlib.blake2b(f"{tenant}|{name}".encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big")
    return sorted(names, key=w, reverse=True)


class FrontDoor:
    """Routes queries across replicas; owns admission, pinning, failover
    (see module docstring)."""

    def __init__(self, replicas: List[ReplicaHandle],
                 admission: Optional[AdmissionController] = None,
                 faults=None, tracer: Optional[SpanTracer] = None,
                 health: Optional[HealthMonitor] = None,
                 policy: Optional[HealthPolicy] = None,
                 spread: str = "tenant"):
        if not replicas:
            raise ValueError("need at least one replica")
        if spread not in ("tenant", "query"):
            raise ValueError(f"spread must be 'tenant' or 'query', "
                             f"got {spread!r}")
        self.replicas: Dict[str, ReplicaHandle] = {
            r.name: r for r in replicas}
        if len(self.replicas) != len(replicas):
            raise ValueError("replica names must be unique")
        self.admission = admission or AdmissionController()
        self.faults = faults
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.health = health or HealthMonitor(policy, tracer=self.tracer)
        self.spread = spread
        self.metrics = ServeMetrics()
        now = time.perf_counter()
        for name in self.replicas:
            self.health.register(name, now)
        # per-graph feature version pin, seeded from the first replica
        # (every replica starts from the same registration sequence)
        first = replicas[0]
        self._versions: Dict[str, int] = {
            g: e.version for g, e in first.store.graphs.items()}
        self._next_qid = 0
        self._rr = 0                      # round-robin cursor (spread=query)
        self._live: Dict[str, List[RoutedQuery]] = {
            r.name: [] for r in replicas}
        self._orphans: deque = deque()    # accepted, no eligible replica yet
        self.finished: deque = deque(maxlen=100_000)   # settled RoutedQueries
        self.failovers = 0                # replica failover events
        self.failover_queries = 0         # queries moved by failovers
        self.readmissions = 0             # recovered replicas re-admitted

    # ----------------------------------------------------------- intake ----
    def _eligible(self, rq: RoutedQuery) -> List[str]:
        """Healthy replicas at the query's pinned feature version, in
        placement-preference order."""
        names = [n for n in self.health.healthy_names()
                 if self.replicas[n].graph_version(rq.graph)
                 == rq.pinned_version]
        if not names:
            return []
        if self.spread == "tenant":
            return _rendezvous(rq.tenant, names)
        names = sorted(names)
        self._rr += 1
        k = self._rr % len(names)
        return names[k:] + names[:k]

    def _dispatch(self, rq: RoutedQuery) -> bool:
        """Try to place ``rq`` on an eligible replica; False -> orphaned."""
        for name in self._eligible(rq):
            handle = self.replicas[name]
            inner = handle.engine.submit(rq.graph, rq.model, rq.node,
                                         tenant=rq.tenant)
            if inner.rejected:         # e.g. the replica is mid-drain
                continue
            rq.inner = inner
            rq.replica = name
            self._live[name].append(rq)
            return True
        return False

    def submit(self, graph: str, model: str, node: int,
               tenant: str = DEFAULT_TENANT) -> RoutedQuery:
        """Admit + route one query. Admission happens HERE, once — the
        outcome (typed decision) rides on the returned RoutedQuery exactly
        like the single-engine API. An accepted query with no eligible
        replica right now is NOT dropped: it parks as an orphan and
        dispatches as soon as a replica recovers or converges to its
        pinned version."""
        now = time.perf_counter()
        rq = RoutedQuery(graph=graph, model=model, node=int(node),
                         tenant=tenant, qid=self._next_qid, t_submit=now,
                         pinned_version=self._versions.get(graph, 0))
        self._next_qid += 1
        rq.admission = self.admission.admit(tenant, now)
        self.metrics.record_admission(tenant, rq.admission.action)
        if not rq.admission.accepted:
            return rq
        self.admission.on_enqueued(tenant)
        self.metrics.start_clock()
        if not self._dispatch(rq):
            self._orphans.append(rq)
        return rq

    def submit_many(self, graph: str, model: str, nodes,
                    tenant: str = DEFAULT_TENANT) -> List[RoutedQuery]:
        return [self.submit(graph, model, n, tenant=tenant)
                for n in np.asarray(nodes)]

    def update_features(self, graph: str, x: np.ndarray) -> None:
        """Fan a feature update out to EVERY replica, then bump the pin:
        queries submitted after this line route only to replicas that took
        the update (all of them, barring a concurrent failure — stragglers
        become ineligible rather than serving stale features)."""
        for handle in self.replicas.values():
            handle.store.update_features(graph, x)
        self._versions[graph] = \
            next(iter(self.replicas.values())).store.graphs[graph].version

    # --------------------------------------------------------- serving ----
    def _settle(self, rq: RoutedQuery) -> None:
        self.admission.on_dequeued(rq.tenant, 1)
        if rq.done:
            self.metrics.queries += 1
            self.metrics.latency.record(rq.latency_s)
            self.metrics.record_tenant_query(rq.tenant, rq.latency_s)
        self.finished.append(rq)

    def _failover(self, name: str) -> None:
        """Evacuate a down replica and move its accepted work to the
        survivors (orphaning what can't be placed)."""
        handle = self.replicas[name]
        moved = handle.engine.evacuate()
        by_qid = {rq.inner.qid: rq for rq in self._live[name]
                  if rq.inner is not None}
        self._live[name] = []
        relocated = orphaned = 0
        for q in moved:                     # evacuation (service) order
            rq = by_qid.get(q.qid)
            if rq is None or rq.settled:
                continue
            rq.failovers += 1
            rq.inner = None
            rq.replica = None
            if self._dispatch(rq):
                relocated += 1
            else:
                self._orphans.append(rq)
                orphaned += 1
        self.failovers += 1
        self.failover_queries += relocated + orphaned
        self.tracer.event("failover", replica=name, moved=len(moved),
                          relocated=relocated, orphaned=orphaned)

    def tick(self) -> int:
        """One supervision + serving round: heartbeat every replica, fail
        the newly-dead over, advance every healthy replica's engine one
        tick (a serving fault counts against its health), re-dispatch
        orphans, and settle finished queries. Returns queries answered."""
        now = time.perf_counter()
        for name, handle in self.replicas.items():
            ok = handle.beat(now, self.faults)
            went_up = self.health.beat(name, ok, now)
            if went_up == "up":
                handle.engine.resume_intake()
                self.readmissions += 1
        for name in self.health.check(now):
            self._failover(name)
        answered = 0
        for name, handle in self.replicas.items():
            if not self.health.healthy(name):
                continue
            if self.faults is not None and self.faults.is_killed(name):
                continue                    # dead replicas don't serve
            try:
                n = handle.engine.tick()
            except Exception as e:
                if self.health.fault(name, repr(e), time.perf_counter()):
                    self._failover(name)
                continue
            if n:
                answered += n
                self.health.served(name)
        # orphan re-dispatch: a recovered/converged replica picks them up
        for _ in range(len(self._orphans)):
            rq = self._orphans.popleft()
            if rq.settled:
                self._settle(rq)
                continue
            if not self._dispatch(rq):
                self._orphans.append(rq)
        # settle finished queries out of the live lists
        for name, live in self._live.items():
            keep = []
            for rq in live:
                if rq.settled:
                    self._settle(rq)
                else:
                    keep.append(rq)
            self._live[name] = keep
        return answered

    @property
    def pending(self) -> int:
        """Accepted queries not yet settled, tier-wide."""
        return (sum(len(v) for v in self._live.values())
                + len(self._orphans))

    def run_until_drained(self, max_ticks: int = 100_000
                          ) -> List[RoutedQuery]:
        """Tick until every accepted query settles (or the tick budget
        runs out — orphans with no recovering replica can wait forever;
        the budget turns that into a visible test failure)."""
        ticks = 0
        while self.pending and ticks < max_ticks:
            self.tick()
            ticks += 1
        self.metrics.stop_clock()
        return list(self.finished)

    def drain(self, timeout_s: float = 30.0) -> Dict[str, DrainReport]:
        """Graceful tier drain: stop intake and flush every healthy
        replica (per-replica :meth:`GNNServeEngine.drain` reports keyed by
        replica name)."""
        reports = {}
        for name, handle in self.replicas.items():
            if self.faults is not None and self.faults.is_killed(name):
                continue
            reports[name] = handle.engine.drain(timeout_s)
        # settle whatever the drains answered
        self.tick()
        self.metrics.stop_clock()
        return reports

    def reshard(self, name: str, graph: str, model: str, to_shards: int,
                artifact_dir=None, drain_timeout_s: float = 30.0):
        """Live-reshard one replica to ``to_shards`` (convenience wrapper
        around :class:`~repro_torch.serve.replica.reshard.Resharder`:
        prepare in the background state, then swap + drain)."""
        from .reshard import Resharder
        rs = Resharder(self.replicas[name], graph, model, to_shards,
                       artifact_dir=artifact_dir,
                       drain_timeout_s=drain_timeout_s, tracer=self.tracer)
        rs.prepare(block=True)
        return rs.swap()

    def snapshot(self) -> dict:
        return dict(
            replicas=sorted(self.replicas),
            health=self.health.snapshot(),
            pending=self.pending, orphans=len(self._orphans),
            failovers=self.failovers,
            failover_queries=self.failover_queries,
            readmissions=self.readmissions,
            versions=dict(self._versions),
            metrics=self.metrics.snapshot(),
            faults=None if self.faults is None else self.faults.snapshot())


def build_replica(name: str, data, models: Dict[str, tuple],
                  n_shards: int = 0, cache_dir=None, graph: str = "g",
                  store_kw: Optional[dict] = None, faults=None,
                  tracer=None, device="cuda", **engine_kw) -> ReplicaHandle:
    """Stand one replica up: a private GraphStore on ``device`` with
    ``data`` registered as ``graph`` and each ``models[name] = (family,
    params)`` entry registered, plus a sharded engine (``n_shards >= 1``)
    or a single-host engine (``n_shards = 0``) over it."""
    from ..sharded import ShardedServeEngine
    store = GraphStore(cache_dir=str(cache_dir) if cache_dir else None,
                       device=device, **(store_kw or {}))
    store.register_graph(graph, data)
    for mname, (family, params) in models.items():
        store.register_model(mname, family, params)
    if n_shards >= 1:
        engine = ShardedServeEngine(store, n_shards, faults=faults,
                                    tracer=tracer, **engine_kw)
    else:
        engine = GNNServeEngine(store, faults=faults, tracer=tracer,
                                **engine_kw)
    return ReplicaHandle(name, store, engine)
