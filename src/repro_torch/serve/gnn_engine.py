"""GNN serving engine: micro-batched node-level query scheduler
(reference: ``repro/serve/gnn_engine.py``).

Requests (``NodeQuery``: answer node-classification for one node of one
registered graph under one registered model) join per-session FIFO queues.
The serving hot path is an explicit two-stage pipeline:

  * **extract** — queue pick (incremental oldest-head heap) -> batch
    formation -> deterministic k-hop extraction around the batch's seeds ->
    subgraph FRDC build -> shape-bucket padding. The pick and the
    adoption of new features (the session's ``sync``, card work) run on
    the main thread; the rest is pure host work: producing a
    :class:`~repro_torch.serve.session_core.PreparedBatch` touches no
    device (numpy and CPU tensors only).
  * **compute** — copy the staged arrays to the session's device and
    launch the bucketed forward's kernels on the current stream (the host
    returns with the work in flight), wait for the result, gather
    per-query logits.

With ``pipeline_depth == 0`` (the default) each :meth:`tick` runs both
stages back-to-back — the serial loop. With ``pipeline_depth >= 1`` the
extract stage runs on a background worker and up to ``pipeline_depth``
launched forwards stay in flight, so extraction of batch *i+1* overlaps the
device computation of batch *i* (double-buffering at depth 1). Both loops
drive the SAME session stages in the SAME batch order, so their outputs are
bit-exact — the pipeline changes when work happens, never what is computed.

Two serve paths per batch: **full-cache** (the session's cached full-graph
inference; a numpy gather, resolved entirely in the extract stage) and
**micro-batched subgraph** (the prepared-batch path above). ``mode="auto"``
uses the full cache below ``full_cache_max_nodes`` and the subgraph path
above it. Latency is measured submit -> answer, so queueing delay is
included (p50/p99 are end-to-end); per-batch extract/compute stage times
and the overlap ratio land in :class:`~repro_torch.serve.metrics.ServeMetrics`.

An in-flight batch on the card carries a ``torch.cuda.Event`` recorded on
the launching stream right after its launch: ``_oldest_ready`` queries it,
so the light-traffic completion never blocks on a batch the card has not
finished. Batches on the CPU are ready when their launch returns.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .admission import (DEFAULT_TENANT, SHED, AdmissionController,
                        AdmissionDecision)
from .cost import CostEstimate, CostEstimator
from .gnn_session import CompiledGraphSession, GraphStore
from .metrics import ServeMetrics
from .session_core import FAMILY_AGG_LAYERS, launch_prepared_many
from .slo import SLOTracker
from .trace import RecompileWatchdog, SpanTracer, TransferWatchdog


def _record_ready(devs) -> Optional[object]:
    """A CUDA event recorded on the current stream of the first handle on
    the card (the stream the launch put its kernels on), or None when no
    handle lies on the card."""
    for d in devs or ():
        if isinstance(d, torch.Tensor) and d.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d.device))
            return ev
    return None


@dataclasses.dataclass(frozen=True)
class QueryFailure:
    """Typed terminal failure of one accepted query: the engine retried its
    batch ``attempts`` times and gave up (``reason="max_retries"``), so the
    query is dropped with this record attached instead of wedging the
    pipeline forever. ``stage`` names the pipeline stage of the final
    error, ``error`` its repr."""
    reason: str
    stage: str
    attempts: int
    error: str


@dataclasses.dataclass
class DrainReport:
    """Outcome of one :meth:`GNNServeEngine.drain`: queries answered during
    the drain window, accepted-but-unserved queries typed-shed at the
    deadline, queries that exhausted their retries while draining, and
    whether the deadline fired at all."""
    answered: int
    shed: int
    failed: int
    elapsed_s: float
    timed_out: bool

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class NodeQuery:
    """One node-classification request and, once served, its answer.

    ``tenant`` tags the submitter for admission control and weighted
    scheduling; ``admission`` is the typed decision its submission drew —
    a throttled/shed query is returned immediately (``rejected`` True,
    never queued, never ``done``) so the caller can back off or retry."""
    graph: str
    model: str
    node: int
    qid: int = -1
    t_submit: float = 0.0
    t_done: float = 0.0
    logits: Optional[np.ndarray] = None
    pred: Optional[int] = None
    tenant: str = DEFAULT_TENANT
    admission: Optional[AdmissionDecision] = None
    # submit-time predicted cost (None when the engine has no estimator)
    cost: Optional[CostEstimate] = None
    # trace context: submit() stamps qid/t_submit/admission above; when the
    # query is picked into a batch this links it to that batch's BatchTrace
    trace_id: int = -1
    # bounded-retry state: service attempts this query's batches have
    # burned, and the typed terminal failure once they exceed max_retries
    attempts: int = 0
    failure: Optional[QueryFailure] = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def done(self) -> bool:
        return self.pred is not None

    @property
    def rejected(self) -> bool:
        return self.admission is not None and not self.admission.accepted

    @property
    def failed(self) -> bool:
        """Accepted but terminally dropped (retries exhausted)."""
        return self.failure is not None

    @property
    def settled(self) -> bool:
        """Nothing more will happen to this query: answered, rejected at
        admission, or terminally failed."""
        return self.done or self.rejected or self.failed


@dataclasses.dataclass
class _Inflight:
    """One micro-batch moving through the pipeline: extract-stage output
    plus the in-flight device handles the compute stage fills in."""
    key: tuple
    batch: List[NodeQuery]
    session: object
    seeds: np.ndarray
    prepared: object                  # PreparedBatch, or None = full-cache
    result: Optional[np.ndarray]      # full-cache answer (extract-resolved)
    t_start: float
    extract_s: float
    t_launch: float = 0.0
    t_launch_end: float = 0.0
    devs: Optional[list] = None
    trace: Optional[object] = None    # BatchTrace (when tracing is on)
    coalesced: int = 1                # buckets sharing this batch's dispatch
    ready: Optional[object] = None    # torch.cuda.Event after a card launch


class GNNServeEngine:
    """Micro-batching scheduler over a :class:`GraphStore`'s sessions."""

    # model-family namespace: stamped on the metrics snapshot (and from
    # there onto every Prometheus series) and on watchdog warning events,
    # so a GNN engine and a token engine exported from one process never
    # collide. Subclasses override (TokenServeEngine: per-store kind).
    family = "gnn"

    def __init__(self, store: GraphStore, max_batch: Optional[int] = None,
                 mode: str = "auto", full_cache_max_nodes: int = 200_000,
                 keep_finished: int = 100_000, pipeline_depth: int = 0,
                 admission: Optional[AdmissionController] = None,
                 tracer: Optional[SpanTracer] = None, trace: bool = True,
                 cost: Optional[CostEstimator] = None,
                 slo: Optional[SLOTracker] = None,
                 multi_bucket: bool = False, faults=None,
                 max_retries: int = 8, retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 2.0):
        if mode not in ("auto", "full", "subgraph"):
            raise ValueError(mode)
        if max_retries < 1:
            raise ValueError(f"max_retries must be >= 1, got {max_retries}")
        self.store = store
        self.max_batch = max_batch or store.max_batch
        if self.max_batch > store.max_batch:
            raise ValueError(
                f"engine max_batch {self.max_batch} exceeds the store's "
                f"session seed-slot width {store.max_batch}")
        self.mode = mode
        self.full_cache_max_nodes = full_cache_max_nodes
        self.pipeline_depth = int(pipeline_depth)
        # multi-bucket co-launch: a pipelined fill defers its launches and
        # dispatches every newly extracted bucket as ONE program per serve
        # core (ServeCore.launch_many: the K forwards back to back on the
        # stream, counted as one dispatch) — bit-exact vs serial launches.
        # Needs pipeline_depth >= 2 to ever coalesce; no effect on the
        # serial (depth 0) loop.
        self.multi_bucket = bool(multi_bucket)
        self.metrics = ServeMetrics(family=self.family)
        self._queues: Dict[tuple, Deque[NodeQuery]] = {}
        self._next_qid = 0
        # queue-structure guard: the pipelined extract stage (pick + pop)
        # runs on the background worker concurrently with submit()
        self._qlock = threading.Lock()
        # tenancy: admission decisions at submit + the weighted virtual-time
        # scheduler that generalizes the old lazy oldest-head heap (every
        # mutating call happens under _qlock). The default controller admits
        # everything and weights every tenant equally — the pre-tenancy
        # engine behavior.
        self.admission = admission or AdmissionController()
        # pipeline state: one background extraction + launched batches
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._extract_future = None
        self._inflight: Deque[_Inflight] = deque()
        self._last_done = 0.0        # completion clock (compute attribution)
        self._unanswered = 0         # queued + in-flight (drain condition)
        # bounded: callers hold the authoritative NodeQuery objects from
        # submit(); this is a convenience tail for drain-style use, not an
        # unbounded log of every answer a long-running engine ever produced
        self.finished: Deque[NodeQuery] = deque(maxlen=keep_finished)
        # served batch compositions (most recent), the replay source for
        # bit-exactness oracles under reordering batch formation
        self.batch_log: Deque[List[NodeQuery]] = deque(maxlen=4096)
        # observability: the span tracer (every served batch flows through
        # it; retention is sampled) and the two serving watchdogs. Pass
        # trace=False to make the whole layer a no-op, or inject a
        # configured SpanTracer (capacity/sampling) to share one ring
        # buffer across engines.
        self.tracer = tracer if tracer is not None \
            else SpanTracer(enabled=trace)
        self.recompile_watchdog = RecompileWatchdog(self.tracer,
                                                    family=self.family)
        self.transfer_watchdog = TransferWatchdog(self.tracer,
                                                  family=self.family)
        self._wired_sessions: set = set()
        # closed-loop cost/SLO observability (both opt-in; None preserves
        # the cost-unaware engine exactly): the estimator predicts each
        # submission's cost units from host statics — admission charges
        # them, fair queueing weights by them, and measured batch time
        # calibrates them — while the SLO tracker turns the answered/
        # rejected stream into error budgets that feed back into admission
        # depth. Both are driven under _qlock.
        self.cost = cost
        self.slo = slo
        if slo is not None and slo.tracer is None:
            slo.tracer = self.tracer
        # chaos seam: a replica.FaultInjector (duck-typed: anything with
        # check(op, scope=...)) consulted at the extract/launch/complete
        # stage boundaries; None = no injection. fault_scope tags this
        # engine's checks (the replica tier sets it to the replica name so
        # per-replica fault rules match).
        self.faults = faults
        self.fault_scope: Optional[str] = None
        # bounded retry: a requeued batch backs its queue off exponentially
        # (+ deterministic jitter) and each member query burns one attempt;
        # past max_retries the query is dropped with a typed QueryFailure
        # instead of requeueing forever
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        self._retry_rng = np.random.default_rng(0)
        self._backoff: Dict[tuple, float] = {}   # key -> pickable-again time
        # drain/evacuate state: a draining engine typed-sheds new intake
        self._draining = False

    # ------------------------------------------------------------ intake ----
    def submit(self, graph: str, model: str, node: int,
               tenant: str = DEFAULT_TENANT) -> NodeQuery:
        """Enqueue one node query for ``tenant``. Request validation raises
        here (a malformed request is the submitting caller's bug); admission
        outcomes do NOT — a throttled or shed query comes back immediately
        with its typed :class:`AdmissionDecision` attached and is never
        queued, so one tenant over quota can never crash (or clog) a tick
        that is also carrying other tenants' queries."""
        if graph not in self.store.graphs:
            raise KeyError(f"unknown graph {graph!r}; "
                           f"have {sorted(self.store.graphs)}")
        if model not in self.store.models:
            raise KeyError(f"unknown model {model!r}; "
                           f"have {sorted(self.store.models)}")
        n = self.store.graphs[graph].data.n_nodes
        node = int(node)
        if not 0 <= node < n:
            raise ValueError(f"node {node} out of range for graph "
                             f"{graph!r} with {n} nodes")
        q = NodeQuery(graph=graph, model=model, node=node, tenant=tenant)
        # cost prediction is pure host work over cached topology statics —
        # never under the lock (first touch of a node walks its closure)
        q.cost = self._estimate_cost(graph, model, node)
        return self._admit_enqueue(q, self._queue_key(graph, model, node,
                                                      tenant))

    def _admit_enqueue(self, q, key: tuple):
        """Family-neutral intake tail shared by every engine's ``submit``:
        stamp the qid, run admission under the queue lock, and enqueue on
        acceptance. ``q`` needs the query protocol fields (tenant, cost,
        admission, t_submit) and ``q.cost`` already estimated."""
        tenant = q.tenant
        q.qid, self._next_qid = self._next_qid, self._next_qid + 1
        charge = q.cost.units if q.cost is not None else 1.0
        with self._qlock:
            q.t_submit = time.perf_counter()
            if self._draining:
                # intake is stopped (drain/evacuation): typed shed without
                # burning the tenant's tokens — resume_intake() re-opens
                q.admission = AdmissionDecision(
                    SHED, tenant, reason="engine draining: intake stopped")
                self.metrics.record_admission(tenant, SHED)
                return q
            q.admission = self.admission.admit(tenant, q.t_submit,
                                               cost=charge)
            self.metrics.record_admission(
                tenant, q.admission.action,
                cost=(charge if q.admission.accepted else 0.0),
                cost_limited=q.admission.cost_limited)
            if not q.admission.accepted:
                if self.slo is not None:
                    self.slo.observe(tenant, q.t_submit, rejected=True)
                    self.slo.check(q.t_submit, self.admission)
                return q
            self.admission.on_enqueued(tenant)
            dq = self._queues.setdefault(key, deque())
            dq.append(q)
            self._unanswered += 1
            if len(dq) == 1:                  # q became a queue head
                self._heap_push(key, q.t_submit)
        self.metrics.start_clock()
        return q

    def _queue_key(self, graph: str, model: str, node: int,
                   tenant: str = DEFAULT_TENANT) -> tuple:
        """Queue routing hook: one FIFO per (graph, model, tenant) here; the
        sharded engine additionally keys by the node's owning shard so every
        served micro-batch is a single-owner group. The tenant is always the
        LAST key component (the admission controller's convention), so
        batches never mix tenants — per-tenant latency attribution and the
        sharded engine's single-owner co-batching both survive tenancy."""
        return (graph, model, tenant)

    # ------------------------------------------------------- cost model ----
    def _estimate_cost(self, graph: str, model: str,
                       node: int) -> Optional[CostEstimate]:
        """Submit-time cost prediction (None without an estimator). Pure
        host statics: the graph entry's cached CSR index, the model
        family's aggregation depth, and the halo-row hook — no session is
        resolved, so submit never compiles anything."""
        if self.cost is None:
            return None
        entry = self.store.graphs[graph]
        if self.mode == "full" or (
                self.mode == "auto"
                and entry.data.n_nodes <= self.full_cache_max_nodes):
            return self.cost.estimate(graph, node, entry.csr,
                                      full_cache=True)
        family = self.store.models[model].family
        halo_rows, row_bytes = self._cost_halo_rows(graph, model, node)
        return self.cost.estimate(
            graph, node, entry.csr,
            khop=FAMILY_AGG_LAYERS.get(family, 2),
            halo_rows=halo_rows, row_bytes=row_bytes)

    def _cost_halo_rows(self, graph: str, model: str,
                        node: int) -> Tuple[int, int]:
        """(halo feature rows, bytes per row) the query's seed will pull
        from remote shards — 0 on the single-host path; the sharded engine
        overrides this from its static halo signatures."""
        return 0, 0

    def submit_many(self, graph: str, model: str, nodes: np.ndarray,
                    tenant: str = DEFAULT_TENANT) -> List[NodeQuery]:
        return [self.submit(graph, model, n, tenant=tenant)
                for n in np.asarray(nodes)]

    @property
    def pending(self) -> int:
        """Queries not yet ANSWERED — queued plus extracted/launched
        in-flight batches, so the classic ``while engine.pending:
        engine.tick()`` drain idiom cannot exit with launched batches
        still unanswered under pipelining."""
        with self._qlock:
            return self._unanswered

    def _queued(self) -> int:
        """Queries still sitting in the queues (the pipeline fill check —
        in-flight batches are NOT re-extractable)."""
        with self._qlock:
            return sum(len(q) for q in self._queues.values())

    def _sessions(self):
        """The store sessions this engine class serves from (the sharded
        engine overrides this to its partitioned sessions)."""
        return self.store._sessions.values()

    @property
    def compile_count(self) -> int:
        """Total new programs across all sessions this engine has touched —
        the 'zero steady-state recompiles' acceptance counter."""
        return sum(s.compile_count for s in self._sessions())

    @property
    def dispatch_count(self) -> int:
        """Total device dispatches across the engine's sessions — the
        launches-per-tick regression counter (a multi-bucket co-launch of K
        buckets moves this by 1, not K)."""
        return sum(getattr(s, "dispatch_count", 0)
                   for s in self._sessions())

    # --------------------------------------------------------- scheduling ---
    def _heap_push(self, key: tuple, t: float) -> None:
        self.admission.push_head(key, key[-1], t)

    def _pick_queue(self) -> Optional[tuple]:
        """Next queue to serve (caller holds ``_qlock``): the admission
        controller's weighted virtual-time pick — oldest head within a
        tenant, weighted fair across tenants, overdue heads (past the
        staleness bound) globally FIFO. With a single tenant this is
        exactly the old lazy oldest-head heap pick.

        Queues inside a retry-backoff window are invisible to the pick (and
        to the staleness preemption — the backoff must win, and it is
        bounded by ``retry_backoff_max_s``); when a window expires its
        queue's head is re-pushed, since the scheduler's lazy heaps may
        have dropped it while the queue looked empty."""
        queues = self._queues
        if self._backoff:
            now = time.perf_counter()
            for k in [k for k, t in self._backoff.items() if t <= now]:
                del self._backoff[k]
                dq = self._queues.get(k)
                if dq:
                    self._heap_push(k, dq[0].t_submit)
            if self._backoff:
                queues = {k: dq for k, dq in self._queues.items()
                          if k not in self._backoff}
        return self.admission.pick(queues)

    def _backoff_hold_s(self) -> Optional[float]:
        """Seconds until the earliest backed-off queue with live work
        becomes pickable — but only when backed-off queues are the ONLY
        queued work (None otherwise): the drain loops sleep on this instead
        of spinning against an all-backed-off queue set."""
        with self._qlock:
            if not self._backoff:
                return None
            if any(dq and k not in self._backoff
                   for k, dq in self._queues.items()):
                return None
            held = [t for k, t in self._backoff.items()
                    if self._queues.get(k)]
            if not held:
                return None
            return max(0.0, min(held) - time.perf_counter())

    def _pop_batch(self, key: tuple, session) -> List[NodeQuery]:
        """Batch formation (caller holds ``_qlock``): FIFO pop of up to
        ``max_batch`` head requests. The sharded engine overrides this with
        halo-aware formation (``session`` is the already-resolved serving
        session, so no session work happens under the lock)."""
        dq = self._queues[key]
        return [dq.popleft() for _ in range(min(self.max_batch, len(dq)))]

    def _requeue(self, key: tuple, batch: List[NodeQuery],
                 stage: str = "", error: str = "") -> None:
        """Restore a popped-but-unserved batch to the FRONT of its queue
        (extract/compute failure path: the queries must not be lost) —
        under the BOUNDED retry discipline: each member query burns one
        attempt; queries past ``max_retries`` are dropped with a typed
        :class:`QueryFailure` (counted in ``metrics.retry_shed``) instead
        of requeueing forever, and the survivors' queue backs off
        exponentially with deterministic jitter before it becomes pickable
        again — a poison batch can no longer wedge the pipeline or starve
        its neighbors by hot-spinning the retry path."""
        now = time.perf_counter()
        survivors: List[NodeQuery] = []
        exhausted: List[NodeQuery] = []
        for q in batch:
            q.attempts += 1
            (exhausted if q.attempts > self.max_retries
             else survivors).append(q)
        with self._qlock:
            self.metrics.requeues += 1
            if survivors:
                dq = self._queues.setdefault(key, deque())
                for q in reversed(survivors):
                    dq.appendleft(q)
                self.admission.on_requeued(key[-1], len(survivors))
                self._heap_push(key, dq[0].t_submit)
                attempt = max(q.attempts for q in survivors)
                delay = min(self.retry_backoff_max_s,
                            self.retry_backoff_s * 2.0 ** (attempt - 1))
                delay *= 1.0 + 0.5 * float(self._retry_rng.random())
                self._backoff[key] = max(self._backoff.get(key, 0.0),
                                         now + delay)
            for q in exhausted:
                q.failure = QueryFailure(reason="max_retries", stage=stage,
                                         attempts=q.attempts, error=error)
                q.t_done = now
                self.metrics.retry_shed += 1
                self._unanswered -= 1
                self.finished.append(q)
                if self.slo is not None:
                    self.slo.observe(q.tenant, now, rejected=True)
        if exhausted:
            self.tracer.event(
                "retry_exhausted", key=list(key), stage=stage, error=error,
                qids=[q.qid for q in exhausted],
                attempts=exhausted[0].attempts)

    def _check_fault(self, op: str) -> None:
        """Chaos seam: consult the injected FaultInjector (if any) at a
        stage boundary — a matching rule raises InjectedFault, which flows
        through the SAME requeue/retry path as a real stage failure."""
        if self.faults is not None:
            self.faults.check(op, scope=self.fault_scope)

    def _use_full_cache(self, session) -> bool:
        if self.mode == "full":
            return True
        if self.mode == "subgraph":
            return False
        return session.graph.data.n_nodes <= self.full_cache_max_nodes

    def _get_session(self, key: Tuple[str, ...]):
        """Resolve a queue key (first two entries: graph, model) to the
        session answering it (hook: the sharded engine resolves to a
        partitioned session instead)."""
        return self.store.session(*key[:2])

    def _wire_session(self, session):
        """Wire the recompile watchdog into a session's new-program hook the
        first time this engine touches it (idempotent per session)."""
        if id(session) not in self._wired_sessions:
            self._wired_sessions.add(id(session))
            set_hook = getattr(session, "set_trace_hook", None)
            if set_hook is not None:
                set_hook(self.recompile_watchdog.on_recompile)
        return session

    # ------------------------------------------------------ trace hooks ----
    def _trace_shard(self, key: tuple) -> Optional[int]:
        """Owning shard of a queue key (None here; the sharded engine keys
        queues by owner)."""
        return None

    def _trace_bucket(self, prepared) -> dict:
        """Launch-shape summary of a PreparedBatch for its trace."""
        if prepared is None:
            return {}
        return dict(groups=[
            dict(n_pad=int(g.staged.x_pad.shape[0]),
                 g_pad={str(k): int(a["group_row"].shape[0])
                        for k, a in g.staged.adjs.items()})
            for g in prepared.groups])

    def _trace_halo_begin(self, session):
        """Pre-extraction token for per-batch halo attribution (the sharded
        engine snapshots the serve-path halo byte counters here)."""
        return None

    def _trace_halo_end(self, session, token) -> dict:
        return {}

    # ------------------------------------------------------------- stages ---
    def _pick_stage(self) -> Optional[tuple]:
        """EXTRACT head, on the calling (main) thread: pick the next queue,
        resolve its session and adopt the store's current features. The
        adoption is the card work of the extract stage (a feature upload,
        BN recalibration, the full-graph cache refresh), so it runs here and
        the worker's body stays host-only. Returns ``(key, session, pick)``
        or None. At most one extraction is outstanding, so the pick sees the
        queue state the worker's pop will see."""
        with self._qlock:
            key = self._pick_queue()
            pick = self.admission.last_pick or {}
        if key is None:
            return None
        # resolving the session may build it (first touch) — never under
        # the lock. The pick stays valid: only the (single) extractor pops,
        # and new submits are strictly newer than the picked head.
        session = self._wire_session(self._get_session(key))
        session.sync()
        return key, session, pick

    def _extract_stage(self, picked: Optional[tuple] = None
                       ) -> Optional[_Inflight]:
        """EXTRACT: queue pick -> batch formation -> k-hop extraction ->
        FRDC build -> bucket pad. The body after the pick is pure host work
        — the pipelined engine runs it on the background worker (with the
        ``picked`` result of :meth:`_pick_stage`, made on the main thread)
        while the previous batch's forward is in flight on the card.
        Full-cache batches resolve entirely here (the cached pass is a
        numpy gather; there is nothing to overlap).

        Only the queue surgery runs under ``_qlock``, so submit() never
        blocks on extraction. A failure after the pop requeues the batch at
        the front of its queue before re-raising: queries are never
        silently lost."""
        if picked is None:
            picked = self._pick_stage()
        if picked is None:
            return None
        key, session, pick = picked
        self._prepare_formation(key, session)
        with self._qlock:
            batch = self._pop_batch(key, session)
            if batch:
                # virtual-time + backlog accounting of the service start;
                # with a cost model the virtual charge is the batch's
                # predicted units, so expensive batches push their tenant
                # further back than cheap ones of the same size
                served_cost = None
                if self.cost is not None:
                    served_cost = sum(q.cost.units for q in batch
                                      if q.cost is not None)
                self.admission.on_served(key[-1], len(batch),
                                         cost=served_cost)
        if not batch:
            return None
        t0 = time.perf_counter()
        tr = None
        if self.tracer.enabled:
            tr = self.tracer.begin(key, key[-1], self._trace_shard(key),
                                   batch, t0,
                                   vtime=float(pick.get("vtime", 0.0)),
                                   overdue=bool(pick.get("overdue", False)))
        try:
            self._check_fault("extract")
            halo_token = self._trace_halo_begin(session) \
                if tr is not None else None
            seeds, result, prepared = self._prepare_stage(session, batch)
            extract_s = time.perf_counter() - t0
            if tr is not None:
                tr.full_cache = prepared is None
                tr.bucket = self._trace_bucket(prepared)
                tr.halo = self._trace_halo_end(session, halo_token)
                tr.span("extract", t0, t0 + extract_s)
            if prepared is not None:
                self.transfer_watchdog.check_prepared(prepared)
            return _Inflight(key=key, batch=batch, session=session,
                             seeds=seeds, prepared=prepared, result=result,
                             t_start=t0, extract_s=extract_s, trace=tr)
        except BaseException as e:
            self._requeue(key, batch, stage="extract", error=repr(e))
            self.tracer.commit(tr, error=repr(e), requeued=True)
            raise

    def _prepare_formation(self, key: tuple, session) -> None:
        """Pre-formation hook, called OUTSIDE ``_qlock``: a subclass whose
        batch formation needs per-request metadata (the sharded engine's
        halo signatures) warms its caches here so the locked pop does no
        session work."""

    def _prepare_stage(self, session, batch):
        """Family-specific EXTRACT body: turn a popped batch into either an
        immediate result (full-cache gather) or a launch-ready
        ``PreparedBatch``; returns ``(seeds, result, prepared)`` with
        exactly one of result/prepared set. The token engine overrides
        this to stage prompt chunks instead of k-hop subgraphs."""
        seeds = np.asarray([q.node for q in batch], np.int64)
        if self._use_full_cache(session):
            return seeds, session.full_logits()[seeds], None
        return seeds, None, session.prepare_batch(seeds)

    def _launch_stage(self, inf: _Inflight) -> None:
        """COMPUTE head: upload and launch the forward(s) — returns with the
        device work in flight (a CUDA event marks its end). Deliberately
        counts NOTHING: a launch/complete failure requeues the batch and
        retries it, so the serve-path counters must only move in the
        (single) successful completion — counting here double-counted
        retried batches and drifted ``cache_hit_rate``."""
        self._check_fault("launch")
        inf.t_launch = time.perf_counter()
        if inf.prepared is not None:
            inf.devs = inf.session.launch_batch(inf.prepared)
            self.transfer_watchdog.check_launched(
                inf.devs, getattr(inf.session, "device", None))
            inf.ready = _record_ready(inf.devs)
        inf.t_launch_end = time.perf_counter()

    def _launch_coalesced(self, infs: List[_Inflight]) -> None:
        """Multi-bucket COMPUTE head: co-dispatch every deferred batch's
        staged buckets as one program per serve core
        (:func:`~repro_torch.serve.session_core.launch_prepared_many` —
        bit-exact vs the serial launches). On the card the K forwards go
        out back to back, the same calls serial launches make, so this only
        holds the fill's launches until it ends; it can gain once the
        composition is captured as one CUDA graph (ROADMAP Q2-R4).
        Full-cache batches (already resolved at extract) just get their
        launch window stamped. A
        failure requeues EVERY deferred batch and drops them from the
        pipeline, mirroring the single-batch launch failure path."""
        t0 = time.perf_counter()
        device_infs = [inf for inf in infs if inf.prepared is not None]
        try:
            self._check_fault("launch")
            devs_lists = launch_prepared_many(
                [inf.prepared for inf in device_infs])
        except BaseException as e:
            for inf in infs:
                try:
                    self._inflight.remove(inf)
                except ValueError:
                    pass
                self._requeue(inf.key, inf.batch, stage="launch",
                              error=repr(e))
                self.tracer.commit(inf.trace, error=repr(e), requeued=True)
                inf.trace = None
            raise
        t1 = time.perf_counter()
        for inf, devs in zip(device_infs, devs_lists):
            inf.devs = devs
            self.transfer_watchdog.check_launched(
                inf.devs, getattr(inf.session, "device", None))
            inf.ready = _record_ready(inf.devs)
        for inf in infs:
            inf.t_launch, inf.t_launch_end = t0, t1
            inf.coalesced = len(device_infs) if inf.prepared is not None \
                else 1

    def _complete_stage(self, inf: _Inflight) -> int:
        """COMPUTE tail: block on the device result, gather per-query
        answers, record metrics. Returns queries answered.

        The compute-stage time attributed to THIS batch starts at its
        launch or at the previous batch's completion, whichever is later:
        completions are sequential, so in a saturated pipeline the span
        launch -> done would double-count the older batches' device time
        and inflate the overlap ratio."""
        self._check_fault("complete")
        if inf.prepared is None:
            logits = inf.result
        else:
            logits = inf.session.finish_batch(inf.prepared, inf.devs)
        t_done = time.perf_counter()
        # serve-path counters move here — after the batch can no longer
        # fail into the requeue/retry path — so they are retry-invariant
        if inf.prepared is None:
            self.metrics.full_cache_hits += len(inf.batch)
        else:
            self.metrics.subgraph_queries += len(inf.batch)
        self.metrics.batches += 1
        self.metrics.batch_latency.record(t_done - inf.t_start)
        compute_attr_s = t_done - max(inf.t_launch, self._last_done)
        self.metrics.record_stages(inf.extract_s, compute_attr_s)
        self._last_done = t_done
        # cost calibration + attribution: the batch's measured service
        # seconds (host extraction + de-overlapped device compute) fold
        # into the estimator's units-per-second EWMAs and split back
        # across the member queries pro rata by predicted units
        if self.cost is not None:
            units = [q.cost.units if q.cost is not None else 0.0
                     for q in inf.batch]
            pred_units = sum(units)
            service_s = inf.extract_s + compute_attr_s
            n_pad = 0
            if inf.prepared is not None:
                n_pad = max((int(g.staged.x_pad.shape[0])
                             for g in inf.prepared.groups), default=0)
            self.cost.observe_batch(pred_units, service_s, n_pad=n_pad)
            shares = self.cost.attribute(units, service_s)
            for q, share in zip(inf.batch, shares):
                self.metrics.record_tenant_cost_attributed(q.tenant, share)
            if inf.trace is not None:
                inf.trace.cost = dict(
                    pred_units=pred_units, measured_s=service_s,
                    n_pad=n_pad, units=units, attributed_s=shares)
        if inf.trace is not None:
            t_le = inf.t_launch_end or t_done
            # co-launched batches share one dispatch: their launch spans
            # carry the coalesced bucket count (and literally the same
            # [t0, t1) window) so a trace shows one device dispatch per
            # multi-bucket tick, not one per batch
            if inf.coalesced > 1:
                inf.trace.span("launch", inf.t_launch, t_le,
                               coalesced=inf.coalesced)
            else:
                inf.trace.span("launch", inf.t_launch, t_le)
            # the wall span launch_end -> done plus the de-overlapped time
            # this batch actually contributed (what record_stages summed)
            inf.trace.span("compute", t_le, t_done,
                           attributed_s=compute_attr_s)
            inf.trace.t_end = t_done
            self.tracer.commit(inf.trace)
            inf.trace = None
        self._deliver(inf, logits)
        for q in inf.batch:
            q.t_done = t_done
            self.metrics.queries += 1
            self.metrics.latency.record(q.latency_s)
            self.metrics.record_tenant_query(q.tenant, q.latency_s)
            self.finished.append(q)
        self.batch_log.append(list(inf.batch))
        with self._qlock:
            self._unanswered -= len(inf.batch)
            if self.slo is not None:
                for q in inf.batch:
                    self.slo.observe(q.tenant, t_done,
                                     latency_s=q.latency_s)
                self.slo.check(t_done, self.admission)
        return len(inf.batch)

    def _deliver(self, inf: _Inflight, result) -> None:
        """Family-specific answer delivery: write each member query's
        answer fields from the batch result. Node queries get their logits
        row + argmax class; the token engine writes generated-token arrays
        instead. Timing/metrics/finished bookkeeping stays in
        :meth:`_complete_stage` — this only fills the answers."""
        preds = np.argmax(result, axis=-1)
        for q, lg, p in zip(inf.batch, result, preds):
            q.logits = np.asarray(lg)
            q.pred = int(p)

    # ------------------------------------------------------------- serve ----
    def _worker(self) -> concurrent.futures.ThreadPoolExecutor:
        """The single extract worker (one thread: extraction order IS batch
        order, which the bit-exactness and water-mark guarantees key on)."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-extract")
        return self._pool

    def _submit_extract(self) -> bool:
        """Pick on this thread and hand the extraction body to the worker;
        False when every queued key is inside a retry-backoff window."""
        picked = self._pick_stage()
        if picked is None:
            return False
        self._extract_future = self._worker().submit(self._extract_stage,
                                                     picked)
        return True

    def _pump(self, block: bool) -> int:
        """Advance the pipeline: keep one extraction on the worker and up to
        ``pipeline_depth`` launched forwards in flight; complete the oldest
        batch when the pipeline is full (always, when ``block``). With
        ``multi_bucket`` the fill's launches are DEFERRED and every bucket
        extracted this tick goes out as one co-dispatch after the fill."""
        deferred: List[_Inflight] = []
        try:
            while len(self._inflight) < self.pipeline_depth:
                if self._extract_future is None:
                    if not self._queued() or not self._submit_extract():
                        break
                try:
                    inf = self._extract_future.result()
                finally:
                    # a failed extraction must not wedge the pipeline: the
                    # stage already requeued its batch, so clearing the
                    # future lets the next tick retry after the caller sees
                    # the error
                    self._extract_future = None
                if inf is None:
                    break
                # hand the NEXT extraction to the worker BEFORE launching
                # this batch, so it overlaps the device time of everything
                # in flight
                if self._queued():
                    try:
                        self._submit_extract()
                    except BaseException as e:
                        # the pick's session work failed: this batch was
                        # popped but not launched, so it must not be lost
                        self._requeue(inf.key, inf.batch, stage="extract",
                                      error=repr(e))
                        self.tracer.commit(inf.trace, error=repr(e),
                                           requeued=True)
                        raise
                if self.multi_bucket:
                    deferred.append(inf)
                    self._inflight.append(inf)
                else:
                    self._compute(inf, launch_only=True)
                    self._inflight.append(inf)
        except BaseException:
            # batches deferred earlier in this fill are extracted and in
            # the pipeline: launch them before the error goes up, so none
            # is left in flight without a launch
            if deferred:
                self._launch_coalesced(deferred)
            raise
        if deferred:
            self._launch_coalesced(deferred)
        # complete the oldest batch when the pipeline is full — or when the
        # input is drained AND its device result is already available:
        # light traffic must not strand launched batches behind a depth
        # gate only more traffic could open, but a momentarily empty queue
        # must not serialize the pipeline by blocking on in-flight work
        # the next wave could still overlap.
        drained_input = (not self._queued()
                         and self._extract_future is None)
        if self._inflight and (block
                               or len(self._inflight) >= self.pipeline_depth
                               or (drained_input and self._oldest_ready())):
            return self._compute(self._inflight.popleft(),
                                 complete_only=True)
        return 0

    def _oldest_ready(self) -> bool:
        """Whether the oldest in-flight batch can be completed without
        blocking: full-cache batches resolved at extract time, batches on
        the CPU when their launch returned, batches on the card once the
        CUDA event recorded after their launch has completed."""
        inf = self._inflight[0]
        if inf.devs is None or inf.ready is None:
            return True
        return bool(inf.ready.query())

    def _compute(self, inf: _Inflight, launch_only: bool = False,
                 complete_only: bool = False) -> int:
        """Run the compute stage (launch and/or complete) with the
        never-lose-queries guarantee: a failure in either half requeues the
        batch at the front of its queue before re-raising, mirroring the
        extract stage's failure path."""
        try:
            if not complete_only:
                self._launch_stage(inf)
            if launch_only:
                return 0
            return self._complete_stage(inf)
        except BaseException as e:
            stage = "complete" if complete_only or inf.t_launch_end \
                else "launch"
            self._requeue(inf.key, inf.batch, stage=stage, error=repr(e))
            self.tracer.commit(inf.trace, error=repr(e), requeued=True)
            inf.trace = None
            raise

    def _step(self, block: bool) -> int:
        t0 = time.perf_counter()
        try:
            if self.pipeline_depth <= 0:
                inf = self._extract_stage()
                if inf is None:
                    return 0
                return self._compute(inf)
            return self._pump(block)
        finally:
            self.metrics.serve_wall_s += time.perf_counter() - t0

    def tick(self) -> int:
        """Serve ONE pipeline step. Serial engine: extract + compute one
        micro-batch (the oldest-waiting queue's head of line). Pipelined
        engine: fill the pipeline and complete the oldest batch once it is
        full — early ticks return 0 while the pipeline ramps; completions
        then stream one batch per tick. Returns queries answered."""
        return self._step(block=False)

    def run_until_drained(self, max_ticks: int = 100_000) -> List[NodeQuery]:
        ticks = 0
        while ticks < max_ticks and (
                self.pending or self._inflight
                or self._extract_future is not None):
            n = self._step(block=True)
            if (n == 0 and not self._inflight
                    and self._extract_future is None):
                # all remaining work is behind retry-backoff windows:
                # sleep toward the earliest expiry instead of spinning
                hold = self._backoff_hold_s()
                if hold:
                    time.sleep(min(hold, 0.05))
            ticks += 1
        self.metrics.stop_clock()
        return list(self.finished)

    def close(self) -> None:
        """Shut the background extract worker down (idempotent; the engine
        keeps working — a later pipelined tick restarts it)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ------------------------------------------------ drain / evacuation ----
    def resume_intake(self) -> None:
        """Re-open intake after a :meth:`drain` or :meth:`evacuate` (the
        replica tier's recovery re-admission path)."""
        with self._qlock:
            self._draining = False

    def _shed_queued(self, reason: str) -> List[NodeQuery]:
        """Typed-shed every queued (not in-flight) query: each gets a SHED
        AdmissionDecision naming ``reason``, is counted in
        ``metrics.drain_shed``, and lands in ``finished`` so drain-style
        callers still see it. Caller must NOT hold ``_qlock``."""
        now = time.perf_counter()
        shed: List[NodeQuery] = []
        with self._qlock:
            for key, dq in self._queues.items():
                while dq:
                    q = dq.popleft()
                    q.admission = AdmissionDecision(
                        SHED, q.tenant, reason=reason)
                    q.t_done = now
                    # NOT record_admission: the submission was already
                    # counted as accepted — drain_shed is its own counter
                    self.metrics.drain_shed += 1
                    self._unanswered -= 1
                    self.admission.on_dequeued(q.tenant, 1)
                    self.finished.append(q)
                    if self.slo is not None:
                        self.slo.observe(q.tenant, now, rejected=True)
                    shed.append(q)
            self._backoff.clear()
        return shed

    def drain(self, timeout_s: float = 30.0) -> DrainReport:
        """Graceful drain: stop intake (new submits typed-shed), serve the
        backlog until empty or ``timeout_s``, then typed-shed whatever is
        still queued and flush the in-flight pipeline batches. Always
        terminates; never loses an accepted query silently — every query is
        answered, typed-shed (``drain_shed``), or typed-failed
        (``retry_shed``) by the time this returns. Intake stays stopped
        (see :meth:`resume_intake`)."""
        t0 = time.perf_counter()
        answered0 = self.metrics.queries
        failed0 = self.metrics.retry_shed
        with self._qlock:
            self._draining = True
        deadline = t0 + float(timeout_s)
        while (self.pending or self._inflight
               or self._extract_future is not None):
            if time.perf_counter() >= deadline:
                break
            try:
                n = self._step(block=True)
            except Exception:
                # stage failures already requeued their batch; keep draining
                n = 0
            if (n == 0 and not self._inflight
                    and self._extract_future is None):
                hold = self._backoff_hold_s()
                if hold:
                    left = deadline - time.perf_counter()
                    time.sleep(max(0.0, min(hold, 0.05, left)))
        # deadline path: shed the queues FIRST so _step can't refill the
        # pipeline, then flush launched/extracting batches; a flush failure
        # requeues, so re-shed each iteration until nothing is in flight
        shed: List[NodeQuery] = []
        if (self.pending or self._inflight
                or self._extract_future is not None):
            reason = f"drain timeout after {timeout_s:g}s"
            shed.extend(self._shed_queued(reason))
            while self._inflight or self._extract_future is not None:
                try:
                    self._step(block=True)
                except Exception:
                    pass
                shed.extend(self._shed_queued(reason))
        self.metrics.stop_clock()
        elapsed = time.perf_counter() - t0
        report = DrainReport(
            answered=self.metrics.queries - answered0, shed=len(shed),
            failed=self.metrics.retry_shed - failed0,
            elapsed_s=elapsed, timed_out=bool(shed))
        self.tracer.event("drain", **report.to_json())
        return report

    def evacuate(self) -> List[NodeQuery]:
        """Failover evacuation: stop intake, resolve the background
        extraction, and hand back EVERY accepted-but-unanswered query (in
        service order: in-flight batches oldest-first, then queued by
        submit order) with pipeline state cleared — the front door resubmits
        them to a surviving replica. Unlike :meth:`drain` this never runs
        another compute step: a dead/dying replica cannot be trusted to
        answer, only to surrender its queries."""
        with self._qlock:
            self._draining = True
        fut, self._extract_future = self._extract_future, None
        if fut is not None:
            try:
                inf = fut.result()
                if inf is not None:
                    self._inflight.append(inf)
            except BaseException:
                pass  # the stage already requeued its batch
        self.close()
        out: List[NodeQuery] = []
        while self._inflight:
            inf = self._inflight.popleft()
            self.tracer.commit(inf.trace, error="evacuated", requeued=True)
            inf.trace = None
            out.extend(inf.batch)
        with self._qlock:
            queued: List[NodeQuery] = []
            for key, dq in self._queues.items():
                while dq:
                    q = dq.popleft()
                    self.admission.on_dequeued(q.tenant, 1)
                    queued.append(q)
            queued.sort(key=lambda q: (q.t_submit, q.qid))
            out.extend(queued)
            self._unanswered -= len(out)
            self._backoff.clear()
        return out

    def engine_config(self) -> dict:
        """Constructor kwargs that rebuild an engine equivalent to this one
        (minus the store/topology args the caller supplies): the reshard
        path uses this to spin the P' engine up with the same admission
        policies, tracer ring, retry discipline, and chaos seam."""
        return dict(
            max_batch=self.max_batch, mode=self.mode,
            full_cache_max_nodes=self.full_cache_max_nodes,
            keep_finished=self.finished.maxlen,
            pipeline_depth=self.pipeline_depth,
            admission=self.admission.spawn(), tracer=self.tracer,
            cost=self.cost, slo=self.slo, multi_bucket=self.multi_bucket,
            faults=self.faults, max_retries=self.max_retries,
            retry_backoff_s=self.retry_backoff_s,
            retry_backoff_max_s=self.retry_backoff_max_s)

    # ------------------------------------------------------------ warmup ----
    def warmup(self, graph: str, model: str, probes: int = 16,
               seed: int = 0) -> int:
        """Pre-populate a session's shape buckets (and its full cache)
        so the serving loop runs with zero steady-state recompiles. Returns
        the number of compiles the warmup triggered.

        Also the recompile watchdog's arming point: compiles during warmup
        are expected (disarmed); once warmup returns, the engine is in
        steady state and any further new program fires a structured
        ``recompile`` warning."""
        self.recompile_watchdog.disarm()
        try:
            session = self._wire_session(self._get_session((graph, model)))
            session.sync()
            if self._use_full_cache(session):
                # steady state serves from the cache sync just built
                return 0
            return session.warmup(np.random.default_rng(seed),
                                  probes=probes)
        finally:
            self.recompile_watchdog.arm()

    def snapshot(self) -> dict:
        inval = sum(s.invalidations for s in self._sessions())
        extra = dict(
            compiles=self.compile_count, invalidations=inval,
            dispatches=self.dispatch_count,
            pending=self.pending, pipeline_depth=self.pipeline_depth,
            multi_bucket=self.multi_bucket,
            watchdogs=dict(recompile=self.recompile_watchdog.snapshot(),
                           transfer=self.transfer_watchdog.snapshot()),
            trace=self.tracer.snapshot())
        if self.cost is not None:
            extra["cost"] = self.cost.snapshot()
        if self.slo is not None:
            extra["slo"] = self.slo.snapshot(time.perf_counter())
        return self.metrics.snapshot(extra=extra)
