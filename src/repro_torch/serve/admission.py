"""Multi-tenant admission control + weighted fair scheduling for the GNN
serving engines (reference: ``repro/serve/admission.py``, copied).

Two concerns live here, both previously inlined (or absent) in
:class:`~repro_torch.serve.gnn_engine.GNNServeEngine`:

  * **Admission** — every ``submit()`` is checked against the submitting
    tenant's :class:`TenantPolicy` BEFORE it touches a queue: a token bucket
    enforces the tenant's sustained rate (``rate_qps``, burst capacity
    ``burst``), and ``max_queue_depth`` bounds the tenant's queued backlog.
    The outcome is a typed :class:`AdmissionDecision` — ``accept`` /
    ``throttle`` (rate limit, with a ``retry_after_s`` hint) / ``shed``
    (overload) — attached to the returned query, NEVER an exception: one
    tenant blowing its quota must bounce back to that tenant's caller, not
    crash a tick that is also carrying other tenants' queries.

  * **Scheduling** — the engine's queue pick generalizes the lazy
    oldest-head heap to **weighted start-time fair queueing across
    tenants**: each tenant carries a virtual time that advances by
    ``cost / weight`` whenever one of its queues is served (``cost``
    defaulting to the batch size, or the batch's predicted cost units when
    the engine carries a
    :class:`~repro_torch.serve.cost.CostEstimator`), and the pick goes to
    the backlogged tenant with the smallest virtual start tag
    (FIFO oldest-head WITHIN a tenant — with a single tenant this is
    exactly the pre-tenancy scheduler). Higher-weight tenants therefore
    drain proportionally faster under contention, while the **staleness
    bound** keeps the scheduler starvation-free: any queue head that has
    waited longer than ``staleness_bound_s`` preempts the virtual-time
    order and is served globally FIFO among the overdue — a weight-1 tenant
    behind a weight-100 firehose still sees every request picked within
    (roughly) the bound plus one batch service time.

The controller is NOT internally locked: the engine already serializes
queue surgery under its ``_qlock`` and calls every mutating method while
holding it.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Deque, Dict, List, Optional, Tuple

DEFAULT_TENANT = "default"

ACCEPT = "accept"
THROTTLE = "throttle"
SHED = "shed"


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant serving contract.

    ``rate_qps``         sustained admission rate (token-bucket refill);
                         ``inf`` disables rate limiting.
    ``burst``            bucket capacity — how far above the sustained rate
                         a short spike may go; defaults to
                         ``max(1, rate_qps)`` (one second of traffic).
    ``weight``           scheduler share: under contention a tenant drains
                         proportionally to its weight (integer >= 1).
    ``max_queue_depth``  queued-backlog bound; submissions beyond it are
                         shed (``None`` = unbounded).
    ``cost_rate``        cost budget in predicted cost units per second
                         (``None`` disables cost charging): when the engine
                         carries a
                         :class:`~repro_torch.serve.cost.CostEstimator`,
                         a second token bucket charges each submission its
                         PREDICTED units instead of 1 — a tenant nominally
                         under its QPS limit but submitting hub-node whales
                         drains this bucket and is throttled on cost.
    ``cost_burst``       cost-bucket capacity; defaults to one second of
                         budget (``max(1, cost_rate)``).
    """
    rate_qps: float = math.inf
    burst: Optional[float] = None
    weight: int = 1
    max_queue_depth: Optional[int] = None
    cost_rate: Optional[float] = None
    cost_burst: Optional[float] = None

    def __post_init__(self):
        if not self.rate_qps > 0:
            raise ValueError(f"rate_qps must be > 0, got {self.rate_qps}")
        if self.burst is not None and not self.burst >= 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if int(self.weight) != self.weight or self.weight < 1:
            raise ValueError(f"weight must be an integer >= 1, "
                             f"got {self.weight}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, "
                             f"got {self.max_queue_depth}")
        if self.cost_rate is not None and not self.cost_rate > 0:
            raise ValueError(f"cost_rate must be > 0, got {self.cost_rate}")
        if self.cost_burst is not None and not self.cost_burst >= 1:
            raise ValueError(f"cost_burst must be >= 1, "
                             f"got {self.cost_burst}")

    @property
    def bucket_capacity(self) -> float:
        if self.burst is not None:
            return float(self.burst)
        return math.inf if math.isinf(self.rate_qps) \
            else max(1.0, self.rate_qps)

    @property
    def cost_bucket_capacity(self) -> float:
        if self.cost_burst is not None:
            return float(self.cost_burst)
        return math.inf if self.cost_rate is None \
            else max(1.0, self.cost_rate)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Typed outcome of one ``submit()`` admission check. ``cost`` is the
    predicted cost units the submission was charged (1.0 when no cost
    estimator is wired in)."""
    action: str                      # ACCEPT | THROTTLE | SHED
    tenant: str
    reason: str = ""
    retry_after_s: float = 0.0
    cost: float = 1.0

    @property
    def accepted(self) -> bool:
        return self.action == ACCEPT

    @property
    def cost_limited(self) -> bool:
        """Whether the cost-unit budget (not the QPS rate) throttled it."""
        return self.action == THROTTLE and self.reason.startswith("cost")


class _TokenBucket:
    """Continuous-refill token bucket. The admission rate bucket takes one
    token per query; the cost bucket charges predicted cost units."""

    __slots__ = ("rate", "capacity", "tokens", "t_last")

    def __init__(self, rate: float, capacity: float, now: float):
        self.rate = rate
        self.capacity = capacity
        self.tokens = capacity
        self.t_last = now

    def try_take(self, now: float, cost: float = 1.0) -> Tuple[bool, float]:
        """Take ``cost`` tokens; returns (ok, retry_after_s). The charge is
        clamped to the bucket capacity so a single whale beyond the burst
        needs a FULL bucket rather than being unadmittable forever."""
        if math.isinf(self.rate):
            return True, 0.0
        need = min(float(cost), self.capacity)
        self.tokens = min(self.capacity,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= need:
            self.tokens -= need
            return True, 0.0
        return False, (need - self.tokens) / self.rate

    def refund(self, cost: float) -> None:
        self.tokens = min(self.capacity, self.tokens + float(cost))


class AdmissionController:
    """Tenant policies + admission state + the weighted fair scheduler.

    Queue keys are opaque tuples whose LAST component is the tenant (the
    engines' ``_queue_key`` convention); the controller never inspects the
    rest. Scheduler state is the per-tenant lazy oldest-head heap (the same
    stale-entry discipline the pre-tenancy engine heap used) plus the
    virtual clocks of start-time fair queueing.
    """

    # admits between sweeps of quiescent per-tenant state (buckets that
    # have refilled to capacity, expired virtual-time debt, zero backlogs)
    SWEEP_EVERY = 4096

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 staleness_bound_s: float = 1.0):
        self.default_policy = default_policy or TenantPolicy()
        self.staleness_bound_s = float(staleness_bound_s)
        self._policies: Dict[str, TenantPolicy] = dict(policies or {})
        self._buckets: Dict[str, _TokenBucket] = {}
        self._cost_buckets: Dict[str, _TokenBucket] = {}
        self._backlog: Dict[str, int] = {}
        # SLO feedback: multiplier on a tenant's max_queue_depth (the
        # SLOTracker's autotune shrinks it under sustained budget burn)
        self._depth_scale: Dict[str, float] = {}
        # weighted virtual time: per-tenant finish tags + the global clock
        self._vtime: Dict[str, float] = {}
        self._vclock = 0.0
        # per-tenant lazy oldest-head heaps: (head t_submit, seq, key)
        self._heaps: Dict[str, List[Tuple[float, int, tuple]]] = {}
        # the incremental pick() structure (the heap-over-virtual-start-
        # tags refactor): a lazy min-heap of (virtual start, head t_submit,
        # seq, tenant) scheduling tags. Entries go stale (served heads,
        # advanced virtual clocks) and are corrected or dropped at pop
        # time; ranks only ever increase, so the lazy-min argument of the
        # pre-tenancy oldest-head heap carries over.
        self._tags: List[Tuple[float, float, int, str]] = []
        # tenants whose virtual time moved since the last pick (their tags
        # must be refreshed before the next pop)
        self._dirty: set = set()
        self._seq = 0
        self._admits_since_sweep = 0
        # scheduling decision of the most recent pick() that returned a
        # queue — tenant, its virtual start tag, and whether the staleness
        # bound preempted the virtual-time order. Read by the engines (under
        # the same lock discipline as every other mutating call) to tag the
        # served batch's trace with WHY it was scheduled.
        self.last_pick: Optional[dict] = None

    # ------------------------------------------------------------ policy ----
    def policy(self, tenant: str) -> TenantPolicy:
        return self._policies.get(tenant, self.default_policy)

    def spawn(self) -> "AdmissionController":
        """A fresh controller carrying the same policies/staleness bound but
        none of the runtime state (buckets, backlogs, virtual clocks). The
        replica tier uses this to give each engine generation — a resharded
        replacement, a rebuilt replica — its own controller serialized under
        its own ``_qlock`` while preserving the tenant contracts; sharing
        one controller across two live engines would race their locks."""
        return AdmissionController(policies=dict(self._policies),
                                   default_policy=self.default_policy,
                                   staleness_bound_s=self.staleness_bound_s)

    def set_policy(self, tenant: str, policy: TenantPolicy) -> None:
        """Install (or replace) a tenant's policy; its token buckets
        restart full at the new rates."""
        self._policies[tenant] = policy
        self._buckets.pop(tenant, None)
        self._cost_buckets.pop(tenant, None)

    def backlog(self, tenant: str) -> int:
        """Queries currently queued (not yet popped into a batch)."""
        return self._backlog.get(tenant, 0)

    # ------------------------------------------------------- SLO feedback ---
    def set_depth_scale(self, tenant: str, scale: float) -> None:
        """Install the SLO autotuner's multiplier on the tenant's
        ``max_queue_depth`` (clamped to (0, 1]; 1.0 clears the override)."""
        scale = min(max(float(scale), 1e-6), 1.0)
        if scale >= 1.0:
            self._depth_scale.pop(tenant, None)
        else:
            self._depth_scale[tenant] = scale

    def effective_depth(self, tenant: str) -> Optional[int]:
        """The tenant's depth bound after SLO feedback (None = unbounded)."""
        depth = self.policy(tenant).max_queue_depth
        if depth is None:
            return None
        return max(1, int(depth * self._depth_scale.get(tenant, 1.0)))

    # --------------------------------------------------------- admission ----
    def admit(self, tenant: str, now: Optional[float] = None,
              cost: float = 1.0) -> AdmissionDecision:
        """Decide one submission charged ``cost`` predicted units. Depth is
        checked before either bucket so a shed (overload) submission does
        not also burn tokens; the cost budget is checked before the QPS
        rate (and refunded on a rate throttle) so a rejected submission
        never burns both."""
        now = time.perf_counter() if now is None else now
        self._admits_since_sweep += 1
        if self._admits_since_sweep >= self.SWEEP_EVERY:
            self._sweep(now)
        pol = self.policy(tenant)
        depth = self._backlog.get(tenant, 0)
        limit = self.effective_depth(tenant)
        if limit is not None and depth >= limit:
            reason = f"queue depth {depth} at limit {limit}"
            if limit != pol.max_queue_depth:
                reason += f" (SLO-scaled from {pol.max_queue_depth})"
            return AdmissionDecision(SHED, tenant, reason=reason, cost=cost)
        cost_bucket = None
        if pol.cost_rate is not None:
            cost_bucket = self._cost_buckets.get(tenant)
            if cost_bucket is None:
                cost_bucket = _TokenBucket(pol.cost_rate,
                                           pol.cost_bucket_capacity, now)
                self._cost_buckets[tenant] = cost_bucket
            ok, retry = cost_bucket.try_take(now, cost)
            if not ok:
                return AdmissionDecision(
                    THROTTLE, tenant, retry_after_s=retry, cost=cost,
                    reason=f"cost budget {pol.cost_rate:g} units/s "
                           f"exceeded (charge {cost:g})")
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = _TokenBucket(pol.rate_qps, pol.bucket_capacity, now)
            self._buckets[tenant] = bucket
        ok, retry = bucket.try_take(now)
        if not ok:
            if cost_bucket is not None:
                cost_bucket.refund(cost)
            return AdmissionDecision(
                THROTTLE, tenant, retry_after_s=retry, cost=cost,
                reason=f"rate limit {pol.rate_qps:g} qps exceeded")
        return AdmissionDecision(ACCEPT, tenant, cost=cost)

    def _sweep(self, now: float) -> None:
        """Drop quiescent per-tenant state, so high-cardinality tenant ids
        (per-user tags) don't grow the controller without bound. Buckets
        refilled to capacity and zero backlogs are exact state
        equivalences; pruning an IDLE tenant's virtual-time tag forgives
        at most its last batch / weight of residual debt — the standard
        fair-queueing semantics for a flow that drains and re-arrives
        (debt is only load-bearing while the tenant stays backlogged,
        which is exactly when its heap keeps the tag alive)."""
        self._admits_since_sweep = 0
        for buckets in (self._buckets, self._cost_buckets):
            for t, b in list(buckets.items()):
                if math.isinf(b.rate) \
                        or b.tokens + (now - b.t_last) * b.rate >= b.capacity:
                    del buckets[t]
        for t in list(self._vtime):
            if t not in self._heaps and self._backlog.get(t, 0) == 0:
                del self._vtime[t]
        for t in list(self._backlog):
            if self._backlog[t] == 0:
                del self._backlog[t]

    # --------------------------------------------------------- scheduler ----
    def on_enqueued(self, tenant: str) -> None:
        self._backlog[tenant] = self._backlog.get(tenant, 0) + 1

    def push_head(self, key: tuple, tenant: str, t_submit: float) -> None:
        """Record that ``key``'s queue (re)gained a head submitted at
        ``t_submit`` — the lazy-heap push of the pre-tenancy scheduler, now
        into the tenant's own heap PLUS the incremental pick() structure:
        the tenant's scheduling tag."""
        self._seq += 1
        heapq.heappush(self._heaps.setdefault(tenant, []),
                       (t_submit, self._seq, key))
        heapq.heappush(self._tags,
                       (self._vstart(tenant), t_submit, self._seq, tenant))

    def _vstart(self, tenant: str) -> float:
        """The tenant's current virtual start tag."""
        return max(self._vtime.get(tenant, 0.0), self._vclock)

    def _peek(self, tenant: str, queues: Dict[tuple, Deque]
              ) -> Optional[Tuple[float, tuple]]:
        """Valid oldest head of one tenant's heap (lazy refresh: entries
        whose recorded head was served or reordered away are dropped and
        the live head re-pushed)."""
        heap = self._heaps.get(tenant)
        while heap:
            t, _, key = heap[0]
            dq = queues.get(key)
            if not dq:
                heapq.heappop(heap)
                continue
            if dq[0].t_submit != t:
                heapq.heappop(heap)
                self.push_head(key, tenant, dq[0].t_submit)
                continue
            return t, key
        # fully drained: drop the tenant's heap so pick() only ever scans
        # tenants with live backlog (push_head recreates it on demand)
        if heap is not None:
            del self._heaps[tenant]
        return None

    def _push_tag(self, tenant: str, queues: Dict[tuple, Deque]) -> None:
        """Refresh one tenant's scheduling tag after its virtual time moved
        (no-op for tenants with no live head)."""
        cur = self._peek(tenant, queues)
        if cur is None:
            return
        self._seq += 1
        heapq.heappush(self._tags,
                       (self._vstart(tenant), cur[0], self._seq, tenant))

    def pick(self, queues: Dict[tuple, Deque],
             now: Optional[float] = None) -> Optional[tuple]:
        """The queue to serve next.

        Overdue heads (waiting past ``staleness_bound_s``) win globally in
        FIFO order — the starvation bound. Otherwise the backlogged tenant
        with the smallest virtual start tag wins, ties broken by oldest
        head — which, with one tenant, IS the oldest-head pick of the
        pre-tenancy heap.

        Cost: the rank selection is O(log) amortized per pick via the
        lazy tag heap (instead of the previous O(#backlogged tenants)
        re-ranking scan with a heap peek per tenant). Lazy-min argument:
        virtual starts and head timestamps only ever increase
        (``on_served`` advances vtime; served heads are replaced by
        younger ones; ``on_requeued`` restores go back through
        ``push_head``, which pushes a fresh tag), so every backlogged
        tenant always owns at least one tag ranked <= its true rank —
        popping stale tags and re-pushing at most one corrected tag per
        tenant per pick cannot skip the minimum. The staleness watchdog
        stays a direct sweep of live queue heads (one float compare each):
        overdue-ness is a function of wall-clock NOW, not of any event the
        lazy structure could have witnessed.
        """
        now = time.perf_counter() if now is None else now
        horizon = now - self.staleness_bound_s
        overdue_key, overdue_t = None, math.inf
        for key, dq in queues.items():
            if dq and dq[0].t_submit <= horizon \
                    and dq[0].t_submit < overdue_t:
                overdue_key, overdue_t = key, dq[0].t_submit
        if overdue_key is not None:
            tenant = overdue_key[-1]
            self.last_pick = dict(tenant=tenant,
                                  vtime=self._vstart(tenant), overdue=True)
            return overdue_key
        for tenant in self._dirty:
            self._push_tag(tenant, queues)
        self._dirty.clear()
        fixed: set = set()
        heap = self._tags
        while heap:
            vstart, head_t, _, tenant = heap[0]
            cur = self._peek(tenant, queues)
            if cur is None:
                heapq.heappop(heap)
                continue
            true_vstart = self._vstart(tenant)
            if vstart != true_vstart or head_t != cur[0]:
                heapq.heappop(heap)
                if tenant not in fixed:
                    fixed.add(tenant)
                    self._seq += 1
                    heapq.heappush(
                        heap, (true_vstart, cur[0], self._seq, tenant))
                continue
            self.last_pick = dict(tenant=tenant, vtime=true_vstart,
                                  overdue=False)
            return cur[1]
        return None

    def on_served(self, tenant: str, n: int,
                  cost: Optional[float] = None) -> None:
        """Account one popped batch: the tenant's virtual time advances by
        ``cost / weight`` from its start tag — ``cost`` defaulting to the
        batch size ``n``, or the batch's summed PREDICTED cost units when
        the engine carries a cost estimator (so an expensive hub batch
        pushes its tenant further back in virtual time than a cheap
        full-cache batch of the same size) — and its queued backlog
        shrinks."""
        w = self.policy(tenant).weight
        start = max(self._vtime.get(tenant, 0.0), self._vclock)
        self._vclock = start
        charge = float(n if cost is None else cost)
        self._vtime[tenant] = start + charge / w
        self._backlog[tenant] = max(0, self._backlog.get(tenant, 0) - n)
        self._dirty.add(tenant)

    def on_requeued(self, tenant: str, n: int) -> None:
        """A popped batch bounced back to its queue (extract/compute
        failure path): restore the backlog accounting. The virtual-time
        charge of the failed service attempt deliberately stands — a
        tenant whose batches keep failing must not starve its neighbors by
        replaying at zero virtual cost."""
        self._backlog[tenant] = self._backlog.get(tenant, 0) + n

    def on_dequeued(self, tenant: str, n: int) -> None:
        """Queries left the queue WITHOUT being served here — evacuated to
        another replica, shed at drain timeout, or (at the front door)
        completed downstream. Backlog-only: no virtual-time charge, since
        no service happened on this controller's engine."""
        self._backlog[tenant] = max(0, self._backlog.get(tenant, 0) - n)
