"""Per-query span tracing + serving watchdogs — the event-level observability
layer under :mod:`repro_torch.serve.metrics` (reference:
``repro/serve/trace.py``).

:class:`~repro_torch.serve.metrics.ServeMetrics` answers "how fast is the
engine overall"; this module answers "what happened to THIS batch": every served
micro-batch emits a :class:`BatchTrace` span tree (queue wait with the
fair-queueing virtual time at pick, extract, launch, device compute), tagged
with its bucket shape, tenant, owning shard and halo traffic, into a bounded
ring buffer. Recording is SAMPLED in steady state (1-in-``sample_every``)
but outliers beyond the rolling p99 batch time and every error/requeue path
are always kept — the traces one actually wants when a benchmark regresses.

Trace context lifecycle: a query carries context from ``submit()`` on — its
``qid``, ``t_submit`` and typed admission decision live on the
:class:`~repro_torch.serve.gnn_engine.NodeQuery` itself; when the query is
picked into a batch the engine opens a :class:`BatchTrace` (the query's
``trace_id`` links to it), stage spans are appended as the batch moves
through the pipeline, and the trace is committed at finish (or on the
error/requeue path, always recorded). Exporters
(:mod:`repro_torch.serve.export`) derive Chrome-trace JSON and Prometheus text
offline from the ring buffer — nothing in the hot path serializes.

Watchdogs turn two test-only invariants into runtime signals:

  * :class:`RecompileWatchdog` — the engines wire it into the program
    counters of every :class:`~repro_torch.serve.session_core.ServeCore`
    and distributed-pass layer executor they touch (a new padded shape key
    is where the reference's jit traces). ``warmup()`` arms it; an armed
    watchdog seeing a new program means a STEADY-STATE recompile (a novel
    shape escaped the high-water buckets) and emits a structured warning
    event carrying the offending shape key.
  * :class:`TransferWatchdog` — the extract stage must be pure host work
    and the launch stage pure async launch. The watchdog checks both at
    the launch seam: a device-resident staged array (a tensor off the CPU)
    means extraction touched the device; a launch returning host results
    (a numpy array, or a CPU tensor from a core on the card) means the
    launch waited on a device->host copy. ``strict_guard()`` additionally
    sets torch's CUDA sync debug mode to ``"error"`` around a block, so a
    synchronizing call raises there; it is a no-op without CUDA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

log = logging.getLogger(__name__)


def _on_device(a) -> bool:
    """A tensor off the CPU (numpy arrays and CPU tensors, pinned or not,
    are host arrays). Duck-typed so this module never imports torch."""
    dev = getattr(a, "device", None)
    return dev is not None and getattr(dev, "type", "cpu") != "cpu"

# format version of the serialized trace records (and the chrome/prometheus
# exports derived from them)
TRACE_SCHEMA_VERSION = 1

# span names of the serving pipeline, in stage order — the per-stage tracks
# of the Chrome-trace export
STAGES = ("queue_wait", "extract", "launch", "compute")

# event names the replica tier emits through SpanTracer.event (always-kept
# WarningEvent records, like the watchdog firings): replica health
# transitions, failover requeues, reshard lifecycle phases, and the typed
# per-query failure paths of the bounded-retry / drain machinery
REPLICA_EVENTS = ("replica_unhealthy", "replica_recovered", "failover",
                  "reshard", "retry_exhausted", "drain")

# torch's CUDA sync debug mode, which TransferWatchdog.strict_guard sets, is
# one setting for the whole process (JAX's transfer guard is per thread).
# A strict guard and card work on another thread that must synchronize (the
# replica tier's background reshard build) take this lock, so the one never
# runs while the other's mode is set. Process-wide, as the mode it guards.
SYNC_EXCLUSIVE = threading.RLock()


@dataclasses.dataclass
class SpanEvent:
    """One timed stage of a batch's service: ``[t0, t1)`` wall-clock span
    (``time.perf_counter`` seconds) plus stage-specific attributes."""
    name: str
    t0: float
    t1: float
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_json(self) -> dict:
        return dict(name=self.name, t0=self.t0, t1=self.t1,
                    duration_s=self.duration_s, **self.attrs)


@dataclasses.dataclass
class BatchTrace:
    """Span tree of one micro-batch moving through the serving pipeline.

    ``vtime`` is the fair-queueing virtual start tag the scheduler used at
    pick (``overdue`` when the staleness bound preempted the virtual-time
    order); ``queries`` records each member query's qid/node/submit time and
    its queue wait at pick; ``bucket`` the padded launch shape; ``halo`` the
    sharded engine's per-batch halo traffic. ``kept`` says why the ring
    buffer retained this trace (``sampled`` / ``outlier`` / ``error``)."""
    trace_id: int
    key: tuple
    tenant: str
    shard: Optional[int]
    t_start: float                    # pick time (service start)
    t_end: float = 0.0
    spans: List[SpanEvent] = dataclasses.field(default_factory=list)
    queries: List[dict] = dataclasses.field(default_factory=list)
    bucket: Dict[str, object] = dataclasses.field(default_factory=dict)
    halo: Dict[str, object] = dataclasses.field(default_factory=dict)
    vtime: float = 0.0
    overdue: bool = False
    full_cache: bool = False
    error: str = ""
    requeued: bool = False
    kept: str = ""
    # cost-model view of the batch: summed predicted units, measured
    # service seconds, per-query predicted units, attribution — filled by
    # the engine's complete stage when a CostEstimator is wired in
    cost: Dict[str, object] = dataclasses.field(default_factory=dict)

    def span(self, name: str, t0: float, t1: float, **attrs) -> SpanEvent:
        ev = SpanEvent(name, t0, t1, attrs)
        self.spans.append(ev)
        return ev

    @property
    def total_s(self) -> float:
        return max(self.t_end - self.t_start, 0.0)

    def stage_s(self, name: str) -> float:
        """Summed duration of ``name`` spans (``compute`` prefers the
        double-count-free ``attributed_s`` the engine records, mirroring
        :meth:`ServeMetrics.record_stages`)."""
        total = 0.0
        for ev in self.spans:
            if ev.name == name:
                total += float(ev.attrs.get("attributed_s", ev.duration_s))
        return total

    def to_json(self) -> dict:
        return dict(type="batch", trace_id=self.trace_id,
                    key=list(self.key), tenant=self.tenant, shard=self.shard,
                    t_start=self.t_start, t_end=self.t_end,
                    total_s=self.total_s, vtime=self.vtime,
                    overdue=self.overdue, full_cache=self.full_cache,
                    n_queries=len(self.queries), queries=list(self.queries),
                    bucket=dict(self.bucket), halo=dict(self.halo),
                    cost=dict(self.cost),
                    error=self.error, requeued=self.requeued, kept=self.kept,
                    spans=[s.to_json() for s in self.spans])


@dataclasses.dataclass
class WarningEvent:
    """Structured out-of-band event (watchdog firings) — always recorded."""
    trace_id: int
    name: str
    t: float
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dict(type="warning", trace_id=self.trace_id, name=self.name,
                    t=self.t, **self.attrs)


class SpanTracer:
    """Bounded ring buffer of batch traces + warning events, with steady-
    state sampling and always-on outlier/error capture.

    Retention policy per committed batch, in priority order: error/requeue
    paths are ALWAYS kept; batches whose total service time exceeds the
    rolling p99 (over the last ``outlier_window`` batches, once at least 32
    have been seen) are kept as outliers; otherwise 1-in-``sample_every``
    batches are kept. ``sample_every=1`` records everything (the acceptance
    and benchmark-export setting); ``enabled=False`` makes every call a
    no-op without the engines having to branch on None.

    Thread safety: the pipelined engines commit traces from worker threads
    while exporters snapshot the ring from the caller's thread, so ring and
    counter mutation is serialized under an internal lock — a
    :meth:`records` snapshot taken mid-append can never see a torn ring
    (a ``_pos`` read racing the wrap-around slice)."""

    OUTLIER_MIN_SAMPLES = 32

    def __init__(self, capacity: int = 4096, sample_every: int = 16,
                 outlier_pct: float = 99.0, outlier_window: int = 512,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, "
                             f"got {sample_every}")
        self.capacity = capacity
        self.sample_every = int(sample_every)
        self.outlier_pct = float(outlier_pct)
        self.enabled = enabled
        self._ring: List[object] = []
        self._pos = 0
        self._lock = threading.Lock()
        self._next_id = 0
        self.batches_seen = 0
        self.batches_recorded = 0
        self.outliers_recorded = 0
        self.errors_recorded = 0
        self.warnings_recorded = 0
        self._totals = np.zeros(int(outlier_window), np.float64)
        self._n_totals = 0

    # --------------------------------------------------------- recording ----
    def begin(self, key: tuple, tenant: str, shard: Optional[int],
              batch: list, t_pick: float, vtime: float = 0.0,
              overdue: bool = False) -> Optional[BatchTrace]:
        """Open the trace of one just-picked batch (``batch``: NodeQuery
        list). Cheap — retention is decided at :meth:`commit`."""
        if not self.enabled:
            return None
        with self._lock:
            trace_id = self._next_id
            self._next_id += 1
        tr = BatchTrace(trace_id=trace_id, key=key, tenant=tenant,
                        shard=shard, t_start=t_pick, vtime=vtime,
                        overdue=overdue)
        tr.queries = [dict(qid=q.qid, node=q.node, t_submit=q.t_submit,
                           queue_wait_s=t_pick - q.t_submit) for q in batch]
        for q in batch:          # link each query to its batch's trace
            q.trace_id = tr.trace_id
        tr.span("queue_wait",
                min((q.t_submit for q in batch), default=t_pick), t_pick,
                vtime=vtime, overdue=overdue)
        return tr

    def commit(self, trace: Optional[BatchTrace], error: str = "",
               requeued: bool = False) -> bool:
        """Close a batch trace and decide retention. Returns whether the
        ring buffer kept it."""
        if trace is None or not self.enabled:
            return False
        if error:
            trace.error = error
        trace.requeued = requeued
        if trace.t_end <= trace.t_start:
            trace.t_end = time.perf_counter()
        with self._lock:
            self.batches_seen += 1
            kept = ""
            if error or requeued:
                kept = "error"
                self.errors_recorded += 1
            elif self._is_outlier(trace.total_s):
                kept = "outlier"
                self.outliers_recorded += 1
            elif (self.batches_seen - 1) % self.sample_every == 0:
                kept = "sampled"
            self._push_total(trace.total_s)
            if kept:
                trace.kept = kept
                self._store(trace)
                self.batches_recorded += 1
        return bool(kept)

    def warning(self, name: str, **attrs) -> WarningEvent:
        """Record an always-kept structured warning event (watchdogs)."""
        with self._lock:
            ev = WarningEvent(trace_id=self._next_id, name=name,
                              t=time.perf_counter(), attrs=attrs)
            self._next_id += 1
            if self.enabled:
                self._store(ev)
                self.warnings_recorded += 1
        return ev

    def event(self, name: str, **attrs) -> WarningEvent:
        """Record an always-kept structured lifecycle event — the replica
        tier's channel for health transitions, failovers and reshard phases
        (see :data:`REPLICA_EVENTS`). Same record type and retention as
        :meth:`warning`; the separate name keeps call sites honest about
        whether they are reporting a problem or narrating a transition."""
        return self.warning(name, **attrs)

    def _push_total(self, total_s: float) -> None:
        self._totals[self._n_totals % self._totals.size] = total_s
        self._n_totals += 1

    def _is_outlier(self, total_s: float) -> bool:
        n = min(self._n_totals, self._totals.size)
        if n < self.OUTLIER_MIN_SAMPLES:
            return False
        return total_s > float(np.percentile(self._totals[:n],
                                             self.outlier_pct))

    def _store(self, record) -> None:
        if len(self._ring) < self.capacity:
            self._ring.append(record)
        else:
            self._ring[self._pos] = record
            self._pos = (self._pos + 1) % self.capacity

    # ------------------------------------------------------------ access ----
    def records(self) -> List[object]:
        """Retained records, oldest first (a consistent copy: the slice is
        taken under the ring lock, so concurrent commits from pipeline
        worker threads can never tear the wrap-around)."""
        with self._lock:
            return self._ring[self._pos:] + self._ring[:self._pos]

    def batch_traces(self) -> List[BatchTrace]:
        return [r for r in self.records() if isinstance(r, BatchTrace)]

    def warning_events(self) -> List[WarningEvent]:
        return [r for r in self.records() if isinstance(r, WarningEvent)]

    def clear(self) -> None:
        with self._lock:
            self._ring, self._pos = [], 0

    def snapshot(self) -> dict:
        return dict(schema_version=TRACE_SCHEMA_VERSION,
                    enabled=self.enabled, capacity=self.capacity,
                    sample_every=self.sample_every,
                    batches_seen=self.batches_seen,
                    batches_recorded=self.batches_recorded,
                    outliers_recorded=self.outliers_recorded,
                    errors_recorded=self.errors_recorded,
                    warnings_recorded=self.warnings_recorded,
                    retained=len(self._ring))


# ---------------------------------------------------------------------------
# Watchdogs
# ---------------------------------------------------------------------------

class RecompileWatchdog:
    """Turns the 'zero steady-state recompiles' test invariant into a
    runtime signal.

    The engines wire :meth:`on_recompile` into every serve core / layer
    executor they resolve (via the sessions' ``set_trace_hook``). While
    DISARMED (the warmup phase) new programs are expected and ignored;
    ``warmup()`` arms the watchdog, after which every new one is a
    steady-state recompile: counted, logged, and emitted as a structured
    ``recompile`` warning event carrying the offending shape key."""

    def __init__(self, tracer: Optional[SpanTracer] = None,
                 family: str = "gnn"):
        self.tracer = tracer
        self.family = family
        self.armed = False
        self.steady_recompiles = 0
        self.last: Optional[dict] = None

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def on_recompile(self, label: str, shape: Optional[dict]) -> None:
        """The session trace hook: ``label`` names the recompiled program
        (``core`` / ``shard<i>/core`` / ``executor/<layer>``), ``shape``
        the offending shape key (padded dims)."""
        if not self.armed:
            return
        self.steady_recompiles += 1
        self.last = dict(label=label, shape=shape)
        log.warning("steady-state recompile in %s: shape=%s", label, shape)
        if self.tracer is not None:
            self.tracer.warning("recompile", family=self.family,
                                label=label, shape=shape)

    def snapshot(self) -> dict:
        return dict(armed=self.armed, family=self.family,
                    steady_recompiles=self.steady_recompiles,
                    last=self.last)


class TransferWatchdog:
    """Counts unexpected device<->host syncs at the serving pipeline's
    stage boundaries.

    The contract the pipeline's overlap depends on: EXTRACT stages pure
    host arrays (numpy, or CPU tensors pinned or not; a staged tensor on
    the card means extraction did device work and will serialize against
    in-flight forwards), and LAUNCH is pure async launch (a launch
    returning host results means something waited on a device->host copy
    inside it). Both checks are O(#groups) type probes per batch;
    violations are counted and (for the first ``max_events`` per kind)
    emitted as structured ``transfer`` warning events."""

    def __init__(self, tracer: Optional[SpanTracer] = None,
                 max_events: int = 16, family: str = "gnn"):
        self.tracer = tracer
        self.family = family
        self.max_events = max_events
        self.device_in_extract = 0     # staged arrays resident on device
        self.host_sync_in_launch = 0   # launch returned concrete host arrays

    def _emit(self, count: int, kind: str, **attrs) -> None:
        log.warning("unexpected transfer (%s): %s", kind, attrs)
        if self.tracer is not None and count <= self.max_events:
            self.tracer.warning("transfer", family=self.family,
                                kind=kind, **attrs)

    def check_prepared(self, prepared) -> None:
        """EXTRACT-purity check on a PreparedBatch about to launch."""
        for i, g in enumerate(getattr(prepared, "groups", ()) or ()):
            x = g.staged.x_pad
            if _on_device(x):
                self.device_in_extract += 1
                self._emit(self.device_in_extract, "device_in_extract",
                           group=i, array_type=type(x).__name__)

    def check_launched(self, devs, device=None) -> None:
        """LAUNCH-asynchrony check on the just-launched device handles:
        a numpy result, or a CPU tensor from a core whose ``device`` is
        not the CPU, came back through a device->host copy."""
        on_card = device is not None and getattr(device, "type",
                                                 str(device)) != "cpu"
        for i, d in enumerate(devs or ()):
            if isinstance(d, np.ndarray) or (on_card and not _on_device(d)):
                self.host_sync_in_launch += 1
                self._emit(self.host_sync_in_launch, "host_sync_in_launch",
                           group=i)

    @contextlib.contextmanager
    def strict_guard(self):
        """Set torch's CUDA sync debug mode to ``"error"`` for the enclosed
        block, so a synchronizing call (``.item()``, a blocking copy to the
        host, a stream sync) RAISES; an exception out of the block is
        counted, and the previous mode is restored on exit. The mode is
        process-global, not per thread: while it is set, no other thread
        may do CUDA work that syncs (the extract worker does none; a
        background reshard build holds :data:`SYNC_EXCLUSIVE`, which the
        guard waits for). Without CUDA the mode is not set, as the
        reference's guard never fires on the CPU backend; the type checks
        above carry the signal there."""
        import torch
        armed = torch.cuda.is_available()
        with SYNC_EXCLUSIVE:
            if armed:
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            except Exception:
                self.host_sync_in_launch += 1
                self._emit(self.host_sync_in_launch, "host_sync_in_launch",
                           source="transfer_guard")
                raise
            finally:
                if armed:
                    torch.cuda.set_sync_debug_mode(prev)

    def snapshot(self) -> dict:
        return dict(family=self.family,
                    device_in_extract=self.device_in_extract,
                    host_sync_in_launch=self.host_sync_in_launch)
