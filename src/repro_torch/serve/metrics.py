"""Serving metrics: latency percentiles, QPS, cache hit-rates, program
counters — the observability layer of the GNN serving subsystem (reference:
``repro/serve/metrics.py``, copied: numpy only).

Single-process and allocation-light: a flat sample list per histogram and
plain integer counters. ``snapshot()`` returns a JSON-serializable dict, the
payload of ``BENCH_serve_gnn.json`` and the example's final report.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


class LatencyStats:
    """Wall-clock latency samples with percentile summaries.

    Bounded: keeps the most recent ``max_samples`` in a ring buffer so a
    long-running engine doesn't grow without limit; ``count`` stays exact
    over the full lifetime, percentiles are over the retained window."""

    def __init__(self, max_samples: int = 100_000) -> None:
        self.max_samples = max_samples
        self._samples: List[float] = []
        self._pos = 0
        self._total = 0

    def record(self, seconds: float) -> None:
        s = float(seconds)
        if len(self._samples) < self.max_samples:
            self._samples.append(s)
        else:
            self._samples[self._pos] = s
            self._pos = (self._pos + 1) % self.max_samples
        self._total += 1

    @property
    def count(self) -> int:
        return self._total

    def percentile(self, p: float) -> float:
        if not self._samples:
            return float("nan")
        return float(np.percentile(np.asarray(self._samples), p))

    @property
    def window(self) -> int:
        """Samples currently retained — the population behind the
        percentiles. Equals ``count`` until the ring wraps."""
        return len(self._samples)

    def summary(self) -> Dict[str, float]:
        if not self._samples:
            return dict(count=0, window=0, mean_ms=float("nan"),
                        p50_ms=float("nan"), p90_ms=float("nan"),
                        p99_ms=float("nan"), max_ms=float("nan"))
        a = np.asarray(self._samples) * 1e3
        return dict(count=self._total, window=len(self._samples),
                    mean_ms=float(a.mean()),
                    p50_ms=float(np.percentile(a, 50)),
                    p90_ms=float(np.percentile(a, 90)),
                    p99_ms=float(np.percentile(a, 99)),
                    max_ms=float(a.max()))


@dataclasses.dataclass
class TenantMetrics:
    """Per-tenant slice of an engine's metrics: admission outcomes
    (``accepted`` / ``throttled`` / ``shed`` submissions) plus the answered
    queries and their end-to-end latency histogram."""
    accepted: int = 0
    throttled: int = 0
    shed: int = 0
    queries: int = 0
    # cost accounting (all 0 until the engine wires a CostEstimator):
    # predicted units admitted, rejections charged to the cost budget
    # specifically, and measured service seconds attributed pro rata
    cost_units: float = 0.0
    cost_throttled: int = 0
    attributed_cost_s: float = 0.0
    latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)

    @property
    def submitted(self) -> int:
        return self.accepted + self.throttled + self.shed

    @property
    def shed_rate(self) -> float:
        """Fraction of submissions shed (overload rejections only — kept
        consistent with the adjacent ``shed`` counter; rate-limit bounces
        are ``throttle_rate``, and ``reject_rate`` is their sum)."""
        return self.shed / max(self.submitted, 1)

    @property
    def throttle_rate(self) -> float:
        return self.throttled / max(self.submitted, 1)

    @property
    def reject_rate(self) -> float:
        """Fraction of submissions NOT admitted (throttled or shed)."""
        return (self.throttled + self.shed) / max(self.submitted, 1)

    def snapshot(self, elapsed_s: float) -> dict:
        return dict(accepted=self.accepted, throttled=self.throttled,
                    shed=self.shed, shed_rate=self.shed_rate,
                    throttle_rate=self.throttle_rate,
                    reject_rate=self.reject_rate,
                    queries=self.queries,
                    qps=self.queries / max(elapsed_s, 1e-9),
                    cost_units=self.cost_units,
                    cost_throttled=self.cost_throttled,
                    attributed_cost_s=self.attributed_cost_s,
                    latency=self.latency.summary())


@dataclasses.dataclass
class ServeMetrics:
    """Counters + histograms for one engine (or one session).

    The per-batch service time is broken into the two pipeline stages:
    **extract** (queue pick -> k-hop/routed extraction -> FRDC build ->
    bucket pad; pure host work) and **compute** (forward launch ->
    device result fetch -> gather). ``batch_latency`` stays the total.
    ``serve_wall_s`` accumulates the wall time the engine actually spent
    inside its serve loop, so ``overlap_ratio`` — the fraction of stage time
    hidden behind the other stage — is ``(extract + compute - wall) /
    (extract + compute)``: 0 for the serial loop, approaching 0.5 when a
    double-buffered pipeline fully hides extraction behind the in-flight
    device computation.
    """
    # model-family namespace ("gnn", "transformer", "ssm", ...): carried in
    # the snapshot and merged as a ``family`` label onto every Prometheus
    # series, so engines of different families exported from one process
    # never collide on a series name.
    family: str = "gnn"
    latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    batch_latency: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)
    extract_latency: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)
    compute_latency: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)
    queries: int = 0
    batches: int = 0
    full_cache_hits: int = 0       # answered from the cached full-graph pass
    subgraph_queries: int = 0      # answered via the micro-batched k-hop path
    extract_s: float = 0.0         # summed extract-stage seconds
    compute_s: float = 0.0         # summed compute-stage seconds
    serve_wall_s: float = 0.0      # wall seconds inside the serve loop
    # failure-path accounting (the bounded-retry / drain machinery):
    # batches bounced back to their queue, queries dropped with a typed
    # per-query failure after max_retries, and accepted-but-unserved
    # queries typed-shed by a drain timeout
    requeues: int = 0
    retry_shed: int = 0
    drain_shed: int = 0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    # wall time banked from previous start/stop waves (restart-safe clock)
    _elapsed_base: float = 0.0
    # per-tenant breakdowns (admission outcomes + answered latency)
    tenants: Dict[str, TenantMetrics] = dataclasses.field(
        default_factory=dict)

    def tenant(self, name: str) -> TenantMetrics:
        tm = self.tenants.get(name)
        if tm is None:
            tm = self.tenants[name] = TenantMetrics()
        return tm

    def record_admission(self, tenant: str, action: str,
                         cost: float = 0.0,
                         cost_limited: bool = False) -> None:
        """Fold one admission outcome in; an accepted submission's
        predicted ``cost`` units are counted against the tenant, and a
        throttle charged to the COST budget (vs the QPS rate) is split out
        into ``cost_throttled``."""
        tm = self.tenant(tenant)
        if action == "accept":
            tm.accepted += 1
            tm.cost_units += float(cost)
        elif action == "throttle":
            tm.throttled += 1
            if cost_limited:
                tm.cost_throttled += 1
        else:
            tm.shed += 1

    def record_tenant_query(self, tenant: str, latency_s: float) -> None:
        tm = self.tenant(tenant)
        tm.queries += 1
        tm.latency.record(latency_s)

    def record_tenant_cost_attributed(self, tenant: str,
                                      seconds: float) -> None:
        """Credit a tenant its pro-rata share of one batch's measured
        service seconds (the cost attribution the estimator computes)."""
        self.tenant(tenant).attributed_cost_s += float(seconds)

    def record_stages(self, extract_s: float, compute_s: float) -> None:
        """Record one batch's per-stage breakdown (both histogrammed and
        summed for the overlap gauge)."""
        self.extract_latency.record(extract_s)
        self.compute_latency.record(compute_s)
        self.extract_s += float(extract_s)
        self.compute_s += float(compute_s)

    @property
    def overlap_ratio(self) -> float:
        stage_s = self.extract_s + self.compute_s
        if stage_s <= 0.0:
            return 0.0
        return max(0.0, stage_s - self.serve_wall_s) / stage_s

    def start_clock(self) -> None:
        """Start (or RESUME) the serving clock. Restart-safe: a second
        serve wave after ``stop_clock()`` banks the finished wave's wall
        time and reopens the clock, so ``elapsed_s`` keeps accumulating
        and ``qps`` stays total-queries / total-serving-time instead of
        freezing at the first wave's window."""
        if self.started_at is None:
            self.started_at = time.perf_counter()
        elif self.finished_at is not None:
            self._elapsed_base += self.finished_at - self.started_at
            self.started_at = time.perf_counter()
            self.finished_at = None
        # else: clock already running — idempotent, like the original

    def stop_clock(self) -> None:
        if self.started_at is not None and self.finished_at is None:
            self.finished_at = time.perf_counter()

    @property
    def elapsed_s(self) -> float:
        if self.started_at is None:
            return max(self._elapsed_base, 0.0) or 0.0
        end = self.finished_at or time.perf_counter()
        return max(self._elapsed_base + (end - self.started_at), 1e-9)

    @property
    def qps(self) -> float:
        return self.queries / self.elapsed_s

    @property
    def cache_hit_rate(self) -> float:
        return self.full_cache_hits / max(self.queries, 1)

    def snapshot(self, extra: Optional[dict] = None) -> dict:
        out = dict(
            family=self.family,
            queries=self.queries, batches=self.batches, qps=self.qps,
            full_cache_hits=self.full_cache_hits,
            subgraph_queries=self.subgraph_queries,
            cache_hit_rate=self.cache_hit_rate,
            elapsed_s=self.elapsed_s,
            latency=self.latency.summary(),
            batch_latency=self.batch_latency.summary(),
            batch_breakdown=dict(extract=self.extract_latency.summary(),
                                 compute=self.compute_latency.summary(),
                                 total=self.batch_latency.summary()),
            overlap_ratio=self.overlap_ratio,
            serve_wall_s=self.serve_wall_s,
            requeues=self.requeues,
            retry_shed=self.retry_shed,
            drain_shed=self.drain_shed,
            tenants={name: tm.snapshot(self.elapsed_s)
                     for name, tm in sorted(self.tenants.items())},
        )
        if extra:
            out.update(extra)
        return out
