"""Offline exporters over the :class:`~repro_torch.serve.trace.SpanTracer` ring
buffer: Chrome-trace JSON (``chrome://tracing`` / Perfetto loadable) and a
Prometheus text-exposition snapshot.

Both are pure functions of already-recorded data — nothing here runs in the
serving hot path. The Chrome trace lays out one PROCESS per shard (plus one
for unsharded batches) and one THREAD per pipeline stage, so Perfetto's
timeline shows queue-wait / extract / launch / compute as parallel tracks
and the extract/compute overlap is visible as literal span overlap.
(Reference: ``repro/serve/export.py``.)
"""
from __future__ import annotations

import json
from typing import Iterable, List, Optional

from .trace import STAGES, BatchTrace, SpanTracer, WarningEvent

_US = 1e6  # chrome trace timestamps are microseconds


def _pid_of(tr: BatchTrace) -> int:
    # pid 1 = the unsharded engine; shard i gets pid 2+i
    return 1 if tr.shard is None else 2 + int(tr.shard)


def _pid_name(pid: int) -> str:
    return "serve" if pid == 1 else f"shard-{pid - 2}"


def chrome_trace(source) -> dict:
    """Build a Chrome-trace object (``json.dump`` it to a file and load in
    Perfetto) from a :class:`SpanTracer` or an iterable of trace records.

    Batch spans become "X" (complete) duration events on a (pid=shard,
    tid=stage) track; watchdog warnings become instant "i" events on a
    dedicated track. Timestamps are rebased to the earliest span so the
    viewer opens at t=0."""
    if isinstance(source, SpanTracer):
        records = source.records()
    else:
        records = list(source)
    batches = [r for r in records if isinstance(r, BatchTrace)]
    warnings = [r for r in records if isinstance(r, WarningEvent)]

    t0s = [s.t0 for tr in batches for s in tr.spans]
    t0s += [w.t for w in warnings]
    base = min(t0s) if t0s else 0.0

    events: List[dict] = []
    pids = {}
    for tr in batches:
        pid = _pid_of(tr)
        pids.setdefault(pid, _pid_name(pid))
        common = dict(trace_id=tr.trace_id, key=list(tr.key),
                      tenant=tr.tenant, n_queries=len(tr.queries),
                      kept=tr.kept)
        for s in tr.spans:
            tid = STAGES.index(s.name) + 1 if s.name in STAGES else 99
            args = dict(common)
            args.update({k: v for k, v in s.attrs.items()})
            if s.name == "extract":
                args.update(bucket=dict(tr.bucket), halo=dict(tr.halo))
            if tr.error:
                args.update(error=tr.error, requeued=tr.requeued)
            events.append(dict(
                name=s.name, ph="X", pid=pid, tid=tid,
                ts=(s.t0 - base) * _US,
                dur=max(s.t1 - s.t0, 0.0) * _US,
                cat="serve", args=args))
    for w in warnings:
        events.append(dict(
            name=w.name, ph="i", s="g", pid=1, tid=98,
            ts=(w.t - base) * _US, cat="watchdog",
            args=dict(trace_id=w.trace_id, **w.attrs)))
    if warnings:
        pids.setdefault(1, _pid_name(1))

    meta: List[dict] = []
    for pid, name in sorted(pids.items()):
        meta.append(dict(name="process_name", ph="M", pid=pid, tid=0,
                         args=dict(name=name)))
        for i, stage in enumerate(STAGES):
            meta.append(dict(name="thread_name", ph="M", pid=pid, tid=i + 1,
                             args=dict(name=stage)))
        meta.append(dict(name="thread_name", ph="M", pid=pid, tid=98,
                         args=dict(name="watchdog")))
    return dict(traceEvents=meta + events, displayTimeUnit="ms")


def write_chrome_trace(source, path: str) -> dict:
    """``chrome_trace`` + dump to ``path``; returns the trace object."""
    obj = chrome_trace(source)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Registry:
    """Collects samples grouped by metric name so the rendered exposition
    carries ``# HELP``/``# TYPE`` headers once per series, immediately
    before that series' samples — the Prometheus text-format contract
    (samples of one metric must be contiguous, headers precede them)."""

    def __init__(self, default_labels: Optional[dict] = None):
        # name -> [help, type, [(labels, value), ...]] in first-seen order
        self._metrics: dict = {}
        # merged under every sample's labels — the model-family namespace
        # ("gnn" / "transformer" / "ssm") that keeps engines of different
        # families exported from one process off each other's series
        self.default_labels = dict(default_labels or {})

    def add(self, name: str, value, labels: Optional[dict] = None,
            help_: str = "", type_: str = "gauge") -> None:
        ent = self._metrics.get(name)
        if ent is None:
            ent = self._metrics[name] = [help_, type_, []]
        elif help_ and not ent[0]:
            ent[0] = help_
        ent[2].append((dict(self.default_labels, **(labels or {})),
                       float(value)))

    def render(self) -> str:
        out: List[str] = []
        for name, (help_, type_, samples) in self._metrics.items():
            out.append(f"# HELP {name} "
                       f"{help_ or name.replace('_', ' ')}")
            out.append(f"# TYPE {name} {type_}")
            for labels, value in samples:
                out.append(f"{name}{_fmt_labels(labels)} {value:g}")
        return "\n".join(out) + "\n"


def prometheus_text(snapshot: dict, tracer: Optional[SpanTracer] = None,
                    prefix: str = "serve") -> str:
    """Render an engine ``snapshot()`` dict (plus, optionally, the tracer's
    own counters) as Prometheus text exposition — a point-in-time scrape a
    textfile collector can ship as-is. Every series carries its
    ``# HELP``/``# TYPE`` headers; cost-model and SLO series appear when
    the snapshot includes them (engine constructed with an estimator /
    tracker). When the snapshot names its model family every series gets a
    ``family`` label, so scrapes from a GNN engine and a token engine in
    the same process never collide."""
    family = snapshot.get("family")
    reg = _Registry(dict(family=family) if family else None)
    m = snapshot

    reg.add(f"{prefix}_queries_total", m.get("queries", 0),
            help_="Queries served to completion", type_="counter")
    reg.add(f"{prefix}_batches_total", m.get("batches", 0),
            help_="Micro-batches served", type_="counter")
    reg.add(f"{prefix}_qps", m.get("qps", 0.0),
            help_="Served queries per second of elapsed serving time")
    reg.add(f"{prefix}_wall_seconds", m.get("serve_wall_s", 0.0),
            help_="Wall-clock seconds spent inside the serve loop")
    reg.add(f"{prefix}_overlap_ratio", m.get("overlap_ratio", 0.0),
            help_="Stage time hidden behind the other pipeline stage")
    reg.add(f"{prefix}_cache_hit_rate", m.get("cache_hit_rate", 0.0),
            help_="Fraction of queries answered from the full-graph cache")

    def _latency(stats: dict, labels: dict) -> None:
        for q in ("p50_ms", "p90_ms", "p99_ms", "mean_ms", "max_ms"):
            v = stats.get(q)
            if v is not None and v == v:        # skip NaN (empty window)
                reg.add(f"{prefix}_latency_ms", v,
                        dict(labels, quantile=q[:-3]),
                        help_="Latency summaries over the retained window")
        for k in ("count", "window"):
            if k in stats:
                reg.add(f"{prefix}_latency_{k}", stats[k], labels,
                        help_=f"Latency sample {k} behind the summaries")
    _latency(m.get("latency", {}), dict(group="query"))
    _latency(m.get("batch_latency", {}), dict(group="batch"))
    for stage, stats in sorted(m.get("batch_breakdown", {}).items()):
        if stage != "total":
            _latency(stats, dict(group=f"stage_{stage}"))

    tenant_help = dict(
        accepted="Submissions admitted", throttled="Submissions throttled",
        shed="Submissions shed at the queue-depth bound",
        queries="Queries answered",
        cost_throttled="Throttles charged to the cost-unit budget")
    for tenant, st in sorted(m.get("tenants", {}).items()):
        if not isinstance(st, dict):
            continue
        for k in ("accepted", "throttled", "shed", "queries",
                  "cost_throttled"):
            if k in st:
                reg.add(f"{prefix}_tenant_{k}_total", st[k],
                        dict(tenant=tenant), type_="counter",
                        help_=tenant_help.get(k, ""))
        if "cost_units" in st:
            reg.add(f"{prefix}_tenant_cost_units_total", st["cost_units"],
                    dict(tenant=tenant), type_="counter",
                    help_="Predicted cost units admitted for the tenant")
        if "attributed_cost_s" in st:
            reg.add(f"{prefix}_tenant_cost_attributed_seconds_total",
                    st["attributed_cost_s"], dict(tenant=tenant),
                    type_="counter",
                    help_="Measured batch service seconds attributed to "
                          "the tenant pro rata by predicted cost")
        _latency(st.get("latency", {}), dict(tenant=tenant))

    for k in ("pending", "pipeline_depth"):
        if k in snapshot:
            reg.add(f"{prefix}_{k}", snapshot[k])
    for k in ("compiles", "invalidations", "executor_compiles",
              "halo_bytes", "halo_tiles_shared", "halo_bytes_saved",
              "whale_splits"):
        if k in snapshot:
            reg.add(f"{prefix}_{k}_total", snapshot[k], type_="counter")
    for tag, b in sorted(snapshot.get("halo_bytes_by_tag", {}).items()):
        reg.add(f"{prefix}_halo_bytes_by_tag_total", b, dict(tag=tag),
                type_="counter")

    cost = snapshot.get("cost")
    if isinstance(cost, dict):
        reg.add(f"{prefix}_cost_queries_estimated_total",
                cost.get("queries_estimated", 0), type_="counter",
                help_="Submissions the cost model priced")
        reg.add(f"{prefix}_cost_batches_observed_total",
                cost.get("batches_observed", 0), type_="counter",
                help_="Served batches folded into cost calibration")
        if cost.get("typical_units") is not None:
            reg.add(f"{prefix}_cost_typical_units",
                    cost["typical_units"],
                    help_="EWMA predicted cost units per query")
        if cost.get("units_per_second") is not None:
            reg.add(f"{prefix}_cost_units_per_second",
                    cost["units_per_second"],
                    help_="Calibrated cost units per measured service "
                          "second (EWMA)")
        rho = cost.get("rank_correlation")
        if rho is not None and rho == rho:
            reg.add(f"{prefix}_cost_rank_correlation", rho,
                    help_="Spearman rho of predicted vs measured "
                          "per-batch cost")

    slo = snapshot.get("slo")
    if isinstance(slo, dict):
        for tenant, st in sorted(slo.get("tenants", {}).items()):
            reg.add(f"{prefix}_slo_burn_rate", st.get("burn_short", 0.0),
                    dict(tenant=tenant, window="short"),
                    help_="Error-budget burn rate over the sliding window")
            reg.add(f"{prefix}_slo_burn_rate", st.get("burn_long", 0.0),
                    dict(tenant=tenant, window="long"))
            reg.add(f"{prefix}_slo_budget_remaining",
                    st.get("budget_remaining", 1.0), dict(tenant=tenant),
                    help_="Error budget left at the long-window burn "
                          "(1 = untouched)")
            reg.add(f"{prefix}_slo_alerts_total", st.get("alerts", 0),
                    dict(tenant=tenant), type_="counter",
                    help_="Multi-window burn-rate alerts fired")
            reg.add(f"{prefix}_slo_depth_scale",
                    st.get("depth_scale", 1.0), dict(tenant=tenant),
                    help_="SLO autotune multiplier on the tenant's queue "
                          "depth")

    wd = snapshot.get("watchdogs", {})
    rc = wd.get("recompile", {})
    if rc:
        reg.add(f"{prefix}_steady_recompiles_total",
                rc.get("steady_recompiles", 0),
                help_="Steady-state new programs flagged by the watchdog",
                type_="counter")
    tw = wd.get("transfer", {})
    for k in ("device_in_extract", "host_sync_in_launch"):
        if k in tw:
            reg.add(f"{prefix}_unexpected_transfers_total", tw[k],
                    dict(kind=k), type_="counter",
                    help_="Device/host syncs the transfer watchdog caught")

    if tracer is not None:
        ts = tracer.snapshot()
        for k in ("batches_seen", "batches_recorded", "outliers_recorded",
                  "errors_recorded", "warnings_recorded"):
            reg.add(f"{prefix}_trace_{k}_total", ts[k], type_="counter")
        reg.add(f"{prefix}_trace_retained", ts["retained"])
    return reg.render()
