"""GNN serving (reference: ``repro/serve``).

``session_core`` — shared calibrate/bucketed-serve machinery, including the
                   PreparedBatch extract-stage objects and the multi-bucket
                   co-launch (``launch_prepared_many``).
``adapters``     — ModelFamilyAdapter seam (GNNAdapter).
``gnn_session``  — GraphStore / CompiledGraphSession artifacts.
``gnn_engine``   — GNNServeEngine: micro-batched node-query engine over
                   compiled sessions; two-stage extract/compute pipeline
                   (``pipeline_depth``), tenant-aware weighted fair
                   scheduling, bounded retries, drain/evacuate.
``admission``    — multi-tenant admission control (TenantPolicy token
                   buckets, typed accept/throttle/shed decisions) + the
                   weighted virtual-time scheduler of the engines.
``cost``         — submit-time per-query cost prediction + online
                   calibration against measured batch time.
``slo``          — per-tenant SLO policies: error-budget burn-rate
                   tracking, multi-window alerts, admission-depth feedback.
``metrics``      — latency percentiles / QPS / cache counters, the
                   extract/compute breakdown and overlap ratio, per-tenant
                   breakdowns.
``trace``        — per-batch span tracing and the recompile/transfer
                   watchdogs.
``export``       — Chrome-trace JSON and Prometheus text over the trace
                   ring buffer.
``sharded``      — partitioned sessions and the ShardedServeEngine.

The token tier (token sessions and engine) and the replica tier are not
ported.
"""
from .adapters import GNNAdapter, ModelFamilyAdapter
from .admission import (AdmissionController, AdmissionDecision,
                        DEFAULT_TENANT, TenantPolicy)
from .cost import CostEstimate, CostEstimator, spearman_rho
from .export import chrome_trace, prometheus_text, write_chrome_trace
from .gnn_engine import (DrainReport, GNNServeEngine, NodeQuery,
                         QueryFailure)
from .gnn_session import CompiledGraphSession, GraphStore
from .metrics import LatencyStats, ServeMetrics, TenantMetrics
from .session_core import ArtifactError, SessionPlan
from .sharded import (ShardedGraphSession, ShardedServeEngine, ShardPlan,
                      ShardPlanner)
from .slo import SLOPolicy, SLOTracker
from .trace import (BatchTrace, RecompileWatchdog, SpanTracer,
                    TransferWatchdog, WarningEvent)

__all__ = [
    "AdmissionController", "AdmissionDecision", "DEFAULT_TENANT",
    "TenantPolicy", "GNNServeEngine", "NodeQuery", "CompiledGraphSession",
    "GraphStore", "SessionPlan", "LatencyStats", "ServeMetrics",
    "TenantMetrics", "ShardedGraphSession", "ShardedServeEngine",
    "ShardPlan", "ShardPlanner", "BatchTrace", "SpanTracer",
    "RecompileWatchdog", "TransferWatchdog", "WarningEvent",
    "chrome_trace", "prometheus_text", "write_chrome_trace",
    "CostEstimate", "CostEstimator", "spearman_rho",
    "SLOPolicy", "SLOTracker",
    "ArtifactError", "DrainReport", "QueryFailure",
    "ModelFamilyAdapter", "GNNAdapter",
]
