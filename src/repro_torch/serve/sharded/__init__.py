"""Sharded serving (reference: ``repro/serve/sharded``): partitioned graph
sessions with cross-shard k-hop routing and halo exchange.

``planner``  — ShardPlanner: per-shard intra FRDC + halo adjacency +
               routing table (reuses graphs/partition.py).
``routing``  — RoutingTable + routed k-hop extraction (identical to the
               single-host ``sampling.khop_subgraph``).
``halo``     — shard-boundary row gathers with byte accounting, and the
               ring exchange's static schedule.
``executor`` — the host layer executor of the distributed full pass.
``session``  — ShardedGraphSession: per-shard bucketed serve cores +
               distributed layer-wise full pass + checkpointer artifacts.
``engine``   — ShardedServeEngine: the micro-batching scheduler routed over
               partitioned sessions (halo-aware batch formation).

The SPMD executor and the ring transport over cards wait for the
multi-card slice (ROADMAP Queue 1 item 5).
"""
from .engine import ShardedServeEngine
from .executor import HostLayerExecutor
from .halo import HaloStats, MeshHaloPlan, build_mesh_plan, gather_rows
from .planner import ShardPart, ShardPlan, ShardPlanner, SpmdPlan
from .routing import RoutingTable, ShardedCSR
from .session import ShardedGraphSession

__all__ = [
    "ShardedServeEngine", "ShardedGraphSession", "ShardPlanner", "ShardPlan",
    "ShardPart", "SpmdPlan", "RoutingTable", "ShardedCSR", "HaloStats",
    "MeshHaloPlan", "gather_rows", "build_mesh_plan", "HostLayerExecutor",
]
