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

The SPMD executor, the ring transport over cards and the sharded engine
wait for later slices (ROADMAP Queue 1 items 4 and 5).
"""
from .executor import HostLayerExecutor
from .halo import HaloStats, MeshHaloPlan, build_mesh_plan, gather_rows
from .planner import ShardPart, ShardPlan, ShardPlanner, SpmdPlan
from .routing import RoutingTable, ShardedCSR
from .session import ShardedGraphSession

__all__ = [
    "ShardedGraphSession", "ShardPlanner", "ShardPlan", "ShardPart",
    "SpmdPlan", "RoutingTable", "ShardedCSR", "HaloStats", "MeshHaloPlan",
    "gather_rows", "build_mesh_plan", "HostLayerExecutor",
]
