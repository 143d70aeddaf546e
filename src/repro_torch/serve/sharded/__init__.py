"""Sharded serving (reference: ``repro/serve/sharded``): partitioned graph
sessions with cross-shard k-hop routing and halo exchange.

``planner``  — ShardPlanner: per-shard intra FRDC + halo adjacency +
               routing table (reuses graphs/partition.py).
``routing``  — RoutingTable + routed k-hop extraction (identical to the
               single-host ``sampling.khop_subgraph``).
``halo``     — shard-boundary row gathers with byte accounting, the ring
               exchange's static schedule, and the ring over
               ``torch.distributed`` (``ring_scatter``, ``mesh_exchange``).
``executor`` — the layer executors of the distributed full pass: host
               (P shards in turn, loopback or mesh exchange) and SPMD (one
               rank a shard).
``session``  — ShardedGraphSession: per-shard bucketed serve cores +
               distributed layer-wise full pass + checkpointer artifacts.
``engine``   — ShardedServeEngine: the micro-batching scheduler routed over
               partitioned sessions (halo-aware batch formation).

The SPMD executor runs in a world of one rank a shard
(``launch.mesh.run_ranks``); every rank runs the same program and gets
the whole answer of each call.
"""
from .engine import ShardedServeEngine
from .executor import HostLayerExecutor, SpmdLayerExecutor
from .halo import (HaloStats, MeshHaloPlan, build_mesh_plan, gather_rows,
                   mesh_exchange, ring_scatter)
from .planner import ShardPart, ShardPlan, ShardPlanner, SpmdPlan
from .routing import RoutingTable, ShardedCSR
from .session import ShardedGraphSession

__all__ = [
    "ShardedServeEngine", "ShardedGraphSession", "ShardPlanner", "ShardPlan",
    "ShardPart", "SpmdPlan", "RoutingTable", "ShardedCSR", "HaloStats",
    "MeshHaloPlan", "gather_rows", "build_mesh_plan", "mesh_exchange",
    "ring_scatter", "HostLayerExecutor", "SpmdLayerExecutor",
]
