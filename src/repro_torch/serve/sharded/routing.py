"""Routing table + cross-shard k-hop extraction (reference:
``repro/serve/sharded/routing.py``).

The partition is contiguous (tile-row-aligned node ranges, see
:func:`repro_torch.graphs.partition.shard_node_bounds`), so the routing table is
the ``(P+1,)`` bounds array: global node -> owning shard by bisection,
global -> local id by subtracting the owner's base. It is still serialized
as an explicit artifact (``routing.json``) because consumers of a saved
sharded session — including future non-contiguous planners — must not assume
the contiguity, only the table's API.

Cross-shard k-hop: each shard only knows its OWN adjacency rows (local CSR
over global column ids). Frontier expansion routes every frontier node to
its owning shard, gathers the per-shard neighbor lists with the exact same
vectorized gather the single-host path uses, and merges the returned
frontiers — nodes discovered past a shard boundary are routed onward on the
next hop. The resulting subgraph (node set, induced edges, seed positions)
is identical to the single-host :func:`repro_torch.graphs.sampling.khop_subgraph`,
which is what makes sharded serving bit-exact. Host numpy, a copy of the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ...graphs import sampling


@dataclasses.dataclass
class RoutingTable:
    """Global node id -> (owning shard, local id)."""
    bounds: np.ndarray                 # (P+1,) int64, bounds[0]=0, [-1]=n

    @property
    def n_shards(self) -> int:
        return self.bounds.size - 1

    @property
    def n_nodes(self) -> int:
        return int(self.bounds[-1])

    def shard_range(self, s: int) -> Tuple[int, int]:
        return int(self.bounds[s]), int(self.bounds[s + 1])

    def owner(self, nodes: np.ndarray) -> np.ndarray:
        nodes = np.asarray(nodes, np.int64)
        return np.searchsorted(self.bounds, nodes, side="right") - 1

    def local(self, nodes: np.ndarray,
              owner: Optional[np.ndarray] = None) -> np.ndarray:
        nodes = np.asarray(nodes, np.int64)
        if owner is None:
            owner = self.owner(nodes)
        return nodes - self.bounds[owner]

    def to_json(self) -> dict:
        return dict(bounds=[int(b) for b in self.bounds])

    @classmethod
    def from_json(cls, d: dict) -> "RoutingTable":
        return cls(bounds=np.asarray(d["bounds"], np.int64))


class ShardedCSR:
    """The graph's adjacency partitioned by row ownership: shard ``s`` holds
    a local-row CSR (rows ``[bounds[s], bounds[s+1])`` re-based to 0) whose
    column ids stay GLOBAL. Built from the same edge list with the same
    stable sort as the single-host CSR, so per-row neighbor order matches."""

    def __init__(self, routing: RoutingTable,
                 shards: List[sampling.CSRGraph]):
        self.routing = routing
        self.shards = shards
        self.requests_by_shard = np.zeros(routing.n_shards, np.int64)

    @property
    def n_nodes(self) -> int:
        return self.routing.n_nodes

    @classmethod
    def from_edges(cls, edges: np.ndarray, routing: RoutingTable
                   ) -> "ShardedCSR":
        rows, cols = np.asarray(edges[0], np.int64), \
            np.asarray(edges[1], np.int64)
        shards = []
        for s in range(routing.n_shards):
            lo, hi = routing.shard_range(s)
            m = (rows >= lo) & (rows < hi)
            shards.append(sampling.to_csr(
                np.stack([rows[m] - lo, cols[m]]), max(hi - lo, 1)))
        return cls(routing, shards)

    @classmethod
    def from_arrays(cls, routing: RoutingTable,
                    indptrs: List[np.ndarray],
                    indices: List[np.ndarray]) -> "ShardedCSR":
        shards = [sampling.CSRGraph(indptr=np.asarray(p, np.int64),
                                    indices=np.asarray(i, np.int64),
                                    n_nodes=p.shape[0] - 1)
                  for p, i in zip(indptrs, indices)]
        return cls(routing, shards)

    def neighbors_concat(self, nodes: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated neighbor lists + per-node counts for SORTED global
        ``nodes``. The routed equivalent of the single-host gather: each
        owner shard answers for its slice, slices concatenate back in global
        node order (ownership ranges are contiguous and ascending)."""
        nodes = np.asarray(nodes, np.int64)
        starts = np.searchsorted(nodes, self.routing.bounds)
        cols_parts, count_parts = [], []
        for s in range(self.routing.n_shards):
            sel = nodes[starts[s]:starts[s + 1]]
            if sel.size == 0:
                continue
            self.requests_by_shard[s] += sel.size
            lo, _ = self.routing.shard_range(s)
            c, k = sampling.gather_neighbors(self.shards[s], sel - lo)
            cols_parts.append(c)
            count_parts.append(k)
        if not cols_parts:
            return np.zeros(0, np.int64), np.zeros(nodes.size, np.int64)
        return np.concatenate(cols_parts), np.concatenate(count_parts)


def khop_nodes(scsr: ShardedCSR, seeds: np.ndarray, k: int) -> np.ndarray:
    """Sorted node ids of the full k-hop closure of ``seeds``, discovered by
    routed frontier expansion (mirror of ``sampling.khop_nodes``)."""
    seen = np.zeros(scsr.n_nodes, bool)
    frontier = np.unique(np.asarray(seeds, np.int64))
    seen[frontier] = True
    for _ in range(k):
        if frontier.size == 0:
            break
        nbrs, _ = scsr.neighbors_concat(frontier)
        if nbrs.size == 0:
            break
        nbrs = np.unique(nbrs)
        frontier = nbrs[~seen[nbrs]]
        seen[frontier] = True
    return np.nonzero(seen)[0]


def induced_edges(scsr: ShardedCSR, sub_nodes: np.ndarray) -> np.ndarray:
    """(2, E_sub) edge list among ``sub_nodes`` reindexed into the subgraph
    — per-shard adjacency rows routed back and reassembled in global node
    order, identical to the single-host ``sampling.induced_edges``."""
    remap = -np.ones(scsr.n_nodes, np.int64)
    remap[sub_nodes] = np.arange(sub_nodes.size)
    cols, counts = scsr.neighbors_concat(sub_nodes)
    if cols.size == 0:
        return np.zeros((2, 0), np.int64)
    rows = np.repeat(sub_nodes, counts)
    keep = remap[cols] >= 0
    return np.stack([remap[rows[keep]], remap[cols[keep]]])


def khop_subgraph(scsr: ShardedCSR, seeds: np.ndarray, k: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Routed k-hop subgraph extraction: (sorted sub_nodes, reindexed edges,
    seed positions) — bit-identical to ``sampling.khop_subgraph``."""
    seeds = np.asarray(seeds, np.int64)
    sub_nodes = khop_nodes(scsr, seeds, k)
    sub_edges = induced_edges(scsr, sub_nodes)
    seed_pos = np.searchsorted(sub_nodes, seeds)
    return sub_nodes, sub_edges, seed_pos
