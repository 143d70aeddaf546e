"""Inductive-learning samplers (GraphSAGE neighbour sampling, GraphSAINT
node-budget subgraphs; paper §2.1 / §4.1) and the deterministic k-hop
subgraph extraction of serving (reference: ``repro/graphs/sampling.py``).

Host numpy, a copy of the reference's: the same calls in the same order,
the samplers' numpy generator draws included, so every array equals the
reference's for the same graph and seed.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import numpy as np

from ..core import frdc
from .datasets import GraphData


class CSRGraph(NamedTuple):
    """Host-side CSR over the directed edge list: row -> neighbor columns.

    Rows are the RECEIVING side of aggregation (``out[r] += x[c]`` for every
    edge (r, c)), matching ``frdc.from_coo(edges[0], edges[1], ...)``.
    """
    indptr: np.ndarray     # (N+1,) int64
    indices: np.ndarray    # (E,) int64
    n_nodes: int

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]


def to_csr(edges: np.ndarray, n_nodes: int) -> CSRGraph:
    indptr, indices = _build_csr(np.asarray(edges, np.int64), n_nodes)
    return CSRGraph(indptr=indptr, indices=indices, n_nodes=n_nodes)


def _build_csr(edges: np.ndarray, n: int):
    order = np.argsort(edges[0], kind="stable")
    counts = np.bincount(edges[0], minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, edges[1][order]


def gather_neighbors(csr: CSRGraph, nodes: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated neighbor lists of ``nodes`` + per-node counts, vectorized
    (no Python loop over nodes: this is on the per-batch serving path)."""
    counts = csr.indptr[nodes + 1] - csr.indptr[nodes]
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), counts
    ends = np.cumsum(counts)
    offs = np.arange(total) - np.repeat(ends - counts, counts)
    idx = np.repeat(csr.indptr[nodes], counts) + offs
    return csr.indices[idx], counts


def khop_nodes(csr: CSRGraph, seeds: np.ndarray, k: int) -> np.ndarray:
    """Sorted node ids of the FULL (unsampled) k-hop closure of ``seeds``.

    Every node at distance <= k-1 from a seed has its complete neighborhood
    inside the closure, so an L-layer GNN restricted to the k=L closure
    reproduces full-graph outputs for the seeds exactly.
    """
    seen = np.zeros(csr.n_nodes, bool)
    frontier = np.unique(np.asarray(seeds, np.int64))
    seen[frontier] = True
    for _ in range(k):
        if frontier.size == 0:
            break
        nbrs, _ = gather_neighbors(csr, frontier)
        if nbrs.size == 0:
            break
        nbrs = np.unique(nbrs)
        frontier = nbrs[~seen[nbrs]]
        seen[frontier] = True
    return np.nonzero(seen)[0]


def induced_edges(csr: CSRGraph, sub_nodes: np.ndarray) -> np.ndarray:
    """(2, E_sub) edge list among ``sub_nodes``, reindexed into the subgraph
    (relative node order preserved: sub id i is the i-th smallest full id)."""
    remap = -np.ones(csr.n_nodes, np.int64)
    remap[sub_nodes] = np.arange(sub_nodes.size)
    cols, counts = gather_neighbors(csr, sub_nodes)
    if cols.size == 0:
        return np.zeros((2, 0), np.int64)
    rows = np.repeat(sub_nodes, counts)
    keep = remap[cols] >= 0
    return np.stack([remap[rows[keep]], remap[cols[keep]]])


def khop_subgraph(csr: CSRGraph, seeds: np.ndarray, k: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full k-hop subgraph: (sorted sub_nodes, (2, E_sub) reindexed edges,
    positions of the seeds inside ``sub_nodes`` in the order given)."""
    seeds = np.asarray(seeds, np.int64)
    sub_nodes = khop_nodes(csr, seeds, k)
    sub_edges = induced_edges(csr, sub_nodes)
    seed_pos = np.searchsorted(sub_nodes, seeds)
    return sub_nodes, sub_edges, seed_pos


class ExtractedSubgraph(NamedTuple):
    """One extracted k-hop serving subgraph: pure host arrays, the unit of
    work the extract stage hands to the compute stage."""
    sub_nodes: np.ndarray   # (n_sub,) sorted global node ids
    sub_edges: np.ndarray   # (2, E_sub) edges reindexed into the subgraph
    seed_pos: np.ndarray    # positions of the seeds inside sub_nodes


def extract_khop(csr: CSRGraph, seeds: np.ndarray,
                 k: int) -> ExtractedSubgraph:
    """Extraction entry point of the serving path."""
    return ExtractedSubgraph(*khop_subgraph(csr, seeds, k))


def sage_sample(data: GraphData, batch_nodes: np.ndarray, fanouts=(10, 10),
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """GraphSAGE fixed-fanout neighbour expansion from ``batch_nodes``
    outward, one fanout a layer. Returns (subgraph node ids, (2, E_sub)
    edge list reindexed into the subgraph)."""
    rng = np.random.default_rng(seed)
    indptr, indices = _build_csr(data.edges, data.n_nodes)
    frontier = np.unique(batch_nodes)
    nodes = [frontier]
    for fan in fanouts:
        nxt = []
        for u in frontier:
            nbrs = indices[indptr[u]:indptr[u + 1]]
            if nbrs.size > fan:
                nbrs = rng.choice(nbrs, size=fan, replace=False)
            nxt.append(nbrs)
        frontier = np.unique(np.concatenate(nxt)) if nxt \
            else np.array([], np.int64)
        nodes.append(frontier)
    sub_nodes = np.unique(np.concatenate(nodes))
    remap = -np.ones(data.n_nodes, np.int64)
    remap[sub_nodes] = np.arange(sub_nodes.size)
    src, dst = data.edges
    keep = (remap[src] >= 0) & (remap[dst] >= 0)
    sub_edges = np.stack([remap[src[keep]], remap[dst[keep]]])
    return sub_nodes, sub_edges


def saint_node_sampler(data: GraphData, budget: int, seed: int = 0
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """GraphSAINT node sampler: subgraphs of a degree-proportional node
    budget, without end."""
    rng = np.random.default_rng(seed)
    deg = np.bincount(data.edges[0], minlength=data.n_nodes) + 1.0
    p = deg / deg.sum()
    remapped = -np.ones(data.n_nodes, np.int64)
    while True:
        sub_nodes = np.unique(rng.choice(data.n_nodes, size=budget, p=p))
        remapped[:] = -1
        remapped[sub_nodes] = np.arange(sub_nodes.size)
        src, dst = data.edges
        keep = (remapped[src] >= 0) & (remapped[dst] >= 0)
        yield sub_nodes, np.stack([remapped[src[keep]], remapped[dst[keep]]])


def subgraph_adjacency(sub_nodes: np.ndarray, sub_edges: np.ndarray,
                       kind: str = "gcn", device="cuda") -> frdc.FRDCMatrix:
    n = sub_nodes.size
    r, c = sub_edges
    if kind == "gcn":
        return frdc.gcn_normalized(r, c, n, device=device)
    if kind == "mean":
        return frdc.mean_normalized(r, c, n, device=device)
    return frdc.from_coo(r, c, n, n, device=device)
