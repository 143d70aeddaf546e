"""1-D block-row graph partitioning (reference: ``repro/graphs/partition.py``).

Tile-rows are split into contiguous shards balanced by edge count; every
shard holds its FRDC block-rows over the full column space. Host numpy, a
copy of the reference's: the same calls in the same order, so bounds and
FRDC arrays equal the reference's for the same edge list. The sharded
serving planner (``serve/sharded/planner.py``) takes its routing table from
:func:`shard_node_bounds`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core import frdc
from ..core.frdc import FRDCMatrix, TILE


@dataclasses.dataclass
class RowShard:
    adj: FRDCMatrix          # local block-rows, col space = FULL graph
    row_start: int           # first (node) row owned
    row_end: int             # one past last node row owned


def shard_tile_bounds(rows: np.ndarray, n: int, n_shards: int) -> np.ndarray:
    """Contiguous tile-row shard boundaries, balanced by EDGE count.

    Returns ``(n_shards + 1,)`` tile-row indices (first 0, last
    ``ceil(n/TILE)``); shard ``s`` owns tile-rows ``[b[s], b[s+1])``.
    Deterministic: a pure function of the row histogram. A shard may be
    empty on a tiny or hub-dominated graph.
    """
    rows = np.asarray(rows, np.int64)
    n_tr = -(-n // TILE)
    counts = np.bincount(rows // TILE, minlength=n_tr)
    cum = np.concatenate([[0], np.cumsum(counts)])
    total = cum[-1]
    bounds = np.zeros(n_shards + 1, np.int64)
    for s in range(n_shards):
        target = total * (s + 1) / n_shards
        tr_end = int(np.searchsorted(cum, target)) if s < n_shards - 1 else n_tr
        bounds[s + 1] = max(tr_end, bounds[s])
    return bounds


def shard_node_bounds(rows: np.ndarray, n: int, n_shards: int) -> np.ndarray:
    """``shard_tile_bounds`` in NODE units: tile-aligned except the last,
    which is clamped to ``n``. The sharded routing table is this array."""
    return np.minimum(shard_tile_bounds(rows, n, n_shards) * TILE, n)


def partition_rows(rows: np.ndarray, cols: np.ndarray, n: int,
                   n_shards: int, kind: str = "gcn",
                   device="cuda") -> List[RowShard]:
    """Split an edge list into ``n_shards`` contiguous tile-row shards
    (boundaries from :func:`shard_tile_bounds`); every shard holds its FRDC
    block-rows over the FULL column space, on ``device``."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s = rows[order], cols[order]
    n_tr = -(-n // TILE)
    counts = np.bincount(rows_s // TILE, minlength=n_tr)
    cum = np.concatenate([[0], np.cumsum(counts)])
    bounds = shard_tile_bounds(rows, n, n_shards)
    shards = []
    prev_tr = 0
    for s in range(n_shards):
        tr_end = int(bounds[s + 1])
        lo, hi = cum[prev_tr], cum[tr_end]
        r_lo, r_hi = prev_tr * TILE, min(tr_end * TILE, n)
        local_rows = rows_s[lo:hi] - r_lo
        local_cols = cols_s[lo:hi]
        scales = {}
        if kind == "gcn":
            # global degrees for exact normalization
            deg = np.bincount(rows, minlength=n) + 1.0
            dinv = 1.0 / np.sqrt(deg)
            loop = np.arange(r_lo, r_hi, dtype=np.int64)
            local_rows = np.concatenate([local_rows, loop - r_lo])
            local_cols = np.concatenate([local_cols, loop])
            scales = dict(row_scale=dinv[r_lo:r_hi], col_scale=dinv)
        elif kind == "mean":
            deg = np.bincount(rows, minlength=n)
            scales = dict(row_scale=1.0 / np.maximum(deg[r_lo:r_hi], 1))
        adj = frdc.from_coo(local_rows, local_cols, max(r_hi - r_lo, TILE), n,
                            device=device, **scales)
        shards.append(RowShard(adj=adj, row_start=r_lo, row_end=r_hi))
        prev_tr = tr_end
    return shards


def shard_stats(shards: List[RowShard]) -> dict:
    edges = np.array([s.adj.nnz for s in shards], np.float64)
    return dict(
        n_shards=len(shards),
        edges_mean=float(edges.mean()),
        edges_max=float(edges.max()),
        imbalance=float(edges.max() / max(edges.mean(), 1.0)),
    )
