"""Synthetic stat-matched graph datasets (reference:
``repro/graphs/datasets.py``).

A copy of the reference generator: the same numpy RNG calls in the same
order, so ``make_dataset(name, seed, scale)`` gives arrays identical to the
reference's. Each generator matches the node/edge/feature/class counts of
the paper's Table 2 with a planted partition, power-law degrees and
class-correlated sparse binary features.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..core import frdc


@dataclasses.dataclass
class GraphData:
    name: str
    x: np.ndarray            # (N, F) float32 features
    y: np.ndarray            # (N,) int32 labels
    edges: np.ndarray        # (2, E) int64 directed edge list
    n_classes: int
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[1]

    def adjacency(self, kind: str = "gcn", device="cuda") -> frdc.FRDCMatrix:
        r, c = self.edges
        if kind == "gcn":
            return frdc.gcn_normalized(r, c, self.n_nodes, device=device)
        if kind == "mean":
            return frdc.mean_normalized(r, c, self.n_nodes, device=device)
        if kind == "binary":
            return frdc.from_coo(r, c, self.n_nodes, self.n_nodes,
                                 device=device)
        raise ValueError(kind)


# Table 2 of the paper.
DATASET_STATS: Dict[str, dict] = {
    "cora":     dict(n_nodes=2708,   n_edges=13264,      n_feat=1433, n_classes=7),
    "pubmed":   dict(n_nodes=19717,  n_edges=108356,     n_feat=500,  n_classes=3),
    "citeseer": dict(n_nodes=3327,   n_edges=12431,      n_feat=3703, n_classes=6),
    "flickr":   dict(n_nodes=89250,  n_edges=899756,     n_feat=500,  n_classes=7),
    "reddit":   dict(n_nodes=232965, n_edges=114615892,  n_feat=602,  n_classes=41),
}


def make_dataset(name: str, seed: int = 0, scale: float = 1.0,
                 homophily: float = 0.85, feature_signal: float = 0.08,
                 ) -> GraphData:
    """Generate a stat-matched synthetic dataset.

    ``scale`` < 1 shrinks node/edge counts proportionally (used to fit the
    Reddit-class graph in CPU benchmark time; ``--full`` passes 1.0).
    """
    stats = DATASET_STATS[name]
    n = max(int(stats["n_nodes"] * scale), 64)
    e = max(int(stats["n_edges"] * scale), 4 * n)
    f = stats["n_feat"]
    c = stats["n_classes"]
    rng = np.random.default_rng(seed)

    y = rng.integers(0, c, size=n).astype(np.int32)

    # power-law degree propensities (alpha ~ 2.1, truncated)
    prop = rng.pareto(1.1, size=n) + 1.0
    prop /= prop.sum()

    half = e // 2
    src = rng.choice(n, size=half, p=prop)
    same = rng.random(half) < homophily
    dst = np.empty(half, np.int64)
    # homophilous endpoints: random node of the same class
    order = np.argsort(y, kind="stable")
    class_starts = np.searchsorted(y[order], np.arange(c))
    class_ends = np.searchsorted(y[order], np.arange(c), side="right")
    class_ends = np.append(class_starts[1:], n)
    cls = y[src]
    lo, hi = class_starts[cls], class_ends[cls]
    pick = (lo + (rng.random(half) * np.maximum(hi - lo, 1)).astype(np.int64))
    dst[same] = order[pick[same]]
    dst[~same] = rng.choice(n, size=(~same).sum())
    keep = src != dst
    src, dst = src[keep], dst[keep]
    edges = np.concatenate([np.stack([src, dst]), np.stack([dst, src])], axis=1)
    edges = np.unique(edges, axis=1)

    # class-correlated sparse binary features (bag-of-words style)
    words_per_class = max(f // c, 1)
    x = (rng.random((n, f)) < 0.015).astype(np.float32)
    for k in range(c):
        cols = slice(k * words_per_class, min((k + 1) * words_per_class, f))
        rows = np.nonzero(y == k)[0]
        boost = rng.random((rows.size, cols.stop - cols.start)) < feature_signal
        x[rows, cols] = np.maximum(x[rows, cols], boost.astype(np.float32))

    # transductive split: 20 train/class, 500 val, rest test (Planetoid-style)
    train_mask = np.zeros(n, bool)
    for k in range(c):
        idx = np.nonzero(y == k)[0]
        train_mask[rng.choice(idx, size=min(20, idx.size), replace=False)] = True
    rest = np.nonzero(~train_mask)[0]
    rng.shuffle(rest)
    val_mask = np.zeros(n, bool)
    val_mask[rest[:min(500, rest.size // 4)]] = True
    test_mask = ~(train_mask | val_mask)

    return GraphData(name=name, x=x, y=y, edges=edges.astype(np.int64),
                     n_classes=c, train_mask=train_mask, val_mask=val_mask,
                     test_mask=test_mask)
