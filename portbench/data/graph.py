"""Stat-matched synthetic graphs at the paper's Table 2 counts, made on the
device from a seed.

Patterned on ``src/repro_torch/graphs/datasets.py`` (``make_dataset``):
power-law degree propensities, a planted partition with homophily,
symmetrized and deduplicated edges without self loops, and sparse binary
features with a class-correlated boost. What differs:

* every array is drawn with a ``torch.Generator`` on the device, so the
  arrays differ from numpy's for the same seed;
* the propensities are the Pareto quantiles ``(1 - q) ** (-1 / alpha)`` at
  evenly spaced ``q``, shuffled by the seed, not Pareto draws: every seed
  gets the same set of hub sizes in another order, so the work of a
  forward hardly moves from seed to seed (a heavy tail drawn anew moves
  the largest hub, and with it the deduplicated edge count, by the seed);
* endpoint pairs are drawn in rounds until the deduplicated graph has
  exactly Table 2's edge count (one round of draws leaves Reddit at about
  64% of it, the heavy tail drawing the same hub pairs again);
* no labels are kept beyond what shapes the edges and features, and no
  train / test split is made: the benchmark only runs inference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Graph(NamedTuple):
    x: torch.Tensor        # (n, f) float32 0/1 features
    rows: torch.Tensor     # (e,) int64, sorted by (row, col), no self loops
    cols: torch.Tensor     # (e,) int64
    n_nodes: int
    n_feat: int
    n_classes: int

    @property
    def n_edges(self) -> int:
        return int(self.rows.numel())


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


MAX_ROUNDS = 64


def _draw_pairs(m: int, cdf, y, order, starts, counts, homophily: float,
                g: torch.Generator, n: int) -> torch.Tensor:
    """``m`` endpoint pairs: a source by propensity, a destination of the
    source's class with probability ``homophily``, else any node; without
    self loops, as keys ``lo * n + hi`` with lo < hi."""
    dev = cdf.device
    u = torch.rand(m, generator=g, device=dev, dtype=torch.float64)
    src = torch.searchsorted(cdf, u).clamp_(max=n - 1)
    cls = y[src]
    last = starts[cls] + counts[cls] - 1
    pick = starts[cls] + (torch.rand(m, generator=g, device=dev)
                          * counts[cls]).long()
    pick = torch.minimum(pick, last)
    same = torch.rand(m, generator=g, device=dev) < homophily
    other = torch.randint(0, n, (m,), generator=g, device=dev)
    dst = torch.where(same, order[pick], other)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return torch.minimum(src, dst) * n + torch.maximum(src, dst)


def make_graph(spec: dict, g: torch.Generator, device) -> Graph:
    """The graph of a traffic file's ``graph`` entry, drawn from ``g``:
    ``n_nodes``, ``n_edges`` (directed edges, each undirected edge counted
    twice, as Table 2 counts them), ``n_feat``, ``n_classes``,
    ``homophily``, ``degree_alpha``, ``feature_density``,
    ``feature_signal``.

    Endpoint pairs are drawn in rounds and deduplicated until there are
    ``n_edges // 2`` distinct ones; a seeded choice of exactly that many
    is kept, so every seed has the published edge count."""
    n, f, c = int(spec["n_nodes"]), int(spec["n_feat"]), int(spec["n_classes"])
    target = int(spec["n_edges"]) // 2

    y = torch.randint(0, c, (n,), generator=g, device=device)
    q = (torch.arange(n, device=device, dtype=torch.float64) + 0.5) / n
    prop = (1.0 - q) ** (-1.0 / float(spec["degree_alpha"]))
    prop = prop[torch.randperm(n, generator=g, device=device)]
    cdf = torch.cumsum(prop, 0)
    cdf /= cdf[-1].clone()
    order = torch.argsort(y, stable=True)
    counts = torch.bincount(y, minlength=c)
    starts = torch.cumsum(counts, 0) - counts

    keys = torch.empty(0, dtype=torch.int64, device=device)
    m = target
    for _ in range(MAX_ROUNDS):
        had = keys.numel()
        keys = torch.unique(torch.cat([keys, _draw_pairs(
            m, cdf, y, order, starts, counts, float(spec["homophily"]), g,
            n)]))
        short = target - keys.numel()
        if short <= 0:
            break
        gain = max((keys.numel() - had) / m, 0.01)
        m = int(short / gain * 1.25) + 1024
    else:
        raise RuntimeError(f"{keys.numel()} distinct edges after "
                           f"{MAX_ROUNDS} rounds, short of {target}")
    keys = keys[torch.randperm(keys.numel(), generator=g,
                               device=device)[:target]]
    lo, hi = keys // n, keys % n
    del keys
    both = torch.sort(torch.cat([lo * n + hi, hi * n + lo])).values
    del lo, hi
    rows, cols = both // n, both % n
    del both

    # class-correlated sparse binary features (bag-of-words style)
    words = max(f // c, 1)
    col_class = torch.arange(f, device=device) // words
    x = torch.rand((n, f), generator=g, device=device) \
        < float(spec["feature_density"])
    boost = torch.rand((n, f), generator=g, device=device) \
        < float(spec["feature_signal"])
    boost &= col_class[None, :] == y[:, None]
    x |= boost
    del boost
    return Graph(x=x.to(torch.float32), rows=rows, cols=cols, n_nodes=n,
                 n_feat=f, n_classes=c)


def glorot(g: torch.Generator, shape, device) -> torch.Tensor:
    """Glorot-uniform float32 weights of ``shape`` (fan in, fan out)."""
    lim = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(tuple(shape), generator=g, device=device) * 2 - 1) * lim


def tile_count(rows: torch.Tensor, cols: torch.Tensor, n: int,
               tile: int = 4) -> int:
    """Non-empty ``tile`` x ``tile`` blocks of the 0/1 matrix with ones at
    (rows, cols): the size of its tiled form."""
    ntc = -(-n // tile)
    return int(torch.unique((rows // tile) * ntc + cols // tile).numel())
