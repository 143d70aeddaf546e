"""Plain reference of the BitGNN GraphSAGE forward (Table 4 "Ours").

Each layer, of weights W_self and W_agg: b = BN(h); r = mean |b| a row;
p = sign(b) (0 counts as +); self = (p @ sign(W_self)) * r * s_self; agg
= D^-1 A ((p @ sign(W_agg)) * r * s_agg) with A the 0/1 adjacency (no self
loops) and D its degrees (at least 1); out = self + agg, ReLU after
layer 1. ``s`` is a weight's per-output-column mean |W|. The +-1 products
are integer dots, exact in any float type that holds them.

:func:`forward` gives the logits in one precision. :func:`bounds` gives,
in float64, the interval each logit lies in whatever side float32
rounding puts a sign on when BN's value is within ``common.EPS`` of 0
relative to the magnitude of its terms (``common.sign3``), the open signs
carried through the integer dots and the aggregation as intervals.
"""
from __future__ import annotations

import torch

from . import common


def _mean_adjacency(rows, cols, n, dt):
    deg = torch.bincount(rows, minlength=n).to(torch.float64)
    dinv = (1.0 / deg.clamp(min=1.0)).to(dt)
    return common.csr(rows, cols, n, dt=dt), dinv


def _layer(h, a, dinv, w_self, w_agg, dt):
    b = common.batch_norm(h)
    r = b.abs().mean(dim=-1, keepdim=True)
    p = common.sign(b).to(torch.float64)
    del b
    out = []
    for w in (w_self, w_agg):
        sw, s = common.weight_signs(w, dt)
        out.append((p @ sw.to(torch.float64)).to(dt) * r * s)
    self_part, agg_in = out
    return self_part + dinv[:, None] * common.spmm(a, agg_in)


def forward(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
            weights: dict, precision: str = "float64") -> torch.Tensor:
    """Logits (n, c) in the dtype of ``precision``."""
    dt = common.dtype(precision)
    a, dinv = _mean_adjacency(rows, cols, x.shape[0], dt)
    h = torch.relu(_layer(x.to(dt), a, dinv, weights["w1_self"],
                          weights["w1_agg"], dt))
    return _layer(h, a, dinv, weights["w2_self"], weights["w2_agg"], dt)


def _layer_bounds(h, h_mag, a, dinv, w_self, w_agg):
    """(lo, hi, magnitude) of one layer's output; ``h`` is exact and
    ``h_mag`` the magnitude of the terms that float32 sums into it."""
    dt = torch.float64
    mu = h.mean(dim=0, keepdim=True)
    sd = h.std(dim=0, keepdim=True, correction=0) + 1e-5
    b = (h - mu) / sd
    p, open_ = common.sign3(b, (h_mag + mu.abs()) / sd)
    r = b.abs().mean(dim=-1, keepdim=True)
    del b
    parts = []
    for w in (w_self, w_agg):
        sw, s = common.weight_signs(w, dt)
        mid = (p @ sw) * r * s
        half = open_.sum(dim=1, keepdim=True) * r * s
        parts.append((mid - half, mid + half, (mid.abs() + half)))
    (s_lo, s_hi, s_mag), (g_lo, g_hi, g_mag) = parts
    agg = lambda v: dinv[:, None] * common.spmm(a, v)   # noqa: E731
    return (s_lo + agg(g_lo), s_hi + agg(g_hi), s_mag + agg(g_mag))


def bounds(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           weights: dict) -> tuple:
    """(lo, hi) float64 logits (n, c)."""
    x = x.to(torch.float64)
    a, dinv = _mean_adjacency(rows, cols, x.shape[0], torch.float64)
    lo, hi, mag = _layer_bounds(x, x.abs(), a, dinv, weights["w1_self"],
                                weights["w1_agg"])
    # ReLU is monotone, and exact where it clips a value that rounding
    # cannot bring to 0: there float32 holds an exact 0 (magnitude 0). An
    # open layer-1 value feeds layer 2's BN as its midpoint, its width
    # carried into the open signs' margin.
    mag = torch.where(hi < -common.EPS * mag, 0.0, mag)
    lo, hi = torch.relu(lo), torch.relu(hi)
    h = (lo + hi) / 2
    lo2, hi2, _ = _layer_bounds(h, mag + (hi - lo) / common.EPS / 2, a, dinv,
                                weights["w2_self"], weights["w2_agg"])
    return lo2, hi2
