"""Plain reference of the BitGNN GCN "bin" forward (Table 3 "Ours(bin)").

Layer 1: BN(x) @ (sign(W1) * s1) -> sign -> binary aggregation over the
0/1 adjacency A (no self loops): the integer sum over a row's neighbours
of their +-1 values -> sign (0 counts as +). Layer 2: the +-1 hidden
matrix @ sign(W2) (an integer dot), times s2, then the GCN aggregation
D^-1/2 (A + I) D^-1/2 with D the degrees of A + I. ``s`` is a weight's
per-output-column mean |W|; every sign takes 0 as +1.

:func:`forward` gives the logits in one precision. :func:`bounds` gives,
in float64, the interval each logit lies in whatever side float32
rounding puts a sign on when the value is within ``common.EPS`` of 0
relative to the magnitude of its terms (``common.sign3``): such a sign is
left open, and the open signs are carried through the integer counts and
the aggregation as intervals.
"""
from __future__ import annotations

import torch

from . import common


def _layer1(x, sw1, s1, precision):
    xn = common.batch_norm(x)
    w = sw1 * s1
    h = common.matmul(xn, w, precision)
    return h, xn, w


def forward(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
            weights: dict, precision: str = "float64") -> torch.Tensor:
    """Logits (n, c) in the dtype of ``precision``."""
    dt = common.dtype(precision)
    n = x.shape[0]
    sw1, s1 = common.weight_signs(weights["w1"], dt)
    sw2, s2 = common.weight_signs(weights["w2"], dt)
    h, _, _ = _layer1(x.to(dt), sw1, s1, precision)
    counts = common.spmm(common.csr(rows, cols, n, dt=dt), common.sign(h))
    z = (common.sign(counts).double() @ sw2.double()).to(dt) * s2
    return common.gcn_aggregate(rows, cols, n, z)


def bounds(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           weights: dict) -> tuple:
    """(lo, hi) float64 logits (n, c)."""
    dt = torch.float64
    n = x.shape[0]
    sw1, s1 = common.weight_signs(weights["w1"], dt)
    sw2, s2 = common.weight_signs(weights["w2"], dt)
    h, xn, w = _layer1(x.to(dt), sw1, s1, "float64")
    mag = xn.abs() @ w.abs()
    del xn
    s, open_ = common.sign3(h, mag)
    del h, mag
    a = common.csr(rows, cols, n, dt=dt)
    c, c_open = common.spmm(a, s), common.spmm(a, open_)
    del a, s, open_
    # a row's count lies in [c - c_open, c + c_open]: its sign is open
    # where that range holds 0 and a negative value
    lo_c, hi_c = c - c_open, c + c_open
    s2x = torch.where(lo_c >= 0, 1.0, torch.where(hi_c < 0, -1.0, 0.0)).to(dt)
    open2 = (s2x == 0).to(dt)
    z = (s2x @ sw2) * s2
    z_open = open2.sum(dim=1, keepdim=True) * s2
    return (common.gcn_aggregate(rows, cols, n, z - z_open),
            common.gcn_aggregate(rows, cols, n, z + z_open))
