"""The comparison that decides ``correct``: the program's logits against
the reference's interval ``[lo, hi]`` (the reference's ``bounds``: where a
sign lies within float32 rounding of 0 the reference leaves it open), by
two numbers. A logit's gap is its distance outside the interval (0
inside); ``m`` is the interval's midpoint.

* ``mean_gap``: the mean gap over the mean |m|. A lower precision puts
  many signs on the other side of 0 beyond the open margin, each moving a
  node's neighbours a little; this number grows with their count.
* ``row_gap``: the widest gap of a node's row over that row's largest |m|
  plus the mean |m|: one answer altered, read against its own size.

A non-finite logit, or a shape other than the reference's, reads inf.
"""
from __future__ import annotations

import math

import torch

NUMBERS = ("mean_gap", "row_gap")


def gaps(program: torch.Tensor, lo: torch.Tensor, hi=None) -> dict:
    """The numbers for ``program`` against ``[lo, hi]`` (a point reference
    ``lo`` where ``hi`` is None)."""
    hi = lo if hi is None else hi
    if tuple(program.shape) != tuple(lo.shape):
        return dict.fromkeys(NUMBERS, math.inf)
    lo, hi = lo.to(torch.float64), hi.to(torch.float64)
    p = program.to(lo.device, torch.float64)
    d = (lo - p).clamp(min=0) + (p - hi).clamp(min=0)
    if not bool(torch.isfinite(p).all()):
        return dict.fromkeys(NUMBERS, math.inf)
    mag = ((lo + hi) / 2).abs()
    mean = mag.mean()
    row = d.amax(dim=1) / (mag.amax(dim=1) + mean)
    return {"mean_gap": float(d.mean() / mean),
            "row_gap": float(row.max())}


def within(readings: dict, limits: dict) -> bool:
    """Every number at or under its limit (a missing reading fails)."""
    return all(readings.get(k, math.inf) <= v for k, v in limits.items())
