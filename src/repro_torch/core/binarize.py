"""Binarization ops: BIN / SCL / BN (reference: ``repro/core/binarize.py``).

Bi-GCN-style binarization factorizes ``X`` as ``diag(alpha) @ sign(X)``
(row-wise) or ``sign(X) @ diag(beta)`` (column-wise) with positive L1-mean
scales. A BIN right after an SCL cannot change any sign, so the SCL is
elided (paper §3.1.2).

BIN is the one op here with a kernel: :func:`bin_op` goes through
``kernels.ops.binarize_pack``, which launches the CUDA BIN kernel for a
CUDA tensor and runs its plain version for a CPU tensor.
:func:`straight_through_sign` is the training-time sign, with the clipped
identity for its gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import counting, ops
from . import bitops


class BinTensor(NamedTuple):
    """A binarized matrix: packed sign bits + positive scale factors.

    ``packed``: (..., rows, words) int32 bit-view, bits along the columns.
    ``scale``: broadcastable positive factors, row-wise (rows, 1) or
    column-wise (1, cols). ``n``: logical column count (pre-padding).
    """
    packed: torch.Tensor
    scale: torch.Tensor
    n: int

    @property
    def shape(self):
        return (*self.packed.shape[:-1], self.n)


def bin_op(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """BIN: sign-binarize-and-pack along ``axis`` (bit=1 iff x>=0)."""
    x = x.movedim(axis, -1)
    lead = x.shape[:-1]
    packed = ops.binarize_pack(x.reshape(-1, x.shape[-1]).contiguous())
    return packed.reshape(*lead, packed.shape[-1]).movedim(-1, axis)


def row_l1_scale(x: torch.Tensor) -> torch.Tensor:
    """Bi-GCN row-wise scale: mean |x| per row (positive)."""
    return x.abs().mean(dim=-1, keepdim=True)


def col_l1_scale(x: torch.Tensor) -> torch.Tensor:
    """Bi-GCN column-wise scale: mean |x| per column (positive)."""
    return x.abs().mean(dim=-2, keepdim=True)


def binarize_matrix(x: torch.Tensor, scale: str = "row") -> BinTensor:
    """Factorize ``x ~= scale * sign(x)`` and pack the signs."""
    with counting.span("bin"):
        if scale == "row":
            s = row_l1_scale(x)
        elif scale == "col":
            s = col_l1_scale(x)
        elif scale == "none":
            s = x.new_ones((*x.shape[:-2], 1, 1))
        else:
            raise ValueError(scale)
        return BinTensor(packed=bin_op(x, axis=-1), scale=s, n=x.shape[-1])


def dequantize(t: BinTensor, dtype=torch.float32) -> torch.Tensor:
    """Recover the (approximate) full-precision matrix."""
    return bitops.unpack_pm1(t.packed, t.n, axis=-1, dtype=dtype) * t.scale


def scl_op(x: torch.Tensor, scale: torch.Tensor,
           elide: bool = False) -> torch.Tensor:
    """SCL: multiply by (positive) scale factors; no-op when elided."""
    if elide:
        return x
    return x * scale


class BNParams(NamedTuple):
    gamma: torch.Tensor
    beta: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    eps: float = 1e-5


def bn_op(x: torch.Tensor, p: BNParams) -> torch.Tensor:
    """Inference-time batch norm (affine with running stats)."""
    inv = p.gamma * torch.rsqrt(p.var + p.eps)
    return x * inv + (p.beta - p.mean * inv)


def bn_bin_threshold(p: BNParams) -> torch.Tensor:
    """Fold BN into the following BIN: sign(BN(x)) == (x >= t) when gamma>0,
    with ``t = mean - beta*sqrt(var+eps)/gamma``."""
    return p.mean - p.beta * torch.sqrt(p.var + p.eps) / p.gamma


class _STESign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return torch.where(v >= 0, 1.0, -1.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        v, = ctx.saved_tensors
        return g * (v.abs() <= 1.0).to(g.dtype)


def straight_through_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1}, with sign(0) = +1 (not ``torch.sign``, which
    gives 0), and a straight-through gradient: ``g`` where ``|x| <= 1``, 0
    elsewhere. Trains the binary weights and activations of the Bi-GCN
    recipe (paper §5)."""
    return _STESign.apply(x)
