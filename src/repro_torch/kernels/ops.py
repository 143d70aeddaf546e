"""Dispatch by tensor device over the four kernels (reference:
``repro/kernels/ops.py``).

For a CUDA tensor each entry point launches its CUDA kernel; for a CPU
tensor it runs the kernel's plain PyTorch version; any other device raises.
There is no fallback: a CUDA tensor either reaches the kernel or the launch
raises. The wrappers also apply what the TPU dispatch applies around the
kernels (the BSpMM scale order, row crops), and :func:`launch_counts` reads
the per-kernel CUDA launch counters.
"""
from __future__ import annotations

import torch

from ..core.frdc import FRDCMatrix
from . import bmm_kernel, bspmm_kernel, pack_kernel

_COUNTERS = (pack_kernel.LAUNCHES, bmm_kernel.LAUNCHES, bspmm_kernel.LAUNCHES)


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"repro_torch has no kernels for device {t.device}")


def launch_counts() -> dict:
    """CUDA launches per kernel since the last :func:`reset_launch_counts`."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


def binarize_pack(x: torch.Tensor) -> torch.Tensor:
    """BIN: (M, F) float -> (M, ceil(F/32)) int32 bit-view sign words."""
    if _on_card(x):
        return pack_kernel.binarize_pack_cuda(x)
    return pack_kernel.binarize_pack_plain(x)


def bmm_xnor(a_packed: torch.Tensor, b_packed: torch.Tensor, n_bits: int,
             binarize: bool = False) -> torch.Tensor:
    """Packed ±1 matmul -> (M, N) int32 counts, or sign words if binarize."""
    if _on_card(a_packed):
        return bmm_kernel.bmm_xnor_cuda(a_packed, b_packed, n_bits, binarize)
    return bmm_kernel.bmm_xnor_plain(a_packed, b_packed, n_bits, binarize)


def bspmm_bits(adj: FRDCMatrix, x_packed: torch.Tensor, n_feat: int,
               binarize: bool = True,
               trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """FRDC trinary aggregation cropped to ``adj.n_rows`` rows: (n_rows,
    Wf*32) int32 counts, or (n_rows, Wf) sign words if binarize."""
    run = bspmm_kernel.bspmm_bits_cuda if _on_card(x_packed) \
        else bspmm_kernel.bspmm_bits_plain
    return run(adj, x_packed, n_feat, binarize, trinary_mode)[: adj.n_rows]


def bspmm_fp(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """Exact ``Adj_eff @ x`` for fp x: the column scale is folded into x
    before the kernel, the row scale applied once after (the order of the
    reference's ``ops._serve_fp_backend``)."""
    if adj.col_scale is not None:
        x = x * adj.col_scale[:, None].to(x.dtype)
    run = bspmm_kernel.bspmm_fp_cuda if _on_card(x) \
        else bspmm_kernel.bspmm_fp_plain
    out = run(adj, x)[: adj.n_rows]
    if adj.row_scale is not None:
        out = out * adj.row_scale[:, None].to(out.dtype)
    return out
