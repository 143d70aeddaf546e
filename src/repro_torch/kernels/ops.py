"""Dispatch by tensor device over the kernels (reference:
``repro/kernels/ops.py``).

For a CUDA tensor each entry point launches its CUDA kernel; for a CPU
tensor it runs the kernel's plain PyTorch version; any other device raises.
There is no fallback: a CUDA tensor either reaches the kernel or the launch
raises. The wrappers also apply what the TPU dispatch applies around the
kernels (the BSpMM scale order, row crops), and :func:`launch_counts` reads
the per-kernel CUDA launch counters.

The serving sessions select kernels with :func:`serve_kernels`: a
``block_shape`` routes the BSpMM stages to the 2D block grids. The fused
per-layer kernels (:mod:`.fused_layer`) are called by the sessions
themselves, one entry point per layer kind. Unlike the reference, where the
Pallas kernels run only on a TPU (or under ``force_kernels``), the port
always has its kernels: on the CPU the same flags select their plain
versions.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from ..core.frdc import FRDCMatrix
from . import bmm_kernel, bspmm_kernel, fused_layer, pack_kernel

_COUNTERS = (pack_kernel.LAUNCHES, bmm_kernel.LAUNCHES, bspmm_kernel.LAUNCHES,
             fused_layer.LAUNCHES)


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
               binarize: bool = True, trinary_mode: str = "s3_two_popc",
               block_shape=None) -> torch.Tensor:
    """FRDC trinary aggregation cropped to ``adj.n_rows`` rows: (n_rows,
    Wf*32) int32 counts, or (n_rows, Wf) sign words if binarize. A
    ``block_shape`` (rows, feats) routes to the 2D block grid."""
    plan = bspmm_kernel._block_plan(block_shape, n_feat, packed_width=True)
    card = _on_card(x_packed)
    if plan is None:
        run = bspmm_kernel.bspmm_bits_cuda if card \
            else bspmm_kernel.bspmm_bits_plain
        out = run(adj, x_packed, n_feat, binarize, trinary_mode)
    else:
        run = bspmm_kernel.bspmm_bits_grid_cuda if card \
            else bspmm_kernel.bspmm_bits_grid_plain
        out = run(adj, x_packed, n_feat, binarize, trinary_mode, plan)
    return out[: adj.n_rows]


def bspmm_fp(adj: FRDCMatrix, x: torch.Tensor,
             block_shape=None) -> torch.Tensor:
    """Exact ``Adj_eff @ x`` for fp x: the column scale is folded into x
    before the kernel, the row scale applied once after (the order of the
    reference's ``ops._serve_fp_backend``). A ``block_shape`` routes to the
    2D block grid."""
    plan = bspmm_kernel._block_plan(block_shape, x.shape[1],
                                    packed_width=False)
    if adj.col_scale is not None:
        x = x * adj.col_scale[:, None].to(x.dtype)
    card = _on_card(x)
    if plan is None:
        run = bspmm_kernel.bspmm_fp_cuda if card else bspmm_kernel.bspmm_fp_plain
        out = run(adj, x)
    else:
        run = bspmm_kernel.bspmm_fp_grid_cuda if card \
            else bspmm_kernel.bspmm_fp_grid_plain
        out = run(adj, x, plan)
    out = out[: adj.n_rows]
    if adj.row_scale is not None:
        out = out * adj.row_scale[:, None].to(out.dtype)
    return out


def _serve_bits_backend(adj: FRDCMatrix, x_packed: torch.Tensor,
                        trinary_mode: str, block_shape=None) -> torch.Tensor:
    """``core.bspmm`` trinary-counts stage: raw counts (n_rows, Wf*32)."""
    return bspmm_bits(adj, x_packed, x_packed.shape[1] * 32, binarize=False,
                      trinary_mode=trinary_mode, block_shape=block_shape)


# ---------------------------------------------------------------------------
# Explicit serve aggregations of the sharded layer executors
# ---------------------------------------------------------------------------
# The 1D kernels on the card, their plain versions on the CPU, whatever a
# ``serve_kernels`` context routes: the executors' stages call these
# directly, as the reference's shard_map bodies do.

def serve_fp(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """BSpMM.FBF for the layer executors: exact scaled fp aggregation."""
    return bspmm_fp(adj, x)


def serve_counts(adj: FRDCMatrix, x_packed: torch.Tensor,
                 trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """Raw trinary counts (n_rows, Wf*32) for the layer executors: the
    integer partial sums of the distributed binary-aggregation layer, which
    add exactly across the intra/halo split."""
    return bspmm_bits(adj, x_packed, x_packed.shape[1] * 32, binarize=False,
                      trinary_mode=trinary_mode)


def serve_fp_pair(intra: FRDCMatrix, halo: FRDCMatrix, x_local: torch.Tensor,
                  x_remote: torch.Tensor) -> torch.Tensor:
    """Distributed FBF aggregation ``(intra_raw @ x_local + halo_raw @
    x_remote) * row_scale``: each matrix's column scale folds into its own
    operand, and the row scale the two share is applied once, after the
    add (the reference's association, ``ops.serve_fp_pair``)."""
    y = serve_fp(intra._replace(row_scale=None), x_local) \
        + serve_fp(halo._replace(row_scale=None), x_remote)
    if intra.row_scale is not None:
        y = y * intra.row_scale[:, None].to(y.dtype)
    return y


@contextlib.contextmanager
def serve_kernels(enabled: bool = True, block_shape=None):
    """Route the BSpMM aggregation stages of ``core.bspmm`` by the serving
    plan while active; yields whether the selection is on.

    ``enabled`` is the sessions' ``use_pallas`` flag: off, the default 1D
    kernels run and ``block_shape`` is ignored, as in the reference. On,
    ``block_shape`` (``SessionPlan.bspmm_block``) sends both stages to the
    2D block grids."""
    if not enabled:
        yield False
        return
    from ..core import bspmm as bspmm_core
    with bspmm_core.override_backends(
            fp=functools.partial(bspmm_fp, block_shape=block_shape),
            bits=functools.partial(_serve_bits_backend,
                                   block_shape=block_shape)):
        yield True
