"""Dense oracles for every kernel (reference: ``repro/kernels/ref.py``).

They re-derive each kernel's math with dense ops (unpack to ±1, decode FRDC
to a dense matrix, matmul), sharing nothing with the kernels beyond the
bit-packing convention, so a failure localizes to the kernel.
"""
from __future__ import annotations

import torch

from ..core import bitops
from ..core.frdc import FRDCMatrix, TILE, to_dense


def bmm_xnor_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                 n_bits: int) -> torch.Tensor:
    """Unpack to ±1 and matmul in int64."""
    a = bitops.unpack_pm1(a_packed, n_bits, dtype=torch.int64)
    b = bitops.unpack_pm1(b_packed, n_bits, dtype=torch.int64)
    return (a @ b.T).to(torch.int32)


def bmm_xnor_bin_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                     n_bits: int) -> torch.Tensor:
    return bitops.pack_bits(bmm_xnor_ref(a_packed, b_packed, n_bits) >= 0)


def binarize_pack_ref(x: torch.Tensor) -> torch.Tensor:
    return bitops.pack_bits(x >= 0, axis=-1)


def bspmm_bits_ref(adj: FRDCMatrix, x_packed: torch.Tensor, n_feat: int,
                   binarize: bool = True) -> torch.Tensor:
    """Decode FRDC to dense, unpack ±1 activations, matmul; (R4, n_feat)
    counts or (R4, Wf) sign words."""
    a = to_dense(adj, apply_scales=False).to(torch.int64)
    act = bitops.unpack_pm1(x_packed, n_feat, dtype=torch.int64)[: a.shape[1]]
    full = a.new_zeros((adj.n_tile_rows * TILE, n_feat))
    full[: a.shape[0]] = a @ act
    full = full.to(torch.int32)
    return bitops.pack_bits(full >= 0) if binarize else full


def bspmm_fp_ref(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """Raw ``A_bin @ x`` (scales excluded, as in the kernel); (R4, F)."""
    a = to_dense(adj, apply_scales=False).to(x.dtype)
    full = x.new_zeros((adj.n_tile_rows * TILE, x.shape[1]))
    full[: a.shape[0]] = a @ x[: a.shape[1]]
    return full
