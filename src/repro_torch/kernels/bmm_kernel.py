"""XNOR-popc dense binary matmul kernel: the compute core of BMM.BB?.

Replaces the Pallas TPU kernel ``repro/kernels/bmm_kernel.py:bmm_xnor``
(``_bmm_xnor_kernel`` / ``_bmm_xnor_bin_kernel``) with ``csrc/bmm.cu``.
A (M, Wk) and B (N, Wk) are ±1 matrices packed along K (B is the
transposed weight). Output: (M, N) int32 ``n_bits - 2*popc(a^b)`` summed
over the words, or (fused Step ⑥) (M, ceil(N/32)) sign words with the bits
of columns past N zero.

The kernel is a tiled bit GEMM (``csrc/xnor.cuh``): a block keeps a column
tile of B in shared memory and walks row tiles in a grid-stride loop. The
launcher picks the route from N: up to 8 columns (the class layers) it runs
``__popc(a ^ b)`` on register tiles of 4 x 4 outputs a thread, above that
the b1 tensor-core AND-popc product on 16 x 64 warp tiles, each the faster
of the two at its shapes on the H100 (``PERF.md``). It also works out each
launch's tiles, shared memory and grid.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core import bitops
from . import build

LAUNCHES = {"bmm_xnor": 0}  # CUDA launches (plain-version calls not counted)


def bmm_xnor_plain(a_packed: torch.Tensor, b_packed: torch.Tensor,
                   n_bits: int, binarize: bool = False) -> torch.Tensor:
    """Plain PyTorch version: XOR-popc one K word at a time into an (M, N)
    accumulator, as the TPU kernel marches over the packed words."""
    m, wk = a_packed.shape
    if b_packed.shape[1] != wk:
        raise ValueError(f"word counts differ: {wk} vs {b_packed.shape[1]}")
    acc = torch.zeros((m, b_packed.shape[0]), dtype=torch.int64,
                      device=a_packed.device)
    for w in range(wk):
        acc += bitops.popcount(bitops.as_u32(a_packed[:, w, None]
                                             ^ b_packed[None, :, w]))
    out = (int(n_bits) - 2 * acc).to(torch.int32)
    return bitops.pack_bits(out >= 0, axis=-1) if binarize else out


def attributes(n: int, wk: int) -> Dict[str, int]:
    """Registers, static and dynamic shared memory and resident blocks per
    SM of the kernel that a launch at N columns and Wk words runs."""
    return build.attributes("bmm", "bmm_xnor", n, wk)


def bmm_xnor_cuda(a_packed: torch.Tensor, b_packed: torch.Tensor,
                  n_bits: int, binarize: bool = False) -> torch.Tensor:
    """Launch the XNOR-popc kernel on CUDA int32 bit-view operands."""
    for t in (a_packed, b_packed):
        if not t.is_cuda or t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError("bmm_xnor_cuda takes 2-D CUDA int32 bit-view "
                             f"words, got {t.dtype} {t.ndim}-D on {t.device}")
    m, wk = a_packed.shape
    n = b_packed.shape[0]
    if b_packed.shape[1] != wk or b_packed.device != a_packed.device:
        raise ValueError(f"operands differ: {wk} words on {a_packed.device} "
                         f"vs {b_packed.shape[1]} on {b_packed.device}")
    a = a_packed.contiguous()
    b = b_packed.contiguous()
    width = bitops.padded_words(n) if binarize else n
    out = torch.empty((m, width), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    if wk == 0:
        raise ValueError("bmm_xnor_cuda needs at least one word of K")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    build.check(build.library("bmm").bmm_xnor(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, wk, int(n_bits),
        int(binarize), stream), "bmm_xnor")
    LAUNCHES["bmm_xnor"] += 1
    return out
