"""BIN kernel: fused binarize-and-pack (paper Fig. 2 ③).

Replaces the Pallas TPU kernel ``repro/kernels/pack_kernel.py:binarize_pack``
(``_pack_kernel``) with ``csrc/pack.cu``: (M, F) float32/bfloat16 ->
(M, ceil(F/32)) sign words, bit = 1 iff x >= 0, LSB-first, columns past F
packed as 0. On the H100 the kernel is bound by bytes (one read of x, one
write of the words); one warp builds one word with one ``__ballot_sync``
over 32 coalesced loads.
"""
from __future__ import annotations

import torch

from ..core import bitops
from . import build, counting

LAUNCHES = {"binarize_pack": 0}  # CUDA launches (plain-version calls not counted)
ENTRIES = {"binarize_pack": 0}   # entries on either device (``counting``)


@counting.entry_point(ENTRIES, "binarize_pack")
def binarize_pack_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: compare, then shift-and-sum 32-bit lane groups."""
    return bitops.sign_bits(x, axis=-1)


@counting.entry_point(ENTRIES, "binarize_pack")
def binarize_pack_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the BIN kernel on a CUDA (M, F) float32/bfloat16 tensor."""
    if not x.is_cuda or x.ndim != 2:
        raise ValueError(f"binarize_pack_cuda takes a 2-D CUDA tensor, got "
                         f"{x.ndim}-D on {x.device}")
    fn = {torch.float32: "binarize_pack_f32",
          torch.bfloat16: "binarize_pack_bf16"}.get(x.dtype)
    if fn is None:
        raise TypeError(f"binarize_pack_cuda takes float32/bfloat16, got {x.dtype}")
    x = x.contiguous()
    m, f = x.shape
    wf = bitops.padded_words(f)
    out = torch.empty((m, wf), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(getattr(build.library("pack"), fn)(
        x.data_ptr(), out.data_ptr(), m, f, wf, stream), fn)
    LAUNCHES["binarize_pack"] += 1
    return out
