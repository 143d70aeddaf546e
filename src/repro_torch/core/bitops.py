"""Bit-level primitives for BitGNN in PyTorch (reference: ``repro/core/bitops.py``).

Conventions (identical to the reference)
----------------------------------------
* Bits are packed along a chosen axis into 32-bit words, LSB-first:
  bit ``j`` of word ``w`` holds element ``w*32 + j``.
* Binary activations/weights: stored bit ``1`` means ``+1``, ``0`` means ``-1``.
* Binary adjacency: bit ``1`` means an edge.
* Padding bits are ``0`` in both operands; every dot product is pad-safe.

Storage: PyTorch's uint32 lacks shifts and ``~`` on the CPU, so packed words
are kept as ``int32`` bit-views (``torch.from_numpy(u32.view(np.int32))``
round-trips exactly). Arithmetic that needs unsigned semantics widens to
int64 and masks to the low 32 bits first; :func:`popcount` is a SWAR
popcount on those int64 values (PyTorch has no popcount op). The CUDA
kernels read the same buffers as ``uint32_t``.
"""
from __future__ import annotations

import torch

WORD = 32
MASK32 = 0xFFFFFFFF


def padded_words(n: int) -> int:
    """Number of 32-bit words needed to hold ``n`` bits."""
    return (n + WORD - 1) // WORD


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit-view words -> int64 holding the unsigned value."""
    return words.to(torch.int64) & MASK32


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit-view (two's complement)."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def popcount(u: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2**32); returns int64."""
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) & MASK32) >> 24


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int64, device=device)


def pack_bits(bits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a {0,1}/bool tensor along ``axis`` into int32 bit-view words.

    ``bits.shape[axis]`` need not be a multiple of 32; missing bits pad as 0.
    """
    axis = axis % bits.ndim
    b = bits.movedim(axis, -1).to(torch.int64)
    n = b.shape[-1]
    pad = (-n) % WORD
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    grouped = b.reshape(*b.shape[:-1], (n + pad) // WORD, WORD)
    packed = (grouped << _shifts(b.device)).sum(dim=-1)
    return to_i32(packed).movedim(-1, axis)


def unpack_bits(packed: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns int32 {0,1} with length ``n``."""
    axis = axis % packed.ndim
    words = as_u32(packed.movedim(axis, -1))
    bits = (words[..., :, None] >> _shifts(words.device)) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD)[..., :n]
    return bits.to(torch.int32).movedim(-1, axis)


def sign_bits(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Binarize-and-pack: bit=1 iff x >= 0 (the BNN ``sign``)."""
    return pack_bits(x >= 0, axis=axis)


def unpack_pm1(packed: torch.Tensor, n: int, axis: int = -1,
               dtype=torch.float32) -> torch.Tensor:
    """Unpack BNN-convention bits to ±1 values of ``dtype``."""
    return (2 * unpack_bits(packed, n, axis=axis) - 1).to(dtype)


# ---------------------------------------------------------------------------
# Word-level dot products; all reduce over the LAST (packed-word) axis.
# ---------------------------------------------------------------------------

def xnor_dot(a: torch.Tensor, b: torch.Tensor, n_bits) -> torch.Tensor:
    """±1·±1 dot product: ``n - 2*popc(a XOR b)``."""
    pc = popcount(as_u32(a ^ b)).sum(dim=-1)
    return (int(n_bits) - 2 * pc).to(torch.int32)


def and_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0/1·0/1 dot product: ``popc(a AND b)``."""
    return popcount(as_u32(a & b)).sum(dim=-1).to(torch.int32)


def trinary_dot_s2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Adjacency(0/1)·activation(±1): ``popc(a&b) - popc(a&~b)``."""
    return (popcount(as_u32(a & b)) - popcount(as_u32(a & ~b))
            ).sum(dim=-1).to(torch.int32)


def trinary_dot_s3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Adjacency(0/1)·activation(±1): ``2*popc(a&b) - popc(a)``."""
    return (2 * popcount(as_u32(a & b)) - popcount(as_u32(a))
            ).sum(dim=-1).to(torch.int32)


def trinary_dot_s1(a_bits: torch.Tensor, b_pm1: torch.Tensor) -> torch.Tensor:
    """The if/else on a's nonzeros, for UNPACKED operands: ``a_bits`` is
    {0,1}, ``b_pm1`` is ±1 (or full precision); sums the last axis in
    ``b_pm1``'s dtype (int32 for integers, as the reference's default)."""
    dt = torch.int32 if not b_pm1.is_floating_point() else b_pm1.dtype
    return torch.where(a_bits != 0, b_pm1, torch.zeros_like(b_pm1)).sum(
        dim=-1, dtype=dt)


TRINARY_MODES = ("s1_select", "s2_and_andnot", "s3_two_popc")


def trinary_dot(a: torch.Tensor, b: torch.Tensor,
                mode: str = "s3_two_popc") -> torch.Tensor:
    """The packed trinary dot by ``mode``; ``s1_select`` takes unpacked
    operands (:func:`trinary_dot_s1`) and is refused here."""
    if mode == "s2_and_andnot":
        return trinary_dot_s2(a, b)
    if mode == "s3_two_popc":
        return trinary_dot_s3(a, b)
    raise ValueError(f"packed trinary mode must be s2/s3, got {mode!r}")


def bit_transpose_32(words: torch.Tensor) -> torch.Tensor:
    """Transpose a 32x32 bit block.

    ``words``: (..., 32) where row k's bit f is element (k, f). Returns
    (..., 32) where row f's bit k is element (k, f). The CUDA kernel does
    this with 32 ``__ballot_sync`` calls across a warp.
    """
    u = as_u32(words)
    sh = _shifts(u.device)
    bits = (u[..., :, None] >> sh) & 1                  # [..., k, f]
    return to_i32((bits << sh[:, None]).sum(dim=-2))    # word f, bit k


def bmm_xnor_words(a_packed: torch.Tensor, b_packed: torch.Tensor,
                   n_bits) -> torch.Tensor:
    """(M, W) x (N, W) packed ±1 matmul -> (M, N) int32 via XNOR-popc."""
    return xnor_dot(a_packed[:, None, :], b_packed[None, :, :], n_bits)


def spmm_trinary_words(adj_packed: torch.Tensor, act_packed: torch.Tensor,
                       mode: str = "s3_two_popc") -> torch.Tensor:
    """(M, W) 0/1 adjacency x (F, W) ±1 activations -> (M, F) int32.

    ``act_packed`` holds the activations TRANSPOSED and packed along the
    node axis (the paper's Step 4 layout)."""
    return trinary_dot(adj_packed[:, None, :], act_packed[None, :, :], mode)
