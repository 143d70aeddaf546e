"""BitGNN binarized linear layers for the LM models (reference:
``repro/quant/binary_linear.py``).

Weights are factorized Bi-GCN style, ``W ~= sign(W) * scale_out`` with a
positive per-output-channel L1 scale, and stored bit-packed along the
contraction axis: 32x less device memory than bf16. ``layers.linear``
consumes the packed dict; its unpack and product are torch ops, as the
reference's are XLA ops (no packed-weight kernel runs in either package).

The packed words are the reference's uint32 words held as int32 bit-views
(torch has no shifts on uint32): bit ``k`` of word ``j`` of row ``o`` is
the sign bit (``w >= 0``) of input ``32 j + k`` of output ``o``.
"""
from __future__ import annotations

from typing import Any

import torch

from ..models.layers import unpack_weight

# weight-matrix keys eligible for binarization (projections only; SSM decay /
# norm / router params stay fp)
_QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "wi", "wz", "wx", "wr", "wg",
    "shared_wi", "shared_wo", "cm_wk", "cm_wv", "cm_wr",
})


def quantize_linear(w: torch.Tensor) -> dict:
    """(in, out) fp weight -> {"packed": (out, ceil(in/512)*16) int32,
    "scale": (out,)}."""
    n_in = w.shape[0]
    scale = torch.mean(torch.abs(w.float()), dim=0).to(w.dtype)
    wt = w.t()                                       # (out, in)
    # pad the packed-word count to a multiple of 16, as the reference does
    # for its mesh axis (pad bits are 0 and sliced off on unpack)
    pad = (-n_in) % (32 * 16)
    bits = (wt >= 0).to(torch.int64)
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    grouped = bits.reshape(wt.shape[0], -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=w.device)
    words = torch.sum(grouped << shifts, dim=-1)     # [0, 2^32) in int64
    # wrap to the int32 bit-view of the same 32 bits (two's complement)
    words = words - ((words >> 31) << 32)
    return {"packed": words.to(torch.int32), "scale": scale}


def dequantize_linear(q: dict, n_in: int, dtype=torch.bfloat16
                      ) -> torch.Tensor:
    """The (n_in, out) weight ``(2 * bit - 1) * scale`` in ``dtype``."""
    w = {"packed": q["packed"], "scale": q["scale"].to(dtype)}
    return unpack_weight(w, n_in, dtype).t()


def _should_quantize(key, leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim == 2
            and key in _QUANT_KEYS)


def quantize_params(params: Any) -> Any:
    """Replace every eligible 2-D projection with its bit-packed form (the
    leaf's own dict key decides, as the reference's path test does)."""
    return _quantize_tree(params, None)


def _quantize_tree(node, key):
    if isinstance(node, dict):
        return {k: _quantize_tree(v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_quantize_tree(v, None) for v in node)
    return quantize_linear(node) if _should_quantize(key, node) else node


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def quantized_param_bytes(params: Any) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(params))
