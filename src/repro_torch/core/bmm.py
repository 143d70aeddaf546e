"""BMM — dense binary matmul variants (reference: ``repro/core/bmm.py``).

Seven variants ``BMM.<X><W><O>`` (X = activation, W = weight, O = output
precision; F = full, B = binary): FBF, FBB, BBF, BBB, BFF, BFB, FFB.

Weights of the ``?B?`` variants are a ``BinTensor`` of ``W.T``, packed along
the contraction axis K with a per-output-column positive scale. The SCL
before a binary output is elided (§3.1.2).

Kernels: every ``BB?`` product goes through ``kernels.ops.bmm_xnor`` (the
XNOR-popc kernel) and every binary output through ``kernels.ops
.binarize_pack`` (the BIN kernel); both compute in integers, so results are
bit-exact against the reference. The fp products ``x @ dequantize(wt).T``
stay ``torch.matmul`` as the reference leaves them to XLA; they assume
PyTorch's default float32 matmul precision ("highest", TF32 off).
"""
from __future__ import annotations

from typing import Union

import torch

from ..kernels import counting, ops
from . import bitops
from .binarize import BinTensor, bin_op, binarize_matrix, dequantize

BMM_VARIANTS = ("FBF", "FBB", "BBF", "BBB", "BFF", "BFB", "FFB")
_SPAN = {v: "bmm." + v for v in BMM_VARIANTS}   # ``counting.span`` names


def quantize_weight(w: torch.Tensor) -> BinTensor:
    """Offline weight binarization: BinTensor of W.T with col scales."""
    return binarize_matrix(w.T.contiguous(), scale="row")


def quantize_act(x: torch.Tensor) -> BinTensor:
    """Activation binarization with per-row L1 scale (Bi-GCN)."""
    return binarize_matrix(x, scale="row")


def _xnor_matmul(xa: BinTensor, wt: BinTensor) -> torch.Tensor:
    """sign(X) @ sign(W) via XNOR-popc on packed words -> (M, N) int32."""
    if xa.n != wt.n:
        raise ValueError(f"contraction mismatch: {xa.n} vs {wt.n}")
    return ops.bmm_xnor(xa.packed, wt.packed, xa.n)


def bmm(x: Union[torch.Tensor, BinTensor], wt: Union[torch.Tensor, BinTensor],
        variant: str, out_scale: bool = True):
    """Dispatch a BMM variant.

    ``x``: (M, K) fp tensor for ``F??`` or BinTensor (packed along K) for
    ``B??``. ``wt``: BinTensor of W.T for ``?B?`` or (K, N) fp for ``?F?``.
    Returns (M, N) fp for ``??F`` or BinTensor for ``??B``. ``out_scale``:
    compute the output BinTensor's row scale (skipped when the consumer
    elides it).
    """
    if variant not in BMM_VARIANTS:
        raise ValueError(f"unknown BMM variant {variant!r}")
    with counting.span(_SPAN[variant]):
        xa, wp, op = variant

        if xa == "F":
            if isinstance(x, BinTensor):
                raise TypeError(f"BMM.{variant} takes an fp activation")
            w_eff = dequantize(wt).T if wp == "B" else wt
            full = x @ w_eff
        else:
            if not isinstance(x, BinTensor):
                raise TypeError(f"BMM.{variant} takes a BinTensor activation")
            if wp == "B":
                full = _xnor_matmul(x, wt).to(torch.float32)
                if op == "F":
                    full = full * x.scale * wt.scale.reshape(1, -1)
                # op == "B": both positive scales are elided under the BIN
            else:  # BF?: ±1 activation times fp weight
                full = bitops.unpack_pm1(x.packed, x.n) @ wt
                if op == "F":
                    full = full * x.scale

        if op == "F":
            return full
        scale = full.abs().mean(dim=-1, keepdim=True) if out_scale \
            else full.new_ones((full.shape[0], 1))
        return BinTensor(packed=bin_op(full, axis=-1), scale=scale,
                         n=full.shape[-1])


def bmm_reference_fp(x: torch.Tensor, w: torch.Tensor,
                     variant: str) -> torch.Tensor:
    """Full-precision oracle of what each variant APPROXIMATES: the
    operands binarized by the variant's letters with sign and L1 scaling
    (``x`` by rows, ``w`` by columns), then exact fp math. The output
    letter is the caller's."""
    xa, wp, _ = variant
    if xa == "B":
        xs = torch.mean(torch.abs(x), dim=-1, keepdim=True)
        x = torch.where(x >= 0, 1.0, -1.0) * xs
    if wp == "B":
        ws = torch.mean(torch.abs(w), dim=0, keepdim=True)
        w = torch.where(w >= 0, 1.0, -1.0) * ws
    return x @ w
