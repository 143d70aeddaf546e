"""BSpMM — binary sparse (FRDC adjacency) x dense matmul (reference:
``repro/core/bspmm.py``).

Four variants ``BSpMM.<X>B<O>`` (out = Adj_eff @ X):
  * FBF / FBB : fp activations; exact for factorized adjacencies (column
                scales fold into X, row scales apply after, elided when O==B).
  * BBF / BBB : ±1 activations through the trinary popc dot product; the
                paper's binary aggregation approximation.

The aggregation stages run in ``kernels.ops``: ``bspmm_fp`` (the fp FRDC
kernel) and ``bspmm_bits`` in counts mode (Algorithm 1); each binary output
goes through the BIN kernel. :func:`override_backends` swaps both stages for
other implementations while it is active (``kernels.ops.serve_kernels``
routes them to the 2D block-grid kernels). The override lives in a context
variable, so a session serving on one thread never reroutes another's.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Union

import torch

from ..kernels import counting, ops
from .binarize import BinTensor, bin_op
from .frdc import FRDCMatrix

BSPMM_VARIANTS = ("FBF", "FBB", "BBF", "BBB")
_SPAN = {v: "bspmm." + v for v in BSPMM_VARIANTS}   # ``counting.span`` names
TRINARY_DEFAULT = "s3_two_popc"

# Pluggable aggregation stages (fp, bits), consulted at call time: fp(adj, x)
# -> (n_rows, F) with the scales applied; bits(adj, x_packed, trinary_mode)
# -> (n_rows, Wf*32) int32 trinary counts. None selects the kernels.ops
# default.
_BACKENDS: contextvars.ContextVar = contextvars.ContextVar(
    "bspmm_backends", default=(None, None))


@contextlib.contextmanager
def override_backends(fp: Optional[Callable] = None,
                      bits: Optional[Callable] = None):
    """Route the BSpMM aggregation stages through other implementations
    while the context is active (reference ``core/bspmm.py:45-57``)."""
    token = _BACKENDS.set((fp, bits))
    try:
        yield
    finally:
        _BACKENDS.reset(token)


def _counts(adj: FRDCMatrix, x_packed: torch.Tensor,
            trinary_mode: str) -> torch.Tensor:
    return ops.bspmm_bits(adj, x_packed, x_packed.shape[1] * 32,
                          binarize=False, trinary_mode=trinary_mode)


def bspmm(adj: FRDCMatrix, x: Union[torch.Tensor, BinTensor], variant: str,
          trinary_mode: str = TRINARY_DEFAULT, out_scale: bool = True):
    """Dispatch a BSpMM variant. ``x`` fp (N,F) for F??, BinTensor for B??."""
    if variant not in BSPMM_VARIANTS:
        raise ValueError(f"unknown BSpMM variant {variant!r}")
    with counting.span(_SPAN[variant]):
        xa, _, op = variant
        fp_backend, bits_backend = _BACKENDS.get()

        if xa == "F":
            full = (fp_backend or ops.bspmm_fp)(adj, x)
            n_feat = x.shape[-1]
        else:
            if not isinstance(x, BinTensor):
                raise TypeError(
                    f"BSpMM.{variant} takes a BinTensor activation")
            n_feat = x.n
            counts = (bits_backend or _counts)(adj, x.packed, trinary_mode)
            counts = counts[:, :n_feat].to(torch.float32)
            if op == "F":
                # the paper's approximation: positive scales re-applied as
                # a global mean factor after the bit aggregation (§3.1.2);
                # copied from the reference as it is, not padding-invariant
                full = counts * x.scale.mean()
                if adj.row_scale is not None:
                    full = full * adj.row_scale[:, None]
                if adj.col_scale is not None:
                    full = full * adj.col_scale.mean()
            else:
                full = counts   # every scale is positive -> elided by BIN

        if op == "F":
            return full
        scale = full.abs().mean(dim=-1, keepdim=True) if out_scale \
            else full.new_ones((full.shape[0], 1))
        return BinTensor(packed=bin_op(full[:, :n_feat].contiguous(), axis=-1),
                         scale=scale, n=n_feat)


def spmm_reference_fp(adj_dense: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: ``Adj_eff @ X`` with a decoded dense adjacency."""
    return adj_dense @ x
