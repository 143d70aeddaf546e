"""1-bit gradient compression with error feedback (reference:
``repro/quant/grad_compress.py``).

``compress_tree`` is the step's numerics: each gradient leaf plus its
error-feedback residual is replaced by its sign times the per-tensor mean
of |.|, and what that drops is carried into the next step's residual. The
residual is float32 whatever the gradient's dtype; ``g_hat`` comes back in
the gradient's dtype. ``allreduce_1bit`` is the wire-level collective
between data-parallel replicas: packed sign words (32x fewer bytes than
fp32) and one scale a rank, all-gathered over a mesh axis's group
(:mod:`repro_torch.distributed.collectives`).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..core import bitops
from ..distributed import collectives
from ..optim.optimizer import tree_leaves, tree_map


def init_error_state(params: Any) -> Any:
    """A float32 zero residual for every leaf of ``params``."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """sign+scale with error feedback: returns (g_hat, new_err)."""
    gf = g.to(torch.float32) + err
    scale = torch.mean(torch.abs(gf))
    g_hat = torch.where(gf >= 0, scale, -scale)
    return g_hat.to(g.dtype), gf - g_hat


def compress_tree(grads: Any, err_state: Any) -> Tuple[Any, Any]:
    """:func:`compress_leaf` over the leaves of ``grads`` and ``err_state``
    paired in flatten order: (g_hat tree, residual tree), both in the
    structure of ``grads``."""
    out = {id(g): compress_leaf(g, e)
           for g, e in zip(tree_leaves(grads), tree_leaves(err_state))}
    return (tree_map(lambda g: out[id(g)][0], grads),
            tree_map(lambda g: out[id(g)][1], grads))


def allreduce_1bit(local_grad: torch.Tensor, mesh, axis: str = "data"):
    """The cross-replica mean of sign-compressed gradients, packed on the
    wire. Every rank of ``mesh``'s ``axis`` group packs the sign bits of
    its flat fp32 ``local_grad`` (n,) and all-gathers the words and its
    scale, the mean of |g|; each then unpacks the ±1 signs and takes the
    mean of ``sign * scale`` over the ranks, in rank order. Returns (n,)
    fp32, equal on every rank."""
    if mesh is None:
        raise ValueError("allreduce_1bit needs a mesh of data-parallel "
                         "replicas (launch.mesh.make_host_mesh)")
    group = mesh.get_group(axis)
    n = local_grad.shape[0]
    scale = torch.mean(torch.abs(local_grad)).reshape(1)
    packed = bitops.pack_bits((local_grad >= 0).reshape(1, -1)).reshape(-1)
    words = torch.stack(collectives.all_gather(packed, group))    # (R, W)
    scales = torch.cat(collectives.all_gather(scale, group))      # (R,)
    signs = bitops.unpack_pm1(words, n, axis=-1)                  # (R, n)
    return torch.mean(signs * scales[:, None], dim=0)
