"""1-bit gradient compression with error feedback (reference:
``repro/quant/grad_compress.py``).

``compress_tree`` is the step's numerics: each gradient leaf plus its
error-feedback residual is replaced by its sign times the per-tensor mean
of |.|, and what that drops is carried into the next step's residual. The
residual is float32 whatever the gradient's dtype; ``g_hat`` comes back in
the gradient's dtype. ``allreduce_1bit``, the reference's wire-level
collective of packed sign words between data-parallel replicas, needs a
device mesh and raises.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

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
    wire. It needs a device mesh of data-parallel replicas."""
    raise NotImplementedError(
        "allreduce_1bit needs a device mesh; the mesh paths come with "
        "torch.distributed (ROADMAP Q1-3)")
