"""AdamW, a cosine schedule, gradient clipping and SGD with momentum
(reference: ``repro/optim/optimizer.py``).

Functional, as the reference is: the state mirrors a tree of parameter
tensors (a NamedTuple, tuple, list or dict of tensors) and ``update``
returns new parameters and a new state. The formula is the reference's and
not ``torch.optim.AdamW``'s: the weight decay sits inside the ``lr *``
term, and the bias corrections ``1 - b ** step`` are taken in float32 from
a step counter that stays on the parameters' device, so a training loop
reads nothing back from the card.

The leaf dtypes follow JAX's promotion, which the reference's training
relies on: a 0-d float32 array there is not weakly typed, so the clip
scale and the bias corrections (and a scheduled ``lr``) lift bf16 leaves
to float32, while a Python float takes the leaf's dtype. torch treats a
0-d tensor like a scalar and would keep bf16, so :func:`_promote` lifts
the leaf where a 0-d tensor enters and :func:`_weak` casts a Python float
to a low-precision leaf's dtype. bf16 parameters therefore come back
float32 after one step, and ``mu`` / ``nu`` float32 when clipping is on,
as in the reference; float32 trees are unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensors of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        if hasattr(tree, "_fields"):            # NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _promote(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype JAX gives ``x`` op a strongly typed 0-d ``s``."""
    return x.to(torch.promote_types(x.dtype, s.dtype))


def _weak(c: float, x: torch.Tensor):
    """A Python float as JAX's weak type meets ``x``: in ``x``'s dtype.
    torch would compute a bf16 op against the float itself."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.tensor(c, dtype=x.dtype, device=x.device)
    return c


def tree_leaves(tree: Tree) -> list:
    """The tensors of ``tree`` in its order (dict values in key order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    return [leaf for sub in tree for leaf in tree_leaves(sub)]


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32, on the parameters' device
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params: Tree) -> AdamWState:
        device = tree_leaves(params)[0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    def _lr(self, step: torch.Tensor):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState,
               params: Tree) -> tuple:
        step = state.step + 1
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: _promote(g, scale) * scale, grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: _weak(b1, m) * m + _weak(1 - b1, g) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: _weak(b2, v) * v
                      + _weak(1 - b2, g) * g * g, state.nu, grads)
        t = step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        lr = self._lr(step)

        def upd(p, m, v):
            mhat = _promote(m, bc1) / bc1
            vhat = _promote(v, bc2) / bc2
            return p - lr * (mhat / (torch.sqrt(vhat) + self.eps)
                             + _weak(self.weight_decay, p) * p)

        return tree_map(upd, params, mu, nu), AdamWState(step=step, mu=mu,
                                                         nu=nu)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor in ``tree``, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def cosine_schedule(peak_lr: float, warmup_steps: int,
                    total_steps: int, floor: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total_steps``; ``step`` is a tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clip((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


@torch.no_grad()
def sgd_momentum(params: Tree, grads: Tree, velocity: Tree, lr: float,
                 momentum: float = 0.9) -> tuple:
    velocity = tree_map(lambda v, g: momentum * v + g, velocity, grads)
    params = tree_map(lambda p, v: p - lr * v, params, velocity)
    return params, velocity
