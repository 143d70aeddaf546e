"""Train-step builder: loss, gradients, AdamW update (reference:
``repro/train/train_step.py``). Also :func:`input_specs`: the inputs of
every (arch x shape) dry-run cell as meta-device tensors (shapes and
dtypes, no storage), where the reference returns ``ShapeDtypeStruct``s.

The reference differentiates with ``jax.value_and_grad`` under ``jit``;
here the step runs eagerly and :func:`value_and_grad` takes the gradients
with ``torch.autograd`` over copies of the parameter leaves marked
``requires_grad``, returned as a tree in the parameters' structure (a leaf
the loss does not reach gets zeros, as in JAX). Like ``jax.value_and_grad``
it refuses a tree with integer leaves, such as the bit-packed
``{"packed", "scale"}`` projections of ``quant.binary_linear``, with
``TypeError``: there is no quantized training in either package.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, ShapeConfig
from ..models import transformer
from ..models.layers import _on_mesh
from ..optim.optimizer import AdamW, AdamWState, tree_leaves, tree_map
from ..quant import grad_compress as gc


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs of one dry-run cell, on the meta device.

    train/prefill: token batch (+ stub frontend tensors for vlm/audio);
    decode: one-token batch + the KV/state cache at seq_len, and ``pos`` a
    0-d int32 (``decode_step`` itself takes a host int).
    """
    b, t = shape.global_batch, shape.seq_len

    def sds(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    if shape.kind in ("train", "prefill"):
        t_text = t
        batch = {}
        if cfg.family == "vlm":
            t_text = t - cfg.frontend_len
            batch["image_embeds"] = sds((b, cfg.frontend_len,
                                         cfg.frontend_dim), torch.bfloat16)
        if cfg.is_encdec:
            batch["frames"] = sds((b, cfg.frontend_len, cfg.frontend_dim),
                                  torch.bfloat16)
        batch["tokens"] = sds((b, t_text), torch.int32)
        if shape.kind == "train":
            batch["labels"] = sds((b, t_text), torch.int32)
        return batch
    # decode: cache holds seq_len history
    cache = transformer.init_cache(
        cfg, b, t, enc_len=cfg.frontend_len if cfg.is_encdec else 0,
        device="meta")
    return {"tokens": sds((b, 1), torch.int32), "cache": cache,
            "pos": sds((), torch.int32)}


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy, the log-softmax in float32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return torch.mean(nll)


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, *args) -> (loss, grads)``: the loss detached and the
    gradient of every leaf of ``params``, in its structure and dtype."""
    def vg(params, *args):
        for leaf in tree_leaves(params):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                raise TypeError(
                    "grad requires real- or complex-valued inputs, but got "
                    f"{leaf.dtype} (bit-packed parameters cannot be "
                    "trained)")
        with torch.enable_grad():
            leaves = tree_map(lambda x: x.detach().requires_grad_(True),
                              params)
            loss = _replicated(loss_fn(leaves, *args))
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        by_leaf = {id(x): torch.zeros_like(x) if g is None else g
                   for x, g in zip(flat, grads)}
        return loss.detach(), tree_map(lambda x: by_leaf[id(x)], leaves)
    return vg


def _replicated(loss: torch.Tensor) -> torch.Tensor:
    """A DTensor loss that is a partial sum (a mean over sharded rows)
    made replicated: the gradient seed is then 1 on every rank, not a
    partial 1 a rank."""
    if type(loss) is torch.Tensor or not any(
            p.is_partial() for p in getattr(loss, "placements", ())):
        return loss
    from torch.distributed.tensor import Replicate
    return loss.redistribute(loss.device_mesh,
                             [Replicate()] * loss.device_mesh.ndim)


def _as_params(grads, params):
    """Gradients in their parameters' placements (see
    ``distributed.sharding.match_placements``); plain trees as they are."""
    if not _on_mesh(tree_leaves(params)):
        return grads
    from ..distributed.sharding import match_placements
    return match_placements(grads, params)


def make_loss_fn(cfg: ModelConfig, unroll: bool, q_chunk: int,
                 block_remat: bool = False, boundary_sharding=None,
                 logits_sharding=None) -> Callable:
    def loss_fn(params, batch):
        kw = {k: batch[k] for k in ("image_embeds", "frames") if k in batch}
        logits = transformer.forward(params, cfg, batch["tokens"],
                                     unroll=unroll, q_chunk=q_chunk,
                                     block_remat=block_remat,
                                     boundary_sharding=boundary_sharding,
                                     logits_sharding=logits_sharding, **kw)
        labels = batch["labels"]
        # align labels with the (possibly frontend-prefixed) logit sequence:
        # 0 on the left, and the pad counts in the mean, as in the reference
        t_total = logits.shape[1]
        if labels.shape[1] < t_total:
            labels = F.pad(labels, (t_total - labels.shape[1], 0))
        return softmax_xent(logits, labels)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: AdamW, unroll: bool = False,
                    q_chunk: int = 0, compress_grads: bool = False,
                    remat: bool = False, boundary_sharding=None,
                    logits_sharding=None) -> Callable:
    """Returns train_step(params, opt_state, [err_state,] batch) -> ...

    ``compress_grads``: 1-bit sign+scale gradient compression with error
    feedback (``quant.grad_compress``), carrying ``err_state``. ``remat``:
    per-block activation checkpointing. The step returns new trees; the
    caller rebinds them (the reference donates its buffers under jit).
    On DTensor parameters each gradient (and the compressed gradient and
    its error) is moved to its parameter's placements before the update,
    so the state keeps its layout from step to step."""
    grad_fn = value_and_grad(make_loss_fn(
        cfg, unroll, q_chunk, block_remat=remat,
        boundary_sharding=boundary_sharding,
        logits_sharding=logits_sharding))

    if not compress_grads:
        def train_step(params, opt_state: AdamWState, batch):
            loss, grads = grad_fn(params, batch)
            grads = _as_params(grads, params)
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, {"loss": loss}
        return train_step

    def train_step_c(params, opt_state: AdamWState, err_state, batch):
        loss, grads = grad_fn(params, batch)
        grads, err_state = gc.compress_tree(_as_params(grads, params),
                                            err_state)
        grads = _as_params(grads, params)
        err_state = _as_params(err_state, params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, err_state, {"loss": loss}
    return train_step_c


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, tokens, pos) -> (logits, cache)``, one
    decode step at the host-int position ``pos``."""
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return transformer.decode_step(params, cfg, cache, tokens, pos)
    return serve_step


def make_prefill_step(cfg: ModelConfig, q_chunk: int = 2048,
                      boundary_sharding=None,
                      logits_sharding=None) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        kw = {k: batch[k] for k in ("image_embeds", "frames") if k in batch}
        return transformer.forward(params, cfg, batch["tokens"],
                                   unroll=True, q_chunk=q_chunk,
                                   boundary_sharding=boundary_sharding,
                                   logits_sharding=logits_sharding, **kw)
    return prefill_step
