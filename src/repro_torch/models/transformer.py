"""Unified model assembly for all 10 assigned architectures (reference:
``repro/models/transformer.py``).

One parameter tree + one forward covers: dense decoders (GQA+RoPE+SwiGLU),
MoE decoders (qwen2-moe, llama4-scout), the Zamba2 hybrid (Mamba2 backbone +
one weight-tied shared attention block), RWKV6, the enc-dec audio backbone
(seamless-m4t; frontend stub supplies frames), and the LLaVA VLM (frontend
stub supplies patch embeddings, projector in-model).

The blocks run as a Python loop over layers. ``unroll=False`` (the
reference's ``lax.scan`` over stacked layers) is accepted and computes the
same thing. ``block_remat`` recomputes each decoder block in the backward
pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
around a block). Where the reference constrains an activation's sharding
(``with_sharding_constraint``), the port redistributes a DTensor
activation to the given placements; a plain tensor passes unchanged.

Decode positions are host ints, and the attention caches are updated in
place (see ``layers``). Parameter and cache trees move between the packages
through numpy: :func:`params_from_numpy` / :func:`params_to_numpy` and
:func:`cache_from_numpy` / :func:`cache_to_numpy`.
"""
from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from . import layers, moe as moe_mod, ssm
from .layers import (attention_block, embed, init_attention, init_embedding,
                     init_mlp, lm_head, linear, matmul, mlp_block, rmsnorm,
                     _init)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_norm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def _init_block(gen, kind: str, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    if kind == "dense":
        return {"ln1": _init_norm(d, dtype, device),
                "attn": init_attention(gen, cfg, dtype, device),
                "ln2": _init_norm(d, dtype, device),
                "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device)}
    if kind == "moe":
        return {"ln1": _init_norm(d, dtype, device),
                "attn": init_attention(gen, cfg, dtype, device),
                "ln2": _init_norm(d, dtype, device),
                "moe": moe_mod.init_moe(gen, cfg, dtype, device)}
    if kind in ("mamba", "mamba_attn"):
        return {"ln1": _init_norm(d, dtype, device),
                "mamba": ssm.init_mamba(gen, cfg, dtype, device)}
    if kind == "rwkv":
        return {"ln1": _init_norm(d, dtype, device),
                "tm": ssm.init_rwkv(gen, cfg, dtype, device),
                "ln2": _init_norm(d, dtype, device)}
    if kind == "encdec":   # decoder block with cross attention
        return {"ln1": _init_norm(d, dtype, device),
                "attn": init_attention(gen, cfg, dtype, device),
                "ln_x": _init_norm(d, dtype, device),
                "cross": init_attention(gen, cfg, dtype, device),
                "ln2": _init_norm(d, dtype, device),
                "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device)}
    raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Seeded random parameters in the reference's tree layout; the draws
    come from ``generator`` (a ``torch.Generator`` on ``device``), not from
    the reference's keys: carry the reference's arrays across with
    :func:`params_from_numpy` to compare the two packages."""
    gen, dtype = generator, cfg.compute_dtype
    d = cfg.d_model
    p = {"embed": init_embedding(gen, cfg, dtype, device),
         "final_ln": _init_norm(d, dtype, device)}

    if cfg.is_encdec:
        p["frontend_proj"] = _init(gen, (cfg.frontend_dim, d),
                                   cfg.frontend_dim, dtype, device)
        p["enc_blocks"] = [_init_block(gen, "dense", cfg, dtype, device)
                           for _ in range(cfg.enc_layers)]
        p["enc_ln"] = _init_norm(d, dtype, device)
        p["blocks"] = [_init_block(gen, "encdec", cfg, dtype, device)
                       for _ in range(cfg.dec_layers)]
        return p

    if cfg.family == "vlm":
        p["projector"] = {
            "w1": _init(gen, (cfg.frontend_dim, d), cfg.frontend_dim, dtype,
                        device),
            "w2": _init(gen, (d, d), d, dtype, device)}

    p["blocks"] = [_init_block(gen, kind, cfg, dtype, device)
                   for kind in cfg.block_pattern()]
    if cfg.family == "hybrid" and cfg.attn_every:
        # ONE shared (weight-tied) attention+mlp block (Zamba2)
        p["shared_attn"] = {
            "ln1": _init_norm(d, dtype, device),
            "attn": init_attention(gen, cfg, dtype, device),
            "ln2": _init_norm(d, dtype, device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device)}
    return p


# ---------------------------------------------------------------------------
# Weights and caches carried across packages
# ---------------------------------------------------------------------------

def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: move the 16 bits
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    elif a.dtype == np.uint32:          # packed words: the int32 bit-view
        t = torch.from_numpy(np.array(a).view(np.int32))
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree, device="cuda"):
    """A nested dict/list/tuple tree of arrays (numpy, or anything
    ``np.asarray`` takes, such as the reference's arrays) -> the same tree
    of tensors on ``device``. bf16 arrays keep their bits; uint32 words
    (packed ``{"packed", "scale"}`` leaves) become their int32 bit-views."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def _leaf_to_numpy(t: torch.Tensor, key) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # exact in float32
        return t.float().numpy()
    a = t.numpy()
    if key == "packed":
        return a.view(np.uint32)
    return a


def params_to_numpy(tree):
    """The reverse of :func:`params_from_numpy` on the host: packed words
    as the reference's uint32, bf16 leaves as float32 arrays of the same
    values (numpy has no bfloat16 of its own)."""
    return _tree_to_numpy(tree, None)


def _tree_to_numpy(node, key):
    if isinstance(node, dict):
        return {k: _tree_to_numpy(v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_to_numpy(v, None) for v in node)
    return _leaf_to_numpy(node, key)


def cache_from_numpy(tree, device="cuda"):
    """A decode cache (:func:`init_cache`'s tree) from numpy arrays."""
    return params_from_numpy(tree, device)


def cache_to_numpy(cache):
    """A decode cache's leaves on the host, for comparison."""
    return params_to_numpy(cache)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _apply_block(bp, kind, x, positions, cfg, unroll, q_chunk,
                 cache=None, cache_pos=None, shared=None, enc_memory_kv=None):
    """Returns (x, new_cache)."""
    if kind in ("dense", "moe"):
        h, new_c = attention_block(bp["attn"], rmsnorm(x, bp["ln1"]["scale"]),
                                   positions, cfg, q_chunk=q_chunk,
                                   cache=cache, cache_pos=cache_pos)
        x = x + h
        inner = rmsnorm(x, bp["ln2"]["scale"])
        if kind == "moe":
            x = x + moe_mod.moe_block(bp["moe"], inner, cfg)
        else:
            x = x + mlp_block(bp["mlp"], inner, cfg.act)
        return x, new_c
    if kind in ("mamba", "mamba_attn"):
        h, new_c = ssm.mamba_block(bp["mamba"], rmsnorm(x, bp["ln1"]["scale"]),
                                   cfg, unroll, cache=cache)
        x = x + h
        if kind == "mamba_attn":
            sc = None if cache is None else cache.get("shared")
            h, new_sc = attention_block(
                shared["attn"], rmsnorm(x, shared["ln1"]["scale"]), positions,
                cfg, q_chunk=q_chunk, cache=sc, cache_pos=cache_pos)
            x = x + h
            x = x + mlp_block(shared["mlp"],
                              rmsnorm(x, shared["ln2"]["scale"]), cfg.act)
            if new_c is not None or new_sc is not None:
                new_c = {**(new_c or {}), "shared": new_sc}
        return x, new_c
    if kind == "rwkv":
        h, tm_c = ssm.rwkv_time_mix(bp["tm"], rmsnorm(x, bp["ln1"]["scale"]),
                                    cfg, unroll, cache=cache)
        x = x + h
        inner = rmsnorm(x, bp["ln2"]["scale"])
        h, cm_last = ssm.rwkv_channel_mix(bp["tm"], inner, cache=cache)
        new_c = None if cache is None else {**tm_c, "cm_last": cm_last}
        return x + h, new_c
    if kind == "encdec":
        h, new_c = attention_block(bp["attn"], rmsnorm(x, bp["ln1"]["scale"]),
                                   positions, cfg, q_chunk=q_chunk,
                                   cache=cache, cache_pos=cache_pos)
        x = x + h
        h, _ = attention_block(bp["cross"], rmsnorm(x, bp["ln_x"]["scale"]),
                               positions, cfg, q_chunk=q_chunk,
                               kv_override=enc_memory_kv)
        x = x + h
        x = x + mlp_block(bp["mlp"], rmsnorm(x, bp["ln2"]["scale"]), cfg.act)
        return x, new_c
    raise ValueError(kind)


def _constrain(h: torch.Tensor, placements) -> torch.Tensor:
    """``h`` redistributed to ``placements`` when it is a DTensor (the
    reference's ``with_sharding_constraint``); else ``h`` itself."""
    if placements is None:
        return h
    from torch.distributed.tensor import DTensor
    if not isinstance(h, DTensor):
        return h
    return h.redistribute(h.device_mesh, placements)


def _positions(b: int, t: int, cfg, device) -> layers.Rotary:
    """RoPE at positions 0..t-1 of b rows, shared by every layer."""
    return layers.Rotary(torch.arange(t, device=device).expand(b, t),
                         cfg.rope_theta)


def _encode(params, cfg, frames, q_chunk):
    """Audio/speech encoder: frontend stub frames -> memory (B, Tf, d)."""
    x = matmul(frames.to(cfg.compute_dtype), params["frontend_proj"])
    positions = _positions(frames.shape[0], frames.shape[1], cfg,
                           frames.device)
    for bp in params["enc_blocks"]:
        h, _ = attention_block(bp["attn"], rmsnorm(x, bp["ln1"]["scale"]),
                               positions, cfg, causal=False, q_chunk=q_chunk)
        x = x + h
        x = x + mlp_block(bp["mlp"], rmsnorm(x, bp["ln2"]["scale"]), cfg.act)
    return rmsnorm(x, params["enc_ln"]["scale"])


def _cross_kv(params, cfg, memory):
    """Precompute cross-attention K/V per decoder layer from enc memory."""
    b, tf, d = memory.shape
    hd, kvc = cfg.head_dim, layers.kv_compute_heads(cfg)
    out = []
    for bp in params["blocks"]:
        k = linear(bp["cross"]["wk"], memory).reshape(b, tf, kvc, hd)
        v = linear(bp["cross"]["wv"], memory).reshape(b, tf, kvc, hd)
        out.append((k, v))
    return out


def _pattern(cfg: ModelConfig):
    return (("encdec",) * cfg.dec_layers if cfg.is_encdec
            else cfg.block_pattern())


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            image_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            unroll: bool = True, q_chunk: int = 0,
            block_remat: bool = False, boundary_sharding=None,
            logits_sharding=None) -> torch.Tensor:
    """tokens (B, T_text) -> logits (B, T_total, vocab_padded).

    ``block_remat``: each decoder block runs under
    ``torch.utils.checkpoint`` (non-reentrant), so the backward pass keeps
    only the block boundaries and recomputes the rest, as the reference's
    ``jax.checkpoint`` around a block does. The encoder's blocks are not
    wrapped, as in the reference.

    ``boundary_sharding``: placements the residual stream takes between
    blocks, e.g. (dp, "model", None) as ``Shard`` placements for
    Megatron-style sequence-parallel boundaries; ``logits_sharding``:
    placements of the (B, T, V) logits. Each applies to DTensor
    activations (a dry run on a mesh) and leaves plain tensors as they
    are."""
    x = embed(params["embed"], tokens)
    if cfg.family == "vlm":
        if image_embeds is None:
            raise ValueError("a vlm forward needs image_embeds")
        img = image_embeds.to(cfg.compute_dtype)
        img = matmul(torch.tanh(matmul(img, params["projector"]["w1"])),
                     params["projector"]["w2"])
        x = torch.cat([img, x], dim=1)
    b, t, _ = x.shape
    positions = _positions(b, t, cfg, x.device)

    enc_kv = None
    if cfg.is_encdec:
        if frames is None:
            raise ValueError("an enc-dec forward needs frames")
        memory = _encode(params, cfg, frames, q_chunk)
        enc_kv = _cross_kv(params, cfg, memory)

    pattern = _pattern(cfg)
    shared = params.get("shared_attn")

    def blockfn(bp, h, kind, ekv):
        return _apply_block(bp, kind, h, positions, cfg, unroll, q_chunk,
                            shared=shared, enc_memory_kv=ekv)[0]

    for i, bp in enumerate(params["blocks"]):
        ekv = None if enc_kv is None else enc_kv[i]
        if block_remat:
            x = _remat(blockfn, bp, x, pattern[i], ekv)
        else:
            x = blockfn(bp, x, pattern[i], ekv)
        x = _constrain(x, boundary_sharding)
    x = rmsnorm(x, params["final_ln"]["scale"])
    return _constrain(lm_head(params["embed"], x, cfg.vocab),
                      logits_sharding)


def _remat(fn, *args):
    """``torch.utils.checkpoint`` without reentrance. When ``fn`` raises,
    torch before 2.13 leaves the checkpoint's saved-tensor hooks installed
    until its suspended generator is collected, and every backward in the
    process meanwhile saves into the failed block and recomputes it (a
    failed dry-run cell, then any training). Close the generators the
    failed call left suspended, innermost first, as later torch does."""
    try:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    except BaseException as e:
        gens = []
        tb = e.__traceback__
        while tb is not None:
            frame = tb.tb_frame
            gen = frame.f_locals.get("gen")
            if frame.f_code.co_filename == torch.utils.checkpoint.__file__ \
                    and inspect.isgenerator(gen) and gen.gi_frame is not None:
                gens.append(gen)
            tb = tb.tb_next
        for gen in reversed(gens):
            gen.close()
        raise


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0, device="cuda") -> dict:
    """Allocate decode caches (KV buffers / SSM states)."""
    dtype = cfg.compute_dtype
    hd, kvc = cfg.head_dim, layers.kv_compute_heads(cfg)
    h_ssm = cfg.ssm_heads_padded or (
        cfg.d_model // cfg.ssm_head_dim if cfg.ssm_head_dim else 0)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_cache():
        if cfg.kv_cache_quant == "int8":
            return {"k": zeros((batch, max_len, kvc, hd), torch.int8),
                    "v": zeros((batch, max_len, kvc, hd), torch.int8),
                    "k_scale": zeros((batch, max_len, kvc, 1), dtype),
                    "v_scale": zeros((batch, max_len, kvc, 1), dtype)}
        return {"k": zeros((batch, max_len, kvc, hd), dtype),
                "v": zeros((batch, max_len, kvc, hd), dtype)}

    caches = []
    for kind in _pattern(cfg):
        if kind in ("dense", "moe", "encdec"):
            caches.append(attn_cache())
        elif kind in ("mamba", "mamba_attn"):
            h = cfg.ssm_heads_padded or cfg.ssm_heads
            c = {"S": zeros((batch, h, cfg.ssm_head_dim, cfg.ssm_state),
                            torch.float32),
                 "conv": zeros((batch, 3, h * cfg.ssm_head_dim), dtype)}
            if kind == "mamba_attn":
                c["shared"] = attn_cache()
            caches.append(c)
        elif kind == "rwkv":
            caches.append({"S": zeros((batch, h_ssm, cfg.ssm_head_dim,
                                       cfg.ssm_head_dim), torch.float32),
                           "last": zeros((batch, cfg.d_model), dtype),
                           "cm_last": zeros((batch, cfg.d_model), dtype)})
    cache = {"layers": caches}
    if cfg.is_encdec and enc_len:
        cache["enc_memory"] = zeros((batch, enc_len, cfg.d_model), dtype)
    return cache


def decode_step(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                pos: int):
    """One-token decode: tokens (B, 1), ``pos`` a host int -> (logits,
    new_cache). The attention buffers of ``cache`` are written in place."""
    pos = int(pos)
    x = embed(params["embed"], tokens)
    b = x.shape[0]
    positions = layers.Rotary(torch.full((b, 1), pos, dtype=torch.int32,
                                         device=x.device), cfg.rope_theta)
    pattern = _pattern(cfg)
    enc_kv = None
    if cfg.is_encdec:
        enc_kv = _cross_kv(params, cfg, cache["enc_memory"])
    shared = params.get("shared_attn")
    new_layers = []
    for i, bp in enumerate(params["blocks"]):
        x, nc = _apply_block(
            bp, pattern[i], x, positions, cfg, unroll=True, q_chunk=0,
            cache=cache["layers"][i], cache_pos=pos, shared=shared,
            enc_memory_kv=None if enc_kv is None else enc_kv[i])
        new_layers.append(nc)
    x = rmsnorm(x, params["final_ln"]["scale"])
    logits = lm_head(params["embed"], x, cfg.vocab)
    new_cache = dict(cache)
    new_cache["layers"] = new_layers
    return logits, new_cache


def decode_chunk(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                 pos0: int):
    """``T`` single-token decode steps in order: tokens (B, T), ``pos0`` the
    position of tokens[:, 0] -> (logits (B, T, V), new_cache).

    Bit-exact with a Python loop of :func:`decode_step` by construction:
    each step IS ``decode_step`` (the SSM blocks' exact recurrent branch,
    not the chunked prefill path). The reference scans the same body in
    one program."""
    outs = []
    for i in range(tokens.shape[1]):
        logits, cache = decode_step(params, cfg, cache, tokens[:, i:i + 1],
                                    int(pos0) + i)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1), cache
