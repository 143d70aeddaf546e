"""Transformer building blocks: norms, RoPE, GQA attention (train / chunked
prefill / KV-cache decode), MLPs, embeddings (reference:
``repro/models/layers.py``).

BitGNN integration: ``linear()`` consumes either a plain fp weight or a
bit-packed ``{"packed","scale"}`` dict produced by
``repro_torch.quant.binary_linear`` (32x smaller weight storage). The
unpack is torch ops and the product a ``torch.matmul``, as the reference's
is an XLA dot outside any Pallas kernel.

Numerics follow the reference's: where JAX promotes a mixed bf16 x fp32
product to fp32, :func:`matmul` / :func:`einsum` cast both operands to the
promoted type (``torch.matmul`` refuses mixed dtypes).

Decode positions are host ints: the KV-cache write position and the
length mask never read a device scalar, so a decode step issues no
device->host sync. The KV caches are written in place (the reference's
``dynamic_update_slice`` returns a new buffer; the port's returned cache
holds the caller's buffers, updated), with the reference's start clamp.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig


# ---------------------------------------------------------------------------
# Mixed-dtype products (JAX promotes; torch.matmul raises)
# ---------------------------------------------------------------------------

def _promoted(*ts):
    dt = ts[0].dtype
    if all(t.dtype == dt for t in ts):
        return ts
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t if t.dtype == dt else t.to(dt) for t in ts]


def _on_mesh(ts) -> bool:
    """Whether an operand is a DTensor (a dry run on a device mesh)."""
    if all(type(t) is torch.Tensor for t in ts):
        return False
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul``."""
    a, b = _promoted(a, b)
    if _on_mesh((a, b)) and b.ndim == 2:
        lead = "abcdefgh"[:a.ndim - 1]
        return einsum(f"{lead}y,yz->{lead}z", a, b)
    return torch.matmul(a, b)


def einsum(spec: str, *ts: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` with JAX's dtype promotion. On DTensors the
    contraction runs on the local shards
    (``distributed.sharding.mesh_einsum``)."""
    ts = _promoted(*ts)
    if _on_mesh(ts):
        from ..distributed.sharding import mesh_einsum
        return mesh_einsum(spec, *ts)
    return torch.einsum(spec, *ts)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def unpack_weight(w: dict, n_in: int, dtype) -> torch.Tensor:
    """The (out, n_in) effective weight of a packed linear:
    ``(2 * bit - 1) * scale``, in ``dtype`` promoted with the scale's dtype
    (the reference's ``pm1 * scale``; +-1 times the scale is exact, so the
    select gives the same values). The words are read byte by byte (bit
    ``8 j + b`` of a little-endian word is bit ``b`` of its byte ``j``),
    each byte to its eight bits by one gather."""
    packed, scale = w["packed"], w["scale"]
    by = packed.contiguous().view(torch.uint8)           # (out, 4 W)
    bits = _bit_table(packed.device)[by.int()].reshape(packed.shape[0], -1)
    dt = dtype if dtype == scale.dtype else torch.promote_types(dtype,
                                                                scale.dtype)
    s = scale.to(dt)[:, None]
    return torch.where(bits[:, :n_in], s, -s)


_BIT_TABLES: dict = {}    # device -> the constant table below


def _bit_table(device) -> torch.Tensor:
    """(256, 8) bool: the bits of each byte value, least significant first.
    Built once a device: building it in every call would add launches to
    each packed product. (A table of +-1 factors in the weight's dtype,
    gathered and then scaled, read 7x the device time on the H100.)"""
    t = _BIT_TABLES.get(device)
    if t is None:
        v = torch.arange(256, dtype=torch.int32, device=device)
        k = torch.arange(8, dtype=torch.int32, device=device)
        t = _BIT_TABLES[device] = ((v[:, None] >> k) & 1).bool()
    return t


def linear(w, x: torch.Tensor) -> torch.Tensor:
    """x @ W with optional BitGNN bit-packed weight.

    Packed form: {"packed": (out, in/32) int32 bit-views of the reference's
    uint32 words, "scale": (out,)}; bits are signs packed along the
    contraction axis (``quantize_linear``). The unpack runs as torch ops
    (sign = 2*bit-1, times the positive per-output scale)."""
    if isinstance(w, dict) and "packed" in w:
        w_eff = unpack_weight(w, x.shape[-1], x.dtype)
        return matmul(x, w_eff.t())
    return matmul(x, w)


def _init(gen: torch.Generator, shape, in_axis_size, dtype, device):
    std = 1.0 / math.sqrt(in_axis_size)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

class Rotary:
    """RoPE at fixed ``positions`` (B, T). Its tables are built on first use
    for each (head dim, dtype) and then shared by every tensor rotated at
    those positions: a forward or a decode step builds them once for all
    its layers. Bit-equal to the reference's ``rope``: the first half's
    ``x1 * cos - x2 * sin`` is ``x1 * cos + x2 * (-sin)`` (negation is
    exact), and the second half adds ``x2 * cos`` and ``x1 * sin`` in the
    other order (IEEE addition commutes)."""

    def __init__(self, positions: torch.Tensor, theta: float):
        self.positions = positions
        self.theta = theta
        self._tables = {}

    def _table(self, hd: int, dtype):
        t = self._tables.get((hd, dtype))
        if t is None:
            half = hd // 2
            freqs = self.theta ** (-torch.arange(
                0, half, dtype=torch.float32,
                device=self.positions.device) / half)
            angles = self.positions[..., None].float() * freqs    # (B,T,half)
            cos = torch.cos(angles)[:, :, None, :].to(dtype)
            sin = torch.sin(angles)[:, :, None, :].to(dtype)
            t = self._tables[(hd, dtype)] = (torch.cat([cos, cos], dim=-1),
                                             torch.cat([-sin, sin], dim=-1))
        return t

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, hd) rotated at the positions."""
        cos, sin = self._table(x.shape[-1], x.dtype)
        half = x.shape[-1] // 2
        turned = torch.cat([x[..., half:], x[..., :half]], dim=-1)
        return x * cos + turned * sin


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int."""
    return Rotary(positions, theta)(x)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, dtype, device="cuda"):
    """GQA projections with the TP padding policy applied (q heads
    ``n_heads_padded``; kv heads ``kv_compute_heads``)."""
    d, hd = cfg.d_model, cfg.head_dim
    hq = cfg.n_heads_padded or cfg.n_heads
    kvc = kv_compute_heads(cfg)
    return {
        "wq": _init(gen, (d, hq * hd), d, dtype, device),
        "wk": _init(gen, (d, kvc * hd), d, dtype, device),
        "wv": _init(gen, (d, kvc * hd), d, dtype, device),
        "wo": _init(gen, (hq * hd, d), hq * hd, dtype, device),
    }


def kv_compute_heads(cfg: ModelConfig) -> int:
    kvp = cfg.n_kv_heads_padded or cfg.n_kv_heads
    return max(kvp, cfg.tp) if cfg.tp > 1 else kvp


def _masked(scores, causal, q_offset, tq, kv_len):
    """The reference's causal and cache-length masks: -1e9 where masked.
    ``q_offset`` and ``kv_len`` are host ints."""
    s = scores.shape[-1]
    if causal and kv_len is not None and kv_len >= q_offset + tq:
        kv_len = None        # implied: no query sees past its own position
    if not causal and kv_len is None:
        return scores
    kpos = torch.arange(s, device=scores.device)
    drop = None
    if causal:
        qpos = torch.arange(q_offset, q_offset + tq, device=scores.device)
        drop = kpos[None, :] > qpos[:, None]                      # (Tq, S)
    if kv_len is not None:   # decode: mask the cache tail beyond the length
        tail = kpos >= kv_len
        drop = tail if drop is None else drop | tail
    return scores.masked_fill(drop, -1e9)


def _sdpa(q, k, v, causal: bool, q_offset, kv_len: Optional[int] = None):
    """(B,Tq,H,hd) x (B,S,H,hd): scores materialized per call (callers
    chunk)."""
    hd = q.shape[-1]
    scores = einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    scores = _masked(scores, causal, q_offset, q.shape[1], kv_len)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return einsum("bhqk,bkhd->bqhd", probs, v)


def _sdpa_grouped(q, k, v, causal: bool, q_offset, kv_len=None):
    """GQA without materializing repeated K/V: q is reshaped to
    (B,Tq,KV,G,hd) and contracted straight against the KV-head tensors."""
    b, tq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q5 = q.reshape(b, tq, hkv, g, hd)
    scores = einsum("bqhgd,bkhd->bhgqk", q5, k) / math.sqrt(hd)
    scores = _masked(scores, causal, q_offset, tq, kv_len)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, tq, hq, hd)


GQA_NO_REPEAT = False   # the reference's §Perf variant flag


def multi_head_attention(q, k, v, causal: bool = True, q_chunk: int = 0,
                         q_offset: int = 0, kv_len=None):
    """Exact attention, optionally Q-chunked so the (C, S) score block, not
    (T, S), bounds live memory."""
    hq, hkv = q.shape[2], k.shape[2]
    attn = _sdpa
    if hq != hkv:
        if GQA_NO_REPEAT:
            attn = _sdpa_grouped
        else:
            k = torch.repeat_interleave(k, hq // hkv, dim=2)
            v = torch.repeat_interleave(v, hq // hkv, dim=2)
    tq = q.shape[1]
    if not q_chunk or tq <= q_chunk:
        return attn(q, k, v, causal, q_offset, kv_len)
    outs = []
    for c0 in range(0, tq, q_chunk):
        c1 = min(c0 + q_chunk, tq)
        outs.append(attn(q[:, c0:c1], k, v, causal, q_offset + c0, kv_len))
    return torch.cat(outs, dim=1)


def _write(buf: torch.Tensor, val: torch.Tensor, pos: int) -> torch.Tensor:
    """``lax.dynamic_update_slice(buf, val, (0, pos, 0, ...))`` in place:
    the start is clamped so the update fits, as XLA clamps it."""
    t = val.shape[1]
    start = min(max(int(pos), 0), buf.shape[1] - t)
    buf[:, start:start + t] = val
    return buf


def attention_block(params, x, positions, cfg: ModelConfig, causal=True,
                    q_chunk: int = 0, cache=None, cache_pos: int = None,
                    kv_override=None):
    """Full attention block: proj -> rope -> sdpa -> out-proj.

    ``positions``: (B, T) ints, or a :class:`Rotary` at them that the
    caller shares across its layers.
    cache: {"k","v"} (B, S, KVC, hd) buffers for decode (and "k_scale" /
    "v_scale" for the int8 cache), written in place at the host int
    ``cache_pos``. kv_override short-circuits projection for
    cross-attention (pre-computed encoder memory).
    Returns (out, new_cache).
    """
    b, t, d = x.shape
    hd = cfg.head_dim
    hq = cfg.n_heads_padded or cfg.n_heads
    kvc = kv_compute_heads(cfg)
    q = linear(params["wq"], x).reshape(b, t, hq, hd)
    rot = positions if isinstance(positions, Rotary) else Rotary(
        positions, cfg.rope_theta)
    if kv_override is not None:
        k, v = kv_override
        q = rot(q)
        new_cache = cache
        kv_len = None
    else:
        k = linear(params["wk"], x).reshape(b, t, kvc, hd)
        v = linear(params["wv"], x).reshape(b, t, kvc, hd)
        q = rot(q)
        k = rot(k)
        if cache is not None and "k_scale" in cache:
            # int8 KV cache: per-(position, head) symmetric scales. XLA's
            # float -> int8 conversion saturates; the clamp does the same.
            def quant(u):
                s = torch.amax(torch.abs(u), dim=-1, keepdim=True) / 127.0 \
                    + 1e-8
                qv = torch.round(u / s).clamp(-128, 127).to(torch.int8)
                return qv, s.to(u.dtype)
            kq, ks = quant(k)
            vq, vs = quant(v)
            new_cache = {"k": _write(cache["k"], kq, cache_pos),
                         "v": _write(cache["v"], vq, cache_pos),
                         "k_scale": _write(cache["k_scale"], ks, cache_pos),
                         "v_scale": _write(cache["v_scale"], vs, cache_pos)}
            k = new_cache["k"].to(x.dtype) * new_cache["k_scale"]
            v = new_cache["v"].to(x.dtype) * new_cache["v_scale"]
            kv_len = cache_pos + t
        elif cache is not None:   # the copy casts to the cache's dtype
            k = _write(cache["k"], k, cache_pos)
            v = _write(cache["v"], v, cache_pos)
            new_cache = {"k": k, "v": v}
            kv_len = cache_pos + t
        else:
            new_cache = None
            kv_len = None
    out = multi_head_attention(q, k, v, causal=causal and kv_override is None,
                               q_chunk=q_chunk,
                               q_offset=0 if cache is None else cache_pos,
                               kv_len=kv_len)
    out = linear(params["wo"], out.reshape(b, t, hq * hd))
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d: int, ff: int, act: str, dtype, device="cuda"):
    if act == "swiglu":
        return {"wi": _init(gen, (d, 2 * ff), d, dtype, device),
                "wo": _init(gen, (ff, d), ff, dtype, device)}
    return {"wi": _init(gen, (d, ff), d, dtype, device),
            "wo": _init(gen, (ff, d), ff, dtype, device)}


def activate(h: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU on the two halves of ``h``, else ``jax.nn.gelu``'s default,
    the tanh approximation."""
    if act == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        return F.silu(gate) * up
    return F.gelu(h, approximate="tanh")


def mlp_block(params, x, act: str):
    return linear(params["wo"], activate(linear(params["wi"], x), act))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embedding(gen, cfg: ModelConfig, dtype, device="cuda"):
    v = cfg.vocab_padded or cfg.vocab
    return {"table": _init(gen, (v, cfg.d_model), cfg.d_model, dtype,
                           device)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    if _on_mesh((table,)):
        from ..distributed.sharding import mesh_embed
        return mesh_embed(table, tokens)
    return table[tokens]


def lm_head(params, x: torch.Tensor, logical_vocab: int) -> torch.Tensor:
    logits = matmul(x, params["table"].t())
    v = logits.shape[-1]
    if v > logical_vocab:  # mask padding vocab out of the softmax
        logits[..., logical_vocab:] = -1e9
    return logits
