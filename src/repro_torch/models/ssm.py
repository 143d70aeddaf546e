"""State-space blocks: Mamba2 (zamba2 hybrid) and RWKV6 "Finch" time-mix
(reference: ``repro/models/ssm.py``).

Both use chunked linear-recurrence algorithms: O(T/Q * Q^2) intra-chunk
products plus an O(1)-per-chunk carried state. The chunk loop is a Python
loop (the reference's ``unroll=False`` scans the same step body; the
argument is accepted and computes the same thing here).

Decode steps are O(1): a single state update per token. SSM states stay
in fp32; the products against bf16 projections run in fp32, as JAX
promotes them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import _init, einsum, linear, matmul

CHUNK = 256
_CONV_K = 4


# ---------------------------------------------------------------------------
# Mamba2 (SSD, n_groups=1)
# ---------------------------------------------------------------------------

def init_mamba(gen, cfg: ModelConfig, dtype, device="cuda"):
    d = cfg.d_model
    n = cfg.ssm_state
    h = cfg.ssm_heads_padded or cfg.ssm_heads
    p_dim = cfg.ssm_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wz": _init(gen, (d, h * p_dim), d, dtype, device),
        "wx": _init(gen, (d, h * p_dim), d, dtype, device),
        "wB": _init(gen, (d, n), d, dtype, device),
        "wC": _init(gen, (d, n), d, dtype, device),
        "wdt": _init(gen, (d, h), d, dtype, device),
        "dt_bias": torch.zeros((h,), **f32),
        "A_log": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "conv_w": _init(gen, (_CONV_K, h * p_dim), _CONV_K, dtype, device),
        "norm_scale": torch.ones((h * p_dim,), dtype=dtype, device=device),
        "wo": _init(gen, (h * p_dim, d), h * p_dim, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv (k=4) via shifted adds. x: (B, T, C); state:
    (B, K-1, C) tail of the previous segment. Returns (y, new_state)."""
    b, t, c = x.shape
    if state is None:
        state = x.new_zeros((b, _CONV_K - 1, c))
    ext = torch.cat([state, x], dim=1)
    y = sum(ext[:, i:i + t] * w[i] for i in range(_CONV_K))
    return y, ext[:, -(_CONV_K - 1):]


def _pad_time(v: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 at its end by ``pad``."""
    if not pad:
        return v
    return F.pad(v, (0, 0) * (v.ndim - 2) + (0, pad))


def mamba_block(params, x, cfg: ModelConfig, unroll: bool = True,
                cache: Optional[dict] = None):
    """x: (B, T, d). cache (decode): {"S": (B,H,P,N) fp32, "conv": (B,3,HP)}.
    Returns (y, new_cache)."""
    b, t, d = x.shape
    h = cfg.ssm_heads_padded or cfg.ssm_heads
    p_dim, n = cfg.ssm_head_dim, cfg.ssm_state

    z = linear(params["wz"], x)
    xh = linear(params["wx"], x)
    conv_state = None if cache is None else cache["conv"]
    xh, new_conv = _causal_conv(xh, params["conv_w"], conv_state)
    xh = F.silu(xh)
    bmat = linear(params["wB"], x).float()                   # (B,T,N)
    cmat = linear(params["wC"], x).float()                   # (B,T,N)
    dt = F.softplus(linear(params["wdt"], x).float()
                    + params["dt_bias"])                     # (B,T,H)
    a = -torch.exp(params["A_log"])                          # (H,)
    da = dt * a                                              # (B,T,H) <= 0

    xs = xh.reshape(b, t, h, p_dim).float()
    s0 = (torch.zeros((b, h, p_dim, n), dtype=torch.float32,
                      device=x.device) if cache is None else cache["S"])

    if cache is not None and t == 1:  # decode: exact single-step update
        dec = torch.exp(da[:, 0])[..., None, None]
        contrib = einsum("bh,bn,bhp->bhpn", dt[:, 0], bmat[:, 0], xs[:, 0])
        s_new = s0 * dec + contrib
        y = einsum("bn,bhpn->bhp", cmat[:, 0], s_new)
        y = y + params["D"][None, :, None] * xs[:, 0]
        y = y.reshape(b, 1, h * p_dim).to(x.dtype)
        new_cache = {"S": s_new, "conv": new_conv}
    else:
        nq = -(-t // CHUNK)
        pad = nq * CHUNK - t
        xq = _pad_time(xs, pad).reshape(b, nq, CHUNK, h, p_dim)
        bq = _pad_time(bmat, pad).reshape(b, nq, CHUNK, n)
        cq = _pad_time(cmat, pad).reshape(b, nq, CHUNK, n)
        dtq = _pad_time(dt, pad).reshape(b, nq, CHUNK, h)
        daq = _pad_time(da, pad).reshape(b, nq, CHUNK, h)
        mask = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                     device=x.device))

        def step(s, i):
            xi, bi, ci, dti = xq[:, i], bq[:, i], cq[:, i], dtq[:, i]
            lq = torch.cumsum(daq[:, i], dim=1)              # (B,Q,H)
            cb = einsum("bin,bjn->bij", ci, bi)
            dec = torch.exp(lq[:, :, None, :] - lq[:, None, :, :])
            w_ij = torch.where(mask[None, :, :, None],
                               cb[:, :, :, None] * dec * dti[:, None, :, :],
                               0.0)
            y_intra = einsum("bijh,bjhp->bihp", w_ij, xi)
            lq_end = lq[:, -1:, :]
            contrib = einsum("bjh,bjn,bjhp->bhpn",
                             dti * torch.exp(lq_end - lq), bi, xi)
            s_new = s * torch.exp(lq_end[:, 0])[..., None, None] + contrib
            y_inter = einsum("bin,bhpn,bih->bihp", ci, s, torch.exp(lq))
            return s_new, y_intra + y_inter

        ys, s = [], s0
        for i in range(nq):
            s, y_i = step(s, i)
            ys.append(y_i)
        y = torch.cat(ys, dim=1)[:, :t]
        y = y + params["D"][None, None, :, None] * xs[:, :t]
        y = y.reshape(b, t, h * p_dim).to(x.dtype)
        new_cache = None if cache is None else {"S": s, "conv": new_conv}

    # gated RMSNorm + out proj (Mamba2 epilogue)
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6).to(y.dtype)) * params["norm_scale"]
    return linear(params["wo"], y), new_cache


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent per-channel decay, chunked GLA form
# ---------------------------------------------------------------------------

_LORA = 32
_CLAMP = 30.0


def init_rwkv(gen, cfg: ModelConfig, dtype, device="cuda"):
    d = cfg.d_model
    h = cfg.ssm_heads_padded or (d // cfg.ssm_head_dim)
    hk = cfg.ssm_head_dim
    dh = h * hk
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu": 0.5 * torch.ones((5, d), dtype=dtype, device=device),
        "wr": _init(gen, (d, dh), d, dtype, device),
        "wk": _init(gen, (d, dh), d, dtype, device),
        "wv": _init(gen, (d, dh), d, dtype, device),
        "wg": _init(gen, (d, dh), d, dtype, device),
        "w0": -6.0 * torch.ones((dh,), **f32),          # base decay
        "wA": _init(gen, (d, _LORA), d, dtype, device),   # decay lora
        "wB": _init(gen, (_LORA, dh), _LORA, dtype, device),
        "u": torch.zeros((dh,), **f32),                 # bonus
        "ln_scale": torch.ones((dh,), dtype=dtype, device=device),
        "wo": _init(gen, (dh, d), dh, dtype, device),
        # channel mix
        "cm_mu": 0.5 * torch.ones((2, d), dtype=dtype, device=device),
        "cm_wk": _init(gen, (d, cfg.d_ff), d, dtype, device),
        "cm_wv": _init(gen, (cfg.d_ff, d), cfg.d_ff, dtype, device),
        "cm_wr": _init(gen, (d, d), d, dtype, device),
    }


def _shift_delta(x, last: Optional[torch.Tensor] = None):
    """prev_token - x; ``last`` is the previous segment's tail."""
    b = x.shape[0]
    first = (x.new_zeros((b, 1, x.shape[-1])) if last is None
             else last[:, None, :])
    return torch.cat([first, x[:, :-1]], dim=1) - x


def _token_shifts(x, mus, last: Optional[torch.Tensor] = None):
    """``x + mu * (prev_token - x)`` for each row ``mu`` of ``mus`` (K, d),
    in one pass: (K, B, T, d). Each element is the reference's one shift."""
    return x + mus[:, None, None, :] * _shift_delta(x, last)


def _token_shift(x, mu, last: Optional[torch.Tensor] = None):
    """x + mu * (prev_token - x); ``last`` is the previous segment's tail."""
    return _token_shifts(x, mu[None], last)[0]


def rwkv_time_mix(params, x, cfg: ModelConfig, unroll: bool = True,
                  cache: Optional[dict] = None):
    """x: (B,T,d) -> (B,T,d). cache: {"S": (B,H,K,V) fp32, "last": (B,d)}."""
    b, t, d = x.shape
    h = cfg.ssm_heads_padded or (d // cfg.ssm_head_dim)
    hk = cfg.ssm_head_dim
    xr, xk, xv, xw, xg = _token_shifts(
        x, params["mu"], None if cache is None else cache["last"])

    r = linear(params["wr"], xr).reshape(b, t, h, hk).float()
    k = linear(params["wk"], xk).reshape(b, t, h, hk).float()
    v = linear(params["wv"], xv).reshape(b, t, h, hk).float()
    g = F.silu(linear(params["wg"], xg))

    lora = matmul(torch.tanh(matmul(xw, params["wA"])), params["wB"])
    logw = -torch.exp(torch.clamp(params["w0"] + lora.float(), -8.0, 8.0))
    logw = torch.clamp(logw, min=-_CLAMP).reshape(b, t, h, hk)
    u = params["u"].reshape(h, hk)

    s0 = (torch.zeros((b, h, hk, hk), dtype=torch.float32, device=x.device)
          if cache is None else cache["S"])

    if cache is not None and t == 1:
        r1, k1, v1, w1 = r[:, 0], k[:, 0], v[:, 0], torch.exp(logw[:, 0])
        kv = einsum("bhk,bhv->bhkv", k1, v1)
        y = einsum("bhk,bhkv->bhv", r1, s0 + u[None, :, :, None] * kv)
        s_new = s0 * w1[..., None] + kv
        y = y[:, None]                                       # (B,1,H,V)
        new_cache = {"S": s_new, "last": x[:, -1, :]}
    else:
        q_sz = min(CHUNK, 64)
        nq = -(-t // q_sz)
        pad = nq * q_sz - t
        rq = _pad_time(r, pad).reshape(b, nq, q_sz, h, hk)
        kq = _pad_time(k, pad).reshape(b, nq, q_sz, h, hk)
        vq = _pad_time(v, pad).reshape(b, nq, q_sz, h, hk)
        lwq = _pad_time(logw, pad).reshape(b, nq, q_sz, h, hk)  # log(1)=0
        mask = torch.tril(torch.ones((q_sz, q_sz), dtype=torch.bool,
                                     device=x.device), diagonal=-1)

        def step(s, i):
            ri, ki, vi, lw = rq[:, i], kq[:, i], vq[:, i], lwq[:, i]
            cl = torch.cumsum(lw, dim=1)                     # (B,Q,H,K) incl.
            cl_excl = cl - lw
            q_eff = ri * torch.exp(torch.clamp(cl_excl, min=-_CLAMP))
            k_eff = ki * torch.exp(torch.clamp(-cl, max=_CLAMP))
            scores = einsum("bihk,bjhk->bhij", q_eff, k_eff)
            scores = torch.where(mask[None, None], scores, 0.0)
            bonus = einsum("bihk,hk,bihk->bih", ri, u, ki)
            y_intra = einsum("bhij,bjhv->bihv", scores, vi) \
                + bonus[..., None] * vi
            y_inter = einsum("bihk,bhkv->bihv", q_eff, s)
            cl_end = cl[:, -1]                               # (B,H,K)
            k_carry = ki * torch.exp(torch.clamp(cl_end[:, None] - cl,
                                                 min=-_CLAMP))
            s_new = s * torch.exp(cl_end)[..., None] \
                + einsum("bjhk,bjhv->bhkv", k_carry, vi)
            return s_new, y_intra + y_inter

        ys, s = [], s0
        for i in range(nq):
            s, y_i = step(s, i)
            ys.append(y_i)
        y = torch.cat(ys, dim=1)[:, :t]
        new_cache = None if cache is None else {"S": s, "last": x[:, -1, :]}

    # per-head groupnorm, gate, out-proj
    y = y.reshape(b, -1, h, hk)
    mu_ = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    y = ((y - mu_) * torch.rsqrt(var + 1e-5)).reshape(b, y.shape[1], h * hk)
    y = (y.to(x.dtype) * params["ln_scale"]) * g
    return linear(params["wo"], y), new_cache


def rwkv_channel_mix(params, x, cache: Optional[dict] = None):
    """Returns (out, new_cm_last). Reads the PREVIOUS segment tail from
    ``cache["cm_last"]``; the caller merges the returned tail into its new
    cache (the time-mix and channel-mix tails are distinct streams)."""
    xk, xr = _token_shifts(
        x, params["cm_mu"], None if cache is None else cache.get("cm_last"))
    k = torch.square(F.relu(linear(params["cm_wk"], xk)))
    out = torch.sigmoid(linear(params["cm_wr"], xr)) \
        * linear(params["cm_wv"], k)
    return out, x[:, -1, :]
