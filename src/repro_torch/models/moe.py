"""Mixture-of-Experts block with capacity-based sort dispatch (reference:
``repro/models/moe.py``).

The token->(expert, slot) assignment is a binary sparse matrix D in
{0,1}^(tokens x E*C); dispatch is D^T @ X and combine is (D * gates) @ Y,
realized as a gather and a scatter over the sorted assignments.

Determinism on the card: top-k breaks ties to the lower expert index (a
stable descending sort, as ``lax.top_k`` does), the sort is stable, and the
combine adds each token's k contributions in a fixed order, the order in
which the reference's scatter-add applies them (by position in the sorted
assignment list), instead of a CUDA ``index_add_`` whose atomics add in no
fixed order. Replays are bit-equal.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import _init, activate, einsum, linear, matmul


def init_moe(gen, cfg: ModelConfig, dtype, device="cuda"):
    d, ff = cfg.d_model, cfg.d_ff
    e = cfg.moe_experts_padded or cfg.moe_experts
    ff_in = 2 * ff if cfg.act == "swiglu" else ff
    p = {
        "router": _init(gen, (d, e), d, torch.float32, device),
        "wi": _init(gen, (e, d, ff_in), d, dtype, device),
        "wo": _init(gen, (e, ff, d), ff, dtype, device),
    }
    if cfg.moe_shared_ff:
        sf = cfg.moe_shared_ff
        p["shared_wi"] = _init(gen, (d, 2 * sf if cfg.act == "swiglu"
                                     else sf), d, dtype, device)
        p["shared_wo"] = _init(gen, (sf, d), sf, dtype, device)
        p["shared_gate"] = _init(gen, (d, 1), d, dtype, device)
    return p


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    return max(-(-c // 8) * 8, 8)


def _route(flat: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           e: int, k: int):
    """Softmax gates and the top-k experts of each row, renormalized:
    (gate_vals, expert_idx), each (..., k); ties go to the lower index."""
    logits = matmul(flat.float(), router)                         # (..., E)
    if e > cfg.moe_experts:  # mask padded experts out of routing
        # out of place: in a dry run on a mesh the logits may be partial
        # sums, which an in-place add cannot take (the same values)
        m = cfg.moe_experts
        logits = torch.cat([logits[..., :m], logits[..., m:] + -1e9], dim=-1)
    gates_all = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return gate_vals, expert_idx


def _dispatch(fe: torch.Tensor, e: int, cap: int):
    """Sorted-rank slots of the flat (N*k,) expert choices: returns
    (order, slot, keep), ``slot == e * cap`` for a dropped choice."""
    order = torch.sort(fe, stable=True).indices
    se = fe[order]
    starts = torch.searchsorted(se, torch.arange(e, device=fe.device,
                                                 dtype=se.dtype))
    rank = torch.arange(fe.numel(), device=fe.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, torch.full_like(se, e * cap))
    return order, slot, keep


def _combine(y_sorted: torch.Tensor, order: torch.Tensor, n: int, k: int):
    """``zeros((n, d)).at[st].add(y_sorted)`` in a fixed order: token i's
    k rows, taken in their sorted-list order, added left to right."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    pos = torch.sort(inv.reshape(n, k), dim=1).values               # (n, k)
    rows = y_sorted[pos]                                            # (n,k,d)
    out = torch.zeros_like(rows[:, 0])
    for j in range(k):
        out = out + rows[:, j]
    return out


def _experts(params, xe: torch.Tensor, cfg: ModelConfig, spec_in: str,
             spec_out: str) -> torch.Tensor:
    h = activate(einsum(spec_in, xe, params["wi"]), cfg.act)
    return einsum(spec_out, h, params["wo"])


def moe_block(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d) -> (B, T, d). Dispatch is GLOBAL by default;
    ``cfg.moe_groups > 1`` switches to per-group dispatch (the reference's
    per-data-shard form, here on one device); ``cfg.moe_groups == -1``, the
    reference's shard_map form, needs a device mesh and raises."""
    if getattr(cfg, "moe_groups", 0) == -1:
        raise NotImplementedError(
            "moe_groups=-1 (the reference's shard_map MoE) needs a device "
            "mesh of expert-parallel ranks; it comes with slice G-b "
            "(ROADMAP Queue 1 item 3)")
    if getattr(cfg, "moe_groups", 0) > 1:
        return _moe_grouped(params, x, cfg)
    b, t, d = x.shape
    n = b * t
    e = cfg.moe_experts_padded or cfg.moe_experts
    k = cfg.moe_top_k
    flat = x.reshape(n, d)

    gate_vals, expert_idx = _route(flat, params["router"], cfg, e, k)
    cap = _capacity(n, e, k, cfg.capacity_factor)

    fe = expert_idx.reshape(-1)                                    # (N*k,)
    ft = torch.repeat_interleave(torch.arange(n, device=x.device), k)
    fg = gate_vals.reshape(-1).to(x.dtype)
    order, slot, keep = _dispatch(fe, e, cap)
    st, sg = ft[order], fg[order]

    # dispatch: Xe = D^T @ X (the trash slot e * cap is dropped)
    xe = x.new_zeros((e * cap + 1, d))
    xe[slot] = flat[st]
    xe = xe[:-1].reshape(e, cap, d)

    ye = _experts(params, xe, cfg, "ecd,edf->ecf", "ecf,efd->ecd")

    # combine: Y = (D * gates) @ Ye
    y_tok = ye.reshape(e * cap, d)[torch.clamp(slot, max=e * cap - 1)]
    y_tok = y_tok * (sg * keep.to(x.dtype))[:, None]
    out = _combine(y_tok, order, n, k)

    if "shared_wi" in params:
        out = out + _shared_expert(params, flat, cfg)
    return out.reshape(b, t, d)


def _shared_expert(params, flat, cfg):
    h = activate(linear(params["shared_wi"], flat), cfg.act)
    shared = linear(params["shared_wo"], h)
    sgate = torch.sigmoid(matmul(flat, params["shared_gate"]))
    return shared * sgate


def _moe_grouped(params, x: torch.Tensor, cfg: ModelConfig):
    """Per-group dispatch: tokens are split into ``moe_groups`` groups;
    routing, capacity, sort, gather and combine are all group-local (the
    reference aligns the groups with its data-parallel axis; on one device
    the math is the same)."""
    b, t, d = x.shape
    n = b * t
    g = cfg.moe_groups
    e = cfg.moe_experts_padded or cfg.moe_experts
    k = cfg.moe_top_k
    nl = n // g
    flat = x.reshape(g, nl, d)

    gate_vals, expert_idx = _route(flat, params["router"], cfg, e, k)
    cap = _capacity(nl, e, k, cfg.capacity_factor)

    xe = x.new_zeros((g, e * cap + 1, d))
    ft = torch.repeat_interleave(torch.arange(nl, device=x.device), k)
    plans = []
    for gi in range(g):
        fe = expert_idx[gi].reshape(-1)
        fg = gate_vals[gi].reshape(-1).to(x.dtype)
        order, slot, keep = _dispatch(fe, e, cap)
        st, sg = ft[order], fg[order]
        xe[gi, slot] = flat[gi, st]
        plans.append((order, slot, keep, sg))
    xe = xe[:, :-1].reshape(g, e, cap, d)

    ye = _experts(params, xe, cfg, "gecd,edf->gecf", "gecf,efd->gecd")

    outs = []
    for gi, (order, slot, keep, sg) in enumerate(plans):
        y_rows = ye[gi].reshape(e * cap, d)[torch.clamp(slot,
                                                        max=e * cap - 1)]
        y_rows = y_rows * (sg * keep.to(x.dtype))[:, None]
        outs.append(_combine(y_rows, order, nl, k))
    out = torch.stack(outs).reshape(n, d)

    if "shared_wi" in params:
        out = out + _shared_expert(params, x.reshape(n, d), cfg)
    return out.reshape(b, t, d)

