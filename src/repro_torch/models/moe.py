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

import dataclasses

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
    per-data-shard form, here on one device); ``cfg.moe_groups == -1`` is
    the expert-parallel form (:func:`_moe_shard_map`) where the experts
    are DTensors on a mesh with a ``model`` dim, and the global dispatch
    elsewhere, as in the reference."""
    if getattr(cfg, "moe_groups", 0) == -1:
        return _moe_shard_map(params, x, cfg)
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


def _model_mesh(*ts):
    """The device mesh of the first DTensor among ``ts`` when it has a
    ``model`` dim, else None (the port's stand-in for the reference's
    abstract mesh in context)."""
    if all(type(t) is torch.Tensor for t in ts):
        return None
    from torch.distributed.tensor import DTensor
    for t in ts:
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            return mesh if "model" in (mesh.mesh_dim_names or ()) else None
    return None


def _moe_shard_map(params, x: torch.Tensor, cfg: ModelConfig):
    """Expert-parallel MoE (the reference's ``_moe_shard_map``, §Perf A3).

    Every rank holds a data shard of the tokens (replicated over the
    ``model`` dim) and a ``model`` shard of the experts. Each rank routes
    its own tokens, keeps only the assignments to its own experts (local
    capacity slots), runs those experts and combines locally; the partial
    outputs, a ``Partial`` DTensor over ``model``, are summed by ONE
    (nl, d) all-reduce a layer. The body runs on local tensors; the
    DTensor boundary carries the gradients (a rank's share of the router
    and token gradients is a partial sum; its expert gradients are its
    own shard's). Without a mesh with a ``model`` dim this is the global
    dispatch, ``moe_groups=0``, as the reference falls back to."""
    mesh = _model_mesh(params["wi"], x)
    if mesh is None:
        return moe_block(params, x, dataclasses.replace(cfg, moe_groups=0))
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    m_dim = mesh.mesh_dim_names.index("model")
    b, t, d = x.shape
    e = cfg.moe_experts_padded or cfg.moe_experts
    k = cfg.moe_top_k
    tp = mesh.size(m_dim)
    dp = mesh.size() // tp
    if e % tp:
        raise ValueError(f"{e} experts do not split over model = {tp}; "
                         f"pad them (resolve_for_mesh)")
    if b % dp:
        raise ValueError(f"a batch of {b} does not split over the {dp} "
                         f"data-parallel ranks")
    e_loc = e // tp
    e0 = mesh.get_local_rank(m_dim) * e_loc

    def placed(v, pl):
        if not isinstance(v, DTensor):
            v = DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return v if list(v.placements) == pl else v.redistribute(mesh, pl)

    def over_model(on_model, elsewhere):
        return [on_model if i == m_dim else elsewhere
                for i in range(mesh.ndim)]

    # the reference's in_specs: tokens P(dp, None), router P(), experts
    # P("model", ...); a rank's gradient of what it uses but does not own
    # alone is a partial sum over the dims it is replicated on. The
    # tokens split by batch rows, the reference's split of B * T rows.
    rows = over_model(Replicate(), Shard(0))
    xr = placed(x, rows)
    # the tokens' gradient is summed over model at this boundary, one
    # all-reduce in the backward (the transpose of the reference's
    # replicated in_spec), not left partial for the ops before it
    xr = DTensor.from_local(xr.to_local(), mesh, rows, run_check=False,
                            shape=xr.shape, stride=xr.stride())
    flat = xr.to_local(
        grad_placements=over_model(Partial(), Shard(0))).reshape(-1, d)
    router = placed(params["router"], [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial()] * mesh.ndim)
    local_p = {w: placed(params[w], over_model(Shard(0), Replicate()))
               .to_local(grad_placements=over_model(Shard(0), Partial()))
               for w in ("wi", "wo")}

    nl = flat.shape[0]
    gate_vals, expert_idx = _route(flat, router, cfg, e, k)
    cap = _capacity(nl, e, k, cfg.capacity_factor)
    fe = expert_idx.reshape(-1)
    ft = torch.repeat_interleave(torch.arange(nl, device=flat.device), k)
    fg = gate_vals.reshape(-1).to(flat.dtype)
    order, slot, keep = _dispatch(fe, e, cap)
    se, st, sg = fe[order], ft[order], fg[order]
    local = keep & (se >= e0) & (se < e0 + e_loc)
    slot = torch.where(local, slot - e0 * cap,
                       torch.full_like(slot, e_loc * cap))

    xe = flat.new_zeros((e_loc * cap + 1, d))
    xe[slot] = flat[st]
    xe = xe[:-1].reshape(e_loc, cap, d)
    ye = _experts(local_p, xe, cfg, "ecd,edf->ecf", "ecf,efd->ecd")
    y_rows = ye.reshape(e_loc * cap, d)[torch.clamp(slot,
                                                    max=e_loc * cap - 1)]
    y_rows = y_rows * (sg * local.to(flat.dtype))[:, None]
    part = _combine(y_rows, order, nl, k).reshape(-1, t, d)

    out = DTensor.from_local(part, mesh, over_model(Partial(), Shard(0)),
                             run_check=False, shape=x.shape,
                             stride=(t * d, d, 1))
    out = out.redistribute(mesh, rows)        # the one all-reduce a layer
    if not isinstance(x, DTensor):
        out = out.full_tensor()
    if "shared_wi" in params:
        out = out + _shared_expert(params, x, cfg)
    return out
