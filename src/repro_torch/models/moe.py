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
import math

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


def _slots(xe: torch.Tensor, flat: torch.Tensor, gate_vals: torch.Tensor,
           expert_idx: torch.Tensor, e: int, cap: int):
    """Dispatch, Xe = D^T @ X: writes the (n, d) rows of ``flat`` into
    their experts' capacity slots of ``xe`` (e * cap + 1, d), a choice past
    its expert's capacity into the trash slot e * cap; returns the plan
    :func:`_unslot` combines by."""
    n, d = flat.shape
    k = expert_idx.shape[-1]
    fe = expert_idx.reshape(-1)                                    # (N*k,)
    ft = torch.repeat_interleave(torch.arange(n, device=flat.device), k)
    fg = gate_vals.reshape(-1).to(flat.dtype)
    order, slot, keep = _dispatch(fe, e, cap)
    st, sg = ft[order], fg[order]
    xe[slot] = flat[st]
    return order, slot, keep, sg


def _unslot(ye: torch.Tensor, plan, n: int, k: int) -> torch.Tensor:
    """Combine, Y = (D * gates) @ Ye: the (n, d) tokens' gated expert rows
    of ``ye`` (e, cap, d), summed by :func:`_combine`."""
    order, slot, keep, sg = plan
    e, cap, d = ye.shape
    rows = ye.reshape(e * cap, d)[torch.clamp(slot, max=e * cap - 1)]
    return _combine(rows * (sg * keep.to(sg.dtype))[:, None], order, n, k)


def _moe_groups(params, router, flat: torch.Tensor, cfg: ModelConfig,
                experts):
    """Routing, dispatch and combine of the (g, nl, d) groups of ``flat``,
    each group on its own (capacity over its nl tokens): the (g * nl, d)
    output. ``experts(xe)`` runs the experts on the (g, e, cap, d) slots
    and returns their (g, e, cap, d) rows."""
    g, nl, d = flat.shape
    e = cfg.moe_experts_padded or cfg.moe_experts
    k = cfg.moe_top_k
    gate_vals, expert_idx = _route(flat, router, cfg, e, k)
    cap = _capacity(nl, e, k, cfg.capacity_factor)
    xe = flat.new_zeros((g, e * cap + 1, d))
    plans = [_slots(xe[i], flat[i], gate_vals[i], expert_idx[i], e, cap)
             for i in range(g)]
    ye = experts(xe[:, :-1].reshape(g, e, cap, d))
    outs = [_unslot(ye[i], plan, nl, k) for i, plan in enumerate(plans)]
    return outs[0] if g == 1 else torch.cat(outs)


def moe_block(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d) -> (B, T, d). Dispatch is GLOBAL by default (one group
    of all B * T tokens); ``cfg.moe_groups > 1`` switches to per-group
    dispatch (the reference's per-data-shard form); ``cfg.moe_groups ==
    -1`` is the expert-parallel form (:func:`_moe_shard_map`) where the
    experts are DTensors on a mesh with a ``model`` dim, and the global
    dispatch elsewhere, as in the reference. Where ``x`` or the parameters
    are DTensors the global and grouped forms run as :func:`_moe_on_mesh`
    lays them out."""
    groups = getattr(cfg, "moe_groups", 0)
    if groups == -1:
        return _moe_shard_map(params, x, cfg)
    mesh = _mesh_of(x, params["router"], params["wi"])
    if mesh is not None:
        return _moe_on_mesh(params, x, cfg, mesh)
    b, t, d = x.shape
    flat = x.reshape(max(groups, 1), -1, d)
    out = _moe_groups(params, params["router"], flat, cfg,
                      lambda xe: _experts(params, xe, cfg, "gecd,edf->gecf",
                                          "gecf,efd->gecd"))
    out = out.reshape(b, t, d)
    if "shared_wi" in params:
        # the global form's shared expert reads the dispatch's view, the
        # grouped form's reads x: each form's token gradient sums its
        # terms in the order it always has
        shared = _shared_expert(params, flat if groups <= 1 else x, cfg)
        out = out + shared.reshape(b, t, d)
    return out


def _moe_on_mesh(params, x: torch.Tensor, cfg: ModelConfig, mesh):
    """The global and grouped dispatch where ``x`` or the parameters are
    DTensors on ``mesh``, laid out as the reference constrains it.
    Routing, dispatch and combine run on local tensors, laid out by
    ``rows``; the experts and the shared expert run on DTensors.

    ``rows``: the global dispatch ranks every token against all the others
    (capacity over all B * T tokens), so every rank gathers all of them
    and dispatches them alike, as GSPMD gathers them. The grouped form
    keeps the mesh dims that shard ``x``'s batch where a shard holds whole
    groups (its groups are then the reference's data shards), else it
    gathers the tokens too. Where the mesh has a ``model`` dim, the slots
    then take the reference's constraint (``src/repro/models/moe.py``:
    the global form's (e, cap, d) slots experts over ``model`` and
    capacity over ``data``, the grouped form's (g, e, cap, d) groups over
    ``data`` and experts over ``model``; a dim that a mesh dim does not
    split evenly stays whole), a local slice of the slots a rank holds;
    the experts' rows are gathered back for the combine. Every rank runs
    the ops one process runs on its groups, on the same values: the output
    and the gradients are the one-process block's, but for sums over a dim
    that the placements shard (FSDP's ``d`` in the experts' products, the
    rows a replicated weight is used on), which add parts."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..distributed import sharding

    b, t, d = x.shape
    g = max(getattr(cfg, "moe_groups", 0), 1)
    x_pl = list(x.placements) if isinstance(x, DTensor) \
        else [Replicate()] * mesh.ndim
    rows = [p if g > 1 and p == Shard(0) else Replicate() for p in x_pl]
    s = math.prod(mesh.size(i) for i, p in enumerate(rows) if p.is_shard())
    if g % s or b % s:
        rows, s = [Replicate()] * mesh.ndim, 1
    # a rank's gradient is its own rows' where it holds a shard of them;
    # the router's, used on those rows alone, is a partial sum there
    flat = _placed(x, mesh, rows).to_local(grad_placements=rows)
    router = _placed(params["router"], mesh, [Replicate()] * mesh.ndim) \
        .to_local(grad_placements=[Partial() if p.is_shard() else p
                                   for p in rows])

    spec = (None, "model", "data", None) if g == 1 \
        else ("data", "model", None, None)

    def experts(xe):
        xe = DTensor.from_local(xe, mesh, rows, run_check=False)
        if "model" in mesh.mesh_dim_names:
            xe = _placed(xe, mesh, [
                p if not p.is_shard() or xe.shape[p.dim] % mesh.size(i) == 0
                else Replicate()
                for i, p in enumerate(sharding.placements(spec, mesh))])
        ye = _experts(params, xe, cfg, "gecd,edf->gecf", "gecf,efd->gecd")
        return ye.redistribute(mesh, rows).to_local(grad_placements=rows)

    out = _moe_groups(params, router, flat.reshape(g // s, -1, d), cfg,
                      experts)
    # in x's placements (replicated where x is a partial sum)
    out = DTensor.from_local(out.reshape(-1, t, d), mesh, rows,
                             run_check=False).redistribute(
        mesh, [Replicate() if p.is_partial() else p for p in x_pl])
    if "shared_wi" in params:
        out = out + _shared_expert(params, x, cfg)
    return out if isinstance(x, DTensor) else out.full_tensor()


def _placed(v, mesh, pl):
    """``v`` as a DTensor on ``mesh`` in the placements ``pl`` (a plain
    tensor counts as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(v, DTensor):
        v = DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return v if list(v.placements) == pl else v.redistribute(mesh, pl)


def _shared_expert(params, x, cfg):
    h = activate(linear(params["shared_wi"], x), cfg.act)
    shared = linear(params["shared_wo"], h)
    sgate = torch.sigmoid(matmul(x, params["shared_gate"]))
    return shared * sgate


def _mesh_of(*ts):
    """The device mesh of the first DTensor among ``ts``, or None."""
    if all(type(t) is torch.Tensor for t in ts):
        return None
    from torch.distributed.tensor import DTensor
    return next((t.device_mesh for t in ts if isinstance(t, DTensor)), None)


def _model_mesh(*ts):
    """The device mesh of the first DTensor among ``ts`` when it has a
    ``model`` dim, else None (the port's stand-in for the reference's
    abstract mesh in context)."""
    mesh = _mesh_of(*ts)
    return mesh if mesh is not None and "model" in (
        mesh.mesh_dim_names or ()) else None


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

    def over_model(on_model, elsewhere):
        return [on_model if i == m_dim else elsewhere
                for i in range(mesh.ndim)]

    # the reference's in_specs: tokens P(dp, None), router P(), experts
    # P("model", ...); a rank's gradient of what it uses but does not own
    # alone is a partial sum over the dims it is replicated on. The
    # tokens split by batch rows, the reference's split of B * T rows.
    rows = over_model(Replicate(), Shard(0))
    xr = _placed(x, mesh, rows)
    # the tokens' gradient is summed over model at this boundary, one
    # all-reduce in the backward (the transpose of the reference's
    # replicated in_spec), not left partial for the ops before it
    xr = DTensor.from_local(xr.to_local(), mesh, rows, run_check=False,
                            shape=xr.shape, stride=xr.stride())
    flat = xr.to_local(
        grad_placements=over_model(Partial(), Shard(0))).reshape(-1, d)
    router = _placed(params["router"], mesh,
                     [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial()] * mesh.ndim)
    local_p = {w: _placed(params[w], mesh,
                          over_model(Shard(0), Replicate())).to_local(
                              grad_placements=over_model(Shard(0), Partial()))
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
