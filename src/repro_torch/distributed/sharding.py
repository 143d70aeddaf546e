"""Logical-axis sharding rules -> DTensor placements (reference:
``repro/distributed/sharding.py``).

Megatron-style tensor parallelism on the "model" axis (column-parallel into
attention/FFN, row-parallel out, vocab-sharded embedding), optional FSDP on
the "data" axis for weights (training shapes: optimizer state must fit),
batch over ("pod","data").

The rules are data: a spec is a tuple with one entry per tensor dim, each a
mesh-axis name, a tuple of names or ``None``, equal entry by entry to the
reference's ``PartitionSpec``. :func:`placements` turns a spec into the
``Placement`` list of a ``DeviceMesh`` (one entry per mesh dim). Rules are
keyed on the LAST component of each parameter's key path, the checkpoint
key string (``checkpoint.checkpointer``): dict keys as they are, sequence
items as their index, NamedTuple fields as ``.<field>``. The parameter
trees hold no dict key made of digits, so a component of digits is a
sequence index.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from ..checkpoint.checkpointer import _children

Spec = tuple


def _is_dict_key(part: str) -> bool:
    return not (part.startswith(".") or part.isdigit())


def _key_of(parts: Sequence[str]) -> str:
    return parts[-1]


def _parent_key(parts: Sequence[str]) -> str:
    for entry in reversed(parts[:-1]):
        if _is_dict_key(entry):
            return entry
    return ""


# fp rule table: key -> (spec builder). d=fsdp axis or None, m="model".
def _fp_spec(key: str, parent: str, ndim: int, d, m) -> Spec:
    col = {  # column-parallel: (in, out_model)
        "wq", "wk", "wv", "wi", "wz", "wx", "wdt", "wr", "wg",
        "shared_wi", "cm_wk",
    }
    row = {  # row-parallel: (in_model, out)
        "wo", "shared_wo", "cm_wv",
    }
    model_vec = {"A_log", "dt_bias", "D", "w0", "u", "ln_scale", "norm_scale"}
    if key == "table":
        return (m, d)                        # vocab-sharded embedding
    if ndim == 3 and key == "wi":            # MoE experts: EP over model —
        return (m, d, None)                  # MUST precede the 2-D col rule
    if ndim == 3 and key == "wo":
        return (m, None, d)
    if key in col:
        return (d, m) if ndim == 2 else (None,)
    if key in row:
        return (m, d) if ndim == 2 else (None,)
    if key == "cm_wr":
        return (d, None)
    if key in ("wB", "wC"):                  # mamba B/C proj: small state dim
        return (d, None)
    if key == "conv_w":
        return (None, m)
    if key in model_vec:
        return (m,) if ndim == 1 else (None, m)
    if key == "router":
        return (None, None)
    if parent == "moe" or key in ("wi", "wo") and ndim == 3:
        pass
    if ndim == 3 and key == "wi":
        return (m, d, None)                  # experts over model (EP)
    if ndim == 3 and key == "wo":
        return (m, None, d)
    if key in ("w1", "w2") and parent == "projector":
        return (None, None)
    if key == "frontend_proj":
        return (None, None)
    if key == "wA":
        return (d, None)
    if key == "wB" and ndim == 2:
        return (None, m)
    return tuple([None] * min(ndim, 0) or [])  # replicate


QUANT_REPLICATE = False  # §Perf C2: replicate (tiny) packed weights


def param_pspec(path: str, leaf, fsdp: bool) -> Spec:
    """The spec of the parameter at key path ``path`` (``"blocks/0/attn/wq"``)."""
    parts = path.split("/")
    key = _key_of(parts)
    parent = _parent_key(parts)
    d = "data" if fsdp else None
    ndim = getattr(leaf, "ndim", 0)
    if key in ("packed", "scale") and QUANT_REPLICATE:
        return (None,) * ndim
    if key in ("packed", "scale"):
        # bit-packed projections: packed is (out, in/32) = TRANSPOSE of the
        # fp weight, so swap the fp rule's two axes.
        fp_key = parent
        base = _fp_spec(fp_key, _parent_key(parts[:-1]), 2, d, "model")
        a, b = (list(base) + [None, None])[:2]
        if key == "scale":
            return (b,)
        return (b, a)
    spec = _fp_spec(key, parent, ndim, d, "model")
    # pad the spec rank to the leaf rank
    entries = list(spec)
    if len(entries) < ndim:
        entries += [None] * (ndim - len(entries))
    return tuple(entries[:ndim]) if ndim else ()


def placements(spec: Spec, mesh) -> list:
    """A spec as the placements of ``mesh``: mesh dim ``a`` shards the
    tensor dim whose entry names ``a`` (alone or in a tuple), else
    replicates. A tuple entry shards one tensor dim over several mesh dims,
    the first named the outermost, as in the reference. A mesh dim of size
    1 replicates: one shard is the whole tensor."""
    out = []
    for i, axis in enumerate(mesh.mesh_dim_names):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1
                   else Replicate())
    return out


def mesh_einsum(spec: str, *ts):
    """``torch.einsum(spec, *ts)`` where an operand is a DTensor: each
    mesh dim shards one letter of the spec (or none) in every operand
    that has it and replicates the others; the einsum runs on the local
    shards, and the output is sharded on that letter, or a partial sum
    where it was contracted. Of the letters the operands shard on a mesh
    dim, the one that costs the fewest bytes wins (those redistributed,
    plus the output a rank holds: a contracted letter leaves the whole
    output's partial sum on every rank); the first operand's on a tie.
    Plain tensors count as replicated.

    DTensor itself runs an einsum as a ``bmm`` over the batch letters
    flattened into one dim, which older DTensor cannot do where two of
    them are sharded (batch over "data", heads over "model")."""
    from torch.distributed.tensor import DTensor

    mesh = next(t.device_mesh for t in ts if isinstance(t, DTensor))
    lhs, out = spec.replace(" ", "").split("->")
    subs = lhs.split(",")
    dts = []
    for t in ts:
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if any(p.is_partial() for p in t.placements):
            t = t.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in t.placements])
        dts.append(t)
    size = {c: n for t, sub in zip(dts, subs) for c, n in zip(sub, t.shape)}
    out_bytes = math.prod(size[c] for c in out) * dts[0].element_size()
    target, out_pl = [], []
    for m in range(mesh.ndim):
        options = [sub[t.placements[m].dim] for t, sub in zip(dts, subs)
                   if t.placements[m].is_shard()]

        def cost(c, m=m):    # bytes moved, and the output this rank holds
            held = out_bytes // mesh.size(m) if c is not None and c in out \
                else out_bytes
            return _relayout_bytes(dts, subs, m, c, mesh) + held
        best = min(dict.fromkeys(options + [None]), key=cost)
        target.append(best)
        out_pl.append(Replicate() if best is None else
                      Shard(out.index(best)) if best in out else Partial())
    moved = []
    for t, sub in zip(dts, subs):
        want = [Shard(sub.index(c)) if c is not None and c in sub
                else Replicate() for c in target]
        moved.append(t if list(t.placements) == want
                     else t.redistribute(mesh, want))
    # each operand's local gradient: sharded as the operand where it has
    # the letter, a partial sum where a rank sees only its part of the
    # letter (the operand is replicated, another operand sharded)
    grads = [[Shard(sub.index(c)) if c is not None and c in sub
              else Replicate() if c is None else Partial() for c in target]
             for sub in subs]
    # contiguous, as the global stride says (an einsum may return a view)
    local = torch.einsum(spec, *[t.to_local(grad_placements=g)
                                 for t, g in zip(moved, grads)]).contiguous()
    shape = torch.Size([size[c] for c in out])
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def mesh_embed(table, tokens):
    """``table[tokens]`` where ``table`` (V, d) is a DTensor: a mesh dim
    that shards the vocab looks up the rows this rank holds (the others 0)
    and leaves a partial sum; one that shards ``d`` where the tokens are
    sharded too gathers the table first (FSDP), else shards the output's
    ``d``. A mesh dim that shards the tokens shards the output's rows."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    t_pl, x_pl, out_pl = [], [], []
    for tp, xp in zip(table.placements, tokens.placements):
        if xp.is_shard() and tp.is_shard():   # FSDP: gather the table's d;
            if tp.dim == 1:                   # a vocab shard: the tokens
                tp = Replicate()
            else:
                xp = Replicate()
        t_pl.append(tp)
        x_pl.append(xp)
        out_pl.append(Partial() if tp.is_shard() and tp.dim == 0
                      else Shard(tokens.ndim) if tp.is_shard()
                      else xp)
    if list(table.placements) != t_pl:
        table = table.redistribute(mesh, t_pl)
    if list(tokens.placements) != x_pl:
        tokens = tokens.redistribute(mesh, x_pl)
    rows, off = compute_local_shape_and_global_offset(table.shape, mesh,
                                                      t_pl)
    ids = tokens.to_local()
    # a replicated table looked up by sharded tokens: a partial gradient
    local = table.to_local(grad_placements=[
        Partial() if tp.is_replicate() and xp.is_shard() else tp
        for tp, xp in zip(t_pl, x_pl)])
    if any(p.is_shard() and p.dim == 0 for p in t_pl):
        ids = ids - off[0]
        miss = (ids < 0) | (ids >= rows[0])
        out = local[ids.clamp(0, rows[0] - 1)].masked_fill(miss[..., None],
                                                             0)
    else:
        out = local[ids]
    shape = torch.Size(tuple(tokens.shape) + (table.shape[1],))
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def _relayout_bytes(dts, subs, m, letter, mesh) -> int:
    """Bytes the operands move on mesh dim ``m`` to be sharded on
    ``letter`` (or replicated, ``None``): a gather of a shard, or an
    all-to-all of one; a replicated operand splits for free."""
    n = mesh.size(m)
    total = 0
    for t, sub in zip(dts, subs):
        p = t.placements[m]
        has = letter is not None and letter in sub
        if not p.is_shard() or (has and p.dim == sub.index(letter)):
            continue
        local = t.numel() // n * t.element_size()
        total += local if has else local * (n - 1)
    return total


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _map_with_path(fn, tree, path=()):
    """``fn(key path, leaf)`` over the leaves of ``tree``, in its structure
    (``None`` holds no leaf, as in the reference's tree maps)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn("/".join(path), tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in kids}
    items = [_map_with_path(fn, v, path + (k,)) for k, v in kids]
    return type(tree)(*items) if hasattr(type(tree), "_fields") \
        else type(tree)(items)


def param_placements(params: Any, mesh, fsdp: bool = False) -> Any:
    """The tree of ``params`` with each leaf replaced by its placements."""
    return _map_with_path(
        lambda path, leaf: placements(param_pspec(path, leaf, fsdp), mesh),
        params)


def param_shardings(params: Any, mesh, fsdp: bool = False) -> Any:
    """The tree of ``params`` with each leaf replaced by ``(mesh, its
    placements)``: the ``shardings`` form of ``Checkpointer.restore`` and
    ``Trainer``."""
    return _map_with_path(
        lambda path, leaf: (mesh, placements(param_pspec(path, leaf, fsdp),
                                             mesh)), params)


def opt_shardings(p_shardings: Any, mesh) -> Any:
    """AdamW's state under ``p_shardings`` (the reference's
    ``_opt_shardings``): the step replicated, the moments as their
    parameters."""
    from ..optim.optimizer import AdamWState
    return AdamWState(step=(mesh, replicated(mesh)), mu=p_shardings,
                      nu=p_shardings)


def zip_map(fn, tree, placements):
    """``fn(tensor, its placements)`` over ``tree``, whose structure
    ``placements`` repeats with a placement list at each tensor."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, placements)
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, placements[k]) for k, v in tree.items()}
    items = [zip_map(fn, v, p) for v, p in zip(tree, placements)]
    return type(tree)(*items) if hasattr(type(tree), "_fields") \
        else type(tree)(items)


def redistribute_tree(tree, placements):
    """``tree``'s DTensors moved to ``placements``; plain tensors (the
    replicated step counter of a dry run) as they are."""
    from torch.distributed.tensor import DTensor
    return zip_map(lambda t, pl: t.redistribute(t.device_mesh, pl)
                   if isinstance(t, DTensor)
                   and list(t.placements) != list(pl) else t,
                   tree, placements)


def placements_of(tree) -> Any:
    """The placements of each DTensor leaf of ``tree`` (None for a plain
    tensor), in its structure."""
    from torch.distributed.tensor import DTensor
    return _map_with_path(lambda path, t: list(t.placements)
                          if isinstance(t, DTensor) else None, tree)


def match_placements(tree, like):
    """Each DTensor leaf of ``tree`` redistributed to the placements of
    the matching leaf of ``like``: the gradient of a parameter comes back
    in the layout its last op left (a replicated weight used on sharded
    rows: a partial sum), and an update mixing layouts would let DTensor
    pick the parameter's next one."""
    return redistribute_tree(tree, placements_of(like))


def batch_pspec(mesh) -> Spec:
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    return (dp,)


def _dp_size(mesh) -> int:
    size = mesh.size(mesh.mesh_dim_names.index("data"))
    if "pod" in mesh.mesh_dim_names:
        size *= mesh.size(mesh.mesh_dim_names.index("pod"))
    return size


def _dp0(mesh):
    return batch_pspec(mesh)[0]


def data_shardings(batch: Any, mesh) -> Any:
    dp0, dsz = _dp0(mesh), _dp_size(mesh)

    def one(path, leaf):
        nd = getattr(leaf, "ndim", 0)
        if nd and leaf.shape[0] % dsz == 0:
            return placements((dp0,) + (None,) * (nd - 1), mesh)
        return placements((None,) * nd, mesh)
    return _map_with_path(one, batch)


def cache_shardings(cache: Any, mesh) -> Any:
    """Decode caches: batch over dp, heads over model.

    k/v (B,S,H,hd) -> (dp,None,"model",None); SSM states (B,H,...) ->
    (dp,"model",...); tails (B,d) -> (dp,None); enc memory (B,T,d) ->
    (dp,None,None). When B doesn't divide dp (long_500k, B=1) the KV-cache
    SEQUENCE axis takes the dp shards instead (sequence-parallel decode) and
    per-batch states replicate across dp."""
    dp0, dsz = _dp0(mesh), _dp_size(mesh)

    def one(path, leaf):
        nd = leaf.ndim
        key = _key_of(path.split("/"))
        b_ok = nd >= 1 and leaf.shape[0] % dsz == 0
        bax = dp0 if b_ok else None
        if key in ("k", "v", "k_scale", "v_scale") and nd == 4:
            seq_ax = None if b_ok else (
                dp0 if leaf.shape[1] % dsz == 0 else None)
            spec = (bax, seq_ax, "model", None)
        elif key == "S" and nd >= 3:
            spec = (bax, "model") + (None,) * (nd - 2)
        elif key == "conv" and nd == 3:
            spec = (bax, None, "model")
        elif key == "enc_memory" and nd == 3:
            spec = (bax, None, None)
        elif nd >= 1:
            spec = (bax,) + (None,) * (nd - 1)
        else:
            spec = ()
        return placements(spec, mesh)
    return _map_with_path(one, cache)


def logits_sharding(mesh, batch: int = 0) -> list:
    dp0, dsz = _dp0(mesh), _dp_size(mesh)
    if batch and batch % dsz != 0:
        return placements((None, None, "model"), mesh)
    return placements((dp0, None, "model"), mesh)


def replicated(mesh) -> list:
    return [Replicate()] * mesh.ndim
