"""Fused per-layer kernels: one launch per GNN layer (reference:
``repro/kernels/fused_layer.py``).

The reference evaluates any layer function inside one ``pallas_call``
(``fused_call`` replays its jaxpr). CUDA has no such replay, so the port
fuses per layer KIND, the four the model families compose
(``models/gnn.py``), each one launch of ``csrc/fused_layer.cu``:

* :func:`gcn_bin_l1` — BN -> BMM.FBB -> BSpMM.BBB -> packed sign words (GCN
  "bin" layer 1);
* :func:`gcn_bbf_fbf` — [BN -> quantize_act] -> BMM.BBF -> BSpMM.FBF [->
  ReLU] (GCN "full" layers; GCN "bin" layer 2 takes the packed words with
  unit scales and no BN);
* :func:`branch_add` — BN -> quantize_act -> BMM.BBF self + BSpMM.FBF(BMM.BBF
  agg) [-> ReLU] (SAGE / SAINT layers);
* :func:`fc` — BN -> quantize_act -> BMM.BBF (SAINT's last layer).

The CUDA kernel is cooperative: a transform phase (one block per row
tile: a register-tiled fp32 GEMM for BMM.FBB; quantize_act into a shared
tile and the b1 tensor-core XNOR-popc tile of ``csrc/xnor.cuh`` for
BMM.BBF), a grid barrier, per work item partial sums of the aggregation
(at most ``GROUPS_PER_ITEM`` groups of one tile-row), a barrier, and a
combine phase that adds each tile-row's items in item order. Its launcher
sizes the shared memory and the grid. On a CPU tensor each kind runs its
plain version: the same transform with PyTorch ops, then
:func:`agg_fp` / :func:`agg_counts`, the BSpMM plain versions of
``bspmm_kernel`` (the order of the sums does not change the integer
counts, and fp results are held to a tolerance of their sum of |terms|).

The sharded executors' step (the reference's ``fused_call`` of BN ->
transform -> ``agg(intra, y) + agg(halo, rem)`` -> post) is two launches:
:func:`transform`, the layer kernel's transform alone (``aggregate = 0``),
whose rows the shards exchange, and :func:`pair`, ``csrc/fused_pair.cu``,
which walks the intra adjacency over those rows and the halo adjacency
over the exchanged rows ``rem`` side by side, adds the halo sums to the
intra sums, applies the shared row scale once and then the self branch
and the ReLU, or the sign (plain: :func:`pair_plain`, on
:func:`agg_fp_pair` / :func:`agg_counts_pair`). Each kind with
``halo``/``rem`` is that step. ``bn_rcp`` takes BN as the executors'
``(x - mu) * (1 / sd)``.

:data:`KERNEL_CALLS` counts fused layers (``fused``) and the aggregations
folded into them (``fused_aggs``) on either device, as the reference's
trace-time counters do; :data:`LAUNCHES` counts CUDA launches, and
:data:`ENTRIES` the entries into the two kernels on either device (a
sharded step is two: its transform and its pair).
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Dict, NamedTuple, Optional

import torch

from ..core import bitops
from ..core.frdc import FRDCMatrix, TILE
from . import bmm_kernel, build, counting, pack_kernel
from .bspmm_kernel import GROUPS_PER_ITEM, TRINARY_MODES, WORD, _check_adj, \
    bspmm_bits_plain, bspmm_fp_plain, fp_layout, max_items, work_items

if TYPE_CHECKING:   # core.binarize imports kernels.ops, which imports this
    from ..core.binarize import BinTensor

KERNEL_CALLS = {"fused": 0, "fused_aggs": 0}
# CUDA launches (plain calls not counted): every launch of the layer kernel
# and of the pair kernel, and apart the sharded executors' forms: the pair
# step of each kind (its fused_pair launch), fc with BN by the reciprocal,
# and the transform alone
PAIR_FORMS = ("gcn_bin_l1+halo", "gcn_bbf_fbf+halo", "branch_add+halo",
              "fc+rcp", "transform")
LAUNCHES = {"fused_layer": 0, "fused_pair": 0,
            **{f"fused_layer/{k}": 0 for k in PAIR_FORMS}}
ENTRIES = {"fused_layer": 0, "fused_pair": 0}   # ``counting``


def reset_counters() -> None:
    KERNEL_CALLS["fused"] = 0
    KERNEL_CALLS["fused_aggs"] = 0


# ---------------------------------------------------------------------------
# The plain aggregation stages
# ---------------------------------------------------------------------------

def agg_fp(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain aggregation stage of a fused layer, the twin of
    ``ops.bspmm_fp``: column scale folded into x, raw sums, crop, row
    scale."""
    KERNEL_CALLS["fused_aggs"] += 1
    if adj.col_scale is not None:
        x = x * adj.col_scale[:, None].to(x.dtype)
    out = bspmm_fp_plain(adj, x)[: adj.n_rows]
    if adj.row_scale is not None:
        out = out * adj.row_scale[:, None].to(out.dtype)
    return out


def agg_counts(adj: FRDCMatrix, x_packed: torch.Tensor,
               trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """Plain trinary-counts stage of a fused layer: raw counts cropped to
    the real rows, (n_rows, Wf*32) int32."""
    KERNEL_CALLS["fused_aggs"] += 1
    return bspmm_bits_plain(adj, x_packed, x_packed.shape[1] * WORD, False,
                            trinary_mode)[: adj.n_rows]


def agg_fp_pair(intra: FRDCMatrix, halo: FRDCMatrix, x_local: torch.Tensor,
                x_remote: torch.Tensor) -> torch.Tensor:
    """Plain intra+halo stage of a sharded fp layer, the twin of
    ``ops.serve_fp_pair``: each column scale folded into its own operand,
    the two raw sums added, then the shared row scale applied once."""
    y = agg_fp(intra._replace(row_scale=None), x_local) \
        + agg_fp(halo._replace(row_scale=None), x_remote)
    if intra.row_scale is not None:
        y = y * intra.row_scale[:, None].to(y.dtype)
    return y


def agg_counts_pair(intra: FRDCMatrix, halo: FRDCMatrix,
                    xp_local: torch.Tensor, xp_remote: torch.Tensor,
                    trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """Plain intra+halo stage of the sharded packed layer: the two integer
    count sums added (exact in any order)."""
    return agg_counts(intra, xp_local, trinary_mode) \
        + agg_counts(halo, xp_remote, trinary_mode)


# ---------------------------------------------------------------------------
# Plain versions of the four layer kinds
# ---------------------------------------------------------------------------

def _bn(x: torch.Tensor, bn, rcp: bool = False) -> torch.Tensor:
    """Frozen BN: ``(x - mu) / sd``, or with ``rcp`` the sharded executors'
    ``(x - mu) * (1.0 / sd)`` (``session_core.apply_bn``)."""
    if bn is None:
        return x
    mu, sd = bn
    return (x - mu) * (1.0 / sd) if rcp else (x - mu) / sd


def _quantize(z: torch.Tensor):
    """quantize_act: sign words and the per-row mean |z|."""
    return pack_kernel.binarize_pack_plain(z), z.abs().mean(dim=-1,
                                                             keepdim=True)


def _bbf(words: torch.Tensor, xs, w: BinTensor) -> torch.Tensor:
    """BMM.BBF: XNOR-popc counts times the row and weight scales."""
    counts = bmm_kernel.bmm_xnor_plain(words, w.packed, w.n).to(torch.float32)
    return counts * xs * w.scale.reshape(1, -1)


def _input(h: torch.Tensor, bn, rcp: bool = False):
    """(sign words, row scales) of a layer input: fp rows go through BN and
    quantize_act; int32 rows are packed words with unit scales."""
    if h.dtype == torch.int32:
        return h, h.new_ones((h.shape[0], 1), dtype=torch.float32)
    return _quantize(_bn(h, bn, rcp))


def _fbb(x, bn, w: BinTensor, rcp: bool = False) -> torch.Tensor:
    """BMM.FBB: sign words of BN(x) times the dequantized weights."""
    w_eff = (bitops.unpack_pm1(w.packed, w.n) * w.scale).T
    return pack_kernel.binarize_pack_plain(_bn(x, bn, rcp) @ w_eff)


def pair_plain(y: torch.Tensor, ys: Optional[torch.Tensor],
               rem: torch.Tensor, intra: FRDCMatrix, halo: FRDCMatrix,
               relu: bool = False, n_out: Optional[int] = None,
               trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """The pair step's aggregation and epilogue on the transform's outputs,
    in the kernel's order: fp rows ``y`` give ``agg_fp_pair`` (each column
    scale on its own rows, the raw sums added, the row scale once), then
    ``ys + v`` and the ReLU; sign words give the signs of
    ``agg_counts_pair`` over the first ``n_out`` features."""
    if y.dtype == torch.int32:
        counts = agg_counts_pair(intra, halo, y, rem, trinary_mode)
        return bitops.pack_bits(counts[:, :n_out] >= 0, axis=-1)
    out = agg_fp_pair(intra, halo, y, rem)
    if ys is not None:
        out = ys + out
    return torch.relu(out) if relu else out


def gcn_bin_l1_plain(x, bn, w: BinTensor, adj: FRDCMatrix,
                     trinary_mode: str = "s3_two_popc",
                     halo: Optional[FRDCMatrix] = None,
                     rem: Optional[torch.Tensor] = None,
                     bn_rcp: bool = False) -> torch.Tensor:
    hb = _fbb(x, bn, w, bn_rcp)
    n_out = w.packed.shape[0]
    if halo is not None:
        return pair_plain(hb, None, rem, adj, halo, n_out=n_out,
                          trinary_mode=trinary_mode)
    counts = agg_counts(adj, hb, trinary_mode)
    return bitops.pack_bits(counts[:, :n_out] >= 0, axis=-1)


def gcn_bbf_fbf_plain(h, bn, w: BinTensor, adj: FRDCMatrix,
                      relu: bool = False, halo: Optional[FRDCMatrix] = None,
                      rem: Optional[torch.Tensor] = None,
                      bn_rcp: bool = False) -> torch.Tensor:
    words, xs = _input(h, bn, bn_rcp)
    y = _bbf(words, xs, w)
    if halo is not None:
        return pair_plain(y, None, rem, adj, halo, relu)
    out = agg_fp(adj, y)
    return torch.relu(out) if relu else out


def branch_add_plain(h, bn, w_self: BinTensor, w_agg: BinTensor,
                     adj: FRDCMatrix, relu: bool = False,
                     halo: Optional[FRDCMatrix] = None,
                     rem: Optional[torch.Tensor] = None,
                     bn_rcp: bool = False) -> torch.Tensor:
    words, xs = _input(h, bn, bn_rcp)
    ys, y = _bbf(words, xs, w_self), _bbf(words, xs, w_agg)
    if halo is not None:
        return pair_plain(y, ys, rem, adj, halo, relu)
    out = ys + agg_fp(adj, y)
    return torch.relu(out) if relu else out


def fc_plain(h, bn, w: BinTensor, bn_rcp: bool = False) -> torch.Tensor:
    words, xs = _input(h, bn, bn_rcp)
    return _bbf(words, xs, w)


def transform_plain(h, bn, w: BinTensor, fbb: bool = False,
                    bn_rcp: bool = False,
                    w_self: Optional[BinTensor] = None):
    """A layer's transform alone: BMM.FBB sign words, or BMM.BBF rows; with
    ``w_self`` the pair (rows, self branch rows)."""
    if fbb:
        return _fbb(h, bn, w, bn_rcp)
    if w_self is None:
        return fc_plain(h, bn, w, bn_rcp)
    words, xs = _input(h, bn, bn_rcp)
    return _bbf(words, xs, w), _bbf(words, xs, w_self)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _Params(ctypes.Structure):
    """Mirror of ``Params`` in ``csrc/fused_layer.cu`` (same field order)."""
    _fields_ = [
        ("x", _P), ("xw", _P), ("mu", _P), ("sd", _P),
        ("n_in", _L), ("f", _I), ("wk", _I), ("bn_rcp", _I),
        ("w_a", _P), ("s_a", _P), ("w_s", _P), ("s_s", _P),
        ("ho", _I), ("fbb", _I), ("aggregate", _I), ("s2", _I), ("relu", _I),
        ("grp_ptr", _P), ("tiles", _P), ("col_idx", _P), ("item_ptr", _P),
        ("row_scale", _P), ("col_scale", _P),
        ("n_tile_rows", _I), ("n_rows", _L), ("chunk", _I),
        ("y", _P), ("ys", _P), ("part", _P), ("out", _P),
        ("fp_sub", _I), ("fp_cols", _I), ("fp_vec", _I),
    ]


class _PairParams(ctypes.Structure):
    """Mirror of ``Params`` in ``csrc/fused_pair.cu`` (same field order)."""
    _fields_ = [
        ("grp_ptr", _P), ("tiles", _P), ("col_idx", _P), ("col_scale", _P),
        ("h_grp_ptr", _P), ("h_tiles", _P), ("h_col_idx", _P),
        ("h_col_scale", _P), ("row_scale", _P),
        ("tasks", _P), ("row_done", _P), ("part", _P),
        ("y", _P), ("rem", _P), ("ys", _P), ("out", _P),
        ("n_y", _L), ("n_rem", _L), ("n_rows", _L),
        ("n_tile_rows", _I), ("n_tasks", _I), ("ho", _I), ("chunk", _I),
        ("fbb", _I), ("s2", _I), ("relu", _I),
        ("fp_sub", _I), ("fp_cols", _I), ("fp_vec", _I),
    ]


MAX_IN_WORDS = 128   # csrc/fused_layer.cu kMaxWords
MAX_OUT = 256        # 32 * kMaxChunks


def attributes(f: int, fbb: bool = False,
               self_branch: bool = False) -> Dict[str, int]:
    """Registers, static and dynamic shared memory and resident blocks per
    SM of the fused kernel when its transform takes ``f`` features in
    BMM.FBB (``fbb``) or BMM.BBF, with the self branch's weights or
    without (the dynamic shared memory depends on these alone)."""
    return build.attributes("fused_layer", "fused_layer", f, int(fbb),
                            int(self_branch))


def pair_attributes(ho: int, fbb: bool = False) -> Dict[str, int]:
    """The same for the pair kernel built for ``ho`` output columns: its fp
    instance (the lane layout of aligned rows), or its counts instance
    (``fbb``)."""
    if fbb:
        return build.attributes("fused_pair", "fused_pair_bits",
                                -(-ho // WORD), 0)
    lay = fp_layout(ho, ho, 0)
    return build.attributes("fused_pair", "fused_pair_fp", lay.sub, lay.cols,
                            int(lay.vec))


def _ptr(t: Optional[torch.Tensor], dev, dtype, what: str):
    if t is None:
        return None
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"fused layer: {what} must be contiguous {dtype} on "
                         f"{dev}, got {t.dtype} on {t.device}")
    return t.data_ptr()


def _launch(h: torch.Tensor, bn, w_a: BinTensor, adj: Optional[FRDCMatrix],
            w_s: Optional[BinTensor] = None, fbb: bool = False,
            relu: bool = False, trinary_mode: str = "s3_two_popc",
            item_ptr: Optional[torch.Tensor] = None,
            bn_rcp: bool = False, form: Optional[str] = None):
    """One fused launch (``form``: its :data:`PAIR_FORMS` counter). Without
    ``adj`` the kernel stops after its transform and returns it: BMM.FBB
    sign words, or BMM.BBF rows, and with ``w_s`` the pair (rows, self
    branch rows)."""
    dev = h.device
    if h.ndim != 2 or h.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"fused layer takes 2-D float32 rows or int32 words, "
                         f"got {h.dtype} {tuple(h.shape)}")
    if trinary_mode not in TRINARY_MODES:
        raise ValueError(trinary_mode)
    packed_in = h.dtype == torch.int32
    h = h.contiguous()
    n_in = h.shape[0]
    ho, wk = w_a.packed.shape
    f = int(w_a.n)
    if wk > MAX_IN_WORDS or ho > MAX_OUT or (fbb and packed_in):
        raise ValueError(f"fused layer: input width {f} / output width {ho} "
                         f"beyond the kernel's {MAX_IN_WORDS * WORD} / "
                         f"{MAX_OUT}")
    if h.shape[1] != (wk if packed_in else f):
        raise ValueError(f"fused layer: input width {h.shape[1]} does not "
                         f"match the weights ({f} features)")
    p = _Params()
    keep = []   # tensors whose pointers the struct holds

    def hold(t):
        keep.append(t)
        return t

    if packed_in:
        p.xw = _ptr(h, dev, torch.int32, "input words")
    else:
        p.x = _ptr(h, dev, torch.float32, "input rows")
        if bn is not None:
            sd = bn[1].reshape(-1)
            p.mu = _ptr(hold(bn[0].reshape(-1).contiguous()), dev,
                        torch.float32, "BN mean")
            # the reciprocal as apply_bn takes it: one IEEE division here
            p.sd = _ptr(hold((1.0 / sd if bn_rcp else sd).contiguous()), dev,
                        torch.float32, "BN sd")
            p.bn_rcp = int(bn_rcp)
    p.n_in, p.f, p.wk, p.ho = n_in, f, wk, ho
    p.w_a = _ptr(w_a.packed, dev, torch.int32, "weights")
    p.s_a = _ptr(hold(w_a.scale.reshape(-1).contiguous()), dev, torch.float32,
                 "weight scales")
    ys = None
    if w_s is not None:
        p.w_s = _ptr(w_s.packed, dev, torch.int32, "self weights")
        p.s_s = _ptr(hold(w_s.scale.reshape(-1).contiguous()), dev,
                     torch.float32, "self weight scales")
        ys = torch.empty((n_in, ho), dtype=torch.float32, device=dev)
        p.ys = ys.data_ptr()
    p.fbb, p.relu = int(fbb), int(relu)
    p.s2 = int(trinary_mode == "s2_and_andnot")
    wh = -(-ho // WORD)
    if adj is None:
        out = torch.empty((n_in, wh if fbb else ho),
                          dtype=torch.int32 if fbb else torch.float32,
                          device=dev)
        if fbb:
            p.y = out.data_ptr()
    else:
        _check_adj(adj, h, "fused layer")
        if adj.n_cols != n_in or (w_s is not None and adj.n_rows != n_in):
            raise ValueError(f"fused layer: {n_in} input rows for a "
                             f"({adj.n_rows}, {adj.n_cols}) adjacency")
        if item_ptr is None:
            item_ptr = work_items(adj.grp_ptr)
        width = wh * WORD if fbb else ho
        kind = torch.int32 if fbb else torch.float32
        p.aggregate = 1
        p.grp_ptr, p.tiles = adj.grp_ptr.data_ptr(), adj.tiles.data_ptr()
        p.col_idx = adj.col_idx.data_ptr()
        p.item_ptr = _ptr(item_ptr, dev, torch.int32, "item_ptr")
        p.row_scale = _ptr(adj.row_scale, dev, torch.float32, "row scale")
        p.col_scale = _ptr(adj.col_scale, dev, torch.float32, "col scale")
        p.n_tile_rows, p.n_rows = adj.n_tile_rows, adj.n_rows
        p.chunk = GROUPS_PER_ITEM
        y = hold(torch.empty((n_in, wh if fbb else ho), dtype=kind,
                             device=dev))
        p.y = y.data_ptr()
        p.fp_sub, p.fp_cols, p.fp_vec = fp_layout(ho, ho, p.y)
        p.part = hold(torch.empty(max_items(adj) * TILE * width, dtype=kind,
                                  device=dev)).data_ptr()
        out = torch.empty((adj.n_rows, wh if fbb else ho), dtype=kind,
                          device=dev)
    p.out = out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library("fused_layer").fused_layer(
        ctypes.byref(p), stream), "fused_layer")
    LAUNCHES["fused_layer"] += 1
    if form is not None:
        LAUNCHES[f"fused_layer/{form}"] += 1
    if adj is not None:
        KERNEL_CALLS["fused_aggs"] += 1
    elif ys is not None:
        return out, ys
    return out


class PairItems(NamedTuple):
    """The pair kernel's work of one shard (:func:`pair_items`)."""
    tasks: torch.Tensor   # (n_tasks, 2) int32: (tile-row, item or -1)
    n_part: int           # the heavy rows' item tasks, first in the list


def pair_items(intra: FRDCMatrix, halo: FRDCMatrix) -> PairItems:
    """The pair kernel's task list over the two matrices' tile-rows, built
    once per plan (its length costs a device sync). A tile-row has
    ``max(1, ceil(groups / GROUPS_PER_ITEM))`` items in each matrix
    (``work_items``). One with a single intra item and a single halo item
    is one task, ``(row, -1)``; each item of any other row is a task
    ``(row, k)``, its intra items ``k < n_intra`` then its halo items,
    those rows first and in order."""
    if halo.n_tile_rows != intra.n_tile_rows:
        raise ValueError(f"pair: {intra.n_tile_rows} intra and "
                         f"{halo.n_tile_rows} halo tile-rows")
    n_i = torch.diff(work_items(intra.grp_ptr)).long()
    n_h = torch.diff(work_items(halo.grp_ptr)).long()
    rows = torch.arange(intra.n_tile_rows, device=n_i.device)
    heavy = (n_i > 1) | (n_h > 1)
    per = (n_i + n_h)[heavy]
    item_rows = torch.repeat_interleave(rows[heavy], per)
    first = torch.repeat_interleave(torch.cumsum(per, 0) - per, per)
    k = torch.arange(item_rows.numel(), device=rows.device) - first
    light = rows[~heavy]
    tasks = torch.cat([torch.stack([item_rows, k], 1),
                       torch.stack([light, torch.full_like(light, -1)], 1)])
    return PairItems(tasks.to(torch.int32).contiguous(), item_rows.numel())


def _pair_launch(y: torch.Tensor, ys: Optional[torch.Tensor],
                 rem: torch.Tensor, intra: FRDCMatrix, halo: FRDCMatrix,
                 items: Optional[PairItems], relu: bool, n_out: Optional[int],
                 trinary_mode: str) -> torch.Tensor:
    """One launch of ``csrc/fused_pair.cu``."""
    dev = y.device
    fbb = y.dtype == torch.int32
    kind = y.dtype
    if y.ndim != 2 or kind not in (torch.float32, torch.int32) \
            or rem.ndim != 2 or rem.dtype != kind \
            or rem.shape[1] != y.shape[1]:
        raise ValueError(f"pair: y {y.dtype} {tuple(y.shape)} and rem "
                         f"{rem.dtype} {tuple(rem.shape)} must be 2-D float32 "
                         f"rows or int32 words of one width")
    if trinary_mode not in TRINARY_MODES:
        raise ValueError(trinary_mode)
    ho = y.shape[1] if not fbb else n_out
    if ho is None or not 0 < ho <= y.shape[1] * (WORD if fbb else 1) \
            or (fbb and -(-ho // WORD) != y.shape[1]):
        raise ValueError(f"pair: {n_out} output features for y of width "
                         f"{y.shape[1]}")
    _check_adj(intra, y, "pair intra")
    _check_adj(halo, y, "pair halo")
    if intra.n_cols != y.shape[0] or halo.n_rows != intra.n_rows \
            or rem.shape[0] < halo.n_cols:
        raise ValueError(f"pair: a ({intra.n_rows}, {intra.n_cols}) intra and "
                         f"a ({halo.n_rows}, {halo.n_cols}) halo adjacency "
                         f"for y {tuple(y.shape)} and rem {tuple(rem.shape)}")
    if ys is not None and (fbb or tuple(ys.shape) != (intra.n_rows, ho)):
        raise ValueError(f"pair: self branch {tuple(ys.shape)} for "
                         f"{intra.n_rows} rows of width {ho}")
    if items is None:
        items = pair_items(intra, halo)
    y, rem = y.contiguous(), rem.contiguous()
    p = _PairParams()
    keep = []   # scratch whose pointers the struct holds
    p.grp_ptr, p.tiles = intra.grp_ptr.data_ptr(), intra.tiles.data_ptr()
    p.col_idx = intra.col_idx.data_ptr()
    p.h_grp_ptr, p.h_tiles = halo.grp_ptr.data_ptr(), halo.tiles.data_ptr()
    p.h_col_idx = halo.col_idx.data_ptr()
    if not fbb:
        p.col_scale = _ptr(intra.col_scale, dev, torch.float32, "col scale")
        p.h_col_scale = _ptr(halo.col_scale, dev, torch.float32,
                             "halo col scale")
        p.row_scale = _ptr(intra.row_scale, dev, torch.float32, "row scale")
        p.ys = _ptr(ys, dev, torch.float32, "self branch")
    p.tasks = _ptr(items.tasks, dev, torch.int32, "tasks")
    wh = -(-ho // WORD)
    if items.n_part:
        keep.append(torch.empty(intra.n_tile_rows, dtype=torch.int32,
                                device=dev))
        p.row_done = keep[-1].data_ptr()
        keep.append(torch.empty(items.n_part * TILE * (wh * WORD if fbb
                                                       else ho),
                                dtype=kind, device=dev))
        p.part = keep[-1].data_ptr()
    p.y, p.rem = y.data_ptr(), rem.data_ptr()
    out = torch.empty((intra.n_rows, wh if fbb else ho), dtype=kind,
                      device=dev)
    p.out = out.data_ptr()
    p.n_y, p.n_rem, p.n_rows = y.shape[0], rem.shape[0], intra.n_rows
    p.n_tile_rows, p.n_tasks = intra.n_tile_rows, items.tasks.shape[0]
    p.ho, p.chunk = ho, GROUPS_PER_ITEM
    p.fbb, p.relu = int(fbb), int(relu)
    p.s2 = int(trinary_mode == "s2_and_andnot")
    # vector loads only where both row sets are aligned to them
    p.fp_sub, p.fp_cols, p.fp_vec = fp_layout(ho, ho, p.y | p.rem)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library("fused_pair").fused_pair(
        ctypes.byref(p), stream), "fused_pair")
    return out


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"repro_torch has no kernels for device {t.device}")


# ---------------------------------------------------------------------------
# Entry points: one fused layer each, and the sharded step's two launches
# ---------------------------------------------------------------------------
# ``halo``/``rem``/``pair_items``: the sharded executors' step, the halo
# adjacency of this shard's rows (columns: its halo nodes), the exchanged
# rows of those nodes (the same transform, computed by their owners with
# :func:`transform`) and the step's :func:`pair_items`; the kind then runs
# as :func:`transform` and :func:`pair`. ``bn_rcp`` takes the executors'
# BN by the reciprocal.

def transform(h: torch.Tensor, bn, w: BinTensor, fbb: bool = False,
              bn_rcp: bool = False, w_self: Optional[BinTensor] = None):
    """A fused layer's transform alone (the kernel with ``aggregate = 0``):
    BMM.FBB sign words (``fbb``) or BMM.BBF rows, and with ``w_self`` the
    pair (rows, self branch rows) of one launch. The sharded executors
    exchange the rows, so that a remote row is the very row its owner's
    step computes for itself."""
    with counting.entry(ENTRIES, "fused_layer"):
        if _on_card(h):
            return _launch(h, bn, w, None, w_s=w_self, fbb=fbb,
                           bn_rcp=bn_rcp, form="transform")
        return transform_plain(h, bn, w, fbb, bn_rcp, w_self)


def pair(y: torch.Tensor, ys: Optional[torch.Tensor], rem: torch.Tensor,
         intra: FRDCMatrix, halo: FRDCMatrix,
         items: Optional[PairItems] = None, relu: bool = False,
         n_out: Optional[int] = None,
         trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """The sharded step's aggregation and epilogue on its transform
    (:func:`transform`): ``y`` the shard's rows (BMM.BBF fp rows, or
    BMM.FBB sign words of ``n_out`` features), ``ys`` the self branch or
    None, ``rem`` the exchanged rows of the halo nodes; ``items`` from
    :func:`pair_items` (built here when None). One ``fused_pair`` launch,
    counted under the kind's form (``fused_layer/<kind>+halo``)."""
    KERNEL_CALLS["fused"] += 1
    with counting.entry(ENTRIES, "fused_pair"):
        if not _on_card(y):
            return pair_plain(y, ys, rem, intra, halo, relu, n_out,
                              trinary_mode)
        out = _pair_launch(y, ys, rem, intra, halo, items, relu, n_out,
                           trinary_mode)
    kind = "gcn_bin_l1" if y.dtype == torch.int32 else \
        "gcn_bbf_fbf" if ys is None else "branch_add"
    LAUNCHES["fused_pair"] += 1
    LAUNCHES[f"fused_layer/{kind}+halo"] += 1
    KERNEL_CALLS["fused_aggs"] += 2
    return out


def gcn_bin_l1(x: torch.Tensor, bn, w: BinTensor, adj: FRDCMatrix,
               trinary_mode: str = "s3_two_popc",
               item_ptr: Optional[torch.Tensor] = None,
               halo: Optional[FRDCMatrix] = None,
               rem: Optional[torch.Tensor] = None,
               pair_items: Optional[PairItems] = None,
               bn_rcp: bool = False) -> torch.Tensor:
    """GCN "bin" layer 1: BN -> BMM.FBB -> BSpMM.BBB over the 0/1 adjacency;
    returns (n_rows, ceil(H/32)) int32 sign words (unit scales)."""
    if halo is not None:
        return pair(transform(x, bn, w, fbb=True, bn_rcp=bn_rcp), None, rem,
                    adj, halo, pair_items, n_out=w.packed.shape[0],
                    trinary_mode=trinary_mode)
    KERNEL_CALLS["fused"] += 1
    with counting.entry(ENTRIES, "fused_layer"):
        if _on_card(x):
            return _launch(x, bn, w, adj, fbb=True,
                           trinary_mode=trinary_mode, item_ptr=item_ptr,
                           bn_rcp=bn_rcp)
        return gcn_bin_l1_plain(x, bn, w, adj, trinary_mode, bn_rcp=bn_rcp)


def gcn_bbf_fbf(h: torch.Tensor, bn, w: BinTensor, adj: FRDCMatrix,
                relu: bool = False,
                item_ptr: Optional[torch.Tensor] = None,
                halo: Optional[FRDCMatrix] = None,
                rem: Optional[torch.Tensor] = None,
                pair_items: Optional[PairItems] = None,
                bn_rcp: bool = False) -> torch.Tensor:
    """[BN -> quantize_act] -> BMM.BBF -> BSpMM.FBF [-> ReLU]; ``h`` is fp
    rows, or int32 sign words with unit scales (``bn`` None)."""
    if halo is not None:
        return pair(transform(h, bn, w, bn_rcp=bn_rcp), None, rem, adj, halo,
                    pair_items, relu)
    KERNEL_CALLS["fused"] += 1
    with counting.entry(ENTRIES, "fused_layer"):
        if _on_card(h):
            return _launch(h, bn, w, adj, relu=relu, item_ptr=item_ptr,
                           bn_rcp=bn_rcp)
        return gcn_bbf_fbf_plain(h, bn, w, adj, relu, bn_rcp=bn_rcp)


def branch_add(h: torch.Tensor, bn, w_self: BinTensor, w_agg: BinTensor,
               adj: FRDCMatrix, relu: bool = False,
               item_ptr: Optional[torch.Tensor] = None,
               halo: Optional[FRDCMatrix] = None,
               rem: Optional[torch.Tensor] = None,
               pair_items: Optional[PairItems] = None,
               bn_rcp: bool = False) -> torch.Tensor:
    """BN -> quantize_act -> BMM.BBF self + BSpMM.FBF(BMM.BBF agg) [-> ReLU]."""
    if halo is not None:
        y, ys = transform(h, bn, w_agg, bn_rcp=bn_rcp, w_self=w_self)
        return pair(y, ys, rem, adj, halo, pair_items, relu)
    KERNEL_CALLS["fused"] += 1
    with counting.entry(ENTRIES, "fused_layer"):
        if _on_card(h):
            return _launch(h, bn, w_agg, adj, w_s=w_self, relu=relu,
                           item_ptr=item_ptr, bn_rcp=bn_rcp)
        return branch_add_plain(h, bn, w_self, w_agg, adj, relu,
                                bn_rcp=bn_rcp)


def fc(h: torch.Tensor, bn, w: BinTensor, bn_rcp: bool = False
       ) -> torch.Tensor:
    """BN -> quantize_act -> BMM.BBF."""
    KERNEL_CALLS["fused"] += 1
    with counting.entry(ENTRIES, "fused_layer"):
        if _on_card(h):
            return _launch(h, bn, w, None, bn_rcp=bn_rcp,
                           form="fc+rcp" if bn_rcp else None)
        return fc_plain(h, bn, w, bn_rcp)
