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
transform -> ``agg(intra, y) + agg(halo, rem)`` -> post) is each kind with
``halo``/``rem``: the kernel walks the halo adjacency's items over the
exchanged rows ``rem`` beside the intra items over its own transform, adds
the halo sums to the intra sums and applies the shared row scale once
(plain: :func:`agg_fp_pair`, :func:`agg_counts_pair`); ``bn_rcp`` takes
BN as the executors' ``(x - mu) * (1 / sd)``; :func:`transform` is the
kernel's transform alone, the rows the shards exchange.

:data:`KERNEL_CALLS` counts fused layers (``fused``) and the aggregations
folded into them (``fused_aggs``) on either device, as the reference's
trace-time counters do; :data:`LAUNCHES` counts CUDA launches.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Dict, Optional

import torch

from ..core import bitops
from ..core.frdc import FRDCMatrix, TILE
from . import bmm_kernel, build, pack_kernel
from .bspmm_kernel import GROUPS_PER_ITEM, TRINARY_MODES, WORD, _check_adj, \
    bspmm_bits_plain, bspmm_fp_plain, fp_layout, max_items, work_items

if TYPE_CHECKING:   # core.binarize imports kernels.ops, which imports this
    from ..core.binarize import BinTensor

KERNEL_CALLS = {"fused": 0, "fused_aggs": 0}
# CUDA launches (plain calls not counted): every launch, and apart the
# sharded executors' forms: each kind with the halo pair, fc with BN by
# the reciprocal, and the transform alone
PAIR_FORMS = ("gcn_bin_l1+halo", "gcn_bbf_fbf+halo", "branch_add+halo",
              "fc+rcp", "transform")
LAUNCHES = {"fused_layer": 0, **{f"fused_layer/{k}": 0 for k in PAIR_FORMS}}


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


def _agg(adj, y, halo, rem):
    """fp aggregation over one adjacency, or over the intra+halo pair."""
    return agg_fp(adj, y) if halo is None else agg_fp_pair(adj, halo, y, rem)


def gcn_bin_l1_plain(x, bn, w: BinTensor, adj: FRDCMatrix,
                     trinary_mode: str = "s3_two_popc",
                     halo: Optional[FRDCMatrix] = None,
                     rem: Optional[torch.Tensor] = None,
                     bn_rcp: bool = False) -> torch.Tensor:
    hb = _fbb(x, bn, w, bn_rcp)
    counts = agg_counts(adj, hb, trinary_mode) if halo is None \
        else agg_counts_pair(adj, halo, hb, rem, trinary_mode)
    return bitops.pack_bits(counts[:, :w.packed.shape[0]] >= 0, axis=-1)


def gcn_bbf_fbf_plain(h, bn, w: BinTensor, adj: FRDCMatrix,
                      relu: bool = False, halo: Optional[FRDCMatrix] = None,
                      rem: Optional[torch.Tensor] = None,
                      bn_rcp: bool = False) -> torch.Tensor:
    words, xs = _input(h, bn, bn_rcp)
    out = _agg(adj, _bbf(words, xs, w), halo, rem)
    return torch.relu(out) if relu else out


def branch_add_plain(h, bn, w_self: BinTensor, w_agg: BinTensor,
                     adj: FRDCMatrix, relu: bool = False,
                     halo: Optional[FRDCMatrix] = None,
                     rem: Optional[torch.Tensor] = None,
                     bn_rcp: bool = False) -> torch.Tensor:
    words, xs = _input(h, bn, bn_rcp)
    out = _bbf(words, xs, w_self) + _agg(adj, _bbf(words, xs, w_agg), halo,
                                         rem)
    return torch.relu(out) if relu else out


def fc_plain(h, bn, w: BinTensor, bn_rcp: bool = False) -> torch.Tensor:
    words, xs = _input(h, bn, bn_rcp)
    return _bbf(words, xs, w)


def transform_plain(h, bn, w: BinTensor, fbb: bool = False,
                    bn_rcp: bool = False) -> torch.Tensor:
    """A layer's transform alone: BMM.FBB sign words, or BMM.BBF rows."""
    return _fbb(h, bn, w, bn_rcp) if fbb else fc_plain(h, bn, w, bn_rcp)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class _Params(ctypes.Structure):
    """Mirror of ``Params`` in ``csrc/fused_layer.cu`` (same field order)."""
    _fields_ = [
        ("x", _P), ("xw", _P), ("mu", _P), ("sd", _P),
        ("n_in", ctypes.c_longlong), ("f", ctypes.c_int), ("wk", ctypes.c_int),
        ("bn_rcp", ctypes.c_int),
        ("w_a", _P), ("s_a", _P), ("w_s", _P), ("s_s", _P),
        ("ho", ctypes.c_int), ("fbb", ctypes.c_int),
        ("aggregate", ctypes.c_int), ("s2", ctypes.c_int),
        ("relu", ctypes.c_int),
        ("grp_ptr", _P), ("tiles", _P), ("col_idx", _P), ("item_ptr", _P),
        ("row_scale", _P), ("col_scale", _P),
        ("n_tile_rows", ctypes.c_int), ("n_rows", ctypes.c_longlong),
        ("chunk", ctypes.c_int),
        ("h_grp_ptr", _P), ("h_tiles", _P), ("h_col_idx", _P),
        ("h_item_ptr", _P), ("h_col_scale", _P),
        ("rem", _P), ("n_rem", ctypes.c_longlong), ("remc", _P),
        ("y", _P), ("ys", _P), ("part", _P), ("out", _P),
        ("fp_sub", ctypes.c_int), ("fp_cols", ctypes.c_int),
        ("fp_vec", ctypes.c_int),
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
            halo: Optional[FRDCMatrix] = None,
            rem: Optional[torch.Tensor] = None,
            halo_items: Optional[torch.Tensor] = None,
            bn_rcp: bool = False, form: Optional[str] = None) -> torch.Tensor:
    """One fused launch (``form``: its :data:`PAIR_FORMS` counter). Without ``adj`` the kernel stops after its
    transform and returns it: BMM.FBB sign words, or BMM.BBF rows (the
    self branch's product is then not returned). With ``halo`` and ``rem``
    (the exchanged rows of its columns) it aggregates the intra+halo pair."""
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
    if (halo is None) != (rem is None) or (halo is not None and adj is None):
        raise ValueError("fused layer: the halo adjacency needs its rows "
                         "(rem) and an intra adjacency")
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
    if w_s is not None:
        p.w_s = _ptr(w_s.packed, dev, torch.int32, "self weights")
        p.s_s = _ptr(hold(w_s.scale.reshape(-1).contiguous()), dev,
                     torch.float32, "self weight scales")
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
        n_items = max_items(adj)
        if halo is not None:
            _check_adj(halo, h, "fused layer halo")
            if halo.n_rows != adj.n_rows or rem.ndim != 2 \
                    or rem.shape[1] != (wh if fbb else ho) \
                    or rem.shape[0] < halo.n_cols:
                raise ValueError(
                    f"fused layer: a ({halo.n_rows}, {halo.n_cols}) halo "
                    f"adjacency with rem {tuple(rem.shape)} for "
                    f"{adj.n_rows} rows of width {ho}")
            if halo_items is None:
                halo_items = work_items(halo.grp_ptr)
            rem = rem.contiguous()
            p.h_grp_ptr, p.h_tiles = (halo.grp_ptr.data_ptr(),
                                      halo.tiles.data_ptr())
            p.h_col_idx = halo.col_idx.data_ptr()
            p.h_item_ptr = _ptr(halo_items, dev, torch.int32, "halo items")
            p.h_col_scale = _ptr(halo.col_scale, dev, torch.float32,
                                 "halo col scale")
            p.rem = _ptr(rem, dev, kind, "rem")
            p.n_rem = rem.shape[0]
            if not fbb:   # the fp walk reads rem's rows, scaled, from here
                p.remc = hold(torch.empty_like(rem)).data_ptr()
            n_items += max_items(halo)
        y = hold(torch.empty((n_in, wh if fbb else ho), dtype=kind,
                             device=dev))
        p.y = y.data_ptr()
        p.fp_sub, p.fp_cols, p.fp_vec = fp_layout(ho, ho, p.y)
        if w_s is not None:
            p.ys = hold(torch.empty((n_in, ho), dtype=torch.float32,
                                    device=dev)).data_ptr()
        p.part = hold(torch.empty(n_items * TILE * width, dtype=kind,
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
        KERNEL_CALLS["fused_aggs"] += 1 + (halo is not None)
    return out


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"repro_torch has no kernels for device {t.device}")


def _pair_form(kind: str, halo) -> Optional[str]:
    return None if halo is None else f"{kind}+halo"


# ---------------------------------------------------------------------------
# Entry points: one fused layer each
# ---------------------------------------------------------------------------
# ``halo``/``rem``/``halo_items``: the sharded executors' pair body, the
# halo adjacency of this shard's rows (columns: its halo nodes), the
# exchanged rows of those nodes (the same transform, computed by their
# owners with :func:`transform`) and its work items; ``bn_rcp`` takes the
# executors' BN by the reciprocal.

def gcn_bin_l1(x: torch.Tensor, bn, w: BinTensor, adj: FRDCMatrix,
               trinary_mode: str = "s3_two_popc",
               item_ptr: Optional[torch.Tensor] = None,
               halo: Optional[FRDCMatrix] = None,
               rem: Optional[torch.Tensor] = None,
               halo_items: Optional[torch.Tensor] = None,
               bn_rcp: bool = False) -> torch.Tensor:
    """GCN "bin" layer 1: BN -> BMM.FBB -> BSpMM.BBB over the 0/1 adjacency;
    returns (n_rows, ceil(H/32)) int32 sign words (unit scales)."""
    KERNEL_CALLS["fused"] += 1
    if _on_card(x):
        return _launch(x, bn, w, adj, fbb=True, trinary_mode=trinary_mode,
                       item_ptr=item_ptr, halo=halo, rem=rem,
                       halo_items=halo_items, bn_rcp=bn_rcp,
                       form=_pair_form("gcn_bin_l1", halo))
    return gcn_bin_l1_plain(x, bn, w, adj, trinary_mode, halo, rem, bn_rcp)


def gcn_bbf_fbf(h: torch.Tensor, bn, w: BinTensor, adj: FRDCMatrix,
                relu: bool = False,
                item_ptr: Optional[torch.Tensor] = None,
                halo: Optional[FRDCMatrix] = None,
                rem: Optional[torch.Tensor] = None,
                halo_items: Optional[torch.Tensor] = None,
                bn_rcp: bool = False) -> torch.Tensor:
    """[BN -> quantize_act] -> BMM.BBF -> BSpMM.FBF [-> ReLU]; ``h`` is fp
    rows, or int32 sign words with unit scales (``bn`` None)."""
    KERNEL_CALLS["fused"] += 1
    if _on_card(h):
        return _launch(h, bn, w, adj, relu=relu, item_ptr=item_ptr,
                       halo=halo, rem=rem, halo_items=halo_items,
                       bn_rcp=bn_rcp, form=_pair_form("gcn_bbf_fbf", halo))
    return gcn_bbf_fbf_plain(h, bn, w, adj, relu, halo, rem, bn_rcp)


def branch_add(h: torch.Tensor, bn, w_self: BinTensor, w_agg: BinTensor,
               adj: FRDCMatrix, relu: bool = False,
               item_ptr: Optional[torch.Tensor] = None,
               halo: Optional[FRDCMatrix] = None,
               rem: Optional[torch.Tensor] = None,
               halo_items: Optional[torch.Tensor] = None,
               bn_rcp: bool = False) -> torch.Tensor:
    """BN -> quantize_act -> BMM.BBF self + BSpMM.FBF(BMM.BBF agg) [-> ReLU]."""
    KERNEL_CALLS["fused"] += 1
    if _on_card(h):
        return _launch(h, bn, w_agg, adj, w_s=w_self, relu=relu,
                       item_ptr=item_ptr, halo=halo, rem=rem,
                       halo_items=halo_items, bn_rcp=bn_rcp,
                       form=_pair_form("branch_add", halo))
    return branch_add_plain(h, bn, w_self, w_agg, adj, relu, halo, rem,
                            bn_rcp)


def fc(h: torch.Tensor, bn, w: BinTensor, bn_rcp: bool = False
       ) -> torch.Tensor:
    """BN -> quantize_act -> BMM.BBF."""
    KERNEL_CALLS["fused"] += 1
    if _on_card(h):
        return _launch(h, bn, w, None, bn_rcp=bn_rcp,
                       form="fc+rcp" if bn_rcp else None)
    return fc_plain(h, bn, w, bn_rcp)


def transform(h: torch.Tensor, bn, w: BinTensor, fbb: bool = False,
              bn_rcp: bool = False) -> torch.Tensor:
    """A fused layer's transform alone (the kernel with ``aggregate = 0``):
    BMM.FBB sign words (``fbb``) or BMM.BBF rows. The sharded executors
    exchange these rows, so that a remote row is the very row its owner's
    fused launch computes for itself."""
    if _on_card(h):
        return _launch(h, bn, w, None, fbb=fbb, bn_rcp=bn_rcp,
                       form="transform")
    return transform_plain(h, bn, w, fbb, bn_rcp)
