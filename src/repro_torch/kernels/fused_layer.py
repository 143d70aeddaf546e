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
LAUNCHES = {"fused_layer": 0}  # CUDA launches (plain calls not counted)


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


# ---------------------------------------------------------------------------
# Plain versions of the four layer kinds
# ---------------------------------------------------------------------------

def _bn(x: torch.Tensor, bn) -> torch.Tensor:
    if bn is None:
        return x
    mu, sd = bn
    return (x - mu) / sd


def _quantize(z: torch.Tensor):
    """quantize_act: sign words and the per-row mean |z|."""
    return pack_kernel.binarize_pack_plain(z), z.abs().mean(dim=-1,
                                                             keepdim=True)


def _bbf(words: torch.Tensor, xs, w: BinTensor) -> torch.Tensor:
    """BMM.BBF: XNOR-popc counts times the row and weight scales."""
    counts = bmm_kernel.bmm_xnor_plain(words, w.packed, w.n).to(torch.float32)
    return counts * xs * w.scale.reshape(1, -1)


def _input(h: torch.Tensor, bn):
    """(sign words, row scales) of a layer input: fp rows go through BN and
    quantize_act; int32 rows are packed words with unit scales."""
    if h.dtype == torch.int32:
        return h, h.new_ones((h.shape[0], 1), dtype=torch.float32)
    return _quantize(_bn(h, bn))


def gcn_bin_l1_plain(x, bn, w: BinTensor, adj: FRDCMatrix,
                     trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    z = _bn(x, bn)
    w_eff = (bitops.unpack_pm1(w.packed, w.n) * w.scale).T
    hb = pack_kernel.binarize_pack_plain(z @ w_eff)
    n_out = w.packed.shape[0]
    counts = agg_counts(adj, hb, trinary_mode)[:, :n_out]
    return bitops.pack_bits(counts >= 0, axis=-1)


def gcn_bbf_fbf_plain(h, bn, w: BinTensor, adj: FRDCMatrix,
                      relu: bool = False) -> torch.Tensor:
    words, xs = _input(h, bn)
    out = agg_fp(adj, _bbf(words, xs, w))
    return torch.relu(out) if relu else out


def branch_add_plain(h, bn, w_self: BinTensor, w_agg: BinTensor,
                     adj: FRDCMatrix, relu: bool = False) -> torch.Tensor:
    words, xs = _input(h, bn)
    out = _bbf(words, xs, w_self) + agg_fp(adj, _bbf(words, xs, w_agg))
    return torch.relu(out) if relu else out


def fc_plain(h, bn, w: BinTensor) -> torch.Tensor:
    words, xs = _input(h, bn)
    return _bbf(words, xs, w)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class _Params(ctypes.Structure):
    """Mirror of ``Params`` in ``csrc/fused_layer.cu`` (same field order)."""
    _fields_ = [
        ("x", _P), ("xw", _P), ("mu", _P), ("sd", _P),
        ("n_in", ctypes.c_longlong), ("f", ctypes.c_int), ("wk", ctypes.c_int),
        ("w_a", _P), ("s_a", _P), ("w_s", _P), ("s_s", _P),
        ("ho", ctypes.c_int), ("fbb", ctypes.c_int),
        ("aggregate", ctypes.c_int), ("s2", ctypes.c_int),
        ("relu", ctypes.c_int),
        ("grp_ptr", _P), ("tiles", _P), ("col_idx", _P), ("item_ptr", _P),
        ("row_scale", _P), ("col_scale", _P),
        ("n_tile_rows", ctypes.c_int), ("n_rows", ctypes.c_longlong),
        ("chunk", ctypes.c_int),
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
            item_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
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
            p.mu = _ptr(hold(bn[0].reshape(-1).contiguous()), dev,
                        torch.float32, "BN mean")
            p.sd = _ptr(hold(bn[1].reshape(-1).contiguous()), dev,
                        torch.float32, "BN sd")
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
        out = torch.empty((n_in, ho), dtype=torch.float32, device=dev)
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
        if w_s is not None:
            p.ys = hold(torch.empty((n_in, ho), dtype=torch.float32,
                                    device=dev)).data_ptr()
        p.part = hold(torch.empty(max_items(adj) * TILE * width, dtype=kind,
                                  device=dev)).data_ptr()
        out = torch.empty((adj.n_rows, wh if fbb else ho), dtype=kind,
                          device=dev)
    p.out = out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library("fused_layer").fused_layer(
        ctypes.byref(p), stream), "fused_layer")
    LAUNCHES["fused_layer"] += 1
    if adj is not None:
        KERNEL_CALLS["fused_aggs"] += 1
    return out


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"repro_torch has no kernels for device {t.device}")


# ---------------------------------------------------------------------------
# Entry points: one fused layer each
# ---------------------------------------------------------------------------

def gcn_bin_l1(x: torch.Tensor, bn, w: BinTensor, adj: FRDCMatrix,
               trinary_mode: str = "s3_two_popc",
               item_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GCN "bin" layer 1: BN -> BMM.FBB -> BSpMM.BBB over the 0/1 adjacency;
    returns (n_rows, ceil(H/32)) int32 sign words (unit scales)."""
    KERNEL_CALLS["fused"] += 1
    if _on_card(x):
        return _launch(x, bn, w, adj, fbb=True, trinary_mode=trinary_mode,
                       item_ptr=item_ptr)
    return gcn_bin_l1_plain(x, bn, w, adj, trinary_mode)


def gcn_bbf_fbf(h: torch.Tensor, bn, w: BinTensor, adj: FRDCMatrix,
                relu: bool = False,
                item_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[BN -> quantize_act] -> BMM.BBF -> BSpMM.FBF [-> ReLU]; ``h`` is fp
    rows, or int32 sign words with unit scales (``bn`` None)."""
    KERNEL_CALLS["fused"] += 1
    if _on_card(h):
        return _launch(h, bn, w, adj, relu=relu, item_ptr=item_ptr)
    return gcn_bbf_fbf_plain(h, bn, w, adj, relu)


def branch_add(h: torch.Tensor, bn, w_self: BinTensor, w_agg: BinTensor,
               adj: FRDCMatrix, relu: bool = False,
               item_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BN -> quantize_act -> BMM.BBF self + BSpMM.FBF(BMM.BBF agg) [-> ReLU]."""
    KERNEL_CALLS["fused"] += 1
    if _on_card(h):
        return _launch(h, bn, w_agg, adj, w_s=w_self, relu=relu,
                       item_ptr=item_ptr)
    return branch_add_plain(h, bn, w_self, w_agg, adj, relu)


def fc(h: torch.Tensor, bn, w: BinTensor) -> torch.Tensor:
    """BN -> quantize_act -> BMM.BBF."""
    KERNEL_CALLS["fused"] += 1
    if _on_card(h):
        return _launch(h, bn, w, None)
    return fc_plain(h, bn, w)
