"""Shared compile/calibrate/serve machinery of the GNN serving sessions
(reference: ``repro/serve/session_core.py``).

* :class:`SessionPlan` and the tuner-driven plan selection (paper §3.4);
* family-dispatched bitgnn forwards under the plan's kernel selection
  (:func:`family_forward`: the 2D block grid for ``bspmm_block``, one fused
  kernel per layer for ``fused``);
* :class:`ServeCore`, the bucket-shaped subgraph forward with the
  HIGH-WATER pow2 shape buckets and the program counter: PyTorch runs
  eagerly, so where the reference counts jit traces the core counts each
  new padded shape key (``compile_count``), the zero-steady-state-recompile
  verification counter, and one dispatch per ``launch`` / ``launch_many``
  call (``n_dispatches``);
* subgraph FRDC construction carrying FULL-graph factorization vectors, so
  a k-hop forward reproduces the full-graph computation for the seed rows;
* FRDC and parameter (de)serialization in the reference's artifact format.

The extract stage is host work: the subgraph FRDC is built on the CPU,
``ServeCore.launch`` copies it to the session's device (pinned memory,
non-blocking) and launches the forward without waiting for it, and only
``finish`` copies the answers back.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import bitops, frdc, tuner
from ..core.binarize import BinTensor
from ..core.bmm import bmm, quantize_act
from ..core.bspmm import TRINARY_DEFAULT
from ..kernels import fused_layer
from ..kernels import ops as kernel_ops
from ..models import gnn

FAMILIES = ("gcn", "sage", "saint")

# layer_variants of the two legal GCN end-to-end schemes (paper Table 3);
# SAGE/SAINT run the fixed Fig. 2 pipeline (BMM.BBF branches + BSpMM.FBF).
GCN_SCHEME_VARIANTS = {
    "full": (("BMM.BBF", "BSpMM.FBF"), ("BMM.BBF", "BSpMM.FBF")),
    "bin": (("BMM.FBB", "BSpMM.BBB"), ("BMM.BBF", "BSpMM.FBF")),
}
FIXED_VARIANTS = (("BMM.BBF", "BSpMM.FBF"), ("BMM.BBF", "BSpMM.FBF"))

# adjacency kinds each family's packed forward consumes
FAMILY_ADJ_KINDS = {"gcn": ("adj", "bin"), "sage": ("mean",), "saint": ("sum",)}

# aggregation layers per family: the k of the k-hop closure a served node
# needs, and the hops a feature update invalidates
FAMILY_AGG_LAYERS = {"gcn": 2, "sage": 2, "saint": 2}


def bucket_pow2(n: int, floor: int, cap: Optional[int] = None) -> int:
    """Round up to the power-of-two bucket grid (>= floor, <= cap)."""
    b = floor
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


@dataclasses.dataclass
class SessionPlan:
    """Tuner-selected execution plan of one compiled session.

    ``bspmm_block`` is the BSpMM block-shape tunable, ``(rows, feats)`` of
    one 2D-grid block, or None for the 1D kernels. ``fused`` selects one
    fused kernel per layer (:mod:`repro_torch.kernels.fused_layer`). Both
    take effect only with ``use_pallas``; calibration passes (which must
    RECORD bn stats) always run unfused. Both ride in ``plan.json``.
    """
    family: str
    scheme: str                       # gcn: "full" | "bin"; else "fixed"
    trinary_mode: str = TRINARY_DEFAULT
    layer_variants: tuple = FIXED_VARIANTS
    tuned_latency_s: float = float("nan")
    output_delta: float = float("nan")
    bspmm_block: Optional[Tuple[int, int]] = None
    fused: bool = False

    def name(self) -> str:
        layers = ";".join(f"{m}+{s}" for m, s in self.layer_variants)
        blk = ("" if self.bspmm_block is None
               else f"|blk{self.bspmm_block[0]}x{self.bspmm_block[1]}")
        fz = "|fused" if self.fused else ""
        return f"{self.family}/{self.scheme}[{layers}|{self.trinary_mode}" \
               f"{blk}{fz}]"

    def to_json(self) -> dict:
        return dict(family=self.family, scheme=self.scheme,
                    trinary_mode=self.trinary_mode,
                    layer_variants=[list(v) for v in self.layer_variants],
                    tuned_latency_s=self.tuned_latency_s,
                    output_delta=self.output_delta,
                    bspmm_block=(None if self.bspmm_block is None
                                 else list(self.bspmm_block)),
                    fused=self.fused)

    @classmethod
    def from_json(cls, d: dict) -> "SessionPlan":
        blk = d.get("bspmm_block")
        return cls(family=d["family"], scheme=d["scheme"],
                   trinary_mode=d["trinary_mode"],
                   layer_variants=tuple(tuple(v) for v in d["layer_variants"]),
                   tuned_latency_s=d.get("tuned_latency_s", float("nan")),
                   output_delta=d.get("output_delta", float("nan")),
                   bspmm_block=None if blk is None else tuple(blk),
                   fused=bool(d.get("fused", False)))


def quantize_family(family: str, params):
    return {"gcn": gnn.quantize_gcn, "sage": gnn.quantize_sage,
            "saint": gnn.quantize_saint}[family](params)


def family_forward(plan: SessionPlan, qparams, x,
                   adjs: Dict[str, frdc.FRDCMatrix],
                   use_pallas: bool = False, items: Optional[dict] = None,
                   **kw):
    """Dispatch the family's packed forward under ``plan``.

    ``use_pallas`` turns on the plan's kernel selection: ``bspmm_block``
    routes the BSpMM stages to the 2D block grid, and ``fused`` (with
    frozen BN stats, not calibrating) runs one fused kernel per layer.
    ``items``: optional precomputed task lists per adjacency kind for the
    fused kernels (``fused_layer.pair_items``).
    """
    fused = (plan.fused and use_pallas
             and kw.get("bn_stats") is not None
             and not kw.get("return_bn_stats", False))
    if fused:
        return _fused_family_forward(plan, qparams, x, adjs, kw["bn_stats"],
                                     items or {})
    with kernel_ops.serve_kernels(use_pallas, block_shape=plan.bspmm_block):
        if plan.family == "gcn":
            return gnn.gcn_forward_bitgnn(
                qparams, x, adjs["adj"], adjs["bin"], scheme=plan.scheme,
                trinary_mode=plan.trinary_mode, **kw)
        if plan.family == "sage":
            return gnn.sage_forward_bitgnn(qparams, x, adjs["mean"], **kw)
        return gnn.saint_forward_bitgnn(qparams, x, adjs["sum"], **kw)


def _fused_family_forward(plan: SessionPlan, q, x,
                          adjs: Dict[str, frdc.FRDCMatrix], bn_stats: tuple,
                          items: dict):
    """Serve the forward as ONE fused kernel per layer.

    The layer kinds follow the family's layer callables
    (``gnn.bitgnn_layers``); the BN-site cursor advances across layers as
    the monolithic forward's ``_BNTap`` does, and the GCN "bin" scheme's
    binary carry crosses the layer boundary as its packed words with unit
    scales (layer 2 has no BN site)."""
    fl = fused_layer
    if plan.family == "gcn":
        adj = adjs["adj"]
        if plan.scheme == "bin":
            h = fl.gcn_bin_l1(x, bn_stats[0], q.w1, adjs["bin"],
                              plan.trinary_mode, items.get("bin"))
            return fl.gcn_bbf_fbf(h, None, q.w2, adj, False, items.get("adj"))
        h = fl.gcn_bbf_fbf(x, bn_stats[0], q.w1, adj, True, items.get("adj"))
        return fl.gcn_bbf_fbf(h, bn_stats[1], q.w2, adj, False,
                              items.get("adj"))
    kind = "mean" if plan.family == "sage" else "sum"
    adj, it = adjs[kind], items.get(kind)
    h = fl.branch_add(x, bn_stats[0], q.w1_self, q.w1_agg, adj, True, it)
    h = fl.branch_add(h, bn_stats[1], q.w2_self, q.w2_agg, adj,
                      plan.family == "saint", it)
    if plan.family == "saint":
        h = fl.fc(h, bn_stats[2], q.w_fc)
    return h


# ---------------------------------------------------------------------------
# FRDC and parameter (de)serialization — the reference's artifact format
# ---------------------------------------------------------------------------

def frdc_arrays(m: frdc.FRDCMatrix) -> dict:
    out = dict(tiles=m.tiles, col_idx=m.col_idx, group_row=m.group_row,
               group_first=m.group_first, grp_ptr=m.grp_ptr)
    if m.row_scale is not None:
        out["row_scale"] = m.row_scale
    if m.col_scale is not None:
        out["col_scale"] = m.col_scale
    return out


def frdc_rebuild(arrs: dict, n_rows: int, n_cols: int,
                 nnz: int = 0) -> frdc.FRDCMatrix:
    return frdc.FRDCMatrix(
        tiles=arrs["tiles"], col_idx=arrs["col_idx"],
        group_row=arrs["group_row"], group_first=arrs["group_first"],
        grp_ptr=arrs["grp_ptr"], n_rows=int(n_rows), n_cols=int(n_cols),
        nnz=int(nnz), row_scale=arrs.get("row_scale"),
        col_scale=arrs.get("col_scale"))


def frdc_to_host(m: frdc.FRDCMatrix) -> dict:
    """FRDC arrays as the reference stores them (tiles uint16)."""
    out = {k: v.detach().cpu().numpy() for k, v in frdc_arrays(m).items()}
    out["tiles"] = out["tiles"].astype(np.uint16)
    return out


def frdc_from_host(arrs: dict, dims, device) -> frdc.FRDCMatrix:
    """Inverse of :func:`frdc_to_host`: int32 tiles, tensors on ``device``."""
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
    t = {k: dev(v, np.float32 if k.endswith("scale") else np.int32)
         for k, v in arrs.items()}
    return frdc_rebuild(t, *dims)


def quant_to_host(q):
    """Quantized params as the reference stores them: packed words uint32,
    scales float32, ``n`` a python int."""
    return type(q)(*(BinTensor(
        packed=t.packed.detach().cpu().numpy().view(np.uint32),
        scale=t.scale.detach().cpu().numpy(), n=int(t.n)) for t in q))


def coerce_quant(q, device="cuda"):
    """Re-type a restored quantized param tree: words as the port's int32
    bit-views and scales as float32 tensors on ``device``; the ``n`` field
    round-trips through npz as a 0-d array and comes back as a python int."""
    def words(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a).astype(np.uint32).view(np.int32))).to(device)
    return type(q)(*(BinTensor(
        packed=words(t.packed),
        scale=torch.from_numpy(np.asarray(t.scale, np.float32)).to(device),
        n=int(t.n)) for t in q))


# FRDC array fields per adjacency kind of each family: the structure of a
# saved artifact, so load() can build the restore template without encoding
# any adjacency.
FRDC_BASE_FIELDS = ("tiles", "col_idx", "group_row", "group_first", "grp_ptr")
ADJ_SCALE_FIELDS = {
    "gcn": {"adj": ("row_scale", "col_scale"), "bin": ()},
    "sage": {"mean": ("row_scale",)},
    "saint": {"sum": ()},
}


def adj_like(family: str) -> dict:
    return {kind: {f: np.zeros(0) for f in FRDC_BASE_FIELDS + extra}
            for kind, extra in ADJ_SCALE_FIELDS[family].items()}


def feature_fingerprint(x: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def session_fingerprint(graph, model) -> dict:
    """Identity of the (graph, model) pair an artifact was compiled for:
    the match key of every artifact restore path."""
    d = graph.data
    return dict(graph=graph.name, model=model.name, family=model.family,
                n_nodes=int(d.n_nodes), n_edges=int(d.n_edges),
                features=feature_fingerprint(d.x))


# ---------------------------------------------------------------------------
# Artifact robustness — typed corruption errors for the restore path
# ---------------------------------------------------------------------------

class ArtifactError(RuntimeError):
    """A serving artifact on disk is CORRUPT (truncated sidecar, unparsable
    JSON, a half-written npz), as opposed to missing or mismatched, which
    the load paths report by returning None so the caller recompiles. It
    names the file and the field that failed."""

    def __init__(self, path, field: str = "", detail: str = ""):
        self.path = str(path)
        self.field = field
        self.detail = detail
        msg = f"corrupt serving artifact {self.path}"
        if field:
            msg += f" (field {field!r})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def load_sidecar(path, required: Tuple[str, ...] = ()) -> Optional[dict]:
    """Read an artifact sidecar (``plan.json``). Missing file -> None (no
    artifact: recompile). Unparsable JSON, a non-object payload, or a
    missing required field -> :class:`ArtifactError`."""
    path = pathlib.Path(path)
    if not path.exists():
        return None
    try:
        sidecar = json.loads(path.read_text())
    except (ValueError, OSError) as e:
        raise ArtifactError(path, field="json", detail=str(e))
    if not isinstance(sidecar, dict):
        raise ArtifactError(path, field="json",
                            detail=f"expected an object, got "
                                   f"{type(sidecar).__name__}")
    for f in required:
        if f not in sidecar:
            raise ArtifactError(path, field=f, detail="missing field")
    return sidecar


def restore_artifact_state(directory, like):
    """Checkpointer restore with typed corruption reporting: None when no
    complete checkpoint exists or its structure mismatches ``like``
    (recompile), :class:`ArtifactError` when the manifest or npz payload is
    present but unreadable. Leaves come back as numpy arrays."""
    from ..checkpoint.checkpointer import Checkpointer, _flatten, _unflatten
    ckpt = Checkpointer(directory, keep=1)
    step = ckpt.latest_step()
    if step is None:
        return None
    out = pathlib.Path(directory) / f"step_{step:08d}"
    man_path = out / "manifest.json"
    try:
        manifest = json.loads(man_path.read_text())
    except (ValueError, OSError) as e:
        raise ArtifactError(man_path, field="json", detail=str(e))
    for f in ("keys", "n_leaves", "shards"):
        if f not in manifest:
            raise ArtifactError(man_path, field=f, detail="missing field")
    keys, _, structure = _flatten(like)
    if keys != manifest["keys"]:
        return None                    # structure mismatch: recompile
    npz_path = out / manifest["shards"][0]
    if not npz_path.exists():
        raise ArtifactError(npz_path, field="shards",
                            detail="manifest names a missing shard file")
    try:
        data = np.load(npz_path)
        leaves = [np.asarray(data[f"a{i}"])
                  for i in range(int(manifest["n_leaves"]))]
    except (zipfile.BadZipFile, KeyError, ValueError, OSError) as e:
        raise ArtifactError(npz_path, field="leaves", detail=str(e))
    return _unflatten(structure, leaves)


# ---------------------------------------------------------------------------
# Subgraph adjacency construction (full-graph factorization vectors)
# ---------------------------------------------------------------------------

def sub_adjacency(family: str, n_sub: int, sub_edges: np.ndarray,
                  dinv_sub: Optional[np.ndarray]
                  ) -> Dict[str, frdc.FRDCMatrix]:
    """Per-family subgraph FRDC matrices, built on the CPU (the extract
    stage is host work; the launch copies them to the card). ``dinv_sub``
    is the FULL-graph factorization vector gathered at the subgraph's nodes
    (GCN: D^-1/2 with self-loops; SAGE: D^-1; SAINT: None), so seed-row
    aggregation equals the full graph's."""
    if family == "gcn":
        loops = np.arange(n_sub, dtype=np.int64)
        r = np.concatenate([sub_edges[0], loops])
        c = np.concatenate([sub_edges[1], loops])
        return {
            "adj": frdc.from_coo(r, c, n_sub, n_sub, row_scale=dinv_sub,
                                 col_scale=dinv_sub, device="cpu"),
            "bin": frdc.from_coo(sub_edges[0], sub_edges[1], n_sub, n_sub,
                                 device="cpu"),
        }
    if family == "sage":
        return {"mean": frdc.from_coo(sub_edges[0], sub_edges[1], n_sub,
                                      n_sub, row_scale=dinv_sub,
                                      device="cpu")}
    return {"sum": frdc.from_coo(sub_edges[0], sub_edges[1], n_sub, n_sub,
                                 device="cpu")}


def dinv_for_family(family: str, degrees: np.ndarray) -> Optional[np.ndarray]:
    """Full-graph factorization vector from full-graph receiver degrees."""
    if family == "gcn":
        return 1.0 / np.sqrt(degrees + 1.0)          # self-loops included
    if family == "sage":
        return 1.0 / np.maximum(degrees.astype(np.float64), 1.0)
    return None


# ---------------------------------------------------------------------------
# Layer programs — the distributed full pass decomposed into executor steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerStep:
    """One step of a family's distributed layer program.

    A step runs per shard as: optional BN (site ``bn_site`` of the frozen
    calibration, or distributed moments in calibrate mode) -> ``pre``
    (dense per-shard transform giving the exchange operand and any aux
    state ``post`` needs) -> halo exchange of the operand (packed int32
    words when ``packed``) -> aggregation ``intra @ operand + halo @
    exchanged`` over adjacency ``kind`` (trinary popc counts when
    ``packed``: integer partial sums, exact across the split) -> ``post(aux,
    y)``, the next carried state. ``kind=None`` steps skip the exchange and
    the aggregation (SAINT's trailing FC).

    The reference traces a step's body inside one ``fused_call`` for the
    fused plans; CUDA replays no jaxpr, so each step also names its fused
    form, two launches: ``transform(st, bn) -> (y, ys)``, the fused layer
    kind's transform alone (BN by the reciprocal), whose rows ``y`` are the
    exchange operand (``ys``: the self branch, or None), and ``pair(y, ys,
    rem, intra, halo, items)``, the aggregation of the intra+halo pair and
    the epilogue (``fused_layer.pair``; ``items`` from
    ``fused_layer.pair_items``). ``fused(st, bn, rem, intra, halo, items)``
    is the two in turn, or, for an exchange-free step, its one launch.

    ``payload_cols``/``payload_itemsize``: the exchange operand's row width,
    the wire-byte schedule of the step (``MeshHaloPlan.payload_bytes``).
    """
    name: str
    kind: Optional[str]
    packed: bool
    bn_site: Optional[int]
    pre: Callable
    post: Callable
    payload_cols: int = 0
    payload_itemsize: int = 4
    fused: Optional[Callable] = None
    transform: Optional[Callable] = None
    pair: Optional[Callable] = None

    @property
    def tag(self) -> str:
        """Halo byte-accounting tag."""
        return f"{self.name}/{'packed' if self.packed else 'fp'}"


def binarize_counts(counts: torch.Tensor, n_feat: int) -> BinTensor:
    """Sign-binarize summed trinary counts: the BSpMM.BBB output stage (unit
    scales: positive scales are elided by the consumer)."""
    counts = counts.to(torch.float32)
    if counts.shape[-1] > n_feat:
        counts = counts[:, :n_feat]
    return BinTensor(packed=bitops.sign_bits(counts, axis=-1),
                     scale=counts.new_ones((counts.shape[0], 1)), n=n_feat)


def _fused_step(transform: Callable, pair: Callable) -> Callable:
    """A step's fused form from its two launches."""
    def fused(st, bn, rem, intra, halo, items):
        y, ys = transform(st, bn)
        return pair(y, ys, rem, intra, halo, items)
    return fused


def _step(*args, transform: Callable, pair: Callable, **kw) -> LayerStep:
    return LayerStep(*args, fused=_fused_step(transform, pair),
                     transform=transform, pair=pair, **kw)


def build_layer_program(plan: SessionPlan, q) -> Tuple[LayerStep, ...]:
    """Decompose ``plan``'s family forward into executor layer steps.

    Run per shard with the single-host BN constants, the program equals the
    family's ``*_forward_bitgnn`` over the whole graph wherever the
    aggregation split is exact (binary layers), and to fp reassociation
    elsewhere."""
    fam = plan.family
    fl = fused_layer
    mode = plan.trinary_mode
    if fam == "gcn" and plan.scheme == "bin":
        n_hidden = int(q.w1.packed.shape[0])
        n_out = int(q.w2.packed.shape[0])

        def pre1(z):
            return bmm(z, q.w1, "FBB", out_scale=False).packed, None

        def post1(aux, counts):
            return binarize_counts(counts, n_hidden).packed

        def pre2(st):
            h1 = BinTensor(packed=st, scale=st.new_ones(
                (st.shape[0], 1), dtype=torch.float32), n=n_hidden)
            return bmm(h1, q.w2, "BBF"), None

        return (
            _step("layer1", "bin", True, 0, pre1, post1,
                  payload_cols=-(-n_hidden // 32),
                  transform=lambda st, bn: (fl.transform(
                      st, bn, q.w1, fbb=True, bn_rcp=True), None),
                  pair=lambda y, ys, rem, a, h, it: fl.pair(
                      y, ys, rem, a, h, it, n_out=n_hidden,
                      trinary_mode=mode)),
            _step("layer2", "adj", False, None, pre2, lambda aux, y: y,
                  payload_cols=n_out,
                  transform=lambda st, bn: (fl.transform(st, None, q.w2),
                                            None),
                  pair=fl.pair),
        )
    if fam == "gcn":
        def gcn_step(name, site, w, relu):
            def pre(z):
                return bmm(quantize_act(z), w, "BBF"), None
            return _step(
                name, "adj", False, site, pre,
                (lambda aux, y: torch.relu(y)) if relu else (lambda aux, y: y),
                payload_cols=int(w.packed.shape[0]),
                transform=lambda st, bn: (fl.transform(st, bn, w,
                                                       bn_rcp=True), None),
                pair=lambda y, ys, rem, a, h, it: fl.pair(
                    y, ys, rem, a, h, it, relu))

        return (gcn_step("layer1", 0, q.w1, True),
                gcn_step("layer2", 1, q.w2, False))

    # sage / saint: self + aggregated branch merged by ADD per layer
    kind = "mean" if fam == "sage" else "sum"

    def branch_step(name, site, w_self, w_agg, relu):
        def pre(z):
            xq = quantize_act(z)
            return bmm(xq, w_agg, "BBF"), xq

        def post(xq, agg):
            h = bmm(xq, w_self, "BBF") + agg
            return torch.relu(h) if relu else h

        return _step(
            name, kind, False, site, pre, post,
            payload_cols=int(w_agg.packed.shape[0]),
            transform=lambda st, bn: fl.transform(st, bn, w_agg, bn_rcp=True,
                                                  w_self=w_self),
            pair=lambda y, ys, rem, a, h, it: fl.pair(y, ys, rem, a, h, it,
                                                      relu))

    steps = [branch_step("layer1", 0, q.w1_self, q.w1_agg, True),
             branch_step("layer2", 1, q.w2_self, q.w2_agg, fam == "saint")]
    if fam == "saint":
        steps.append(LayerStep(
            "fc", None, False, 2,
            lambda z: (bmm(quantize_act(z), q.w_fc, "BBF"), None),
            lambda aux, y: y,
            fused=lambda st, bn, rem, a, h, it: fl.fc(st, bn, q.w_fc, True)))
    return tuple(steps)


def apply_bn(x: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor
             ) -> torch.Tensor:
    """Frozen-stats batch norm in the layer executors' form, ``(x - mu) *
    (1.0 / sd)``: the reference multiplies by the reciprocal there (a jitted
    and an eager division round differently under XLA), where the
    single-host forwards divide. Copied as it is."""
    return (x - mu) * (1.0 / sd)


# the eps of gnn.bn_stats, shared by the distributed calibrations
BN_EPS = 1e-5


def moments_from_sums(s1, s2, cnt, eps: float = BN_EPS) -> tuple:
    """(mu, sd) from sum / sum-of-squares / count partials: the formula of
    distributed BN calibration."""
    mu = s1 / cnt
    sd = torch.sqrt(torch.clamp(s2 / cnt - mu * mu, min=0.0)) + eps
    return mu, sd


def distributed_moments(blocks: List[torch.Tensor],
                        eps: float = BN_EPS) -> tuple:
    """Per-feature (mu, sd) over the GLOBAL node axis from per-shard row
    blocks (sum and sum-of-squares partials added across shards)."""
    cnt = float(sum(int(b.shape[0]) for b in blocks))
    s1 = sum(b.sum(dim=0, keepdim=True) for b in blocks)
    s2 = sum((b * b).sum(dim=0, keepdim=True) for b in blocks)
    return moments_from_sums(s1, s2, cnt, eps)


class LayerExecutor:
    """Executes a layer program over per-shard feature blocks.

    ``run_pass(program, xs, bn, calibrate=False)`` takes the per-shard
    UNPADDED feature blocks and either the frozen BN tuple (site-indexed) or
    ``calibrate=True`` to compute the stats from the pass itself; returns
    ``(per-shard output blocks, collected stats or None)``. The port has
    :class:`repro_torch.serve.sharded.executor.HostLayerExecutor`.
    """
    name = "?"

    @property
    def compile_count(self) -> int:
        """Distinct layer programs the executor has run."""
        return 0

    def run_pass(self, program, xs, bn, calibrate: bool = False):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# ServeCore — the bucket-shaped subgraph forward
# ---------------------------------------------------------------------------

class ServeCore:
    """One bucketed forward + its high-water shape buckets.

    The core owns the family-AGNOSTIC serving machinery: the program
    counter, the high-water pow2 buckets and async launch/finish. What a
    launch computes is the ``adapter``'s business (:class:`repro_torch.serve.adapters.ModelFamilyAdapter`).

    Node and FRDC group counts are padded up to pow2 marks that only ever
    grow (capped at ``node_cap``), so serving converges to one steady padded
    shape after a short warmup. ``compile_count`` counts the distinct padded
    shape keys launched (``adapter.program_key``) — where the reference's
    jit would trace — and IS the verification counter; ``on_trace(shape)``
    fires on each new one with ``adapter.trace_shape``.
    """

    NODE_BUCKET_FLOOR = 64
    GROUP_BUCKET_FLOOR = 16

    def __init__(self, plan: SessionPlan, qparams, max_batch: int,
                 node_cap: int, use_pallas: bool = False, adapter=None,
                 device="cuda"):
        if adapter is None:
            from .adapters import GNNAdapter
            adapter = GNNAdapter(plan)
        self.adapter = adapter
        self.plan = plan
        self.qparams = qparams
        self.max_batch = max_batch
        self.node_cap = node_cap
        self.use_pallas = use_pallas
        self.device = torch.device(device)
        self._shapes: set = set()
        self.on_trace = None
        self._n_water = 0
        self._g_water: Dict[Tuple[int, str], int] = {}
        # launch / launch_many calls (a launch_many of K buckets counts 1):
        # the launches-per-tick metric, counted as the reference counts
        # its device dispatches
        self.n_dispatches = 0

    @property
    def compile_count(self) -> int:
        return len(self._shapes)

    def _new_program(self, key) -> bool:
        key = json.dumps(key, sort_keys=True)
        if key in self._shapes:
            return False
        self._shapes.add(key)
        return True

    def _upload(self, a):
        """Host array or CPU tensor -> the core's device, without waiting
        for the device (pinned staging, non-blocking copy)."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _serve_one(self, staged: "StagedBatch", bn):
        x, operands, pos = self.adapter.upload(self, staged)
        return self.adapter.serve_body(self, x, bn, operands, pos)

    def _pad_mats(self, mats: Dict[str, frdc.FRDCMatrix], n_sub: int):
        return self.adapter.pad_operands(self, mats, n_sub)

    def stage(self, x_sub: np.ndarray, mats: Dict[str, frdc.FRDCMatrix],
              seed_pos: np.ndarray) -> "StagedBatch":
        """EXTRACT-stage tail: bucket-pad one extracted subgraph into the
        launch-ready host arrays. Pure host work (the water-mark update
        happens here, so staging order — not launch order — is what the
        zero-recompile guarantee keys on)."""
        n_pad, adjs = self._pad_mats(mats, x_sub.shape[0])
        x_pad = np.zeros((n_pad, x_sub.shape[1]), np.float32)
        x_pad[:x_sub.shape[0]] = x_sub
        pos_pad = np.zeros((self.max_batch,), np.int64)
        pos_pad[:seed_pos.size] = seed_pos
        return StagedBatch(x_pad=x_pad, adjs=adjs, pos_pad=pos_pad,
                           n_seeds=int(seed_pos.size))

    def launch(self, staged: "StagedBatch", bn: tuple) -> torch.Tensor:
        """COMPUTE-stage head: copy the staged arrays to the device and
        launch the bucketed forward; returns before the device finishes, so
        the caller can overlap the next batch's extraction with it."""
        shape = self.adapter.trace_shape(staged)
        new = self._new_program(self.adapter.program_key(staged, bn))
        self.n_dispatches += 1
        out = self._serve_one(staged, bn)
        if new and self.on_trace is not None:
            self.on_trace(shape)
        return out

    def launch_many(self, entries: List[Tuple["StagedBatch", tuple]]
                    ) -> List[torch.Tensor]:
        """Launch SEVERAL staged buckets as one program: ``entries`` are
        (staged, bn) pairs, each bucket under its own captured calibration.
        The K forwards go out back to back on the stream, each the same
        calls :meth:`launch` makes, so the outputs are bit-equal to K
        serial launches. Counted as ONE dispatch, and as one new program
        per new (K, shapes) composition, the reference's jit cache key."""
        if len(entries) == 1:
            staged, bn = entries[0]
            return [self.launch(staged, bn)]
        shape = self.adapter.trace_shape_many([s for s, _ in entries])
        new = self._new_program(shape)
        self.n_dispatches += 1
        outs = [self._serve_one(s, bn) for s, bn in entries]
        if new and self.on_trace is not None:
            self.on_trace(shape)
        return outs

    def finish(self, out_dev: torch.Tensor, staged: "StagedBatch"
               ) -> np.ndarray:
        """COMPUTE-stage tail: wait for the device result and crop it back
        to host answers (GNN: the seed rows)."""
        return self.adapter.finish(out_dev, staged)

    def run(self, x_sub: np.ndarray, mats: Dict[str, frdc.FRDCMatrix],
            seed_pos: np.ndarray, bn: tuple) -> np.ndarray:
        """Serial stage -> launch -> finish of one extracted subgraph;
        returns (len(seed_pos), n_out) logits."""
        staged = self.stage(x_sub, mats, seed_pos)
        return self.finish(self.launch(staged, bn), staged)

    def preset_water(self, n_max: int, g_max: Dict[str, int],
                     margin: float) -> None:
        """Set the water marks ``margin`` above probed maxima (pow2-rounded);
        a workload batch can only add a program by exceeding the margined
        bucket, and the monotone water then absorbs it."""
        n_pad = bucket_pow2(min(int(n_max * margin), self.node_cap),
                            self.NODE_BUCKET_FLOOR, self.node_cap)
        self._n_water = max(self._n_water, n_pad)
        for k, g in g_max.items():
            wkey = (self._n_water, k)
            g_pad = bucket_pow2(int(g * margin), self.GROUP_BUCKET_FLOOR)
            self._g_water[wkey] = max(self._g_water.get(wkey, 0), g_pad)


# ---------------------------------------------------------------------------
# Prepared batches — the extract-stage output of the serving pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StagedBatch:
    """One bucket-padded subgraph, ready for :meth:`ServeCore.launch`."""
    x_pad: np.ndarray               # (n_pad, F) zero-padded features
    adjs: Dict[str, dict]           # padded FRDC arrays per adjacency kind
    pos_pad: np.ndarray             # (max_batch,) seed positions, padded
    n_seeds: int


@dataclasses.dataclass
class PreparedGroup:
    """One serve core's share of a prepared batch: the staged subgraph of
    the uniq-seed subset ``sel``."""
    core: ServeCore
    sel: np.ndarray
    staged: StagedBatch


@dataclasses.dataclass
class PreparedBatch:
    """Extract-stage output for one micro-batch of seeds, produced WITHOUT
    device work. ``inverse`` maps the uniq-seed rows back to request order;
    ``bn`` is the frozen calibration CAPTURED AT EXTRACT TIME, which the
    launch uses (never the session's live ``bn``)."""
    n_uniq: int
    inverse: np.ndarray
    groups: List[PreparedGroup]
    out_shape: Tuple[int, ...] = ()
    bn: Optional[tuple] = None

    def launch(self) -> List[torch.Tensor]:
        """Launch every group's forward with the CAPTURED calibration."""
        return [g.core.launch(g.staged, self.bn) for g in self.groups]

    def finish(self, devs: List[torch.Tensor]) -> np.ndarray:
        """Wait for the device results and reassemble request-order
        logits."""
        out: Optional[np.ndarray] = None
        for g, dv in zip(self.groups, devs):
            logits = g.core.finish(dv, g.staged)
            if out is None:
                out = np.zeros((self.n_uniq,) + logits.shape[1:],
                               logits.dtype)
            out[g.sel] = logits
        if out is None:
            out = np.zeros((self.n_uniq,) + tuple(self.out_shape),
                           np.float32)
        return out[self.inverse]


def launch_prepared_many(prepared: List[PreparedBatch]
                         ) -> List[List[torch.Tensor]]:
    """Co-launch several prepared batches: every staged group is bucketed
    by its owning :class:`ServeCore` and each core issues ONE
    :meth:`ServeCore.launch_many` for its whole share. Returns the
    per-batch handle lists in exactly the order ``[p.launch() for p in
    prepared]`` would, each handle bit-equal to what the serial launches
    give. Groups keep their batch's CAPTURED ``bn``."""
    by_core: Dict[int, Tuple[ServeCore, list]] = {}
    slots: List[List[Optional[torch.Tensor]]] = []
    for bi, p in enumerate(prepared):
        slots.append([None] * len(p.groups))
        for gi, g in enumerate(p.groups):
            _, entries = by_core.setdefault(id(g.core), (g.core, []))
            entries.append((g.staged, p.bn, bi, gi))
    for core, entries in by_core.values():
        outs = core.launch_many([(s, bn) for s, bn, _, _ in entries])
        for (_, _, bi, gi), dv in zip(entries, outs):
            slots[bi][gi] = dv
    return slots


# ---------------------------------------------------------------------------
# Plan selection (default + tuner; paper §3.4)
# ---------------------------------------------------------------------------

def default_plan(family: str) -> SessionPlan:
    if family == "gcn":
        return SessionPlan(family, "bin",
                           layer_variants=GCN_SCHEME_VARIANTS["bin"])
    return SessionPlan(family, "fixed")


def tune_plan(data, family: str, qparams, repeats: int = 2,
              device="cuda") -> SessionPlan:
    """Time the legal end-to-end variant assignments on the actual graph
    (paper §3.4) and pick the fastest. ``data``: the host GraphData."""
    x = torch.from_numpy(data.x).to(device)
    if family == "gcn":
        adj = data.adjacency("gcn", device)
        adj_bin = data.adjacency("binary", device)
        cands = [
            tuner.Candidate(GCN_SCHEME_VARIANTS["full"], "s3_two_popc"),
            tuner.Candidate(GCN_SCHEME_VARIANTS["bin"], "s3_two_popc"),
            tuner.Candidate(GCN_SCHEME_VARIANTS["bin"], "s2_and_andnot"),
        ]

        def build(cand):
            scheme = ("bin" if cand.layer_variants[0][0] == "BMM.FBB"
                      else "full")

            def fwd(xx):
                return gnn.gcn_forward_bitgnn(
                    qparams, xx, adj, adj_bin, scheme=scheme,
                    trinary_mode=cand.trinary_mode)
            return fwd
    else:
        adj = data.adjacency("mean" if family == "sage" else "binary", device)
        fwd_fn = (gnn.sage_forward_bitgnn if family == "sage"
                  else gnn.saint_forward_bitgnn)
        cands = [tuner.Candidate(FIXED_VARIANTS, TRINARY_DEFAULT)]

        def build(cand):
            def fwd(xx):
                return fwd_fn(qparams, xx, adj)
            return fwd

    results = tuner.tune(build, (x,), cands, repeats=repeats)
    best = results[0]
    scheme = "fixed"
    if family == "gcn":
        scheme = ("bin" if best.candidate.layer_variants[0][0] == "BMM.FBB"
                  else "full")
    return SessionPlan(
        family=family, scheme=scheme,
        trinary_mode=best.candidate.trinary_mode,
        layer_variants=best.candidate.layer_variants,
        tuned_latency_s=best.latency_s,
        output_delta=best.output_delta)
