"""GNN models: GCN / GraphSAGE / GraphSAINT in full precision and as BitGNN
packed-bit inference (reference: ``repro/models/gnn.py``).

* ``*_forward_fp`` — full-precision forwards;
* ``*_forward_bigcn`` — the Bi-GCN baseline: logically binarized (sign and
  scales applied, values stored fp32, fp32 matmuls), trained with
  straight-through estimators; ``gcn_forward_ste_bin`` is the training
  forward of the "bin" scheme;
* ``*_forward_bitgnn`` — BitGNN packed inference through the two-level
  abstraction (GCN schemes: "full" = fp aggregation, "bin" = binary
  aggregation; Table 3's "Ours (full)" / "Ours (bin)");
* ``BitGCN`` / ``BitSAGE`` / ``BitSAINT`` — ``nn.Module``s holding the packed
  weights as buffers; their ``forward`` is the functional forward.

The fp and Bi-GCN forwards take the adjacency as a dense matrix or as the
sparse :func:`sparse_adjacency` (the card's form: a dense full-graph
matrix does not fit). :func:`train_node_classifier` trains any
of them with the reference's AdamW; :func:`quantize_gcn` and friends then
pack the trained weights for the bitgnn forwards.

Parameters come from :func:`init_gcn` and friends (numpy glorot from a
seed) or from :func:`params_from_numpy`, which takes the reference
package's parameters as numpy arrays so both packages compute with the
same weights; :func:`params_to_numpy` carries them back.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..core import abstraction, frdc
from ..core.binarize import BinTensor, straight_through_sign
from ..core.bmm import bmm, quantize_act, quantize_weight
from ..core.bspmm import bspmm
from ..kernels import counting
from ..optim.optimizer import AdamW


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class GCNParams(NamedTuple):
    w1: torch.Tensor
    w2: torch.Tensor


class SAGEParams(NamedTuple):
    w1_self: torch.Tensor
    w1_agg: torch.Tensor
    w2_self: torch.Tensor
    w2_agg: torch.Tensor


class SAINTParams(NamedTuple):
    w1_self: torch.Tensor
    w1_agg: torch.Tensor
    w2_self: torch.Tensor
    w2_agg: torch.Tensor
    w_fc: torch.Tensor


PARAMS = {"gcn": GCNParams, "sage": SAGEParams, "saint": SAINTParams}


def _glorot(rng: np.random.Generator, shape) -> np.ndarray:
    lim = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    return rng.uniform(-lim, lim, size=shape).astype(np.float32)


def _shapes(family: str, n_feat: int, hidden: int, n_classes: int) -> list:
    if family == "gcn":
        return [(n_feat, hidden), (hidden, n_classes)]
    if family == "sage":
        return [(n_feat, hidden), (n_feat, hidden),
                (hidden, n_classes), (hidden, n_classes)]
    if family == "saint":
        return [(n_feat, hidden), (n_feat, hidden), (hidden, hidden),
                (hidden, hidden), (hidden, n_classes)]
    raise ValueError(f"unknown family: {family!r}")


def _init(family: str, seed: int, n_feat: int, hidden: int, n_classes: int,
          device):
    rng = np.random.default_rng(seed)
    arrays = [_glorot(rng, s) for s in _shapes(family, n_feat, hidden,
                                                n_classes)]
    return params_from_numpy(family, arrays, device)


def init_gcn(seed: int, n_feat: int, hidden: int, n_classes: int,
             device="cuda") -> GCNParams:
    return _init("gcn", seed, n_feat, hidden, n_classes, device)


def init_sage(seed: int, n_feat: int, hidden: int, n_classes: int,
              device="cuda") -> SAGEParams:
    return _init("sage", seed, n_feat, hidden, n_classes, device)


def init_saint(seed: int, n_feat: int, hidden: int, n_classes: int,
               device="cuda") -> SAINTParams:
    return _init("saint", seed, n_feat, hidden, n_classes, device)


def params_from_numpy(family: str,
                      arrays: Union[Sequence[np.ndarray], Mapping[str, np.ndarray]],
                      device="cuda"):
    """Parameters of ``family`` from numpy arrays, in field order or by field
    name (e.g. ``[np.asarray(w) for w in reference_params]``)."""
    cls = PARAMS.get(family)
    if cls is None:
        raise ValueError(f"unknown family: {family!r}")
    if isinstance(arrays, Mapping):
        arrays = [arrays[f] for f in cls._fields]
    if len(arrays) != len(cls._fields):
        raise ValueError(f"{family} takes {len(cls._fields)} arrays "
                         f"{cls._fields}, got {len(arrays)}")
    return cls(*(torch.from_numpy(np.array(a, np.float32)).to(device)
                 for a in arrays))


def params_to_numpy(params: NamedTuple) -> dict:
    """The reverse of :func:`params_from_numpy`: ``{field: float32 array}``
    on the host (``params_from_numpy(family, params_to_numpy(p))`` gives
    ``p`` back)."""
    return {f: t.detach().cpu().numpy()
            for f, t in zip(params._fields, params)}


# ---------------------------------------------------------------------------
# Aggregation backends (the FP32 (S) / FP32 (T) rows of Tables 3-5)
# ---------------------------------------------------------------------------

def aggregate_scatter(edges: torch.Tensor, x: torch.Tensor, n: int,
                      norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PyG scatter-gather semantics: a gather per edge, then a scatter-add
    into the destination rows (``index_add``)."""
    src, dst = edges
    msgs = x[src]
    if norm is not None:
        msgs = msgs * norm[:, None]
    return x.new_zeros((n, x.shape[1])).index_add(0, dst, msgs)


def aggregate_dense(adj, x: torch.Tensor) -> torch.Tensor:
    """PyG SpMM-tensor semantics: ``adj @ x``, with ``adj`` a dense matrix,
    a sparse CSR tensor or a :class:`SparseAdjacency`."""
    return adj @ x


class _SparseMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, a_t, x):
        ctx.a_t = a_t
        return torch.sparse.mm(a, x)

    @staticmethod
    def backward(ctx, g):
        return None, None, torch.sparse.mm(ctx.a_t, g)


class SparseAdjacency(NamedTuple):
    """A sparse CSR adjacency with its transpose, both built once:
    ``adj @ x`` is ``torch.sparse.mm``, and its backward multiplies by the
    stored transpose. (The backward of a bare CSR product transposes the
    matrix on every step, which on the card synchronizes with the host a
    few times a training step.) The mean adjacency is not symmetric, so
    the transpose is its own matrix."""
    csr: torch.Tensor
    csr_t: torch.Tensor

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return _SparseMatmul.apply(self.csr, self.csr_t, x)


def sparse_adjacency(m: frdc.FRDCMatrix) -> SparseAdjacency:
    """The training forwards' adjacency on ``m``'s device: the matrix of
    :func:`frdc.to_dense`, sparse."""
    return SparseAdjacency(frdc.to_sparse(m), frdc.to_sparse(m, transpose=True))


# ---------------------------------------------------------------------------
# STE binarization (training time)
# ---------------------------------------------------------------------------

class _Abs(torch.autograd.Function):
    """|v| with the reference's gradient at 0: +1, as ``jnp.abs`` has it
    (``torch.abs`` gives 0 there). The forward is one ``abs``, so the
    inference forwards pay nothing for the gradient."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return v.abs()

    @staticmethod
    def backward(ctx, g):
        v, = ctx.saved_tensors
        return g * torch.where(v >= 0, 1.0, -1.0)


_abs = _Abs.apply


def _ste_binarize_w(w: torch.Tensor) -> torch.Tensor:
    """sign(w) times the per-column mean |w|; the gradient flows through
    the scale too."""
    return straight_through_sign(w) * _abs(w).mean(dim=0, keepdim=True)


def _ste_binarize_x(x: torch.Tensor) -> torch.Tensor:
    """sign(x) times the per-row mean |x|."""
    return straight_through_sign(x) * _abs(x).mean(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Batch norm
# ---------------------------------------------------------------------------

def bn_stats(x: torch.Tensor, eps: float = 1e-5) -> tuple:
    """Per-feature (mu, sd) over the node axis. ``sd`` is the population
    standard deviation (ddof 0, as ``jnp.std``) plus eps."""
    mu = x.mean(dim=0, keepdim=True)
    sd = x.std(dim=0, keepdim=True, correction=0) + eps
    return mu, sd


def batch_norm(x: torch.Tensor, eps: float = 1e-5,
               stats: Optional[tuple] = None) -> torch.Tensor:
    """Per-feature standardization: the BN before every BIN (paper Fig. 1).
    ``stats``: optional frozen (mu, sd)."""
    if stats is None:
        stats = bn_stats(x, eps)
    mu, sd = stats
    return (x - mu) / sd


class _BNTap:
    """Sequences the BN sites of a forward: replays frozen per-site stats or
    computes-and-records them from the batch (calibration)."""

    def __init__(self, frozen: Optional[tuple]):
        self.frozen = frozen
        self.collected: list = []
        self._i = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with counting.span("bn"):
            if self.frozen is not None:
                s = self.frozen[self._i]
                self._i += 1
            else:
                s = bn_stats(x)
                self.collected.append(s)
            return batch_norm(x, stats=s)


def _run_bitgnn_layers(layers: list, x, mats: dict,
                       bn_stats: Optional[tuple], return_bn_stats: bool):
    bn = _BNTap(bn_stats)
    h = x
    with counting.span("gnn.forward", new_forward=True):
        for fn in layers:
            with counting.span("gnn.layer"):
                h = fn(bn, h, mats)
    if return_bn_stats:
        return h, tuple(bn.collected)
    return h


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def gcn_forward_fp(params: GCNParams, x, adj_dense):
    h = torch.relu(adj_dense @ (x @ params.w1))
    return adj_dense @ (h @ params.w2)


def gcn_forward_bigcn(params: GCNParams, x, adj):
    """Bi-GCN baseline: BN -> BIN -> BMM -> SCL -> SpMM per layer (Fig. 1),
    logically binarized: fp32 storage and compute."""
    h = _ste_binarize_x(batch_norm(x)) @ _ste_binarize_w(params.w1)
    h = torch.relu(adj @ h)
    h = _ste_binarize_x(batch_norm(h)) @ _ste_binarize_w(params.w2)
    return adj @ h


def gcn_forward_ste_bin(params: GCNParams, x, adj_hat, adj):
    """Training forward of the BitGNN "bin" scheme: binary aggregation over
    the unnormalized 0/1 adjacency ``adj_hat`` in layer 1."""
    h = batch_norm(x) @ _ste_binarize_w(params.w1)   # BN + MM.FB?
    s = straight_through_sign(h)                      # BIN (unit scale)
    agg = adj_hat @ s                                 # binary aggregation
    h1 = straight_through_sign(agg)                   # output BIN
    h2 = h1 @ _ste_binarize_w(params.w2)              # MM.BB?
    return adj @ h2                                   # fp aggregation


class GCNQuant(NamedTuple):
    w1: BinTensor
    w2: BinTensor


def quantize_gcn(params: GCNParams) -> GCNQuant:
    return GCNQuant(*(quantize_weight(w) for w in params))


def gcn_bitgnn_layers(q: GCNQuant, scheme: str = "bin",
                      trinary_mode: str = "s3_two_popc") -> list:
    """Per-layer callables ``fn(bn_tap, h, mats)`` of the GCN bitgnn forward;
    ``mats["adj"]`` is the scaled adjacency, ``mats["bin"]`` the 0/1 one."""
    if scheme == "full":
        l1 = abstraction.MMSpMM("BMM.BBF", "BSpMM.FBF")
        l2 = abstraction.MMSpMM("BMM.BBF", "BSpMM.FBF")
        return [
            lambda bn, h, mats: torch.relu(
                l1(quantize_act(bn(h)), q.w1, mats["adj"])),
            lambda bn, h, mats: l2(quantize_act(bn(h)), q.w2, mats["adj"]),
        ]
    if scheme != "bin":
        raise ValueError(scheme)
    l1 = abstraction.MMSpMM("BMM.FBB", "BSpMM.BBB")
    l2 = abstraction.MMSpMM("BMM.BBF", "BSpMM.FBF")
    return [
        lambda bn, h, mats: l1(bn(h), q.w1, mats["bin"],
                               trinary_mode=trinary_mode, out_scale=False),
        lambda bn, h, mats: l2(h, q.w2, mats["adj"]),
    ]


def gcn_forward_bitgnn(q: GCNQuant, x, adj: frdc.FRDCMatrix,
                       adj_bin: frdc.FRDCMatrix, scheme: str = "bin",
                       trinary_mode: str = "s3_two_popc",
                       bn_stats: Optional[tuple] = None,
                       return_bn_stats: bool = False):
    """BitGNN packed GCN inference.

    scheme="full": BIN -> BMM.BBF -> BSpMM.FBF per layer.
    scheme="bin":  layer 1 BMM.FBB + BSpMM.BBB over the 0/1 adjacency,
                   layer 2 BMM.BBF + BSpMM.FBF (Table 3 "Ours (bin)").
    ``bn_stats``: frozen per-site (mu, sd); ``return_bn_stats=True`` also
    returns the stats computed from this batch.
    """
    return _run_bitgnn_layers(gcn_bitgnn_layers(q, scheme, trinary_mode),
                              x, {"adj": adj, "bin": adj_bin},
                              bn_stats, return_bn_stats)


# ---------------------------------------------------------------------------
# SAGE (mean aggregator + self weight) and SAINT (sum aggregator x2 + FC)
# ---------------------------------------------------------------------------

def sage_forward_fp(params: SAGEParams, x, adj_mean_dense):
    h = x @ params.w1_self + (adj_mean_dense @ x) @ params.w1_agg
    h = torch.relu(h)
    return h @ params.w2_self + (adj_mean_dense @ h) @ params.w2_agg


def sage_forward_bigcn(params: SAGEParams, x, adj_mean):
    xb = _ste_binarize_x(batch_norm(x))
    h = xb @ _ste_binarize_w(params.w1_self) \
        + (adj_mean @ xb) @ _ste_binarize_w(params.w1_agg)
    h = torch.relu(h)
    hb = _ste_binarize_x(batch_norm(h))
    return hb @ _ste_binarize_w(params.w2_self) \
        + (adj_mean @ hb) @ _ste_binarize_w(params.w2_agg)


def saint_forward_fp(params: SAINTParams, x, adj_sum_dense):
    h = x @ params.w1_self + (adj_sum_dense @ x) @ params.w1_agg
    h = torch.relu(h)
    h = h @ params.w2_self + (adj_sum_dense @ h) @ params.w2_agg
    return torch.relu(h) @ params.w_fc


class SAGEQuant(NamedTuple):
    w1_self: BinTensor
    w1_agg: BinTensor
    w2_self: BinTensor
    w2_agg: BinTensor


class SAINTQuant(NamedTuple):
    w1_self: BinTensor
    w1_agg: BinTensor
    w2_self: BinTensor
    w2_agg: BinTensor
    w_fc: BinTensor


def quantize_sage(params: SAGEParams) -> SAGEQuant:
    return SAGEQuant(*(quantize_weight(w) for w in params))


def quantize_saint(params: SAINTParams) -> SAINTQuant:
    return SAINTQuant(*(quantize_weight(w) for w in params))


def _branch_add_layer(w_self: BinTensor, w_agg: BinTensor, relu: bool):
    """One SAGE/SAINT layer: BMM self + BSpMM(BMM agg), merged by ADD."""
    def fn(bn, h, mats):
        hq = quantize_act(bn(h))
        out = bmm(hq, w_self, "BBF") \
            + bspmm(mats["adj"], bmm(hq, w_agg, "BBF"), "FBF")
        return torch.relu(out) if relu else out
    return fn


def sage_bitgnn_layers(q: SAGEQuant) -> list:
    return [_branch_add_layer(q.w1_self, q.w1_agg, True),
            _branch_add_layer(q.w2_self, q.w2_agg, False)]


def saint_bitgnn_layers(q: SAINTQuant) -> list:
    return [_branch_add_layer(q.w1_self, q.w1_agg, True),
            _branch_add_layer(q.w2_self, q.w2_agg, True),
            lambda bn, h, mats: bmm(quantize_act(bn(h)), q.w_fc, "BBF")]


def sage_forward_bitgnn(q: SAGEQuant, x, adj_mean: frdc.FRDCMatrix,
                        bn_stats: Optional[tuple] = None,
                        return_bn_stats: bool = False):
    """BitGNN SAGE: BMM for both branches + BSpMM.FBF mean aggregation after
    the transform, merged by ADD (paper Fig. 2 SAGE.bin)."""
    return _run_bitgnn_layers(sage_bitgnn_layers(q), x, {"adj": adj_mean},
                              bn_stats, return_bn_stats)


def saint_forward_bitgnn(q: SAINTQuant, x, adj_sum: frdc.FRDCMatrix,
                         bn_stats: Optional[tuple] = None,
                         return_bn_stats: bool = False):
    return _run_bitgnn_layers(saint_bitgnn_layers(q), x, {"adj": adj_sum},
                              bn_stats, return_bn_stats)


def bitgnn_layers(family: str, q, scheme: str = "bin",
                  trinary_mode: str = "s3_two_popc") -> list:
    """Family dispatch for the per-layer decomposition."""
    if family == "gcn":
        return gcn_bitgnn_layers(q, scheme, trinary_mode)
    if family == "sage":
        return sage_bitgnn_layers(q)
    if family == "saint":
        return saint_bitgnn_layers(q)
    raise ValueError(f"unknown bitgnn family: {family!r}")


# ---------------------------------------------------------------------------
# Training (full-batch node classification) and evaluation
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, mask):
    """Masked mean NLL: ``sum(nll * mask) / sum(mask)``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    mask = mask.to(logits.dtype)
    return (nll * mask).sum() / mask.sum()


def accuracy(logits, labels, mask) -> float:
    pred = logits.argmax(dim=-1)
    mask = mask.to(torch.float32)
    return float(((pred == labels).to(torch.float32) * mask).sum() / mask.sum())


def train_node_classifier(forward: Callable, params: NamedTuple,
                          inputs: tuple, y: torch.Tensor,
                          train_mask: torch.Tensor, epochs: int = 150,
                          lr: float = 1e-2, weight_decay: float = 5e-4):
    """Full-batch training of any ``forward(params, *inputs)`` model with
    the reference's AdamW. Runs where ``params`` lie; the loop reads nothing
    back from the device until it returns ``(params, float(final loss))``."""
    opt = AdamW(lr=lr, weight_decay=weight_decay)
    state = opt.init(params)
    mask = train_mask.to(torch.float32)
    loss = torch.tensor(float("inf"))
    for _ in range(epochs):
        params = type(params)(*(p.detach().requires_grad_() for p in params))
        loss = cross_entropy(forward(params, *inputs), y, mask)
        grads = torch.autograd.grad(loss, params)
        params, state = opt.update(type(params)(*grads), state, params)
    return type(params)(*(p.detach() for p in params)), float(loss.detach())


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _PackedWeights(nn.Module):
    """Holds a quantized parameter set as buffers: ``<name>_packed`` (int32
    bit-view words of W.T) and ``<name>_scale`` (per-column scales)."""

    def __init__(self, quant: NamedTuple):
        super().__init__()
        self._quant_cls = type(quant)
        self._n = {}
        for name, t in zip(quant._fields, quant):
            self.register_buffer(f"{name}_packed", t.packed)
            self.register_buffer(f"{name}_scale", t.scale)
            self._n[name] = t.n

    def quant(self):
        """The packed weights as the functional forwards take them."""
        return self._quant_cls(*(
            BinTensor(getattr(self, f"{f}_packed"), getattr(self, f"{f}_scale"),
                      self._n[f]) for f in self._quant_cls._fields))


class BitGCN(_PackedWeights):
    """BitGNN GCN; ``forward(x, adj, adj_bin)`` is :func:`gcn_forward_bitgnn`."""

    def __init__(self, params: GCNParams, scheme: str = "bin",
                 trinary_mode: str = "s3_two_popc"):
        super().__init__(quantize_gcn(params))
        self.scheme = scheme
        self.trinary_mode = trinary_mode

    def forward(self, x, adj, adj_bin, bn_stats=None, return_bn_stats=False):
        return gcn_forward_bitgnn(self.quant(), x, adj, adj_bin, self.scheme,
                                  self.trinary_mode, bn_stats, return_bn_stats)


class BitSAGE(_PackedWeights):
    """BitGNN GraphSAGE; ``forward(x, adj_mean)`` is :func:`sage_forward_bitgnn`."""

    def __init__(self, params: SAGEParams):
        super().__init__(quantize_sage(params))

    def forward(self, x, adj_mean, bn_stats=None, return_bn_stats=False):
        return sage_forward_bitgnn(self.quant(), x, adj_mean, bn_stats,
                                   return_bn_stats)


class BitSAINT(_PackedWeights):
    """BitGNN GraphSAINT; ``forward(x, adj_sum)`` is :func:`saint_forward_bitgnn`."""

    def __init__(self, params: SAINTParams):
        super().__init__(quantize_saint(params))

    def forward(self, x, adj_sum, bn_stats=None, return_bn_stats=False):
        return saint_forward_bitgnn(self.quant(), x, adj_sum, bn_stats,
                                    return_bn_stats)
