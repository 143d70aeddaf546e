"""Compiled graph sessions: the (graph, model) serving artifact (reference:
``repro/serve/gnn_session.py``).

A :class:`GraphStore` registers graphs (host-side ``GraphData``) and models
(family + full-precision params) and builds a :class:`CompiledGraphSession`
per (graph, model) pair:

* the FRDC adjacencies the family's packed forward needs, on the session's
  device (GCN: normalized + 0/1; SAGE: mean-normalized; SAINT: 0/1 sum);
* bit-packed quantized weights;
* a variant plan (the default, or tuned on the actual graph), carrying the
  kernel selection (``bspmm_block``, ``fused``);
* full-graph BN calibration: the per-site (mu, sd) statistics, the only
  cross-node statistic of any bitgnn forward, frozen from one full-graph
  pass, so a k-hop subgraph forward reproduces the full-graph computation
  for its seeds;
* a cached full-graph logits fast path, invalidated on feature update.

Artifacts go through :mod:`repro_torch.checkpoint.checkpointer` in the
reference's format (``step_00000000/shard_0.npz`` + ``manifest.json`` and a
``plan.json`` sidecar), so an artifact written by either package restores
in the other.

Feature updates: ``GraphStore.update_features`` records WHICH rows changed.
A session in incremental mode keeps its frozen calibration and patches only
the ``FAMILY_AGG_LAYERS``-hop out-neighborhood of the changed rows in its
cached logits; the default mode recalibrates and recomputes the cache.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..core import frdc
from ..graphs import sampling
from ..graphs.datasets import GraphData
from . import adapters, session_core
from .session_core import (  # re-exported (stable import path)
    FAMILIES, FAMILY_AGG_LAYERS, ServeCore, SessionPlan, bucket_pow2)

__all__ = ["CompiledGraphSession", "GraphEntry", "GraphStore", "ModelEntry",
           "FAMILIES", "FAMILY_AGG_LAYERS", "ServeCore", "SessionPlan",
           "bucket_pow2"]

# retained changelog entries per graph: an incremental session can catch up
# across at most this many feature versions before a full recompute.
CHANGELOG_KEEP = 64


@dataclasses.dataclass
class GraphEntry:
    name: str
    data: GraphData
    version: int = 0
    # (version, changed row ids) per update_features call, most recent last
    changelog: List[Tuple[int, np.ndarray]] = dataclasses.field(
        default_factory=list)
    _csr: Optional[sampling.CSRGraph] = None
    _csr_rev: Optional[sampling.CSRGraph] = None
    _dinv_gcn: Optional[np.ndarray] = None
    _dinv_mean: Optional[np.ndarray] = None

    @property
    def csr(self) -> sampling.CSRGraph:
        if self._csr is None:
            self._csr = sampling.to_csr(self.data.edges, self.data.n_nodes)
        return self._csr

    @property
    def csr_rev(self) -> sampling.CSRGraph:
        """Reverse CSR (sender -> receivers): the out-neighborhood a feature
        change invalidates."""
        if self._csr_rev is None:
            e = self.data.edges
            self._csr_rev = sampling.to_csr(np.stack([e[1], e[0]]),
                                            self.data.n_nodes)
        return self._csr_rev

    @property
    def dinv_gcn(self) -> np.ndarray:
        """Full-graph D^-1/2 (self-loops included): subgraph adjacencies
        index into THIS so seed rows keep the full-graph normalization."""
        if self._dinv_gcn is None:
            n = self.data.n_nodes
            deg = np.bincount(self.data.edges[0], minlength=n) + 1.0
            self._dinv_gcn = 1.0 / np.sqrt(deg)
        return self._dinv_gcn

    @property
    def dinv_mean(self) -> np.ndarray:
        if self._dinv_mean is None:
            n = self.data.n_nodes
            deg = np.bincount(self.data.edges[0], minlength=n).astype(
                np.float64)
            self._dinv_mean = 1.0 / np.maximum(deg, 1.0)
        return self._dinv_mean

    def dinv_for(self, family: str) -> Optional[np.ndarray]:
        if family == "gcn":
            return self.dinv_gcn
        if family == "sage":
            return self.dinv_mean
        return None

    def record_change(self, changed: np.ndarray) -> None:
        self.changelog.append((self.version, np.asarray(changed, np.int64)))
        del self.changelog[:-CHANGELOG_KEEP]

    def changed_since(self, version: int) -> Optional[np.ndarray]:
        """Union of rows changed in (version, self.version], or None when the
        changelog no longer covers that span (recompute fully)."""
        need = list(range(version + 1, self.version + 1))
        have = {v: c for v, c in self.changelog}
        if any(v not in have for v in need):
            return None
        if not need:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate([have[v] for v in need]))


@dataclasses.dataclass
class ModelEntry:
    name: str
    family: str
    params: object


def _params_on(params, device):
    return type(params)(*(torch.as_tensor(w).to(device) for w in params))


class CompiledGraphSession:
    """Per-(graph, model) compiled serving artifact. See module docstring."""

    def __init__(self, graph: GraphEntry, model: ModelEntry,
                 plan: SessionPlan, qparams, khop: int = 2,
                 max_batch: int = 32,
                 adj_full: Optional[Dict[str, frdc.FRDCMatrix]] = None,
                 use_pallas: bool = False, incremental: bool = False,
                 device="cuda"):
        self.graph = graph
        self.model = model
        self.plan = plan
        self.qparams = qparams
        self.khop = khop
        self.max_batch = max_batch
        self.use_pallas = use_pallas
        self.incremental = incremental
        self.device = torch.device(device)
        self.key = f"{graph.name}__{model.name}"
        self.feature_version = -1          # forces first sync to calibrate
        self.bn: Optional[tuple] = None
        self._x_dev: Optional[torch.Tensor] = None
        self._full_cache: Optional[np.ndarray] = None
        self._invalidations = 0
        self._incremental_refreshes = 0
        # adj_full injected on artifact restore (skips re-encoding the graph)
        self._adj_full = (adj_full if adj_full is not None
                          else self._build_full_adjacencies())
        node_cap = self._adj_full[next(iter(self._adj_full))].n_tile_rows \
            * frdc.TILE
        self.adapter = adapters.GNNAdapter(plan)
        self.core = ServeCore(plan, qparams, max_batch, node_cap,
                              use_pallas=use_pallas, adapter=self.adapter,
                              device=self.device)

    # ------------------------------------------------------------ build ----
    def _build_full_adjacencies(self) -> Dict[str, frdc.FRDCMatrix]:
        d, dev = self.graph.data, self.device
        fam = self.plan.family
        if fam == "gcn":
            return {"adj": d.adjacency("gcn", dev),
                    "bin": d.adjacency("binary", dev)}
        if fam == "sage":
            return {"mean": d.adjacency("mean", dev)}
        return {"sum": d.adjacency("binary", dev)}

    def full_forward(self, x: torch.Tensor, bn: Optional[tuple] = None):
        """The full-graph forward: calibrating (returns ``(logits, bn)``)
        when ``bn`` is None, else with the frozen stats ``bn``."""
        if bn is None:
            return session_core.family_forward(
                self.plan, self.qparams, x, self._adj_full,
                use_pallas=self.use_pallas, return_bn_stats=True)
        return session_core.family_forward(
            self.plan, self.qparams, x, self._adj_full,
            use_pallas=self.use_pallas, bn_stats=bn)

    # ------------------------------------------------------------- sync ----
    def sync(self) -> None:
        """Adopt the store's current features. Default: re-upload,
        recalibrate BN and refresh the full-graph logits cache. Incremental
        mode: keep the frozen calibration and patch only the
        out-neighborhood of the changed rows. No-op when already current."""
        if self.feature_version == self.graph.version:
            return
        invalidated = self.feature_version >= 0
        changed = None
        if (self.incremental and invalidated and self.bn is not None
                and self._full_cache is not None):
            changed = self.graph.changed_since(self.feature_version)
        self._x_dev = torch.from_numpy(self.graph.data.x).to(self.device)
        if changed is None:
            out, bn = self.full_forward(self._x_dev)
            self.bn = bn
            self._full_cache = out.cpu().numpy().copy()  # patched in place
        elif changed.size:
            self._refresh_incremental(changed)
        self.feature_version = self.graph.version
        if invalidated:
            self._invalidations += 1

    def _refresh_incremental(self, changed: np.ndarray) -> None:
        """Patch the cached logits of every node whose output can depend on
        a changed row: the FAMILY_AGG_LAYERS-hop closure of ``changed``
        under REVERSE edges. BN stays frozen, so rows outside the closure
        are unchanged."""
        k = FAMILY_AGG_LAYERS[self.plan.family]
        affected = sampling.khop_nodes(self.graph.csr_rev, changed, k)
        n = self.graph.data.n_nodes
        # beyond ~12.5% of the graph the batched subgraph passes cost more
        # than one frozen-stats full pass: patch from that instead
        if affected.size * 8 > n:
            out = self.full_forward(self._x_dev, self.bn).cpu().numpy()
            self._full_cache[affected] = out[affected]
        else:
            for i in range(0, affected.size, self.max_batch):
                chunk = affected[i:i + self.max_batch]
                self._full_cache[chunk] = self._serve_batch(chunk)
        self._incremental_refreshes += 1

    @property
    def invalidations(self) -> int:
        return self._invalidations

    @property
    def incremental_refreshes(self) -> int:
        return self._incremental_refreshes

    @property
    def compile_count(self) -> int:
        """Distinct padded shapes the bucketed subgraph forward has run."""
        return self.core.compile_count

    @property
    def dispatch_count(self) -> int:
        """Launches issued (a multi-bucket co-launch counts 1)."""
        return self.core.n_dispatches

    def set_trace_hook(self, cb) -> None:
        """Wire ``cb(label, shape_dict)`` to fire on every NEW padded shape
        of this session's serve core. ``None`` unwires."""
        self.core.on_trace = (None if cb is None
                              else (lambda shape: cb("core", shape)))

    # ------------------------------------------------------ full path ------
    def full_logits(self) -> np.ndarray:
        """Cached full-graph inference (the fast path for warm graphs)."""
        self.sync()
        return self._full_cache

    # -------------------------------------------------- subgraph path ------
    def _extract(self, uniq_seeds: np.ndarray):
        """Host-side k-hop extraction + subgraph FRDC build (no device
        work; warmup probes steady-state shapes with it)."""
        ex = sampling.extract_khop(self.graph.csr, uniq_seeds, self.khop)
        dinv = self.graph.dinv_for(self.plan.family)
        mats = self.adapter.sub_operands(
            ex.sub_nodes.size, ex.sub_edges,
            None if dinv is None else dinv[ex.sub_nodes])
        return ex.sub_nodes, mats, ex.seed_pos

    def prepare_batch(self, seeds: np.ndarray) -> session_core.PreparedBatch:
        """EXTRACT stage: k-hop extract, build the subgraph FRDC and
        bucket-pad: host work only, producing the launch-ready
        :class:`~repro_torch.serve.session_core.PreparedBatch`. It does not
        adopt new features (that is card work): the caller runs
        :meth:`sync` first, as :meth:`serve_subgraph` and the engine's pick
        on the main thread do."""
        seeds = np.asarray(seeds, np.int64)
        uniq, inverse = np.unique(seeds, return_inverse=True)
        sub_nodes, mats, seed_pos = self._extract(uniq)
        staged = self.core.stage(self.graph.data.x[sub_nodes], mats,
                                 seed_pos)
        group = session_core.PreparedGroup(
            core=self.core, sel=np.arange(uniq.size), staged=staged)
        return session_core.PreparedBatch(n_uniq=uniq.size, inverse=inverse,
                                          groups=[group], bn=self.bn)

    def launch_batch(self, prepared) -> list:
        """COMPUTE-stage head: launch the forward(s) without waiting (with
        the calibration captured when the batch was staged)."""
        return prepared.launch()

    def finish_batch(self, prepared, devs) -> np.ndarray:
        """COMPUTE-stage tail: wait and reassemble request-order logits."""
        return prepared.finish(devs)

    def _serve_batch(self, uniq_seeds: np.ndarray) -> np.ndarray:
        """One extraction + bucketed forward for <= max_batch unique seeds,
        against the CURRENT features and frozen calibration (no sync)."""
        sub_nodes, mats, seed_pos = self._extract(uniq_seeds)
        return self.core.run(self.graph.data.x[sub_nodes], mats, seed_pos,
                             self.bn)

    def serve_subgraph(self, seeds: np.ndarray) -> np.ndarray:
        """Micro-batched node-level inference: k-hop extraction -> bucket
        padding -> forward -> (len(seeds), n_out) logits, through the same
        prepare/launch/finish stages a pipelined engine drives."""
        self.sync()
        prepared = self.prepare_batch(seeds)
        return self.finish_batch(prepared, self.launch_batch(prepared))

    def warmup(self, rng: Optional[np.random.Generator] = None,
               probes: int = 16, margin: float = 1.125) -> int:
        """Drive the high-water shape bucket to its steady value and run it
        once. Probes ``probes`` max-width batches HOST-SIDE ONLY to find the
        largest node/group counts, sets the water marks ``margin`` above
        them (pow2-rounded), and runs one real forward. Returns the new
        programs it added."""
        rng = rng or np.random.default_rng(0)
        before = self.core.compile_count
        self.sync()
        n = self.graph.data.n_nodes
        n_max, g_max = 0, {}
        for _ in range(probes):
            seeds = np.unique(rng.integers(0, n, size=self.max_batch))
            sub_nodes, mats, _ = self._extract(seeds)
            n_max = max(n_max, sub_nodes.size)
            for k, m in mats.items():
                g_max[k] = max(g_max.get(k, 0), m.n_groups)
        self.core.preset_water(n_max, g_max, margin)
        self.serve_subgraph(rng.integers(0, n, size=self.max_batch))
        return self.core.compile_count - before

    # ------------------------------------------------------- artifact ------
    def _state(self) -> dict:
        # bn stats are not serialized: the first sync() after load
        # recomputes them in the pass that fills the logits cache
        return {"qparams": session_core.quant_to_host(self.qparams),
                "adj": {k: session_core.frdc_to_host(m)
                        for k, m in self._adj_full.items()}}

    def fingerprint(self) -> dict:
        return session_core.session_fingerprint(self.graph, self.model)

    def save(self, directory) -> None:
        """Serialize the artifact: arrays in step_0, plan + static dims +
        fingerprint in plan.json."""
        self.sync()
        ckpt = Checkpointer(directory, keep=1)
        ckpt.save(0, self._state(), blocking=True)
        sidecar = dict(
            plan=self.plan.to_json(), fingerprint=self.fingerprint(),
            khop=self.khop, max_batch=self.max_batch,
            adj_dims={k: [m.n_rows, m.n_cols, m.nnz]
                      for k, m in self._adj_full.items()})
        (Path(directory) / "plan.json").write_text(json.dumps(sidecar))

    @classmethod
    def load(cls, directory, graph: GraphEntry, model: ModelEntry,
             khop: Optional[int] = None, max_batch: Optional[int] = None,
             use_pallas: bool = False, incremental: bool = False,
             bspmm_block="unchanged", fused="unchanged", device="cuda",
             ) -> Optional["CompiledGraphSession"]:
        """Restore a session artifact; returns None on any mismatch (missing
        files, different graph/model/features, a khop/max_batch or kernel
        selection that differs from what the caller wants) so the caller
        rebuilds. The adjacency encode is skipped: the FRDC arrays come
        from the checkpoint."""
        directory = Path(directory)
        sidecar_path = directory / "plan.json"
        sidecar = session_core.load_sidecar(
            sidecar_path, required=("plan", "fingerprint", "khop",
                                    "max_batch", "adj_dims"))
        if sidecar is None:
            return None
        if khop is not None and sidecar["khop"] != khop:
            return None
        if max_batch is not None and sidecar["max_batch"] != max_batch:
            return None
        if session_core.session_fingerprint(graph, model) \
                != sidecar["fingerprint"]:
            return None
        try:
            plan = SessionPlan.from_json(sidecar["plan"])
        except (KeyError, TypeError, ValueError) as e:
            raise session_core.ArtifactError(sidecar_path, field="plan",
                                             detail=repr(e))
        if bspmm_block != "unchanged" and plan.bspmm_block != bspmm_block:
            return None
        if fused != "unchanged" and plan.fused != fused:
            return None
        like = {"qparams": session_core.quantize_family(
                    model.family, _params_on(model.params, "cpu")),
                "adj": session_core.adj_like(model.family)}
        state = session_core.restore_artifact_state(directory, like)
        if state is None:
            return None
        dims = sidecar["adj_dims"]
        adj_full = {k: session_core.frdc_from_host(v, dims[k], device)
                    for k, v in state["adj"].items()}
        return cls(graph, model, plan,
                   session_core.coerce_quant(state["qparams"], device),
                   khop=sidecar["khop"], max_batch=sidecar["max_batch"],
                   adj_full=adj_full, use_pallas=use_pallas,
                   incremental=incremental, device=device)


# ---------------------------------------------------------------------------
# Store
# ---------------------------------------------------------------------------

class GraphStore:
    """Registry of graphs + models producing cached compiled sessions on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cache_dir: Optional[str] = None, khop: int = 2,
                 max_batch: int = 32, use_pallas: bool = False,
                 incremental: bool = False,
                 bspmm_block: Optional[Tuple[int, int]] = None,
                 fused: bool = False,
                 tuner_cache: Optional[str] = None, device="cuda"):
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.khop = khop
        self.max_batch = max_batch
        self.use_pallas = use_pallas
        self.incremental = incremental
        self.device = torch.device(device)
        # BSpMM block-shape and fused-kernel selection, recorded in every
        # plan this store builds (and so in plan.json)
        self.bspmm_block = (None if bspmm_block is None
                            else tuple(bspmm_block))
        self.fused = bool(fused)
        from . import tuner_cache as tuner_cache_mod
        self.tuner_cache = (tuner_cache_mod.TunerCache(tuner_cache)
                            if tuner_cache else None)
        self.graphs: Dict[str, GraphEntry] = {}
        self.models: Dict[str, ModelEntry] = {}
        self._sessions: Dict[Tuple[str, str], CompiledGraphSession] = {}
        self._sharded_sessions: Dict[tuple, object] = {}

    # -------------------------------------------------------- registry ----
    def register_graph(self, name: str, data: GraphData) -> GraphEntry:
        entry = GraphEntry(name=name, data=data)
        self.graphs[name] = entry
        return entry

    def register_model(self, name: str, family: str, params) -> ModelEntry:
        if family not in FAMILIES:
            raise ValueError(f"unknown family {family!r}; have {FAMILIES}")
        entry = ModelEntry(name=name, family=family, params=params)
        self.models[name] = entry
        return entry

    def update_features(self, name: str, x: np.ndarray) -> None:
        """Swap node features; sessions recalibrate or patch their caches on
        next use. In incremental mode the CHANGED rows are diffed and
        recorded (the refresh changelog)."""
        entry = self.graphs[name]
        x = np.asarray(x, np.float32)
        if x.shape != entry.data.x.shape:
            raise ValueError(f"feature shape {x.shape} != "
                             f"{entry.data.x.shape} (graph structure and "
                             f"feature width are fixed per registration)")
        changed = (np.nonzero((entry.data.x != x).any(axis=1))[0]
                   if self.incremental else None)
        entry.data.x = x
        entry.version += 1
        if changed is not None:
            entry.record_change(changed)

    def _plan_block(self, g: GraphEntry) -> Optional[Tuple[int, int]]:
        """The block shape new plans get: an explicit store block wins;
        otherwise a tuner-cache hit for this graph's stats (same backend
        and fused flag); else the 1D kernels."""
        if self.bspmm_block is not None or self.tuner_cache is None:
            return self.bspmm_block
        from .tuner_cache import graph_stats
        return self.tuner_cache.lookup(graph_stats(g.data), fused=self.fused,
                                       backend=self.device.type)

    # --------------------------------------------------------- compile ----
    def session(self, graph: str, model: str, tune: bool = False,
                tune_repeats: int = 2) -> CompiledGraphSession:
        key = (graph, model)
        if key in self._sessions:
            return self._sessions[key]
        g, m = self.graphs[graph], self.models[model]

        sess = None
        sess_dir = (self.cache_dir / f"{graph}__{model}"
                    if self.cache_dir else None)
        blk = self._plan_block(g)
        if sess_dir is not None:
            sess = CompiledGraphSession.load(
                sess_dir, g, m, khop=self.khop, max_batch=self.max_batch,
                use_pallas=self.use_pallas, incremental=self.incremental,
                bspmm_block=blk, fused=self.fused, device=self.device)
        if sess is None:
            qparams = session_core.quantize_family(
                m.family, _params_on(m.params, self.device))
            plan = (session_core.tune_plan(g.data, m.family, qparams,
                                           repeats=tune_repeats,
                                           device=self.device)
                    if tune else session_core.default_plan(m.family))
            plan = dataclasses.replace(plan, bspmm_block=blk,
                                       fused=self.fused)
            sess = CompiledGraphSession(
                g, m, plan, qparams, khop=self.khop,
                max_batch=self.max_batch, use_pallas=self.use_pallas,
                incremental=self.incremental, device=self.device)
            sess.sync()
            if sess_dir is not None:
                sess.save(sess_dir)
        self._sessions[key] = sess
        return sess

    def sharded_session(self, graph: str, model: str, n_shards: int,
                        tune: bool = False, tune_repeats: int = 2,
                        executor: str = "host",
                        bn_mode: str = "single_host"):
        """Compile (or restore) a partitioned session serving ``graph``
        from ``n_shards`` shards on the store's device. ``executor`` and
        ``bn_mode`` select the distributed-pass implementation and the BN
        calibration source; both are part of the cache key. See
        :mod:`repro_torch.serve.sharded`."""
        from .sharded import ShardedGraphSession, ShardPlanner
        from .sharded.session import check_modes
        check_modes(executor, bn_mode)
        key = (graph, model, int(n_shards), executor, bn_mode)
        if key in self._sharded_sessions:
            return self._sharded_sessions[key]
        g, m = self.graphs[graph], self.models[model]

        sess = None
        sess_dir = (self.cache_dir / f"{graph}__{model}__P{n_shards}"
                    if self.cache_dir else None)
        blk = self._plan_block(g)
        if sess_dir is not None:
            sess = ShardedGraphSession.load(
                sess_dir, g, m, khop=self.khop, max_batch=self.max_batch,
                use_pallas=self.use_pallas, executor=executor,
                bn_mode=bn_mode, bspmm_block=blk, fused=self.fused,
                device=self.device)
        if sess is None:
            qparams = session_core.quantize_family(
                m.family, _params_on(m.params, self.device))
            plan = (session_core.tune_plan(g.data, m.family, qparams,
                                           repeats=tune_repeats,
                                           device=self.device)
                    if tune else session_core.default_plan(m.family))
            plan = dataclasses.replace(plan, bspmm_block=blk,
                                       fused=self.fused)
            shard_plan = ShardPlanner(n_shards).plan(g.data, m.family)
            sess = ShardedGraphSession(
                g, m, plan, qparams, shard_plan, khop=self.khop,
                max_batch=self.max_batch, use_pallas=self.use_pallas,
                executor=executor, bn_mode=bn_mode, device=self.device)
            sess.sync()
            if sess_dir is not None:
                sess.save(sess_dir)
        self._sharded_sessions[key] = sess
        return sess
