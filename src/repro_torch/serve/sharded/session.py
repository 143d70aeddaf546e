"""ShardedGraphSession: one (graph, model) serving artifact split over P
shards (reference: ``repro/serve/sharded/session.py``).

Compared with the single-host
:class:`~repro_torch.serve.gnn_session.CompiledGraphSession`, the graph
state is partitioned (contiguous tile-row-aligned node ranges,
:mod:`.planner`): each shard owns its feature rows, its block of the CSR,
an intra-shard FRDC adjacency and a halo adjacency over the boundary edges.
Serving has two paths:

* **routed subgraph**: a k-hop query is answered by its seed's OWNING
  shard. The frontier is routed across shard boundaries (:mod:`.routing`),
  remote features and factorization entries are fetched through the halo
  loopback, and the owner's :class:`~repro_torch.serve.session_core.
  ServeCore` runs the same bucketed forward as the single-host session with
  the same frozen BN stats, so the answers equal single-host serving's for
  the same per-owner micro-batches.
* **distributed full pass**: layer-wise per-shard aggregation ``intra @
  local + halo @ remote``, the remote operand arriving by halo exchange;
  the binary layer of GCN "bin" exchanges packed words and adds integer
  counts exactly. It fills the per-shard full-logits caches.

The pass runs through a :class:`~repro_torch.serve.session_core.
LayerExecutor`: ``executor="host"`` is :class:`~.executor.
HostLayerExecutor`. ``"spmd"`` (one program per layer over P cards, the
ring exchange inside it) raises :class:`NotImplementedError`: it waits for
the multi-card slice, ROADMAP Queue 1 item 5.

BN calibration (``bn_mode=``): ``"single_host"`` freezes the stats of one
full-graph forward through the shared
:func:`~repro_torch.serve.session_core.family_forward` (the single-host
session's calibration); ``"distributed"`` computes each site's (mu, sd)
inside the distributed pass itself.

Artifacts (per-shard FRDC + CSR + routing table) go through the
checkpointer in the reference's format with a ``routing.json`` sidecar, so
an artifact written by either package restores in the other without
re-partitioning or re-tuning.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ...checkpoint.checkpointer import Checkpointer
from ...core import frdc
from ...graphs import sampling
from .. import adapters, session_core
from ..session_core import ServeCore, SessionPlan
from . import halo as halo_mod
from .executor import HostLayerExecutor
from .planner import ShardPart, ShardPlan, SpmdPlan
from .routing import RoutingTable, ShardedCSR
from .routing import khop_subgraph as routed_khop_subgraph

EXECUTORS = ("host", "spmd")
BN_MODES = ("single_host", "distributed")


def check_modes(executor: str, bn_mode: str) -> None:
    """Refuse an unknown executor or BN mode, and the SPMD executor, which
    is not ported."""
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r}; have {EXECUTORS}")
    if executor == "spmd":
        raise NotImplementedError(
            "executor='spmd' is not ported: it needs P cards and the ring "
            "exchange over torch.distributed (ROADMAP Queue 1 item 5, "
            "Slice C: SpmdLayerExecutor); use executor='host'")
    if bn_mode not in BN_MODES:
        raise ValueError(f"unknown bn_mode {bn_mode!r}; have {BN_MODES}")


class ShardedGraphSession:
    """Partitioned serving artifact on ``device``. See module docstring."""

    def __init__(self, graph, model, plan: SessionPlan, qparams,
                 shard_plan: ShardPlan, khop: int = 2, max_batch: int = 32,
                 use_pallas: bool = False, executor: str = "host",
                 bn_mode: str = "single_host", device="cuda"):
        if shard_plan.family != plan.family:
            raise ValueError(f"shard plan family {shard_plan.family!r} != "
                             f"session family {plan.family!r}")
        check_modes(executor, bn_mode)
        self.graph = graph
        self.model = model
        self.plan = plan
        self.qparams = qparams
        self.shard_plan = shard_plan
        self.routing: RoutingTable = shard_plan.routing
        self.khop = khop
        self.max_batch = max_batch
        self.use_pallas = use_pallas
        self.executor = executor
        self.bn_mode = bn_mode
        self.device = torch.device(device)
        self.key = f"{graph.name}__{model.name}__P{shard_plan.n_shards}"
        self.feature_version = -1
        self.bn: Optional[tuple] = None
        self.halo_stats = halo_mod.HaloStats()
        self._caches: Optional[List[np.ndarray]] = None
        self._assembled: Optional[np.ndarray] = None
        self._invalidations = 0
        self._scsr: ShardedCSR = shard_plan.sharded_csr()
        self._adj_full: Optional[Dict[str, frdc.FRDCMatrix]] = None
        self._executor_obj: Optional[session_core.LayerExecutor] = None
        self.program = session_core.build_layer_program(plan, qparams)
        # one bucketed serve core per shard, all composing ONE stateless
        # family adapter; a routed subgraph can span the whole graph, so
        # every core's node cap is the full padded graph
        node_cap = -(-shard_plan.n_nodes // frdc.TILE) * frdc.TILE
        self.adapter = adapters.GNNAdapter(plan)
        self.cores = [ServeCore(plan, qparams, max_batch, node_cap,
                                use_pallas=use_pallas, adapter=self.adapter,
                                device=self.device)
                      for _ in range(shard_plan.n_shards)]
        # observability callback cb(label, shape_dict), fanned out to every
        # per-shard core and (on build) the layer executor
        self._trace_hook = None

    # ------------------------------------------------------------ state ----
    @property
    def n_shards(self) -> int:
        return self.shard_plan.n_shards

    @property
    def parts(self) -> List[ShardPart]:
        return self.shard_plan.parts

    @property
    def compile_count(self) -> int:
        """Distinct padded shapes across the per-shard serve cores."""
        return sum(c.compile_count for c in self.cores)

    @property
    def compile_count_by_shard(self) -> List[int]:
        return [c.compile_count for c in self.cores]

    @property
    def dispatch_count(self) -> int:
        """Launches across the per-shard serve cores (a multi-bucket
        co-launch counts 1 per participating core)."""
        return sum(c.n_dispatches for c in self.cores)

    @property
    def invalidations(self) -> int:
        return self._invalidations

    def _x_blocks(self) -> List[np.ndarray]:
        x = self.graph.data.x
        return [x[p.row_start:p.row_end] for p in self.parts]

    def _dinv_blocks(self) -> Optional[List[np.ndarray]]:
        if self.parts[0].dinv is None:
            return None
        return [p.dinv for p in self.parts]

    # ------------------------------------------------------- executor ------
    @property
    def layer_executor(self) -> session_core.LayerExecutor:
        """The distributed-pass executor (built on first use)."""
        if self._executor_obj is None:
            self._executor_obj = HostLayerExecutor(
                self.parts, self.shard_plan.spmd_plan(), self.plan,
                self.halo_stats, self.routing, use_pallas=self.use_pallas,
                device=self.device)
            self._wire_executor_hook()
        return self._executor_obj

    def set_trace_hook(self, cb) -> None:
        """Wire ``cb(label, shape_dict)`` to fire on every NEW program of
        any per-shard serve core (``shard<i>/core``) or of the layer
        executor (``executor/host/stage<i>`` and ``.../operand<i>``).
        ``None`` unwires. An executor built later inherits the hook."""
        self._trace_hook = cb
        for i, core in enumerate(self.cores):
            if cb is None:
                core.on_trace = None
            else:
                core.on_trace = (lambda shape, _i=i:
                                 cb(f"shard{_i}/core", shape))
        self._wire_executor_hook()

    def _wire_executor_hook(self) -> None:
        if self._executor_obj is None:
            return
        cb = self._trace_hook
        self._executor_obj.on_trace = (
            None if cb is None
            else (lambda label, shape: cb(f"executor/{label}", shape)))

    @property
    def executor_compile_count(self) -> int:
        """Distinct layer programs of the distributed pass (see
        :attr:`HostLayerExecutor.compile_count`)."""
        return (0 if self._executor_obj is None
                else self._executor_obj.compile_count)

    # ------------------------------------------------------- calibrate -----
    def _calibrate(self) -> tuple:
        """BN stats of the shared full-graph calibration forward: the
        computation the single-host session freezes its stats from, so a
        sharded and a single-host session over one graph agree on them."""
        if self._adj_full is None:
            d, dev = self.graph.data, self.device
            fam = self.plan.family
            if fam == "gcn":
                self._adj_full = {"adj": d.adjacency("gcn", dev),
                                  "bin": d.adjacency("binary", dev)}
            elif fam == "sage":
                self._adj_full = {"mean": d.adjacency("mean", dev)}
            else:
                self._adj_full = {"sum": d.adjacency("binary", dev)}
        x = torch.from_numpy(self.graph.data.x).to(self.device)
        _, bn = session_core.family_forward(
            self.plan, self.qparams, x, self._adj_full,
            use_pallas=self.use_pallas, return_bn_stats=True)
        return bn

    def sync(self) -> None:
        """Adopt the store's current features: recalibrate BN and refresh
        the per-shard logits caches through the distributed pass.
        ``bn_mode="single_host"`` freezes the stats from the full-graph
        anchor first; ``"distributed"`` computes them inside the pass. No-op
        when current."""
        if self.feature_version == self.graph.version:
            return
        invalidated = self.feature_version >= 0
        if self.bn_mode == "distributed":
            self._caches, self.bn = self.layer_executor.run_pass(
                self.program, self._x_blocks(), None, calibrate=True)
        else:
            self.bn = self._calibrate()
            self._caches, _ = self.layer_executor.run_pass(
                self.program, self._x_blocks(), self.bn)
        self._assembled = None
        self.feature_version = self.graph.version
        if invalidated:
            self._invalidations += 1

    # ----------------------------------------------------- full pass -------
    def run_distributed_pass(self) -> List[np.ndarray]:
        """One distributed full pass with the CURRENT frozen calibration
        (no cache mutation)."""
        self.sync()
        blocks, _ = self.layer_executor.run_pass(
            self.program, self._x_blocks(), self.bn)
        return blocks

    def full_logits(self) -> np.ndarray:
        """Full-graph logits assembled from the per-shard caches (each
        filled by the distributed pass), memoized per feature version."""
        self.sync()
        if self._assembled is None:
            self._assembled = np.concatenate(self._caches, axis=0)
        return self._assembled

    # -------------------------------------------------- subgraph path ------
    def _extract(self, uniq_seeds: np.ndarray):
        """Routed k-hop extraction + subgraph FRDC build for one owner's
        seed group (host work; warmup probes shapes with it)."""
        ex = sampling.ExtractedSubgraph(*routed_khop_subgraph(
            self._scsr, uniq_seeds, self.khop))
        dinv_blocks = self._dinv_blocks()
        dinv_sub = None
        if dinv_blocks is not None:
            dinv_sub = halo_mod.gather_rows(dinv_blocks, self.routing,
                                            ex.sub_nodes)
        mats = self.adapter.sub_operands(ex.sub_nodes.size, ex.sub_edges,
                                         dinv_sub)
        return ex.sub_nodes, mats, ex.seed_pos

    def prepare_batch(self, seeds: np.ndarray) -> session_core.PreparedBatch:
        """EXTRACT stage: routed k-hop extraction, halo feature fetch and
        bucket padding for every owner group in the batch: host work only
        (the ``serve/x`` halo bytes are counted here, where the gather is).
        It does not adopt new features (the distributed pass is card work):
        the caller runs :meth:`sync` first, as :meth:`serve_subgraph` and
        the engine's pick on the main thread do."""
        seeds = np.asarray(seeds, np.int64)
        uniq, inverse = np.unique(seeds, return_inverse=True)
        owners = self.routing.owner(uniq)
        groups = []
        for s in np.unique(owners):
            sel = np.nonzero(owners == s)[0]
            sub_nodes, mats, seed_pos = self._extract(uniq[sel])
            x_sub = halo_mod.gather_rows(self._x_blocks(), self.routing,
                                         sub_nodes, home=int(s),
                                         stats=self.halo_stats, tag="serve/x")
            staged = self.cores[int(s)].stage(x_sub, mats, seed_pos)
            groups.append(session_core.PreparedGroup(
                core=self.cores[int(s)], sel=sel, staged=staged))
        return session_core.PreparedBatch(n_uniq=uniq.size, inverse=inverse,
                                          groups=groups,
                                          out_shape=self._out_shape(),
                                          bn=self.bn)

    def launch_batch(self, prepared) -> list:
        """COMPUTE-stage head: launch every owner group's forward (with the
        calibration captured when the batch was staged)."""
        return prepared.launch()

    def finish_batch(self, prepared, devs) -> np.ndarray:
        """COMPUTE-stage tail: wait and merge owner groups back into
        request order."""
        return prepared.finish(devs)

    def serve_subgraph(self, seeds: np.ndarray) -> np.ndarray:
        """Node-level inference across shards: group the batch by owning
        shard, answer each group on its owner, merge back into request
        order, through the prepare/launch/finish stages."""
        self.sync()
        prepared = self.prepare_batch(seeds)
        return self.finish_batch(prepared, self.launch_batch(prepared))

    def seed_halo_tiles(self, node: int) -> frozenset:
        """Per-seed halo signature for halo-aware batch formation: the FRDC
        tile ids (global node id // TILE) of the seed's REMOTE 1-hop
        neighbours."""
        owner = int(self.routing.owner(np.asarray([node]))[0])
        lo, hi = self.routing.shard_range(owner)
        nbrs = self._scsr.shards[owner].neighbors(int(node) - lo)
        remote = nbrs[(nbrs < lo) | (nbrs >= hi)]
        return frozenset((remote // frdc.TILE).tolist())

    def _out_shape(self) -> tuple:
        if self._caches is not None:
            return self._caches[0].shape[1:]
        q = self.qparams
        last = q[-2] if self.plan.family == "sage" else q[-1]
        return (last.packed.shape[0],)    # BinTensor of W.T: rows = outputs

    def warmup(self, rng: Optional[np.random.Generator] = None,
               probes: int = 16, margin: float = 1.125) -> int:
        """Per-shard high-water warmup: probe ``probes`` max-width batches
        on the host, route each probe's seeds to their owners (and probe
        every shard at full width from its own range), preset each core's
        water marks, then serve one batch. Returns the programs added."""
        rng = rng or np.random.default_rng(0)
        before = self.compile_count
        self.sync()
        n = self.shard_plan.n_nodes
        n_max = [0] * self.n_shards
        g_max: List[Dict[str, int]] = [{} for _ in range(self.n_shards)]

        def _probe(s: int, seeds: np.ndarray) -> None:
            sub_nodes, mats, _ = self._extract(seeds)
            n_max[s] = max(n_max[s], sub_nodes.size)
            for k, m in mats.items():
                g_max[s][k] = max(g_max[s].get(k, 0), m.n_groups)

        for _ in range(probes):
            seeds = np.unique(rng.integers(0, n, size=self.max_batch))
            owners = self.routing.owner(seeds)
            for s in np.unique(owners):
                _probe(s, seeds[owners == s])
            for s in range(self.n_shards):
                lo, hi = self.routing.shard_range(s)
                if hi > lo:
                    _probe(s, np.unique(rng.integers(lo, hi,
                                                     size=self.max_batch)))
        for s, core in enumerate(self.cores):
            if n_max[s]:
                core.preset_water(n_max[s], g_max[s], margin)
        self.serve_subgraph(rng.integers(0, n, size=self.max_batch))
        return self.compile_count - before

    # ------------------------------------------------------- artifact ------
    def fingerprint(self) -> dict:
        return session_core.session_fingerprint(self.graph, self.model)

    def _state(self) -> dict:
        shards = []
        for p in self.parts:
            shards.append({
                "intra": {k: session_core.frdc_to_host(m)
                          for k, m in p.intra.items()},
                "halo": {k: session_core.frdc_to_host(m)
                         for k, m in p.halo.items()},
                "halo_nodes": p.halo_nodes,
                "indptr": p.indptr, "indices": p.indices,
                **({} if p.dinv is None else {"dinv": p.dinv}),
            })
        return {"qparams": session_core.quant_to_host(self.qparams),
                "shards": shards}

    def save(self, directory) -> None:
        """Serialize per-shard FRDC + CSR + routing table via the
        checkpointer; plan, fingerprint and dims in ``routing.json``."""
        self.sync()
        directory = Path(directory)
        ckpt = Checkpointer(directory, keep=1)
        ckpt.save(0, self._state(), blocking=True)
        sidecar = dict(
            plan=self.plan.to_json(), fingerprint=self.fingerprint(),
            khop=self.khop, max_batch=self.max_batch,
            n_shards=self.n_shards,
            routing=self.routing.to_json(),
            spmd=self.shard_plan.spmd_plan().to_json(),
            shards=[dict(
                row_start=p.row_start, row_end=p.row_end, n_halo=p.n_halo,
                intra_dims={k: [m.n_rows, m.n_cols, m.nnz]
                            for k, m in p.intra.items()},
                halo_dims={k: [m.n_rows, m.n_cols, m.nnz]
                           for k, m in p.halo.items()},
            ) for p in self.parts])
        (directory / "routing.json").write_text(json.dumps(sidecar))

    @classmethod
    def load(cls, directory, graph, model, khop: Optional[int] = None,
             max_batch: Optional[int] = None, use_pallas: bool = False,
             executor: str = "host", bn_mode: str = "single_host",
             bspmm_block="unchanged", fused="unchanged", device="cuda",
             ) -> Optional["ShardedGraphSession"]:
        """Restore a sharded artifact WITHOUT re-partitioning or re-tuning;
        returns None on any mismatch so the caller replans. ``executor`` and
        ``bn_mode`` are runtime choices, not artifact properties; sidecars
        without the ``spmd`` field rebuild it from the restored parts."""
        directory = Path(directory)
        sidecar_path = directory / "routing.json"
        sidecar = session_core.load_sidecar(
            sidecar_path, required=("plan", "fingerprint", "khop",
                                    "max_batch", "n_shards", "routing",
                                    "shards"))
        if sidecar is None:
            return None
        if khop is not None and sidecar["khop"] != khop:
            return None
        if max_batch is not None and sidecar["max_batch"] != max_batch:
            return None
        try:
            plan = SessionPlan.from_json(sidecar["plan"])
        except (KeyError, TypeError, ValueError) as e:
            raise session_core.ArtifactError(sidecar_path, field="plan",
                                             detail=repr(e))
        if session_core.session_fingerprint(graph, model) \
                != sidecar["fingerprint"]:
            return None
        if bspmm_block != "unchanged" and plan.bspmm_block != bspmm_block:
            return None
        if fused != "unchanged" and plan.fused != fused:
            return None
        fam = model.family
        has_dinv = fam in ("gcn", "sage")
        kinds = session_core.FAMILY_ADJ_KINDS[fam]
        adj_like = session_core.adj_like(fam)   # halo: the same fields
        like_shards = [{
            "intra": {k: adj_like[k] for k in kinds},
            "halo": {k: adj_like[k] for k in kinds},
            "halo_nodes": np.zeros(0, np.int64),
            "indptr": np.zeros(0, np.int64),
            "indices": np.zeros(0, np.int64),
            **({"dinv": np.zeros(0)} if has_dinv else {}),
        } for _ in sidecar["shards"]]
        like = {"qparams": session_core.quantize_family(
                    fam, type(model.params)(*(torch.as_tensor(w).cpu()
                                              for w in model.params))),
                "shards": like_shards}
        state = session_core.restore_artifact_state(directory, like)
        if state is None:
            return None
        try:
            routing = RoutingTable.from_json(sidecar["routing"])
        except (KeyError, TypeError, ValueError) as e:
            raise session_core.ArtifactError(sidecar_path, field="routing",
                                             detail=repr(e))
        parts = []
        for s, (sd, st) in enumerate(zip(sidecar["shards"],
                                         state["shards"])):
            intra = {k: session_core.frdc_from_host(
                st["intra"][k], sd["intra_dims"][k], "cpu") for k in kinds}
            halo_m = {k: session_core.frdc_from_host(
                st["halo"][k], sd["halo_dims"][k], "cpu") for k in kinds}
            parts.append(ShardPart(
                index=s, row_start=int(sd["row_start"]),
                row_end=int(sd["row_end"]),
                halo_nodes=np.asarray(st["halo_nodes"], np.int64),
                intra=intra, halo=halo_m,
                indptr=np.asarray(st["indptr"], np.int64),
                indices=np.asarray(st["indices"], np.int64),
                dinv=(np.asarray(st["dinv"]) if has_dinv else None)))
        spmd = (SpmdPlan.from_json(sidecar["spmd"])
                if "spmd" in sidecar else None)
        shard_plan = ShardPlan(family=fam, routing=routing, parts=parts,
                               n_nodes=int(graph.data.n_nodes),
                               n_edges=int(graph.data.n_edges), spmd=spmd)
        return cls(graph, model, plan,
                   session_core.coerce_quant(state["qparams"], device),
                   shard_plan, khop=sidecar["khop"],
                   max_batch=sidecar["max_batch"], use_pallas=use_pallas,
                   executor=executor, bn_mode=bn_mode, device=device)
