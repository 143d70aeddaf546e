"""Shard planning: cut a graph into P serving shards (reference:
``repro/serve/sharded/planner.py``).

``ShardPlanner`` reuses :mod:`repro_torch.graphs.partition`'s edge-balanced
tile-row-aligned boundaries and builds, per shard:

  * an **intra-shard FRDC adjacency** per adjacency kind the family's packed
    forward needs (rows AND columns local to the shard);
  * a **halo FRDC adjacency** per kind: the boundary edges (local row, remote
    column), columns re-indexed into the shard's sorted ``halo_nodes`` list —
    the bit-packed structure the layer-wise halo exchange aggregates over;
  * the shard's rows of the graph CSR (global column ids) for routed k-hop
    extraction;
  * the shard's slice of the FULL-graph factorization vector (GCN D^-1/2 /
    SAGE D^-1), so subgraph adjacencies assembled from any mix of shards
    normalize exactly like the full graph.

Every edge of the input lands in exactly one shard's intra OR halo
adjacency; self-loops added by the GCN normalization are intra by
construction. The plan is host state, built with numpy exactly as the
reference builds it (the FRDC matrices as CPU tensors): the layer
executor copies its padded operands to the session's device.
:func:`validate_reshard` is the replica tier's pre-swap check of a live
reshard's two routing tables.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ...core import frdc
from ...graphs import partition, sampling
from ...graphs.datasets import GraphData
from .. import session_core
from .halo import MeshHaloPlan, build_mesh_plan
from .routing import RoutingTable, ShardedCSR


def _host_frdc(*args, **kw) -> frdc.FRDCMatrix:
    """FRDC built on the host (the plan is host state)."""
    return frdc.from_coo(*args, device="cpu", **kw)


@dataclasses.dataclass
class SpmdPlan:
    """Uniform padded dims + halo schedule of the layer executors.

    Every shard's FRDC operands are padded to ONE shape —
    ``(n_local_pad, n_local_pad)`` intra / ``(n_local_pad, n_halo_pad)``
    halo, per-kind shared group counts — so one layer program serves every
    shard, and (in the reference's SPMD executor) the shards stack along a
    leading axis with the ring schedule (``mesh_plan``, overflow slot at
    ``n_halo_pad``). Serialized as the ``spmd`` field of ``routing.json``;
    artifacts without the field rebuild it from the shard parts.
    """
    n_shards: int
    n_local_pad: int
    n_halo_pad: int
    intra_groups: Dict[str, int]
    halo_groups: Dict[str, int]
    mesh_plan: MeshHaloPlan

    def to_json(self) -> dict:
        return dict(n_shards=self.n_shards, n_local_pad=self.n_local_pad,
                    n_halo_pad=self.n_halo_pad,
                    intra_groups=dict(self.intra_groups),
                    halo_groups=dict(self.halo_groups),
                    mesh_plan=self.mesh_plan.to_json())

    @classmethod
    def from_json(cls, d: dict) -> "SpmdPlan":
        return cls(n_shards=int(d["n_shards"]),
                   n_local_pad=int(d["n_local_pad"]),
                   n_halo_pad=int(d["n_halo_pad"]),
                   intra_groups={k: int(v)
                                 for k, v in d["intra_groups"].items()},
                   halo_groups={k: int(v)
                                for k, v in d["halo_groups"].items()},
                   mesh_plan=MeshHaloPlan.from_json(d["mesh_plan"]))


def build_spmd_plan(routing: RoutingTable, parts: List["ShardPart"]
                    ) -> SpmdPlan:
    """Derive the uniform SPMD dims + padded halo schedule from shard parts
    (tile-aligned covers of every shard's local/halo/group extents)."""
    n_local_pad = max(frdc.align_tile(p.n_local) for p in parts)
    n_halo_pad = max(frdc.align_tile(p.n_halo) for p in parts)
    kinds = list(parts[0].intra)
    intra_groups = {k: max(p.intra[k].n_groups for p in parts)
                    for k in kinds}
    halo_groups = {k: max(p.halo[k].n_groups for p in parts) for k in kinds}
    mesh_plan = build_mesh_plan(routing, [p.halo_nodes for p in parts],
                                n_halo_buf=n_halo_pad)
    return SpmdPlan(n_shards=len(parts), n_local_pad=n_local_pad,
                    n_halo_pad=n_halo_pad, intra_groups=intra_groups,
                    halo_groups=halo_groups, mesh_plan=mesh_plan)


@dataclasses.dataclass
class ShardPart:
    """Everything one shard owns."""
    index: int
    row_start: int
    row_end: int
    halo_nodes: np.ndarray                    # sorted global ids, may be empty
    intra: Dict[str, frdc.FRDCMatrix]         # kind -> (n_local, n_local)
    halo: Dict[str, frdc.FRDCMatrix]          # kind -> (n_local, max(n_halo,1))
    indptr: np.ndarray                        # local CSR rows -> global cols
    indices: np.ndarray
    dinv: Optional[np.ndarray]                # factorization rows [lo, hi)

    @property
    def n_local(self) -> int:
        return self.row_end - self.row_start

    @property
    def n_halo(self) -> int:
        return int(self.halo_nodes.size)


@dataclasses.dataclass
class ShardPlan:
    family: str
    routing: RoutingTable
    parts: List[ShardPart]
    n_nodes: int
    n_edges: int
    spmd: Optional[SpmdPlan] = None

    @property
    def n_shards(self) -> int:
        return len(self.parts)

    def spmd_plan(self) -> SpmdPlan:
        """The uniform-dims SPMD execution plan (built on demand for plans
        restored from pre-``spmd`` artifacts, recorded otherwise)."""
        if self.spmd is None:
            self.spmd = build_spmd_plan(self.routing, self.parts)
        return self.spmd

    def sharded_csr(self) -> ShardedCSR:
        return ShardedCSR.from_arrays(
            self.routing, [p.indptr for p in self.parts],
            [p.indices for p in self.parts])

    def stats(self) -> dict:
        intra = np.array([sum(m.nnz for m in p.intra.values())
                          for p in self.parts], np.float64)
        cut = np.array([sum(m.nnz for m in p.halo.values())
                        for p in self.parts], np.float64)
        kinds = len(self.parts[0].intra)
        total = max(float(intra.sum() + cut.sum()), 1.0)
        return dict(
            n_shards=self.n_shards, n_nodes=self.n_nodes,
            n_edges=self.n_edges,
            edge_cut_fraction=float(cut.sum()) / total,
            halo_nodes=[p.n_halo for p in self.parts],
            local_nodes=[p.n_local for p in self.parts],
            imbalance=float((intra + cut).max()
                            / max((intra + cut).mean(), 1.0)),
            adjacency_kinds=kinds,
        )


class ShardPlanner:
    """Plan P serving shards for one (graph, model family) pair."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards

    def plan(self, data: GraphData, family: str) -> ShardPlan:
        if family not in session_core.FAMILIES:
            raise ValueError(f"unknown family {family!r}")
        rows = np.asarray(data.edges[0], np.int64)
        cols = np.asarray(data.edges[1], np.int64)
        n = data.n_nodes
        bounds = partition.shard_node_bounds(rows, n, self.n_shards)
        routing = RoutingTable(bounds=bounds)
        deg = np.bincount(rows, minlength=n)
        dinv = session_core.dinv_for_family(family, deg)

        parts = []
        for s in range(self.n_shards):
            lo, hi = routing.shard_range(s)
            n_local = max(hi - lo, 1)
            rmask = (rows >= lo) & (rows < hi)
            rs, cs = rows[rmask] - lo, cols[rmask]
            # local CSR over GLOBAL columns (same stable sort as the
            # single-host CSR -> identical per-row neighbor order)
            csr = sampling.to_csr(np.stack([rs, cs]), n_local)
            cmask = (cs >= lo) & (cs < hi)
            ir, ic = rs[cmask], cs[cmask] - lo
            hr, hc_global = rs[~cmask], cs[~cmask]
            halo_nodes = np.unique(hc_global)
            hc = np.searchsorted(halo_nodes, hc_global)
            n_halo = max(halo_nodes.size, 1)
            # degenerate dims (empty shard / no halo) keep unit scales so the
            # FRDC scale vectors always match the padded matrix dims
            rsc = None if dinv is None else (
                dinv[lo:hi] if hi > lo else np.ones(n_local))
            hcsc = (dinv[halo_nodes] if dinv is not None and halo_nodes.size
                    else np.ones(n_halo))

            intra: Dict[str, frdc.FRDCMatrix] = {}
            halo_m: Dict[str, frdc.FRDCMatrix] = {}
            if family == "gcn":
                loops = np.arange(hi - lo, dtype=np.int64)
                intra["adj"] = _host_frdc(
                    np.concatenate([ir, loops]), np.concatenate([ic, loops]),
                    n_local, n_local, row_scale=rsc, col_scale=rsc)
                halo_m["adj"] = _host_frdc(
                    hr, hc, n_local, n_halo, row_scale=rsc, col_scale=hcsc)
                intra["bin"] = _host_frdc(ir, ic, n_local, n_local)
                halo_m["bin"] = _host_frdc(hr, hc, n_local, n_halo)
            elif family == "sage":
                intra["mean"] = _host_frdc(ir, ic, n_local, n_local,
                                           row_scale=rsc)
                halo_m["mean"] = _host_frdc(hr, hc, n_local, n_halo,
                                            row_scale=rsc)
            else:
                intra["sum"] = _host_frdc(ir, ic, n_local, n_local)
                halo_m["sum"] = _host_frdc(hr, hc, n_local, n_halo)

            parts.append(ShardPart(
                index=s, row_start=lo, row_end=hi, halo_nodes=halo_nodes,
                intra=intra, halo=halo_m, indptr=csr.indptr,
                indices=csr.indices,
                dinv=None if dinv is None else dinv[lo:hi]))
        plan = ShardPlan(family=family, routing=routing, parts=parts,
                         n_nodes=n, n_edges=int(rows.size))
        plan.spmd_plan()            # record the uniform dims + halo schedule
        return plan


def validate_reshard(old_routing: RoutingTable, new_routing: RoutingTable,
                     n_nodes: int) -> None:
    """Pre-swap consistency gate for a live reshard P -> P': both routing
    tables must be well-formed contiguous covers of the SAME node id space
    ``[0, n_nodes)`` — a reshard redistributes ownership, it never changes
    the graph. Raises ValueError naming the violated invariant (the reshard
    aborts before any traffic moves)."""
    for name, rt in (("old", old_routing), ("new", new_routing)):
        b = np.asarray(rt.bounds, np.int64)
        if b.size < 2:
            raise ValueError(f"reshard: {name} routing has {b.size} bounds "
                             f"(need >= 2)")
        if int(b[0]) != 0 or int(b[-1]) != n_nodes:
            raise ValueError(
                f"reshard: {name} routing covers [{int(b[0])}, "
                f"{int(b[-1])}) but the graph has {n_nodes} nodes")
        if np.any(np.diff(b) < 0):
            raise ValueError(f"reshard: {name} routing bounds are not "
                             f"monotone: {b.tolist()}")
