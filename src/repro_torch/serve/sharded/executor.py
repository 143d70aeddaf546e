"""The layer executors of the distributed full pass (reference:
``repro/serve/sharded/executor.py``).

Both run a family's layer program
(:func:`~repro_torch.serve.session_core.build_layer_program`) over the
uniformly padded per-shard operands (:class:`~.planner.SpmdPlan`) through
:func:`layer_compute`, so they agree bit for bit:

* :class:`HostLayerExecutor` runs each layer as P sequential per-shard
  stages, with the halo exchange as a step between them. Without a mesh
  the exchange is the reference's host loopback done on the device: the
  operand rows of every shard are gathered by the same index tables
  (``halo_nodes``) into each shard's ``(n_halo_pad, F)`` halo operand,
  whose padded rows stay zero, and :class:`~.halo.HaloStats` records the
  bytes the reference's :func:`~.halo.gather_rows` would, under the same
  tags. With a mesh (``mesh=``, every rank running the same program) the
  exchange goes through :func:`~.halo.mesh_exchange`, on the SpmdPlan's
  own ring schedule.
* :class:`SpmdLayerExecutor` is the reference's one-program-a-layer
  executor in torch's model: one process a shard, every rank running the
  same program. Rank ``r`` holds only shard ``r``'s padded operands and
  runs each step on them; :func:`~.halo.ring_scatter` over the mesh's
  group takes the place of the host exchange. Calibrate mode all-gathers
  each BN site's partial sums and adds them in shard order, and the last
  step's states are all-gathered, so every rank returns the whole pass.

A fused plan (``plan.fused`` with ``use_pallas``) runs each step as two
launches a shard: ``LayerStep.transform`` over all of the shard's padded
rows, whose first ``n_local`` rows are exchanged, and ``LayerStep.pair``,
the intra+halo aggregation and epilogue on that same transform and the
exchanged rows, so a remote row is the row its owner aggregates, bit for
bit. An exchange-free step is one fused launch (``LayerStep.fused``). The
unfused stages run BN by the reciprocal (``apply_bn``), ``step.pre`` and
the 1D kernels through ``ops.serve_counts`` / ``serve_fp_pair``.

Calibrate mode (``bn_mode="distributed"``) takes each BN site's (mu, sd)
from the pass itself: per-shard sum and sum-of-squares partials added
across shards in shard order (``distributed_moments``).

Halo bytes of the ring transports come from the static schedule,
``MeshHaloPlan.payload_bytes``, once per exchange.
"""
from __future__ import annotations

import hashlib
import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ...core import frdc
from ...distributed import collectives
from ...kernels import fused_layer
from ...kernels import ops as kernel_ops
from .. import session_core
from ..session_core import LayerExecutor, LayerStep, SessionPlan
from . import halo as halo_mod
from .planner import ShardPart, SpmdPlan
from .routing import RoutingTable


def layer_compute(step: LayerStep, trinary_mode: str, st, bn_stats, rem,
                  intra, halo, fused: bool = False):
    """One layer step on one shard.

    ``st``: the shard's padded carried state; ``bn_stats``: (mu, sd) or
    None; ``rem``: the (n_halo_pad, F) exchanged halo operand (None for
    exchange-free steps); ``intra``/``halo``: the shard's uniformly padded
    FRDC matrices of ``step.kind``. ``fused`` runs the step in its fused
    form (``LayerStep.fused``; the executor runs an exchange step's two
    launches itself)."""
    if fused:
        return step.fused(st, bn_stats, rem, intra, halo, None)
    z = session_core.apply_bn(st, *bn_stats) if bn_stats is not None else st
    operand, aux = step.pre(z)
    if step.kind is None:
        y = operand
    elif step.packed:
        y = kernel_ops.serve_counts(intra, operand, trinary_mode) \
            + kernel_ops.serve_counts(halo, rem, trinary_mode)
    else:
        y = kernel_ops.serve_fp_pair(intra, halo, operand, rem)
    return step.post(aux, y)


def exchange_operand(step: LayerStep, st, bn_stats):
    """The rows an unfused step exchanges: BN and ``step.pre`` (computed
    again inside :func:`layer_compute`, which rounds the same)."""
    z = session_core.apply_bn(st, *bn_stats) if bn_stats is not None else st
    return step.pre(z)[0]


class _PaddedExecutor(LayerExecutor):
    """What both executors share: the plan, the program counter and the
    padding of a feature block to the uniform row count."""

    def __init__(self, parts: List[ShardPart], spmd: SpmdPlan,
                 plan: SessionPlan, stats: halo_mod.HaloStats, mesh,
                 use_pallas: bool, device):
        self.parts = parts
        self.spmd = spmd
        self.plan = plan
        self.stats = stats
        self.mesh = mesh
        self.device = torch.device(device)
        self.fused = plan.fused and use_pallas
        self._programs: set = set()
        # observability hook: on_trace(label, shape_dict) on each NEW layer
        # program, labelled "host/operand{i}" and "host/stage{i}" in the
        # order the reference traces them, or "spmd/step{i}"
        self.on_trace = None

    @property
    def compile_count(self) -> int:
        """Distinct layer programs run, where the reference counts jit
        traces (host: a stage per step and an operand program per exchange
        step; SPMD: one a step), for each BN mode; constant after the
        first pass."""
        return len(self._programs)

    def _program(self, key: tuple, label: str, shape: dict) -> None:
        """Count a layer program; fire ``on_trace`` when it is new."""
        if key in self._programs:
            return
        self._programs.add(key)
        if self.on_trace is not None:
            self.on_trace(f"{self.name}/{label}", shape)

    def _pad_block(self, b) -> torch.Tensor:
        """One shard's feature block on the device, zero-padded to
        ``n_local_pad`` rows."""
        b = torch.as_tensor(b).to(self.device)
        buf = b.new_zeros((self.spmd.n_local_pad,) + tuple(b.shape[1:]))
        buf[:b.shape[0]] = b
        return buf


class HostLayerExecutor(_PaddedExecutor):
    """Host-orchestrated distributed pass (sequential per-shard stages) over
    the uniformly padded per-shard FRDC operands on ``device``."""

    name = "host"

    def __init__(self, parts: List[ShardPart], spmd: SpmdPlan,
                 plan: SessionPlan, stats: halo_mod.HaloStats,
                 routing: RoutingTable, mesh=None, use_pallas: bool = False,
                 device="cuda"):
        super().__init__(parts, spmd, plan, stats, mesh, use_pallas, device)
        npd, nhp = spmd.n_local_pad, spmd.n_halo_pad
        self._intra: Dict[str, List[frdc.FRDCMatrix]] = {}
        self._halo: Dict[str, List[frdc.FRDCMatrix]] = {}
        self._items: Dict[str, list] = {}
        for kind in parts[0].intra:
            self._intra[kind] = [m.to(self.device) for m in
                                 frdc.pad_frdc_uniform(
                                     [pt.intra[kind] for pt in parts], npd,
                                     npd, spmd.intra_groups[kind])]
            self._halo[kind] = [m.to(self.device) for m in
                                frdc.pad_frdc_uniform(
                                    [pt.halo[kind] for pt in parts], npd, nhp,
                                    spmd.halo_groups[kind])]
            if self.fused:   # the pair kernel's tasks, built once
                self._items[kind] = [
                    fused_layer.pair_items(a, h)
                    for a, h in zip(self._intra[kind], self._halo[kind])]
        # per shard: its halo nodes on the device, and the rows each other
        # shard serves it (gather_rows' byte accounting, owner by owner)
        self._halo_idx = [torch.from_numpy(p.halo_nodes).to(self.device)
                          for p in parts]
        self._halo_rows: List[List[int]] = []
        for p in parts:
            owner = routing.owner(p.halo_nodes)
            self._halo_rows.append([
                int(c) for s, c in enumerate(np.bincount(
                    owner, minlength=routing.n_shards))
                if c and s != p.index])

    def _pad_state(self, xs: List[np.ndarray]) -> List[torch.Tensor]:
        return [self._pad_block(b) for b in xs]

    # ----------------------------------------------------------- exchange --
    def _exchange(self, blocks: List[torch.Tensor], tag: str
                  ) -> List[torch.Tensor]:
        """Every shard's halo operand from the per-shard operand blocks
        (``n_local`` rows each): ``(n_halo_pad, F)``, rows in
        ``halo_nodes`` order, padded rows zero; over the mesh when one is
        attached, else gathered on the device."""
        if self.mesh is not None:
            # the SpmdPlan's ring schedule (its receive buffer is the
            # uniform halo pad): no second MeshHaloPlan is built
            out = []
            for g in halo_mod.mesh_exchange(self.mesh, blocks,
                                            self.spmd.mesh_plan,
                                            stats=self.stats, tag=tag):
                buf = g.new_zeros((self.spmd.n_halo_pad,)
                                  + tuple(g.shape[1:]))
                buf[:g.shape[0]] = g
                out.append(buf)
            return out
        full = torch.cat(blocks)          # shards own ascending node ranges
        row_bytes = math.prod(full.shape[1:]) * full.element_size()
        out = []
        for p, idx, rows in zip(self.parts, self._halo_idx, self._halo_rows):
            buf = full.new_zeros((self.spmd.n_halo_pad,)
                                 + tuple(full.shape[1:]))
            if p.n_halo:
                buf[:p.n_halo] = full[idx]
            for r in rows:
                self.stats.add(tag, r * row_bytes)
            out.append(buf)
        return out

    # ---------------------------------------------------------------- pass --
    def run_pass(self, program: Tuple[LayerStep, ...], xs: List[np.ndarray],
                 bn: Optional[tuple], calibrate: bool = False):
        state = self._pad_state(xs)
        trinary = self.plan.trinary_mode
        collected = []
        for i, step in enumerate(program):
            with_bn = step.bn_site is not None
            bn_args = None
            if with_bn:
                if calibrate:
                    site = session_core.distributed_moments(
                        [s[:p.n_local] for s, p in zip(state, self.parts)])
                    collected.append(site)
                else:
                    site = bn[step.bn_site]
                bn_args = tuple(t.to(self.device) for t in site)
            if step.kind is None:
                self._program(("stage", i, with_bn), f"stage{i}",
                              self._stage_shape(with_bn))
                state = [layer_compute(step, trinary, s, bn_args, None, None,
                                       None, self.fused) for s in state]
                continue
            self._program(("operand", i, with_bn), f"operand{i}",
                          dict(with_bn=with_bn))
            self._program(("stage", i, with_bn), f"stage{i}",
                          self._stage_shape(with_bn))
            intra, halo = self._intra[step.kind], self._halo[step.kind]
            if self.fused:   # the transform once: exchanged and aggregated
                outs = [step.transform(s, bn_args) for s in state]
                halo_in = self._exchange(
                    [y[:p.n_local] for (y, _), p in zip(outs, self.parts)],
                    step.tag)
                items = self._items[step.kind]
                state = [step.pair(y, ys, rem, intra[k], halo[k], items[k])
                         for k, ((y, ys), rem) in enumerate(zip(outs,
                                                                halo_in))]
                continue
            operands = [self._operand(step, s, bn_args)[:p.n_local]
                        for s, p in zip(state, self.parts)]
            halo_in = self._exchange(operands, step.tag)
            state = [layer_compute(step, trinary, s, bn_args, rem, intra[k],
                                   halo[k])
                     for k, (s, rem) in enumerate(zip(state, halo_in))]
        blocks = [s[:p.n_local].cpu().numpy()
                  for s, p in zip(state, self.parts)]
        return blocks, (tuple(collected) if calibrate else None)

    def _stage_shape(self, with_bn: bool) -> dict:
        return dict(n_local_pad=self.spmd.n_local_pad,
                    n_halo_pad=self.spmd.n_halo_pad, with_bn=with_bn)

    def _operand(self, step: LayerStep, st, bn_args):
        """The exchange operand of one shard: BN and ``step.pre``, or the
        fused kind's transform alone (the rows its pair aggregates)."""
        if self.fused:
            return step.transform(st, bn_args)[0]
        return exchange_operand(step, st, bn_args)


class SpmdLayerExecutor(_PaddedExecutor):
    """The distributed pass with one rank a shard over ``mesh``'s ``data``
    group: rank ``r`` runs every step on shard ``r`` alone, the halo
    arriving by the ring exchange. Every rank makes each call, in the same
    order, and gets the whole pass back."""

    name = "spmd"

    def __init__(self, parts: List[ShardPart], spmd: SpmdPlan,
                 plan: SessionPlan, stats: halo_mod.HaloStats, mesh,
                 use_pallas: bool = False, device="cuda"):
        p = spmd.n_shards
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if mesh is None or "data" not in names \
                or mesh.size(names.index("data")) != p or mesh.size() != p:
            raise ValueError(
                f"SPMD executor needs a mesh with a 'data' axis of exactly "
                f"{p} ranks (make_shard_mesh({p})); got {mesh}")
        super().__init__(parts, spmd, plan, stats, mesh, use_pallas, device)
        self.group = mesh.get_group("data")
        self.rank = dist.get_rank(self.group)
        r, npd, nhp = self.rank, spmd.n_local_pad, spmd.n_halo_pad
        self._intra: Dict[str, frdc.FRDCMatrix] = {}
        self._halo: Dict[str, frdc.FRDCMatrix] = {}
        self._items: Dict[str, object] = {}
        for kind in parts[0].intra:
            self._intra[kind] = _own_row(frdc.pad_frdc_uniform(
                [pt.intra[kind] for pt in parts], npd, npd,
                spmd.intra_groups[kind]), r).to(self.device)
            self._halo[kind] = _own_row(frdc.pad_frdc_uniform(
                [pt.halo[kind] for pt in parts], npd, nhp,
                spmd.halo_groups[kind]), r).to(self.device)
            if self.fused:
                self._items[kind] = fused_layer.pair_items(
                    self._intra[kind], self._halo[kind])
        mp = spmd.mesh_plan
        self._send = halo_mod.schedule_row(mp.send_idx, r, self.device)
        self._recv = halo_mod.schedule_row(mp.recv_pos, r, self.device)
        self._check_plans()

    def _check_plans(self) -> None:
        """All ranks must hold one SpmdPlan: a rank planned differently
        would wait on a collective the others never make, or aggregate
        rows that were never sent to it."""
        sp = self.spmd
        doc = json.dumps(dict(n_local_pad=sp.n_local_pad,
                              n_halo_pad=sp.n_halo_pad,
                              intra_groups=sp.intra_groups,
                              halo_groups=sp.halo_groups,
                              mesh_plan=sp.mesh_plan.to_json()),
                         sort_keys=True)
        mine = torch.from_numpy(np.frombuffer(
            hashlib.sha256(doc.encode()).digest(), np.int64).copy())
        got = collectives.all_gather(mine.to(self.device), self.group)
        bad = [s for s, g in enumerate(got) if not torch.equal(g, got[0])]
        if bad:
            raise RuntimeError(f"SPMD executor: ranks {bad} hold another "
                               f"SpmdPlan than rank 0")

    def _moments(self, own: torch.Tensor) -> tuple:
        """(mu, sd) of a BN site from every rank's (s1, s2, cnt) of its
        real rows, added in shard order (an ``all_reduce`` adds in the
        order the backend picks, and the ranks must agree bit for bit).
        float64 carries the float32 partials and the count exactly."""
        f = own.shape[1]
        part = torch.cat([own.sum(dim=0, keepdim=True),
                          (own * own).sum(dim=0, keepdim=True)], dim=1)
        row = torch.cat([part.to(torch.float64),
                         part.new_full((1, 1), own.shape[0],
                                       dtype=torch.float64)], dim=1)
        got = collectives.all_gather(row, self.group)
        s1 = sum(g[:, :f].to(own.dtype) for g in got)
        s2 = sum(g[:, f:2 * f].to(own.dtype) for g in got)
        cnt = float(sum(int(g[0, -1]) for g in got))
        return session_core.moments_from_sums(s1, s2, cnt)

    def _ring(self, y: torch.Tensor) -> torch.Tensor:
        return halo_mod.ring_scatter(y, self._send, self._recv,
                                     self.spmd.n_halo_pad, self.group)

    def run_pass(self, program: Tuple[LayerStep, ...], xs: List[np.ndarray],
                 bn: Optional[tuple], calibrate: bool = False):
        own = self.parts[self.rank]
        st = self._pad_block(xs[self.rank])
        trinary = self.plan.trinary_mode
        mp = self.spmd.mesh_plan
        collected = []
        for i, step in enumerate(program):
            self._program((i, bool(calibrate)), f"step{i}", dict(
                n_local_pad=self.spmd.n_local_pad,
                n_halo_pad=self.spmd.n_halo_pad, calibrate=calibrate))
            bn_args = None
            if step.bn_site is not None:
                if calibrate:
                    site = self._moments(st[:own.n_local])
                    collected.append(site)
                else:
                    site = bn[step.bn_site]
                bn_args = tuple(t.to(self.device) for t in site)
            if step.kind is None:
                st = layer_compute(step, trinary, st, bn_args, None, None,
                                   None, self.fused)
                continue
            intra, halo = self._intra[step.kind], self._halo[step.kind]
            if self.fused:   # the transform once: exchanged and aggregated
                y, ys = step.transform(st, bn_args)
                st = step.pair(y, ys, self._ring(y), intra, halo,
                               self._items[step.kind])
            else:
                rem = self._ring(exchange_operand(step, st, bn_args))
                st = layer_compute(step, trinary, st, bn_args, rem, intra,
                                   halo)
            self.stats.add(step.tag, mp.payload_bytes(step.payload_cols,
                                                      step.payload_itemsize))
        states = collectives.all_gather(st, self.group)
        blocks = [s[:p.n_local].cpu().numpy()
                  for s, p in zip(states, self.parts)]
        return blocks, (tuple(collected) if calibrate else None)


def _own_row(padded: List[frdc.FRDCMatrix], r: int) -> frdc.FRDCMatrix:
    """Shard ``r``'s matrix as row ``r`` of :func:`frdc.stack_frdc` (a
    copy: the stack is dropped)."""
    rows = {f: v[r].clone() for f, v in frdc.stack_frdc(padded).items()}
    m = padded[r]
    return session_core.frdc_rebuild(rows, m.n_rows, m.n_cols, m.nnz)
