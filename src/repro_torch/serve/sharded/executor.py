"""The host layer executor of the distributed full pass (reference:
``repro/serve/sharded/executor.py``).

:class:`HostLayerExecutor` runs a family's layer program
(:func:`~repro_torch.serve.session_core.build_layer_program`) over the
uniformly padded per-shard operands (:class:`~.planner.SpmdPlan`): each
layer as P sequential per-shard stages through :func:`layer_compute`, with
the halo exchange as a step between them. It runs on any device count; on
one card the P shards share it.

The exchange is the reference's host loopback done on the device: the
operand rows of every shard are gathered by the same index tables
(``halo_nodes``) into each shard's ``(n_halo_pad, F)`` halo operand, whose
padded rows stay zero, and :class:`~.halo.HaloStats` records the bytes the
reference's :func:`~.halo.gather_rows` would, under the same tags.

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
across shards (``distributed_moments``). The SPMD executor (one program per
layer over the stacked shards, the ring exchange inside it) waits for the
multi-card slice: ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core import frdc
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


class HostLayerExecutor(LayerExecutor):
    """Host-orchestrated distributed pass (sequential per-shard stages) over
    the uniformly padded per-shard FRDC operands on ``device``."""

    name = "host"

    def __init__(self, parts: List[ShardPart], spmd: SpmdPlan,
                 plan: SessionPlan, stats: halo_mod.HaloStats,
                 routing: RoutingTable, use_pallas: bool = False,
                 device="cuda"):
        self.parts = parts
        self.spmd = spmd
        self.plan = plan
        self.stats = stats
        self.device = torch.device(device)
        self.fused = plan.fused and use_pallas
        self._programs: set = set()
        # observability hook: on_trace(label, shape_dict) on each NEW layer
        # program, labelled "{name}/operand{i}" and "{name}/stage{i}" in the
        # order the reference traces them (the SPMD executor's
        # "{name}/step{i}" comes with it)
        self.on_trace = None
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

    @property
    def compile_count(self) -> int:
        """Distinct layer programs run: a stage per step and an operand
        program per exchange step, for each BN mode, where the reference
        counts jit traces; constant after the first pass."""
        return len(self._programs)

    def _pad_state(self, xs: List[np.ndarray]) -> List[torch.Tensor]:
        npd = self.spmd.n_local_pad
        out = []
        for b in xs:
            b = torch.as_tensor(b).to(self.device)
            buf = b.new_zeros((npd,) + tuple(b.shape[1:]))
            buf[:b.shape[0]] = b
            out.append(buf)
        return out

    # ----------------------------------------------------------- exchange --
    def _exchange(self, blocks: List[torch.Tensor], tag: str
                  ) -> List[torch.Tensor]:
        """Every shard's halo operand from the per-shard operand blocks
        (``n_local`` rows each): ``(n_halo_pad, F)``, rows in
        ``halo_nodes`` order, padded rows zero, gathered on the device."""
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

    def _program(self, key: tuple, label: str, shape: dict) -> None:
        """Count a layer program; fire ``on_trace`` when it is new."""
        if key in self._programs:
            return
        self._programs.add(key)
        if self.on_trace is not None:
            self.on_trace(f"{self.name}/{label}", shape)

    def _stage_shape(self, with_bn: bool) -> dict:
        return dict(n_local_pad=self.spmd.n_local_pad,
                    n_halo_pad=self.spmd.n_halo_pad, with_bn=with_bn)

    def _operand(self, step: LayerStep, st, bn_args):
        """The exchange operand of one shard: BN and ``step.pre``, or the
        fused kind's transform alone (the rows its pair aggregates)."""
        if self.fused:
            return step.transform(st, bn_args)[0]
        z = session_core.apply_bn(st, *bn_args) if bn_args is not None \
            else st
        return step.pre(z)[0]
