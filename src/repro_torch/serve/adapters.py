"""Model-family adapters: the seam that makes :class:`ServeCore` generic
(reference: ``repro/serve/adapters.py``).

The serving core (program counter, high-water shape buckets, async
launch/finish, trace hooks) is family-agnostic;
what a model family computes lives behind a :class:`ModelFamilyAdapter`:
``quantize``, ``serve_body`` (the launched forward), ``pad_operands``
(bucket shaping), ``sub_operands`` / ``operand_like`` (per-query operands
and the artifact template), ``finish`` and ``trace_shape``. The token
adapter comes with the token tier.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..core import frdc
from ..kernels import bspmm_kernel
from . import session_core


class ModelFamilyAdapter:
    """Contract one model family implements to ride the serving core.

    ``kind`` namespaces the family in metrics and trace exports.
    """

    kind = "?"

    def quantize(self, params):
        """Dense params -> the serving params the launched body uses."""
        raise NotImplementedError

    def serve_body(self, core, x, state, operands, seeds):
        """The launched body. ``x``/``seeds`` are the staged dense tensors on
        the core's device, ``operands`` the (padded) per-batch operand dict,
        ``state`` the pinned calibration. Returns the launch result."""
        raise NotImplementedError

    def pad_operands(self, core, operands, n_sub):
        """Pad one batch's operands to the core's high-water buckets;
        returns ``(n_pad, padded_operands)``. Must be monotone in the water
        marks: staging order, not launch order, is what the
        zero-steady-state-recompile guarantee keys on."""
        raise NotImplementedError

    def sub_operands(self, *args, **kw):
        """Build the operand dict for one extracted per-query closure."""
        raise NotImplementedError

    def operand_like(self):
        """Template tree for checkpoint restore validation."""
        raise NotImplementedError

    def finish(self, out_dev, staged) -> Any:
        """Wait for one launch result and crop it to host answers."""
        raise NotImplementedError

    def trace_shape(self, staged) -> dict:
        """Shape key of one staged batch (the program-counter key)."""
        raise NotImplementedError


class GNNAdapter(ModelFamilyAdapter):
    """The GNN serving specifics. Stateless with respect to the core (the
    water marks live on each ``ServeCore``)."""

    kind = "gnn"

    def __init__(self, plan: "session_core.SessionPlan"):
        self.plan = plan

    def quantize(self, params):
        return session_core.quantize_family(self.plan.family, params)

    def serve_body(self, core, x, state, operands, seeds):
        n_pad = x.shape[0]
        mats = {k: session_core.frdc_rebuild(v, n_pad, n_pad)
                for k, v in operands.items()}
        items = {k: v.get("item_ptr") for k, v in operands.items()}
        out = session_core.family_forward(self.plan, core.qparams, x, mats,
                                          use_pallas=core.use_pallas,
                                          items=items, bn_stats=state)
        return out[seeds]

    def pad_operands(self, core, operands, n_sub):
        n_pad = session_core.bucket_pow2(max(n_sub, core._n_water),
                                         core.NODE_BUCKET_FLOOR,
                                         core.node_cap)
        core._n_water = n_pad
        fused = self.plan.fused and core.use_pallas
        adjs = {}
        for k, m in operands.items():
            wkey = (n_pad, k)
            g_pad = max(core._g_water.get(wkey, 0),
                        session_core.bucket_pow2(m.n_groups,
                                                 core.GROUP_BUCKET_FLOOR))
            core._g_water[wkey] = g_pad
            arrs = session_core.frdc_arrays(
                frdc.pad_frdc(m, n_pad, n_groups=g_pad))
            if fused:   # the fused kernels' work items, built on the host
                arrs["item_ptr"] = bspmm_kernel.work_items(arrs["grp_ptr"])
            adjs[k] = arrs
        return n_pad, adjs

    def sub_operands(self, n_sub: int, sub_edges, dinv_sub):
        return session_core.sub_adjacency(self.plan.family, n_sub,
                                          sub_edges, dinv_sub)

    def operand_like(self):
        return session_core.adj_like(self.plan.family)

    def finish(self, out_dev, staged) -> np.ndarray:
        return out_dev.cpu().numpy()[:staged.n_seeds]

    def trace_shape(self, staged) -> dict:
        return dict(
            n_pad=int(staged.x_pad.shape[0]),
            groups={str(k): int(a["group_row"].shape[0])
                    for k, a in staged.adjs.items()})
