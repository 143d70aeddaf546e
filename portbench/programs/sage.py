"""``repro_torch.models.gnn.BitSAGE``: both branches through ``bmm_xnor``,
BSpMM.FBF mean aggregation after the transform, merged by ADD. Set-up
builds the mean adjacency with ``repro_torch.core.frdc`` and freezes BN
from one calibrating call. The port has no lower-precision path here: its
float work is BN, scales and the float32 aggregation."""
from __future__ import annotations

import numpy as np
import torch

from . import Program


def build(x: torch.Tensor, rows: np.ndarray, cols: np.ndarray,
          weights: dict, config: dict, device) -> Program:
    from repro_torch.core import frdc
    from repro_torch.models import gnn

    adj = frdc.mean_normalized(rows, cols, x.shape[0], device=device)
    model = gnn.BitSAGE(gnn.SAGEParams(weights["w1_self"], weights["w1_agg"],
                                       weights["w2_self"], weights["w2_agg"]))
    _, stats = model(x, adj, return_bn_stats=True)

    def forward():
        return model(x, adj, bn_stats=stats)
    return Program(forward=forward, control=None)
