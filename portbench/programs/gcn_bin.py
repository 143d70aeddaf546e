"""``repro_torch.models.gnn.BitGCN`` under the "bin" scheme: BMM.FBB and
BSpMM.BBB over the 0/1 adjacency in layer 1, BMM.BBF and BSpMM.FBF over
the GCN-normalized adjacency in layer 2. Set-up builds both adjacencies
with ``repro_torch.core.frdc`` and freezes BN from one calibrating call.

Its lower-precision path is PyTorch's TF32 switch, which the port's
float32 product (BMM.FBB, ``torch.matmul``) follows."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import Program


@contextlib.contextmanager
def tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def build(x: torch.Tensor, rows: np.ndarray, cols: np.ndarray,
          weights: dict, config: dict, device) -> Program:
    from repro_torch.core import frdc
    from repro_torch.models import gnn

    n = x.shape[0]
    adj = frdc.gcn_normalized(rows, cols, n, device=device)
    adj_bin = frdc.from_coo(rows, cols, n, n, device=device)
    model = gnn.BitGCN(gnn.GCNParams(weights["w1"], weights["w2"]),
                       scheme=config["scheme"])
    _, stats = model(x, adj, adj_bin, return_bn_stats=True)

    def forward():
        return model(x, adj, adj_bin, bn_stats=stats)
    return Program(forward=forward, control=tf32)
