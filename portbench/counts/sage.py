"""Stages of the BitGNN GraphSAGE forward (Table 4 "Ours"), two layers of
``out = BMM.BBF(BIN(BN(h)), W_self) + BSpMM.FBF(D^-1 A, BMM.BBF(BIN(BN(h)),
W_agg))``, ReLU after the first.

Shapes: ``n`` nodes, layer widths ``f -> h -> c``; ``nnz`` / ``tiles`` of
the 0/1 adjacency A (no self loops), with its one row-scale vector.

Per layer of width ``k -> m``:

* elementwise: BN ``2 n k``; the row scale mean|x| ``2 n k``; the two
  products' scales ``2 n m`` each; the add ``n m``; ReLU ``n m`` (layer 1).
* transform: the BIN of BN(h) (fp32 in, bits out; one compare an
  element); two BMM.BBF of ``2 n k m`` binary multiply-adds at the int8
  rate, each bits in and fp32 (n, m) out.
* aggregation: BSpMM.FBF ``2 nnz m`` fp32 over A (fp32 in and out).
"""
from __future__ import annotations

from . import Op, adjacency_bytes, bits_bytes, fp32_bytes


def stages(s: dict) -> dict:
    n = s["n"]
    a = adjacency_bytes(n, s["nnz"], s["tiles"], scales=1)
    out = {"elementwise": [], "transform": [], "aggregation": []}
    widths = [(s["f"], s["h"], True), (s["h"], s["c"], False)]
    for i, (k, m, relu) in enumerate(widths, 1):
        out["elementwise"] += [
            Op(f"bn{i}", 2.0 * n * k, "fp32", 2 * fp32_bytes(n, k)),
            Op(f"row_scale{i}", 2.0 * n * k, "fp32", fp32_bytes(n, k) + 4.0 * n),
            Op(f"scales{i}", 4.0 * n * m, "fp32", 4 * fp32_bytes(n, m)),
            Op(f"add{i}", (2.0 if relu else 1.0) * n * m, "fp32",
               3 * fp32_bytes(n, m)),
        ]
        out["transform"] += [
            Op(f"bin{i}", 1.0 * n * k, "fp32", fp32_bytes(n, k) + bits_bytes(n, k)),
            Op(f"bmm_self{i}", 2.0 * n * k * m, "int8",
               bits_bytes(n, k) + bits_bytes(m, k) + 4.0 * m + fp32_bytes(n, m)),
            Op(f"bmm_agg{i}", 2.0 * n * k * m, "int8",
               bits_bytes(n, k) + bits_bytes(m, k) + 4.0 * m + fp32_bytes(n, m)),
        ]
        out["aggregation"] += [
            Op(f"bspmm_fbf{i}", 2.0 * s["nnz"] * m, "fp32",
               fp32_bytes(n, m) + a + fp32_bytes(n, m)),
        ]
    return out
