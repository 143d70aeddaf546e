"""Stages of the BitGNN GCN "bin" forward (Table 3 "Ours(bin)"), two layers.

Shapes: ``n`` nodes, ``f`` features, ``h`` hidden, ``c`` classes; ``nnz`` /
``tiles`` of the 0/1 adjacency A (no self loops) and ``nnz_hat`` /
``tiles_hat`` of A + I.

* elementwise: BN of x, ``2 n f`` (subtract, divide); each BIN, one
  compare an element (``n h`` twice); the layer-2 scale, ``n c``.
* transform: BMM.FBB ``2 n f h`` fp32 (BN(x) in at 4 B, the weight's sign
  bits and scales, the output's sign bits); BMM.BBF ``2 n h c`` binary
  multiply-adds at the int8 rate (bits in, fp32 (n, c) out).
* aggregation: BSpMM.BBB ``2 nnz h`` binary multiply-adds over A (bits
  in, A, bits out); BSpMM.FBF ``2 nnz_hat c`` fp32 over A + I with its
  two scale vectors (fp32 in and out).
"""
from __future__ import annotations

from . import Op, adjacency_bytes, bits_bytes, fp32_bytes


def stages(s: dict) -> dict:
    n, f, h, c = s["n"], s["f"], s["h"], s["c"]
    a = adjacency_bytes(n, s["nnz"], s["tiles"])
    a_hat = adjacency_bytes(n, s["nnz_hat"], s["tiles_hat"], scales=2)
    return {
        "elementwise": [
            Op("bn1", 2.0 * n * f, "fp32", 2 * fp32_bytes(n, f)),
            Op("bin1", 1.0 * n * h, "fp32", fp32_bytes(n, h) + bits_bytes(n, h)),
            Op("bin2", 1.0 * n * h, "fp32", fp32_bytes(n, h) + bits_bytes(n, h)),
            Op("scale2", 1.0 * n * c, "fp32", 2 * fp32_bytes(n, c)),
        ],
        "transform": [
            Op("bmm_fbb1", 2.0 * n * f * h, "fp32",
               fp32_bytes(n, f) + bits_bytes(h, f) + 4.0 * h
               + bits_bytes(n, h)),
            Op("bmm_bbf2", 2.0 * n * h * c, "int8",
               bits_bytes(n, h) + bits_bytes(c, h) + 4.0 * c
               + fp32_bytes(n, c)),
        ],
        "aggregation": [
            Op("bspmm_bbb1", 2.0 * s["nnz"] * h, "int8",
               bits_bytes(n, h) + a + bits_bytes(n, h)),
            Op("bspmm_fbf2", 2.0 * s["nnz_hat"] * c, "fp32",
               fp32_bytes(n, c) + a_hat + fp32_bytes(n, c)),
        ],
    }
