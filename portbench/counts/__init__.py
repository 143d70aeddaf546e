"""Operations and bytes of a forward, by stage, worked out from the cell's
shapes alone (never from a kernel's description of its own work), and the
table of the card's peaks (``peaks.json``).

A family's module (``counts/<program>.py``) gives ``stages(shapes)``: a
dict from stage name (``transform``, ``aggregation``, ``elementwise``) to
a list of :class:`Op`. Each op counts its inputs once and its output once,
at the least width an exact form of them needs: a binary activation at 1
bit, a float32 value at 4 bytes, and an adjacency as the smaller of its
CSR and its 4x4-tile form (:func:`adjacency_bytes`).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, NamedTuple

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


class Op(NamedTuple):
    name: str
    ops: float      # operations (a multiply-add is 2)
    rate: str       # key of the peak rate in peaks.json: "int8" or "fp32"
    bytes: float    # least bytes moved: inputs once, output once


def bits_bytes(rows: int, cols: int) -> float:
    """A binary (rows, cols) matrix at one bit an element."""
    return rows * cols / 8.0


def fp32_bytes(rows: int, cols: int) -> float:
    return rows * cols * 4.0


def adjacency_bytes(n: int, nnz: int, n_tiles: int, scales: int = 0) -> float:
    """The least of an n x n 0/1 adjacency's two exact forms, plus its
    float32 scale vectors:

    * CSR: ``4 * nnz`` column indices + ``4 * (n + 1)`` row offsets;
    * 4x4 tiles: ``n_tiles * (2 + 4)`` (16 bits and a tile-column index a
      tile) + ``4 * (ceil(n / 4) + 1)`` tile-row offsets;

    and ``4 * n * scales`` (the row and column scales of a normalized
    adjacency)."""
    csr = 4.0 * nnz + 4.0 * (n + 1)
    tiled = 6.0 * n_tiles + 4.0 * (-(-n // 4) + 1)
    return min(csr, tiled) + 4.0 * n * scales


def least_seconds(op: Op) -> float:
    """The larger of the op's operations over its peak rate and its bytes
    over the memory bandwidth."""
    return max(op.ops / PEAKS[op.rate], op.bytes / PEAKS["hbm_bytes"])


def stage_least_seconds(ops: List[Op]) -> float:
    """A stage's ops run one after another: the least time is the sum."""
    return sum(least_seconds(o) for o in ops)


def peak_seconds(stages: Dict[str, List[Op]]) -> float:
    """The forward's operations at the peak rate of each kind: the time
    that ``forward_mfu`` sets against the forward's."""
    return sum(o.ops / PEAKS[o.rate] for ops in stages.values() for o in ops)
