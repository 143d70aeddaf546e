"""Collective-byte accounting of a traced step (reference:
``repro/distributed/hlo_analysis.py``).

The reference parses the per-device, SPMD-partitioned HLO text of a compiled
program: every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute instruction gives its payload. torch compiles no HLO and
emits no such text, so the regex parser has nothing to read here and is not
ported. The collectives are recorded where DTensor issues them instead: as
the functional collectives (``_c10d_functional.*``) that rank 0 runs on its
local tensors. :class:`CollectiveRecorder` is a dispatch mode that records
them; :func:`collective_payload` is the rule it applies, which the dry run's
step tracker applies too.

Wire-byte conventions (ring algorithms, per device), the reference's:
    all-gather         output_bytes          (each device receives V_out-V_in)
    all-reduce         2 x operand_bytes     (reduce-scatter + all-gather)
    reduce-scatter     operand_bytes
    all-to-all         operand_bytes
    collective-permute operand_bytes
``bytes_by_op`` holds the payload: the output of an all-gather, the operand
of the rest.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# functional collective -> the reference's HLO op name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def collective_payload(func, args, out) -> Optional[Tuple[str, int]]:
    """``(op, payload bytes)`` when ``func`` is a functional collective,
    else None: the output's bytes for an all-gather, the operand's (the
    first argument, a tensor or a list of them) for the rest."""
    if func.namespace not in ("_c10d_functional", "c10d_functional"):
        return None
    op = _COLLECTIVES.get(func._opname)
    if op is None:
        return None
    return op, _nbytes(out) if op == "all-gather" else _nbytes(args[0])


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int]
    count_by_op: Dict[str, int]

    @property
    def wire_bytes(self) -> int:
        """Per-device wire bytes with the ring conventions above."""
        total = 0
        for op, b in self.bytes_by_op.items():
            total += 2 * b if op == "all-reduce" else b
        return total

    @property
    def raw_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


class CollectiveRecorder(TorchDispatchMode):
    """``with CollectiveRecorder() as rec:`` records every functional
    collective this process runs on plain tensors; ``rec.stats()`` sums
    them. The mode declines DTensor ops, so DTensor runs them and the
    collectives its redistributions issue come back here on the local
    tensors, with rank 0's local shapes. Ops run under a fake-tensor mode
    (DTensor's sharding propagation works out global output shapes that
    way) pass unrecorded. Subclasses see every other local op through
    :meth:`add`."""

    def __init__(self):
        super().__init__()
        self.bytes_by_op: Dict[str, int] = defaultdict(int)
        self.count_by_op: Dict[str, int] = defaultdict(int)

    def add(self, func, args, kwargs, out) -> None:
        hit = collective_payload(func, args, out)
        if hit is not None:
            self.bytes_by_op[hit[0]] += hit[1]
            self.count_by_op[hit[0]] += 1

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes_by_op), dict(self.count_by_op))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            self.add(func, args, kwargs, out)
        return out
