"""Two-level BitGNN abstraction (reference: ``repro/core/abstraction.py``).

Low level: the BMM / BSpMM / ADD / CONCAT variant registry with
three-letter precision suffixes and static type-checking of chains.
High level: ``MMSpMM`` (the GCNConv pattern, with the re-binarization scale
elided when the BMM output is binary) and ``MMAdd`` (the SAGEConv pattern).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Sequence, Union

import torch

from . import bitops
from . import bmm as bmm_mod
from . import bspmm as bspmm_mod
from .binarize import BinTensor, dequantize
from .frdc import FRDCMatrix

Tensor = Union[torch.Tensor, BinTensor]


def precision_of(x: Tensor) -> str:
    return "B" if isinstance(x, BinTensor) else "F"


@dataclasses.dataclass(frozen=True)
class OpVariant:
    """A registered low-level op variant."""
    kind: str        # "BMM" | "BSpMM" | "ADD" | "CONCAT"
    suffix: str      # e.g. "FBF"
    fn: Callable

    @property
    def name(self) -> str:
        return f"{self.kind}.{self.suffix}"

    @property
    def in_precision(self) -> str:
        return self.suffix[0]

    @property
    def out_precision(self) -> str:
        return self.suffix[-1]


def _add_fff(a, b):
    return a + b


def _add_bbf(a: BinTensor, b: BinTensor):
    """ADD.BBF: sum two binary tensors into full precision."""
    return dequantize(a) + dequantize(b)


def _concat_fff(a, b):
    return torch.cat([a, b], dim=-1)


def _concat_bbb(a: BinTensor, b: BinTensor):
    scale = torch.maximum(a.scale, b.scale)
    if a.n % 32 == 0:
        return BinTensor(packed=torch.cat([a.packed, b.packed], dim=-1),
                         scale=scale, n=a.n + b.n)
    bits = torch.cat([bitops.unpack_bits(a.packed, a.n),
                      bitops.unpack_bits(b.packed, b.n)], dim=-1)
    return BinTensor(packed=bitops.pack_bits(bits), scale=scale, n=a.n + b.n)


REGISTRY: Dict[str, OpVariant] = {}


def _register(kind: str, suffix: str, fn: Callable) -> None:
    v = OpVariant(kind, suffix, fn)
    REGISTRY[v.name] = v


for _s in bmm_mod.BMM_VARIANTS:
    _register("BMM", _s,
              (lambda s: lambda x, w, **kw: bmm_mod.bmm(x, w, s, **kw))(_s))
for _s in bspmm_mod.BSPMM_VARIANTS:
    _register("BSpMM", _s,
              (lambda s: lambda a, x, **kw: bspmm_mod.bspmm(a, x, s, **kw))(_s))
_register("ADD", "FFF", _add_fff)
_register("ADD", "BBF", _add_bbf)
_register("CONCAT", "FFF", _concat_fff)
_register("CONCAT", "BBB", _concat_bbb)


def op(name: str) -> OpVariant:
    if name not in REGISTRY:
        raise KeyError(f"{name!r} not registered; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def check_chain(*names: str) -> None:
    """Static precision type-check of an op chain (§3.1.2 guarantee)."""
    for a, b in itertools.pairwise(names):
        va, vb = op(a), op(b)
        if va.out_precision != vb.in_precision:
            raise TypeError(
                f"precision mismatch: {va.name} outputs {va.out_precision!r} "
                f"but {vb.name} expects {vb.in_precision!r}")


# The legal GCNConv pairings of §3.1.2, plus the fully-fp-out / fully-bin-in
# combinations used mid-network (the reference's list, in its order).
MMSPMM_PAIRINGS: Sequence[tuple] = (
    ("BMM.FBB", "BSpMM.BBB"),
    ("BMM.FBF", "BSpMM.FBB"),
    ("BMM.BBF", "BSpMM.FBF"),
    ("BMM.BBB", "BSpMM.BBF"),
    ("BMM.FBF", "BSpMM.FBF"),
    ("BMM.BBB", "BSpMM.BBB"),
)


@dataclasses.dataclass(frozen=True)
class MMSpMM:
    """High-level block: BMM -> BSpMM (the GCNConv core).

    When the BMM output is binary, ``out_scale=False`` is passed so no scale
    is computed (the §3.1.2 SCL elision done at composition time)."""
    mm: str
    spmm: str

    def __post_init__(self):
        check_chain(self.mm, self.spmm)

    def __call__(self, x: Tensor, wt, adj: FRDCMatrix, **kw):
        mm_v, sp_v = op(self.mm), op(self.spmm)
        h = mm_v.fn(x, wt, out_scale=mm_v.out_precision != "B")
        return sp_v.fn(adj, h, **kw)


@dataclasses.dataclass(frozen=True)
class MMAdd:
    """High-level block: two BMMs merged by ADD (the SAGEConv core)."""
    mm_self: str
    mm_agg: str
    add: str = "ADD.FFF"

    def __call__(self, x_self: Tensor, w1, x_agg: Tensor, w2):
        a = op(self.mm_self).fn(x_self, w1)
        b = op(self.mm_agg).fn(x_agg, w2)
        return op(self.add).fn(a, b)


def legal_mmspmm_variants() -> Sequence[MMSpMM]:
    return tuple(MMSpMM(a, b) for a, b in MMSPMM_PAIRINGS)
