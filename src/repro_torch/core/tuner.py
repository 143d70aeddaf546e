"""Tuning utilities (reference: ``repro/core/tuner.py``, paper §3.4).

Times candidate precision-variant assignments and trinary modes on the
actual graph and ranks them. A candidate forward that runs on the card is
timed to the end of its work (``torch.cuda.synchronize``).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Optional, Sequence

import torch

from .abstraction import MMSPMM_PAIRINGS
from .bspmm import TRINARY_DEFAULT


@dataclasses.dataclass
class Candidate:
    layer_variants: Sequence[tuple]   # (mm, spmm) per layer
    trinary_mode: str = TRINARY_DEFAULT

    def name(self) -> str:
        layers = ";".join(f"{m}+{s}" for m, s in self.layer_variants)
        return f"[{layers}|{self.trinary_mode}]"


@dataclasses.dataclass
class TuneResult:
    candidate: Candidate
    latency_s: float
    output_delta: float


def legal_two_layer_candidates(first_in: str = "F",
                               last_out: str = "F") -> Sequence[Candidate]:
    """Enumerate type-correct 2-layer GCN variant assignments (§3.1.2)."""
    out = []
    for (m1, s1), (m2, s2) in itertools.product(MMSPMM_PAIRINGS, repeat=2):
        if m1.split(".")[1][0] != first_in:
            continue
        if s2.split(".")[1][-1] != last_out:
            continue
        # inter-layer precision: spmm1 out == mm2 in
        if s1.split(".")[1][-1] != m2.split(".")[1][0]:
            continue
        for mode in ("s2_and_andnot", "s3_two_popc"):
            out.append(Candidate(((m1, s1), (m2, s2)), mode))
    return tuple(out)


def _first(out):
    return out if isinstance(out, torch.Tensor) else out[0]


def _sync(out) -> None:
    if _first(out).is_cuda:
        torch.cuda.synchronize(_first(out).device)


def _time_call(fn: Callable, *args, repeats: int = 3) -> float:
    _sync(fn(*args))   # warm (builds the kernels on first use)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def tune(build_forward: Callable[[Candidate], Callable],
         args: tuple,
         candidates: Sequence[Candidate],
         reference: Optional[torch.Tensor] = None,
         repeats: int = 3) -> Sequence[TuneResult]:
    """Time every candidate forward; rank by latency.

    ``build_forward(candidate)`` returns a callable; ``reference``
    (optional) is an fp32 forward output for accuracy-delta reporting.
    """
    results = []
    for cand in candidates:
        fwd = build_forward(cand)
        latency = _time_call(fwd, *args, repeats=repeats)
        delta = float("nan")
        if reference is not None:
            delta = float((_first(fwd(*args)) - reference).abs().mean())
        results.append(TuneResult(cand, latency, delta))
    return sorted(results, key=lambda r: r.latency_s)


def best(results: Sequence[TuneResult],
         max_delta: Optional[float] = None) -> TuneResult:
    ok = [r for r in results
          if max_delta is None or r.output_delta <= max_delta]
    if not ok:
        raise ValueError("no candidate satisfies the accuracy bound")
    return ok[0]
