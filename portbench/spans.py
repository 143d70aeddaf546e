"""The port's own spans (``repro_torch.kernels.counting.spans``) read beside
a traced window.

The port records its spans on ``time.time_ns``, the clock of the window's
``portbench.*`` spans and of the profiler's device timeline, so the three
compare directly. The forward path's spans exist only while the profiler
runs, so only the traced window has them; the FRDC build's spans are
recorded in set-up. :func:`recorded` is None outside a traced run on the
card (a trace with no device operation: a run on the CPU) and where the
port records no spans (a checkout from before it did); every reader then
finds nothing to read.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]
FORWARD = "gnn.forward"
KERNEL = "kernel."
FRDC_BUILD = "frdc.from_coo"


def recorded(ctx) -> Optional[list]:
    """Every span the port holds, or None (see the module's doc)."""
    t = ctx.trace
    if t is None or not t.device_ops:
        return None
    try:
        from repro_torch.kernels import counting
    except ImportError:
        return None
    read = getattr(counting, "spans", None)
    return None if read is None else read()


def outermost(spans: Sequence, pred: Callable) -> list:
    """The spans that satisfy ``pred`` with no ancestor that does."""
    by_index = {s.index: s for s in spans}

    def nested(s) -> bool:
        p = by_index.get(s.parent)
        while p is not None:
            if pred(p):
                return True
            p = by_index.get(p.parent)
        return False
    return [s for s in spans if pred(s) and not nested(s)]


def union(intervals) -> List[Interval]:
    """The union of ``(start, end)`` intervals, in order."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The parts of the union ``a`` that the union ``b`` does not cover."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, t = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > t:
                out.append((t, b[k][0]))
            t = max(t, b[k][1])
            k += 1
        if t < e:
            out.append((t, e))
    return out


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """The length of the intersection of the unions ``a`` and ``b``."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def length_ns(intervals: List[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def idle(trace) -> List[Interval]:
    """The stretches of the window that no device operation covers."""
    return subtract([(trace.start_ns, trace.end_ns)], trace.intervals())


def forward_parts(ctx) -> Optional[Tuple[List[Interval], List[Interval]]]:
    """The host's time inside the window's ``gnn.forward`` spans, and the
    part of it inside their outermost ``kernel.*`` spans (the calls into
    the port's own kernels), each as a union; None where there is none."""
    spans = recorded(ctx)
    if spans is None:
        return None
    t = ctx.trace
    window = [s for s in spans if t.start_ns <= s.start_ns
              and s.end_ns <= t.end_ns]
    forwards = [s for s in window if s.name == FORWARD]
    if not forwards:
        return None
    ids = {s.forward for s in forwards}
    calls = outermost(window, lambda s: s.name.startswith(KERNEL))
    kernels = [s for s in calls if s.forward in ids]
    return (union((s.start_ns, s.end_ns) for s in forwards),
            union((s.start_ns, s.end_ns) for s in kernels))


def blocks(ctx) -> Optional[List[Interval]]:
    """The host's time in the forwards outside the kernel calls: BN, BIN's
    sign, abs and mean, the scales, the adds, cuBLAS and their Python."""
    parts = forward_parts(ctx)
    return None if parts is None else subtract(*parts)
