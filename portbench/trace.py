"""A window under ``torch.profiler``, reduced to what the per-layer
metrics read: the device operations (name, start, end) and the host's
``portbench.*`` spans, on one clock.

The traced window runs from the start of its first host span to the end
of its last. ``busy_s`` is the union of the device operations' intervals
inside it; an idle gap is a stretch of it that no device operation
covers, named by the host span at its middle (``enqueue``: the forward's
call was running; ``sync``: the host waited in ``synchronize``;
``between``: neither).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import List, NamedTuple, Tuple


NAME_CHARS = 160   # a kernel's name in the breakdown, cut to this length


class Trace(NamedTuple):
    device_ops: List[Tuple[str, int, int]]   # (name, start_ns, end_ns)
    spans: List[Tuple[str, int, int]]        # host spans, by start
    forwards: int
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        merged: List[List[int]] = []
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def gaps(self) -> List[Tuple[str, float]]:
        """Every idle gap of the window: (host span at its middle, s)."""
        out, t = [], self.start_ns
        bounds = self.intervals() + [(self.end_ns, self.end_ns)]
        starts = [s for _, s, _ in self.spans]
        for s, e in bounds:
            if s > t:
                mid = (s + t) // 2
                i = bisect.bisect_right(starts, mid) - 1
                name = "between"
                if i >= 0 and self.spans[i][2] >= mid:
                    name = self.spans[i][0].rsplit(".", 1)[-1]
                out.append((name, (s - t) / 1e9))
            t = max(t, e)
        return out

    def by_name(self) -> list:
        """(name, device s a forward, launches a forward) of every
        operation name, the most time first."""
        t: dict = defaultdict(int)
        k: dict = defaultdict(int)
        for name, s, e in self.device_ops:
            t[name] += e - s
            k[name] += 1
        return sorted(((n, t[n] / 1e9 / self.forwards, k[n] / self.forwards)
                       for n in t), key=lambda r: -r[1])

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        host span (total, and the longest single gap of each), seconds."""
        by_name: dict = defaultdict(int)
        for name, s, e in self.device_ops:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        total: dict = defaultdict(float)
        longest: dict = defaultdict(float)
        for name, sec in self.gaps():
            total[name] += sec
            longest[name] = max(longest[name], sec)
        gaps = [[f"{k} (total)", v] for k, v in total.items()]
        gaps += [[f"{k} (longest)", v] for k, v in longest.items()]
        gaps.sort(key=lambda kv: -kv[1])
        return {"device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in ops],
                "idle_gaps": gaps[:top]}


class Spans:
    """Host spans on the profiler's clock (``time.time_ns``, the clock
    that the profiler's device timeline is given in): calling it with a
    name gives a context manager that records one span."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t, time.time_ns()))


def profile(run_window):
    """Run ``run_window(span)`` under the profiler, tracing the device
    alone (host operations untraced, so the host runs at its own pace);
    returns its result and the :class:`Trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    spans = Spans()
    # without a card (the CPU tests) the trace holds no device operation
    activity = ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU
    with _profile(activities=[activity]) as prof:
        result = run_window(spans)
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    marks = sorted(spans.spans, key=lambda s: s[1])
    start = marks[0][1] if marks else 0
    end = marks[-1][2] if marks else 0
    return result, Trace(device_ops=ops, spans=marks,
                         forwards=result["count"], start_ns=start, end_ns=end)
