"""A closed loop of one client running full-graph forwards back to back.

Each forward is one call of the program's forward, then
``torch.cuda.synchronize()``: a user classifying every node waits for the
answer. The window starts at the first call and ends at the end of the
synchronise that first crosses ``seconds``, so a rate taken over it covers
all the work and all the time of the window.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional


def run(forward: Callable, seconds: float, sync: Callable,
        keep_index: int, span: Optional[Callable] = None) -> dict:
    """Run the window. ``keep_index``: the forward whose output is kept
    beside the last one for the comparison. ``span(name)``: a context
    manager that marks the host's ``enqueue`` (call to return) and
    ``sync`` spans of each forward in a trace.

    Returns ``count``, ``window_s``, ``latencies_s`` (call to end of
    synchronise, each forward), ``enqueue_s`` (call to return) and
    ``outputs`` ({index: logits}) of the kept forward and the last."""
    span = span or (lambda name: contextlib.nullcontext())
    perf = time.perf_counter
    latencies, enqueue, outputs = [], [], {}
    out = None
    start = perf()
    while True:
        t0 = perf()
        with span("portbench.enqueue"):
            out = forward()
        t1 = perf()
        with span("portbench.sync"):
            sync()
        t2 = perf()
        if len(latencies) == keep_index:
            outputs[keep_index] = out
        latencies.append(t2 - t0)
        enqueue.append(t1 - t0)
        if t2 - start >= seconds:
            break
    outputs[len(latencies) - 1] = out
    return {"count": len(latencies), "window_s": t2 - start,
            "latencies_s": latencies, "enqueue_s": enqueue,
            "outputs": outputs}
