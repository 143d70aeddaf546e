"""Kernel entry counting and :func:`launch_stats`'s op count.

Every wrapper of a hand-written kernel (``*_cuda`` and ``*_plain`` in
``pack_kernel``, ``bmm_kernel`` and ``bspmm_kernel``; the entry points of
``fused_layer``) runs inside :func:`entry`. Only the outermost entry of a
thread counts: a plain version that calls another (the fused layer's plain
aggregation, a grid's plain version) is one entry, as one CUDA launch
replaces it on the card. Each module keeps its counts by kernel in an
``ENTRIES`` dict beside its ``LAUNCHES``.

:class:`Recorder` is the op count behind ``ops.launch_stats``: a
``TorchDispatchMode`` that counts the aten ops dispatched outside any kernel
entry, and each entry as one op.
"""
from __future__ import annotations

import contextlib
import functools
import threading

from torch.utils._python_dispatch import TorchDispatchMode

_LOCAL = threading.local()


@contextlib.contextmanager
def entry(counter: dict, name: str):
    """Run the body as one entry into kernel ``name`` of ``counter``."""
    depth = getattr(_LOCAL, "depth", 0)
    if depth == 0:
        counter[name] += 1
        rec = getattr(_LOCAL, "recorder", None)
        if rec is not None:
            rec.calls += 1
            rec.ops += 1
    _LOCAL.depth = depth + 1
    try:
        yield
    finally:
        _LOCAL.depth = depth


def entry_point(counter: dict, name: str):
    """Decorator form of :func:`entry`."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            with entry(counter, name):
                return fn(*args, **kwargs)
        return counted
    return wrap


class Recorder(TorchDispatchMode):
    """Counts, in this thread while active, the aten ops dispatched outside
    kernel entries (``ops``) and the kernel entries (``calls``, each also
    one op)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.calls = 0

    def __enter__(self):
        if getattr(_LOCAL, "recorder", None) is not None:
            raise RuntimeError("launch_stats does not nest")
        _LOCAL.recorder = self
        return super().__enter__()

    def __exit__(self, *exc):
        _LOCAL.recorder = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(_LOCAL, "depth", 0) == 0:
            self.ops += 1
        return func(*args, **(kwargs or {}))
