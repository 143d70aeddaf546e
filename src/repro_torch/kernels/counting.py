"""Kernel entry counting, :func:`launch_stats`'s op count, and the port's
spans.

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

:func:`span` records a named span of the forward path, and :func:`entry` one
``kernel.<name>`` span for each outermost entry, only while a torch profiler
session is active (torch's own ``_is_profiler_enabled`` flag); otherwise a
span is one flag test and an empty context manager. :func:`setup_span`
records always: the set-up it times (an FRDC build) runs once an adjacency,
before any profiler starts. A span holds its name, the index of the span
around it in its thread, the id of the forward it belongs to (a new one for
each span opened with ``new_forward``), and its start and end on
``time.time_ns``, the clock of the profiler's device timeline. Spans go into
:data:`RING`, which keeps the newest :data:`RING_SPANS` and counts the ones
it drops; :func:`spans` returns them. No ``record_function`` or NVTX range
is emitted, so tracing adds no event to the device timeline.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import List, NamedTuple

from torch.autograd import profiler as _profiler
from torch.utils._python_dispatch import TorchDispatchMode

_LOCAL = threading.local()
# a 3 s traced window of the benchmark's fastest forwards (Flickr, ~1 ms,
# up to 21 spans each) records about 70k spans
RING_SPANS = 1 << 18
NO_SPAN = -1        # the parent of a root span; the forward of set-up


class Span(NamedTuple):
    index: int          # unique in the process, in the order spans opened
    name: str
    parent: int         # index of the enclosing span of its thread
    forward: int        # id of the forward it belongs to
    start_ns: int       # time.time_ns()
    end_ns: int


class SpanRing:
    """The newest ``size`` closed spans; ``dropped`` counts the older ones
    it let go."""

    def __init__(self, size: int = RING_SPANS):
        self._ring: collections.deque = collections.deque(maxlen=size)
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, record: tuple) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(record)

    def records(self) -> List[Span]:
        with self._lock:
            return [Span(*r) for r in self._ring]


RING = SpanRing()
_INDEX = itertools.count()
_FORWARD = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Span:
    """One span, recorded into :data:`RING` when it closes."""
    __slots__ = ("_name", "_new_forward", "_open")

    def __init__(self, name: str, new_forward: bool = False):
        self._name = name
        self._new_forward = new_forward

    def __enter__(self):
        stack = getattr(_LOCAL, "spans", None)
        if stack is None:
            stack = _LOCAL.spans = []
        parent, fwd = stack[-1] if stack else (NO_SPAN, NO_SPAN)
        if self._new_forward:
            fwd = next(_FORWARD)
        index = next(_INDEX)
        stack.append((index, fwd))
        self._open = (index, parent, fwd, time.time_ns())
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        index, parent, fwd, start = self._open
        _LOCAL.spans.pop()
        RING.append((index, self._name, parent, fwd, start, end))
        return False


def span(name: str, new_forward: bool = False):
    """A span of the forward path, recorded while a profiler is active;
    ``new_forward``: the span is the root of a forward and takes a new
    forward id for itself and the spans inside it."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, new_forward)


def setup_span(name: str) -> _Span:
    """A span of set-up, always recorded."""
    return _Span(name)


def spans() -> List[Span]:
    """The spans :data:`RING` holds, in the order they closed."""
    return RING.records()


@contextlib.contextmanager
def entry(counter: dict, name: str):
    """Run the body as one entry into kernel ``name`` of ``counter``."""
    depth = getattr(_LOCAL, "depth", 0)
    sp = None
    if depth == 0:
        counter[name] += 1
        rec = getattr(_LOCAL, "recorder", None)
        if rec is not None:
            rec.calls += 1
            rec.ops += 1
        if _profiler._is_profiler_enabled:
            sp = _Span("kernel." + name).__enter__()
    _LOCAL.depth = depth + 1
    try:
        yield
    finally:
        _LOCAL.depth = depth
        if sp is not None:
            sp.__exit__(None, None, None)


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
