"""One reader a metric (``metrics/<name>.py``), with its data file where it
has one (``metrics/<name>.json``: the kernel names it reads). A reader is
``read(ctx, spec) -> float or None``: ``ctx`` is the run's
:class:`portbench.harness.Context`, ``spec`` the contents of the data file
(``{}`` without one). A reader that finds nothing to read returns None and
the metric is left out of the result line.
"""
from __future__ import annotations

import re
from typing import Iterable


def matches(name: str, patterns: Iterable[str]) -> bool:
    """Whether a kernel name contains any of the regular expressions."""
    return any(re.search(p, name) for p in patterns)


def stage_device_s(trace, patterns) -> float:
    """Device seconds a forward of the traced operations whose names match
    ``patterns``."""
    total = sum(e - s for name, s, e in trace.device_ops
                if matches(name, patterns))
    return total / 1e9 / trace.forwards
