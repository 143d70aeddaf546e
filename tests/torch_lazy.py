"""Lazy module handles for the tests of the PyTorch port (``repro_torch``).

Pytest imports every test file in every worker while it collects the suite.
Importing torch there would load it into every worker, and torch roughly
doubles the objects the garbage collector walks, which slows each full
collection in that process: the serving timing tests of other files
(``tests/test_trace.py``) then measure the collector. So the port's test
files skip, as ``pytest.importorskip`` would, by finding torch without
importing it, and reach torch and ``repro_torch`` through these handles,
which import on first attribute access inside a test.

The first of those imports also sets torch's intra-op pool to one thread.
By default each worker starts one OpenMP thread per core, and the threads
keep spinning for a while after every parallel op: with several workers
on a host of a few cores, the port's tests then take the cores from the
timing tests that run beside them (``test_trace.py::test_trace_overhead_within_5pct``
compares two best-of-5 QPS readings within 5%). The port's CPU tests are
small; their wall time does not change with one thread.
"""
import importlib
import importlib.util
import sys

import pytest


def require_torch() -> None:
    """Skip the calling test module when torch is not installed."""
    if importlib.util.find_spec("torch") is None:
        pytest.skip("needs torch", allow_module_level=True)


class lazy:
    """A module that is imported on first attribute access."""

    def __init__(self, name: str):
        self._name = name
        self._module = None

    def __getattr__(self, attr):
        if attr.startswith("__"):
            # pytest probes collected objects (__test__, __bases__); answering
            # those must not import the module
            raise AttributeError(attr)
        if self._module is None:
            self._module = _import(self._name)
        return getattr(self._module, attr)


def _import(name: str):
    first = "torch" not in sys.modules
    module = importlib.import_module(name)
    if first and "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(1)
    return module
