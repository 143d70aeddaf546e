"""Lazy module handles for the tests of the PyTorch port (``repro_torch``).

Pytest imports every test file in every worker while it collects the suite.
Importing torch there would load it into every worker, and torch roughly
doubles the objects the garbage collector walks, which slows each full
collection in that process: the serving timing tests of other files
(``tests/test_trace.py``) then measure the collector. So the port's test
files skip, as ``pytest.importorskip`` would, by finding torch without
importing it, and reach torch and ``repro_torch`` through these handles,
which import on first attribute access inside a test.
"""
import importlib
import importlib.util

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
            self._module = importlib.import_module(self._name)
        return getattr(self._module, attr)
