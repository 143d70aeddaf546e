"""The system under test, one module a family (``programs/<program>.py``,
named by a configuration's ``program``): each builds the port's model and
adjacencies from the benchmark's inputs and hands back the forward that
the window times. Only these modules import ``repro_torch``."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional


class Program(NamedTuple):
    forward: Callable           # one full-graph forward -> (n, c) logits
    control: Optional[Callable]  # a context manager: the program's own
                                 # lower-precision path, or None
