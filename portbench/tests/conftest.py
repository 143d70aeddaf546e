"""The benchmark's CPU tests: ``python -m pytest portbench/tests`` from the
root of the repository. Cases marked ``gpu`` need a CUDA device and skip
without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"n_nodes": 600, "n_edges": 12000, "n_feat": 70, "n_classes": 5,
        "homophily": 0.85, "degree_alpha": 1.1, "feature_density": 0.015,
        "feature_signal": 0.08}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


from portbench import harness  # noqa: E402

LOAD_CELL = harness.load_cell


def tiny_cell(name, graph=None):
    """The cell ``name`` with a small graph of the same kind."""
    cell = LOAD_CELL(name)
    traffic = dict(cell.traffic, graph=dict(graph or TINY),
                   loop=dict(cell.traffic["loop"], trace_seconds=0.2))
    return cell._replace(traffic=traffic)
