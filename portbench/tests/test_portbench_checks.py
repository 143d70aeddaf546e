"""The comparison that decides ``correct``, driven through a whole run on
the CPU (the harness's look for a chip skipped): clean, it reads correct;
with each fault that an inference cell can have planted under the timed
path, it reads not correct. And the control: the reference in the next
precision down fails the cell's limits at a size a test run holds, where
the program passes them (the program's own TF32 path on the card)."""
import importlib

import pytest
import torch

from portbench import calibrate, faults, harness
from portbench.reference import compare

from .conftest import tiny_cell

CELLS = ["bitgcn-bin.flickr", "bitsage.flickr"]
SMALL = {"n_nodes": 3000, "n_edges": 60000, "n_feat": 300, "n_classes": 7,
         "homophily": 0.85, "degree_alpha": 1.1, "feature_density": 0.015,
         "feature_signal": 0.08}


def run_tiny(monkeypatch, cell, wrap=None, trace=False):
    monkeypatch.setattr(harness, "load_cell",
                        lambda name: tiny_cell(name))
    return harness.run(cell, 2**31 + 99, 0.2, trace, device="cpu",
                       wrap=wrap, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_clean_run_is_correct(monkeypatch, cell):
    r = run_tiny(monkeypatch, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"mean_gap", "row_gap"}
    assert set(r["metrics"]) == {"hostpaced_forward_ms",
                                 "hostpaced_forward_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_reads_not_correct(monkeypatch, cell, fault):
    r = run_tiny(monkeypatch, cell, wrap=faults.FAULTS[fault](7))
    assert not r["correct"] and r["failed"] > 0


def test_traced_run_on_the_cpu_reads_no_device_metric(monkeypatch):
    r = run_tiny(monkeypatch, "bitsage.flickr", trace=True)
    assert r["correct"]
    assert set(r["metrics"]) == {"hostpaced_forward_mfu",
                                 "hostpaced_host_enqueue_ms"}
    assert r["device"]["busy_s"] == 0


@pytest.mark.parametrize("cell,precision", [("bitgcn-bin.flickr", "tf32"),
                                            ("bitsage.flickr", "bfloat16")])
def test_control_fails_the_limits_where_the_program_passes(cell, precision):
    c = tiny_cell(cell, SMALL)
    harness.configure_torch()
    r = calibrate.read_seed(c, 11, 0.1, True, device="cpu", log=lambda m: None)
    readings = r["readings"]
    assert compare.within(readings["program"], c.limits)
    assert not compare.within(readings[f"control_reference_{precision}"],
                              c.limits)
    for fault in faults.FAULTS:
        assert not compare.within(readings[fault], c.limits)


@pytest.mark.gpu
def test_program_tf32_path_fails_the_limits_on_the_card(cuda):
    from repro_torch.kernels import build
    c = tiny_cell("bitgcn-bin.flickr", SMALL)
    harness.configure_torch()
    build.build_all(c.config["libraries"])
    readings = calibrate.read_seed(c, 11, 0.1, True, device=cuda,
                                   log=lambda m: None)["readings"]
    assert compare.within(readings["program"], c.limits)
    assert not compare.within(readings["control_program"], c.limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_on_the_card_against_reference(cuda, cell):
    from repro_torch.kernels import build
    c = tiny_cell(cell, SMALL)
    harness.configure_torch()
    build.build_all(c.config["libraries"])
    inp = harness.make_inputs(c, 12, cuda, lambda m: None)
    prog = importlib.import_module(
        f"portbench.programs.{c.config['program']}").build(
        inp.x, inp.rows, inp.cols, inp.weights, c.config, cuda)
    out = prog.forward()
    lo, hi = importlib.import_module(
        f"portbench.reference.{c.config['program']}").bounds(
        inp.x, torch.from_numpy(inp.rows).to(cuda),
        torch.from_numpy(inp.cols).to(cuda), inp.weights)
    assert compare.within(compare.gaps(out, lo, hi), c.limits)
