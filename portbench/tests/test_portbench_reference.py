"""The plain references against dense float32 forwards written out here
from the layer equations, and the program (the port's plain kernels on
the CPU) against the references, on tiny graphs."""
import pytest
import torch

from portbench import harness
from portbench.reference import compare, gcn_bin, sage

from .conftest import tiny_cell


def sgn(x):
    return torch.where(x >= 0, 1.0, -1.0)


def bn(x):
    return (x - x.mean(0)) / (x.std(0, correction=0) + 1e-5)


def dense_inputs(seed):
    cell = tiny_cell("bitsage.flickr")
    inp = harness.make_inputs(cell, seed, "cpu", lambda m: None)
    n = inp.x.shape[0]
    rows = torch.from_numpy(inp.rows)
    cols = torch.from_numpy(inp.cols)
    a = torch.zeros((n, n))
    a[rows, cols] = 1.0
    return inp.x, rows, cols, a


def dense_gcn_bin(x, a, w1, w2):
    n = x.shape[0]
    h = bn(x) @ (sgn(w1) * w1.abs().mean(0))
    counts = a @ sgn(h)
    z = (sgn(counts) @ sgn(w2)) * w2.abs().mean(0)
    a_hat = a + torch.eye(n)
    d = a_hat.sum(1) ** -0.5
    return (d[:, None] * a_hat * d[None, :]) @ z


def dense_sage(x, a, ws):
    d = 1.0 / a.sum(1).clamp(min=1)
    h = x
    for i, (w_self, w_agg) in enumerate(ws):
        b = bn(h)
        r = b.abs().mean(1, keepdim=True)
        s = (sgn(b) @ sgn(w_self)) * r * w_self.abs().mean(0)
        g = (sgn(b) @ sgn(w_agg)) * r * w_agg.abs().mean(0)
        h = s + (d[:, None] * a) @ g
        if i == 0:
            h = torch.relu(h)
    return h


@pytest.mark.parametrize("seed", [1, 2])
def test_gcn_bin_against_dense(seed):
    x, rows, cols, a = dense_inputs(seed)
    g = torch.Generator().manual_seed(seed)
    w = {"w1": torch.randn(x.shape[1], 16, generator=g),
         "w2": torch.randn(16, 5, generator=g)}
    got = gcn_bin.forward(x, rows, cols, w)
    want = dense_gcn_bin(x, a, w["w1"], w["w2"])
    assert got.dtype == torch.float64
    assert compare.gaps(got, want)["mean_gap"] < 1e-5
    lo, hi = gcn_bin.bounds(x, rows, cols, w)
    assert bool((lo <= got).all() and (got <= hi).all())


@pytest.mark.parametrize("seed", [1, 2])
def test_sage_against_dense(seed):
    x, rows, cols, a = dense_inputs(seed)
    g = torch.Generator().manual_seed(seed)
    shapes = [(x.shape[1], 16), (x.shape[1], 16), (16, 5), (16, 5)]
    ws = [torch.randn(*s, generator=g) for s in shapes]
    names = ["w1_self", "w1_agg", "w2_self", "w2_agg"]
    got = sage.forward(x, rows, cols, dict(zip(names, ws)))
    want = dense_sage(x, a, [(ws[0], ws[1]), (ws[2], ws[3])])
    assert compare.gaps(got, want)["mean_gap"] < 1e-5
    lo, hi = sage.bounds(x, rows, cols, dict(zip(names, ws)))
    assert bool((lo <= got).all() and (got <= hi).all())


@pytest.mark.parametrize("cell", ["bitgcn-bin.flickr", "bitsage.flickr"])
def test_program_on_cpu_against_reference(cell):
    import importlib
    c = tiny_cell(cell)
    harness.configure_torch()
    inp = harness.make_inputs(c, 9, "cpu", lambda m: None)
    prog = importlib.import_module(
        f"portbench.programs.{c.config['program']}").build(
        inp.x, inp.rows, inp.cols, inp.weights, c.config, "cpu")
    out = prog.forward()
    lo, hi = importlib.import_module(
        f"portbench.reference.{c.config['program']}").bounds(
        inp.x, torch.from_numpy(inp.rows), torch.from_numpy(inp.cols),
        inp.weights)
    assert compare.within(compare.gaps(out, lo, hi), c.limits)


def test_gaps_of_shape_and_non_finite():
    ref = torch.ones(4, 3, dtype=torch.float64)
    assert compare.gaps(torch.ones(3, 3), ref)["mean_gap"] == float("inf")
    bad = torch.ones(4, 3)
    bad[1, 1] = float("nan")
    assert not compare.within(compare.gaps(bad, ref), {"mean_gap": 1.0})
    assert compare.gaps(torch.ones(4, 3), ref) == {"mean_gap": 0.0,
                                                   "row_gap": 0.0}
    # inside an interval reads 0, outside by its distance
    lo, hi = ref - 1, ref + 1
    assert compare.gaps(torch.full((4, 3), 1.5), lo, hi)["mean_gap"] == 0.0
    assert compare.gaps(torch.full((4, 3), 3.0), lo, hi)["mean_gap"] == 1.0


def test_open_signs_widen_the_interval():
    from portbench.reference import common
    x = torch.tensor([1e-9, -1.0, 0.5], dtype=torch.float64)
    s, open_ = common.sign3(x, torch.ones(3, dtype=torch.float64))
    assert s.tolist() == [0.0, -1.0, 1.0] and open_.tolist() == [1.0, 0, 0]
