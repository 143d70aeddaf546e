"""The device generator's realized counts, at a small scale on the CPU."""
import pytest
import torch

from portbench.data import graph as graphs

from .conftest import TINY


def make(seed, spec=TINY):
    return graphs.make_graph(spec, graphs.generator(seed, "cpu"), "cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**33 + 1])
def test_exact_edge_count_symmetric_no_self_loops(seed):
    g = make(seed)
    n = g.n_nodes
    assert g.n_edges == TINY["n_edges"]
    key = g.rows * n + g.cols
    assert torch.equal(key, torch.unique(key))            # sorted, distinct
    assert bool((g.rows != g.cols).all())
    assert torch.equal(torch.sort(g.cols * n + g.rows).values, key)
    assert g.x.shape == (n, TINY["n_feat"]) and g.x.dtype == torch.float32
    assert set(torch.unique(g.x).tolist()) <= {0.0, 1.0}


def test_same_seed_same_graph_other_seed_other_graph():
    a, b, c = make(5), make(5), make(6)
    assert torch.equal(a.rows, b.rows) and torch.equal(a.cols, b.cols)
    assert torch.equal(a.x, b.x)
    assert not torch.equal(a.rows, c.rows)


def test_feature_density_and_degree_tail_steady_across_seeds():
    spec = dict(TINY, n_nodes=4000, n_edges=80000, n_feat=200)
    top = []
    for seed in (1, 2, 3):
        g = make(seed, spec)
        density = float(g.x.mean())
        # 0.015 background plus 0.08 on the class's own 1/c of the columns
        assert 0.015 < density < 0.015 + 0.08 / spec["n_classes"] + 0.01
        top.append(int(torch.bincount(g.rows, minlength=4000).max()))
    assert max(top) < 1.2 * min(top)    # the same hub sizes, shuffled


def test_tile_count_against_a_dense_count():
    g = make(3)
    n = g.n_nodes
    dense = torch.zeros((-(-n // 4), -(-n // 4)), dtype=torch.bool)
    dense[g.rows // 4, g.cols // 4] = True
    assert graphs.tile_count(g.rows, g.cols, n) == int(dense.sum())


def test_glorot_bounds():
    w = graphs.glorot(graphs.generator(1, "cpu"), (60, 40), "cpu")
    lim = (6.0 / 100) ** 0.5
    assert w.shape == (60, 40) and float(w.abs().max()) <= lim
