"""repro_torch FRDC and datasets held against the reference, field by field
(constructors, padding, ``stack_frdc``, group coarsening, datasets)."""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402

from repro.core import frdc as jf  # noqa: E402
from repro.graphs import datasets as jd  # noqa: E402
tf = lazy("repro_torch.core.frdc")
td = lazy("repro_torch.graphs.datasets")

jax.config.update("jax_platform_name", "cpu")

FIELDS = ("tiles", "col_idx", "group_row", "group_first", "grp_ptr")


def _assert_same(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert (got.n_rows, got.n_cols, got.nnz) == (want.n_rows, want.n_cols,
                                                 want.nnz)
    for f in ("row_scale", "col_scale"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    assert got.nbytes() == want.nbytes()
    assert tf.stats(got) == jf.stats(want)


def _edges(rng, n, density):
    a = rng.random((n, n)) < density
    return np.nonzero(a)


@pytest.mark.parametrize("n,density", [(1, 1.0), (3, 0.5), (37, 0.1),
                                       (70, 0.3)])
def test_constructors_match_reference(n, density):
    rng = np.random.default_rng(n)
    r, c = _edges(rng, n, density)
    _assert_same(tf.from_coo(r, c, n, n, device="cpu"),
                 jf.from_coo(r, c, n, n))
    _assert_same(tf.gcn_normalized(r, c, n, device="cpu"),
                 jf.gcn_normalized(r, c, n))
    _assert_same(tf.mean_normalized(r, c, n, device="cpu"),
                 jf.mean_normalized(r, c, n))


def test_empty_graph_and_rectangular():
    e = np.zeros(0, np.int64)
    _assert_same(tf.from_coo(e, e, 9, 9, device="cpu"), jf.from_coo(e, e, 9, 9))
    rng = np.random.default_rng(4)
    a = (rng.random((13, 29)) < 0.2).astype(np.float32)
    _assert_same(tf.from_dense(a, device="cpu"), jf.from_dense(a))
    with pytest.raises(ValueError):
        tf.from_coo([5], [0], 4, 4, device="cpu")


@pytest.mark.parametrize("kind", ["binary", "gcn"])
def test_pad_frdc_and_to_dense_match_reference(kind):
    rng = np.random.default_rng(7)
    r, c = _edges(rng, 30, 0.15)
    if kind == "gcn":
        t, j = tf.gcn_normalized(r, c, 30, device="cpu"), jf.gcn_normalized(r, c, 30)
    else:
        t, j = tf.from_coo(r, c, 30, 30, device="cpu"), jf.from_coo(r, c, 30, 30)
    _assert_same(tf.pad_frdc(t, 64, n_groups=t.n_groups + 5),
                 jf.pad_frdc(j, 64, n_groups=j.n_groups + 5))
    _assert_same(tf.pad_frdc(t, 33, 40), jf.pad_frdc(j, 33, 40))
    for scales in (True, False):
        np.testing.assert_array_equal(
            tf.to_dense(t, apply_scales=scales).numpy(),
            np.asarray(jf.to_dense(j, apply_scales=scales)))
    with pytest.raises(ValueError):
        tf.pad_frdc(t, 8)


def test_stack_frdc_matches_reference():
    """Shard-stacked fields of uniformly padded matrices (with and without
    scale vectors) equal the reference's; row ``s`` is shard ``s``'s
    matrix; the two refusals raise ``ValueError`` as the reference's."""
    rng = np.random.default_rng(11)
    pairs = []
    for n in (20, 31, 9):
        r, c = _edges(rng, n, 0.2)
        pairs.append((tf.gcn_normalized(r, c, n, device="cpu"),
                      jf.gcn_normalized(r, c, n),
                      tf.from_coo(r, c, n, n, device="cpu"),
                      jf.from_coo(r, c, n, n)))
    for k in (0, 2):
        g = max(p[k].n_groups for p in pairs)
        tm = tf.pad_frdc_uniform([p[k] for p in pairs], 32, 32, g)
        jm = jf.pad_frdc_uniform([p[k + 1] for p in pairs], 32, 32, g)
        got, want = tf.stack_frdc(tm), jf.stack_frdc(jm)
        assert sorted(got) == sorted(want)
        for f, v in got.items():
            assert v.shape[0] == len(pairs)
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[f]),
                                          err_msg=f)
            np.testing.assert_array_equal(v[1].numpy(),
                                          getattr(tm[1], f).numpy())
    with pytest.raises(ValueError, match="uniformly padded"):
        tf.stack_frdc([pairs[0][0], pairs[1][0]])
    with pytest.raises(ValueError, match="uniformly padded"):
        jf.stack_frdc([pairs[0][1], pairs[1][1]])
    mixed = tf.pad_frdc_uniform([pairs[0][0], pairs[1][2]], 32, 32, 40)
    with pytest.raises(ValueError, match="row_scale"):
        tf.stack_frdc(mixed)
    with pytest.raises(ValueError, match="row_scale"):
        jf.stack_frdc(jf.pad_frdc_uniform([pairs[0][1], pairs[1][3]],
                                          32, 32, 40))

def test_coarsen_and_neighbor_ids_match_reference():
    rng = np.random.default_rng(3)
    tiles = rng.integers(0, 2 ** 16, size=(5, 8))
    np.testing.assert_array_equal(
        tf.coarsen_groups(torch.from_numpy(tiles)).numpy().view(np.uint32),
        np.asarray(jf.coarsen_groups(tiles.astype(np.uint16))))
    col = rng.integers(0, 100, size=(5, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        tf.group_neighbor_ids(torch.from_numpy(col)).numpy(),
        np.asarray(jf.group_neighbor_ids(col)))


@pytest.mark.parametrize("name,seed,scale", [("cora", 0, 0.25),
                                             ("citeseer", 3, 0.1)])
def test_make_dataset_identical(name, seed, scale):
    want = jd.make_dataset(name, seed=seed, scale=scale)
    got = td.make_dataset(name, seed=seed, scale=scale)
    for f in ("x", "y", "edges", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert got.n_classes == want.n_classes
    _assert_same(got.adjacency("mean", device="cpu"), want.adjacency("mean"))


def test_device_defaults_to_cuda():
    """Entry points default to the card and never drop to the CPU on their
    own: without a usable CUDA device the default fails loudly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tf.from_coo([0], [0], 4, 4)
