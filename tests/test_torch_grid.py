"""The 2D block-grid BSpMM of the port against the reference's.

``block_probe`` / ``_block_plan`` / ``_resolve_block`` accept and reject the
same block shapes with the same messages; the CUDA grid's geometry equals
the reference's ``_grid_dims``. The grid plain versions (the 1D plain
versions: the grid reorders the sums, it does not change them) are held
against the reference grid kernels ``_bspmm_bits_grid`` / ``_bspmm_fp_grid``
in interpret mode: bits and counts bit-exact, fp at rtol = atol = 1e-5 (fp32
summation order), over the edge cases (N < 4, ragged node counts, empty
tile-rows, ``pad_frdc`` groups, feats < width, feature blocks that do not
divide F, tail words).
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitops as jb, frdc as jf  # noqa: E402
from repro.kernels import bspmm_kernel as jk  # noqa: E402
tf = lazy("repro_torch.core.frdc")
tk = lazy("repro_torch.kernels.bspmm_kernel")
tops = lazy("repro_torch.kernels.ops")
tbspmm = lazy("repro_torch.core.bspmm")
tbin = lazy("repro_torch.core.binarize")

jax.config.update("jax_platform_name", "cpu")

PROBES = [None, (4, None), (8, 32), (12, 64), (0, 32), (6, 32), (-4, None),
          (4, 0), (4, -32), (4, 24), (4, 40), (8, 7), (16, 500), (32, 33)]


def _t(u32) -> "torch.Tensor":
    return torch.from_numpy(np.array(u32, np.uint32).view(np.int32))


def test_block_probe_and_plan_match_reference():
    for block in PROBES:
        for f in (7, 24, 64, 100):
            for packed in (False, True):
                case = (block, f, packed)
                assert tk.block_probe(block, f, packed) == \
                    jk.block_probe(block, f, packed), case
                want = jk.block_probe(block, f, packed)
                if want is None:
                    assert tuple(tk._block_plan(block, f, packed) or ()) == \
                        tuple(jk._block_plan(block, f, packed) or ()), case
                    assert tk._resolve_block(block, f, packed) == \
                        jk._resolve_block(block, f, packed), case
                else:
                    with pytest.raises(ValueError) as e:
                        tk._block_plan(block, f, packed)
                    assert str(e.value) == want
                    with pytest.raises(ValueError):
                        tk._resolve_block(block, f, packed)


def _pair(rng, n, density, pad):
    a = (rng.random((n, n)) < density).astype(np.float32)
    a[(n + 1) // 2:] = 0                       # empty tile-rows
    ja, ta = jf.from_dense(a), tf.from_dense(a, device="cpu")
    if pad:
        ja = jf.pad_frdc(ja, n + 24, n_groups=ja.n_groups + 5)
        ta = tf.pad_frdc(ta, n + 24, n_groups=ta.n_groups + 5)
    return ja, ta


def test_grid_dims_match_reference():
    rng = np.random.default_rng(11)
    for n, rows, feats, width, pad in [(30, 8, 32, 64, False),
                                       (33, 12, None, 96, True),
                                       (3, 32, 7, 7, False)]:
        ja, ta = _pair(rng, n, 0.2, pad)
        want = jk._grid_dims(ja, jk.BlockPlan(rows, feats), width)
        got = tk._grid_geometry(ta, tk.BlockPlan(rows, feats), width)
        assert got == tuple(want[:4])
        # the reference extends grp_ptr with empty ranges for the padded
        # tile-rows, which the CUDA grid skips; its real ranges are ours
        gp = np.asarray(want[4])
        np.testing.assert_array_equal(gp[: ta.n_tile_rows + 1],
                                      ta.grp_ptr.numpy())
        assert (gp[ta.n_tile_rows:] == gp[-1]).all()


# (seed, n, f, rows, feats, pad): N < 4 with tail bits; one tile-row; ragged
# node count; feats not dividing f (fp zero-pads); f narrower than a word
# with a real-width block; pad_frdc groups and rows; block rows past the
# tile-row count
GRID_CASES = [(0, 3, 7, 4, None, False), (1, 4, 32, 4, None, False),
              (2, 22, 64, 8, 32, False), (3, 15, 96, 12, 64, True),
              (4, 18, 24, 4, 24, False), (7, 28, 40, 16, 32, True)]


@pytest.mark.parametrize("seed,n,f,rows,feats,pad", GRID_CASES)
def test_grid_plain_matches_pallas_grid(seed, n, f, rows, feats, pad):
    rng = np.random.default_rng(seed)
    ja, ta = _pair(rng, n, 0.15, pad)
    x = rng.standard_normal((ja.n_cols, f)).astype(np.float32)
    plan_j = jk._block_plan((rows, feats), f, False)
    plan_t = tk._block_plan((rows, feats), f, False)
    want = np.asarray(jk._bspmm_fp_grid(ja, jnp.asarray(x), plan_j, True))
    got = tk.bspmm_fp_grid_plain(ta, torch.from_numpy(x), plan_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), tk.bspmm_fp_plain(ta, torch.from_numpy(x)).numpy(),
        rtol=1e-5, atol=1e-5)

    xp = np.asarray(jb.pack_bits(rng.integers(0, 2, (ja.n_cols, f))))
    # packed blocks stay word-aligned (or the real width)
    blk = (rows, None) if (feats is not None and feats % 32) else (rows, feats)
    plan_j = jk._block_plan(blk, f, True)
    plan_t = tk._block_plan(blk, f, True)
    mode = ("s3_two_popc", "s2_and_andnot")[seed % 2]
    for binarize in (False, True):
        want = np.asarray(jk._bspmm_bits_grid(
            ja, jnp.asarray(xp), f, binarize, mode, plan_j, True))
        got = tk.bspmm_bits_grid_plain(ta, _t(xp), f, binarize, mode, plan_t)
        got_np = got.numpy().view(np.uint32) if binarize else got.numpy()
        np.testing.assert_array_equal(got_np, want, err_msg=str(binarize))
        assert torch.equal(got, tk.bspmm_bits_plain(
            ta, _t(xp), f, binarize, mode))


def test_ops_and_serve_kernels_route_to_the_grid():
    """ops.bspmm_* with a block shape, and core.bspmm inside
    serve_kernels(block_shape=...), give the 1D results; a bad block
    raises the probe's message; serve_kernels(False) ignores the block."""
    rng = np.random.default_rng(5)
    _, ta = _pair(rng, 50, 0.15, True)
    s = torch.from_numpy(rng.random(ta.n_rows).astype(np.float32) + 0.5)
    ta = ta._replace(row_scale=s, col_scale=s)
    x = torch.from_numpy(rng.standard_normal((ta.n_cols, 40)).astype(
        np.float32))
    np.testing.assert_allclose(tops.bspmm_fp(ta, x, block_shape=(8, 16)),
                               tops.bspmm_fp(ta, x), rtol=1e-6, atol=1e-6)
    xb = tbin.binarize_matrix(x)
    for variant in ("BBF", "BBB"):
        base = tbspmm.bspmm(ta, xb, variant)
        with tops.serve_kernels(True, block_shape=(12, 32)) as on:
            assert on
            grid = tbspmm.bspmm(ta, xb, variant)
        if variant == "BBB":
            assert torch.equal(grid.packed, base.packed)
        else:
            assert torch.equal(grid, base)
    with tops.serve_kernels(False, block_shape=(6, 32)) as on:
        assert not on
        tbspmm.bspmm(ta, xb, "BBF")          # the block is ignored
    with tops.serve_kernels(True, block_shape=(6, 32)):
        with pytest.raises(ValueError, match="rows 6 is not a positive"):
            tbspmm.bspmm(ta, xb, "BBF")
