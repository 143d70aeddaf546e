"""Host-side logic of the edge-driven fp FRDC kernels (``csrc/walk.cuh``).

* The work items of heavy tile-rows (``bspmm_kernel.heavy_items``, the
  split each CUDA warp computes from ``group_row`` and ``grp_ptr``): every
  group of a tile-row over the threshold is covered once, in order, by
  items of at most ``GROUPS_PER_ITEM`` groups; light tile-rows and
  ``pad_frdc`` groups never are.
* The lane layout and vector-load choice of the wrappers
  (``bspmm_kernel.fp_layout``) for F in {1, 7, 8, 16, 17, 33, 64, 100},
  with an aligned x and x one element or one row past its buffer's start.
* The kernels' summation order written out with plain PyTorch ops: light
  tile-rows whole, heavy ones as per-item partial sums added in item order.
  It equals ``bspmm_fp_plain`` (F in {1, 7, 16, 64, 100}) and the
  reference ``bspmm_fp`` (Pallas in interpret mode, 1D and
  ``block_shape=(32, 32)``, F = 7) within 1e-5 of the sum of |terms| plus
  1e-6 (fp32 summation order) on a seeded graph with hub tile-rows of 17
  and 40 groups, and on its ``pad_frdc``-padded copy.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import frdc as jf  # noqa: E402
from repro.kernels import bspmm_kernel as jk  # noqa: E402
tf = lazy("repro_torch.core.frdc")
tk = lazy("repro_torch.kernels.bspmm_kernel")

jax.config.update("jax_platform_name", "cpu")

FP_TOL, FP_TOL_ABS = 1e-5, 1e-6
N = 1403                      # not a multiple of 4
HUBS = {1: 17, 4: 40}         # tile-row: groups


def _edges(seed):
    """Sparse random edges on rows 32..199, tile-rows of exactly HUBS
    groups, and no edges below row 200 (empty tile-rows)."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(32, 200, 400)]
    cols = [rng.integers(0, N, 400)]
    for tr, groups in HUBS.items():
        tc = rng.permutation(-(-N // 4))[:8 * groups]     # distinct tiles
        rows.append(tr * 4 + rng.integers(0, 4, tc.size))
        cols.append(np.minimum(tc * 4 + rng.integers(0, 4, tc.size), N - 1))
    return np.concatenate(rows), np.concatenate(cols)


def _pair(seed, pad=False):
    rows, cols = _edges(seed)
    ta = tf.from_coo(rows, cols, N, N, device="cpu")
    ja = jf.from_coo(rows, cols, N, N)
    per = (ta.grp_ptr[1:] - ta.grp_ptr[:-1]).tolist()
    assert {tr: per[tr] for tr in HUBS} == HUBS
    if pad:
        ta = tf.pad_frdc(ta, N + 13, n_groups=ta.n_groups + 11)
        ja = jf.pad_frdc(ja, N + 13, n_groups=ja.n_groups + 11)
    return ta, ja


def kernel_order(adj, x, heavy):
    """bspmm_fp in the CUDA kernels' order: a light tile-row summed whole,
    a heavy one as its items' partial sums added in item order."""
    f = x.shape[1]
    xp = tk._gather_rows(x, adj)
    gp = adj.grp_ptr.tolist()
    out = torch.zeros((adj.n_tile_rows, 4, f), dtype=x.dtype)

    def part(g0, g1):
        return tk._fp_terms(adj, xp, slice(g0, g1)).sum(0)

    for r in range(adj.n_tile_rows):
        if gp[r + 1] - gp[r] <= heavy:
            out[r] = part(gp[r], gp[r + 1])
    for _, _, r, g0, g1 in tk.heavy_items(adj.grp_ptr, adj.group_row, heavy):
        out[r] += part(g0, g1)
    return out.reshape(-1, f)


@pytest.mark.parametrize("heavy", [16, 32])
@pytest.mark.parametrize("pad", [False, True])
def test_heavy_items_cover_each_group_once_in_order(heavy, pad):
    ta, _ = _pair(3, pad)
    gp = ta.grp_ptr.tolist()
    items = tk.heavy_items(ta.grp_ptr, ta.group_row, heavy)
    heavy_rows = [r for r in range(ta.n_tile_rows) if gp[r + 1] - gp[r] > heavy]
    assert heavy_rows == [tr for tr, g in HUBS.items() if g > heavy]
    assert [k for k, *_ in items] == sorted(k for k, *_ in items)
    chunks = -(-ta.n_groups // tk.GROUPS_PER_ITEM)
    for r in heavy_rows:
        mine = [(k, s, g0, g1) for k, s, rr, g0, g1 in items if rr == r]
        covered = [g for *_, g0, g1 in mine for g in range(g0, g1)]
        assert covered == list(range(gp[r], gp[r + 1]))       # once, in order
        for k, s, g0, g1 in mine:
            assert 0 < g1 - g0 <= tk.GROUPS_PER_ITEM
            assert k < chunks and s in (0, 1)
            assert k == g0 // tk.GROUPS_PER_ITEM == (g1 - 1) // tk.GROUPS_PER_ITEM
            # slot 1 only for the first chunk of a row starting mid-chunk
            assert s == int(g0 == gp[r] and g0 % tk.GROUPS_PER_ITEM != 0)
    assert {rr for _, _, rr, _, _ in items} == set(heavy_rows)
    assert max((g1 for *_, g1 in items), default=0) <= gp[-1]  # no pad group
    # the kernels' scratch holds two slots of every chunk: no clash
    assert len({(k, s) for k, s, *_ in items}) == len(items)


def test_fp_layout_and_vector_choice():
    want = {1: (1, 1), 7: (8, 1), 8: (8, 1), 16: (16, 1), 17: (32, 1),
            33: (32, 2), 64: (32, 2), 100: (32, 4)}
    for f, (sub, cols) in want.items():
        buf = torch.zeros(9 * f + f)
        for offset in (0, 1, f):           # aligned, one element, one row
            x = buf[offset:offset + 9 * f].view(9, f)
            lay = tk.fp_layout(f, f, x.data_ptr())
            assert (lay.sub, lay.cols) == (sub, cols), (f, lay)
            aligned = x.data_ptr() % (4 * cols) == 0
            assert lay.vec == (cols > 1 and f % cols == 0 and aligned), \
                (f, offset, lay)
    # a grid pass is one feature block wide, and a vector must not straddle
    # block starts
    assert tk.fp_layout(8, 64, 0) == tk.FpLayout(8, 1, False)
    assert tk.fp_layout(48, 64, 0) == tk.FpLayout(32, 2, True)
    assert tk.fp_layout(36, 72, 0) == tk.FpLayout(32, 2, True)
    assert tk.fp_layout(66, 100, 0) == tk.FpLayout(32, 4, False)
    assert tk.fp_layout(64, 66, 0) == tk.FpLayout(32, 2, True)
    assert tk.fp_layout(64, 65, 0) == tk.FpLayout(32, 2, False)


def _hold(got, want, tol, what):
    assert got.shape == want.shape, what
    assert bool(((got - want).abs() <= tol).all()), what


def test_kernel_order_matches_plain_and_reference():
    f = 7
    ta, ja = _pair(f)
    x = np.random.default_rng(f).standard_normal((N, f)).astype(np.float32)
    xt = torch.from_numpy(x)
    want = tk.bspmm_fp_plain(ta, xt)
    tol = FP_TOL * tk.bspmm_fp_plain(ta, xt.abs()) + FP_TOL_ABS
    refs = {"1D": jk.bspmm_fp(ja, jnp.asarray(x)),
            "grid": jk.bspmm_fp(ja, jnp.asarray(x), block_shape=(32, 32))}
    for heavy in (tk.GROUPS_PER_ITEM, tk.HEAVY_GRID):
        got = kernel_order(ta, xt, heavy)
        _hold(got, want, tol, heavy)
        for name, ref in refs.items():
            _hold(got, torch.from_numpy(np.array(ref)), tol, (heavy, name))


@pytest.mark.parametrize("f", [1, 64, 100])
def test_kernel_order_matches_plain(f):
    ta, _ = _pair(f)
    x = torch.from_numpy(np.random.default_rng(f).standard_normal((N, f))
                         .astype(np.float32))
    tol = FP_TOL * tk.bspmm_fp_plain(ta, x.abs()) + FP_TOL_ABS
    for heavy in (tk.GROUPS_PER_ITEM, tk.HEAVY_GRID):
        _hold(kernel_order(ta, x, heavy), tk.bspmm_fp_plain(ta, x), tol, heavy)


def test_kernel_order_on_padded_bucket():
    """pad_frdc groups past grp_ptr[-1] and padded tile-rows: the kernel
    order still equals the plain version, and the padded rows are 0."""
    ta, _ = _pair(5, pad=True)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((N, 16))
                         .astype(np.float32))
    tol = FP_TOL * tk.bspmm_fp_plain(ta, x.abs()) + FP_TOL_ABS
    for heavy in (tk.GROUPS_PER_ITEM, tk.HEAVY_GRID):
        got = kernel_order(ta, x, heavy)
        _hold(got, tk.bspmm_fp_plain(ta, x), tol, heavy)
        assert not bool(got[N:].any())
