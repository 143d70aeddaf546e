"""Host-side logic of the bits FRDC kernels (``csrc/walk.cuh``).

* The register bit transpose (``transpose32``: five ``__shfl_xor_sync``
  rounds of masked swaps) written out lane by lane with PyTorch ops equals
  ``bit_transpose_32`` of the reference and of the port on seeded words,
  bit for bit.
* The chunk split of heavy tile-rows (``bspmm_kernel.heavy_items``, what
  each CUDA warp works out from ``group_row`` and ``grp_ptr``): every group
  of a tile-row over the threshold is covered once, in order; light and
  ``pad_frdc`` groups never are; each row's item count is the ticket count
  its last warp waits for, and the items fit the kernels' scratch.
* The kernels' summation written out with plain PyTorch ops (the
  transpose above, light tile-rows whole, heavy ones as chunk partials added
  in chunk order, sign words with the tail masked), at the bits kernels'
  threshold of 16 groups and at 32, equals the reference
  ``bspmm_bits`` (Pallas in interpret mode, 1D and ``block_shape=(32,
  32)``) and ``bspmm_bits_plain`` bit for bit: s2 and s3, counts and sign
  words, F in {7, 64, 100}, N not a multiple of 4, hub tile-rows of 17 and
  40 groups, and a ``pad_frdc`` copy.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitops as jb  # noqa: E402
from repro.core import frdc as jf  # noqa: E402
from repro.kernels import bspmm_kernel as jk  # noqa: E402
tb = lazy("repro_torch.core.bitops")
tf = lazy("repro_torch.core.frdc")
tk = lazy("repro_torch.kernels.bspmm_kernel")

jax.config.update("jax_platform_name", "cpu")

N = 1403                      # not a multiple of 4
HUBS = {1: 17, 4: 40}         # tile-row: groups
MODES = ("s3_two_popc", "s2_and_andnot")
MASK = 0xFFFFFFFF


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


def transpose32(x):
    """``walk::transpose32`` lane by lane: x (..., 32) words (int64 holding
    uint32), lane k's word last; returns each lane's word after the five
    rounds. Round j: a lane with bit j clear keeps its columns with bit j
    clear, rotates the others right by j and sends them to lane ^ j; its
    partner keeps the columns with bit j set and sends the rest rotated
    left by j."""
    lane = torch.arange(32)
    for j in (16, 8, 4, 2, 1):
        low_cols = MASK // ((1 << j) + 1)
        low = (lane & j) == 0
        keep = torch.where(low, low_cols, low_cols ^ MASK)
        give = x & (keep ^ MASK)
        rot = torch.where(low, 32 - j, j)
        sent = ((give << rot) | (give >> (32 - rot))) & MASK
        x = (x & keep) | sent[..., lane ^ j]
    return x


def test_transpose32_matches_bit_transpose():
    rng = np.random.default_rng(15)
    words = rng.integers(0, 1 << 32, (257, 32), dtype=np.uint64).astype(np.uint32)
    words[0] = 0
    words[1] = MASK
    words[2] = 1 << np.arange(32, dtype=np.uint32)     # the identity block
    got = transpose32(torch.from_numpy(words.astype(np.int64)))
    want = np.asarray(jb.bit_transpose_32(jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    port = tb.as_u32(tb.bit_transpose_32(torch.from_numpy(words.view(np.int32))))
    assert torch.equal(got, port)


@pytest.mark.parametrize("heavy", [16, 32])
@pytest.mark.parametrize("pad", [False, True])
def test_bits_chunks_cover_each_group_once_in_order(heavy, pad):
    ta, _ = _pair(3, pad)
    gp = ta.grp_ptr.tolist()
    c = tk.GROUPS_PER_ITEM
    items = tk.heavy_items(ta.grp_ptr, ta.group_row, heavy)
    heavy_rows = [r for r in range(ta.n_tile_rows) if gp[r + 1] - gp[r] > heavy]
    assert heavy_rows == [tr for tr, g in HUBS.items() if g > heavy]
    for r in heavy_rows:
        mine = [(k, s, g0, g1) for k, s, rr, g0, g1 in items if rr == r]
        covered = [g for *_, g0, g1 in mine for g in range(g0, g1)]
        assert covered == list(range(gp[r], gp[r + 1]))       # once, in order
        # the ticket count of split_block: chunks k0 .. k1 of the row
        assert len(mine) == (gp[r + 1] - 1) // c - gp[r] // c + 1
        for k, s, g0, g1 in mine:
            assert 0 < g1 - g0 <= c and k == g0 // c == (g1 - 1) // c
            assert s == int(g0 == gp[r] and g0 % c != 0)
    assert {rr for _, _, rr, _, _ in items} == set(heavy_rows)
    assert max((g1 for *_, g1 in items), default=0) <= gp[-1]  # no pad group
    # two scratch slots a chunk, of the chunks of n_groups: no clash
    slots = {2 * k + s for k, s, *_ in items}
    assert len(slots) == len(items) and max(slots) < 2 * -(-ta.n_groups // c)


def _terms(adj, xp, g, mode):
    """A group's counts as the kernel computes them: gathered rows, the
    lane-wise transpose, trinary popc against the coarsened adjacency words
    (the formula of ``mode`` as written)."""
    bg = xp[tf.group_neighbor_ids(adj.col_idx[g]).long()]   # (g, 32, wf)
    bt = transpose32(tb.as_u32(bg).transpose(-1, -2))        # (g, wf, 32)
    a = tb.as_u32(tf.coarsen_groups(adj.tiles[g]))[:, :, None, None]
    b = bt[:, None]
    if mode == "s3_two_popc":
        c = 2 * tb.popcount(a & b) - tb.popcount(a)
    else:
        c = tb.popcount(a & b) - tb.popcount(a & (b ^ MASK))
    return c.flatten(2)


def kernel_order(adj, x, n_feat, binarize, mode, heavy):
    """bspmm_bits in the CUDA kernels' order: a light tile-row summed whole,
    a heavy one as its chunk items' partial sums added in chunk order."""
    xp = tk._gather_rows(x, adj)
    gp = adj.grp_ptr.tolist()
    out = torch.zeros((adj.n_tile_rows, 4, x.shape[1] * 32), dtype=torch.int64)

    def part(g0, g1):
        return _terms(adj, xp, slice(g0, g1), mode).sum(0)

    for r in range(adj.n_tile_rows):
        if gp[r + 1] - gp[r] <= heavy:
            out[r] = part(gp[r], gp[r + 1])
    for _, _, r, g0, g1 in tk.heavy_items(adj.grp_ptr, adj.group_row, heavy):
        out[r] += part(g0, g1)
    counts = out.reshape(-1, x.shape[1] * 32).to(torch.int32)
    return tb.pack_bits(counts[:, :n_feat] >= 0) if binarize else counts


def _check(ta, ja, f, seed, grid_ref):
    rng = np.random.default_rng(seed)
    words = np.array(jb.pack_bits(jnp.asarray(rng.integers(0, 2, (N, f)))))
    xt = torch.from_numpy(words.view(np.int32))
    for mode in MODES:
        for binz in (False, True):
            got = {h: kernel_order(ta, xt, f, binz, mode, h)
                   for h in (tk.GROUPS_PER_ITEM, tk.HEAVY_GRID)}
            want = tk.bspmm_bits_plain(ta, xt, f, binz, mode)
            refs = {"1D": jk.bspmm_bits(ja, jnp.asarray(words), f, binz, mode)}
            if grid_ref(mode, binz):
                refs["grid"] = jk.bspmm_bits(ja, jnp.asarray(words), f, binz,
                                             mode, block_shape=(32, 32))
            for h, g in got.items():
                assert torch.equal(g, want), (h, mode, binz)
                for name, ref in refs.items():
                    np.testing.assert_array_equal(
                        g.numpy(), np.asarray(ref).view(np.int32),
                        err_msg=f"{h} {name} {mode} {binz}")


@pytest.mark.parametrize("f", [7, 64, 100])
def test_kernel_order_matches_reference(f):
    """The grid reference runs at F = 64 (counts s3, sign words s2): in
    interpret mode a grid call takes seconds."""
    ta, ja = _pair(f)
    _check(ta, ja, f, f, lambda mode, binz: f == 64 and (
        (mode, binz) in (("s3_two_popc", False), ("s2_and_andnot", True))))


def test_kernel_order_on_padded_bucket():
    """pad_frdc groups past grp_ptr[-1] and padded tile-rows: the kernel
    order still equals the reference, and the padded rows are 0 / +1."""
    ta, ja = _pair(5, pad=True)
    _check(ta, ja, 7, 5, lambda mode, binz: False)
    xt = torch.zeros((N, 1), dtype=torch.int32)
    got = kernel_order(ta, xt, 7, True, "s3_two_popc", tk.GROUPS_PER_ITEM)
    assert bool((got[N + 3:] == 127).all())


def test_bits_wrappers_refuse_cpu_and_size_scratch():
    """The bits wrappers launch only on CUDA tensors (a CPU tensor raises,
    never reaching the plain version), and their scratch holds two (4,
    width) slots a chunk then one ticket per tile-row and word block."""
    ta, _ = _pair(7)
    x = torch.zeros((N, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tk.bspmm_bits_cuda(ta, x, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tk.bspmm_bits_grid_cuda(ta, x, 64, plan=tk.BlockPlan(32, 32))
    work, tickets = tk._work(ta, 64, 2, torch.int32, "cpu")
    part = -(-ta.n_groups // tk.GROUPS_PER_ITEM) * 2 * 4 * 64
    assert work.numel() == part + 2 * ta.n_tile_rows
    assert tickets == work.data_ptr() + 4 * part
