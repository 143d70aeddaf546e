"""Card-only tests of the bits FRDC walk (``csrc/walk.cuh``: the register
bit transpose, passes of up to 4 words, the chunk split of hub tile-rows):
the 1D and 2D-grid bits kernels and the fused ``gcn_bin_l1`` that
aggregates through it, against their plain PyTorch versions on the same
device.

They need a CUDA device and nvcc (the kernels build on first use) and skip
elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_bits.py

Cases: widths F in {1, 7, 32, 64, 100, 160, 224} (1, 2 and 4-word passes,
a last pass of fewer words, a tail word); tile-rows of 17, 33 and 300
groups (chunk items of the 1D and grid kernels) and empty tile-rows; an x
one word or one row past an allocation's start (no vector loads); a row
count that is not a multiple of 4; word blocks narrower than the row; a
``pad_frdc``-padded matrix; s3 and s2, counts and sign words. Every output
is an integer or a sign of one, so it must be bit-exact, and two runs
bit-equal.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

binarize = lazy("repro_torch.core.binarize")
bitops = lazy("repro_torch.core.bitops")
frdc = lazy("repro_torch.core.frdc")
build = lazy("repro_torch.kernels.build")
bspmm_kernel = lazy("repro_torch.kernels.bspmm_kernel")
fused_layer = lazy("repro_torch.kernels.fused_layer")
ops = lazy("repro_torch.kernels.ops")

N = 10003                       # rows and columns: not a multiple of 4
HUB_GROUPS = (17, 33, 300)      # groups of the hub tile-rows 1, 3 and 5
WIDTHS = (1, 7, 32, 64, 100, 160, 224)
MODES = ("s3_two_popc", "s2_and_andnot")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _graph(seed, device):
    """Random edges (mean degree 5) on the first half of the rows, hub
    tile-rows of exactly HUB_GROUPS groups, and empty tile-rows below."""
    rng = np.random.default_rng(seed)
    hub_rows = {2 * i + 1 for i in range(len(HUB_GROUPS))}
    src = rng.integers(0, N // 2, 5 * N)
    keep = ~np.isin(src // 4, list(hub_rows))
    rows, cols = [src[keep]], [rng.integers(0, N, 5 * N)[keep]]
    for i, groups in enumerate(HUB_GROUPS):
        tc = np.arange(8 * groups)               # one tile per tile-column
        tr = 2 * i + 1
        rows.append(tr * 4 + tc % 4)
        cols.append(tc * 4 + (tc * 7) % 4)
        extra = rng.integers(0, len(tc), len(tc) // 3)   # more bits a tile
        rows.append(tr * 4 + (tc[extra] + 1) % 4)
        cols.append(tc[extra] * 4 + rng.integers(0, 4, extra.size))
    adj = frdc.from_coo(np.concatenate(rows), np.concatenate(cols), N, N,
                        device=device)
    per = (adj.grp_ptr[1:] - adj.grp_ptr[:-1]).cpu().numpy()
    assert [int(per[2 * i + 1]) for i in range(3)] == list(HUB_GROUPS)
    return adj


def _words(rng, f, offset, device):
    """(N, ceil(f / 32)) sign words whose base lies ``offset`` words past
    its buffer's (rows then start mid-row of the buffer: both versions count
    whatever bits a word holds)."""
    buf = bitops.pack_bits(torch.from_numpy(rng.integers(0, 2, (N + 1, f))))
    wf = buf.shape[1]
    return buf.reshape(-1)[offset:offset + N * wf].to(device).view(N, wf)


def _blocks(f):
    wf = bitops.padded_words(f)
    return [b for b in ((32, None), (8, 32), (16, 64), (4, 96), (64, f))
            if b[1] is None or b[1] <= wf * 32]


@pytest.mark.gpu
@pytest.mark.parametrize("f", WIDTHS)
def test_bits_kernels_match_plain(cuda, f):
    rng = np.random.default_rng(f)
    adj = _graph(f, cuda)
    padded = frdc.pad_frdc(adj, N + 21, n_groups=adj.n_groups + 9)
    wf = bitops.padded_words(f)
    plans = [bspmm_kernel._block_plan(b, f, True) for b in _blocks(f)]
    for offset in (0, 1, wf):           # aligned, one word, one row past
        x = _words(rng, f, offset, cuda)
        for a in (adj, padded):         # padded: rows of x end before n_cols
            for binz in (False, True):
                for mode in MODES:
                    want = bspmm_kernel.bspmm_bits_plain(a, x, f, binz, mode)
                    got = bspmm_kernel.bspmm_bits_cuda(a, x, f, binz, mode)
                    assert torch.equal(got, want), (offset, binz, mode)
                    assert torch.equal(got, bspmm_kernel.bspmm_bits_cuda(
                        a, x, f, binz, mode)), "1D not deterministic"
                    for plan in plans:
                        got = bspmm_kernel.bspmm_bits_grid_cuda(
                            a, x, f, binz, mode, plan)
                        assert torch.equal(got, want), (plan, offset, binz)
                        assert torch.equal(got, bspmm_kernel.bspmm_bits_grid_cuda(
                            a, x, f, binz, mode, plan)), f"grid {plan}"
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_bits_empty_and_padded_rows(cuda):
    """Tile-rows with no groups store 0 counts and all-ones sign words with
    the tail masked; pad_frdc's extra tile-rows are empty rows."""
    rng = np.random.default_rng(3)
    adj = _graph(3, cuda)
    adj = frdc.pad_frdc(adj, N + 21, n_groups=adj.n_groups + 9)
    x = _words(rng, 100, 0, cuda)
    empty = torch.nonzero(adj.grp_ptr[1:] == adj.grp_ptr[:-1]).reshape(-1)
    assert empty.numel() > 0
    rows = (empty[:, None] * 4 + torch.arange(4, device=cuda)).reshape(-1)
    plan = bspmm_kernel._block_plan((32, None), 100, True)
    for counts in (bspmm_kernel.bspmm_bits_cuda(adj, x, 100, False),
                   bspmm_kernel.bspmm_bits_grid_cuda(adj, x, 100, False,
                                                     plan=plan)):
        assert not bool(counts[rows].any())
    for words in (bspmm_kernel.bspmm_bits_cuda(adj, x, 100, True),
                  bspmm_kernel.bspmm_bits_grid_cuda(adj, x, 100, True,
                                                    plan=plan)):
        assert bool((words[rows, :3] == -1).all())
        assert bool((words[rows, 3] == (1 << 4) - 1).all())


@pytest.mark.gpu
def test_bits_counts_match_sparse_mm(cuda):
    """The library yardstick of chip_smoke.py computes the same counts:
    torch.sparse.mm of the 0/1 CSR with the +-1 features as float32 (a
    dense 0.2 pattern: every tile-row is cut into chunk items)."""
    rng = np.random.default_rng(5)
    n = 1403
    a = (rng.random((n, n)) < 0.2).astype(np.float32)
    adj = frdc.from_dense(a, device=cuda)
    buf = bitops.pack_bits(torch.from_numpy(rng.integers(0, 2, (n, 64))))
    x = buf.to(cuda)
    csr = torch.from_numpy(a).to_sparse_csr().to(cuda)
    want = torch.sparse.mm(csr, bitops.unpack_pm1(x, 64).to(torch.float32))
    got = bspmm_kernel.bspmm_bits_cuda(adj, x, 64, False)[:n]
    assert torch.equal(got.to(torch.float32), want)


def _weights(rng, n_out, n_in, device):
    return binarize.BinTensor(
        bitops.pack_bits(torch.from_numpy(rng.integers(0, 2, (n_out, n_in))))
        .to(device),
        torch.from_numpy(rng.choice([0.25, 0.5, 1.0], (n_out, 1))
                         .astype(np.float32)).to(device), n_in)


@pytest.mark.gpu
def test_fused_gcn_bin_l1_matches_plain(cuda):
    """The fused GCN "bin" layer 1, whose counts aggregation is the bits
    walk, at output widths of 1, 2 and 4 words (7, 64, 100), on the hub
    graph: integer inputs make the transform exact, so the sign words are
    bit-exact."""
    rng = np.random.default_rng(15)
    adj = _graph(15, cuda)
    f_in = 100
    x = torch.from_numpy(rng.integers(-3, 4, (N, f_in)).astype(np.float32)) \
        .to(cuda)
    bn = (torch.from_numpy(rng.integers(-1, 2, (1, f_in)).astype(np.float32))
          .to(cuda),
          torch.from_numpy(rng.choice([1.0, 2.0], (1, f_in)).astype(np.float32))
          .to(cuda))
    for h in (7, 64, 100):
        w = _weights(rng, h, f_in, cuda)
        for mode in MODES:
            ops.reset_launch_counts()
            got = fused_layer.gcn_bin_l1(x, bn, w, adj, mode)
            again = fused_layer.gcn_bin_l1(x, bn, w, adj, mode)
            torch.cuda.synchronize()
            assert ops.launch_counts()["fused_layer"] == 2
            assert torch.equal(got, again), "not deterministic"
            assert torch.equal(got, fused_layer.gcn_bin_l1_plain(
                x, bn, w, adj, mode)), (h, mode)


@pytest.mark.gpu
def test_bits_kernel_attributes(cuda):
    """Every pass width and formula of both bits kernels builds and fits
    the SM without shared memory."""
    for words in (1, 2, 4):
        for s2 in (0, 1):
            for lib, fn in (("bspmm", "bspmm_bits"),
                            ("bspmm_grid", "bspmm_bits_grid")):
                a = build.attributes(lib, fn, words, s2)
                assert 0 < a["registers"] <= 255, a
                assert a["static_smem_bytes"] == 0, a
                assert a["blocks_per_sm"] >= 2, a


@pytest.mark.gpu
def test_bits_dispatch_launches_kernels(cuda):
    """ops.bspmm_bits on a CUDA tensor launches the 1D kernel, or the grid
    with a block shape, and a CPU tensor launches nothing."""
    rng = np.random.default_rng(0)
    adj = _graph(0, cuda)
    x = _words(rng, 64, 0, cuda)
    ops.reset_launch_counts()
    ops.bspmm_bits(adj, x, 64)
    ops.bspmm_bits(adj, x, 64, block_shape=(32, 32))
    ops.bspmm_bits(adj.to("cpu"), x.cpu(), 64)
    counts = ops.launch_counts()
    assert counts["bspmm_bits"] == 1 and counts["bspmm_bits_grid"] == 1, counts
