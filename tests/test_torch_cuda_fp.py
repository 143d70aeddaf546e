"""Card-only tests of the edge-driven fp FRDC walk (``csrc/walk.cuh``): the
1D and 2D-grid fp kernels and the fused layers that aggregate through it,
against their plain PyTorch versions on the same device, in every lane
layout the wrappers pick.

They need a CUDA device and nvcc (the kernels build on first use) and skip
elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_fp.py

Cases: widths F in {1, 7, 8, 16, 17, 33, 64, 100} (sub-warps, whole-warp
scalar and vector loads); tile-rows of 17, 33 and 300 groups (chunk items
of the 1D and grid kernels); an x whose base is one row or one element
past an allocation's start; a row count that is not a multiple of 4;
feature blocks narrower than F; a ``pad_frdc``-padded matrix. Each output
is held within 1e-5 of the sum of |terms| behind it, plus 1e-6 (fp32
summation order), and two runs must be bit-equal.
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

FP_TOL, FP_TOL_ABS = 1e-5, 1e-6
N = 10003                       # rows and columns: not a multiple of 4
HUB_GROUPS = (17, 33, 300)      # groups of the hub tile-rows 1, 3 and 5
WIDTHS = (1, 7, 8, 16, 17, 33, 64, 100)


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


def _x(rng, f, offset, device):
    """(N, f) float32 whose base lies ``offset`` floats past its buffer's."""
    buf = torch.from_numpy(rng.standard_normal(N * f + offset)
                           .astype(np.float32)).to(device)
    return buf[offset:].view(N, f)


def _hold(got, want, mag):
    err = (got - want).abs()
    assert bool((err <= FP_TOL * mag + FP_TOL_ABS).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("f", WIDTHS)
def test_fp_kernels_match_plain(cuda, f):
    rng = np.random.default_rng(f)
    adj = _graph(f, cuda)
    padded = frdc.pad_frdc(adj, N + 21, n_groups=adj.n_groups + 9)
    plans = [bspmm_kernel._block_plan(b, f, False)
             for b in ((32, None), (8, 24), (16, 8), (4, 64))]
    for offset in (0, 1, f):          # aligned, one element, one row past
        x = _x(rng, f, offset, cuda)
        lay = bspmm_kernel.fp_layout(f, f, x.data_ptr())
        assert lay.vec == (lay.cols > 1 and f % lay.cols == 0
                           and offset % lay.cols == 0)
        for a in (adj, padded):      # padded: rows of x end before n_cols
            xa = x
            want = bspmm_kernel.bspmm_fp_plain(a, xa)
            mag = bspmm_kernel.bspmm_fp_plain(a, xa.abs())
            got = bspmm_kernel.bspmm_fp_cuda(a, xa)
            assert torch.equal(got, bspmm_kernel.bspmm_fp_cuda(a, xa)), \
                "1D not deterministic"
            _hold(got, want, mag)
            for plan in plans:
                got = bspmm_kernel.bspmm_fp_grid_cuda(a, xa, plan)
                assert torch.equal(
                    got, bspmm_kernel.bspmm_fp_grid_cuda(a, xa, plan)), \
                    f"grid {plan} not deterministic"
                _hold(got, want, mag)
    torch.cuda.synchronize()


def _weights(rng, n_out, n_in, device):
    return binarize.BinTensor(
        bitops.pack_bits(torch.from_numpy(rng.integers(0, 2, (n_out, n_in))))
        .to(device),
        torch.from_numpy(rng.choice([0.25, 0.5, 1.0], (n_out, 1))
                         .astype(np.float32)).to(device), n_in)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gcn_bbf_fbf", "branch_add"])
def test_fused_fp_aggregation_matches_plain(cuda, kind):
    """The fused kinds that aggregate fp rows, at output widths 7 and 64
    (sub-warp and vector layouts), on the hub graph."""
    rng = np.random.default_rng(len(kind))
    adj = _graph(len(kind), cuda)
    f_in = 100
    x = torch.from_numpy(rng.integers(-3, 4, (N, f_in)).astype(np.float32)) \
        .to(cuda)
    bn = (torch.from_numpy(rng.integers(-1, 2, (1, f_in)).astype(np.float32))
          .to(cuda),
          torch.from_numpy(rng.choice([1.0, 2.0], (1, f_in)).astype(np.float32))
          .to(cuda))
    for h in (7, 64):
        w1, w2 = _weights(rng, h, f_in, cuda), _weights(rng, h, f_in, cuda)
        if kind == "gcn_bbf_fbf":
            def run(plain=False):
                fn = fused_layer.gcn_bbf_fbf_plain if plain \
                    else fused_layer.gcn_bbf_fbf
                return fn(x, bn, w1, adj, relu=True)
        else:
            def run(plain=False):
                fn = fused_layer.branch_add_plain if plain \
                    else fused_layer.branch_add
                return fn(x, bn, w1, w2, adj, relu=True)
        ops.reset_launch_counts()
        got, again = run(), run()
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_layer"] == 2
        assert torch.equal(got, again), "not deterministic"
        # sum of |terms|: the aggregated branch (w2 in branch_add, whose
        # self branch is w1) and the self branch
        words, xs = fused_layer._input(x, bn)
        w_agg = w2 if kind == "branch_add" else w1
        mag = fused_layer.agg_fp(adj, fused_layer._bbf(words, xs, w_agg).abs())
        if kind == "branch_add":
            mag = mag + fused_layer._bbf(words, xs, w1).abs()
        _hold(got, run(plain=True), mag)


@pytest.mark.gpu
def test_fp_kernel_attributes(cuda):
    """Every layout of both fp kernels builds, fits the SM and keeps the
    walk's hit lists in static shared memory."""
    for sub, cols, vec in [(1, 1, 0), (2, 1, 0), (4, 1, 0), (8, 1, 0),
                           (16, 1, 0), (32, 1, 0), (32, 2, 0), (32, 2, 1),
                           (32, 4, 0), (32, 4, 1)]:
        for lib, fn in (("bspmm", "bspmm_fp"), ("bspmm_grid", "bspmm_fp_grid")):
            a = build.attributes(lib, fn, sub, cols, vec)
            assert 0 < a["registers"] <= 255, a
            assert a["static_smem_bytes"] >= 8 * 128 * 8, a
            assert a["blocks_per_sm"] >= 1, a
    a = fused_layer.attributes(7)
    assert 0 < a["registers"] <= 255 and a["blocks_per_sm"] >= 1, a


@pytest.mark.gpu
def test_fp_dispatch_launches_kernels(cuda):
    """ops.bspmm_fp on a CUDA tensor launches the 1D kernel, or the grid
    with a block shape, and a CPU tensor launches nothing."""
    rng = np.random.default_rng(0)
    adj = _graph(0, cuda)
    x = _x(rng, 7, 0, cuda)
    ops.reset_launch_counts()
    ops.bspmm_fp(adj, x)
    ops.bspmm_fp(adj, x, block_shape=(32, 32))
    ops.bspmm_fp(adj.to("cpu"), x.cpu())
    counts = ops.launch_counts()
    assert counts["bspmm_fp"] == 1 and counts["bspmm_fp_grid"] == 1, counts
