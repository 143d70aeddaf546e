"""Card-only tests of the serving slice: the 2D block-grid BSpMM kernels
and the fused per-layer kernel against their plain PyTorch versions on the
same device, bit-equal repeat runs, and a fused serve batch with one launch
per layer.

They need a CUDA device and nvcc (the kernels build on first use) and skip
elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_serve.py

Integer and packed results must be bit-exact. The fused layers get inputs
whose transform is exact in any summation order (integer features, BN by
integers, power-of-two weight scales), so their packed outputs are
bit-exact too; fp outputs may differ by the aggregation's summation order,
within 1e-5 of the sum of |terms| behind each output, plus 1e-6.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

bitops = lazy("repro_torch.core.bitops")
frdc = lazy("repro_torch.core.frdc")
binarize = lazy("repro_torch.core.binarize")
bspmm_kernel = lazy("repro_torch.kernels.bspmm_kernel")
fused_layer = lazy("repro_torch.kernels.fused_layer")
ops = lazy("repro_torch.kernels.ops")
gnn = lazy("repro_torch.models.gnn")
datasets = lazy("repro_torch.graphs.datasets")
serve = lazy("repro_torch.serve")

FP_TOL, FP_TOL_ABS = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, rows, nbits, device):
    return bitops.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (rows, nbits)))).to(device)


def _adj(rng, n, density, pad, device, hub=False, scaled=False):
    a = (rng.random((n, n)) < density).astype(np.float32)
    a[n // 2:] = 0                     # empty tile-rows
    if hub:
        a[1, :] = 1.0                  # one tile-row with many groups
    kw = {}
    if scaled:
        s = rng.random(n) + 0.5
        kw = dict(row_scale=s, col_scale=s)
    adj = frdc.from_dense(a, device=device, **kw)
    if pad:
        adj = frdc.pad_frdc(adj, n + 24, n_groups=adj.n_groups + 5)
    return adj


# (n, f, density, pad, hub, block): N < 4, tail bits, empty tile-rows,
# pad_frdc groups, a hub row split over the block's warps, feats < width
GRID_CASES = [(3, 7, 0.6, False, False, (4, None)),
              (40, 100, 0.1, True, False, (8, 32)),
              (300, 64, 0.05, False, False, (32, 32)),
              (2000, 64, 0.002, True, True, (12, 64)),
              (2000, 40, 0.002, False, True, (32, None))]


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,density,pad,hub,block", GRID_CASES)
def test_grid_kernels_match_plain(cuda, n, f, density, pad, hub, block):
    rng = np.random.default_rng(n + f)
    adj = _adj(rng, n, density, pad, cuda, hub)
    xp = _words(rng, adj.n_cols, f, cuda)
    bits_block = (block[0], None) if (block[1] or 32) % 32 else block
    plan = bspmm_kernel._block_plan(bits_block, f, True)
    for binz in (False, True):
        for mode in ("s2_and_andnot", "s3_two_popc"):
            got = bspmm_kernel.bspmm_bits_grid_cuda(adj, xp, f, binz, mode,
                                                    plan)
            want = bspmm_kernel.bspmm_bits_grid_plain(adj, xp, f, binz, mode,
                                                      plan)
            assert torch.equal(got, want), (binz, mode)
            assert torch.equal(got, bspmm_kernel.bspmm_bits_grid_cuda(
                adj, xp, f, binz, mode, plan)), "not deterministic"
    x = torch.from_numpy(rng.standard_normal((adj.n_cols, f)).astype(
        np.float32)).to(cuda)
    plan = bspmm_kernel._block_plan(block, f, False)
    got = bspmm_kernel.bspmm_fp_grid_cuda(adj, x, plan)
    magnitude = bspmm_kernel.bspmm_fp_grid_plain(adj, x.abs(), plan)
    err = (got - bspmm_kernel.bspmm_fp_grid_plain(adj, x, plan)).abs()
    assert bool((err <= FP_TOL * magnitude + FP_TOL_ABS).all()), \
        float(err.max())
    assert torch.equal(got, bspmm_kernel.bspmm_fp_grid_cuda(adj, x, plan)), \
        "not deterministic"


def _layer_inputs(rng, n, f, h, device, scaled):
    """Integer features, BN by integers, +-1 weights with power-of-two
    scales: every transform sum is exact."""
    adj = _adj(rng, n, 0.01, True, "cpu", hub=True, scaled=scaled)
    x = torch.from_numpy(rng.integers(-3, 4, (adj.n_cols, f)).astype(
        np.float32))
    mu = torch.from_numpy(rng.integers(-1, 2, (1, f)).astype(np.float32))
    sd = torch.from_numpy(rng.choice([1.0, 2.0], (1, f)).astype(np.float32))

    def weights(n_out, n_in):
        return binarize.BinTensor(
            packed=_words(rng, n_out, n_in, "cpu"),
            scale=torch.from_numpy(rng.choice([0.25, 0.5, 1.0], (n_out, 1))
                                   .astype(np.float32)), n=n_in)
    w1, w2 = weights(h, f), weights(h, f)
    cpu = (x, (mu, sd), w1, w2, adj)
    card = (x.to(device), (mu.to(device), sd.to(device)),
            *(binarize.BinTensor(w.packed.to(device), w.scale.to(device), w.n)
              for w in (w1, w2)), adj.to(device))
    return cpu, card


KINDS = ["gcn_bin_l1", "gcn_bbf_fbf", "branch_add", "fc"]


def _run_kind(kind, x, bn, w1, w2, adj):
    if kind == "gcn_bin_l1":
        return fused_layer.gcn_bin_l1(x, bn, w1, adj)
    if kind == "gcn_bbf_fbf":
        return fused_layer.gcn_bbf_fbf(x, bn, w1, adj, relu=True)
    if kind == "branch_add":
        return fused_layer.branch_add(x, bn, w1, w2, adj, relu=True)
    return fused_layer.fc(x, bn, w1)


def _magnitude(kind, x, bn, w1, w2, adj):
    """Sum of |terms| behind each fp output of a fused layer."""
    words, xs = fused_layer._input(x, bn)
    if kind == "fc":
        return torch.zeros(())
    # branch_add(x, bn, w1, w2, adj) aggregates with w2, w1 is its self branch
    w_agg = w2 if kind == "branch_add" else w1
    mag = fused_layer.agg_fp(adj, fused_layer._bbf(words, xs, w_agg).abs())
    if kind == "branch_add":
        mag = mag + fused_layer._bbf(words, xs, w1).abs()
    return mag


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_fused_layer_matches_plain(cuda, kind):
    rng = np.random.default_rng(len(kind))
    cpu, card = _layer_inputs(rng, 1500, 100, 40, cuda, kind != "gcn_bin_l1")
    fused_layer.reset_counters()
    ops.reset_launch_counts()
    got = _run_kind(kind, *card)
    again = _run_kind(kind, *card)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_layer"] == 2
    assert fused_layer.KERNEL_CALLS["fused"] == 2
    assert torch.equal(got, again), "not deterministic"
    want = _run_kind(kind, *cpu)            # plain version, on the CPU
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "gcn_bin_l1":
        assert torch.equal(got.cpu(), want)
        return
    err = (got.cpu() - want).abs()
    mag = _magnitude(kind, *cpu)
    assert bool((err <= FP_TOL * mag + FP_TOL_ABS).all()), float(err.max())


@pytest.mark.gpu
def test_fused_serve_batch_one_launch_per_layer(cuda):
    data = datasets.make_dataset("cora", seed=0, scale=0.25)
    params = gnn.init_gcn(0, data.x.shape[1], 64, data.n_classes, "cpu")
    seeds = np.random.default_rng(0).integers(0, data.n_nodes, size=16)
    outs = {}
    for device in ("cuda", "cpu"):
        st = serve.GraphStore(max_batch=16, use_pallas=True, fused=True,
                              device=device)
        st.register_graph("g", data)
        st.register_model("gcn", "gcn", params)
        sess = st.session("g", "gcn")
        if device == "cpu":       # the card's frozen BN on the CPU
            sess.bn = tuple((m.cpu(), s.cpu()) for m, s in outs["bn"])
        sess.warmup()
        before = sess.compile_count
        ops.reset_launch_counts()
        outs[device] = sess.serve_subgraph(seeds)
        if device == "cuda":
            counts = ops.launch_counts()
            assert counts.pop("fused_layer") == 2, counts
            assert not any(counts.values()), counts
            outs["bn"] = sess.bn
        assert sess.compile_count == before
    got, want = outs["cuda"], outs["cpu"]
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).all(axis=1).mean() \
        >= 0.999
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.999
