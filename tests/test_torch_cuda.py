"""Card-only tests: each CUDA kernel of repro_torch against its plain
PyTorch version on the same inputs, on the same device.

They need a CUDA device and nvcc (the kernels build on first use) and skip
elsewhere. This file imports neither JAX nor the reference package, so it
runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Integer and packed results must be bit-exact; bspmm_fp within 1e-5 of the
sum of |terms| behind each output, plus 1e-6 (fp32 summation order), and
bit-equal between two runs.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

bitops = lazy("repro_torch.core.bitops")
frdc = lazy("repro_torch.core.frdc")
bmm_kernel = lazy("repro_torch.kernels.bmm_kernel")
bspmm_kernel = lazy("repro_torch.kernels.bspmm_kernel")
ops = lazy("repro_torch.kernels.ops")
pack_kernel = lazy("repro_torch.kernels.pack_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, rows, nbits, device):
    return bitops.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (rows, nbits)))).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("m,f", [(3, 7), (100, 500), (33, 64), (1, 33)])
def test_binarize_pack_matches_plain(cuda, m, f):
    x = torch.randn((m, f), generator=torch.Generator().manual_seed(m)).to(cuda)
    x[0, 0] = 0.0
    for xt in (x, x.bfloat16()):
        assert torch.equal(pack_kernel.binarize_pack_cuda(xt),
                           pack_kernel.binarize_pack_plain(xt))
    # dispatch: a CUDA tensor launches the kernel, a CPU one does not
    ops.reset_launch_counts()
    ops.binarize_pack(x)
    ops.binarize_pack(x.cpu())
    assert ops.launch_counts()["binarize_pack"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(1, 1, 7), (130, 40, 256), (500, 64, 500),
                                   (70, 7, 64)])
def test_bmm_xnor_matches_plain(cuda, m, n, k):
    rng = np.random.default_rng(k)
    a, b = _words(rng, m, k, cuda), _words(rng, n, k, cuda)
    for binarize in (False, True):
        assert torch.equal(bmm_kernel.bmm_xnor_cuda(a, b, k, binarize),
                           bmm_kernel.bmm_xnor_plain(a, b, k, binarize))


def _adj(rng, n, density, pad, device, hub=False):
    a = (rng.random((n, n)) < density).astype(np.float32)
    a[n // 2:] = 0                     # empty tile-rows
    if hub:
        a[1, :] = 1.0                  # one tile-row with many groups
    adj = frdc.from_dense(a, device=device)
    if pad:
        adj = frdc.pad_frdc(adj, n + 24, n_groups=adj.n_groups + 5)
    return adj


CASES = [(3, 7, 0.6, False, False), (40, 100, 0.1, True, False),
         (300, 64, 0.05, False, False), (2000, 64, 0.002, True, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,density,pad,hub", CASES)
def test_bspmm_matches_plain(cuda, n, f, density, pad, hub):
    rng = np.random.default_rng(n)
    adj = _adj(rng, n, density, pad, cuda, hub)
    xp = _words(rng, adj.n_cols, f, cuda)
    for binarize in (False, True):
        for mode in ("s2_and_andnot", "s3_two_popc"):
            assert torch.equal(
                bspmm_kernel.bspmm_bits_cuda(adj, xp, f, binarize, mode),
                bspmm_kernel.bspmm_bits_plain(adj, xp, f, binarize, mode))
    x = torch.from_numpy(rng.standard_normal((adj.n_cols, f)).astype(
        np.float32)).to(cuda)
    got = bspmm_kernel.bspmm_fp_cuda(adj, x)
    # another summation order moves an fp32 sum by a few ulps of the
    # magnitudes summed (|A| @ |x|), not of the result
    magnitude = bspmm_kernel.bspmm_fp_plain(adj, x.abs())
    err = (got - bspmm_kernel.bspmm_fp_plain(adj, x)).abs()
    assert bool((err <= 1e-5 * magnitude + 1e-6).all()), float(err.max())
    assert torch.equal(got, bspmm_kernel.bspmm_fp_cuda(adj, x)), "not deterministic"
