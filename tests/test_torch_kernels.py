"""The kernels' plain PyTorch versions held against the reference Pallas
kernels in interpret mode (as tests/test_kernels.py runs them) and the
dense oracles.

Integer and packed results are bit-exact; bspmm_fp agrees within rtol 1e-5
(atol 1e-5), the fp32 summation-order slack of tests/test_kernels.py.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitops as jb, frdc as jf  # noqa: E402
from repro.kernels import bmm_kernel, bspmm_kernel, pack_kernel  # noqa: E402
tf = lazy("repro_torch.core.frdc")
tbk = lazy("repro_torch.kernels.bmm_kernel")
tsk = lazy("repro_torch.kernels.bspmm_kernel")
tpk = lazy("repro_torch.kernels.pack_kernel")
ref = lazy("repro_torch.kernels.ref")

jax.config.update("jax_platform_name", "cpu")


def _t(u32) -> "torch.Tensor":
    return torch.from_numpy(np.array(u32, np.uint32).view(np.int32))


def _u32(t) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _packed(rng, rows, nbits):
    return np.asarray(jb.pack_bits(rng.integers(0, 2, (rows, nbits))))


def _pair(a: np.ndarray, **kw):
    """The same dense adjacency as FRDC in both packages."""
    return jf.from_dense(a, **kw), tf.from_dense(a, device="cpu")


BMM_SHAPES = [(8, 32, 32), (3, 33, 65), (130, 40, 256), (1, 1, 7)]
PACK_SHAPES = [(8, 32), (3, 100), (1, 31), (65, 7)]
BITS_CASES = [(16, 32, 0.3), (33, 96, 0.25), (3, 7, 0.6), (40, 100, 0.1)]
FP_CASES = [(16, 32, 0.3), (41, 128, 0.15), (6, 7, 0.5)]


@pytest.mark.parametrize("binarize", [False, True])
def test_bmm_xnor_plain_matches_pallas(binarize):
    for m, n, k in BMM_SHAPES:
        rng = np.random.default_rng(m * 1000 + n * 10 + k)
        a, b = _packed(rng, m, k), _packed(rng, n, k)
        want = np.asarray(bmm_kernel.bmm_xnor(a, b, k, binarize=binarize,
                                              block_m=32, block_n=32))
        got = tbk.bmm_xnor_plain(_t(a), _t(b), k, binarize)
        np.testing.assert_array_equal(
            _u32(got) if binarize else got.numpy(), want, err_msg=str((m, n, k)))
        oracle = (ref.bmm_xnor_bin_ref if binarize else ref.bmm_xnor_ref)(
            _t(a), _t(b), k)
        assert torch.equal(got, oracle), (m, n, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binarize_pack_plain_matches_pallas(dtype):
    for m, f in PACK_SHAPES:
        rng = np.random.default_rng(m * f)
        x = rng.standard_normal((m, f)).astype(np.float32)
        x[0, 0] = 0.0
        want = np.asarray(pack_kernel.binarize_pack(
            jnp.asarray(x, getattr(jnp, dtype)), block_m=32, block_f=64))
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        got = tpk.binarize_pack_plain(xt)
        np.testing.assert_array_equal(_u32(got), want, err_msg=str((m, f)))
        assert torch.equal(got, ref.binarize_pack_ref(xt)), (m, f)


def _graph(rng, n, density):
    return (rng.random((n, n)) < density).astype(np.float32)


@pytest.mark.parametrize("mode", ["s2_and_andnot", "s3_two_popc"])
def test_bspmm_bits_plain_matches_pallas(mode):
    for n, f, density in BITS_CASES:
        rng = np.random.default_rng(n * f)
        ja, ta = _pair(_graph(rng, n, density))
        xp = _packed(rng, n, f)
        for binarize in (False, True):
            case = str((n, f, density, binarize))
            want = np.asarray(bspmm_kernel.bspmm_bits(
                ja, xp, f, binarize=binarize, trinary_mode=mode))
            got = tsk.bspmm_bits_plain(ta, _t(xp), f, binarize, mode)
            np.testing.assert_array_equal(
                _u32(got) if binarize else got.numpy(), want, err_msg=case)
            if binarize:
                assert torch.equal(got, ref.bspmm_bits_ref(ta, _t(xp), f)), case


def test_bspmm_fp_plain_matches_pallas():
    for n, f, density in FP_CASES:
        rng = np.random.default_rng(n + f)
        ja, ta = _pair(_graph(rng, n, density))
        x = rng.standard_normal((n, f)).astype(np.float32)
        want = np.asarray(bspmm_kernel.bspmm_fp(ja, jnp.asarray(x)))
        got = tsk.bspmm_fp_plain(ta, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=str((n, f)))
        np.testing.assert_allclose(
            got.numpy(), ref.bspmm_fp_ref(ta, torch.from_numpy(x)).numpy(),
            rtol=1e-5, atol=1e-5, err_msg=str((n, f)))


def test_bspmm_empty_rows_prefill():
    """Rows with no edges (tests/test_kernels.py:91): 0 counts, and sign(0) =
    +1 bits with the tail masked when binarized."""
    n = 16
    a = np.zeros((n, n), np.float32)
    a[0, 3] = 1.0
    ja, ta = _pair(a)
    rng = np.random.default_rng(0)
    for f in (32, 20):
        xp = _packed(rng, n, f)
        counts = tsk.bspmm_bits_plain(ta, _t(xp), f, binarize=False)
        np.testing.assert_array_equal(counts[4:].numpy(), 0)
        np.testing.assert_array_equal(
            counts.numpy(),
            np.asarray(bspmm_kernel.bspmm_bits(ja, xp, f, binarize=False)))
        bits = tsk.bspmm_bits_plain(ta, _t(xp), f, binarize=True)
        np.testing.assert_array_equal(_u32(bits[4:]), (1 << f) - 1 if f < 32
                                      else 0xFFFFFFFF)
        np.testing.assert_array_equal(
            _u32(bits), np.asarray(bspmm_kernel.bspmm_bits(ja, xp, f)))


def test_bspmm_bucket_padded_frdc():
    """pad_frdc bucket groups (tests/test_kernels.py:179) contribute nothing:
    padded and unpadded results agree with the reference kernels."""
    m_j = jf.pad_frdc(jf.from_coo([0], [0], 1, 1), 64, n_groups=16)
    m_t = tf.pad_frdc(tf.from_coo([0], [0], 1, 1, device="cpu"), 64,
                      n_groups=16)
    ones = np.ones((64, 5), np.float32)
    np.testing.assert_array_equal(
        tsk.bspmm_fp_plain(m_t, torch.from_numpy(ones))[:1].numpy(),
        [[1.0] * 5])
    rng = np.random.default_rng(3)
    ja, ta = _pair((rng.random((30, 30)) < 0.2).astype(np.float32))
    pj = jf.pad_frdc(ja, 64, n_groups=ja.n_groups + 7)
    pt = tf.pad_frdc(ta, 64, n_groups=ta.n_groups + 7)
    xf = np.zeros((64, 32), np.float32)
    xf[:30] = rng.standard_normal((30, 32))
    np.testing.assert_allclose(
        tsk.bspmm_fp_plain(pt, torch.from_numpy(xf)).numpy(),
        np.asarray(bspmm_kernel.bspmm_fp(pj, jnp.asarray(xf))),
        rtol=1e-5, atol=1e-5)
    xp = np.zeros((64, 1), np.uint32)
    xp[:30] = _packed(rng, 30, 32)
    for binarize in (False, True):
        got = tsk.bspmm_bits_plain(pt, _t(xp), 32, binarize)
        want = np.asarray(bspmm_kernel.bspmm_bits(pj, xp, 32,
                                                  binarize=binarize))
        np.testing.assert_array_equal(_u32(got) if binarize else got.numpy(),
                                      want)
        unpadded = tsk.bspmm_bits_plain(ta, _t(xp[:30]), 32, binarize)
        np.testing.assert_array_equal(got[:30].numpy(), unpadded[:30].numpy())
