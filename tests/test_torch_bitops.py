"""repro_torch.core.bitops held bit-exact against repro.core.bitops."""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitops as jb  # noqa: E402
tb = lazy("repro_torch.core.bitops")

jax.config.update("jax_platform_name", "cpu")


def _t(words_u32) -> "torch.Tensor":
    """numpy/JAX uint32 words -> the port's int32 bit-view."""
    return torch.from_numpy(np.array(words_u32, np.uint32).view(np.int32))


def _u32(t) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, *shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("shape,axis", [((3, 1), -1), ((3, 31), -1),
                                        ((2, 70), -1), ((70, 5), 0),
                                        ((2, 3, 65), 1)])
def test_pack_unpack_sign_match_reference(shape, axis):
    rng = np.random.default_rng(sum(shape))
    bits = rng.integers(0, 2, size=shape)
    want = np.asarray(jb.pack_bits(bits, axis=axis))
    got = tb.pack_bits(torch.from_numpy(bits), axis=axis)
    np.testing.assert_array_equal(_u32(got), want)
    n = shape[axis]
    np.testing.assert_array_equal(
        tb.unpack_bits(got, n, axis=axis).numpy(),
        np.asarray(jb.unpack_bits(want, n, axis=axis)))
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[0] = 0.0          # sign(0) = +1 in both
    x.flat[-1] = -0.0
    np.testing.assert_array_equal(
        _u32(tb.sign_bits(torch.from_numpy(x), axis=axis)),
        np.asarray(jb.sign_bits(jnp.asarray(x), axis=axis)))
    np.testing.assert_array_equal(
        tb.unpack_pm1(got, n, axis=axis).numpy(),
        np.asarray(jb.unpack_pm1(want, n, axis=axis)))


@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 200])
def test_word_dots_match_reference(n_bits):
    rng = np.random.default_rng(n_bits)
    a = np.asarray(jb.pack_bits(rng.integers(0, 2, (4, n_bits))))
    b = np.asarray(jb.pack_bits(rng.integers(0, 2, (4, n_bits))))
    ta, tb_ = _t(a), _t(b)
    for got, want in [
            (tb.xnor_dot(ta, tb_, n_bits), jb.xnor_dot(a, b, n_bits)),
            (tb.trinary_dot_s2(ta, tb_), jb.trinary_dot_s2(a, b)),
            (tb.trinary_dot_s3(ta, tb_), jb.trinary_dot_s3(a, b)),
            (tb.bmm_xnor_words(ta, tb_, n_bits),
             jb.bmm_xnor_words(a, b, n_bits))]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_width_words_and_popcount():
    """All-ones / high-bit words exercise the int32 bit-view sign handling."""
    rng = np.random.default_rng(1)
    w = _words(rng, 6, 32)
    w[0] = 0xFFFFFFFF
    w[1] = 0x80000000
    np.testing.assert_array_equal(
        tb.popcount(tb.as_u32(_t(w))).numpy(),
        np.asarray(jb.popcount(jnp.asarray(w))))
    np.testing.assert_array_equal(_u32(tb.bit_transpose_32(_t(w))),
                                  np.asarray(jb.bit_transpose_32(w)))



@pytest.mark.parametrize("n", [1, 33, 100])
def test_and_dot(n):
    """``tests/test_bitops.py::test_and_dot``: popc(a AND b) == a @ b,
    equal to the reference's."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2, size=(3, n))
    b = rng.integers(0, 2, size=(3, n))
    got = tb.and_dot(tb.pack_bits(torch.from_numpy(a)),
                     tb.pack_bits(torch.from_numpy(b)))
    np.testing.assert_array_equal(got.numpy(), (a * b).sum(-1))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jb.and_dot(jb.pack_bits(a), jb.pack_bits(b))))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("n,seed", [(1, 0), (31, 1), (32, 2), (33, 3),
                                    (200, 4)])
def test_trinary_dot_all_modes_agree(n, seed):
    """``tests/test_bitops.py::test_trinary_dot_all_modes_agree``, the s1
    line included: every mode gives a @ b for 0/1 a and ±1 b, and each
    equals the reference's."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, size=n)
    b = rng.choice([-1, 1], size=n)
    expected = int(np.dot(a, b))
    ap, bp = tb.pack_bits(torch.from_numpy(a)), tb.pack_bits(
        torch.from_numpy(b > 0))
    s1 = tb.trinary_dot_s1(torch.from_numpy(a), torch.from_numpy(b))
    assert int(s1) == expected == int(jb.trinary_dot_s1(jnp.asarray(a),
                                                        jnp.asarray(b)))
    assert s1.dtype == torch.int32
    for mode in tb.TRINARY_MODES[1:]:
        assert int(tb.trinary_dot(ap, bp, mode)) == expected
    xf = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        tb.trinary_dot_s1(torch.from_numpy(a), torch.from_numpy(xf)).numpy(),
        np.asarray(jb.trinary_dot_s1(jnp.asarray(a), jnp.asarray(xf))),
        rtol=1e-6, atol=1e-6)


def test_trinary_dot_refuses_s1_and_unknown():
    """The packed dispatcher takes s2 / s3 only, as the reference's."""
    assert tb.TRINARY_MODES == jb.TRINARY_MODES
    a = _t(np.ones((2, 1), np.uint32))
    for mode in ("s1_select", "s4"):
        with pytest.raises(ValueError, match="s2/s3"):
            tb.trinary_dot(a, a, mode)
        with pytest.raises(ValueError, match="s2/s3"):
            jb.trinary_dot(np.asarray(a.numpy().view(np.uint32)),
                           np.asarray(a.numpy().view(np.uint32)), mode)


@pytest.mark.parametrize("mode", ["s2_and_andnot", "s3_two_popc"])
def test_spmm_trinary_words_matches_reference(mode):
    """(M, W) adjacency words x (F, W) transposed activation words, bit
    for bit, full-width words in."""
    rng = np.random.default_rng(7)
    adj, act = _words(rng, 5, 3), _words(rng, 4, 3)
    adj[0, 0] = act[1, 2] = 0xFFFFFFFF
    got = tb.spmm_trinary_words(_t(adj), _t(act), mode)
    want = np.asarray(jb.spmm_trinary_words(adj, act, mode))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (5, 4) and got.dtype == torch.int32
