"""repro_torch's core modules that route through the kernels (BMM and
BSpMM variants, the abstraction registry) against the reference.

fp outputs agree within 1e-5. Packed outputs are bit-exact, except where a
sign is taken of a scaled fp sum: there a bit may differ only where the
reference's pre-sign value v has |v| < 1e-5 * max|v|.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import abstraction as jabs, bitops as jb  # noqa: E402
from repro.core import bmm as jbmm, bspmm as jbsp, frdc as jf  # noqa: E402
from repro.core.binarize import dequantize as jdeq  # noqa: E402
tabs = lazy("repro_torch.core.abstraction")
tbits = lazy("repro_torch.core.bitops")
tbmm = lazy("repro_torch.core.bmm")
tbsp = lazy("repro_torch.core.bspmm")
tf = lazy("repro_torch.core.frdc")

jax.config.update("jax_platform_name", "cpu")


def _u32(t) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _assert_out(got, want, pre=None):
    """fp outputs within 1e-5; BinTensor outputs: scales close and bits
    equal, except (given the reference's pre-sign value ``pre``) where
    |pre| < 1e-5 * max|pre|, where a reordered fp sum may cross zero."""
    if hasattr(want, "packed"):
        assert got.n == want.n
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=1e-5, atol=1e-6)
        if pre is None:
            np.testing.assert_array_equal(_u32(got.packed),
                                          np.asarray(want.packed))
            return
        g = tbits.unpack_bits(got.packed, got.n).numpy()
        w = np.asarray(jb.unpack_bits(want.packed, want.n))
        pre = np.asarray(pre)
        near = np.abs(pre) < 1e-5 * np.abs(pre).max()
        assert not ((g != w) & ~near).any()
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["FBF", "FBB", "BBF", "BBB", "BFF",
                                     "BFB", "FFB"])
def test_bmm_variants_match_reference(variant):
    """Integer inputs keep the products exact except where a fractional
    weight scale enters before a sign (FBB): there the near-zero rule."""
    rng = np.random.default_rng(len(variant) + ord(variant[1]))
    x = rng.integers(-3, 4, (9, 40)).astype(np.float32)
    w = rng.integers(-3, 4, (40, 37)).astype(np.float32)
    xa, wp, _ = variant
    xj = jbmm.quantize_act(jnp.asarray(x)) if xa == "B" else jnp.asarray(x)
    xt = tbmm.quantize_act(torch.from_numpy(x)) if xa == "B" \
        else torch.from_numpy(x)
    wj = jbmm.quantize_weight(jnp.asarray(w)) if wp == "B" else jnp.asarray(w)
    wt = tbmm.quantize_weight(torch.from_numpy(w)) if wp == "B" \
        else torch.from_numpy(w)
    pre = xj @ jdeq(wj).T if variant == "FBB" else None
    for out_scale in (True, False):
        _assert_out(tbmm.bmm(xt, wt, variant, out_scale=out_scale),
                    jbmm.bmm(xj, wj, variant, out_scale=out_scale), pre)
    with pytest.raises(ValueError):
        tbmm.bmm(xt, wt, "XYZ")


@pytest.mark.parametrize("variant", ["FBF", "FBB", "BBF", "BBB"])
def test_bspmm_variants_match_reference(variant):
    """Each variant on a 0/1, a GCN-normalized and a mean adjacency, in both
    trinary modes."""
    rng = np.random.default_rng(11)
    n, f = 37, 45
    r, c = np.nonzero(rng.random((n, n)) < 0.15)
    makers = {
        "binary": (lambda: jf.from_coo(r, c, n, n),
                   lambda: tf.from_coo(r, c, n, n, device="cpu")),
        "gcn": (lambda: jf.gcn_normalized(r, c, n),
                lambda: tf.gcn_normalized(r, c, n, device="cpu")),
        "mean": (lambda: jf.mean_normalized(r, c, n),
                 lambda: tf.mean_normalized(r, c, n, device="cpu"))}
    x = rng.integers(-3, 4, (n, f)).astype(np.float32)
    if variant[0] == "B":
        xj, xt = jbmm.quantize_act(jnp.asarray(x)), tbmm.quantize_act(
            torch.from_numpy(x))
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for kind, (build_j, build_t) in makers.items():
        adj_j, adj_t = build_j(), build_t()
        pre = jbsp.bspmm(adj_j, xj, "FBF") if variant == "FBB" else None
        for mode in ("s2_and_andnot", "s3_two_popc"):
            _assert_out(tbsp.bspmm(adj_t, xt, variant, trinary_mode=mode),
                        jbsp.bspmm(adj_j, xj, variant, trinary_mode=mode), pre)


def test_abstraction_registry_and_chains_match_reference():
    assert sorted(tabs.REGISTRY) == sorted(jabs.REGISTRY)
    for name, v in tabs.REGISTRY.items():
        assert (v.in_precision, v.out_precision) == (
            jabs.REGISTRY[name].in_precision, jabs.REGISTRY[name].out_precision)
    tabs.check_chain("BMM.FBB", "BSpMM.BBB", "BMM.BBF")
    with pytest.raises(TypeError):
        tabs.check_chain("BMM.FBF", "BSpMM.BBB")
    with pytest.raises(TypeError):
        tabs.MMSpMM("BMM.FBB", "BSpMM.FBF")
    with pytest.raises(KeyError):
        tabs.op("BMM.QQQ")
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, (6, 40)).astype(np.float32)
    w1 = rng.integers(-3, 4, (40, 16)).astype(np.float32)
    w2 = rng.integers(-3, 4, (40, 16)).astype(np.float32)
    qj = [jbmm.quantize_weight(jnp.asarray(w)) for w in (w1, w2)]
    qt = [tbmm.quantize_weight(torch.from_numpy(w)) for w in (w1, w2)]
    xj, xt = jbmm.quantize_act(jnp.asarray(x)), tbmm.quantize_act(
        torch.from_numpy(x))
    block_j, block_t = jabs.MMAdd("BMM.BBF", "BMM.BBF"), tabs.MMAdd(
        "BMM.BBF", "BMM.BBF")
    _assert_out(block_t(xt, qt[0], xt, qt[1]), block_j(xj, qj[0], xj, qj[1]))
    for name in ("ADD.BBF", "CONCAT.BBB"):
        for a_n in (32, 40):
            aj = jbmm.quantize_act(jnp.asarray(x[:, :a_n]))
            at = tbmm.quantize_act(torch.from_numpy(x[:, :a_n]))
            if name == "ADD.BBF" and a_n != 40:
                continue
            _assert_out(tabs.op(name).fn(at, xt), jabs.op(name).fn(aj, xj))


@pytest.mark.parametrize("variant", ["BBF", "FBF", "BFF"])
def test_bmm_reference_fp_oracles(variant):
    """``tests/test_bmm_abstraction.py``'s fp oracles: the port's
    ``bmm_reference_fp`` equals the reference's within 1e-6 of the
    output's largest magnitude (the two libraries sum a product's terms
    in other orders), and the port's packed ``bmm`` agrees with it within
    the reference tests' 1e-4."""
    rng = np.random.default_rng(ord(variant[0]) + ord(variant[1]))
    for m, k, n in ((8, 33, 9), (17, 70, 40), (1, 1, 1)):
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        ref = tbmm.bmm_reference_fp(xt, wt, variant)
        want = np.asarray(jbmm.bmm_reference_fp(jnp.asarray(x),
                                                jnp.asarray(w), variant))
        assert np.abs(ref.numpy() - want).max() <= 1e-6 * np.abs(want).max()
        xin = tbmm.quantize_act(xt) if variant[0] == "B" else xt
        win = tbmm.quantize_weight(wt) if variant[1] == "B" else wt
        np.testing.assert_allclose(tbmm.bmm(xin, win, variant).numpy(),
                                   ref.numpy(), rtol=1e-4, atol=1e-4)


def test_spmm_reference_fp_matches_reference():
    """The dense oracle ``Adj_eff @ X`` against the reference's, and the
    port's FBF product on a GCN-normalized FRDC matrix against it with
    the matrix decoded dense."""
    rng = np.random.default_rng(5)
    n, f = 37, 12
    r, c = np.nonzero(rng.random((n, n)) < 0.15)
    x = rng.standard_normal((n, f)).astype(np.float32)
    adj_t = tf.gcn_normalized(r, c, n, device="cpu")
    dense = np.array(jf.to_dense(jf.gcn_normalized(r, c, n)))
    got = tbsp.spmm_reference_fp(torch.from_numpy(dense), torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jbsp.spmm_reference_fp(jnp.asarray(dense),
                                                      jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbsp.bspmm(adj_t, torch.from_numpy(x),
                                          "FBF").numpy(),
                               got.numpy(), rtol=1e-5, atol=1e-5)
