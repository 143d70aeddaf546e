"""The slice as a whole: the port's bitgnn forwards against the reference's
on the same graph and the same weights (reference init -> numpy ->
``params_from_numpy``), for GCN "bin", GCN "full", GraphSAGE and GraphSAINT.

Tolerances: logits rtol = atol = 1e-4 (the two packages sum fp32 products
in different orders: the K-wide BMM.F?? matmuls and the BSpMM group sums);
BN stats rtol 1e-5, atol 1e-6; predictions identical. Packed intermediate
bits must be equal except where the reference's pre-sign value v has
|v| < 1e-5 * max|v|, where a reordered sum may cross zero; the test counts
those positions.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitops as jbits, bmm as jbmm, frdc as jf  # noqa: E402
from repro.core.binarize import dequantize as jdeq  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
tbits = lazy("repro_torch.core.bitops")
tbmm = lazy("repro_torch.core.bmm")
tf = lazy("repro_torch.core.frdc")
tbin = lazy("repro_torch.core.binarize")
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")

jax.config.update("jax_platform_name", "cpu")

HIDDEN = 32
NEAR_ZERO = 1e-5
CONFIGS = [("gcn", "bin"), ("gcn", "full"), ("sage", None), ("saint", None)]
ADJ_KINDS = {"gcn": ("gcn", "binary"), "sage": ("mean",), "saint": ("binary",)}


@pytest.fixture(scope="module")
def graph():
    d = make_dataset("cora", seed=0, scale=0.25)
    t = td.make_dataset("cora", seed=0, scale=0.25)
    kinds = ("gcn", "binary", "mean")
    return (d, {k: d.adjacency(k) for k in kinds},
            {k: t.adjacency(k, device="cpu") for k in kinds})


def _params(family, d, seed):
    init = getattr(jg, f"init_{family}")
    pj = init(jax.random.PRNGKey(seed), d.x.shape[1], HIDDEN, d.n_classes)
    pt = tg.params_from_numpy(family, [np.asarray(w) for w in pj], "cpu")
    return pj, pt


def _layers(mod, family, scheme, q):
    if family == "gcn":
        return mod.gcn_bitgnn_layers(q, scheme)
    return mod.bitgnn_layers(family, q)


def _mats(family, adjs):
    kinds = ADJ_KINDS[family]
    if family == "gcn":
        return {"adj": adjs["gcn"], "bin": adjs["binary"]}
    return {"adj": adjs[kinds[0]]}


def _run(mod, layers, x, mats):
    """Run per-layer callables, recording every BN output and layer output."""
    tap = mod._BNTap(None)
    bn_outs = []

    def bn(h):
        y = tap(h)
        bn_outs.append(y)
        return y

    outs, h = [], x
    for fn in layers:
        h = fn(bn, h, mats)
        outs.append(h)
    return outs, bn_outs, tuple(tap.collected)


def _bits_agree(got_packed, want_packed, pre_sign, n):
    """Assert packed bits equal except at near-zero pre-sign positions;
    return (mismatches, near-zero positions)."""
    g = tbits.unpack_bits(got_packed, n).numpy()
    w = np.asarray(jbits.unpack_bits(want_packed, n))
    v = np.asarray(pre_sign)
    near = np.abs(v) < NEAR_ZERO * np.abs(v).max()
    bad = g != w
    assert not (bad & ~near).any(), int((bad & ~near).sum())
    return int(bad.sum()), int(near.sum())


@pytest.mark.parametrize("family,scheme", CONFIGS)
def test_forward_matches_reference(graph, family, scheme):
    d, adj_j, adj_t = graph
    pj, pt = _params(family, d, seed=len(family))
    qj = getattr(jg, f"quantize_{family}")(pj)
    qt = getattr(tg, f"quantize_{family}")(pt)
    x_j, x_t = jnp.asarray(d.x), torch.from_numpy(d.x)
    outs_j, bn_j, stats_j = _run(jg, _layers(jg, family, scheme, qj), x_j,
                                 _mats(family, adj_j))
    outs_t, bn_t, stats_t = _run(tg, _layers(tg, family, scheme, qt), x_t,
                                 _mats(family, adj_t))

    logits_j, logits_t = np.asarray(outs_j[-1]), outs_t[-1].numpy()
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(logits_t.argmax(1), logits_j.argmax(1))

    assert len(stats_t) == len(stats_j)
    for (mu_t, sd_t), (mu_j, sd_j) in zip(stats_t, stats_j):
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j),
                                   rtol=1e-5, atol=1e-6)

    # packed intermediates: the BIN of every BN site (quantize_act)
    bad_total = near_total = 0
    for y_t, y_j in zip(bn_t, bn_j):
        n = y_j.shape[-1]
        bad, near = _bits_agree(tbin.bin_op(y_t), jbits.sign_bits(y_j), y_j, n)
        bad_total, near_total = bad_total + bad, near_total + near
    if scheme == "bin":
        # layer 1: BMM.FBB bits, then the BSpMM.BBB output bits
        fbb_t = tbmm.bmm(bn_t[0], qt.w1, "FBB", out_scale=False)
        fbb_j = jbmm.bmm(bn_j[0], qj.w1, "FBB", out_scale=False)
        pre = bn_j[0] @ jdeq(qj.w1).T
        bad, near = _bits_agree(fbb_t.packed, fbb_j.packed, pre, HIDDEN)
        bad_total, near_total = bad_total + bad, near_total + near
        if bad == 0:
            np.testing.assert_array_equal(
                outs_t[0].packed.numpy().view(np.uint32),
                np.asarray(outs_j[0].packed))
    # every flipped bit sat at one of the counted near-zero positions
    assert bad_total <= near_total, (bad_total, near_total)


@pytest.mark.parametrize("family,scheme", CONFIGS)
def test_modules_equal_functional_forwards(graph, family, scheme):
    d, _, adj_t = graph
    _, pt = _params(family, d, seed=7)
    x = torch.from_numpy(d.x)
    mats = [adj_t[k] for k in ADJ_KINDS[family]]
    q = getattr(tg, f"quantize_{family}")(pt)
    if family == "gcn":
        model = tg.BitGCN(pt, scheme=scheme)
        want = tg.gcn_forward_bitgnn(q, x, *mats, scheme=scheme)
    else:
        model = {"sage": tg.BitSAGE, "saint": tg.BitSAINT}[family](pt)
        want = getattr(tg, f"{family}_forward_bitgnn")(q, x, *mats)
    logits, stats = model(x, *mats, return_bn_stats=True)
    assert torch.equal(logits, want)
    # frozen BN stats reproduce the calibrated forward exactly
    assert torch.equal(model(x, *mats, bn_stats=stats), logits)
    names = {n for n, _ in model.named_buffers()}
    assert {f"{f}_packed" for f in q._fields} <= names


def test_fp_forwards_and_accuracy_match_reference(graph):
    d, adj_j, adj_t = graph
    for family, kind in (("gcn", "gcn"), ("sage", "mean"), ("saint", "binary")):
        pj, pt = _params(family, d, seed=3)
        dense_j, dense_t = jf.to_dense(adj_j[kind]), tf.to_dense(adj_t[kind])
        fwd_j = getattr(jg, f"{family}_forward_fp")
        fwd_t = getattr(tg, f"{family}_forward_fp")
        want = np.array(fwd_j(pj, jnp.asarray(d.x), dense_j))
        got = fwd_t(pt, torch.from_numpy(d.x), dense_t)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=family)
        acc_j = jg.accuracy(jnp.asarray(want), jnp.asarray(d.y),
                            jnp.asarray(d.test_mask))
        acc_t = tg.accuracy(torch.from_numpy(want), torch.from_numpy(d.y),
                            torch.from_numpy(d.test_mask))
        assert acc_t == pytest.approx(acc_j, abs=1e-6), family


def test_init_is_seeded_glorot_and_params_validate():
    a = tg.init_saint(5, 20, 8, 3, device="cpu")
    b = tg.init_saint(5, 20, 8, 3, device="cpu")
    for wa, wb in zip(a, b):
        assert torch.equal(wa, wb)
    lim = float(np.sqrt(6.0 / (20 + 8)))
    assert a.w1_self.shape == (20, 8) and float(a.w1_self.abs().max()) <= lim
    assert a.w_fc.shape == (8, 3)
    named = tg.params_from_numpy(
        "gcn", {"w1": np.ones((4, 2)), "w2": np.ones((2, 3))}, "cpu")
    assert named.w1.dtype == torch.float32 and named.w2.shape == (2, 3)
    with pytest.raises(ValueError):
        tg.params_from_numpy("gcn", [np.ones((4, 2))], "cpu")
    with pytest.raises(ValueError):
        tg.params_from_numpy("gat", [], "cpu")


def test_binarize_ops_match_reference():
    """BIN with row/col/none scales, dequantize, SCL and the BN ops."""
    from repro.core import binarize as jb
    tb = tbin
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 45)).astype(np.float32)
    for scale in ("row", "col", "none"):
        got = tb.binarize_matrix(torch.from_numpy(x), scale)
        want = jb.binarize_matrix(jnp.asarray(x), scale)
        np.testing.assert_array_equal(got.packed.numpy().view(np.uint32),
                                      np.asarray(want.packed))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=1e-6)
        np.testing.assert_allclose(tb.dequantize(got).numpy(),
                                   np.asarray(jb.dequantize(want)), rtol=1e-6)
    with pytest.raises(ValueError):
        tb.binarize_matrix(torch.from_numpy(x), "max")
    s = rng.random((6, 1)).astype(np.float32) + 0.5
    assert torch.equal(tb.scl_op(torch.from_numpy(x), torch.from_numpy(s),
                                 elide=True), torch.from_numpy(x))
    np.testing.assert_allclose(
        tb.scl_op(torch.from_numpy(x), torch.from_numpy(s)).numpy(), x * s)
    p = [rng.random(45).astype(np.float32) + 0.1 for _ in range(4)]
    pt = tb.BNParams(*(torch.from_numpy(a) for a in p))
    pj = jb.BNParams(*(jnp.asarray(a) for a in p))
    np.testing.assert_allclose(tb.bn_op(torch.from_numpy(x), pt).numpy(),
                               np.asarray(jb.bn_op(jnp.asarray(x), pj)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.bn_bin_threshold(pt).numpy(),
                               np.asarray(jb.bn_bin_threshold(pj)),
                               rtol=1e-5, atol=1e-6)
