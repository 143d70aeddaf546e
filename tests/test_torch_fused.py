"""The fused per-layer path of the port against the reference's.

* Sessions: for GCN "bin" (``gcn_bin_l1`` + ``gcn_bbf_fbf`` on packed
  words), GCN "full" (``gcn_bbf_fbf``), SAGE (``branch_add``) and SAINT
  (``branch_add`` + ``fc``), a port session with ``fused=True`` serves the
  same seeds as the reference's fused session (its Pallas ``fused_call`` in
  interpret mode under ``force_kernels``), both under the reference's
  frozen BN: logits rtol = atol = 1e-4, predictions identical, and one
  fused layer per layer (``KERNEL_CALLS["fused"]``).
* The plain aggregation stages ``agg_fp`` / ``agg_counts`` against the
  reference's value-level walks: counts bit-exact, fp at 1e-5.
* Each kind's plain version against the unfused composition of the same
  layer (``models/gnn.py`` layer callables) on inputs whose transform sums
  are exact: packed words bit-exact, fp within 1e-5 of the sum of |terms|.
* The fused gate: ``use_pallas`` off, or a calibration pass, runs unfused.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitops as jb, frdc as jf  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.kernels import fused_layer as jfl, ops as jops  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import GraphStore as JStore  # noqa: E402
from repro.serve import session_core as jsc  # noqa: E402
from repro.serve.gnn_session import CompiledGraphSession as JSession  # noqa: E402,E501
tf = lazy("repro_torch.core.frdc")
tbin = lazy("repro_torch.core.binarize")
tbits = lazy("repro_torch.core.bitops")
tbmm = lazy("repro_torch.core.bmm")
tfl = lazy("repro_torch.kernels.fused_layer")
tg = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")
tsc = lazy("repro_torch.serve.session_core")
td = lazy("repro_torch.graphs.datasets")

jax.config.update("jax_platform_name", "cpu")

BATCH = 8
HIDDEN = 16
CONFIGS = [("gcn", "bin", 2), ("gcn", "full", 2), ("sage", "fixed", 2),
           ("saint", "fixed", 3)]


@pytest.fixture(scope="module")
def data():
    return make_dataset("cora", seed=0, scale=0.1)


def _plan(mod, family, scheme):
    variants = (mod.GCN_SCHEME_VARIANTS[scheme] if family == "gcn"
                else mod.FIXED_VARIANTS)
    return mod.SessionPlan(family, scheme, layer_variants=variants,
                           fused=True)


@pytest.mark.parametrize("family,scheme,n_layers", CONFIGS)
def test_fused_session_matches_reference(data, family, scheme, n_layers):
    pj = getattr(jg, f"init_{family}")(jax.random.PRNGKey(1), data.x.shape[1],
                                       HIDDEN, data.n_classes)
    pt = tg.params_from_numpy(family, [np.asarray(w) for w in pj], "cpu")
    seeds = np.random.default_rng(2).integers(0, data.n_nodes, size=BATCH)

    jst = JStore(max_batch=BATCH, use_pallas=True, fused=True)
    jst.register_graph("g", data)
    jst.register_model("m", family, pj)
    jops.force_kernels(True)
    try:
        jsess = JSession(jst.graphs["g"], jst.models["m"],
                         _plan(jsc, family, scheme),
                         jsc.quantize_family(family, pj), max_batch=BATCH,
                         use_pallas=True)
        jfl.reset_counters()
        want = np.asarray(jsess.serve_subgraph(seeds))
        assert jfl.KERNEL_CALLS["fused"] == n_layers
    finally:
        jops.force_kernels(False)

    tst = tserve.GraphStore(max_batch=BATCH, use_pallas=True, fused=True,
                            device="cpu")
    tst.register_graph("g", td.make_dataset("cora", seed=0, scale=0.1))
    tst.register_model("m", family, pt)
    tsess = tserve.CompiledGraphSession(
        tst.graphs["g"], tst.models["m"], _plan(tsc, family, scheme),
        tsc.quantize_family(family, pt), max_batch=BATCH, use_pallas=True,
        device="cpu")
    tsess.sync()
    # the port calibrates like the reference; serve both under its stats
    assert len(tsess.bn) == len(jsess.bn)
    for (mu_t, sd_t), (mu_j, sd_j) in zip(tsess.bn, jsess.bn):
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j),
                                   rtol=1e-5, atol=1e-6)
    tsess.bn = tuple((torch.from_numpy(np.array(m)),
                      torch.from_numpy(np.array(s))) for m, s in jsess.bn)
    tfl.reset_counters()
    got = tsess.serve_subgraph(seeds)
    assert tfl.KERNEL_CALLS["fused"] == n_layers
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_agg_walks_match_reference_walks():
    rng = np.random.default_rng(4)
    a = (rng.random((45, 45)) < 0.2).astype(np.float32)
    a[30:] = 0
    a[2, :] = 1.0                                   # a row of many groups
    s = rng.random(45) + 0.5
    ja = jf.pad_frdc(jf.from_dense(a, row_scale=s, col_scale=s), 64,
                     n_groups=40)
    ta = tf.pad_frdc(tf.from_dense(a, device="cpu", row_scale=s,
                                   col_scale=s), 64, n_groups=40)
    x = rng.standard_normal((64, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tfl.agg_fp(ta, torch.from_numpy(x)).numpy(),
        np.asarray(jfl.agg_fp(ja, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    xp = np.asarray(jb.pack_bits(rng.integers(0, 2, (64, 40))))
    for mode in ("s3_two_popc", "s2_and_andnot"):
        got = tfl.agg_counts(ta, torch.from_numpy(xp.view(np.int32).copy()),
                             mode)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jfl.agg_counts(ja, jnp.asarray(xp), mode)))


def _exact_inputs(rng, n=300, f=70, h=40):
    """Integer features, BN by integers, +-1 weights with power-of-two
    scales, a scaled adjacency with a many-group row: every transform sum
    is exact in any order."""
    a = (rng.random((n, n)) < 0.03).astype(np.float32)
    a[1, :] = 1.0
    s = rng.random(n) + 0.5
    adj = tf.pad_frdc(tf.from_dense(a, device="cpu", row_scale=s,
                                    col_scale=s), n + 20)
    adj_bin = tf.pad_frdc(tf.from_dense(a, device="cpu"), n + 20)
    x = torch.from_numpy(rng.integers(-3, 4, (n + 20, f)).astype(np.float32))
    bn = (torch.from_numpy(rng.integers(-1, 2, (1, f)).astype(np.float32)),
          torch.from_numpy(rng.choice([1.0, 2.0], (1, f)).astype(np.float32)))

    def weights(n_out, n_in):
        return tbin.BinTensor(
            tbits.pack_bits(torch.from_numpy(rng.integers(0, 2, (n_out,
                                                                n_in)))),
            torch.from_numpy(rng.choice([0.25, 0.5], (n_out, 1)).astype(
                np.float32)), n_in)
    return x, bn, weights(h, f), weights(h, f), weights(10, h), adj, adj_bin


@pytest.mark.parametrize("kind", ["gcn_bin_l1", "gcn_bbf_fbf", "branch_add",
                                  "fc"])
def test_fused_kind_matches_unfused_layer(kind):
    x, bn, w1, w2, w_l2, adj, adj_bin = _exact_inputs(
        np.random.default_rng(9))
    tap = tg._BNTap((bn,))
    words, xs = tfl._input(x, bn)
    if kind == "gcn_bin_l1":
        got = tfl.gcn_bin_l1(x, bn, w1, adj_bin)
        layers = tg.gcn_bitgnn_layers(tg.GCNQuant(w1, w_l2), "bin")
        carry = layers[0](tap, x, {"bin": adj_bin})
        assert torch.equal(got, carry.packed)
        # layer 2 takes those words with unit scales and no BN
        got = tfl.gcn_bbf_fbf(got, None, w_l2, adj)
        want = layers[1](tap, carry, {"adj": adj})
        mag = tfl.agg_fp(adj, tfl._bbf(carry.packed, carry.scale,
                                       w_l2).abs())
    elif kind == "gcn_bbf_fbf":
        got = tfl.gcn_bbf_fbf(x, bn, w1, adj, relu=True)
        want = tg.gcn_bitgnn_layers(tg.GCNQuant(w1, w2), "full")[0](
            tap, x, {"adj": adj})
        mag = tfl.agg_fp(adj, tfl._bbf(words, xs, w1).abs())
    elif kind == "branch_add":
        got = tfl.branch_add(x, bn, w1, w2, adj, relu=True)
        want = tg._branch_add_layer(w1, w2, True)(tap, x, {"adj": adj})
        mag = tfl._bbf(words, xs, w1).abs() + tfl.agg_fp(
            adj, tfl._bbf(words, xs, w2).abs())
    else:
        got = tfl.fc(x, bn, w1)
        want = tbmm.bmm(tbmm.quantize_act(tap(x)), w1, "BBF")
        mag = torch.zeros(())
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all())


def test_fused_gate_follows_use_pallas_and_calibration(data):
    pt = tg.init_sage(0, data.x.shape[1], HIDDEN, data.n_classes, "cpu")
    q = tsc.quantize_family("sage", pt)
    x = torch.from_numpy(data.x)
    adjs = {"mean": tf.mean_normalized(data.edges[0], data.edges[1],
                                       data.n_nodes, device="cpu")}
    plan = _plan(tsc, "sage", "fixed")
    tfl.reset_counters()
    out, bn = tsc.family_forward(plan, q, x, adjs, use_pallas=True,
                                 return_bn_stats=True)
    assert tfl.KERNEL_CALLS["fused"] == 0            # calibration: unfused
    unfused = tsc.family_forward(plan, q, x, adjs, use_pallas=False,
                                 bn_stats=bn)
    assert tfl.KERNEL_CALLS["fused"] == 0            # use_pallas off
    fused = tsc.family_forward(plan, q, x, adjs, use_pallas=True,
                               bn_stats=bn)
    assert tfl.KERNEL_CALLS == {"fused": 2, "fused_aggs": 2}
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(unfused.numpy(), out.numpy(), rtol=1e-5,
                               atol=1e-5)
