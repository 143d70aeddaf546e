"""The port's bit-packed LM linears (``repro_torch.quant.binary_linear``)
against the reference's (``repro.quant.binary_linear``), the port on the
CPU.

The same weights go to both packages. Held: the packed words bit for bit
(the port's int32 bit-views against the reference's uint32 words), the
scales within 1 bf16 ulp (the port's fp32 mean sums in another order),
``dequantize_linear`` and a packed ``layers.linear`` against the
reference's, the ``quantize_params`` tree (the same leaves packed, the
others unchanged) and ``quantized_param_bytes``, and a quantized forward
within the bf16 rule of the model tests (rtol = atol = 0.05).
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.quant import binary_linear as jq  # noqa: E402
torch = lazy("torch")
tl = lazy("repro_torch.models.layers")
tq = lazy("repro_torch.quant.binary_linear")
tt = lazy("repro_torch.models.transformer")
tconf = lazy("repro_torch.configs")

jax.config.update("jax_platform_name", "cpu")

BF16_TOL = 0.05


def _weight(shape, dtype, seed=0, zeros=0):
    w = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    if zeros:   # exact zeros pack as +1 (w >= 0)
        w = w.at[:zeros].set(0.0)
    return w.astype(dtype)


def _port(a):
    return tt.params_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("shape,dtype", [
    ((128, 96), jnp.bfloat16), ((100, 7), jnp.float32),
    ((512, 33), jnp.bfloat16), ((1000, 64), jnp.float32)])
def test_packed_words_bit_equal(shape, dtype):
    w = _weight(shape, dtype, seed=shape[0], zeros=3)
    want = jq.quantize_linear(w)
    got = tq.quantize_linear(_port(w))
    assert got["packed"].dtype == torch.int32
    words = got["packed"].numpy().view(np.uint32)
    assert words.shape == want["packed"].shape
    assert np.array_equal(words, np.asarray(want["packed"]))
    # bit 31 set: the int64 build wrapped to the int32 view
    assert (words >> 31).any()
    ws = np.asarray(want["scale"].astype(jnp.float32))
    np.testing.assert_allclose(got["scale"].float().numpy(), ws,
                               rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_dequantize_and_packed_linear_match(dtype):
    w = _weight((200, 48), dtype, seed=1)
    qj = jq.quantize_linear(w)
    qt = {"packed": _port(qj["packed"]), "scale": _port(qj["scale"])}
    want = np.asarray(jq.dequantize_linear(qj, 200, dtype).astype(jnp.float32))
    got = tq.dequantize_linear(qt, 200, torch.bfloat16
                               if dtype == jnp.bfloat16 else torch.float32)
    assert np.array_equal(got.float().numpy(), want)
    x = _weight((3, 5, 200), dtype, seed=2)
    lj = np.asarray(jl.linear(qj, x).astype(jnp.float32))
    lt = tl.linear(qt, _port(x)).float().numpy()
    tol = BF16_TOL if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(lt, lj, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2-moe-a2.7b"])
def test_quantize_params_tree(arch):
    """The same leaves are packed, by their key; every word equal, every
    other leaf unchanged; the byte counts equal the reference's."""
    cfg = reduced_config(get_config(arch)).resolve_for_mesh(tp=1)
    pj = jt.init_params(jax.random.PRNGKey(0), cfg)
    qj = jq.quantize_params(pj)
    qt = tq.quantize_params(tt.params_from_numpy(
        jax.tree.map(np.asarray, pj), "cpu"))
    flat_j = jax.tree_util.tree_flatten_with_path(qj)[0]
    back = tt.params_to_numpy(qt)
    flat_t = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    n_packed = 0
    for (path, a), (_, b) in zip(flat_j, flat_t):
        a = np.asarray(a)
        if path[-1].key == "packed":
            n_packed += 1
            assert b.dtype == np.uint32 and np.array_equal(a, b)
        elif path[-1].key == "scale" and path[-2].key in jq._QUANT_KEYS:
            np.testing.assert_allclose(b, a.astype(np.float32),
                                       rtol=2 ** -7, atol=0)
        else:
            assert np.array_equal(b, a.astype(b.dtype)), path
    assert n_packed > 0
    assert tq.quantized_param_bytes(qt) == jq.quantized_param_bytes(qj)


def test_quantized_forward_matches_reference():
    cfg = reduced_config(get_config("smollm-135m")).resolve_for_mesh(tp=1)
    tcfg = tconf.reduced_config(
        tconf.get_config("smollm-135m")).resolve_for_mesh(tp=1)
    pj = jt.init_params(jax.random.PRNGKey(0), cfg)
    qj = jq.quantize_params(pj)
    # carry the reference's packed tree, so both forwards use one scale
    qt = tt.params_from_numpy(jax.tree.map(np.asarray, qj), "cpu")
    before = tq.quantized_param_bytes(
        tt.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu"))
    assert tq.quantized_param_bytes(qt) < before * 0.6
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                cfg.vocab)
    want = np.asarray(jax.jit(lambda p, t: jt.forward(p, cfg, t))(
        qj, tokens).astype(jnp.float32))
    got = tt.forward(qt, tcfg, _port(tokens)).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
