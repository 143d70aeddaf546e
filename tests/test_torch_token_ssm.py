"""The port's SSM blocks (``repro_torch.models.ssm``) against sequential
oracles and against the reference's (``repro.models.ssm``), the port on
the CPU; the contracts of ``tests/test_ssm_oracles.py`` held on the port.

* chunked Mamba2 / RWKV6 against a literal per-timestep recurrence (numpy),
  with the reference test's tolerances (2e-3, 5e-3), and against the
  reference's chunked block on the same fp32 weights within 1e-4;
* ``decode_chunk`` bit-equal to a loop of ``decode_step``, logits and
  every cache leaf, zamba2 and rwkv6, quantized or not; its logits against
  the reference's ``decode_chunk`` on fp32 replicas within 1e-4 (in bf16
  the zamba2 hybrid's two packages part by up to 0.5 over 9 steps while
  each sits as far from fp32; ROADMAP Queue 3);
* token-by-token Mamba2 decode reproduces the chunked forward's last
  output, and the decode caches (SSM states, conv and shift tails) match
  the reference's on fp32 replicas within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.quant.binary_linear import quantize_params  # noqa: E402
torch = lazy("torch")
F = lazy("torch.nn.functional")
tconf = lazy("repro_torch.configs")
tssm = lazy("repro_torch.models.ssm")
tl = lazy("repro_torch.models.layers")
tt = lazy("repro_torch.models.transformer")

jax.config.update("jax_platform_name", "cpu")

REF_TOL = 1e-4


def _cfgs(arch, dtype="bfloat16"):
    j = reduced_config(get_config(arch)).resolve_for_mesh(tp=1)
    t = tconf.reduced_config(tconf.get_config(arch)).resolve_for_mesh(tp=1)
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


def _port(tree):
    return tt.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _mamba_sequential(p, x, cfg):
    """Literal recurrence: S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T."""
    b, t, d = x.shape
    h, p_dim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z = tl.linear(p["wz"], x)
    xh, _ = tssm._causal_conv(tl.linear(p["wx"], x), p["conv_w"])
    xh = F.silu(xh)
    bmat = tl.linear(p["wB"], x).numpy()
    cmat = tl.linear(p["wC"], x).numpy()
    dt = F.softplus(tl.linear(p["wdt"], x) + p["dt_bias"]).numpy()
    a = -np.exp(p["A_log"].numpy())
    xs = xh.reshape(b, t, h, p_dim).numpy()
    s = np.zeros((b, h, p_dim, n), np.float32)
    ys = []
    for i in range(t):
        dec = np.exp(dt[:, i] * a)[..., None, None]
        s = s * dec + np.einsum("bh,bn,bhp->bhpn", dt[:, i], bmat[:, i],
                                xs[:, i])
        ys.append(np.einsum("bn,bhpn->bhp", cmat[:, i], s))
    y = np.stack(ys, axis=1) + p["D"].numpy()[None, None, :, None] * xs
    y = torch.from_numpy(y.reshape(b, t, h * p_dim)) * F.silu(z)
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return tl.linear(p["wo"], y * torch.rsqrt(var + 1e-6) * p["norm_scale"])


def test_mamba_chunked_matches_sequential_and_reference():
    cfg, tcfg = _cfgs("zamba2-1.2b", "float32")
    pj = jssm.init_mamba(jax.random.PRNGKey(0), cfg, jnp.float32)
    pt = _port(pj)
    for t in (1, 7, 256, 300):
        x = jax.random.normal(jax.random.PRNGKey(1), (2, t, cfg.d_model),
                              jnp.float32) * 0.5
        xt = _port(x)
        got, _ = tssm.mamba_block(pt, xt, tcfg)
        np.testing.assert_allclose(got.numpy(),
                                   _mamba_sequential(pt, xt, tcfg).numpy(),
                                   rtol=2e-3, atol=2e-3)
        want, _ = jax.jit(lambda p, v: jssm.mamba_block(
            p, v, cfg, unroll=True))(pj, x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=REF_TOL, atol=REF_TOL)


def _rwkv_wkv_sequential(r, k, v, logw, u):
    """Literal RWKV6 wkv: y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)."""
    b, t, h, hk = r.shape
    s = np.zeros((b, h, hk, hk), np.float64)
    w = np.exp(logw)
    ys = []
    for i in range(t):
        kv = np.einsum("bhk,bhv->bhkv", k[:, i], v[:, i])
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, i],
                            s + u[None, :, :, None] * kv))
        s = s * w[:, i][..., None] + kv
    return np.stack(ys, axis=1)


def test_rwkv_wkv_chunked_matches_sequential_and_reference():
    """The inner wkv through the public block, chunked, against an oracle
    built on the block's own projections, and against the reference's
    chunked block."""
    cfg, tcfg = _cfgs("rwkv6-3b", "float32")
    pj = jssm.init_rwkv(jax.random.PRNGKey(0), cfg, jnp.float32)
    # tame the decay lora so exp() ranges stay numerically comparable
    pj["w0"] = -2.0 * jnp.ones_like(pj["w0"])
    p = _port(pj)
    hk = tcfg.ssm_head_dim
    h = tcfg.ssm_heads_padded or tcfg.d_model // hk
    for t in (1, 5, 64, 100, 200):
        x = jax.random.normal(jax.random.PRNGKey(1), (2, t, cfg.d_model),
                              jnp.float32) * 0.3
        xt = _port(x)
        got, _ = tssm.rwkv_time_mix(p, xt, tcfg)
        want, _ = jax.jit(lambda p, v: jssm.rwkv_time_mix(
            p, v, cfg, unroll=True))(pj, x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=REF_TOL, atol=REF_TOL)
        xr, xk, xv, xw, xg = (tssm._token_shift(xt, p["mu"][i])
                              for i in range(5))
        proj = [tl.linear(p[w], xi).reshape(2, t, h, hk).numpy()
                .astype(np.float64) for w, xi in (("wr", xr), ("wk", xk),
                                                  ("wv", xv))]
        lora = torch.tanh(xw @ p["wA"]) @ p["wB"]
        logw = -torch.exp(torch.clamp(p["w0"] + lora, -8.0, 8.0))
        logw = torch.clamp(logw, min=-tssm._CLAMP).reshape(2, t, h, hk)
        y = _rwkv_wkv_sequential(*proj, logw.numpy().astype(np.float64),
                                 p["u"].reshape(h, hk).numpy())
        y = torch.from_numpy(y.astype(np.float32))
        mu = torch.mean(y, dim=-1, keepdim=True)
        var = torch.var(y, dim=-1, keepdim=True, correction=0)
        y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(2, t, h * hk)
        y = (y * p["ln_scale"]) * F.silu(tl.linear(p["wg"], xg))
        np.testing.assert_allclose(got.numpy(),
                                   tl.linear(p["wo"], y).numpy(),
                                   rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("name", ["zamba2-1.2b", "rwkv6-3b"])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_chunk_bitexact_vs_stepwise(name, quant):
    """``decode_chunk`` (the loop the token tier launches per chunk) equals
    a loop of ``decode_step`` bit for bit: every logit AND every cache leaf
    (KV rows, SSM states, conv and shift tails), for the mamba hybrid and
    the pure-rwkv stack, quantized and not; its logits are held against the
    reference's ``decode_chunk`` on the same (packed) weights."""
    cfg, tcfg = _cfgs(name)
    pj = jt.init_params(jax.random.PRNGKey(0), cfg)
    if quant:
        pj = quantize_params(pj)
    pt = _port(pj)
    b, t, cache_len = 2, 9, 32
    tokens = jax.random.randint(jax.random.PRNGKey(1), (b, t), 0, cfg.vocab)
    tok = torch.from_numpy(np.array(tokens))

    cache_s = tt.init_cache(tcfg, b, cache_len, device="cpu")
    rows = []
    for i in range(t):
        lg, cache_s = tt.decode_step(pt, tcfg, cache_s, tok[:, i:i + 1], i)
        rows.append(lg[:, 0])
    got, cache_c = tt.decode_chunk(
        pt, tcfg, tt.init_cache(tcfg, b, cache_len, device="cpu"), tok, 0)
    assert torch.equal(got, torch.stack(rows, dim=1))
    leaves_s = jax.tree_util.tree_leaves(tt.cache_to_numpy(cache_s))
    leaves_c = jax.tree_util.tree_leaves(tt.cache_to_numpy(cache_c))
    assert len(leaves_s) == len(leaves_c) > 0
    for ls, lc in zip(leaves_s, leaves_c):
        assert np.array_equal(ls, lc)

    # against the reference, on fp32 replicas of the same weights (in
    # bf16 both packages drift from fp32 by more than from each other
    # here; ROADMAP Queue 3)
    c32, t32 = _cfgs(name, "float32")
    p32 = jt.init_params(jax.random.PRNGKey(0), c32)
    if quant:
        p32 = quantize_params(p32)
    want, _ = jax.jit(lambda p, c, x: jt.decode_chunk(p, c32, c, x,
                                                      jnp.int32(0)))(
        p32, jt.init_cache(c32, b, cache_len), tokens)
    got32, _ = tt.decode_chunk(
        _port(p32), t32, tt.init_cache(t32, b, cache_len, device="cpu"),
        tok, 0)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want),
                               rtol=REF_TOL, atol=REF_TOL)


def test_mamba_decode_matches_chunked_prefix():
    """Decoding token-by-token reproduces the chunked forward's last
    output."""
    cfg, tcfg = _cfgs("zamba2-1.2b", "float32")
    p = _port(jssm.init_mamba(jax.random.PRNGKey(0), cfg, jnp.float32))
    t = 12
    x = _port(jax.random.normal(jax.random.PRNGKey(2), (1, t, cfg.d_model),
                                jnp.float32) * 0.5)
    full, _ = tssm.mamba_block(p, x, tcfg)
    h = tcfg.ssm_heads
    cache = {"S": torch.zeros((1, h, tcfg.ssm_head_dim, tcfg.ssm_state)),
             "conv": torch.zeros((1, 3, h * tcfg.ssm_head_dim))}
    outs = []
    for i in range(t):
        y, cache = tssm.mamba_block(p, x[:, i:i + 1], tcfg, cache=cache)
        outs.append(y)
    got = torch.cat(outs, dim=1)
    np.testing.assert_allclose(got[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_ssm_decode_caches_match_reference():
    """Three decode steps of each SSM arch on fp32 replicas: every cache
    leaf (fp32 states, conv and shift tails, the hybrid's KV rows) within
    1e-5 of the reference's; a fourth step taken by the port from the
    reference's cache, carried across (``cache_from_numpy``), gives the
    reference's logits within 1e-4."""
    for name in ("zamba2-1.2b", "rwkv6-3b"):
        cfg, tcfg = _cfgs(name, "float32")
        pj = jt.init_params(jax.random.PRNGKey(0), cfg)
        pt = _port(pj)
        tokens = jax.random.randint(jax.random.PRNGKey(3), (2, 3), 0,
                                    cfg.vocab)
        cj = jt.init_cache(cfg, 2, 8)
        ct = tt.init_cache(tcfg, 2, 8, device="cpu")
        step = jax.jit(lambda p, c, x, pos: jt.decode_step(p, cfg, c, x,
                                                           pos))
        for i in range(3):
            _, cj = step(pj, cj, tokens[:, i:i + 1], jnp.int32(i))
            _, ct = tt.decode_step(pt, tcfg, ct,
                                   torch.from_numpy(np.array(
                                       tokens[:, i:i + 1])), i)
        want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, cj))
        got = jax.tree_util.tree_leaves(tt.cache_to_numpy(ct))
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
        carried = tt.cache_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
        lj, _ = step(pj, cj, tokens[:, :1], jnp.int32(3))
        lt, _ = tt.decode_step(pt, tcfg, carried,
                               torch.from_numpy(np.array(tokens[:, :1])), 3)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=REF_TOL, atol=REF_TOL)
