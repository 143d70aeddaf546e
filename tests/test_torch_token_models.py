"""The port's LM blocks and models (``repro_torch.models.{layers, moe,
transformer}``) against the reference's (``repro.models``), the port on
the CPU, on ``reduced_config`` of each of the 10 archs.

The reference's parameters are carried across (``params_from_numpy``: bf16
bits kept), so both packages compute on the same weights and inputs.
Tolerances:

* fp32 replicas of the configs (``dataclasses.replace(cfg,
  dtype="float32")``): rtol = atol = 1e-4;
* bf16: rtol = atol = 0.05; for the SSM archs (rwkv6, the zamba2 hybrid)
  0.15, because both packages sit as far from the fp32 replica as from each
  other there (ROADMAP Queue 3: XLA fuses their bf16 elementwise chains and
  rounds once, torch rounds every op), which the test also holds: the
  port's distance to the fp32 replica is at most 1.5x the reference's;
* the port's own ``decode_step`` against its ``forward``: the reference's
  rule, rtol = atol = 0.15 (``tests/test_arch_smoke.py``; not vlm).

The reference's models run under ``jax.jit`` (faster than eager dispatch;
jit logits differ from eager ones by ~1e-6, far inside these tolerances).
"""
import dataclasses

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
torch = lazy("torch")
tconf = lazy("repro_torch.configs")
tl = lazy("repro_torch.models.layers")
tmoe = lazy("repro_torch.models.moe")
tt = lazy("repro_torch.models.transformer")

jax.config.update("jax_platform_name", "cpu")

FP32_TOL = 1e-4
BF16_TOL = 0.05
SSM_BF16_TOL = 0.15
DECODE_TOL = 0.15
SSM_ARCHS = ("rwkv6-3b", "zamba2-1.2b")
B = 2


def _cfgs(arch, dtype="bfloat16", **kw):
    """(reference config, port config) of ``arch``, reduced."""
    j = reduced_config(get_config(arch)).resolve_for_mesh(tp=1)
    t = tconf.reduced_config(tconf.get_config(arch)).resolve_for_mesh(tp=1)
    return (dataclasses.replace(j, dtype=dtype, **kw),
            dataclasses.replace(t, dtype=dtype, **kw))


def _port(tree):
    return tt.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _to32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


def _rand(seed, shape, scale=1.0, dtype=jnp.float32):
    return (jax.random.normal(jax.random.PRNGKey(seed), shape) * scale
            ).astype(dtype)


def test_primitives_match_reference():
    """rmsnorm, layernorm (population variance), rope, both MLPs (gelu is
    jax's tanh form), embed and a padded lm_head, in fp32 and bf16."""
    for dtype, tol in ((jnp.float32, 1e-5), (jnp.bfloat16, BF16_TOL)):
        _primitives(dtype, tol)


def _primitives(dtype, tol):
    x = _rand(0, (B, 5, 64), dtype=dtype)
    s, b = _rand(1, (64,), dtype=dtype), _rand(2, (64,), dtype=dtype)
    xt, st, bt = (tt.params_from_numpy(np.asarray(a), "cpu")
                  for a in (x, s, b))
    _close(tl.rmsnorm(xt, st), jl.rmsnorm(x, s), tol)
    _close(tl.layernorm(xt, st, bt), jl.layernorm(x, s, b), tol)
    pos = jnp.broadcast_to(jnp.arange(5) + 3, (B, 5))
    q = _rand(3, (B, 5, 4, 32), dtype=dtype)
    _close(tl.rope(tt.params_from_numpy(np.asarray(q), "cpu"),
                   torch.from_numpy(np.array(pos)), 1e4),
           jl.rope(q, pos, 1e4), tol)
    for act, ff_in in (("swiglu", 192), ("gelu", 96)):
        mp = {"wi": _rand(4, (64, ff_in), 0.1, dtype),
              "wo": _rand(5, (96, 64), 0.1, dtype)}
        _close(tl.mlp_block(_port(mp), xt, act), jl.mlp_block(mp, x, act),
               tol)
    cfg, tcfg = _cfgs("smollm-135m")
    cfg, tcfg = cfg.resolve_for_mesh(tp=16), tcfg.resolve_for_mesh(tp=16)
    table = {"table": _rand(6, (cfg.vocab_padded, 64), 0.1, dtype)}
    tok = jax.random.randint(jax.random.PRNGKey(7), (B, 5), 0, cfg.vocab)
    e_j = jl.embed(table, tok)
    e_t = tl.embed(_port(table), torch.from_numpy(np.array(tok)))
    assert np.array_equal(_np(e_t), _np(e_j))
    assert cfg.vocab_padded > cfg.vocab
    _close(tl.lm_head(_port(table), e_t, cfg.vocab),
           jl.lm_head(table, e_j, cfg.vocab), tol)


@pytest.mark.parametrize("mode", ["prefill_chunked", "decode_clamped",
                                  "decode_int8_grouped"])
def test_attention_block_matches_reference(mode, monkeypatch):
    """Prefill (causal, q-chunked), decode into the fp cache (the last
    write's start past the end, clamped as ``dynamic_update_slice``
    clamps it), and the int8 cache with ``GQA_NO_REPEAT``: outputs and
    every cache leaf, fp32 replicas (GQA: 4 q heads over 2 kv heads)."""
    kw = {"kv_cache_quant": "int8"} if "int8" in mode else {}
    cfg, tcfg = _cfgs("smollm-135m", "float32", **kw)
    if "grouped" in mode:
        monkeypatch.setattr(jl, "GQA_NO_REPEAT", True)
        monkeypatch.setattr(tl, "GQA_NO_REPEAT", True)
    pj = jl.init_attention(jax.random.PRNGKey(0), cfg, jnp.float32)
    pt = _port(pj)
    if mode == "prefill_chunked":
        x = _rand(1, (B, 12, cfg.d_model))
        pos = jnp.broadcast_to(jnp.arange(12), (B, 12))
        want, _ = jl.attention_block(pj, x, pos, cfg, q_chunk=5)
        got, _ = tl.attention_block(pt, _port(x),
                                    torch.from_numpy(np.array(pos)), tcfg,
                                    q_chunk=5)
        _close(got, want, FP32_TOL)
        return
    s = 6
    cj = jt.init_cache(cfg, B, s)["layers"][0]
    ct = tt.init_cache(tcfg, B, s, device="cpu")["layers"][0]
    for i, p in enumerate((0, 1, 2, 4, 5, 9)):   # 9 clamps to 5
        x = _rand(10 + i, (B, 1, cfg.d_model))
        pos = jnp.full((B, 1), p, jnp.int32)
        want, cj = jl.attention_block(pj, x, pos, cfg, cache=cj,
                                      cache_pos=jnp.int32(p))
        got, ct = tl.attention_block(pt, _port(x),
                                     torch.full((B, 1), p), tcfg, cache=ct,
                                     cache_pos=p)
        _close(got, want, FP32_TOL)
    for k in cj:
        _close(ct[k], cj[k], FP32_TOL if cj[k].dtype != jnp.int8 else 0)


@pytest.mark.parametrize("groups", [0, 2])
def test_moe_block_matches_reference(groups):
    """Global sort dispatch and the grouped form, with top-2 of 4 experts,
    a shared expert and a capacity that drops tokens (factor 1.0); the
    port's combine adds in the reference's scatter order, and two calls
    are bit-equal."""
    cfg, tcfg = _cfgs("qwen2-moe-a2.7b", "float32", capacity_factor=1.0,
                      moe_groups=groups)
    pj = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    pt = _port(pj)
    x = _rand(1, (B, 12, cfg.d_model))
    want = jmoe.moe_block(pj, x, cfg)
    got = tmoe.moe_block(pt, _port(x), tcfg)
    _close(got, want, FP32_TOL)
    assert torch.equal(got, tmoe.moe_block(pt, _port(x), tcfg))
    # bf16: the same routing, rounding apart
    cfg, tcfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=1.0,
                      moe_groups=groups)
    pj = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    xb = x.astype(jnp.bfloat16)
    _close(tmoe.moe_block(_port(pj), _port(xb), tcfg),
           jmoe.moe_block(pj, xb, cfg), BF16_TOL)


def _inputs(cfg, t):
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    kw, t_text = {}, t
    if cfg.family == "vlm":
        t_text = max(t - cfg.frontend_len, 4)
        kw["image_embeds"] = jax.random.normal(
            ks[1], (B, cfg.frontend_len, cfg.frontend_dim), jnp.float32)
    if cfg.is_encdec:
        kw["frames"] = jax.random.normal(
            ks[2], (B, cfg.frontend_len, cfg.frontend_dim), jnp.float32)
    return jax.random.randint(ks[0], (B, t_text), 0, cfg.vocab), kw


def _reference(pj, cfg, tokens, kw, t):
    """The reference's forward logits and its decode_step logits of each
    step (None for vlm)."""
    full = jax.jit(lambda p, tok, kw: jt.forward(p, cfg, tok, **kw))(
        pj, tokens, kw)
    if cfg.family == "vlm":
        return full, None
    cache = jt.init_cache(cfg, B, t + 4, enc_len=cfg.frontend_len)
    if cfg.is_encdec:
        cache["enc_memory"] = jt._encode(pj, cfg, kw["frames"], q_chunk=0)
    step = jax.jit(lambda p, c, tok, pos: jt.decode_step(p, cfg, c, tok, pos))
    rows = []
    for i in range(t):
        lg, cache = step(pj, cache, tokens[:, i:i + 1], jnp.int32(i))
        rows.append(lg[:, 0])
    return full, jnp.stack(rows, axis=1)


def _port_run(pt, tcfg, tokens, kw, t):
    tok = torch.from_numpy(np.array(tokens))
    tkw = {k: torch.from_numpy(np.array(v)) for k, v in kw.items()}
    full = tt.forward(pt, tcfg, tok, **tkw)
    if tcfg.family == "vlm":
        return full, None
    cache = tt.init_cache(tcfg, B, t + 4, enc_len=tcfg.frontend_len,
                          device="cpu")
    if tcfg.is_encdec:
        cache["enc_memory"] = tt._encode(pt, tcfg, tkw["frames"], q_chunk=0)
    rows = []
    for i in range(t):
        lg, cache = tt.decode_step(pt, tcfg, cache, tok[:, i:i + 1], i)
        rows.append(lg[:, 0])
    return full, torch.stack(rows, dim=1)


ARCH_GROUPS = {
    "dense": ("smollm-135m", "stablelm-1.6b", "starcoder2-3b",
              "minitron-8b"),
    "moe": ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e"),
    "ssm": SSM_ARCHS,
    "multimodal": ("seamless-m4t-medium", "llava-next-34b"),
}


@pytest.mark.parametrize("group", sorted(ARCH_GROUPS))
def test_forward_and_decode_match_reference(group):
    """Every arch of the group: forward logits and each decode_step's
    logits against the reference's, in bf16 and on fp32 replicas, and the
    port's last decode logits against its forward's."""
    t = 8
    for arch in ARCH_GROUPS[group]:
        cfg, tcfg = _cfgs(arch)
        pj = jt.init_params(jax.random.PRNGKey(0), cfg)
        tokens, kw = _inputs(cfg, t)
        t_steps = tokens.shape[1]
        full_j, dec_j = _reference(pj, cfg, tokens, kw, t_steps)
        full_t, dec_t = _port_run(_port(pj), tcfg, tokens, kw, t_steps)
        assert tuple(full_t.shape) == full_j.shape
        assert np.isfinite(_np(full_t)).all()
        tol = SSM_BF16_TOL if arch in SSM_ARCHS else BF16_TOL
        _close(full_t, full_j, tol)
        if dec_j is not None:
            _close(dec_t, dec_j, tol)
            _close(dec_t[:, -1], full_t[:, -1], DECODE_TOL)
        # fp32 replicas of the same weights
        c32, t32 = _cfgs(arch, "float32")
        p32 = _to32(pj)
        f32_j, d32_j = _reference(p32, c32, tokens, kw, t_steps)
        f32_t, d32_t = _port_run(_port(p32), t32, tokens, kw, t_steps)
        _close(f32_t, f32_j, FP32_TOL)
        if d32_j is not None:
            _close(d32_t, d32_j, FP32_TOL)
        if arch in SSM_ARCHS:   # as far from fp32 as the reference is
            ref = np.abs(_np(full_j) - _np(f32_j)).max()
            port = np.abs(_np(full_t) - _np(f32_j)).max()
            assert port <= 1.5 * ref, (arch, port, ref)


def _tree_spec(tree):
    """(path, shape, dtype name) of every leaf, torch or jax."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, tuple(node.shape),
                        str(node.dtype).replace("torch.", "")))
    walk(tree, ())
    return out


def test_init_params_and_cache_trees_match_reference():
    """``init_params(cfg, generator, device)`` and ``init_cache`` give the
    reference's trees: the same paths, shapes and dtypes, for every arch
    (bf16 and its int8 KV cache)."""
    for arch in sorted(ARCHS):
        cfg, tcfg = _cfgs(arch)
        pj = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                   cfg))
        gen = torch.Generator().manual_seed(0)
        assert _tree_spec(tt.init_params(tcfg, gen, "cpu")) == \
            _tree_spec(pj), arch
        for kw in ({}, {"kv_cache_quant": "int8"}):
            c, tc_ = _cfgs(arch, **kw)
            want = jt.init_cache(c, B, 16, enc_len=c.frontend_len)
            got = tt.init_cache(tc_, B, 16, enc_len=tc_.frontend_len,
                                device="cpu")
            assert _tree_spec(got) == _tree_spec(want), (arch, kw)


def test_unsupported_options_raise():
    """The options that act on a mesh leave a one-device forward as it
    is: ``moe_groups=-1`` without a mesh with a ``model`` dim is the
    global dispatch (``moe_groups=0``) bit for bit, as in the reference
    (its expert-parallel form is held in ``tests/test_torch_mesh_train.py``);
    ``block_remat`` (since LM training) computes the plain forward, and
    the sharding arguments (since the dry run) leave plain tensors as they
    are."""
    cfg, tcfg = _cfgs("qwen2-moe-a2.7b", "float32")
    pt = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    assert torch.equal(tt.forward(pt, tcfg, tok, block_remat=True),
                       tt.forward(pt, tcfg, tok))
    from torch.distributed.tensor import Replicate, Shard
    assert torch.equal(tt.forward(pt, tcfg, tok, boundary_sharding=[Shard(0)],
                                  logits_sharding=[Replicate()]),
                       tt.forward(pt, tcfg, tok))
    assert torch.equal(
        tt.forward(pt, dataclasses.replace(tcfg, moe_groups=-1), tok),
        tt.forward(pt, dataclasses.replace(tcfg, moe_groups=0), tok))
    pj = jt.init_params(jax.random.PRNGKey(0), cfg)
    tj = jnp.zeros((1, 4), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(jt.forward(pj, dataclasses.replace(cfg, moe_groups=-1),
                              tj)),
        np.asarray(jt.forward(pj, dataclasses.replace(cfg, moe_groups=0),
                              tj)))
    # unroll=False computes what the unrolled forward computes
    assert torch.equal(tt.forward(pt, tcfg, tok, unroll=False),
                       tt.forward(pt, tcfg, tok))
