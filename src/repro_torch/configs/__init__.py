"""Architecture registry: the 10 assigned configs (reference:
``repro/configs/__init__.py``)."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig, ShapeConfig, SHAPES

# --- assigned architectures (exact figures from the task sheet) -------------

llava_next_34b = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, head_dim=128,
    act="swiglu", frontend_dim=1024, frontend_len=2880)

minitron_8b = ModelConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=16384, vocab=256000, head_dim=128,
    act="swiglu")

starcoder2_3b = ModelConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152, head_dim=128,
    act="gelu")

stablelm_1_6b = ModelConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352, head_dim=64,
    act="swiglu")

smollm_135m = ModelConfig(
    name="smollm-135m", family="dense", n_layers=30, d_model=576,
    n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49152, head_dim=64,
    act="swiglu", tie_embeddings=True)

zamba2_1_2b = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, head_dim=64,
    act="swiglu", ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6)

qwen2_moe_a2_7b = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151936, head_dim=128,
    act="swiglu", moe_experts=60, moe_top_k=4, moe_shared_ff=5632,
    moe_every=1)

llama4_scout_17b_a16e = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
    act="swiglu", moe_experts=16, moe_top_k=1, moe_shared_ff=8192,
    moe_every=1)

seamless_m4t_medium = ModelConfig(
    name="seamless-m4t-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206, head_dim=64,
    act="gelu", enc_layers=12, dec_layers=12, frontend_dim=1024,
    frontend_len=1600)

rwkv6_3b = ModelConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=8960, vocab=65536, head_dim=64,
    ssm_state=64, ssm_head_dim=64)


ARCHS = {c.name: c for c in [
    llava_next_34b, minitron_8b, starcoder2_3b, stablelm_1_6b, smollm_135m,
    zamba2_1_2b, qwen2_moe_a2_7b, llama4_scout_17b_a16e, seamless_m4t_medium,
    rwkv6_3b]}

# shapes each arch actually runs (long_500k: sub-quadratic decode only)
LONG_CONTEXT_ARCHS = ("zamba2-1.2b", "rwkv6-3b")


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def shapes_for(name: str):
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if name in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.attn_every else 4),
        d_model=128, d_ff=256, vocab=512, head_dim=32,
        frontend_dim=64 if cfg.frontend_dim else 0,
        frontend_len=8 if cfg.frontend_len else 0,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2))
    if cfg.moe_experts:
        # capacity_factor large enough that the tiny expert count never drops
        # tokens: capacity drops are batch-composition-dependent, so they
        # break prefill-by-decode vs. parallel-forward parity at smoke scale
        # (16 tokens over 4 experts bind at the default 1.25).
        kw.update(moe_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                  moe_shared_ff=64 if cfg.moe_shared_ff else 0,
                  capacity_factor=8.0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=32)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.enc_layers:
        kw.update(enc_layers=2, dec_layers=2)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "shapes_for", "reduced_config", "LONG_CONTEXT_ARCHS"]
