"""Config system: model / shape / run configs + TP-divisibility resolution
(reference: ``repro/configs/base.py``; ``compute_dtype`` is a torch dtype).

``ModelConfig`` captures every assigned architecture with one dataclass; the
block pattern (dense attention / MoE / Mamba2 / RWKV6 / enc-dec) is selected
per-layer by ``block_pattern()``. ``resolve_for_mesh()`` applies the padding
policy of DESIGN.md §5 (q-heads -> multiple of TP, kv-heads -> divisor of TP
then replicate, vocab -> multiple of TP*128, experts -> multiple of TP) and
records the padding so the roofline can report useful-FLOP ratios.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


# The four assigned input-shape sets (LM transformer shapes).
SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int              # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    norm: str = "rmsnorm"
    act: str = "swiglu"       # swiglu | gelu
    rope_theta: float = 1e6
    tie_embeddings: bool = False

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_ff: int = 0        # fused shared-expert FFN width
    moe_every: int = 1            # MoE block every k layers (else dense)
    capacity_factor: float = 1.25

    # SSM (Mamba2 for hybrid, RWKV6 for ssm family)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0           # hybrid: shared attn block every k layers
    moe_groups: int = 0           # >1: per-dp-shard grouped dispatch (§Perf)
    kv_cache_quant: str = "none"  # none | int8 (§Perf: decode memory term)

    # enc-dec (audio family)
    enc_layers: int = 0
    dec_layers: int = 0
    frontend_dim: int = 0         # stub modality frontend feature width
    frontend_len: int = 0         # stub frontend sequence (frames / patches)

    # quantization (the paper's technique as an LM feature)
    quant: str = "none"           # none | bitgnn (bit-packed binary linears)

    # numerics
    dtype: str = "bfloat16"

    # --- resolved-for-mesh fields (filled by resolve_for_mesh) -------------
    tp: int = 1
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0
    kv_replication: int = 1
    vocab_padded: int = 0
    moe_experts_padded: int = 0
    ssm_heads_padded: int = 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def block_pattern(self) -> Sequence[str]:
        """Per-layer block kinds for the decoder stack."""
        if self.family == "ssm":
            return ("rwkv",) * self.n_layers
        if self.family == "hybrid":
            # Zamba2: Mamba2 backbone + ONE weight-tied shared attention
            # block invoked every `attn_every` layers.
            out = []
            for i in range(self.n_layers):
                out.append("mamba_attn" if self.attn_every and
                           (i + 1) % self.attn_every == 0 else "mamba")
            return tuple(out)
        if self.family == "moe":
            return tuple("moe" if (i + 1) % self.moe_every == 0 else "dense"
                         for i in range(self.n_layers))
        return ("dense",) * self.n_layers

    def resolve_for_mesh(self, tp: int) -> "ModelConfig":
        """Apply the TP padding policy; returns a new resolved config."""
        hp = _ceil_mult(self.n_heads, tp) if self.n_heads else 0
        if self.n_kv_heads:
            kvp = _pad_to_divisor_or_multiple(self.n_kv_heads, tp)
            kv_rep = max(1, tp // kvp) if kvp < tp else 1
        else:
            kvp, kv_rep = 0, 1
        vp = _ceil_mult(self.vocab, tp * 128)
        ep = _ceil_mult(self.moe_experts, tp) if self.moe_experts else 0
        sp = _ceil_mult(self.ssm_heads, tp) if self.ssm_state else 0
        return dataclasses.replace(
            self, tp=tp, n_heads_padded=hp, n_kv_heads_padded=kvp,
            kv_replication=kv_rep, vocab_padded=vp, moe_experts_padded=ep,
            ssm_heads_padded=sp)

    # ---------------- analytic parameter/FLOP accounting --------------------

    def param_count(self, padded: bool = False) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        v = self.vocab_padded if (padded and self.vocab_padded) else self.vocab
        h = (self.n_heads_padded if (padded and self.n_heads_padded)
             else self.n_heads)
        kv = (self.n_kv_heads_padded if (padded and self.n_kv_heads_padded)
              else self.n_kv_heads)
        e = (self.moe_experts_padded if (padded and self.moe_experts_padded)
             else self.moe_experts)
        total = v * d                              # embedding
        if not self.tie_embeddings:
            total += v * d                         # lm head
        ff_mult = 3 if self.act == "swiglu" else 2

        def attn_params():
            return d * (h + 2 * kv) * self.head_dim + h * self.head_dim * d

        def mlp_params(ff):
            return ff_mult * d * ff

        for kind in self.block_pattern():
            if kind == "dense":
                total += attn_params() + mlp_params(self.d_ff)
            elif kind == "moe":
                total += attn_params() + e * mlp_params(self.d_ff)
                total += d * e                     # router
                if self.moe_shared_ff:
                    total += mlp_params(self.moe_shared_ff)
            elif kind in ("mamba", "mamba_attn"):
                di, ns = self.d_inner, self.ssm_state
                nh = self.ssm_heads
                total += d * (2 * di + 2 * ns + nh) + di * d + 4 * (di + 2 * ns)
                if kind == "mamba_attn":
                    pass  # shared (weight-tied) attn counted once below
            elif kind == "rwkv":
                total += 4 * d * d                 # r,k,v,out time-mix
                total += d * (self.d_ff) + self.d_ff * d + d * d  # channel mix
                total += 6 * d + 2 * (d * 32 + 32 * d)  # decay lora etc.
        if self.family == "hybrid" and self.attn_every:
            total += attn_params() + mlp_params(self.d_ff)  # ONE shared block
        if self.is_encdec:
            # encoder blocks + cross attention in decoder
            total += self.enc_layers * (attn_params() + mlp_params(self.d_ff))
            total += self.dec_layers * attn_params()        # cross attn
            total += self.frontend_dim * d                  # frontend proj
        if self.family == "vlm":
            total += self.frontend_dim * d + d * d          # projector MLP
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.moe_experts:
            return self.param_count()
        d = self.d_model
        ff_mult = 3 if self.act == "swiglu" else 2
        inactive = ((self.moe_experts - self.moe_top_k)
                    * ff_mult * d * self.d_ff
                    * sum(1 for k in self.block_pattern() if k == "moe"))
        return int(self.param_count() - inactive)


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_to_divisor_or_multiple(kv: int, tp: int) -> int:
    """Smallest k >= kv with tp % k == 0 or k % tp == 0."""
    k = kv
    while not (tp % k == 0 or k % tp == 0):
        k += 1
    return k
