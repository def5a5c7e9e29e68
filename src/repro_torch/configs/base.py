"""Config system: model architecture + input-shape + run configs.

Every assigned architecture is a frozen `ModelCfg` in its own module under
repro_torch.configs; `repro_torch.configs.registry` maps ``--arch <id>`` to
it.  Shape cells (`ShapeCfg`) are shared across LM archs per the
assignment.  The same dataclasses and values as the JAX package's
`repro.configs` (plain Python, no framework): a config compares equal
field for field with its counterpart there.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional



@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # shared experts (Kimi K2 style)
    every: int = 1               # MoE every k-th layer (Jamba: 2)
    first_dense: int = 0         # leading dense layers (Kimi K2: 1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    """Mamba/attention interleave (Jamba: one attention layer per 8)."""
    period: int = 8
    attn_index: int = 4          # position of the attention layer in a period
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64         # low-rank data-dependent decay proj


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int
    enc_seq: int = 1500          # whisper 30 s @ 50 Hz after conv stub


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    attn_type: Literal["full", "local_global"] = "full"
    window: int = 4096
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_kind: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    moe: Optional[MoECfg] = None
    hybrid: Optional[HybridCfg] = None
    rwkv: Optional[RWKVCfg] = None
    enc_dec: Optional[EncDecCfg] = None
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False    # gemma: embed * sqrt(d_model)
    post_norms: bool = False     # gemma2: sandwich (pre+post) layer norms
    dtype: str = "bfloat16"
    remat: bool = True
    # derived -----------------------------------------------------------
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attn_free(self) -> bool:
        return self.rwkv is not None

    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.hd()
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * hd * (self.num_heads + 2 * self.num_kv_heads) + \
            self.num_heads * hd * D
        dense_mlp = 3 * D * F

        def layer_mlp(i: int) -> int:
            if self.moe and i >= self.moe.first_dense and \
                    (i % self.moe.every == (self.moe.every - 1)):
                e = self.moe
                return (e.num_experts + e.num_shared) * 3 * D * e.d_ff_expert \
                    + D * e.num_experts
            return dense_mlp

        total = emb
        for i in range(L):
            if self.hybrid and (i % self.hybrid.period) != self.hybrid.attn_index:
                d_in = self.hybrid.expand * D
                total += 2 * D * d_in + d_in * D + \
                    d_in * (2 * self.hybrid.d_state + 2)  # proj + ssm
            elif self.rwkv:
                total += 6 * D * D  # r,k,v,g,w,o (approx)
            else:
                total += attn
            total += layer_mlp(i)
        if self.enc_dec:
            total += self.enc_dec.enc_layers * (attn + dense_mlp)
            total += L * attn  # cross attention
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE counts top_k + shared experts)."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        full = self.param_count()
        n_moe_layers = sum(
            1 for i in range(self.num_layers)
            if i >= e.first_dense and (i % e.every == (e.every - 1)))
        all_exp = n_moe_layers * e.num_experts * 3 * self.d_model * e.d_ff_expert
        act_exp = n_moe_layers * (e.top_k + e.num_shared) * 3 * \
            self.d_model * e.d_ff_expert
        return full - all_exp + act_exp


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


LM_SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelCfg, shape: ShapeCfg) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


def reduced(cfg: ModelCfg, **overrides) -> ModelCfg:
    """Tiny same-family config for CPU smoke tests."""
    moe = cfg.moe and MoECfg(
        num_experts=min(cfg.moe.num_experts, 4),
        top_k=min(cfg.moe.top_k, 2),
        d_ff_expert=64,
        num_shared=min(cfg.moe.num_shared, 1),
        every=cfg.moe.every,
        first_dense=min(cfg.moe.first_dense, 1),
    )
    hybrid = cfg.hybrid and HybridCfg(
        period=cfg.hybrid.period, attn_index=cfg.hybrid.attn_index,
        d_state=8, d_conv=4, expand=2)
    enc_dec = cfg.enc_dec and EncDecCfg(enc_layers=2, enc_seq=16)
    base = dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=cfg.hybrid.period if cfg.hybrid else
        (4 if not cfg.moe else max(2, 1 + (cfg.moe.first_dense > 0))),
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        window=64,
        mrope_sections=(4, 6, 6),  # scaled to the reduced head_dim (32)
        moe=moe,
        hybrid=hybrid,
        enc_dec=enc_dec,
        dtype="float32",
        remat=False,
    )
    return dataclasses.replace(base, **overrides) if overrides else base
