"""Whisper-style encoder-decoder (audio family).

The port of `repro.models.whisper`.  The conv / mel frontend is a stub:
precomputed frame embeddings (B, enc_seq, D) feed the encoder directly,
a bidirectional transformer with learned positions.  The decoder adds
cross-attention to every layer.  The encoder and decoder are *lists* of
per-layer dicts (not stacked), as in the reference.  Decode caches both
the self-attention K/V (written in place) and the static encoder K/V,
which `attention.cross_kv` fills once a request.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (cross_entropy, dense_init, dtype_of,
                                       gelu_tanh, init_mlp, init_norm, mlp,
                                       rms_norm, unembed)


def _init_block(gen: torch.Generator, cfg: ModelCfg, cross: bool) -> dict:
    dtype = dtype_of(cfg)
    p = {
        "norm1": init_norm(cfg.d_model, device=gen.device),
        "attn": attn_mod.init_attention(gen, cfg, dtype),
        "norm2": init_norm(cfg.d_model, device=gen.device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }
    if cross:
        p["norm_x"] = init_norm(cfg.d_model, device=gen.device)
        p["xattn"] = attn_mod.init_attention(gen, cfg, dtype)
    return p


def init_encdec(gen: torch.Generator, cfg: ModelCfg) -> dict:
    """Parameters drawn on ``gen``'s device, in the reference's tree."""
    ed = cfg.enc_dec
    dtype = dtype_of(cfg)
    return {
        "tok_embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), 0,
                                dtype),
        "pos_embed": dense_init(gen, (4096, cfg.d_model), 0, dtype),
        "enc_pos_embed": dense_init(gen, (ed.enc_seq, cfg.d_model), 0,
                                    dtype),
        "encoder": [_init_block(gen, cfg, cross=False)
                    for _ in range(ed.enc_layers)],
        "decoder": [_init_block(gen, cfg, cross=True)
                    for _ in range(cfg.num_layers)],
        "enc_norm": init_norm(cfg.d_model, device=gen.device),
        "final_norm": init_norm(cfg.d_model, device=gen.device),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def encode(params: dict, cfg: ModelCfg, enc_embeds: torch.Tensor
           ) -> torch.Tensor:
    """enc_embeds: (B, enc_seq, D) precomputed frame embeddings (stub)."""
    B, S, _ = enc_embeds.shape
    x = enc_embeds.to(dtype_of(cfg)) + params["enc_pos_embed"][None, :S]
    positions = _positions(B, S, x.device)
    for p in params["encoder"]:
        h, _ = attn_mod.attention(p["attn"], cfg,
                                  rms_norm(x, p["norm1"], cfg.norm_eps),
                                  positions, causal=False)
        x = x + h
        x = x + mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                    act=gelu_tanh)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
            enc_embeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decoder pass.  Returns (logits (B, S, V) f32,
    aux = 0)."""
    enc_out = encode(params, cfg, enc_embeds)
    B, S = tokens.shape
    # learned positions wrap past the table size (whisper's real context
    # is 448)
    table = params["pos_embed"]
    pe = table[torch.arange(S, device=tokens.device) % table.shape[0]]
    x = params["tok_embed"][tokens] + pe[None]
    positions = _positions(B, S, x.device)
    for p in params["decoder"]:
        h, _ = attn_mod.attention(p["attn"], cfg,
                                  rms_norm(x, p["norm1"], cfg.norm_eps),
                                  positions, causal=True)
        x = x + h
        kv = attn_mod.cross_kv(p["xattn"], cfg, enc_out)
        h, _ = attn_mod.attention(p["xattn"], cfg,
                                  rms_norm(x, p["norm_x"], cfg.norm_eps),
                                  positions, kv=kv)
        x = x + h
        x = x + mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                    act=gelu_tanh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def encdec_loss(params: dict, cfg: ModelCfg, batch: dict) -> torch.Tensor:
    """The full cross-entropy of the teacher-forced logits (the reference
    does not chunk it here)."""
    logits, _ = forward(params, cfg, batch["tokens"],
                        batch["frontend_embeds"])
    return cross_entropy(logits, batch["labels"])


def init_cache(cfg: ModelCfg, batch: int, max_seq: int,
               device="cuda") -> dict:
    """Self-attention K/V per decoder layer (``self``) + the static encoder
    K/V per layer (``cross``), zero, in the parameter dtype."""
    dtype = dtype_of(cfg)
    hd, kv, es = cfg.hd(), cfg.num_kv_heads, cfg.enc_dec.enc_seq

    def pair(S):
        return {"k": torch.zeros((batch, S, kv, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, S, kv, hd), dtype=dtype,
                                 device=device)}
    return {"self": [pair(max_seq) for _ in range(cfg.num_layers)],
            "cross": [pair(es) for _ in range(cfg.num_layers)]}


def decode_step(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                pos: int, cache: dict) -> tuple[torch.Tensor, dict]:
    """One decoder token against the cache: logits (B, 1, V); the token's
    self-attention K/V are written in place, ``cross`` is read only; the
    same cache is returned."""
    table = params["pos_embed"]
    x = params["tok_embed"][tokens] + table[pos % table.shape[0]][None, None]
    for p, cs, cx in zip(params["decoder"], cache["self"], cache["cross"]):
        h, _, _ = attn_mod.decode_attention(
            p["attn"], cfg, rms_norm(x, p["norm1"], cfg.norm_eps), cs["k"],
            cs["v"], pos)
        x = x + h
        h, _, _ = attn_mod.decode_attention(
            p["xattn"], cfg, rms_norm(x, p["norm_x"], cfg.norm_eps),
            cx["k"], cx["v"], pos, cross=True)
        x = x + h
        x = x + mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                    act=gelu_tanh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache
