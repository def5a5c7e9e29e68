"""Whisper-style encoder-decoder (audio family).

The port of `repro.models.whisper`.  The conv / mel frontend is a stub:
precomputed frame embeddings (B, enc_seq, D) feed the encoder directly,
a bidirectional transformer with learned positions.  The decoder adds
cross-attention to every layer.  The encoder and decoder are *lists* of
per-layer dicts (not stacked), as in the reference.  Decode caches both
the self-attention K/V (written in place) and the static encoder K/V,
which `attention.cross_kv` fills once a request (`fill_cross`).

On a rank mesh (`models.sharding`) the encoder's and the decoder's
attention and GELU MLPs are tensor parallel as the dense model's (the
heads and d_ff split over "model" where they divide it, else whole and
no partial sum to add), cross-attention's K/V are the rank's KV heads,
and the tied embedding is vocabulary-parallel where the vocabulary
divides the model axis (whisper-tiny's 51,865 does not: it is whole, and
the embedding, the unembedding and the cross-entropy run whole on every
model rank).  Every site asks the specs (`shd.split_axes`).  The self
and cross caches are split by position over "model" (``kv_seq``), and a
decode step attends them gathered (`attention.decode_attention`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import attention as attn_mod
from repro_torch.models import sharding as shd
from repro_torch.models.layers import (dense_init, dtype_of, embed,
                                       gelu_tanh, init_mlp, init_norm, mlp,
                                       rms_norm, token_nll, unembed,
                                       vocab_layout)


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
    x = (enc_embeds.to(dtype_of(cfg))
         + shd.local(params["enc_pos_embed"])[None, :S])
    x = shd.constrain(x, ("batch", "seq", None))
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
    table = shd.local(params["pos_embed"])
    pe = table[torch.arange(S, device=tokens.device) % table.shape[0]]
    x = embed(cfg, params, tokens) + pe[None]
    x = shd.constrain(x, ("batch", "seq", None))
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
    does not chunk it here): the mean over every position, of the whole
    batch where the batch's ranks hold blocks of it."""
    logits, _ = forward(params, cfg, batch["tokens"],
                        batch["frontend_embeds"])
    nll = token_nll(logits, batch["labels"], *vocab_layout(cfg, params))
    return shd.psum(torch.sum(nll) / (nll.numel() * shd.batch_split()),
                    shd.batch_axes())


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


def fill_cross(params: dict, cfg: ModelCfg, enc_embeds: torch.Tensor,
               cache: dict) -> dict:
    """Encode the frames and write every decoder layer's cross K/V
    (`attention.cross_kv`) into ``cache["cross"]`` in place; on a rank
    mesh the cache's block (its positions, every KV head) of the rank's
    KV heads, moved by `constrain`.  Returns the cache."""
    enc = encode(params, cfg, enc_embeds)
    for p, cx in zip(params["decoder"], cache["cross"]):
        # the KV heads as the projection holds them (whole where the
        # model axis does not divide them)
        held = ("batch", "seq",
                "kv_heads" if shd.split_axes(p["xattn"]["wk"], -2) else None,
                None)
        for name, t in zip(("k", "v"), attn_mod.cross_kv(p["xattn"], cfg,
                                                         enc)):
            if shd.is_dtensor(cx[name]):
                t = shd.constrain(t, ("batch", "kv_seq", "kv_heads", None),
                                  held=held)
            shd.local_block(cx[name]).copy_(t)
    return cache


def decode_step(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
                pos: int, cache: dict) -> tuple[torch.Tensor, dict]:
    """One decoder token against the cache: logits (B, 1, V); the token's
    self-attention K/V are written in place, ``cross`` is read only; the
    same cache is returned."""
    table = shd.local(params["pos_embed"])
    x = embed(cfg, params, tokens) + table[pos % table.shape[0]][None, None]
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
