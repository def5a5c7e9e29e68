"""GQA attention: full / sliding-window, softcap, QKV bias, RoPE / M-RoPE.

The port of `repro.models.attention` for decoder-only prefill and decode.
Two paths for a full sequence, as in the reference:
  * direct — materializes (B, H, S, S) scores; sequences up to
    `DIRECT_MAX_SEQ`;
  * flash  — `models.flash.flash_attention` (running softmax, triangular
    schedule) above it.

The decode path writes the new K/V at ``pos`` into the cache in place and
attends one query against the whole cache, O(S·d) a token.

Dtypes follow the reference step for step: the direct and decode scores
are the QK product in the parameter dtype (rounded to it), then scaled in
float32 and softcapped; the probabilities are cast to the value dtype
before the PV product.  Cross-attention (Whisper): `cross_kv` projects
the encoder's K/V once; ``attention(kv=...)`` projects the queries only,
never causal, and ``decode_attention(cross=True)`` attends one query
against the whole cached encoder K/V, writing nothing.  The reference's
scan baseline (``_attend_chunked``) is not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import flash as flash_mod
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init
from repro_torch.models.layers import softcap as softcap_fn

NEG_INF = -2.0e38
DIRECT_MAX_SEQ = 2048  # direct path above this switches to flash


def init_attention(gen, cfg: ModelCfg, dtype, lead=()) -> dict:
    hd = cfg.hd()
    p = {
        "wq": dense_init(gen, (cfg.d_model, cfg.num_heads, hd), 0, dtype,
                         lead),
        "wk": dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd), 0, dtype,
                         lead),
        "wv": dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd), 0, dtype,
                         lead),
        "wo": dense_init(gen, (cfg.num_heads, hd, cfg.d_model), 1, dtype,
                         lead),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros(tuple(lead) + (heads, hd), dtype=dtype,
                                  device=gen.device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).unflatten(-1, (H, hd))


def _project_qkv(params, cfg: ModelCfg, x, positions):
    """positions: (B, S), or (3, B, S) for M-RoPE."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.rope_kind == "rope":
        pos2 = positions if positions.ndim == 2 else positions[0]
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(Sq, Sk) additive float32 mask."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF)


def _scores(q, k, cfg: ModelCfg, scale):
    """q: (B, Sq, KV, G, hd)  k: (B, Sk, KV, hd) -> f32 (B, KV, G, Sq, Sk).

    The product is rounded to the parameter dtype, then scaled in float32
    (the reference multiplies a bf16 product by a float64 numpy scale,
    which promotes to float32) and softcapped."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    return softcap_fn(s, cfg.attn_softcap)


def _attend_direct(q, k, v, cfg, scale, q_pos, k_pos, causal, window):
    B, Sq, H, hd = q.shape
    KV = cfg.num_kv_heads
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = _scores(qg, k, cfg, scale)
    s = s + _mask_bias(q_pos, k_pos, causal, window)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(B, Sq, H, hd)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    H, hd, D = wo.shape
    return o.flatten(-2) @ wo.reshape(H * hd, D)


def attention(
    params: dict,
    cfg: ModelCfg,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    return_kv: bool = False,
):
    """Full-sequence attention (prefill / forward / encoder / cross).

    ``kv``: cross-attention against precomputed K/V (`cross_kv`): the
    queries only are projected (no rotary embedding), and the mask is not
    causal.  Returns ``(out, (k, v))`` when return_kv (prefill cache
    fill), else ``(out, None)``.
    """
    S = x.shape[1]
    scale = 1.0 / math.sqrt(cfg.hd())
    if kv is not None:
        q = _q_only(params, cfg, x)
        k, v = kv
        causal = False
    else:
        q, k, v = _project_qkv(params, cfg, x, positions)
    if max(S, k.shape[1]) <= DIRECT_MAX_SEQ:
        q_pos = torch.arange(S, device=x.device)
        k_pos = torch.arange(k.shape[1], device=x.device)
        o = _attend_direct(q, k, v, cfg, scale, q_pos, k_pos, causal,
                           window)
    else:
        o = flash_mod.flash_attention(
            q, k, v, num_kv_heads=cfg.num_kv_heads, scale=scale,
            softcap=cfg.attn_softcap, causal=causal, window=window)
    out = _out(o, params["wo"])
    return out, ((k, v) if return_kv else None)


def cross_kv(params: dict, cfg: ModelCfg, enc_out: torch.Tensor):
    """The encoder's K/V for cross-attention (cached once a request)."""
    k = _proj(enc_out, params["wk"])
    v = _proj(enc_out, params["wv"])
    if cfg.qkv_bias:
        k, v = k + params["bk"], v + params["bv"]
    return k, v


def _q_only(params, cfg: ModelCfg, x):
    q = _proj(x, params["wq"])
    return q + params["bq"] if cfg.qkv_bias else q


def decode_attention(
    params: dict,
    cfg: ModelCfg,
    x: torch.Tensor,              # (B, 1, D)
    cache_k: torch.Tensor,        # (B, S, KV, hd), written in place
    cache_v: torch.Tensor,
    pos: int,                     # write/attend position
    *,
    window: Optional[int] = None,
    cross: bool = False,
):
    """One-token decode against a KV cache.

    Writes the token's K/V at ``pos`` into ``cache_k`` / ``cache_v`` (in
    place) and returns (out (B, 1, D), cache_k, cache_v).  With
    ``cross=True`` the cache is the (static) encoder K/V: the query alone
    is projected, nothing is written and every key is attended."""
    B = x.shape[0]
    hd = cfg.hd()
    KV = cfg.num_kv_heads
    scale = 1.0 / math.sqrt(hd)

    if cross:
        q = _q_only(params, cfg, x)
    else:
        lead = (3, B, 1) if cfg.rope_kind == "mrope" else (B, 1)
        posn = torch.full(lead, pos, dtype=torch.int32, device=x.device)
        q, k_new, v_new = _project_qkv(params, cfg, x, posn)
        cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)

    S = cache_k.shape[1]
    qg = q.reshape(B, 1, KV, cfg.num_heads // KV, hd)
    s = _scores(qg, cache_k, cfg, scale)[:, :, :, 0, :]   # (B, KV, G, S)
    if not cross:
        k_pos = torch.arange(S, device=x.device)
        ok = k_pos <= pos
        if window is not None:
            ok &= (pos - k_pos) < window
        s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(cache_v.dtype), cache_v)
    out = _out(o.reshape(B, 1, cfg.num_heads, hd), params["wo"])
    return out, cache_k, cache_v
