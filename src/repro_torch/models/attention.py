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

On a rank mesh (`models.sharding`) the heads are tensor-parallel: the
Q/K/V projections are column-parallel over "heads" / "kv_heads", the
output projection row-parallel (its partial sums summed at a
`constrain`); cross-attention's queries and its encoder K/V
(`cross_kv`) are column-parallel alike.  Where the rules split the query
heads over "model" but leave the KV heads whole (a KV head count the axis
does not divide: 8 KV heads on a 16-way axis), every model rank projects
every KV head from its whole input, as the reference's partitioner does,
and its query heads [lo, lo + Hl) attend KV heads h // G (`kv_for_rank`:
a slice where the block is aligned to the groups, else one KV head a
query head).  Each rank's gradient of the whole K/V weights then covers
only the heads its queries used, and is summed over the query heads'
axes (`_kv_local`); the K/V path's part of the input's gradient stays
partial on each rank and is summed once with the queries' (`psum_grad`
on the input).  With
``REPRO_SEQ_SHARD_ATTN=1`` and a head count the "model" axis does not
divide, the flash path splits the queries' sequence over it instead
(`flash.flash_attention`'s ``seq_shard``).  Decode
against a cache whose sequence is split over ranks ("kv_seq") writes the
token's K/V on the rank that holds its position and gathers the cache's
positions to attend: an all-gather of the cache each step.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import flash as flash_mod
from repro_torch.models import sharding as shd
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init
from repro_torch.models.layers import softcap as softcap_fn

NEG_INF = -2.0e38
DIRECT_MAX_SEQ = 2048  # direct path above this switches to flash
# sequence-parallel attention for archs whose head count cannot shard over
# the model axis (read at import, as the reference does)
SEQ_SHARD_ATTN = os.environ.get("REPRO_SEQ_SHARD_ATTN", "0") == "1"


def _want_seq_shard(cfg: ModelCfg) -> bool:
    if not SEQ_SHARD_ATTN:
        return False
    mesh = shd.current_mesh()
    if mesh is None or "model" not in mesh.shape:
        return False
    return cfg.num_heads % mesh.shape["model"] != 0


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


def heads_axes(params) -> tuple:
    """The mesh axes this rank's query heads are split over.  The KV heads
    are split over the same axes, or whole on every rank (`kv_whole`);
    any other layout raises."""
    ax = shd.split_axes(params["wq"], -2)
    if "wk" in params:
        kv = shd.split_axes(params["wk"], -2)
        if kv not in ((), ax):
            raise NotImplementedError(
                f"query heads split over {ax} but KV heads over {kv}: a "
                f"rank's queries find their KV heads on their own rank or "
                f"in the whole KV projection")
    return ax


def kv_whole(params) -> bool:
    """Whether this rank's query heads are a block of theirs while its K/V
    projections hold every KV head (the model axis does not divide the
    KV heads)."""
    return bool(heads_axes(params)) and not shd.split_axes(params["wk"], -2)


def kv_for_rank(params, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The KV heads this rank's query heads attend, from ``t`` holding
    every KV head along ``dim``: query head h attends KV head h // G, G =
    H / KV.  The rank's query heads are [lo, lo + Hl) (`shd.offset` of
    ``wq``).  Where that block lies in one group (Hl divides G) or is
    whole groups (G divides Hl and lo), a slice of KV heads, and the
    grouped products keep their groups; else one KV head a query head
    (G = 1 for the rank).  ``t`` as it is off a rank mesh."""
    if not heads_axes(params):
        return t
    H, KV = params["wq"].shape[-2], t.shape[dim]
    if KV != params["wk"].shape[-2]:
        raise ValueError(f"{KV} KV heads along dim {dim}, not every one of "
                         f"{params['wk'].shape[-2]}")
    G = H // KV
    Hl = shd.local_block(params["wq"]).shape[-2]
    lo = shd.offset(params["wq"], -2)
    if G % Hl == 0 or (Hl % G == 0 and lo % G == 0):
        return t.narrow(dim, lo // G, max(Hl // G, 1))
    idx = torch.arange(lo, lo + Hl, device=t.device) // G
    return t.index_select(dim, idx)


def _kv_local(params, name: str) -> torch.Tensor:
    """The block of K/V weight or bias ``name`` this rank computes with
    (`shd.local`).  Held whole while the query heads split, each rank
    uses only the heads its queries attend: its gradient is summed over
    the query heads' axes."""
    w = shd.local(params[name])
    return shd.psum_grad(w, heads_axes(params)) if kv_whole(params) else w


def _project_qkv(params, cfg: ModelCfg, x, positions):
    """positions: (B, S), or (3, B, S) for M-RoPE.  K and V hold every KV
    head where `kv_whole`."""
    x = shd.psum_grad(x, heads_axes(params))
    q = _proj(x, shd.local(params["wq"]))
    k = _proj(x, _kv_local(params, "wk"))
    v = _proj(x, _kv_local(params, "wv"))
    if cfg.qkv_bias:
        q = q + shd.local(params["bq"])
        k = k + _kv_local(params, "bk")
        v = v + _kv_local(params, "bv")
    if cfg.rope_kind == "rope":
        pos2 = positions if positions.ndim == 2 else positions[0]
        q = apply_rope(q, pos2, cfg.rope_theta)
        k = apply_rope(k, pos2, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    q = shd.constrain(q, ("batch", "seq", "heads", None))
    k = shd.constrain(k, ("batch", "seq", "kv_heads", None))
    v = shd.constrain(v, ("batch", "seq", "kv_heads", None))
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
    KV = k.shape[2]
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
    ka, va = ((kv_for_rank(params, k), kv_for_rank(params, v))
              if kv_whole(params) else (k, v))
    held = None
    if max(S, k.shape[1]) <= DIRECT_MAX_SEQ:
        q_pos = torch.arange(S, device=x.device)
        k_pos = torch.arange(k.shape[1], device=x.device)
        o = _attend_direct(q, ka, va, cfg, scale, q_pos, k_pos, causal,
                           window)
    else:
        seq_shard = _want_seq_shard(cfg)
        o = flash_mod.flash_attention(
            q, ka, va, num_kv_heads=ka.shape[2], scale=scale,
            softcap=cfg.attn_softcap, causal=causal, window=window,
            seq_shard=seq_shard)
        if seq_shard:
            held = ("batch", "qseq", None, None)
    o = shd.constrain(o, ("batch", "seq", "heads", None), held=held)
    out = _out(o, shd.local(params["wo"]))
    out = shd.constrain(out, ("batch", "seq", None),
                        partial=shd.split_axes(params["wo"], 0))
    return out, ((k, v) if return_kv else None)


def cross_kv(params: dict, cfg: ModelCfg, enc_out: torch.Tensor):
    """The encoder's K/V for cross-attention (cached once a request); on
    a rank mesh the KV heads as the projection holds them: the rank's
    block, or every head where `kv_whole`."""
    enc_out = shd.psum_grad(enc_out, heads_axes(params))
    k = _proj(enc_out, _kv_local(params, "wk"))
    v = _proj(enc_out, _kv_local(params, "wv"))
    if cfg.qkv_bias:
        k = k + _kv_local(params, "bk")
        v = v + _kv_local(params, "bv")
    return k, v


def _q_only(params, cfg: ModelCfg, x):
    x = shd.psum_grad(x, heads_axes(params))
    q = _proj(x, shd.local(params["wq"]))
    return q + shd.local(params["bq"]) if cfg.qkv_bias else q


def _cache_for_rank(params, cache_k, cache_v, k_new, v_new, pos):
    """Decode on a rank mesh: write the token's K/V (every KV head, or the
    rank's, as the cache holds them) on the rank whose block of the
    cache's positions holds ``pos``, and return the keys and values this
    rank's query heads attend — every position (the cache's blocks
    gathered), the rank's KV heads (`kv_for_rank` where the cache holds
    every KV head)."""
    comm = shd.current_comm()
    ax_h = heads_axes(params)
    ax_kv = shd.split_axes(params["wk"], -2)
    ax_seq = shd.split_axes(cache_k, 1)
    ax_ch = shd.split_axes(cache_k, 2)
    if ax_ch not in ((), ax_kv):
        raise NotImplementedError(
            f"a cache with KV heads split over {ax_ch} for KV projections "
            f"split over {ax_kv} (query heads over {ax_h})")
    kl, vl = cache_k.to_local(), cache_v.to_local()
    if k_new is not None:
        if ax_kv and not ax_ch:
            k_new = comm.all_gather(k_new, 2, ax_kv)
            v_new = comm.all_gather(v_new, 2, ax_kv)
        lo = shd.offset(cache_k, 1)
        if lo <= pos < lo + kl.shape[1]:
            kl[:, pos - lo] = k_new[:, 0].to(kl.dtype)
            vl[:, pos - lo] = v_new[:, 0].to(vl.dtype)
    if ax_seq:
        kl = comm.all_gather(kl, 1, ax_seq)
        vl = comm.all_gather(vl, 1, ax_seq)
    if not ax_ch:
        kl, vl = kv_for_rank(params, kl), kv_for_rank(params, vl)
    return kl, vl


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
    scale = 1.0 / math.sqrt(hd)
    ranked = shd.current_comm() is not None and shd.is_dtensor(cache_k)

    k_new = v_new = None
    if cross:
        q = _q_only(params, cfg, x)
    else:
        lead = (3, B, 1) if cfg.rope_kind == "mrope" else (B, 1)
        posn = torch.full(lead, pos, dtype=torch.int32, device=x.device)
        q, k_new, v_new = _project_qkv(params, cfg, x, posn)
        if not ranked:
            cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
            cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
    keys, values = ((cache_k, cache_v) if not ranked else _cache_for_rank(
        params, cache_k, cache_v, k_new, v_new, pos))

    S, KV = keys.shape[1], keys.shape[2]
    qg = q.reshape(B, 1, KV, q.shape[2] // KV, hd)
    s = _scores(qg, keys, cfg, scale)[:, :, :, 0, :]      # (B, KV, G, S)
    if not cross:
        k_pos = torch.arange(S, device=x.device)
        ok = k_pos <= pos
        if window is not None:
            ok &= (pos - k_pos) < window
        s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(values.dtype), values)
    out = _out(o.reshape(B, 1, q.shape[2], hd), shd.local(params["wo"]))
    out = shd.constrain(out, ("batch", "seq", None),
                        partial=shd.split_axes(params["wo"], 0))
    return out, cache_k, cache_v
