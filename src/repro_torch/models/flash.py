"""Memory-efficient attention (flash-style) in plain PyTorch, with the
reference's custom backward.

The port of `repro.models.flash`: the query axis is split into chunks of
`Q_CHUNK` in a Python loop (a static triangular schedule), and each
q-chunk visits only the KV range its causal / sliding-window mask allows,
aligned to `KV_CHUNK`; inside it a running softmax (max, denom, acc) goes
over KV chunks, so memory is O(S·d), not O(S²), and causal attention
costs ~S²/2 multiply-adds.

Scores accumulate in float32 from the inputs (the reference's
``preferred_element_type``: bf16 products are exact in float32, so the
inputs are widened before the product); the probabilities are cast to
the value dtype before the PV product, which accumulates in float32.  A
masked score is the finite `NEG_INF`, never ``-inf``: a q-row whose every
key in a chunk is masked then carries a uniform row that the next chunk's
correction ``exp(m_prev - m_new)`` clears, as in the reference, where
``-inf`` would give NaN.

Backward (`_MeaChunk`, the reference's ``custom_vjp`` ``_mea_bwd``): a
q-chunk saves only (q, k, v, o, m, l) and recomputes each KV chunk's
scores (the flash-2 schedule).  ``D = sum(do * o)`` uses the saved output
in q's dtype, widened; ``dv = pᵀ do`` uses float32 ``p`` (not the value
dtype the forward cast it to); dk and dv are cast to k's and v's dtype per
KV chunk, dq accumulates in float32 and is cast once.  Each q-chunk's K/V
range is an ordinary slice of k and v, so autograd adds the dk/dv of
overlapping q-chunks as the reference's slice VJPs do.

``seq_shard`` (the reference's sequence-parallel attention, for a head
count the "model" axis does not divide): on a rank mesh each rank takes
its block of the queries' sequence (`models.sharding.constrain` from
"seq" to "qseq"), attends it against the whole K/V (whose gradients,
partial on each rank, are summed over the axis) from its absolute
position ``q_offset``, and returns its block of the output; elsewhere the
constraints move nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import sharding as shd

NEG_INF = -2.0e38
Q_CHUNK = 1024
KV_CHUNK = 512


def _pick_chunk(size: int, target: int) -> int:
    """Largest divisor of `size` that is <= target (handles Sk=1500 cross
    attention and other non-power-of-two sequence lengths)."""
    c = min(target, size)
    while size % c:
        c -= 1
    return c


def _mask(q_lo: int, cq: int, k_lo: int, ck: int, causal: bool,
          window: Optional[int], device) -> torch.Tensor:
    """(cq, ck) keep-mask from the chunks' offsets."""
    qp = q_lo + torch.arange(cq, device=device)
    kp = k_lo + torch.arange(ck, device=device)
    d = qp[:, None] - kp[None, :]
    ok = torch.ones((cq, ck), dtype=torch.bool, device=device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return ok


def _scores(q, k, scale, softcap):
    """q: float32 (B,cq,KV,G,hd) k: (B,ck,KV,hd) -> f32 (B,KV,G,cq,ck)."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _dscores(q, k, scale, softcap, ds_capped):
    """Backprop through scale (+softcap) given d(capped scores)."""
    if softcap is None:
        return ds_capped * scale
    raw = torch.einsum("bqkgh,bskh->bkgqs", q, k.float()) * scale
    t = torch.tanh(raw / softcap)
    return ds_capped * (1.0 - t * t) * scale


def _mea_fwd(q, k, v, scale, softcap, causal, window, q_lo, k_lo):
    """One q-chunk (B,cq,KV,G,hd) over its KV range (B,Sk,KV,hd): the
    running softmax over KV chunks; returns o (B,cq,KV,G,hd) in q's dtype
    and the float32 row max m and denominator l (B,KV,G,cq)."""
    B, cq, KV, G, hd = q.shape
    dtype, q = q.dtype, q.float()
    Sk = k.shape[1]
    ck = _pick_chunk(Sk, KV_CHUNK)
    m = torch.full((B, KV, G, cq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, cq, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(Sk // ck):
        k_c = k[:, i * ck:(i + 1) * ck]
        v_c = v[:, i * ck:(i + 1) * ck]
        s = _scores(q, k_c, scale, softcap)
        keep = _mask(q_lo, cq, k_lo + i * ck, ck, causal, window, q.device)
        s = torch.where(keep, s, NEG_INF)
        m_n = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_n)
        p = torch.exp(s - m_n[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v_c.dtype).float(),
                          v_c.float())
        acc = acc * corr[..., None] + pv
        m = m_n
    o = acc / torch.clamp(l, min=1e-37)[..., None]
    return o.movedim(-2, 1).to(dtype), m, l


def _mea_bwd(q, k, v, o, m, l, do, scale, softcap, causal, window, q_lo,
             k_lo):
    """dq, dk, dv of one q-chunk from its saved (q, k, v, o, m, l)."""
    B, cq, KV, G, hd = q.shape
    Sk = k.shape[1]
    ck = _pick_chunk(Sk, KV_CHUNK)
    q32 = q.float()
    do_t = do.float().movedim(1, -2)                     # (B,KV,G,cq,hd)
    D = torch.sum(do_t * o.float().movedim(1, -2), dim=-1)  # (B,KV,G,cq)
    linv = 1.0 / torch.clamp(l, min=1e-37)
    dq = torch.zeros((B, cq, KV, G, hd), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for i in range(Sk // ck):
        k_c = k[:, i * ck:(i + 1) * ck]
        v_c = v[:, i * ck:(i + 1) * ck]
        s = _scores(q32, k_c, scale, softcap)
        keep = _mask(q_lo, cq, k_lo + i * ck, ck, causal, window, q.device)
        s = torch.where(keep, s, NEG_INF)
        p = torch.exp(s - m[..., None]) * linv[..., None]  # (B,KV,G,cq,ck)
        dp = torch.einsum("bkgqh,bskh->bkgqs", do_t, v_c.float())
        ds = _dscores(q32, k_c, scale, softcap, p * (dp - D[..., None]))
        dq = dq + torch.einsum("bkgqs,bskh->bqkgh", ds, k_c.float())
        dks.append(torch.einsum("bkgqs,bqkgh->bskh", ds, q32).to(k.dtype))
        dvs.append(torch.einsum("bkgqs,bkgqh->bskh", p, do_t).to(v.dtype))
    return dq.to(q.dtype), torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


class _MeaChunk(torch.autograd.Function):
    """One q-chunk attended over its (statically sliced) KV range: the
    running-softmax forward, and a backward that recomputes the scores."""

    @staticmethod
    def forward(ctx, q, k, v, scale, softcap, causal, window, q_lo, k_lo):
        o, m, l = _mea_fwd(q, k, v, scale, softcap, causal, window, q_lo,
                           k_lo)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.static = (scale, softcap, causal, window, q_lo, k_lo)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _mea_bwd(*ctx.saved_tensors, do, *ctx.static)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Sk, KV, hd)
    v: torch.Tensor,
    *,
    num_kv_heads: int,
    scale: float,
    softcap: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,            # absolute position of q[0]
    seq_shard: bool = False,      # sequence-parallel: shard q chunks over
                                  # "model" when heads can't take the axis
) -> torch.Tensor:
    """Static triangular q-chunk schedule over `_MeaChunk`.  With
    ``seq_shard`` on a rank mesh the result is this rank's block of the
    sequence ("qseq").  On a rank mesh whose model axis splits the query
    heads only, ``k`` and ``v`` are the KV heads the rank's query heads
    attend (`attention.kv_for_rank`) and ``num_kv_heads`` their count:
    the groups are the rank's, and `_MeaChunk`'s dk and dv are partial
    sums over the rank's query heads."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    KV = num_kv_heads
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    if seq_shard:
        # one reshard for the whole tensor, as the reference
        qg = shd.constrain(qg, ("batch", "qseq", None, None, None),
                           held=("batch", "seq", None, None, None))
        k = shd.constrain(k, ("batch", None, None, None))
        v = shd.constrain(v, ("batch", None, None, None))
        comm = shd.current_comm()
        if comm is not None:
            ax = comm.moving(tuple(a for a in shd.LOGICAL_RULES["qseq"]
                                   if a in comm.sizes))
            q_offset += comm.offset(Sq, ax)
            k, v = shd.psum_grad(k, ax), shd.psum_grad(v, ax)
        Sq = qg.shape[1]
    cq = _pick_chunk(Sq, Q_CHUNK)
    ckv = _pick_chunk(Sk, KV_CHUNK)
    outs = []
    for i in range(Sq // cq):
        q_lo, q_hi = q_offset + i * cq, q_offset + (i + 1) * cq
        # the KV range this chunk can see, aligned to the KV chunk
        lo, hi = 0, Sk
        if causal:
            hi = min(hi, q_hi)
        if window is not None:
            lo = max(lo, q_lo - window + 1)
        lo = (lo // ckv) * ckv
        hi = min(-(-hi // ckv) * ckv, Sk)
        hi = max(hi, lo + ckv) if Sk >= ckv else Sk
        o = _MeaChunk.apply(qg[:, i * cq:(i + 1) * cq], k[:, lo:hi],
                            v[:, lo:hi], scale, softcap, causal, window,
                            q_lo, lo)
        outs.append(o)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    if seq_shard:
        out = shd.constrain(out, ("batch", "qseq", None, None, None))
    return out.reshape(B, Sq, H, hd)
