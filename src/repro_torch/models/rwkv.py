"""RWKV-6 (Finch) block: token shift + data-dependent-decay WKV recurrence.

The port of `repro.models.rwkv`.  Time mixing per head (hd = 64):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with w_t = exp(-exp(wx_t)) from a low-rank projection of the
token-shifted input (the data-dependent decay).

The recurrence runs chunk by chunk (`_wkv_chunked`): a Python loop over
chunks carries S (B, H, hd, hd) and each chunk is a few einsums, O(S·hd²)
work and O(1) state, so decode is one constant-memory step.  The chunk is
the largest divisor of T up to `CHUNK` (read at call time): a prime
length takes chunks of 1.  The per-head group norm is the population
variance (``correction=0``, as ``jnp.var``), eps 1e-5.

On a rank mesh (`models.sharding`) the time mix is tensor parallel over
its heads: ``w_r``, ``w_k``, ``w_v`` and ``w_g`` are column-parallel (a
rank's D/M output channels are its heads), ``w_o`` row-parallel (its
partial sums all-reduced), and the leaves the rules leave whole on
"model" (``decay_b``'s columns, ``decay_bias``, ``u_bonus``, ``ln_x``)
are split to the rank's channels by `constrain`, whose backward gathers
their gradients.  The WKV and the group norm run on the rank's heads;
the cache keeps the wkv state whole on every model rank (the specs'
``("batch", None, None, None)``), so a prefill gathers its final state
over the heads (B·H·hd² float32 a layer, once a request).  A decode step
instead gathers r, k, v and w (4·B·D float32 a layer a token, where the
state would be B·H·hd²: 16x less at hd = 64) and runs the WKV on every
head against the whole state, as does any step whose D/M channels are
not whole heads.  The channel mix's ``w_k`` is column-parallel over
d_ff, but the rules split ``w_v``'s and ``w_r``'s output columns (D),
not d_ff's rows: ``kk`` is gathered whole, each rank computes its D/M
output columns (``kk``'s gradient, partial on each, summed) and the
output is gathered.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelCfg
from repro_torch.models import sharding as shd
from repro_torch.models.layers import dense_init

CHUNK = 64


def init_rwkv_tmix(gen: torch.Generator, cfg: ModelCfg, dtype,
                   lead=()) -> dict:
    D = cfg.d_model
    rc = cfg.rwkv
    H, hd = D // rc.head_dim, rc.head_dim
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "mu": torch.full(lead + (5, D), 0.5, **f32),  # shift mix r,k,v,g,w
        "w_r": dense_init(gen, (D, D), 0, dtype, lead),
        "w_k": dense_init(gen, (D, D), 0, dtype, lead),
        "w_v": dense_init(gen, (D, D), 0, dtype, lead),
        "w_g": dense_init(gen, (D, D), 0, dtype, lead),
        "w_o": dense_init(gen, (D, D), 0, dtype, lead),
        "decay_a": dense_init(gen, (D, rc.decay_lora), 0, torch.float32,
                              lead),
        "decay_b": dense_init(gen, (rc.decay_lora, D), 0, torch.float32,
                              lead),
        "decay_bias": torch.full(lead + (D,), -5.0, **f32),
        "u_bonus": dense_init(gen, (H, hd), 0, torch.float32, lead),
        "ln_x": torch.ones(lead + (D,), **f32),        # group-norm scale
    }


def init_rwkv_cmix(gen: torch.Generator, cfg: ModelCfg, dtype,
                   lead=()) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "mu": torch.full(tuple(lead) + (2, D), 0.5, dtype=torch.float32,
                         device=gen.device),
        "w_k": dense_init(gen, (D, Fd), 0, dtype, lead),
        "w_v": dense_init(gen, (Fd, D), 0, dtype, lead),
        "w_r": dense_init(gen, (D, D), 0, dtype, lead),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor | None
                 ) -> torch.Tensor:
    """x_{t-1} per position; ``last`` is the (float32) carry for decode."""
    if last is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, w, u, S0):
    """Chunked WKV.  r, k, v: (B, T, H, hd); w: (B, T, H, hd) decay in
    (0, 1); u: (H, hd); S0: (B, H, hd, hd).  Returns (y (B, T, H, hd),
    S_final).

    Within a chunk of length c, with W_t = prod_{s<=t} diag(w_s):
      y_t = r_t (W_{t-1} S0) + sum_{s<t} r_t diag(W_{t-1}/W_s) k_s v_s^T
            + (r_t * u * k_t) v_t^T
    and S0 then advances by the whole chunk.  1/W_s is clamped at e^30:
    where the decay ratio falls below e^-30 the contribution is
    numerically zero anyway.
    """
    B, T, H, hd = r.shape
    c = min(CHUNK, T)
    while T % c:   # largest divisor of T <= CHUNK (odd decode lengths)
        c -= 1
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      -1)
    S = S0
    ys = []
    for i in range(T // c):
        sl = slice(i * c, (i + 1) * c)
        rc, kc, vc, wc = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
        logw = torch.log(torch.clamp(wc, 1e-20, 1.0))
        cs = torch.cumsum(logw, dim=1)                       # log W_t <= 0
        Wprev = torch.exp(cs - logw)                         # W_{t-1} <= 1
        rw = rc * Wprev
        y_in = torch.einsum("bthi,bhij->bthj", rw, S)
        kw = kc * torch.exp(torch.clamp(-cs, max=30.0))
        att = torch.einsum("bthi,bshi->bhts", rw, kw)        # (B, H, c, c)
        att = torch.where(mask, att, 0.0)
        y_intra = torch.einsum("bhts,bshj->bthj", att, vc)
        y_diag = torch.einsum("bthi,bthj->bthj", rc * u * kc, vc)
        ys.append(y_in + y_intra + y_diag)
        # S' = diag(W_c) S + sum_s diag(W_c/W_s) k_s v_s^T
        Wc = torch.exp(cs[:, -1])                            # (B, H, hd)
        ratio = torch.exp(cs[:, -1][:, None] - cs)           # <= 1
        S = Wc[..., None] * S + torch.einsum("bshi,bshj->bhij",
                                             ratio * kc, vc)
    return torch.cat(ys, dim=1), S


def _ways(axes: tuple) -> int:
    """How many blocks a dim split over ``axes`` has on the ambient rank
    mesh (1 for none)."""
    return math.prod(shd.current_comm().sizes[a] for a in axes) if axes \
        else 1


def _mine(t: torch.Tensor, names: tuple, ax: tuple) -> torch.Tensor:
    """The rank's channels of a leaf every rank of the model axis holds
    whole (``names``: the split dim's name, None elsewhere); its gradient
    is gathered from every rank's channels.  As it is off a rank mesh."""
    if not ax:
        return t
    return shd.constrain(t, names, held=(None,) * t.ndim)


def rwkv_time_mix(params: dict, cfg: ModelCfg, x: torch.Tensor,
                  state: dict | None = None, return_state: bool = False):
    """x: (B, T, D); state: {"shift": (B, D), "wkv": (B, H, hd, hd)},
    float32 (on a rank mesh the rank's blocks: its batch rows, every
    head).  Returns (out, new state or None)."""
    B, T, D = x.shape
    rc = cfg.rwkv
    H, hd = D // rc.head_dim, rc.head_dim
    if state is not None:
        state = {k: shd.local_block(v) for k, v in state.items()}
    ax = shd.split_axes(params["w_r"], -1)
    # every head on every rank: a decode step (the state is whole), or
    # channels that are not whole heads
    whole = bool(ax) and (state is not None or (D // _ways(ax)) % hd != 0)
    prev = _token_shift(x, None if state is None else state["shift"])
    mu = shd.local(params["mu"]).to(x.dtype)
    xr, xk, xv, xg, xw = (x + mu[i] * (prev - x) for i in range(5))
    if ax:      # column-parallel: each input's gradient partial, summed
        xr, xk, xv, xg = shd.psum_grad(torch.stack([xr, xk, xv, xg]),
                                       ax).unbind(0)

    r = (xr @ shd.local(params["w_r"])).float()
    k = (xk @ shd.local(params["w_k"])).float()
    v = (xv @ shd.local(params["w_v"])).float()
    g = F.silu(xg @ shd.local(params["w_g"]))
    low = shd.psum_grad(xw.float() @ shd.local(params["decay_a"]), ax)
    wx = low @ _mine(shd.local(params["decay_b"]), (None, "mlp"), ax)
    bias = _mine(shd.local(params["decay_bias"]), ("mlp",), ax)
    w = torch.exp(-torch.exp(wx + bias))                   # (B, T, D/M)
    u = shd.local(params["u_bonus"])
    ln_x = shd.local(params["ln_x"])
    if whole:
        rkvw = shd.constrain(torch.stack([r, k, v, w], dim=2),
                             ("batch", "seq", None, None),
                             held=("batch", "seq", None, "mlp"))
        r, k, v, w = rkvw.unbind(2)
    else:
        u = _mine(u, ("heads", None), ax)
        ln_x = _mine(ln_x, ("mlp",), ax)
    Hl = r.shape[-1] // hd
    r, k, v, w = (t.reshape(B, T, Hl, hd) for t in (r, k, v, w))

    S0 = torch.zeros((B, Hl, hd, hd), dtype=torch.float32, device=x.device) \
        if state is None else state["wkv"]
    y, S_fin = _wkv_chunked(r, k, v, w, u, S0)
    # per-head group norm (population variance, as jnp.var)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y.reshape(B, T, Hl * hd) * ln_x
    if whole:
        y = shd.constrain(y, ("batch", "seq", "mlp"),
                          held=("batch", "seq", None))
    out = (y.to(x.dtype) * g) @ shd.local(params["w_o"])
    out = shd.constrain(out, ("batch", "seq", None), partial=ax)
    new_state = None
    if return_state:
        if ax and not whole:    # the cache holds every head
            S_fin = shd.constrain(S_fin, ("batch", None, None, None),
                                  held=("batch", "heads", None, None))
        new_state = {"shift": x[:, -1].float(), "wkv": S_fin}
    return out, new_state


def rwkv_channel_mix(params: dict, cfg: ModelCfg, x: torch.Tensor,
                     state: torch.Tensor | None = None,
                     return_state: bool = False):
    """Returns (out, the last input in float32 — the next call's shift
    carry — or None)."""
    prev = _token_shift(x, shd.local_block(state))
    mu = shd.local(params["mu"]).to(x.dtype)
    xk = x + mu[0] * (prev - x)
    xr = x + mu[1] * (prev - x)
    ax = shd.split_axes(params["w_k"], -1)         # d_ff's
    ax_o = shd.split_axes(params["w_v"], -1)       # D's, as w_r's
    kk = torch.square(torch.relu(shd.psum_grad(xk, ax)
                                 @ shd.local(params["w_k"])))
    kk = shd.constrain(kk, ("batch", "seq", "mlp"))
    if ax:      # every rank's output columns need every row of d_ff
        kk = shd.constrain(kk, ("batch", "seq", None),
                           held=("batch", "seq", "mlp"))
    val = shd.psum_grad(kk, ax_o) @ shd.local(params["w_v"])
    out = torch.sigmoid(shd.psum_grad(xr, ax_o)
                        @ shd.local(params["w_r"])) * val
    if ax_o:
        out = shd.constrain(out, ("batch", "seq", None),
                            held=("batch", "seq", "mlp"))
    return out, (x[:, -1].float() if return_state else None)


def rwkv_state_shapes(cfg: ModelCfg, batch: int) -> dict:
    D = cfg.d_model
    rc = cfg.rwkv
    H, hd = D // rc.head_dim, rc.head_dim
    return {
        "shift_t": (batch, D),
        "wkv": (batch, H, hd, hd),
        "shift_c": (batch, D),
    }
