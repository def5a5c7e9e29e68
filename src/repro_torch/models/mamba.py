"""Mamba (S6) block for the Jamba hybrid: selective SSM with a chunked scan.

The port of `repro.models.mamba`.  The diagonal selective recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t is evaluated chunk by chunk: a
Python loop over chunks of `CHUNK` carries h, and inside a chunk the
first-order recurrence is a log-depth sweep of elementwise products and
sums over the chunk axis (`_chunk_scan`: 7 passes at 128 steps), where
the reference has ``lax.associative_scan``.  Torch has no associative
scan; a loop over the chunk's steps would be 128 dependent launches a
chunk.  No closed form through ``exp(cumsum(log a))``: ``log a = dt·A``
reaches about -1.6 a step at jamba's A <= 16 and dt <= 0.1, and
``exp(-cumsum)`` overflows float32 within a chunk.

The scan's backward (`_SelectiveScan`) is the reference's closed form:
the same first-order recurrence run in reverse through the forward scan,
not autograd through the sweep (which would keep every pass of every
chunk).  Above `SEQ_CHUNK` tokens the block runs sequence chunk by chunk,
carrying the conv and SSM states, each chunk recomputed in backward
(`torch.utils.checkpoint`, the reference's ``jax.checkpoint``).  Decode
is the O(1) recurrent step with (conv, ssm) carried in the cache.
`CHUNK` and `SEQ_CHUNK` are read at call time.

On a rank mesh (`models.sharding`) the inner channels (d_in) are split
over "model", as the rules split every Mamba leaf along them: the
convolution, the softplus and the selective scan are per channel and run
on the rank's channels, and the decode states hold them.  ``in_proj``'s
columns are ``[xs | z]`` and its block on a rank is a contiguous run of
them (on 2 ranks all of xs on one and all of z on the other), so its
output is gathered whole on its last dim and each half split into the
rank's channels (`_xs_z`).  ``x_proj`` is row-parallel: its partial sums
are all-reduced before the (dt, B, C) split, and their gradient, partial
on each rank's channels, is summed; ``out_proj`` is row-parallel too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import HybridCfg
from repro_torch.models import sharding as shd
from repro_torch.models.layers import dense_init

CHUNK = 128
SEQ_CHUNK = 512


def init_mamba(gen: torch.Generator, d_model: int, hc: HybridCfg, dtype,
               lead=()) -> dict:
    d_in = hc.expand * d_model
    dt_rank = max(1, d_model // 16)
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=gen.device)
    A = torch.arange(1, hc.d_state + 1, **f32).expand(
        lead + (d_in, hc.d_state)).contiguous()
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(lead + (d_in,), generator=gen, **f32) * (hi - lo) + lo
    return {
        "in_proj": dense_init(gen, (d_model, 2 * d_in), 0, dtype, lead),
        "conv_w": dense_init(gen, (d_in, hc.d_conv), 1, dtype, lead),
        "conv_b": torch.zeros(lead + (d_in,), dtype=dtype,
                              device=gen.device),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * hc.d_state), 0,
                             dtype, lead),
        "dt_w": dense_init(gen, (dt_rank, d_in), 0, dtype, lead),
        "dt_b": torch.log(torch.expm1(torch.clamp(torch.exp(u), min=1e-4))),
        "A_log": torch.log(A),
        "D_skip": torch.ones(lead + (d_in,), **f32),
        "out_proj": dense_init(gen, (d_in, d_model), 0, dtype, lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None):
    """Depthwise causal conv1d. x: (B, S, d_in), w: (d_in, K).

    The K taps are summed from 0 in tap order, then ``b`` is added (the
    reference's order, which matters in bf16).  Returns (y, new_state),
    the state the trailing K-1 inputs in float32.
    """
    B, S, d_in = x.shape
    K = w.shape[1]
    if state is None:
        pad = torch.zeros((B, K - 1, d_in), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # (B, S+K-1, d)
    y = sum(xp[:, i:i + S] * w[:, i] for i in range(K)) + b
    if K > 1:
        new_state = xp[:, -(K - 1):].float()
    else:
        new_state = torch.zeros((B, 0, d_in), dtype=torch.float32,
                                device=x.device)
    return y, new_state


def _chunk_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) pairs along axis 1 under the reference's
    combine ``(al, bl), (ar, br) -> (al·ar, br + ar·bl)``: a log-depth
    sweep (each pass combines every step with the one ``d`` before it)."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def _scan_impl(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + bx_t over chunks of `CHUNK`: (h_all, h_T)."""
    S = a.shape[1]
    ch = min(CHUNK, S)
    if S % ch:
        raise ValueError(f"sequence {S} is not a multiple of the scan "
                         f"chunk {ch}")
    h = h0
    outs = []
    for i in range(S // ch):
        sl = slice(i * ch, (i + 1) * ch)
        a_cum, b_cum = _chunk_scan(a[:, sl], bx[:, sl])
        h_all = b_cum + a_cum * h[:, None]
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


class _SelectiveScan(torch.autograd.Function):
    """The chunked scan with the reference's closed-form backward:

    dh_t = g_t + a_{t+1} dh_{t+1};  da_t = dh_t h_{t-1};  dbx_t = dh_t;
    dh0  = a_1 dh_1 — the same first-order recurrence run in reverse,
    through the forward scan on time-reversed inputs.
    """

    @staticmethod
    def forward(ctx, a, bx, h0):
        h_all, h_fin = _scan_impl(a, bx, h0)
        ctx.save_for_backward(a, h_all, h0)
        return h_all, h_fin

    @staticmethod
    def backward(ctx, g_all, g_fin):
        a, h_all, h0 = ctx.saved_tensors
        g_all = torch.zeros_like(h_all) if g_all is None else g_all.clone()
        if g_fin is not None:
            # the incoming gradient on h_T adds to the last position's g
            g_all[:, -1] += g_fin
        a_rev = torch.flip(a, dims=(1,))
        # reversed-time coefficient is the previous reversed a; the first
        # multiplies the zero initial state
        a_shift = torch.cat([torch.ones_like(a_rev[:, :1]), a_rev[:, :-1]],
                            dim=1)
        dh_rev, _ = _scan_impl(a_shift, torch.flip(g_all, dims=(1,)),
                               torch.zeros_like(h0))
        dh = torch.flip(dh_rev, dims=(1,))
        h_prev = torch.cat([h0[:, None], h_all[:, :-1]], dim=1)
        return dh * h_prev, dh, a[:, 0] * dh[:, 0]


def _selective_scan(a, bx, h0):
    """(h_all (B, S, d_in, N), h_T) with the closed-form backward."""
    return _SelectiveScan.apply(a, bx, h0)


def mamba_forward(params: dict, hc: HybridCfg, x: torch.Tensor,
                  state: dict | None = None, return_state: bool = False):
    """x: (B, S, D).  state (decode): {"conv": (B, K-1, d_in), "ssm":
    (B, d_in, N)}, float32.  Returns (y, new_state or None).

    A sequence longer than `SEQ_CHUNK` that it divides runs chunk by
    chunk, carrying the conv and SSM states; with gradients on, each
    chunk is recomputed in backward: peak residual memory O(chunk ·
    d_inner · d_state) instead of O(S · d_inner · d_state).
    """
    B, S, D = x.shape
    if state is not None:
        # a rank's block of the decode cache: the plain tensors it holds
        state = {k: shd.local_block(v) for k, v in state.items()}
    if S > SEQ_CHUNK and S % SEQ_CHUNK == 0:
        d_in = _channels(params, hc, D)
        if state is None:
            state = {
                "conv": torch.zeros((B, hc.d_conv - 1, d_in),
                                    dtype=torch.float32, device=x.device),
                "ssm": torch.zeros((B, d_in, hc.d_state),
                                   dtype=torch.float32, device=x.device),
            }
        ys = []
        for i in range(S // SEQ_CHUNK):
            xi = x[:, i * SEQ_CHUNK:(i + 1) * SEQ_CHUNK]
            if torch.is_grad_enabled():
                yi, state = checkpoint(_mamba_impl, params, hc, xi, state,
                                       True, use_reentrant=False)
            else:
                yi, state = _mamba_impl(params, hc, xi, state, True)
            ys.append(yi)
        return torch.cat(ys, dim=1), (state if return_state else None)
    return _mamba_impl(params, hc, x, state, return_state)


def _channels(params: dict, hc: HybridCfg, d_model: int) -> int:
    """The inner channels this rank holds (all of them off a rank mesh)."""
    ax = shd.split_axes(params["conv_w"], -2)
    n = math.prod(shd.current_comm().sizes[a] for a in ax) if ax else 1
    return hc.expand * d_model // n


def _xs_z(xz: torch.Tensor, ax: tuple):
    """(xs, z) of ``in_proj``'s output, each on this rank's channels.  On
    a rank mesh ``xz`` is the rank's contiguous block of the [xs | z]
    columns: gathered whole on its last dim, then each half split (the
    split's backward gathers each half's gradient, so the gather's keeps
    its block of a gradient every rank holds whole)."""
    if not ax:
        return xz.chunk(2, dim=-1)
    xz = shd.constrain(xz, ("batch", "seq", None),
                       held=("batch", "seq", "mlp"))
    return tuple(shd.constrain(h, ("batch", "seq", "mlp"),
                               held=("batch", "seq", None))
                 for h in xz.chunk(2, dim=-1))


def _mamba_impl(params: dict, hc: HybridCfg, x: torch.Tensor,
                state: dict | None, return_state: bool):
    B, S, D = x.shape
    N = hc.d_state
    ax = shd.split_axes(params["conv_w"], -2)

    # column-parallel: the rank's channels give a partial gradient of x
    xz = shd.psum_grad(x, ax) @ shd.local(params["in_proj"])
    xs, z = _xs_z(xz, ax)                                  # (B, S, d_in)
    xs, conv_state = _causal_conv(xs, shd.local(params["conv_w"]),
                                  shd.local(params["conv_b"]),
                                  None if state is None else state["conv"])
    xs = F.silu(xs)

    proj = xs @ shd.local(params["x_proj"])                # (B, S, R+2N)
    # row-parallel: the channels' partial sums summed; dt, B and C are
    # then used on every rank's channels, each giving a partial gradient
    proj = shd.psum_grad(shd.constrain(proj, ("batch", "seq", None),
                                       partial=ax), ax)
    dt_rank = params["dt_w"].shape[0]
    dt, Bp, Cp = proj.split([dt_rank, N, N], dim=-1)
    # softplus as jax.nn.softplus, log(1 + e^x) everywhere (F.softplus
    # switches to the identity above 20)
    dt = torch.logaddexp(dt @ shd.local(params["dt_w"])
                         + shd.local(params["dt_b"]).to(dt.dtype),
                         torch.zeros((), dtype=dt.dtype, device=x.device))
    A = -torch.exp(shd.local(params["A_log"]))             # (d_in, N)

    a = torch.exp(dt.float()[..., None] * A)               # (B, S, d_in, N)
    bx = (dt * xs).float()[..., None] * Bp.float()[..., None, :]
    h0 = torch.zeros((B, A.shape[0], N), dtype=torch.float32,
                     device=x.device) if state is None else state["ssm"]
    h_all, h_fin = _selective_scan(a, bx, h0)
    y = torch.einsum("bsdn,bsn->bsd", h_all, Cp.float())  # (B, S, d_in)
    y = y + shd.local(params["D_skip"]) * xs.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = shd.constrain(y @ shd.local(params["out_proj"]),
                        ("batch", "seq", None), partial=ax)
    new_state = {"conv": conv_state, "ssm": h_fin} if return_state else None
    return out, new_state


def mamba_state_shape(hc: HybridCfg, d_model: int, batch: int) -> dict:
    d_in = hc.expand * d_model
    return {
        "conv": (batch, hc.d_conv - 1, d_in),
        "ssm": (batch, d_in, hc.d_state),
    }
