"""Mixture-of-Experts: top-k routing, GShard-style one-hot dispatch.

The port of `repro.models.moe`.  Routing follows the reference step for
step: float32 router logits -> softmax -> top-k; the k gates are
renormalised over the k chosen experts (before any drop); each token's
rank within its expert is an exclusive cumulative sum per (batch row,
chunk); a token whose rank reaches the capacity C drops (its one-hot
dispatch row is all zero).  The dispatch, the expert products and the
combine are the reference's one-hot einsums, in its dtypes: the dispatch
one-hot in x's dtype, the combine weights ``disp * gate`` cast to it.

Tokens are processed in chunks of `TOK_CHUNK` along the sequence (read at
call time): capacity is per (batch row, chunk), C = `_capacity(chunk)`.
A sequence that the chunk does not divide, or that is one chunk long,
takes one shot at capacity `_capacity(S)`, as the reference does; the
load-balance statistics of a chunked call are averaged over the chunks.

On a rank mesh (`models.sharding`) the experts are split over "model"
(expert parallel, the reference's ``constrain`` sites): the tokens stay
whole on every rank of the axis, each rank routes them all (the router is
whole there) and keeps the dispatch and gate columns of its own experts
(`_local_experts`), runs its experts, and its combine is a partial sum
over the experts that a `constrain(..., partial=)` adds up.  The
load-balance statistics are means over the batch, whose rows are split
over the batch's ranks: they are averaged across them before the aux
term's product.  Capacity is per (batch row, chunk), so a split of the
rows leaves every token's slot as it is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg
from repro_torch.models import sharding as shd
from repro_torch.models.layers import dense_init, init_mlp, mlp

TOK_CHUNK = 512


def init_moe(gen: torch.Generator, d_model: int, m: MoECfg, dtype,
             lead=()) -> dict:
    E, Fe = m.num_experts, m.d_ff_expert
    p = {
        "router": dense_init(gen, (d_model, E), 0, torch.float32, lead),
        "we_gate": dense_init(gen, (E, d_model, Fe), 1, dtype, lead),
        "we_up": dense_init(gen, (E, d_model, Fe), 1, dtype, lead),
        "we_down": dense_init(gen, (E, Fe, d_model), 1, dtype, lead),
    }
    if m.num_shared:
        shared = init_mlp(gen, d_model, m.num_shared * Fe, dtype, lead)
        p["shared"] = {"ws_gate": shared["w_gate"], "ws_up": shared["w_up"],
                       "ws_down": shared["w_down"]}
    return p


def _capacity(chunk: int, m: MoECfg) -> int:
    c = math.ceil(chunk * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def _route(params: dict, m: MoECfg, xc: torch.Tensor, C: int):
    """The router of a chunk xc (B, c, D) at capacity C: (dispatch
    one-hot (B, c, E, C) in x's dtype, renormalised gates (B, c, E),
    router probabilities (B, c, E), assignments (B, c, E))."""
    E, k = m.num_experts, m.top_k
    logits = xc.float() @ shd.local(params["router"])         # (B, c, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                  # (B, c, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    oh = F.one_hot(idx, E).float()                            # (B, c, k, E)
    assign = oh.sum(2)                                        # (B, c, E)
    gate_e = torch.einsum("bcke,bck->bce", oh, gate)
    # rank of each token within its expert, per (batch row, chunk)
    rank = torch.cumsum(assign, dim=1) - assign               # exclusive
    rank = torch.where(assign > 0, rank, float(C))            # drop non-hits
    # one-hot of the rank by comparison: a rank >= C gives an all-zero
    # row, the reference's drop (``F.one_hot`` would raise there)
    slots = torch.arange(C, device=xc.device, dtype=rank.dtype)
    disp = (rank[..., None] == slots).to(xc.dtype)            # (B, c, E, C)
    disp = disp * assign[..., None].to(xc.dtype)
    return disp, gate_e, probs, assign


def _experts(params: dict, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's gated MLP on its capacity slots: (B, E, C, D) in and
    out (the rank's experts on a rank mesh)."""
    h = F.silu(torch.einsum("becd,edf->becf", buf,
                            shd.local(params["we_gate"])))
    h = h * torch.einsum("becd,edf->becf", buf, shd.local(params["we_up"]))
    return torch.einsum("becf,efd->becd", h, shd.local(params["we_down"]))


def _local_experts(disp: torch.Tensor, gate_e: torch.Tensor, ax: tuple):
    """The dispatch (B, c, E, C) and gate (B, c, E) columns of this rank's
    experts (split over ``ax``), by `constrain`: the gate's gradient is
    gathered from every rank's experts, so the router's is whole on each
    (a bare index would leave it partial, with nothing to sum it)."""
    if not ax:
        return disp, gate_e
    disp = shd.constrain(disp, ("batch", None, "experts", None),
                         held=("batch", None, None, None))
    gate_e = shd.constrain(gate_e, ("batch", None, "experts"),
                           held=("batch", None, None))
    return disp, gate_e


def _route_chunk(params: dict, m: MoECfg, xc: torch.Tensor, C: int,
                 xe: torch.Tensor):
    """xc: (B, c, D) -> (y (B, c, D), mean router probabilities (E,),
    share of assignments (E,)); ``xe`` is xc as the experts take it.  On
    a rank mesh y is this rank's experts' part of the combine, a partial
    sum over the experts' axes."""
    disp, gate_e, probs, assign = _route(params, m, xc, C)
    disp, gate_e = _local_experts(disp, gate_e,
                                  shd.split_axes(params["we_gate"], 0))
    buf = torch.einsum("btec,btd->becd", disp, xe)            # (B, E, C, D)
    out = _experts(params, buf)
    comb = disp * gate_e[..., None].to(xc.dtype)
    y = torch.einsum("btec,becd->btd", comb, out)

    me = probs.mean(dim=(0, 1))                               # (E,)
    ce = assign.mean(dim=(0, 1)) / m.top_k
    return y, me, ce


def _batch_mean(stats: torch.Tensor) -> torch.Tensor:
    """Means over this rank's block of the batch as means over the whole
    batch: averaged across the batch's ranks (its gradient passes to each
    block's mean, divided by their count)."""
    n = shd.batch_split()
    return shd.psum(stats, shd.batch_axes()) / n if n > 1 else stats


def moe_layer(params: dict, m: MoECfg, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss), aux the Switch load-balance term
    E · Σ_e mean-probability_e · assignment-share_e."""
    B, S, D = x.shape
    E = m.num_experts
    ax = shd.split_axes(params["we_gate"], 0)
    # the rank's experts give a partial gradient of the tokens (the
    # router's, computed on every rank, is whole)
    xe = shd.psum_grad(x, ax)
    c = min(TOK_CHUNK, S)
    if S % c != 0 or S == c:
        y, me, ce = _route_chunk(params, m, x, _capacity(S, m), xe)
        stats = torch.stack([me, ce])
    else:
        n = S // c
        C = _capacity(c, m)
        stats = torch.zeros((2, E), dtype=torch.float32, device=x.device)
        ys = []
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            yi, me, ce = _route_chunk(params, m, x[:, sl], C, xe[:, sl])
            stats = stats + torch.stack([me, ce])
            ys.append(yi)
        stats = stats / n
        y = torch.cat(ys, dim=1)
    stats = _batch_mean(stats)
    aux = E * torch.sum(stats[0] * stats[1])
    y = shd.constrain(y, ("batch", "seq", None), partial=ax)
    if "shared" in params:
        sp = params["shared"]
        y = y + mlp({"w_gate": sp["ws_gate"], "w_up": sp["ws_up"],
                     "w_down": sp["ws_down"]}, x)
    return y, aux
