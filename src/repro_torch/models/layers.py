"""Shared building blocks: init helpers, norms, rotary embeddings, MLPs,
the cross-entropy.

The port of `repro.models.layers`.  Each function computes what its
counterpart does, in the same dtypes at each step (norms and RoPE in
float32, cast back; the embedding scale rounded to the parameter dtype
before it multiplies).  Parameter draws are equal in distribution only:
weights cross from the reference through `repro_torch.convert`.

On a rank mesh (`models.sharding`) a weight enters through `shd.local`
(its FSDP dims gathered) and the products are tensor-parallel: the gated
MLP's up projections are column-parallel over "mlp" and its down
projection row-parallel (its partial sums summed, `constrain(...,
partial=)`); the embedding looks up the rank's vocabulary block and the
unembedding gives the block's logits, whose cross-entropy reduces its
max, its sum of exponentials and the gold logit across the block's ranks
(`token_nll` with a vocabulary layout).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelCfg
from repro_torch.models import sharding as shd


def dtype_of(cfg: ModelCfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, lead: tuple[int, ...] = ()
               ) -> torch.Tensor:
    """A truncated normal on [-2, 2] scaled by 1/sqrt(fan_in), drawn on
    ``gen``'s device: fan_in is the product of the dims of ``shape`` up to
    ``in_axis``.  ``lead`` stacks independent draws in front (the layer
    groups' G) without entering the fan-in."""
    fan_in = math.prod(shape[:in_axis + 1]) if in_axis >= 0 else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    # inverse-CDF draw of the standard normal truncated to [-2, 2]
    lo = math.erf(-2.0 / math.sqrt(2.0))
    z = torch.rand(tuple(lead) + tuple(shape), generator=gen,
                   device=gen.device, dtype=torch.float32)
    z.mul_(-2.0 * lo).add_(lo).erfinv_().mul_(math.sqrt(2.0))
    return z.clamp_(-2.0, 2.0).mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Gemma's form: float32, times ``1 + scale``, cast back."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + shd.local(scale).float())
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE): split halves, not interleaved pairs
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); ang: (B, S, hd/2) float32."""
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions3: (3, B, S) — temporal / height / width position ids.
    `sections` partitions the hd/2 frequency slots among the 3 components.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"head_dim/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    slot = torch.arange(hd // 2, device=x.device)
    comp = ((slot >= sections[0]).long()
            + (slot >= sections[0] + sections[1]).long())  # (hd/2,) in 0..2
    pos = positions3.float().movedim(0, -1)                # (B, S, 3)
    pos_per_freq = pos[..., comp]                          # (B, S, hd/2)
    return _rotate(x, pos_per_freq * freqs)


# ---------------------------------------------------------------------------
# Gated MLP (llama/gemma style)
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model: int, d_ff: int, dtype, lead=()) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), 0, dtype, lead),
        "w_up": dense_init(gen, (d_model, d_ff), 0, dtype, lead),
        "w_down": dense_init(gen, (d_ff, d_model), 0, dtype, lead),
    }


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation (not erf)."""
    return F.gelu(x, approximate="tanh")


def mlp(params: dict, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    ax = shd.split_axes(params["w_gate"], -1)
    x = shd.psum_grad(x, ax)
    h = (act(x @ shd.local(params["w_gate"]))
         * (x @ shd.local(params["w_up"])))
    lead = ("batch",) + (None,) * (h.ndim - 2)
    h = shd.constrain(h, lead + ("mlp",))
    return shd.constrain(h @ shd.local(params["w_down"]), lead + (None,),
                         partial=ax)


def init_norm(d: int, lead=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(lead) + (d,), dtype=torch.float32,
                       device=device)


def embed_tokens(cfg: ModelCfg, tok_embed: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows, scaled.  With the vocabulary split over ranks a
    rank looks up the tokens of its block and leaves zeros for the rest:
    the result is a partial sum over `vocab_layout`'s axes."""
    ax = shd.split_axes(tok_embed, 0)
    w = shd.local(tok_embed)
    if ax:
        ids = tokens.long() - shd.offset(tok_embed, 0)
        mine = ((ids >= 0) & (ids < w.shape[0]))[..., None]
        x = torch.where(mine, w[ids.clamp(0, w.shape[0] - 1)], 0.0)
    else:
        x = w[tokens]
    if cfg.scale_embed:
        # sqrt(d_model) rounded to the parameter dtype first, as the
        # reference's ``jnp.asarray(np.sqrt(d), x.dtype)``: 59.75 in bf16
        # for d_model 3584, not 59.87 (a host scalar: no copy to the card;
        # its product with a bf16 or float32 entry rounds once, as there)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def embed(cfg: ModelCfg, params: dict, tokens: torch.Tensor
          ) -> torch.Tensor:
    """The embedded tokens (`embed_tokens` of ``params["tok_embed"]``),
    summed over the vocabulary's ranks."""
    return shd.constrain(embed_tokens(cfg, params["tok_embed"], tokens),
                         ("batch", "seq", None),
                         partial=shd.split_axes(params["tok_embed"], 0))


def vocab_layout(cfg: ModelCfg, params: dict) -> tuple[tuple, int]:
    """(mesh axes, start) of this rank's block of the unembedding's
    vocabulary; ((), 0) off a rank mesh or when it is whole."""
    if cfg.tie_embeddings:
        w, dim = params["tok_embed"], 0
    else:
        w, dim = params["lm_head"], 1
    return shd.split_axes(w, dim), shd.offset(w, dim)


def unembed(cfg: ModelCfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Softcapped float32 logits (of the rank's vocabulary block on a rank
    mesh: a column-parallel product)."""
    ax, _ = vocab_layout(cfg, params)
    x = shd.psum_grad(x, ax)
    if cfg.tie_embeddings:
        logits = x @ shd.local(params["tok_embed"]).T.to(x.dtype)
    else:
        logits = x @ shd.local(params["lm_head"])
    return softcap(logits.float(), cfg.final_softcap)


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              vocab_axes: tuple = (), vocab_start: int = 0
              ) -> torch.Tensor:
    """logsumexp - gold logit at each position: logits (..., V) f32,
    labels (...) of any integer dtype (widened to int64 for the gather
    only).  With ``vocab_axes`` the logits are this rank's vocabulary
    block from ``vocab_start`` (`vocab_layout`), and the max, the sum of
    exponentials and the gold logit are reduced across its ranks."""
    if vocab_axes:
        return _VocabNLL.apply(logits, labels, vocab_start, vocab_axes)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    return logz - gold


class _VocabNLL(torch.autograd.Function):
    """`token_nll` over vocabulary blocks split across ranks: forward as
    ``torch.logsumexp`` computes it (the max, then the sum of
    ``exp(x - max)``), each partial result reduced across the ranks; the
    gradient ``softmax - onehot(label)`` of the rank's block."""

    @staticmethod
    def forward(ctx, logits, labels, start, axes):
        comm = shd.current_comm()
        m = comm.all_reduce(logits.amax(dim=-1), axes, op="max")
        s = comm.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1),
                            axes)
        logz = torch.log(s) + m
        ids = labels.long() - start
        mine = (ids >= 0) & (ids < logits.shape[-1])
        ids = ids.clamp(0, logits.shape[-1] - 1)
        gold = torch.gather(logits, -1, ids[..., None]).squeeze(-1)
        gold = comm.all_reduce(torch.where(mine, gold, 0.0), axes)
        ctx.save_for_backward(logits, logz, ids, mine)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        logits, logz, ids, mine = ctx.saved_tensors
        d = torch.exp(logits - logz[..., None]) * g[..., None]
        d.scatter_add_(-1, ids[..., None],
                       -torch.where(mine, g, 0.0)[..., None])
        return d, None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions. logits (B, S, V) f32, labels (B, S)."""
    return torch.mean(token_nll(logits, labels))
