"""Decoder-only LM assembly: the attention + gated-MLP (dense) family.

The port of `repro.models.transformer` for training, prefill, forward and
decode.  Layers are grouped into *periods* (1 for uniform stacks, 2 for
gemma2's local/global alternation) and each period slot's parameters and
cache carry a leading G = L/P dim, the reference's stacked layout: the
port loops over G in Python where the reference has ``lax.scan``, so a
reference parameter or cache tree converts leaf for leaf
(`repro_torch.convert`).  Decode writes each layer's K/V into its slice
of the stacked cache in place and returns the same cache.

The full-sequence forward takes each stacked leaf's groups with one
``unbind(0)`` (`unbind_groups`): its backward stacks the G group
gradients once, where G indexings ``v[g]`` would each build and add a
zero gradient of the whole stacked leaf.  With ``cfg.remat`` each group's
body runs under `torch.utils.checkpoint` (only the group's input is kept,
the reference's ``save_only_these_names()`` policy), and `chunked_ce`
recomputes each sequence chunk's logits in backward.

Mixture-of-experts, Mamba and RWKV layers (and Whisper's encoder-decoder)
raise `NotImplementedError`: they are ROADMAP Queue 1 item 12c.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelCfg
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (cross_entropy, dense_init, dtype_of,
                                       embed_tokens, gelu_tanh, init_mlp,
                                       init_norm, mlp, rms_norm, token_nll,
                                       unembed)

LATER_FAMILIES = "ROADMAP Queue 1 item 12c"


# ---------------------------------------------------------------------------
# Layer plans
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerPlan:
    kind: str            # "attn" | "mamba" | "rwkv"
    mlp: str             # "dense" | "moe" | "cmix"
    window: Optional[int] = None


def period_plan(cfg: ModelCfg) -> list[LayerPlan]:
    """Per-period layer plans (absolute layer i = group*P + p + prefix)."""
    if cfg.rwkv is not None:
        return [LayerPlan("rwkv", "cmix")]
    if cfg.hybrid is not None:
        plans = []
        for p in range(cfg.hybrid.period):
            kind = "attn" if p == cfg.hybrid.attn_index else "mamba"
            use_moe = (cfg.moe is not None and
                       p % cfg.moe.every == cfg.moe.every - 1)
            plans.append(LayerPlan(kind, "moe" if use_moe else "dense"))
        return plans
    if cfg.attn_type == "local_global":
        return [LayerPlan("attn", "dense", window=cfg.window),
                LayerPlan("attn", "dense", window=None)]
    use_moe = cfg.moe is not None
    return [LayerPlan("attn", "moe" if use_moe else "dense")]


def prefix_plans(cfg: ModelCfg) -> list[LayerPlan]:
    if cfg.moe is not None and cfg.moe.first_dense > 0:
        return [LayerPlan("attn", "dense")] * cfg.moe.first_dense
    return []


def n_groups(cfg: ModelCfg) -> int:
    P = len(period_plan(cfg))
    pre = len(prefix_plans(cfg))
    if (cfg.num_layers - pre) % P:
        raise ValueError(f"{cfg.num_layers} layers less a prefix of {pre} "
                         f"do not fill periods of {P}")
    return (cfg.num_layers - pre) // P


def dense_plans(cfg: ModelCfg) -> list[LayerPlan]:
    """`period_plan`, for a config whose every layer is attention + a
    dense MLP; anything else raises, naming the ROADMAP item."""
    if cfg.enc_dec is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (Whisper, cross-attention) is "
            f"not ported yet: {LATER_FAMILIES}")
    plans = period_plan(cfg) + prefix_plans(cfg)
    for plan in plans:
        if plan.kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {plan.kind} layers are not ported yet: "
                f"{LATER_FAMILIES}")
        if plan.mlp != "dense":
            raise NotImplementedError(
                f"{cfg.name}: {plan.mlp} (mixture-of-experts) layers are "
                f"not ported yet: {LATER_FAMILIES}")
    return period_plan(cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layer(gen: torch.Generator, cfg: ModelCfg, lead=()) -> dict:
    dtype = dtype_of(cfg)
    norms = ["norm1", "norm2"] + (["norm1_post", "norm2_post"]
                                  if cfg.post_norms else [])
    p: dict = {n: init_norm(cfg.d_model, lead, gen.device) for n in norms}
    p["attn"] = attn_mod.init_attention(gen, cfg, dtype, lead)
    p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, lead)
    return p


def init_lm(gen: torch.Generator, cfg: ModelCfg) -> dict:
    """Parameters drawn on ``gen``'s device, in the reference's tree."""
    dtype = dtype_of(cfg)
    plans = dense_plans(cfg)
    G = n_groups(cfg)
    params: dict = {
        "blocks": {f"layer_{p}": _init_layer(gen, cfg, (G,))
                   for p in range(len(plans))},
        "tok_embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), 0,
                                dtype),
        "final_norm": init_norm(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), 0,
                                       dtype)
    return params


def _map_leaves(fn, tree: dict) -> dict:
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def group_slice(tree: dict, g: int) -> dict:
    """Group ``g``'s parameters or cache of a stacked slot: views."""
    return _map_leaves(lambda v: v[g], tree)


def unbind_groups(tree: dict, G: int) -> list[dict]:
    """The G groups' parameters of a stacked slot, by one ``unbind(0)`` a
    leaf: the views `group_slice` gives, with one stack as backward."""
    per_leaf = _map_leaves(lambda t: t.unbind(0), tree)
    return [_map_leaves(lambda u: u[g], per_leaf) for g in range(G)]


# ---------------------------------------------------------------------------
# Layer application (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------
def _residual(p, cfg, x, sub_out, post_name):
    if cfg.post_norms:
        sub_out = rms_norm(sub_out, p[post_name], cfg.norm_eps)
    return x + sub_out


def apply_layer(
    p: dict,
    cfg: ModelCfg,
    plan: LayerPlan,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    pos: Optional[int] = None,
    collect_kv: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, new_cache).  The reference also returns an auxiliary
    loss, which only its mixture-of-experts layers make.

    cache!=None => one-token decode (the cache is written in place);
    collect_kv => full-sequence prefill that also returns the layer's
    decode cache.
    """
    new_cache: Optional[dict] = None
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if cache is None:
        out, kv = attn_mod.attention(p["attn"], cfg, h, positions,
                                     causal=True, window=plan.window,
                                     return_kv=collect_kv)
        if collect_kv:
            new_cache = {"k": kv[0], "v": kv[1]}
    else:
        out, ck, cv = attn_mod.decode_attention(
            p["attn"], cfg, h, cache["k"], cache["v"], pos,
            window=plan.window)
        new_cache = {"k": ck, "v": cv}
    x = _residual(p, cfg, x, out, "norm1_post")

    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    out = mlp(p["mlp"], h, act=gelu_tanh if cfg.scale_embed else F.silu)
    x = _residual(p, cfg, x, out, "norm2_post")
    return x, new_cache


def _embed(params, cfg, tokens, positions, frontend_embeds):
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if cfg.rope_kind == "mrope":
            positions = positions[None].expand(3, B, S)
    x = embed_tokens(cfg, params["tok_embed"], tokens)
    if frontend_embeds is not None:
        # modality stub: precomputed patch/frame embeddings own the first
        # S_f positions
        x = x.clone()
        x[:, :frontend_embeds.shape[1]] = frontend_embeds.to(x.dtype)
    return x, positions


def forward_hidden(
    params: dict,
    cfg: ModelCfg,
    tokens: torch.Tensor,                       # (B, S)
    positions: Optional[torch.Tensor] = None,   # (B, S) or (3, B, S)
    frontend_embeds: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden (B, S, D), aux_loss) — no unembed."""
    plans = dense_plans(cfg)
    x, positions = _embed(params, cfg, tokens, positions, frontend_embeds)

    def group_body(x, gparams):
        for i, plan in enumerate(plans):
            x, _ = apply_layer(gparams[f"layer_{i}"], cfg, plan, x,
                               positions)
        return x

    for gparams in unbind_groups(params["blocks"], n_groups(cfg)):
        if cfg.remat:
            x = checkpoint(group_body, x, gparams, use_reentrant=False)
        else:
            x = group_body(x, gparams)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # no mixture-of-experts layer in this family: the auxiliary loss is 0
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            frontend_embeds: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) f32, aux_loss)."""
    x, aux = forward_hidden(params, cfg, tokens, positions, frontend_embeds)
    return unembed(cfg, params, x), aux


CE_CHUNK = 512


def _ce_sum(cfg: ModelCfg, params: dict, x: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Summed CE of one sequence chunk: unembed -> logsumexp - gold."""
    return torch.sum(token_nll(unembed(cfg, params, x), labels))


def chunked_ce(params: dict, cfg: ModelCfg, x: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V) logits.

    Loops over sequence chunks of `CE_CHUNK`, each recomputed in backward
    (`torch.utils.checkpoint`, the reference's ``jax.checkpoint``): the
    peak logits buffer is (B, CE_CHUNK, V).  A length the chunk does not
    divide takes the full `cross_entropy`, as the reference does.
    """
    B, S, _ = x.shape
    c = min(CE_CHUNK, S)
    if S % c != 0:
        return cross_entropy(unembed(cfg, params, x), labels)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_ce_sum, cfg, params, x[:, sl],
                                   labels[:, sl], use_reentrant=False)
    return total / (B * S)


def lm_loss(params: dict, cfg: ModelCfg, batch: dict) -> torch.Tensor:
    x, aux = forward_hidden(
        params, cfg, batch["tokens"], batch.get("positions"),
        batch.get("frontend_embeds"))
    return chunked_ce(params, cfg, x, batch["labels"]) + 0.01 * aux


def prefill(params: dict, cfg: ModelCfg, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            frontend_embeds: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, dict]:
    """Inference prefill: last-token logits (B, 1, V) + the filled decode
    cache (each slot's K/V stacked over the groups: (G, B, S, KV, hd))."""
    plans = dense_plans(cfg)
    x, positions = _embed(params, cfg, tokens, positions, frontend_embeds)
    kvs: dict = {f"layer_{i}": {"k": [], "v": []} for i in range(len(plans))}
    for g in range(n_groups(cfg)):
        for i, plan in enumerate(plans):
            x, kv = apply_layer(
                group_slice(params["blocks"][f"layer_{i}"], g), cfg, plan,
                x, positions, collect_kv=True)
            kvs[f"layer_{i}"]["k"].append(kv["k"])
            kvs[f"layer_{i}"]["v"].append(kv["v"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, x[:, -1:])
    cache = {"blocks": {name: {k: torch.stack(v) for k, v in slot.items()}
                        for name, slot in kvs.items()}}
    return logits, cache


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelCfg, batch: int, max_seq: int,
               device="cuda") -> dict:
    """Zero cache tree: per period slot, K and V of (G, B, S, KV, hd), in
    the parameter dtype."""
    dtype = dtype_of(cfg)
    plans = dense_plans(cfg)
    shp = (n_groups(cfg), batch, max_seq, cfg.num_kv_heads, cfg.hd())
    return {"blocks": {
        f"layer_{i}": {"k": torch.zeros(shp, dtype=dtype, device=device),
                       "v": torch.zeros(shp, dtype=dtype, device=device)}
        for i in range(len(plans))}}


def decode_step(
    params: dict,
    cfg: ModelCfg,
    tokens: torch.Tensor,     # (B, 1)
    pos: int,
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One serve step: logits (B, 1, V) for the next token; the token's
    K/V are written into ``cache`` at ``pos`` in place, and the same
    cache is returned."""
    plans = dense_plans(cfg)
    x = embed_tokens(cfg, params["tok_embed"], tokens)
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                           device=tokens.device)
    for g in range(n_groups(cfg)):
        for i, plan in enumerate(plans):
            name = f"layer_{i}"
            x, _ = apply_layer(
                group_slice(params["blocks"][name], g), cfg, plan, x,
                positions, cache=group_slice(cache["blocks"][name], g),
                pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache
