"""Decoder-only LM assembly: dense / MoE / hybrid (Mamba) / RWKV families.

The port of `repro.models.transformer` for training, prefill, forward and
decode.  Layers are grouped into *periods* (1 for uniform stacks, 2 for
gemma2's local/global alternation, 8 for jamba's mamba:attn = 7:1) and
each period slot's parameters and cache carry a leading G = L/P dim, the
reference's stacked layout: the port loops over G in Python where the
reference has ``lax.scan``, so a reference parameter or cache tree
converts leaf for leaf (`repro_torch.convert`).  A `first_dense` prefix
(kimi-k2's dense layer 0) is kept unstacked, a list of per-layer dicts,
and runs before the groups, outside remat, as in the reference.

Each layer returns ``(x, aux, new_cache)``: aux is the mixture-of-experts
load-balance term (0 elsewhere), summed over all layers and added to the
loss as ``0.01 * aux``.  Decode writes each layer's new K/V, Mamba
(conv, ssm) or RWKV (shift_t, wkv, shift_c) state into its slice of the
cache in place and returns the same cache; state leaves are float32.

The full-sequence forward takes each stacked leaf's groups with one
``unbind(0)`` (`unbind_groups`): its backward stacks the G group
gradients once, where G indexings ``v[g]`` would each build and add a
zero gradient of the whole stacked leaf.  With ``cfg.remat`` each group's
body runs under `torch.utils.checkpoint` (only the group's input is kept,
the reference's ``save_only_these_names()`` policy; ``REPRO_REMAT=dots``
also keeps the unbatched products' outputs, `_remat_policy`), and `chunked_ce`
recomputes each sequence chunk's logits in backward.  Whisper's
encoder-decoder is `models.whisper`.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelCfg
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (cross_entropy, dense_init, dtype_of,
                                       embed_tokens, gelu_tanh, init_mlp,
                                       init_norm, mlp, rms_norm, token_nll,
                                       unembed)


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


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layer(gen: torch.Generator, cfg: ModelCfg, plan: LayerPlan,
                lead=()) -> dict:
    dtype = dtype_of(cfg)
    norms = ["norm1", "norm2"] + (["norm1_post", "norm2_post"]
                                  if cfg.post_norms else [])
    p: dict = {n: init_norm(cfg.d_model, lead, gen.device) for n in norms}
    if plan.kind == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg, dtype, lead)
    elif plan.kind == "mamba":
        p["mamba"] = mamba_mod.init_mamba(gen, cfg.d_model, cfg.hybrid,
                                          dtype, lead)
    elif plan.kind == "rwkv":
        p["tmix"] = rwkv_mod.init_rwkv_tmix(gen, cfg, dtype, lead)
    if plan.mlp == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, lead)
    elif plan.mlp == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, dtype, lead)
    elif plan.mlp == "cmix":
        p["cmix"] = rwkv_mod.init_rwkv_cmix(gen, cfg, dtype, lead)
    return p


def init_lm(gen: torch.Generator, cfg: ModelCfg) -> dict:
    """Parameters drawn on ``gen``'s device, in the reference's tree."""
    dtype = dtype_of(cfg)
    plans = period_plan(cfg)
    G = n_groups(cfg)
    params: dict = {
        "blocks": {f"layer_{p}": _init_layer(gen, cfg, plan, (G,))
                   for p, plan in enumerate(plans)},
        "tok_embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), 0,
                                dtype),
        "final_norm": init_norm(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), 0,
                                       dtype)
    pre = prefix_plans(cfg)
    if pre:
        params["prefix"] = [_init_layer(gen, cfg, plan) for plan in pre]
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
) -> tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (x, aux_loss, new_cache).

    cache!=None => one-token decode (attention writes the cache in place;
    a state layer returns its new state); collect_kv => full-sequence
    prefill that also returns the layer's decode cache.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Optional[dict] = None
    want_state = (cache is not None) or collect_kv
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if plan.kind == "attn":
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
    elif plan.kind == "mamba":
        out, new_cache = mamba_mod.mamba_forward(
            p["mamba"], cfg.hybrid, h, state=cache, return_state=want_state)
    else:  # rwkv
        st_in = None
        if cache is not None:
            st_in = {"shift": cache["shift_t"], "wkv": cache["wkv"]}
        out, st = rwkv_mod.rwkv_time_mix(
            p["tmix"], cfg, h, state=st_in, return_state=want_state)
        if st is not None:
            new_cache = {"shift_t": st["shift"], "wkv": st["wkv"]}
    x = _residual(p, cfg, x, out, "norm1_post")

    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if plan.mlp == "dense":
        out = mlp(p["mlp"], h, act=gelu_tanh if cfg.scale_embed else F.silu)
    elif plan.mlp == "moe":
        out, aux = moe_mod.moe_layer(p["moe"], cfg.moe, h)
    else:  # cmix
        out, shift_c = rwkv_mod.rwkv_channel_mix(
            p["cmix"], cfg, h,
            state=None if cache is None else cache["shift_c"],
            return_state=want_state)
        if new_cache is not None and shift_c is not None:
            new_cache["shift_c"] = shift_c
    x = _residual(p, cfg, x, out, "norm2_post")
    return x, aux, new_cache


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


# the products without batch dims: what ``REPRO_REMAT=dots`` saves, as the
# reference's ``dots_with_no_batch_dims_saveable`` does (attention's
# batched products, aten.bmm, are recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_policy() -> dict:
    """The remat's keyword arguments, read from ``REPRO_REMAT`` at call
    time: ``dots`` saves the unbatched products' outputs (their backward
    recomputes the rest of the group), anything else saves nothing."""
    if os.environ.get("REPRO_REMAT") == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    return {}


def forward_hidden(
    params: dict,
    cfg: ModelCfg,
    tokens: torch.Tensor,                       # (B, S)
    positions: Optional[torch.Tensor] = None,   # (B, S) or (3, B, S)
    frontend_embeds: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden (B, S, D), aux_loss summed over the layers)
    — no unembed."""
    plans = period_plan(cfg)
    x, positions = _embed(params, cfg, tokens, positions, frontend_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, plan in zip(params.get("prefix", []), prefix_plans(cfg)):
        x, aux, _ = apply_layer(p, cfg, plan, x, positions)
        aux_total = aux_total + aux

    def group_body(x, aux_acc, gparams):
        for i, plan in enumerate(plans):
            x, aux, _ = apply_layer(gparams[f"layer_{i}"], cfg, plan, x,
                                    positions)
            aux_acc = aux_acc + aux
        return x, aux_acc

    remat = _remat_policy()
    for gparams in unbind_groups(params["blocks"], n_groups(cfg)):
        if cfg.remat:
            x, aux_total = checkpoint(group_body, x, aux_total, gparams,
                                      use_reentrant=False, **remat)
        else:
            x, aux_total = group_body(x, aux_total, gparams)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


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
    cache: per period slot each leaf stacked over the groups (K/V of
    (G, B, S, KV, hd), or a state leaf's (G, ...)), and the prefix
    layers' caches unstacked under ``prefix``."""
    plans = period_plan(cfg)
    x, positions = _embed(params, cfg, tokens, positions, frontend_embeds)
    prefix_cache = []
    for p, plan in zip(params.get("prefix", []), prefix_plans(cfg)):
        x, _, kv = apply_layer(p, cfg, plan, x, positions, collect_kv=True)
        prefix_cache.append(kv)
    slots: dict = {f"layer_{i}": [] for i in range(len(plans))}
    for g in range(n_groups(cfg)):
        for i, plan in enumerate(plans):
            x, _, kv = apply_layer(
                group_slice(params["blocks"][f"layer_{i}"], g), cfg, plan,
                x, positions, collect_kv=True)
            slots[f"layer_{i}"].append(kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, x[:, -1:])
    cache: dict = {"blocks": {
        name: {k: torch.stack([c[k] for c in per_group])
               for k in per_group[0]}
        for name, per_group in slots.items()}}
    if prefix_cache:
        cache["prefix"] = prefix_cache
    return logits, cache


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------
def _layer_cache(cfg: ModelCfg, plan: LayerPlan, batch: int, max_seq: int,
                 lead: tuple, device) -> dict:
    """A zero cache for one layer: K/V in the parameter dtype, Mamba and
    RWKV states in float32."""
    if plan.kind == "attn":
        shp = lead + (batch, max_seq, cfg.num_kv_heads, cfg.hd())
        c = {"k": torch.zeros(shp, dtype=dtype_of(cfg), device=device),
             "v": torch.zeros(shp, dtype=dtype_of(cfg), device=device)}
    else:
        shapes = (mamba_mod.mamba_state_shape(cfg.hybrid, cfg.d_model, batch)
                  if plan.kind == "mamba"
                  else rwkv_mod.rwkv_state_shapes(cfg, batch))
        c = {k: torch.zeros(lead + s, dtype=torch.float32, device=device)
             for k, s in shapes.items()}
    if plan.mlp == "cmix":
        c["shift_c"] = torch.zeros(lead + (batch, cfg.d_model),
                                   dtype=torch.float32, device=device)
    return c


def init_cache(cfg: ModelCfg, batch: int, max_seq: int,
               device="cuda") -> dict:
    """Zero cache tree: per period slot each leaf with a leading G (K and
    V of (G, B, S, KV, hd) in the parameter dtype; Mamba's conv and ssm,
    RWKV's shift_t, wkv and shift_c in float32), and the prefix layers'
    caches unstacked under ``prefix``."""
    plans = period_plan(cfg)
    lead = (n_groups(cfg),)
    cache: dict = {"blocks": {
        f"layer_{i}": _layer_cache(cfg, plan, batch, max_seq, lead, device)
        for i, plan in enumerate(plans)}}
    pre = prefix_plans(cfg)
    if pre:
        cache["prefix"] = [_layer_cache(cfg, plan, batch, max_seq, (),
                                        device) for plan in pre]
    return cache


def _write_back(dst: dict, src: dict) -> None:
    """The layer's new cache into its slice of the decode cache, in place
    (attention's K/V are already there)."""
    for k, v in src.items():
        if v is not dst[k]:
            dst[k].copy_(v)


def decode_step(
    params: dict,
    cfg: ModelCfg,
    tokens: torch.Tensor,     # (B, 1)
    pos: int,
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One serve step: logits (B, 1, V) for the next token; the token's
    K/V and the new states are written into ``cache`` in place, and the
    same cache is returned."""
    plans = period_plan(cfg)
    x = embed_tokens(cfg, params["tok_embed"], tokens)
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                           device=tokens.device)
    for p, plan, c in zip(params.get("prefix", []), prefix_plans(cfg),
                          cache.get("prefix", [])):
        x, _, nc = apply_layer(p, cfg, plan, x, positions, cache=c, pos=pos)
        _write_back(c, nc)
    for g in range(n_groups(cfg)):
        for i, plan in enumerate(plans):
            name = f"layer_{i}"
            c = group_slice(cache["blocks"][name], g)
            x, _, nc = apply_layer(
                group_slice(params["blocks"][name], g), cfg, plan, x,
                positions, cache=c, pos=pos)
            _write_back(c, nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache
