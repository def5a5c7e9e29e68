"""Step functions + sharding wiring shared by dryrun.py / train.py / serve.

`make_train_step(cfg, shape, mesh)` returns a `LoweredStep` for a full
train step: fwd + bwd + AdamW update, remat'd groups, the state updated
in place.  `make_serve_step` is the one-token decode, `make_prefill_step`
fills a cache, and `make_step` picks one by the shape's kind.

The port of ``repro.launch.steps``.  Every spec is derived from the
logical sharding rules in `models.sharding`, as the reference derives
them; nothing here is per-arch special-cased.  The mesh is logical
devices of one card (`launch.mesh`): the step runs under
``use_mesh(mesh)``, its values are those of the same step with
``mesh=None`` bit for bit, and its specs say what each device would hold
(`models.sharding.NamedSharding.shard_shape`).  ``abstract_args`` are the
step's arguments as fake tensors (``torch._subclasses.fake_tensor``) or
`models.model.ShapeDtype` records: no memory is allocated for them, and
`launch.dryrun` traces the step on their ``meta`` twins without touching
the card (on a rank mesh, one rank's blocks of them, ``device="meta"``).

The loss's gradients come from ``torch.autograd.grad`` with respect to
detached views of the parameter leaves, and `optim.adamw.apply` writes
the new parameters and moments into the caller's tensors in place (the
reference donates the state).

On a rank mesh (`core.distributed.make_rank_mesh`, one process a
position) the steps of every family are sharded as the specs say: under
the ``2d`` preset FSDP over "data" and tensor parallel over "model" (the
experts, the Mamba channels and the RWKV heads split over it too), under
``REPRO_PARALLELISM=fsdp`` the batch over every axis and the parameters
gathered over ("data", "model") with no tensor parallelism.  Every
argument and result is a tree of per-rank DTensors
(`models.sharding.shard_tree` makes them from whole trees, `full_tree`
gathers them back), each rank holding its block of every parameter,
moment, batch and cache; 8-bit moments hold their quantization blocks
split over ("data", "model") (`optim.adamw`).  The specs are the same as
on a logical mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.core.hwaware import HwAwareConfig
from repro_torch.models import sharding as shd
from repro_torch.models import transformer, whisper
from repro_torch.models.model import (
    Model,
    build_model,
    decode_input_specs,
    train_input_specs,
)
from repro_torch.models.sharding import P
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# Batch / cache sharding rules
# ---------------------------------------------------------------------------
def batch_specs(batch_tree: Any, mesh) -> Any:
    def one(key, leaf):
        nd = len(leaf.shape)
        if "positions" in key and nd == 3:
            names = (None, "batch", None)
        elif "frontend_embeds" in key:
            names = ("batch", None, None)
        elif nd == 2:
            names = ("batch", None)
        else:
            names = ("batch",) + (None,) * (nd - 1)
        return shd.spec(leaf.shape, names, mesh)

    return shd.map_with_path(one, batch_tree)


def _base_ndim(key: str) -> int:
    if key.endswith("'k']") or key.endswith("'v']"):
        return 4
    if "ssm" in key or "conv" in key:
        return 3
    if "wkv" in key:
        return 4
    if "shift" in key:
        return 2
    return 0


def cache_specs(cache_tree: Any, mesh) -> Any:
    def one(key, leaf):
        nd = len(leaf.shape)
        lead = (None,) * (nd - _base_ndim(key))
        if key.endswith("'k']") or key.endswith("'v']"):
            names = lead + ("batch", "kv_seq", "kv_heads", None)
        elif "ssm" in key:
            names = lead + ("batch", "mlp", None)
        elif "conv" in key:
            names = lead + ("batch", None, "mlp")
        elif "wkv" in key:
            names = lead + ("batch", None, None, None)
        elif "shift" in key:
            names = lead + ("batch", None)
        else:
            names = (None,) * nd
        return shd.spec(leaf.shape, names, mesh)

    return shd.map_with_path(one, cache_tree)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LoweredStep:
    fn: Callable               # runs the step on real tensors
    abstract_args: tuple       # fake tensors / ShapeDtype records
    in_specs: Any              # one spec tree per argument
    out_specs: Any             # spec trees of the outputs (None: unset)
    model: Model               # its init draws the parameters


def abstract_train_state(cfg: ModelCfg, state_bits: int = 32
                         ) -> tuple[Any, Any]:
    """Parameters and optimizer state as fake tensors: the shapes and
    dtypes `Model.init` and `adamw.init` give, with no memory allocated
    and the card untouched (drawn on the CPU under a `FakeTensorMode`)."""
    with FakeTensorMode():
        params = build_model(cfg, device="cpu").init(0)
        opt = adamw.init(params, state_bits)
    return params, opt


def _opt_moment_specs(moments: Any, mesh) -> Any:
    """Specs for mu/nu.  f32 moments mirror the param rules; quantized
    QTensor payloads/scales shard their block dim over the FSDP axis
    (blockwise layout is shape-agnostic, so any divisible dim0 works)."""
    quantized = any(leaf.dtype == torch.int8
                    for _, leaf in shd.leaves_with_path(moments))

    def one(key, leaf):
        if quantized:
            names = ("opt_blocks",) + (None,) * (len(leaf.shape) - 1)
            return shd.spec(leaf.shape, names, mesh)
        return shd.spec(leaf.shape, shd._leaf_axes(key, len(leaf.shape)),
                        mesh)

    return shd.map_with_path(one, moments)


# the families whose steps run on a rank mesh
RANKED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


def rank_setup(cfg: ModelCfg, mesh, device) -> tuple:
    """On a rank mesh: check the step can be sharded there and make the
    mesh's collectives (every rank calls this together); returns
    (rank mesh?, the model's device).  ``device`` is ``meta`` only in the
    dry run's trace (`launch.dryrun.rank_trace`), which runs no data."""
    from repro_torch.api.spec import require_device

    dev = require_device(device)
    if not shd.is_rank_mesh(mesh):
        return False, dev
    if cfg.family not in RANKED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on a rank mesh: only the "
            f"{', '.join(RANKED_FAMILIES)} families' steps are sharded "
            f"across processes; use a logical mesh "
            f"(launch.mesh.make_host_mesh)")
    shd.rank_comm(mesh, dev)
    return True, dev


def _batch_axes(spec_tree) -> tuple:
    """The mesh axes the batch rows are split over (the tokens' dim 0)."""
    sp = spec_tree["tokens"]
    return shd._spec_axes(sp[0]) if len(sp) else ()


def _as_dtensor(block: torch.Tensor, names, shape, mesh) -> Any:
    """A rank's block of a result laid out as the rules give for ``names``
    on the global ``shape``, as a DTensor."""
    from torch.distributed.tensor import DTensor

    sp = shd.spec(shape, names, mesh)
    comm = shd.current_comm()
    return DTensor.from_local(block.contiguous(), comm.dm,
                              shd.placements(sp, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    """The row-major strides of ``shape``, with no tensor made (the dry
    run counts every tensor a step makes on ``meta``)."""
    out, step = [], 1
    for d in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(d), 1)
    return tuple(reversed(out))


def _logits_out(logits: torch.Tensor, cfg: ModelCfg, mesh) -> Any:
    """A rank's (B_block, 1, V_block) logits as a DTensor of the whole
    (B, 1, V)."""
    B = logits.shape[0] * shd.batch_split()
    return _as_dtensor(logits, ("batch", None, "vocab"),
                       (B, logits.shape[1], cfg.vocab_size), mesh)


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches along the batch axis (axis 1 of a (3, B, S)
    positions leaf)."""
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        axis = 1 if k == "positions" and v.ndim == 3 else 0
        for i, part in enumerate(v.chunk(n, dim=axis)):
            out[i][k] = part
    return out


def make_train_step(
    cfg: ModelCfg,
    shape: ShapeCfg,
    mesh=None,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    hw_aware: Optional[HwAwareConfig] = None,
    microbatches: int = 1,
    device="cuda",
) -> LoweredStep:
    """``.fn(params, opt_state, batch) -> (params, opt_state, metrics)``,
    ``metrics = {"loss", "grad_norm", "lr"}`` as tensors; params and
    opt_state are updated in place and returned.  microbatches > 1:
    gradient accumulation in float32 over batch slices, divided by the
    count."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ranked, device = rank_setup(cfg, mesh, device)
    model = build_model(cfg, hw_aware=hw_aware, device=device)
    if shape.global_batch % microbatches:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{microbatches} microbatches")

    def grads_of(params, batch):
        live = [p.detach().requires_grad_()
                for p in adamw.tree_leaves(params)]
        loss = model.loss(adamw.tree_unflatten(params, live), batch)
        return loss.detach(), torch.autograd.grad(loss, live)

    def train_step(params, opt_state, batch):
        with shd.use_mesh(mesh, device, baxes):
            batch = shd.local_tree(batch)
            if microbatches == 1:
                loss, grads = grads_of(params, batch)
            else:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
                grads = None
                for micro in _split(batch, microbatches):
                    l, g = grads_of(params, micro)
                    loss = loss + l.float()
                    grads = ([x.float() for x in g] if grads is None else
                             [a + b.float() for a, b in zip(grads, g)])
                loss = loss / microbatches
                grads = [g / microbatches for g in grads]
            grads = adamw.tree_unflatten(params, grads)
            params, opt_state, metrics = adamw.apply(opt_cfg, grads,
                                                     opt_state, params)
            metrics["loss"] = loss
        return params, opt_state, metrics

    params_a, opt_a = abstract_train_state(cfg, opt_cfg.state_bits)
    batch_a = train_input_specs(cfg, shape)
    pspec = shd.param_specs(params_a, mesh)
    ospec = adamw.OptState(step=P(), mu=_opt_moment_specs(opt_a.mu, mesh),
                           nu=_opt_moment_specs(opt_a.nu, mesh))
    bspec = batch_specs(batch_a, mesh)
    baxes = _batch_axes(bspec) if ranked else ()
    return LoweredStep(train_step, (params_a, opt_a, batch_a),
                       (pspec, ospec, bspec), (pspec, ospec, None), model)


# ---------------------------------------------------------------------------
# Serve: decode + prefill
# ---------------------------------------------------------------------------
def _abstract_params(cfg: ModelCfg):
    """The parameters as fake tensors (`abstract_train_state`'s)."""
    with FakeTensorMode():
        return build_model(cfg, device="cpu").init(0)


def make_serve_step(cfg: ModelCfg, shape: ShapeCfg, mesh,
                    device="cuda") -> LoweredStep:
    """``.fn(params, tokens, pos, cache) -> (logits, cache)``: one decode
    token (`Model.decode_step`; the cache is written in place)."""
    ranked, device = rank_setup(cfg, mesh, device)
    model = build_model(cfg, device=device)

    def serve_step(params, tokens, pos, cache):
        if not ranked:
            with shd.use_mesh(mesh):
                return model.decode_step(params, tokens, pos, cache)
        with torch.no_grad(), shd.use_mesh(mesh, device, baxes):
            logits, cache = model.decode_step(
                params, shd.local_block(tokens), pos, cache)
            return _logits_out(logits, cfg, mesh), cache

    params_a = _abstract_params(cfg)
    specs = decode_input_specs(cfg, shape)
    pspec = shd.param_specs(params_a, mesh)
    cspec = cache_specs(specs["cache"], mesh)
    tok_spec = shd.spec(specs["tokens"].shape, ("batch", None), mesh)
    baxes = shd._spec_axes(tok_spec[0]) if ranked and len(tok_spec) else ()
    args = (params_a, specs["tokens"], specs["pos"], specs["cache"])
    return LoweredStep(serve_step, args, (pspec, tok_spec, P(), cspec),
                       (tok_spec, cspec), model)


def make_prefill_step(cfg: ModelCfg, shape: ShapeCfg, mesh,
                      device="cuda") -> LoweredStep:
    """``.fn(params, batch)``: `transformer.prefill`'s (last logits,
    cache), or the encoder-decoder's last-position logits of
    `whisper.forward`.  On a rank mesh the logits and the cache are
    DTensors: the cache in the layout prefill computes it (K/V heads split
    as the projections' are), which `launch.serve.graft_ranked`
    re-blocks."""
    ranked, device = rank_setup(cfg, mesh, device)
    model = build_model(cfg, device=device)

    if ranked and cfg.enc_dec is not None:
        def prefill_step(params, batch):
            with torch.no_grad(), shd.use_mesh(mesh, device, baxes):
                b = shd.local_tree(batch)
                logits, _ = whisper.forward(params, cfg, b["tokens"],
                                            b["frontend_embeds"])
                return _logits_out(logits[:, -1:], cfg, mesh)
    elif ranked:
        def prefill_step(params, batch):
            with torch.no_grad(), shd.use_mesh(mesh, device, baxes):
                b = shd.local_tree(batch)
                logits, cache = transformer.prefill(
                    params, cfg, b["tokens"], b.get("positions"),
                    b.get("frontend_embeds"))
                return (_logits_out(logits, cfg, mesh),
                        _cache_out(cache, params, cfg, mesh))
    elif cfg.enc_dec is not None:
        def prefill_step(params, batch):
            with shd.use_mesh(mesh):
                logits, _ = whisper.forward(params, cfg, batch["tokens"],
                                            batch["frontend_embeds"])
            return logits[:, -1:]
    else:
        def prefill_step(params, batch):
            with shd.use_mesh(mesh):
                return transformer.prefill(
                    params, cfg, batch["tokens"], batch.get("positions"),
                    batch.get("frontend_embeds"))

    params_a = _abstract_params(cfg)
    batch_a = train_input_specs(cfg, shape)
    batch_a.pop("labels")
    pspec = shd.param_specs(params_a, mesh)
    bspec = batch_specs(batch_a, mesh)
    baxes = _batch_axes(bspec) if ranked else ()
    return LoweredStep(prefill_step, (params_a, batch_a), (pspec, bspec),
                       None, model)


def _cache_out(cache: dict, params: dict, cfg: ModelCfg, mesh) -> dict:
    """Prefill's per-rank cache blocks as DTensors of the whole cache: the
    batch split as the batch's, K/V (lead, B, P, KV, hd) with the KV heads
    split as the projections', Mamba's conv (lead, B, K-1, d_in) and ssm
    (lead, B, d_in, N) with the channels split as its weights', RWKV's
    wkv (lead, B, H, hd, hd) and shifts (lead, B, D) whole but for the
    batch."""
    comm = shd.current_comm()
    heads = shd.split_axes(_first_leaf(params, "wk"), -2)
    chans = shd.split_axes(_first_leaf(params, "conv_w"), -2)
    names_of = {"kv_heads": heads, "mlp": chans}

    def one(key, leaf):
        lead = (None,) * (leaf.ndim - _base_ndim(key))
        if key.endswith("'k']") or key.endswith("'v']"):
            names = lead + ("batch", None, "kv_heads", None)
        elif "ssm" in key:
            names = lead + ("batch", "mlp", None)
        elif "conv" in key:
            names = lead + ("batch", None, "mlp")
        elif "wkv" in key:
            names = lead + ("batch", None, None, None)
        else:
            names = lead + ("batch", None)
        names = tuple(n if n is None or n == "batch" or names_of[n] else None
                      for n in names)
        shape = [d * (shd.batch_split() if n == "batch" else
                      math.prod(comm.sizes[a] for a in names_of[n])
                      if n is not None else 1)
                 for d, n in zip(leaf.shape, names)]
        return _as_dtensor(leaf, names, tuple(shape), mesh)
    return shd.map_with_path(one, cache)


def _first_leaf(tree, name: str):
    """The first leaf called ``name`` in a parameter tree (None if none)."""
    return next((leaf for key, leaf in shd.leaves_with_path(tree)
                 if key.endswith(f"'{name}']")), None)


def make_step(cfg: ModelCfg, shape: ShapeCfg, mesh, opt_bits: int = 32,
              microbatches: int = 1, device="cuda") -> LoweredStep:
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(state_bits=opt_bits)
        return make_train_step(cfg, shape, mesh, opt_cfg,
                               microbatches=microbatches, device=device)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, mesh, device=device)
    return make_serve_step(cfg, shape, mesh, device=device)
