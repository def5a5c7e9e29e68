"""AdamW + gradient clipping + LR schedules, in plain PyTorch.

The port of `repro.optim.adamw`.  Optimizer state mirrors the parameter
tree (nested dicts, leaves in sorted-key order as the reference's
``jax.tree.leaves``): float32 moments, or blockwise int8 moments with a
float32 scale per block of `QBLOCK` (`QTensor`).

`apply` updates **in place**, leaf by leaf under ``torch.no_grad()``: the
parameters, the moments and the step counter are written into the
tensors the caller passed, which it returns.  That is the reference's
donation contract (its train step donates the state): at gemma2-2b's
width a functional update would hold two copies of a 31 GB training
state.  The caller may not reuse the old trees.

Arithmetic follows the reference op for op in float32; the bias
corrections' ``b ** step`` are taken in float64 and rounded once (XLA's
float32 ``pow`` is close to correctly rounded; ROADMAP Queue 3).

On a rank mesh the parameters, gradients and float32 moments are
DTensors (`models.sharding`): `global_norm` sums each leaf's squares over
its blocks' ranks, and `apply` updates each rank's blocks in place.
8-bit moments are `QTensor`s whose ``q`` and ``scale`` are DTensors split
along their block dim as the ``opt_blocks`` rule gives (`init`): a rank
owns whole quantization blocks, that is a range of the leaf's flat
row-major entries, which its block of the parameter does not hold.  So
`apply` moves each leaf's parameter and gradient entries into the flat
range of the rank that owns them (`core.ranks.MeshComm.exchange`), runs
the update there, requantizes its own blocks (a block's scale is the max
of its own 256 entries: one process's `_quantize`) and moves the new
parameter entries back; a leaf at a time, so no rank holds more than one
leaf's float32 range beyond its blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_bits: int = 32     # 8 => blockwise-quantized moments


class OptState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    mu: Any
    nu: Any


QBLOCK = 256


@dataclasses.dataclass
class QTensor:
    """Blockwise int8 quantized moment (bitsandbytes-style, deterministic):
    ``q`` (nblocks, QBLOCK) int8 over the padded flat moment, ``scale``
    (nblocks,) float32, ``shape`` the logical shape.  ``tree_flatten`` /
    ``tree_unflatten`` name its children as the reference's registered
    pytree class does, so checkpoints key them alike."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple

    def tree_flatten(self):
        return (self.q, self.scale), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)


def _quantize(x: torch.Tensor) -> QTensor:
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % QBLOCK))
    blocks = flat.reshape(-1, QBLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-20)
    # torch.round rounds half to even, as jnp.round
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale[:, 0], shape)


def _dequantize(t: QTensor) -> torch.Tensor:
    flat = (t.q.float() * t.scale[:, None]).reshape(-1)
    return flat[:math.prod(t.shape)].reshape(t.shape)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (float32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * decay


def tree_leaves(tree: Any) -> list:
    """Leaves in the reference's order: dict keys sorted, then list order;
    a `QTensor` is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` over the leaves, visited in `tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` (in `tree_leaves` order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def init(params: Any, state_bits: int = 32) -> OptState:
    """Zero moments (float32, or 8-bit `QTensor`s) and step 0, on the
    parameters' device."""
    device = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    ranked = _ranked(params)

    def zeros(p):
        if ranked:      # a DTensor of the parameter's placements
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if state_bits != 8:
        moment = zeros
    elif ranked:
        moment = _ranked_zero_moment
    else:
        def moment(p):
            return _quantize(zeros(p))
    return OptState(step, tree_map(moment, params), tree_map(moment, params))


def _ranked(tree: Any) -> bool:
    from repro_torch.core.ranks import is_dtensor
    return any(is_dtensor(x) for x in tree_leaves(tree))


def _block_mesh(p):
    """A DTensor's mesh as the sharding rules read one: its axis sizes."""
    import types
    dm = p.device_mesh
    return types.SimpleNamespace(axis_names=tuple(dm.mesh_dim_names),
                                 shape=dict(zip(dm.mesh_dim_names,
                                                dm.shape)))


def _ranked_zero_moment(p) -> QTensor:
    """`_quantize` of a zero moment of DTensor ``p``, as this rank's
    blocks: ``q`` (nblocks, QBLOCK) and ``scale`` (nblocks,) split along
    the blocks as the ``opt_blocks`` rule gives (the `launch.steps`
    moment specs)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import sharding as shd

    mesh = _block_mesh(p)
    nblocks = -(-math.prod(p.shape) // QBLOCK)
    sp = shd.spec((nblocks, QBLOCK), ("opt_blocks", None), mesh)
    pl = shd.placements(sp, mesh)
    rows = shd.NamedSharding(mesh, sp).shard_shape((nblocks, QBLOCK))[0]
    zero = _quantize(torch.zeros(rows * QBLOCK, device=p.to_local().device))
    dm = p.device_mesh
    return QTensor(
        DTensor.from_local(zero.q, dm, pl, run_check=False,
                           shape=torch.Size((nblocks, QBLOCK)),
                           stride=(QBLOCK, 1)),
        DTensor.from_local(zero.scale, dm, pl, run_check=False,
                           shape=torch.Size((nblocks,)), stride=(1,)),
        tuple(p.shape))


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not _ranked(tree):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    from repro_torch.models import sharding as shd

    # each leaf's sum of squares over its blocks' ranks (one all-reduce
    # for the leaves split alike), then added in leaf order
    sq = [torch.sum(torch.square(shd.local_block(g).float()))
          for g in leaves]
    by_axes: dict = {}
    for i, g in enumerate(leaves):
        by_axes.setdefault(shd.shard_axes(g), []).append(i)
    for axes, idx in by_axes.items():
        if axes:
            comm = shd.rank_comm_of(leaves[idx[0]])
            tot = comm.all_reduce(torch.stack([sq[i] for i in idx]), axes)
            for j, i in enumerate(idx):
                sq[i] = tot[j]
    return torch.sqrt(sum(sq))


def _pow32(base: float, step: torch.Tensor) -> torch.Tensor:
    """float32(base) ** step, taken in float64 and rounded once."""
    b = float(torch.tensor(base, dtype=torch.float32))
    return torch.pow(b, step.double()).float()


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: Any, state: OptState, params: Any
          ) -> tuple[Any, OptState, dict]:
    """One AdamW step, in place: returns ``params`` and ``state`` (the
    same objects, updated) and ``{"grad_norm", "lr"}`` (grad_norm before
    clipping).  Gradients may be in the leaf's dtype or float32.  On a
    rank mesh every leaf is a DTensor and each rank updates its blocks."""
    ranked = _ranked(params)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step
    if ranked:          # replicated: every rank's block is the whole
        from repro_torch.models.sharding import local_block
        step = local_block(step)
    step.add_(1)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - _pow32(b1, step)
    bc2 = 1.0 - _pow32(b2, step)
    quantized = cfg.state_bits == 8

    def update(p, g, mu, nu, ndim):
        """The new parameter values (float32) of entries ``p`` with
        gradients ``g``; the moments ``mu`` and ``nu`` updated in place."""
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        u = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        p32 = p.float()
        if ndim >= 2:          # stacked (G, d) norm scales are decayed too
            u.add_(cfg.weight_decay * p32)
        return p32 - u.mul_(lr)

    leaves = zip(*map(tree_leaves, (params, grads, state.mu, state.nu)))
    if ranked and quantized:
        for p, g, mu_t, nu_t in leaves:
            _ranked_quantized_update(update, p, g, mu_t, nu_t)
        return params, state, {"grad_norm": gnorm, "lr": lr}
    if ranked:
        from repro_torch.models.sharding import local_block
        leaves = ([local_block(x) for x in four] for four in list(leaves))
    for p, g, mu_t, nu_t in leaves:
        mu = _dequantize(mu_t) if quantized else mu_t
        nu = _dequantize(nu_t) if quantized else nu_t
        p.copy_(update(p, g, mu, nu, p.ndim))
        if quantized:
            for t, new in ((mu_t, _quantize(mu)), (nu_t, _quantize(nu))):
                t.q.copy_(new.q)
                t.scale.copy_(new.scale)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _ranked_quantized_update(update, p, g, mu_t: QTensor, nu_t: QTensor
                             ) -> None:
    """`apply`'s update of one DTensor leaf with 8-bit moments: the
    parameter and gradient entries of this rank's quantization blocks
    moved in from the ranks that hold them, updated against the
    dequantized blocks, the blocks requantized in place and the new
    parameter entries moved back into every rank's block of ``p``."""
    from repro_torch.core import ranks
    from repro_torch.models import sharding as shd

    comm = shd.rank_comm_of(p)
    box = ranks.BoxLayout(p.shape, ranks.dims_axes(p))
    if ranks.dims_axes(g) != box.dims_axes:
        raise ValueError(f"a gradient laid out as {ranks.dims_axes(g)} for "
                         f"a parameter laid out as {box.dims_axes}")
    flat = ranks.FlatLayout(p.shape, ranks.dims_axes(mu_t.q).get(0, ()),
                            QBLOCK)
    start, stop = flat.span(comm.coord, comm.sizes)
    n = stop - start

    def moved(x):
        local = x.to_local()
        return comm.exchange(local, box, local.new_empty(n), flat)

    def dequantized(t):
        q, s = t.q.to_local(), t.scale.to_local()
        return (q.float() * s[:, None]).reshape(-1)[:n]

    mu, nu = dequantized(mu_t), dequantized(nu_t)
    new_p = update(moved(p), moved(g), mu, nu, p.ndim).to(p.dtype)
    for t, m in ((mu_t, mu), (nu_t, nu)):
        q, s = t.q.to_local(), t.scale.to_local()
        new = _quantize(F.pad(m, (0, q.numel() - n)))
        q.copy_(new.q)
        s.copy_(new.scale)
    comm.exchange(new_p, flat, p.to_local(), box)
