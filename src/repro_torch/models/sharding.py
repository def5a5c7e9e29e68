"""Logical-axis sharding rules (MaxText-style), divisibility-checked.

Every tensor dimension carries a *logical* name; `LOGICAL_RULES` maps names
to mesh axes.  A dimension is sharded only if its size divides the mesh axis
product — otherwise it silently falls back to replication (e.g. 40 RWKV
heads on a 16-way model axis, or whisper's 51865 vocab).  This keeps one
rule-set valid for all 10 architectures on any mesh, which is what lets
`launch.dryrun` sweep 40 cells x 2 meshes without per-cell hand-sharding.

The port of ``repro.models.sharding``.  The rules, `spec`, `_leaf_axes`
and `param_specs` are the reference's logic, spec for spec.
`NamedSharding` pairs a mesh with a spec and gives the per-device shape
(`shard_shape`).  Two kinds of mesh:

  * logical devices on one card (`launch.mesh`): a spec changes no value
    and no placement, and `constrain` checks its names against the tensor
    and returns the tensor as it is;
  * a rank mesh (`core.distributed.make_rank_mesh`, one process a
    position): each rank holds its block of every parameter, moment,
    batch and cache as the specs say, as a ``DTensor`` (`shard_tree`;
    `placements` turns a spec into DTensor placements), and computes on
    plain blocks with explicit collectives (`core.ranks.MeshComm`):
    `local` hands a layer a weight with its FSDP dims gathered (and
    reduce-scatters its gradient over the batch's ranks), `constrain`
    moves an activation from the layout it is held in to the one its
    names give (a split, a gather, a sum of partial products) and checks
    it against the rules, `psum` / `psum_grad` are the tensor-parallel
    sums of a row- and a column-parallel product.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import types
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import _map_keyed
from repro_torch.core import ranks
from repro_torch.core.ranks import (dims_axes, is_dtensor, is_rank_mesh,
                                    rank_comm)


def _norm_part(part):
    """One entry as ``jax.sharding.PartitionSpec`` keeps it: a tuple of
    one name is the name, an empty tuple is None."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """Per-dimension mesh axes: a name, a tuple of names, or None
    (replicated); dims past its length are replicated.  A tuple, so it
    compares entry for entry with ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_norm_part(p) for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# Parallelism preset:
#   "2d"   — FSDP(data) x TP(model): the baseline below.
#   "fsdp" — ZeRO-style: batch over EVERY axis, params sharded over
#            (data, model), no tensor parallelism; sidesteps head-count
#            divisibility (gemma2-2b).  Needs global_batch % n_devices == 0.
PARALLELISM = os.environ.get("REPRO_PARALLELISM", "2d")

# logical axis -> mesh axes (tuple = sharded over several mesh axes)
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    # decode KV caches shard their sequence dim over "model": the batch
    # dim already owns (pod, data), and at 32k-512k the cache, not the
    # weights, is the per-device memory budget
    "kv_seq": ("model",),
    # sequence-parallel attention: when an arch's head count cannot shard
    # over "model" (gemma2-2b: 8 heads on a 16-way axis), the query/seq
    # dim takes the axis instead
    "qseq": ("model",),
    # unsharded logical axes
    "embed": (),
    "seq": (),
    "layers": (),
    "hd": (),
    "state": (),
    "conv": (),
    "cap": (),
    "pos3": (),
    # quantized-optimizer block payloads: shape-agnostic flat blocks shard
    # over every non-batch axis
    "opt_blocks": ("data", "model"),
}

if PARALLELISM == "fsdp":
    LOGICAL_RULES.update({
        "batch": ("pod", "data", "model"),
        "fsdp": ("data", "model"),
        "heads": (), "kv_heads": (), "mlp": (), "vocab": (),
        "experts": ("data", "model"),  # EP still shards expert weights
        "kv_seq": (), "qseq": (),
    })

# process-wide, not per thread: the autograd engine's device threads run
# the backward, and a remat'd group's forward again inside it, and must see
# the mesh the step set
_local = types.SimpleNamespace(mesh=None, comm=None, batch_axes=())


@contextlib.contextmanager
def use_mesh(mesh, device=None, batch_axes: Sequence[str] = ()):
    """Ambient mesh for `spec` and `constrain` (None = no mesh).  On a rank
    mesh also its collectives on ``device`` (`rank_comm`) and the mesh
    axes the batch is split over (``batch_axes``: the ranks whose
    gradients sum)."""
    prev = (getattr(_local, "mesh", None), getattr(_local, "comm", None),
            getattr(_local, "batch_axes", ()))
    _local.mesh = mesh
    _local.comm = (rank_comm(mesh, device) if is_rank_mesh(mesh)
                   else None)
    _local.batch_axes = tuple(batch_axes)
    try:
        yield
    finally:
        _local.mesh, _local.comm, _local.batch_axes = prev


def current_mesh():
    return getattr(_local, "mesh", None)


def current_comm():
    """The ambient rank mesh's `core.ranks.MeshComm`, or None."""
    return getattr(_local, "comm", None)


def _axes_for(mesh, dim: int, name: Optional[str]):
    """Mesh axes for one dim, or None if not divisible / unmapped."""
    if name is None:
        return None
    axes = tuple(a for a in LOGICAL_RULES.get(name, ())
                 if a in mesh.shape)
    if not axes:
        return None
    size = math.prod(mesh.shape[a] for a in axes)
    if dim % size != 0:
        # try a prefix of the axes (e.g. batch=(pod,data) -> (pod,))
        for cut in range(len(axes) - 1, 0, -1):
            sub = axes[:cut]
            if dim % math.prod(mesh.shape[a] for a in sub) == 0:
                return sub if len(sub) > 1 else sub[0]
        return None
    return axes if len(axes) > 1 else axes[0]


def spec(shape: Sequence[int], names: Sequence[Optional[str]],
         mesh=None) -> PartitionSpec:
    mesh = mesh or current_mesh()
    if mesh is None:
        return P()
    assert len(shape) == len(names), (shape, names)
    used: set[str] = set()
    parts = []
    for dim, nm in zip(shape, names):
        ax = _axes_for(mesh, dim, nm)
        # one mesh axis may shard at most one dim
        flat = ax if isinstance(ax, tuple) else (ax,) if ax else ()
        if any(a in used for a in flat):
            ax = None
        else:
            used.update(flat)
        parts.append(ax)
    return P(*parts)


def _spec_axes(part) -> tuple:
    return () if part is None else part if isinstance(part, tuple) \
        else (part,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each dimension of a tensor is split."""
    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, global_shape: Sequence[int]) -> tuple:
        """Per-device shape: a dim split over axes of total size k holds
        ``dim // k`` a device; k must divide it."""
        shape = list(global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {tuple(shape)} has dims")
        for i, part in enumerate(self.spec):
            k = math.prod(self.mesh.shape[a] for a in _spec_axes(part))
            if shape[i] % k:
                raise ValueError(f"dim {i} of {tuple(global_shape)} does "
                                 f"not split {k} ways ({self.spec})")
            shape[i] //= k
        return tuple(shape)


def constrain(x, names: Sequence[Optional[str]], *,
              held: Optional[Sequence[Optional[str]]] = None,
              partial: Sequence[str] = ()):
    """A layout constraint under the ambient mesh.  On logical devices of
    one card it moves no data: ``x`` is returned as it is, once its names
    have been checked against its rank.

    On a rank mesh ``x`` is this rank's block of a tensor laid out as
    ``held`` says (default: ``names``, already in place), holding partial
    sums over the mesh axes ``partial`` (a product contracted over a dim
    split on them).  The partial sums are summed (all-reduce), and each
    dim whose axes differ between ``held`` and ``names`` is gathered from
    or split into the ranks along them.  The held layout must be the one
    the rules give for the global shape (raises otherwise)."""
    if len(names) != x.ndim:
        raise ValueError(f"{len(names)} names {tuple(names)} for a tensor "
                         f"of rank {x.ndim}")
    comm = current_comm()
    if comm is None:
        return x
    held = tuple(names if held is None else held)
    if len(held) != x.ndim:
        raise ValueError(f"held names {held} for a tensor of rank {x.ndim}")
    mesh = current_mesh()
    src = [tuple(a for a in LOGICAL_RULES.get(n, ()) if a in mesh.shape)
           if n is not None else () for n in held]
    glob = [d * math.prod(mesh.shape[a] for a in ax)
            for d, ax in zip(x.shape, src)]
    if [_spec_axes(p) for p in _padded(spec(glob, held, mesh), x.ndim)] \
            != [tuple(a) for a in src]:
        raise ValueError(f"a block of shape {tuple(x.shape)} held as "
                         f"{held} is not a layout the rules give on mesh "
                         f"{dict(mesh.shape)}")
    dst = [_spec_axes(p) for p in _padded(spec(glob, names, mesh), x.ndim)]
    if partial:
        x = psum(x, partial)
    # every gather before any split: an axis that moves from one dim to
    # another must be gathered off the first while the ranks still hold
    # the same blocks of the second
    moved = [(dim, a, b) for dim, (a, b) in enumerate(zip(src, dst))
             if a != b]
    for dim, a, _ in moved:
        if a:
            x = _Gather.apply(x, dim, comm.moving(a))
    for dim, _, b in moved:
        if b:
            x = _Split.apply(x, dim, comm.moving(b))
    return x


def _padded(sp: PartitionSpec, ndim: int) -> list:
    return list(sp) + [None] * (ndim - len(sp))


def named_sharding(mesh, shape: Sequence[int],
                   names: Sequence[Optional[str]]) -> NamedSharding:
    return NamedSharding(mesh, spec(shape, names, mesh))


# ---------------------------------------------------------------------------
# Parameter specs: leaf-name based rules.
# Init code names every leaf so these rules are total; anything unknown is
# replicated (safe default).
# ---------------------------------------------------------------------------
_PARAM_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    ("tok_embed", ("vocab", "fsdp")),
    ("pos_embed", (None, None)),
    ("lm_head", ("fsdp", "vocab")),
    ("wq", ("fsdp", "heads", None)),
    ("wk", ("fsdp", "kv_heads", None)),
    ("wv", ("fsdp", "kv_heads", None)),
    ("wo", ("heads", None, "fsdp")),
    ("bq", ("heads", None)),
    ("bk", ("kv_heads", None)),
    ("bv", ("kv_heads", None)),
    ("w_gate", ("fsdp", "mlp")),
    ("w_up", ("fsdp", "mlp")),
    ("w_down", ("mlp", "fsdp")),
    ("router", ("fsdp", None)),
    ("we_gate", ("experts", "fsdp", None)),
    ("we_up", ("experts", "fsdp", None)),
    ("we_down", ("experts", None, "fsdp")),
    ("ws_gate", ("fsdp", "mlp")),     # shared expert
    ("ws_up", ("fsdp", "mlp")),
    ("ws_down", ("mlp", "fsdp")),
    ("in_proj", ("fsdp", "mlp")),
    ("conv_w", ("mlp", None)),
    ("conv_b", ("mlp",)),
    ("x_proj", ("mlp", None)),
    ("dt_w", (None, "mlp")),
    ("dt_b", ("mlp",)),
    ("A_log", ("mlp", None)),
    ("D_skip", ("mlp",)),
    ("out_proj", ("mlp", "fsdp")),
    ("w_r", ("fsdp", "mlp")),
    ("w_k", ("fsdp", "mlp")),
    ("w_v", ("fsdp", "mlp")),
    ("w_g", ("fsdp", "mlp")),
    ("w_o", ("mlp", "fsdp")),
    ("decay_a", ("fsdp", None)),
    ("decay_b", (None, "fsdp")),
]


def _leaf_axes(path: str, ndim: int) -> tuple[Optional[str], ...]:
    for key, names in _PARAM_RULES:
        if path.endswith(key) or f"{key}'" in path or f"{key}]" in path:
            if len(names) == ndim:
                return names
            if len(names) == ndim - 1:       # scan-stacked: leading layer dim
                return (None,) + names
            if len(names) == ndim - 2:       # stacked + grouped
                return (None, None) + names
    return (None,) * ndim


def _is_leaf(x) -> bool:
    """A spec, or anything with a shape and a dtype (a tensor, a
    `models.model.ShapeDtype`); a `QTensor` has no dtype and is a node."""
    return isinstance(x, PartitionSpec) or (hasattr(x, "shape")
                                            and hasattr(x, "dtype"))


def map_with_path(fn, tree: Any) -> Any:
    """``fn(key, leaf)`` over a tree of tensors, shape records or specs,
    keyed as the reference's ``jax.tree_util.keystr`` (the checkpoint's
    keys); the structure is kept."""
    return _map_keyed(fn, tree, is_leaf=_is_leaf)


def leaves_with_path(tree: Any) -> list:
    """``(key, leaf)`` pairs of a tree, in `map_with_path`'s order."""
    out = []
    map_with_path(lambda key, leaf: out.append((key, leaf)), tree)
    return out


def param_specs(params, mesh=None):
    """Tree of PartitionSpec for a params tree (name-rule based)."""
    mesh = mesh or current_mesh()
    return map_with_path(
        lambda key, w: spec(w.shape, _leaf_axes(key, w.ndim), mesh)
        if mesh else P(), params)


def param_shardings(params, mesh):
    return map_with_path(lambda key, s: NamedSharding(mesh, s),
                         param_specs(params, mesh))


# ---------------------------------------------------------------------------
# Rank meshes: one process a position (see the module docstring)
# ---------------------------------------------------------------------------
def batch_axes() -> tuple:
    """The ambient mesh axes the batch is split over (`use_mesh`)."""
    return getattr(_local, "batch_axes", ())


def batch_split() -> int:
    """How many blocks the batch is split into on the ambient rank mesh
    (1 elsewhere): a batch mean divides a block's sum by this times its
    rows."""
    comm = current_comm()
    if comm is None:
        return 1
    return math.prod(comm.sizes[a] for a in batch_axes())


def placements(sp: PartitionSpec, mesh) -> tuple:
    """A spec as DTensor placements over the mesh's axes: ``Shard(d)`` on
    every axis that splits dim ``d`` (a dim split over a tuple of axes is
    sharded on each, major to minor, which must be the mesh's order),
    ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.axis_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(sp):
        idx = [names.index(a) for a in _spec_axes(part)]
        if idx != sorted(idx):
            raise ValueError(f"spec {sp} splits dim {dim} over axes out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def fsdp_axes() -> tuple:
    """The mesh axes a layer gathers its weights over before use."""
    return tuple(LOGICAL_RULES["fsdp"])


def split_axes(w, dim: int) -> tuple:
    """The mesh axes (of more than one rank) that dim ``dim`` of weight
    ``w`` stays split over in the layer's product — the tensor-parallel
    ones, not the FSDP ones `local` gathers; () for a plain tensor."""
    comm = current_comm()
    if comm is None or not is_dtensor(w):
        return ()
    axes = dims_axes(w).get(dim % w.ndim, ())
    return comm.moving(tuple(a for a in axes if a not in fsdp_axes()))


def offset(w, dim: int) -> int:
    """The global index where this rank's block of ``w``'s dim ``dim``
    starts, over its `split_axes` (0 for a plain tensor)."""
    axes = split_axes(w, dim)
    return current_comm().offset(w.shape[dim], axes) if axes else 0


class _Sum(torch.autograd.Function):
    """Sum over ``axes`` forward (a row-parallel product's partial sums);
    the gradient passes as it is (every rank's input feeds the sum)."""

    @staticmethod
    def forward(ctx, x, axes):
        return current_comm().all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    """Identity forward on an input every rank along ``axes`` holds whole
    (a column-parallel product's); its gradient, partial on each, is
    summed over them."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.comm = axes, current_comm()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, ctx.axes), None


class _Gather(torch.autograd.Function):
    """The ranks' blocks along ``dim`` joined; the gradient of a result
    every rank then uses whole is the same on each: its block is kept."""

    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.dim, ctx.axes, ctx.comm = dim, axes, current_comm()
        return ctx.comm.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.block(g, ctx.dim, ctx.axes).contiguous(), None, None


class _Split(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor every rank holds whole;
    the gradient gathers the blocks."""

    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.dim, ctx.axes, ctx.comm = dim, axes, current_comm()
        return ctx.comm.block(x, dim, axes).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, ctx.axes), None, None


def psum(x, axes: Sequence[str]):
    """The sum over ``axes`` of a product contracted over a dim split on
    them (a row-parallel product); a plain tensor off a rank mesh."""
    comm = current_comm()
    axes = comm.moving(axes) if comm is not None else ()
    return _Sum.apply(x, axes) if axes else x


def psum_grad(x, axes: Sequence[str]):
    """``x`` as it is, entering products split over ``axes`` (column-
    parallel ones): its gradient is summed over them."""
    comm = current_comm()
    axes = comm.moving(axes) if comm is not None else ()
    return _SumGrad.apply(x, axes) if axes else x


class _Local(torch.autograd.Function):
    """A DTensor weight as the plain block a layer computes with: its FSDP
    dims gathered.  The gradient of that block is summed over the batch's
    ranks — reduce-scattered along a dim split on the axis, all-reduced
    where the weight is whole on it — and handed back as a DTensor with
    the weight's placements."""

    @staticmethod
    def forward(ctx, w):
        comm = current_comm()
        fsdp = fsdp_axes()
        gather = {d: comm.moving(tuple(a for a in ax if a in fsdp))
                  for d, ax in dims_axes(w).items()}
        gather = {d: ax for d, ax in gather.items() if ax}
        ctx.comm, ctx.gather, ctx.batch = comm, gather, comm.moving(
            batch_axes())
        ctx.meta = (w.device_mesh, w.placements, w.shape, w.stride())
        t = w.to_local()
        for d, ax in gather.items():
            t = comm.all_gather(t, d, ax)
        return t if gather else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        comm = ctx.comm
        split = {a: d for d, ax in ctx.gather.items() for a in ax}
        for a in ctx.batch:
            if a not in split:
                g = comm.all_reduce(g, (a,))
        for d, ax in ctx.gather.items():
            summed = tuple(a for a in ax if a in ctx.batch)
            g = comm.reduce_scatter(g, d, summed) if summed else g
            kept = tuple(a for a in ax if a not in ctx.batch)
            g = comm.block(g, d, kept) if kept else g
        mesh, pl, shape, stride = ctx.meta
        return DTensor.from_local(g.contiguous(), mesh, pl, run_check=False,
                                  shape=shape, stride=stride)


def local(w):
    """The block of weight ``w`` this rank computes with (see `_Local`);
    a plain tensor is returned as it is."""
    if current_comm() is None or not is_dtensor(w):
        return w
    return _Local.apply(w)


def local_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as its local block (no gathers, no
    gradient; plain leaves as they are): what this rank holds."""
    return map_with_path(lambda _, x: local_block(x), tree)


def shard_tree(tree: Any, specs: Any, mesh, device) -> Any:
    """A tree of whole tensors or arrays (the same on every rank) as
    per-rank DTensors on ``device``: each leaf's block by its spec."""
    from torch.distributed.tensor import DTensor

    comm = rank_comm(mesh, device)
    by_key = dict(leaves_with_path(specs))

    def one(key, x):
        full = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x.detach()
        sp = by_key[key]
        NamedSharding(mesh, sp).shard_shape(full.shape)
        blk = full
        for dim, part in enumerate(sp):
            blk = comm.block(blk, dim, _spec_axes(part))
        # a copy: the block must not keep the whole leaf alive
        blk = blk.to(device, copy=True, memory_format=torch.contiguous_format)
        return DTensor.from_local(blk, comm.dm, placements(sp, mesh),
                                  run_check=False, shape=full.shape,
                                  stride=full.contiguous().stride())

    return map_with_path(one, tree)


def full_tree(tree: Any) -> Any:
    """Every DTensor leaf gathered whole on every rank, a new tensor (plain
    leaves as they are): what one process would hold."""
    comm = current_comm()
    return map_with_path(
        lambda _, x: ranks.whole(x, comm) if is_dtensor(x) else x, tree)


def rank_comm_of(x):
    """The `MeshComm` of a DTensor's mesh, the ambient one first."""
    return ranks.rank_comm_of(x, current_comm())


def local_block(x):
    """A DTensor's local block (the tensor itself, written in place by
    in-place ops on it); a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def shard_axes(x) -> tuple:
    """Every mesh axis (of more than one rank) some dim of DTensor ``x`` is
    split over, in the mesh's order; () for a plain tensor."""
    if not is_dtensor(x):
        return ()
    sizes = dict(zip(x.device_mesh.mesh_dim_names, x.device_mesh.shape))
    return tuple(name for name, pl in zip(x.device_mesh.mesh_dim_names,
                                          x.placements)
                 if pl.is_shard() and sizes[name] > 1)
