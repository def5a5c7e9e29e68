"""Logical-axis sharding rules (MaxText-style), divisibility-checked.

Every tensor dimension carries a *logical* name; `LOGICAL_RULES` maps names
to mesh axes.  A dimension is sharded only if its size divides the mesh axis
product — otherwise it silently falls back to replication (e.g. 40 RWKV
heads on a 16-way model axis, or whisper's 51865 vocab).  This keeps one
rule-set valid for all 10 architectures on any mesh, which is what lets
`launch.dryrun` sweep 40 cells x 2 meshes without per-cell hand-sharding.

The port of ``repro.models.sharding``.  The rules, `spec`, `_leaf_axes`
and `param_specs` are the reference's logic, spec for spec.  Its meshes
are logical devices on one card (`launch.mesh`), so a spec changes no
value and no placement: `NamedSharding` pairs a mesh with a spec and
gives the per-device shape (`shard_shape`), and `constrain` checks its
names against the tensor and returns the tensor as it is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Any, Optional, Sequence

from repro_torch.checkpoint.checkpoint import _map_keyed


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

_local = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Ambient mesh for `spec` and `constrain` (None = no mesh)."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield
    finally:
        _local.mesh = prev


def current_mesh():
    return getattr(_local, "mesh", None)


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


def constrain(x, names: Sequence[Optional[str]]):
    """A layout constraint under the ambient mesh.  On logical devices of
    one card it moves no data: ``x`` is returned as it is, once its names
    have been checked against its rank."""
    if len(names) != x.ndim:
        raise ValueError(f"{len(names)} names {tuple(names)} for a tensor "
                         f"of rank {x.ndim}")
    return x


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
