"""Gradient compression with error feedback (distributed-optimization trick).

int8 per-tensor-block quantization of gradients before the cross-replica
all-reduce, with an error-feedback accumulator so the quantization error is
re-injected next step (Karimireddy et al.-style EF-SGD guarantee: same
fixed point as uncompressed training):

  g_q, new_err = compress(g + err);  g_sync = all_reduce(decompress(g_q)) / n

The payload is a quarter of a float32 gradient's bytes and half of a
bf16 one's, plus a float32 scale per `BLOCK` values.

The port of ``repro.runtime.compression``, over the port's trees
(`optim.adamw.tree_leaves` order).  The op order is the reference's
(float32, pad to `BLOCK`, ``max|.|/127``, ``maximum(., 1e-12)``, divide,
round half to even, clip, int8), so the payload, the scales and the
error equal the reference's bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

BLOCK = 256  # quantization block (per-block scale)


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 payload (nblocks, BLOCK)
    scale: torch.Tensor    # f32 per-block scales (nblocks,)
    shape: tuple           # original shape


def _pad_len(n: int) -> int:
    return (-n) % BLOCK


def compress(g: torch.Tensor) -> tuple[Compressed, torch.Tensor]:
    """Returns (compressed, error) with g ≈ decompress(compressed) + error."""
    shape = tuple(g.shape)
    flat = g.float().reshape(-1)
    pad = _pad_len(flat.numel())
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)
    err_full = flat - deq
    if pad:
        err_full = err_full[:-pad]
    return Compressed(q, scale[:, 0], shape), err_full.reshape(shape)


def decompress(c: Compressed) -> torch.Tensor:
    deq = (c.q.float() * c.scale[:, None]).reshape(-1)
    return deq[:math.prod(c.shape)].reshape(c.shape)


def ef_compress_tree(grads: Any, err: Any) -> tuple[Any, Any]:
    """Error-feedback compression over a tree.

    Returns (compressed_tree, new_err_tree); pair with `decompress_tree`
    after the all-reduce.
    """
    comp, new_err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        c, ne = compress(g + e.float())
        comp.append(c)
        new_err.append(ne.to(g.dtype))
    return tree_unflatten(grads, comp), tree_unflatten(grads, new_err)


def decompress_tree(comp: Any) -> Any:
    return _map_compressed(decompress, comp)


def _map_compressed(fn, tree: Any) -> Any:
    """``fn`` over the `Compressed` leaves of a tree (a `Compressed` is a
    tuple, which `optim.adamw.tree_map` would walk into)."""
    if isinstance(tree, Compressed):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_compressed(fn, tree[k]) for k in sorted(tree)}
    return type(tree)(_map_compressed(fn, v) for v in tree)


def init_error(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
