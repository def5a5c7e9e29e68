"""Ranks of a process group as the devices of a sharded p-bit mesh.

The reference's `ShardedEngine` puts each row band on its own device under
``shard_map`` and moves halos by ``ppermute``.  The port's counterpart runs
one process a rank of a ``torch.distributed`` process group, one card a
rank on CUDA:

  * `rank_grid` splits the mesh axes over the ranks (how many ranks along
    each axis), and `rank_blocks` reads off each rank's contiguous run of
    row bands and chain shards from a rank mesh
    (`core.distributed.make_rank_mesh`).
  * `RankComm` is one rank's side of the transport: its first and last
    bands' boundary rows to and from its row neighbours in one
    ``batch_isend_irecv`` (`swap_edges`), and ``all_gather`` of the
    rank's parts (`all_gather`), which the engine assembles into global
    tensors.  NCCL carries CUDA tensors.  Gloo carries CPU tensors; with
    CUDA tensors it stages them through host memory, only because the
    caller chose gloo, and `transport` says so ("gloo (host-staged)").
  * `init_rank` is the rendezvous: a ``FileStore`` shared by the ranks, or
    torchrun's environment; `require_cards` refuses NCCL with fewer cards
    than ranks (no quiet fall back to gloo or the CPU).
"""
from __future__ import annotations

import datetime
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 60.0   # a rank waits this long for a peer, then fails


def rank_grid(axis_shapes, world: int) -> tuple[int, ...]:
    """Ranks along each mesh axis: ``world`` split over the axes in order,
    each taking the largest share of the remaining ranks that divides its
    size (so every rank holds a contiguous block of every axis).  Raises
    when ``world`` does not divide the mesh."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    n = math.prod(axis_shapes)
    if world < 1 or n % world:
        raise ValueError(
            f"a world of {world} ranks does not divide the mesh "
            f"{axis_shapes} ({n} positions); use a world size that "
            f"divides {n}")
    left, grid = world, []
    for size in axis_shapes:
        k = math.gcd(left, size)
        grid.append(k)
        left //= k
    if left != 1:   # unreachable when world divides n; kept as a guard
        raise ValueError(f"cannot split {world} ranks over {axis_shapes}")
    return tuple(grid)


def rank_ids(axis_shapes, grid) -> np.ndarray:
    """The rank of every mesh position, shaped like the axes: position
    ``i`` along axis ``a`` is in the ``i // (size_a / grid_a)``-th block,
    and the blocks are numbered row-major over the rank grid."""
    idx = np.indices(tuple(axis_shapes)).reshape(len(axis_shapes), -1)
    coords = [i // (s // k) for i, s, k in zip(idx, axis_shapes, grid)]
    return np.ravel_multi_index(coords, tuple(grid)).reshape(
        tuple(axis_shapes)).astype(np.int64)


def rank_blocks(mesh, rows_axes, chain_axes) -> list[tuple[int, ...]]:
    """Each rank's ``(band0, band1, shard0, shard1)``: the contiguous run
    of row bands and of chain shards it owns under a partition with
    ``rows_axes`` / ``chain_axes``.  Raises where the ranks split an axis
    the partition does not shard (they would be replicas)."""
    names = list(mesh.axis_names)
    part = [names.index(a) for a in tuple(rows_axes) + tuple(chain_axes)]
    rest = [i for i in range(len(names)) if i not in part]
    n_row = math.prod(mesh.shape[a] for a in rows_axes)
    n_chain = math.prod(mesh.shape[a] for a in chain_axes)
    t = np.asarray(mesh.ranks).transpose(part + rest).reshape(
        n_row, n_chain, -1)
    if (t != t[:, :, :1]).any():
        raise ValueError(
            f"the ranks split a mesh axis the partition does not shard "
            f"(axes {names}, rows {tuple(rows_axes)}, chains "
            f"{tuple(chain_axes)}); partition every axis the ranks split")
    t = t[:, :, 0]
    blocks = []
    for k in range(int(t.max()) + 1):
        rows = np.nonzero((t == k).any(axis=1))[0]
        cols = np.nonzero((t == k).any(axis=0))[0]
        b = (int(rows[0]), int(rows[-1]) + 1, int(cols[0]),
             int(cols[-1]) + 1)
        if (len(rows) != b[1] - b[0] or len(cols) != b[3] - b[2]
                or (t[b[0]:b[1], b[2]:b[3]] != k).any()):
            raise ValueError(f"rank {k} does not own a contiguous block of "
                             f"row bands and chain shards")
        blocks.append(b)
    return blocks


def require_cards(backend: str, world: int) -> None:
    """NCCL runs one card a rank: raise when this host has fewer cards
    than ``world`` (it is not turned into gloo)."""
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world:
            raise RuntimeError(
                f"NCCL runs one card a rank: {world} ranks need {world} "
                f"cards and this host has {cards}; run fewer ranks, or "
                f"choose backend='gloo' to share cards through host memory")


def local_rank() -> int:
    """This process's card index on its host: ``LOCAL_RANK`` (torchrun's),
    else ``RANK``, else 0."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def check_rank_device(group, device) -> None:
    """Under NCCL a rank samples on its own card, ``cuda:{LOCAL_RANK}``;
    raise on any other device.  Gloo ranks may share a card or run on the
    CPU."""
    if dist.get_backend(group) != "nccl":
        return
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"NCCL carries CUDA tensors; this rank's device is "
                         f"{dev}")
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    if index != local_rank():
        raise ValueError(
            f"rank {dist.get_rank(group)}'s device is cuda:{index}, not its "
            f"own card cuda:{local_rank()} (LOCAL_RANK); call "
            f"torch.cuda.set_device(LOCAL_RANK) and sample on that card")


def init_rank(backend: str, rank: int, world: int, store_path=None,
              timeout_s: float = RANK_TIMEOUT_S) -> None:
    """Join the default process group as ``rank`` of ``world``: through a
    ``FileStore`` at ``store_path`` (every rank names the same file), or
    through torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``)
    when it is None.  Under NCCL this process's card is ``LOCAL_RANK``'s
    (`require_cards` first).  A peer that does not arrive within
    ``timeout_s`` fails the rank."""
    require_cards(backend, world)
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    kw = dict(backend=backend, rank=int(rank), world_size=int(world),
              timeout=datetime.timedelta(seconds=timeout_s))
    if store_path is not None:
        kw["store"] = dist.FileStore(str(store_path), int(world))
    dist.init_process_group(**kw)


class RankComm:
    """One rank's side of the rank mesh's transport (see the module
    docstring).  ``blocks``: every rank's `rank_blocks` entry; the row
    neighbours are the ranks whose bands end just above this rank's first
    band and start just below its last, on the same chain shards."""

    def __init__(self, group, blocks, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        if len(blocks) != self.world:
            raise ValueError(f"the mesh names {len(blocks)} ranks, the "
                             f"process group has {self.world}")
        self.backend = dist.get_backend(group)
        check_rank_device(group, device)
        dev = torch.device(device)
        self.staged = self.backend == "gloo" and dev.type == "cuda"
        self.transport = ("gloo (host-staged)" if self.staged
                          else self.backend)
        r0, r1, c0, c1 = blocks[self.rank]

        def peer(pred):
            k = next((k for k, b in enumerate(blocks)
                      if pred(b) and b[2:] == (c0, c1)), None)
            if k is None or group is None:
                return k
            return dist.get_global_rank(group, k)

        self.up = peer(lambda b: b[1] == r0)
        self.dn = peer(lambda b: b[0] == r1)
        self.bytes_sent = 0     # boundary bytes this rank sent, a counter
        # host seconds inside swap_edges / all_gather, staging included
        # (under NCCL the enqueue only: its work is asynchronous)
        self.seconds = 0.0

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def swap_edges(self, first: torch.Tensor, last: torch.Tensor):
        """``first`` (B, H), the first band's first-row boundary, to the
        rank above; ``last``, the last band's last row, to the rank below;
        one ``batch_isend_irecv``.  Returns (from_up, from_dn): the rank
        above's last row (this rank's first ``halo_up``) and the rank
        below's first row (its last ``halo_dn``); zeros past the lattice's
        edge."""
        t0 = time.perf_counter()
        from_up, from_dn = torch.zeros_like(first), torch.zeros_like(last)
        ops, recv = [], []
        for peer, send, into in ((self.up, first, from_up),
                                 (self.dn, last, from_dn)):
            if peer is None:
                continue
            out = self._host(send).contiguous()
            buf = torch.empty_like(out)
            ops += [dist.P2POp(dist.isend, out, peer, self.group),
                    dist.P2POp(dist.irecv, buf, peer, self.group)]
            recv.append((buf, into))
            self.bytes_sent += out.numel() * out.element_size()
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            for buf, into in recv:
                into.copy_(buf)
        self.seconds += time.perf_counter() - t0
        return from_up, from_dn

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(world, *x.shape): every rank's ``x`` in rank order, on x's
        device (the same shape on every rank)."""
        t0 = time.perf_counter()
        src = self._host(x).contiguous().reshape(-1)
        out = src.new_empty((self.world * src.numel(),))
        dist.all_gather_into_tensor(out, src, group=self.group)
        out = out.view(self.world, *x.shape).to(x.device)
        self.seconds += time.perf_counter() - t0
        return out
