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
  * `MeshComm` is the language model's side: the collectives along the
    axes of a rank mesh that holds one rank a position, made once a mesh
    (`rank_comm`; `rank_comm_of` finds a DTensor's).  `is_dtensor`,
    `dims_axes` and `whole` read a DTensor's layout and gather it.
    `MeshComm.exchange` moves a tensor between two layouts of it over the
    ranks (`BoxLayout`: blocks of its dims; `FlatLayout`: ranges of its
    flat row-major entries), each rank sending each other rank just the
    entries the other's new block holds.

Both transports stage through the same page-locked host buffers under
gloo and gather alike (`_Transport`).
"""
from __future__ import annotations

import datetime
import math
import os
import time
import weakref

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


# the one-tensor collectives under their newer names where torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _as_integers(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as int32 (or uint8 when its size is not
    a multiple of 4): summed with zeros, integers keep every bit."""
    flat = t.reshape(-1).view(torch.uint8)
    return flat.view(torch.int32) if flat.numel() % 4 == 0 else flat


class _Transport:
    """What `RankComm` and `MeshComm` share: the buffers a collective
    moves through, the gather, and the counters.  NCCL carries CUDA
    tensors and gloo CPU ones; gloo with CUDA tensors stages them through
    page-locked host buffers, only because the caller chose gloo
    (``transport`` "gloo (host-staged)"); any other backend (the dry
    run's fake one on ``meta`` tensors) moves the caller's tensors where
    they are.

    ``counts`` / ``nbytes`` count each kind's calls and the bytes this
    rank contributed; ``ring`` / ``result`` count them as the reference's
    roofline reads its compiled module (`REFERENCE_NAMES`, `ring_bytes`);
    ``seconds`` is the host time inside the collectives, staging included
    (under NCCL the enqueue only: its work is asynchronous).  A call is
    counted as the kind the caller asked for, whatever the transport ran
    (under gloo a gather is an all-reduce, `_gather_rows`)."""

    KINDS = ("all_reduce", "all_gather", "reduce_scatter", "exchange")
    # the reference's name of each kind's HLO op (benchmarks/roofline.py)
    REFERENCE_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                       "reduce_scatter": "reduce-scatter",
                       "exchange": "collective-permute"}

    def __init__(self, backend: str, device):
        self.backend = backend
        self.device = torch.device(device)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.transport = ("gloo (host-staged)" if self.staged
                          else backend)
        self.reset()

    def reset(self) -> None:
        self.counts = {k: 0 for k in self.KINDS}
        self.nbytes = {k: 0 for k in self.KINDS}
        self.ring = {k: 0.0 for k in self.KINDS}
        self.result = {k: 0 for k in self.KINDS}
        self.seconds = 0.0

    def _count(self, kind: str, t0: float, x: torch.Tensor, g: int = 1
               ) -> None:
        """One call of ``kind`` on ``x`` (what this rank contributed) over
        a group of ``g`` ranks."""
        nb = x.numel() * x.element_size()
        self.counts[kind] += 1
        self.nbytes[kind] += nb
        self.ring[kind] += ring_bytes(kind, nb, g)
        self.result[kind] += {"all_gather": nb * g,
                              "reduce_scatter": nb // g}.get(kind, nb)
        self.seconds += time.perf_counter() - t0

    def _count_exchange(self, t0: float, sent: int, received: int) -> None:
        """One point-to-point exchange: this rank sent ``sent`` bytes to
        other ranks (what the reference's roofline charges a
        collective-permute) and received ``received``."""
        self.counts["exchange"] += 1
        self.nbytes["exchange"] += sent
        self.ring["exchange"] += sent
        self.result["exchange"] += received
        self.seconds += time.perf_counter() - t0

    def record(self) -> dict:
        """The counters as plain numbers: calls and bytes by kind, host
        seconds, the transport, and the reference's reading of the same
        calls (``reference``: ``total_bytes``, ``raw_result_bytes`` and
        ``per_op_bytes`` by its op names, as
        ``benchmarks/roofline.py::collective_bytes_from_hlo`` gives them;
        a kind with no call is left out)."""
        named = {self.REFERENCE_NAMES[k]: k for k in self.KINDS
                 if self.counts[k]}
        return {"transport": self.transport, "calls": dict(self.counts),
                "bytes": dict(self.nbytes), "seconds": self.seconds,
                "reference": {
                    "total_bytes": sum(self.ring[k] for k in named.values()),
                    "raw_result_bytes": sum(self.result[k]
                                            for k in named.values()),
                    "per_op_bytes": {n: self.ring[k]
                                     for n, k in named.items()}}}

    def _buffer(self, shape, dtype, zero: bool = False) -> torch.Tensor:
        """A buffer for a collective: page-locked on the host when staging
        (copies to and from the card ~10x faster than pageable ones at
        300 MB on an H100's host; PERF.md), else on the device."""
        make = torch.zeros if zero else torch.empty
        if self.staged:
            return make(shape, dtype=dtype, pin_memory=True)
        return make(shape, dtype=dtype, device=self.device)

    def _staged_copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in a fresh `_buffer` (what a collective may write into)."""
        h = self._buffer(t.shape, t.dtype)
        h.copy_(t)
        return h

    def _gather_rows(self, x: torch.Tensor, n: int, i: int, group
                     ) -> torch.Tensor:
        """The ``n`` ranks' contiguous ``x`` (this rank's is block ``i``)
        joined along dim 0, in a `_buffer`.  Under gloo each block is put
        in a zeroed whole and the wholes summed as integers: an all-reduce,
        faster than gloo's all-gather (PERF.md), and a copy of every
        bit."""
        rows = x.shape[0]
        out = self._buffer((n * rows,) + tuple(x.shape[1:]), x.dtype,
                           zero=self.backend == "gloo")
        if self.backend == "gloo":
            out[i * rows:(i + 1) * rows].copy_(x)
            dist.all_reduce(_as_integers(out), group=group)
        else:
            _ALL_GATHER(out, x, group=group)
        return out


class RankComm(_Transport):
    """One rank's side of the p-bit engine's transport (see the module
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
        check_rank_device(group, device)
        super().__init__(dist.get_backend(group), device)
        r0, r1, c0, c1 = blocks[self.rank]

        def peer(pred):
            k = next((k for k, b in enumerate(blocks)
                      if pred(b) and b[2:] == (c0, c1)), None)
            if k is None or group is None:
                return k
            return dist.get_global_rank(group, k)

        self.up = peer(lambda b: b[1] == r0)
        self.dn = peer(lambda b: b[0] == r1)

    def swap_edges(self, first: torch.Tensor, last: torch.Tensor):
        """``first`` (B, H), the first band's first-row boundary, to the
        rank above; ``last``, the last band's last row, to the rank below;
        one ``batch_isend_irecv``.  Returns (from_up, from_dn): the rank
        above's last row (this rank's first ``halo_up``) and the rank
        below's first row (its last ``halo_dn``); zeros past the lattice's
        edge.  Counted as one ``exchange`` of the bytes sent."""
        t0 = time.perf_counter()
        from_up, from_dn = torch.zeros_like(first), torch.zeros_like(last)
        ops, recv, sent = [], [], 0
        for peer, send, into in ((self.up, first, from_up),
                                 (self.dn, last, from_dn)):
            if peer is None:
                continue
            out = self._staged_copy(send)
            buf = torch.empty_like(out)
            ops += [dist.P2POp(dist.isend, out, peer, self.group),
                    dist.P2POp(dist.irecv, buf, peer, self.group)]
            recv.append((buf, into))
            sent += out.numel() * out.element_size()
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            for buf, into in recv:
                into.copy_(buf)
        self._count_exchange(t0, sent, sent)
        return from_up, from_dn

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(world, *x.shape): every rank's ``x`` in rank order, on x's
        device (the same shape on every rank)."""
        t0 = time.perf_counter()
        src = x.contiguous().reshape(1, -1)
        out = self._gather_rows(src, self.world, self.rank, self.group)
        out = out.view(self.world, *x.shape).to(x.device)
        self._count("all_gather", t0, src, self.world)
        return out


def _mesh_type(device: torch.device) -> str:
    """The ``DeviceMesh`` device type of a `MeshComm` on ``device``: its
    own, but "cpu" for ``meta`` (the dry run's).  DTensor's sharding
    propagation asks the mesh's device module for a device count, and
    ``meta`` has none; a DTensor on a "cpu" mesh keeps ``meta`` local
    tensors where they are, so the buffers, blocks and collectives stay
    on ``meta`` and nothing is allocated."""
    return "cpu" if device.type == "meta" else device.type


class MeshComm(_Transport):
    """The collectives along the axes of a rank mesh that holds one rank a
    position: what the language model's steps move between ranks (the
    parameters' FSDP gathers and gradient reduce-scatters, the tensor-
    parallel sums, the vocabulary's reductions, the decode cache's
    gathers).

    ``dm`` is the ``DeviceMesh`` over the mesh's ranks (its per-axis
    process groups carry the collectives); ``coord`` is this rank's
    position on each axis.  Collectives go through the c10d calls on each
    axis's group; an axis of size 1 moves nothing.  The counters are
    `_Transport`'s.  Under gloo the gather and the reduce-scatter run as
    all-reduces (`_Transport._gather_rows`, `reduce_scatter`)."""

    def __init__(self, mesh, device):
        from torch.distributed.device_mesh import DeviceMesh

        ranks = np.asarray(mesh.ranks)
        world = dist.get_world_size(mesh.group)
        if ranks.size != world or sorted(ranks.reshape(-1)) != list(
                range(world)):
            raise ValueError(
                f"the language model runs one rank a mesh position; this "
                f"mesh {dict(mesh.shape)} puts {world} ranks on "
                f"{ranks.size} positions (a rank holding a block of "
                f"positions is the p-bit engine's layout): make the rank "
                f"mesh with as many positions as ranks")
        super().__init__(dist.get_backend(mesh.group), device)
        self.group = mesh.group
        self.ranks = ranks
        self.axis_names = tuple(mesh.axis_names)
        self.sizes = dict(mesh.shape)
        self.rank = dist.get_rank(mesh.group)
        pos = np.argwhere(ranks == self.rank)[0]
        self.coord = {a: int(i) for a, i in zip(self.axis_names, pos)}
        self.dm = DeviceMesh(_mesh_type(self.device), torch.as_tensor(ranks),
                             mesh_dim_names=self.axis_names)
        self.groups = {a: self.dm.get_group(a) for a in self.axis_names
                       if self.sizes[a] > 1}
        self.plans: dict = {}       # `exchange`'s, by the two layouts

    def moving(self, axes) -> tuple:
        """The axes of ``axes`` that have more than one rank."""
        return tuple(a for a in axes if self.sizes.get(a, 1) > 1)

    def block(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` split over ``axes``
        (major to minor), a view; nothing moves."""
        for a in axes:
            n = self.sizes[a]
            size = t.shape[dim] // n
            t = t.narrow(dim, self.coord[a] * size, size)
        return t

    def offset(self, length: int, axes) -> int:
        """The global start of this rank's block of a dim of ``length``
        split over ``axes``."""
        start = 0
        for a in axes:
            length //= self.sizes[a]
            start += self.coord[a] * length
        return start

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """The sum (or ``op="max"``) of ``t`` over the ranks along
        ``axes``; a new tensor on ``t``'s device."""
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        for a in self.moving(axes):
            t0 = time.perf_counter()
            x = t.detach()
            h = self._staged_copy(x)
            dist.all_reduce(h, op=red, group=self.groups[a])
            t = h.to(x.device)
            self._count("all_reduce", t0, x, self.sizes[a])
        return t

    def all_gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """The blocks of the ranks along ``axes`` joined along ``dim``
        (the inverse of `block`)."""
        for a in reversed(self.moving(axes)):
            t0 = time.perf_counter()
            x = t.detach().movedim(dim, 0).contiguous()
            out = self._gather_rows(x, self.sizes[a], self.coord[a],
                                    self.groups[a])
            t = out.to(x.device).movedim(0, dim)
            self._count("all_gather", t0, x, self.sizes[a])
        return t

    def reduce_scatter(self, t: torch.Tensor, dim: int, axes
                       ) -> torch.Tensor:
        """The sum over the ranks along ``axes`` of ``t``, each rank
        keeping its `block` along ``dim`` (under gloo: an all-reduce, then
        the block)."""
        for a in self.moving(axes):
            t0 = time.perf_counter()
            n, i = self.sizes[a], self.coord[a]
            x = t.detach().movedim(dim, 0).contiguous()
            size = x.shape[0] // n
            if self.backend == "gloo":
                h = self._staged_copy(x)
                dist.all_reduce(h, group=self.groups[a])
                out = h[i * size:(i + 1) * size]
            else:
                out = x.new_empty((size,) + tuple(x.shape[1:]))
                _REDUCE_SCATTER(out, x, group=self.groups[a])
            t = out.to(x.device).movedim(0, dim)
            self._count("reduce_scatter", t0, x, n)
        return t

    def exchange(self, src: torch.Tensor, src_layout, dst: torch.Tensor,
                 dst_layout) -> torch.Tensor:
        """Write into ``dst`` (this rank's block of a tensor laid out as
        ``dst_layout``) the entries it holds, from the ranks that hold
        them in ``src`` (their blocks as ``src_layout``): every rank calls
        it together.  Each entry comes from the rank whose coordinates on
        the axes ``src_layout`` does not split are the receiver's own, so
        a rank that holds an entry in both layouts copies it from itself.
        One ``batch_isend_irecv``, each peer's pieces packed in one
        buffer (host-staged under gloo with CUDA tensors); the bytes this
        rank sends to other ranks count as ``exchange``.  Returns
        ``dst``."""
        t0 = time.perf_counter()
        sends, recvs = _exchange_plan(self, src_layout, dst_layout)
        me = self.rank
        for (sloc, sub), (dloc, dsub) in zip(sends.get(me, ()),
                                             recvs.get(me, ())):
            dst_layout.view(dst, dloc, dsub).copy_(
                src_layout.view(src, sloc, sub))
        ops, landing, sent = [], [], 0
        for peer in sorted(set(sends) | set(recvs)):
            if peer == me:
                continue
            glob = (peer if self.group is None
                    else dist.get_global_rank(self.group, peer))
            if peer in sends:
                parts = [src_layout.view(src, loc, sub).reshape(-1)
                         for loc, sub in sends[peer]]
                out = self._staged_copy(torch.cat(parts))
                ops.append(dist.P2POp(dist.isend, out, glob, self.group))
                sent += out.numel() * out.element_size()
            if peer in recvs:
                n = sum(_volume(sub) for _, sub in recvs[peer])
                buf = self._buffer((n,), dst.dtype)
                ops.append(dist.P2POp(dist.irecv, buf, glob, self.group))
                landing.append((buf, recvs[peer]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            for buf, pieces in landing:
                at = 0
                for loc, sub in pieces:
                    view = dst_layout.view(dst, loc, sub)
                    n = view.numel()
                    view.copy_(buf[at:at + n].view(view.shape))
                    at += n
        self._count_exchange(t0, sent, sum(
            buf.numel() * buf.element_size() for buf, _ in landing))
        return dst


def ring_bytes(kind: str, nbytes: int, g: int) -> float:
    """The bytes the reference's roofline charges a collective of ``kind``
    over ``g`` ranks to which this rank contributed ``nbytes``
    (``benchmarks/roofline.py::_ring_factor`` times the op's result
    size): an all-reduce 2(g-1)/g of the tensor, an all-gather g-1 times
    the rank's block (its result is g blocks, charged (g-1)/g), a
    reduce-scatter (g-1)/g of the whole (its result is one block, charged
    g-1 times), an exchange the bytes it sent (a collective-permute's
    result, charged once)."""
    if kind == "all_reduce":
        return nbytes * 2.0 * (g - 1) / g
    if kind == "all_gather":
        return float(nbytes * (g - 1))
    if kind == "reduce_scatter":
        return nbytes * (g - 1) / g
    return float(nbytes)


# ---------------------------------------------------------------------------
# Layouts of one tensor over a rank mesh, and the exchange between two
# ---------------------------------------------------------------------------
def _volume(box) -> int:
    return math.prod(hi - lo for lo, hi in box)


def _meet(a, b):
    """The intersection of two boxes ((lo, hi) per dim), or None."""
    box = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                in zip(a, b))
    return box if all(lo < hi for lo, hi in box) else None


def flat_boxes(shape, start: int, stop: int) -> list:
    """The flat row-major entries ``[start, stop)`` of a tensor of
    ``shape`` as boxes ((lo, hi) per dim) in flat order: at most two
    partial rows of each dim around a run of whole ones."""
    if start >= stop:
        return []
    if not shape:
        return [()]
    inner = math.prod(shape[1:])
    first, end = -(-start // inner), stop // inner   # the whole rows
    if first > end:             # inside one row
        r = start // inner
        return [((r, r + 1),) + b for b in
                flat_boxes(shape[1:], start - r * inner, stop - r * inner)]
    out = []
    if start < first * inner:
        r = first - 1
        out += [((r, r + 1),) + b for b in
                flat_boxes(shape[1:], start - r * inner, inner)]
    if first < end:
        out.append(((first, end),) + tuple((0, d) for d in shape[1:]))
    if end * inner < stop:
        out += [((end, end + 1),) + b for b in
                flat_boxes(shape[1:], 0, stop - end * inner)]
    return out


def _block_index(coord: dict, sizes: dict, axes) -> tuple[int, int]:
    """(index, count) of a rank's block of a dim split over ``axes``,
    major to minor."""
    k, n = 0, 1
    for a in axes:
        k, n = k * sizes[a] + coord[a], n * sizes[a]
    return k, n


class BoxLayout:
    """A tensor of global ``shape`` whose dim ``d`` is split over the mesh
    axes ``dims_axes[d]`` (major to minor; a DTensor's layout): each rank
    holds one box, its local block."""

    def __init__(self, shape, dims_axes: dict):
        self.shape = tuple(int(d) for d in shape) or (1,)
        self.dims_axes = {d: tuple(a) for d, a in dims_axes.items() if a}
        self.axes = tuple(a for d in sorted(self.dims_axes)
                          for a in self.dims_axes[d])

    def key(self):
        return ("box", self.shape, tuple(sorted(self.dims_axes.items())))

    def regions(self, coord: dict, sizes: dict) -> list:
        box = []
        for d, size in enumerate(self.shape):
            k, n = _block_index(coord, sizes, self.dims_axes.get(d, ()))
            box.append((k * size // n, (k + 1) * size // n))
        box = tuple(box)
        return [(box, box)]

    def view(self, local: torch.Tensor, origin, sub) -> torch.Tensor:
        local = local.reshape(self.shape) if local.ndim == 0 else local
        return local[tuple(slice(lo - o, hi - o) for (lo, hi), (o, _)
                           in zip(sub, origin))]


class FlatLayout:
    """A tensor of global ``shape`` held as ranges of its flat row-major
    entries: its ``ceil(numel / unit)`` units of ``unit`` entries split
    over the mesh ``axes`` (major to minor), each rank holding its units'
    entries, the last one cut at ``numel``, as one flat tensor."""

    def __init__(self, shape, axes, unit: int):
        self.shape = tuple(int(d) for d in shape) or (1,)
        self.axes, self.unit = tuple(axes), int(unit)
        self.numel = math.prod(self.shape)
        self.units = -(-self.numel // self.unit)

    def key(self):
        return ("flat", self.shape, self.axes, self.unit)

    def span(self, coord: dict, sizes: dict) -> tuple[int, int]:
        """The flat range ``[start, stop)`` a rank holds."""
        k, n = _block_index(coord, sizes, self.axes)
        u0, u1 = k * self.units // n, (k + 1) * self.units // n
        return (min(u0 * self.unit, self.numel),
                min(u1 * self.unit, self.numel))

    def regions(self, coord: dict, sizes: dict) -> list:
        start, stop = self.span(coord, sizes)
        out, at = [], 0
        for box in flat_boxes(self.shape, start, stop):
            out.append((box, (at, box)))
            at += _volume(box)
        return out

    def view(self, local: torch.Tensor, loc, sub) -> torch.Tensor:
        at, box = loc
        piece = local[at:at + _volume(box)].view(
            tuple(hi - lo for lo, hi in box))
        return piece[tuple(slice(lo - o, hi - o) for (lo, hi), (o, _)
                           in zip(sub, box))]


def _exchange_plan(comm: MeshComm, src, dst) -> tuple[dict, dict]:
    """This rank's side of `MeshComm.exchange`: ``sends`` {peer: [(src
    locator, box)]} and ``recvs`` {peer: [(dst locator, box)]}, each
    peer's pieces in the same order on both ends."""
    key = (src.key(), dst.key())
    if key in comm.plans:
        return comm.plans[key]
    sizes, names = comm.sizes, comm.axis_names
    grid = np.asarray(comm.ranks)
    coords = {int(grid[idx]): dict(zip(names, map(int, idx)))
              for idx in np.ndindex(grid.shape)}
    me = comm.rank
    tiles = [dict(zip(src.axes, t)) for t in
             np.ndindex(*[sizes[a] for a in src.axes])]
    sends: dict = {}
    recvs: dict = {}
    for r in sorted(coords):
        for dbox, dloc in dst.regions(coords[r], sizes):
            for t in tiles:
                sc = dict(coords[r], **{a: int(i) for a, i in t.items()})
                s = int(grid[tuple(sc[a] for a in names)])
                if s != me and r != me:
                    continue
                for sbox, sloc in src.regions(sc, sizes):
                    sub = _meet(dbox, sbox)
                    if sub is None:
                        continue
                    if s == me:
                        sends.setdefault(r, []).append((sloc, sub))
                    if r == me:
                        recvs.setdefault(s, []).append((dloc, sub))
    comm.plans[key] = sends, recvs
    return sends, recvs


# ---------------------------------------------------------------------------
# A rank mesh's MeshComm, and the DTensors laid out on it
# ---------------------------------------------------------------------------
_COMMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def is_rank_mesh(mesh) -> bool:
    return mesh is not None and getattr(mesh, "ranks", None) is not None


def rank_comm(mesh, device) -> MeshComm:
    """The `MeshComm` of a rank mesh on ``device``'s type, made once a
    mesh (a collective call: every rank makes it together)."""
    kind = torch.device(device if device is not None else "cpu").type
    per_mesh = _COMMS.setdefault(mesh, {})
    if kind not in per_mesh:
        per_mesh[kind] = MeshComm(mesh, device)
    return per_mesh[kind]


def rank_comm_of(x, prefer=None) -> MeshComm:
    """The `MeshComm` of a DTensor's mesh: ``prefer`` (the caller's
    ambient one) where its mesh is equal, else any made for an equal mesh
    (DTensor's dispatch may hand out an equal mesh object it cached for
    an earlier rank mesh of the same ranks)."""
    if prefer is not None and prefer.dm == x.device_mesh:
        return prefer
    for per_mesh in list(_COMMS.values()):
        for comm in per_mesh.values():
            if comm.dm == x.device_mesh:
                return comm
    raise ValueError("this DTensor's mesh is not a rank mesh's")


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def dims_axes(w) -> dict:
    """{tensor dim: mesh axes splitting it, in mesh order} of a DTensor."""
    names = w.device_mesh.mesh_dim_names
    out: dict = {}
    for name, pl in zip(names, w.placements):
        if pl.is_shard():
            out.setdefault(pl.dim % w.ndim, []).append(name)
    return {d: tuple(a) for d, a in out.items()}


def whole(x, prefer=None) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a collective: every rank
    calls it), a new contiguous tensor: what one process would hold."""
    comm = rank_comm_of(x, prefer)
    t = x.to_local().clone()      # a copy, as a gather's result is
    for d, ax in dims_axes(x).items():
        t = comm.all_gather(t, d, ax)
    return t.contiguous()
