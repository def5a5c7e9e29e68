"""Row-band sharded lattice: partition plan, halo exchange, engine.

Counterpart of ``repro.core.distributed``.  The chip tiles its Chimera cell
grid with only inter-cell wires crossing tile boundaries; the sharded
engine cuts the cell grid into contiguous *row bands* and moves only the
chain-coupler boundary spins (O(√N)) between neighbouring bands:

  * `Mesh` / `make_mesh` name the logical devices a `SamplerSpec` shards
    over.  On one card a "device" of the mesh is a row band (or a chain
    shard) living on the spec's device; a mesh that names more than one
    CUDA device raises.  `make_rank_mesh` names the ranks of the default
    process group instead (`core/ranks.py`): each process, one card a
    rank on CUDA, owns a contiguous run of the bands and chain shards.
  * `plan_row_partition` (numpy, memoized) cuts the grid into bands and
    precomputes the padded per-band node slices, the (D, n_loc) neighbour
    tables re-indexed into ``[local | halo_up | halo_dn]``, the boundary
    send lists, the per-band edge lists for the moments and the LFSR cell
    bands — array-equal to the reference's plan.
  * `ShardedEngine` runs the spec's `api.Sync` policy over the plan.  The
    bands of a device live on it with a leading band axis: the scan shapes
    run every band in one batched op, the halo exchange is an index gather
    over the band axis (edge bands read zeros), the launch-resident shape
    runs K1 per band, and the fused-resident-exchange shape runs every
    band of the card in one launch of K5
    (`kernels/sweep_fused.py::sweep_sparse_exchange`), which refreshes the
    halos inside the kernel.  Under a rank mesh the boundary rows between
    ranks go through the process group, and K5 runs per card on windows
    between exchange points with the card's edge halos supplied.  Under
    the default barrier policy spins equal the single-device engine bit
    for bit.

`LatticeSpec` / `make_sk_lattice` generate SK-style lattice instances;
`lattice_to_chip` converts them into the shared `EffectiveChip` slot
layout and `make_lattice_anneal` drives them through a (sharded) Session.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import lfsr as lfsr_mod
from repro_torch.core import ranks as ranks_mod
from repro_torch.core.chimera import ChimeraGraph, make_chimera
from repro_torch.core.hardware import EffectiveChip, HardwareConfig
from repro_torch.core.pbit import fma32
from repro_torch.kernels.ref import (
    halo_exchange_segments,
    sparse_neuron_input,
)
from repro_torch.kernels.shard_sweep import (
    exchange_launch,
    exchange_tables,
    fused_shard_sweeps,
    halo_exchange,
    halo_half_sweep,
)
from repro_torch.kernels.sweep_fused import (
    card_limits,
    exchange_resident_feasible,
)


# ---------------------------------------------------------------------------
# The mesh: logical devices
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh of logical devices, what a sharded `SamplerSpec` names.

    ``axis_names`` in order, ``shape`` as ``{axis: size}`` and ``devices``
    as an integer array of logical ids shaped like the axes — the parts of
    a ``jax.sharding.Mesh`` the engine, the spec's validation and
    `surviving_mesh` read.  Every logical device lives on the spec's
    device: on one card a row band is a slice of a tensor, not a process.
    """

    axis_names: tuple
    shape: dict
    devices: np.ndarray
    # a rank mesh (`make_rank_mesh`): the rank of every position, shaped
    # like the axes, and the process group (None: the default group)
    ranks: np.ndarray | None = None
    group: Any = None


def _logical_ids(devices, n: int) -> np.ndarray:
    """Logical ids of ``devices`` (ints, or device names / `torch.device`s
    of one card); raises when they name more than one CUDA device."""
    if devices is None:
        return np.arange(n, dtype=np.int64)
    devs = list(np.asarray(devices, dtype=object).reshape(-1))
    if len(devs) != n:
        raise ValueError(f"the mesh has {n} positions but {len(devs)} "
                         f"devices were given")
    if all(isinstance(d, (int, np.integer)) for d in devs):
        return np.asarray(devs, dtype=np.int64)
    cards = {torch.device(d) for d in devs}
    if len({(c.type, c.index) for c in cards if c.type == "cuda"}) > 1:
        raise NotImplementedError(
            f"this mesh names {len(cards)} CUDA devices; a logical mesh "
            f"runs every row band on one card — name one card, leave "
            f"devices=None, or run one torch.distributed rank a card on "
            f"a rank mesh (make_rank_mesh)")
    return np.arange(n, dtype=np.int64)


def make_mesh(axis_shapes, axis_names, *, devices=None) -> Mesh:
    """`Mesh` of ``prod(axis_shapes)`` logical devices, mirroring
    ``jax.make_mesh(axis_shapes, axis_names)``."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    axis_names = tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis sizes for "
                         f"{len(axis_names)} axis names")
    if any(s < 1 for s in axis_shapes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {axis_shapes}")
    n = int(np.prod(axis_shapes, dtype=np.int64))
    ids = _logical_ids(devices, n).reshape(axis_shapes)
    return Mesh(axis_names, dict(zip(axis_names, axis_shapes)), ids)


def make_rank_mesh(axis_shapes, axis_names, group=None) -> Mesh:
    """`Mesh` of ``prod(axis_shapes)`` positions over the ranks of
    ``group`` (None: the default process group), mirroring
    ``jax.make_mesh(axis_shapes, axis_names)`` over ``jax.devices()``.

    The ranks split the axes in order (`core.ranks.rank_grid`), so each
    owns a contiguous block of every axis: under a `Partition`, a run of
    row bands and of chain shards.  Raises when no process group is
    initialised, when the world size does not divide the mesh, and under
    NCCL when this rank's current card is not its own
    (``cuda:{LOCAL_RANK}``).  Any other backend passes, the dry run's
    fake one too (`launch.dryrun.FAKE_BACKEND`: it moves nothing)."""
    import torch.distributed as tdist

    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError(
            "make_rank_mesh needs a process group: call "
            "torch.distributed.init_process_group (or core.ranks.init_rank) "
            "in every rank first, or use make_mesh for logical devices of "
            "one card")
    mesh = make_mesh(axis_shapes, axis_names)
    shapes = tuple(mesh.shape[a] for a in mesh.axis_names)
    grid = ranks_mod.rank_grid(shapes, tdist.get_world_size(group))
    if tdist.get_backend(group) == "nccl":
        ranks_mod.check_rank_device(group, "cuda")
    return dataclasses.replace(mesh, ranks=ranks_mod.rank_ids(shapes, grid),
                               group=group)


def device_mesh(mesh: Mesh, device="cuda"):
    """The ``torch.distributed`` ``DeviceMesh`` of a rank mesh that holds
    one rank a position (the language model's steps; `core.ranks.
    MeshComm`), on ``device``'s type, with the mesh's axis names; made
    once a mesh, by every rank together.  Raises for a rank that holds a
    block of positions (the p-bit engine's layout)."""
    if not ranks_mod.is_rank_mesh(mesh):
        raise ValueError("device_mesh needs a rank mesh (make_rank_mesh); a "
                         "logical mesh's devices are all on one card")
    return ranks_mod.rank_comm(mesh, device).dm


# ---------------------------------------------------------------------------
# Partition plan (numpy, built once at Session construction)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Static plan: Chimera cell rows -> n_shards contiguous row bands.

    All arrays are numpy; band-varying tables carry a leading (n_shards,)
    dim.  Padding entries (bands own unequal node counts on masked grids)
    point at real in-bounds nodes and are masked out of updates.
    """

    n_shards: int
    n_loc: int                 # padded nodes per band
    halo: int                  # padded boundary spins per direction
    node_starts: np.ndarray    # (n_shards + 1,) global node range bounds
    part_ids: np.ndarray       # (n_shards, n_loc) global node id
    valid: np.ndarray          # (n_shards, n_loc) bool
    inv_ids: np.ndarray        # (N,) global node -> shard * n_loc + p
    nbr_idx: np.ndarray        # (n_shards, D, n_loc) ext-local indices
    send_up: np.ndarray        # (n_shards, halo) local idx -> band above
    send_dn: np.ndarray        # (n_shards, halo) local idx -> band below
    n_boundary: int            # true boundary spins over internal cuts
    upd_masks: np.ndarray      # (n_shards, 2, n_loc) color masks & valid
    e_loc: int                 # padded edges per band
    edge_e0: np.ndarray        # (n_shards, e_loc) ext-local endpoint 0
    edge_e1: np.ndarray        # (n_shards, e_loc) ext-local endpoint 1
    edge_inv: np.ndarray       # (E,) global edge -> shard * e_loc + q
    # LFSR cell bands (built only when the spec's noise is "lfsr")
    c_loc: int = 0
    cell_ids: np.ndarray | None = None   # (n_shards, c_loc) global cell
    cell_valid: np.ndarray | None = None
    cell_inv: np.ndarray | None = None   # (n_cells,) -> shard * c_loc + q
    lfsr_perm: np.ndarray | None = None  # (n_shards, n_loc) local flat col


# a ChimeraGraph is a pure function of (rows, cols, k, masked_cells), so
# those four plus the band count key the plan exactly; plans are read-only
_PLAN_CACHE: dict = {}
PLAN_CACHE_STATS = {"hits": 0, "misses": 0}


def plan_cache_stats() -> dict:
    """Copy of the `plan_row_partition` memo hit/miss counters."""
    return dict(PLAN_CACHE_STATS)


def clear_plan_cache() -> None:
    """Drop memoized plans and zero the counters (tests)."""
    _PLAN_CACHE.clear()
    PLAN_CACHE_STATS["hits"] = 0
    PLAN_CACHE_STATS["misses"] = 0


def plan_row_partition(graph: ChimeraGraph, n_shards: int,
                       with_lfsr: bool = False) -> RowPartition:
    """Cut the cell grid into contiguous row bands (see `RowPartition`),
    memoized on (graph shape, n_shards, with_lfsr)."""
    key = (graph.rows, graph.cols, graph.k, tuple(graph.masked_cells),
           int(n_shards), bool(with_lfsr))
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        PLAN_CACHE_STATS["hits"] += 1
        return plan
    plan = _plan_row_partition(graph, n_shards, with_lfsr)
    PLAN_CACHE_STATS["misses"] += 1
    _PLAN_CACHE[key] = plan
    return plan


def _plan_row_partition(graph: ChimeraGraph, n_shards: int,
                        with_lfsr: bool = False) -> RowPartition:
    if n_shards < 1 or n_shards > graph.rows:
        raise ValueError(
            f"cannot cut {graph.rows} cell rows into {n_shards} bands")
    base, rem = divmod(graph.rows, n_shards)
    counts = [base + (d < rem) for d in range(n_shards)]
    r_start = np.concatenate([[0], np.cumsum(counts)])       # (n_shards+1,)
    node_r = np.asarray(graph.node_r)
    node_side = np.asarray(graph.node_side)
    # nodes are numbered by (r, c, side, k): each band owns a contiguous
    # id range regardless of cell masking
    node_starts = np.searchsorted(node_r, r_start).astype(np.int64)
    n_loc = max(1, int(np.max(np.diff(node_starts))))
    N = graph.n_nodes
    owner = np.searchsorted(node_starts[1:], np.arange(N), side="right")

    # boundary send lists: vertical (side-0) nodes of each band's first /
    # last cell row — the only nodes chain couplers carry across a cut
    ids_all = np.arange(N)
    send_up_ids, send_dn_ids = [], []
    for d in range(n_shards):
        sel = slice(node_starts[d], node_starts[d + 1])
        ids = ids_all[sel]
        vert = node_side[sel] == 0
        send_up_ids.append(ids[vert & (node_r[sel] == r_start[d])])
        send_dn_ids.append(ids[vert & (node_r[sel] == r_start[d + 1] - 1)])
    H = max(1, max((len(x) for x in send_up_ids + send_dn_ids), default=1))
    n_boundary = sum(len(send_dn_ids[d]) for d in range(n_shards - 1)) \
        + sum(len(send_up_ids[d]) for d in range(1, n_shards))

    nbr_g, _ = graph.neighbor_table()
    D = nbr_g.shape[0]
    part_ids = np.zeros((n_shards, n_loc), np.int32)
    valid = np.zeros((n_shards, n_loc), bool)
    local_nbr = np.zeros((n_shards, D, n_loc), np.int32)
    send_up = np.zeros((n_shards, H), np.int32)
    send_dn = np.zeros((n_shards, H), np.int32)
    for d in range(n_shards):
        s, e = int(node_starts[d]), int(node_starts[d + 1])
        n_d = e - s
        part_ids[d] = min(s, N - 1)
        part_ids[d, :n_d] = np.arange(s, e)
        valid[d, :n_d] = True
        send_up[d, :len(send_up_ids[d])] = send_up_ids[d] - s
        send_dn[d, :len(send_dn_ids[d])] = send_dn_ids[d] - s
        g_nbr = nbr_g[:, s:e].astype(np.int64)       # (D, n_d) global ids
        own = owner[g_nbr]
        loc = (g_nbr - s).astype(np.int64)           # local by default
        if d > 0:
            up = own == d - 1
            pos = np.searchsorted(send_dn_ids[d - 1], g_nbr[up])
            if not np.array_equal(send_dn_ids[d - 1][pos], g_nbr[up]):
                raise AssertionError("cross-band neighbor not on boundary")
            loc[up] = n_loc + pos
        if d < n_shards - 1:
            dn = own == d + 1
            pos = np.searchsorted(send_up_ids[d + 1], g_nbr[dn])
            if not np.array_equal(send_up_ids[d + 1][pos], g_nbr[dn]):
                raise AssertionError("cross-band neighbor not on boundary")
            loc[dn] = n_loc + H + pos
        if np.any(np.abs(own - d) > 1):
            raise AssertionError("neighbor more than one row band away")
        local_nbr[d, :, :n_d] = loc
    inv_ids = (owner * n_loc
               + (np.arange(N) - node_starts[owner])).astype(np.int32)

    color = np.asarray(graph.color)[part_ids]
    upd_masks = np.stack([(color == c) & valid for c in (0, 1)], axis=1)

    # per-band edge lists (owner = endpoint-0's band; endpoint 1 is local
    # or in the halo of the band below)
    e0g, e1g = graph.edges[:, 0].astype(np.int64), \
        graph.edges[:, 1].astype(np.int64)
    e_own = owner[e0g]
    e_loc = max(1, int(np.bincount(e_own, minlength=n_shards).max()))
    edge_e0 = np.zeros((n_shards, e_loc), np.int32)
    edge_e1 = np.zeros((n_shards, e_loc), np.int32)
    edge_inv = np.zeros((graph.n_edges,), np.int32)
    for d in range(n_shards):
        s = int(node_starts[d])
        sel = np.nonzero(e_own == d)[0]
        edge_e0[d, :len(sel)] = e0g[sel] - s
        le1 = e1g[sel] - s
        far = owner[e1g[sel]] == d + 1
        if np.any(far):
            pos = np.searchsorted(send_up_ids[d + 1], e1g[sel][far])
            le1[far] = n_loc + H + pos
        edge_e1[d, :len(sel)] = le1
        edge_inv[sel] = d * e_loc + np.arange(len(sel))

    kw: dict[str, Any] = {}
    if with_lfsr:
        kw = _plan_lfsr_cells(graph, n_shards, r_start, part_ids, valid,
                              node_starts)
    return RowPartition(
        n_shards=n_shards, n_loc=n_loc, halo=H, node_starts=node_starts,
        part_ids=part_ids, valid=valid, inv_ids=inv_ids, nbr_idx=local_nbr,
        send_up=send_up, send_dn=send_dn, n_boundary=int(n_boundary),
        upd_masks=upd_masks, e_loc=e_loc, edge_e0=edge_e0, edge_e1=edge_e1,
        edge_inv=edge_inv, **kw)


def _plan_lfsr_cells(graph, n_shards, r_start, part_ids, valid, node_starts):
    """Band the per-cell LFSRs the same way (cells sort by (r, c), exactly
    the order `core.pbit.make_lfsr_noise` enumerates them)."""
    cells = sorted(
        {(int(r), int(c)) for r, c in zip(graph.node_r, graph.node_c)})
    n_cells = len(cells)
    vert = np.stack([graph.cell_nodes(r, c, side=0) for r, c in cells])
    horiz = np.stack([graph.cell_nodes(r, c, side=1) for r, c in cells])
    perm_g = lfsr_mod.node_gather_perm(vert, horiz, graph.n_nodes)
    cell_rows = np.array([r for r, _ in cells])
    cell_starts = np.searchsorted(cell_rows, r_start)
    c_loc = max(1, int(np.max(np.diff(cell_starts))))
    cell_ids = np.zeros((n_shards, c_loc), np.int32)
    cell_valid = np.zeros((n_shards, c_loc), bool)
    lfsr_perm = np.zeros(part_ids.shape, np.int32)
    for d in range(n_shards):
        s, e = int(cell_starts[d]), int(cell_starts[d + 1])
        cell_ids[d] = min(s, n_cells - 1)
        cell_ids[d, :e - s] = np.arange(s, e)
        cell_valid[d, :e - s] = True
        pg = perm_g[part_ids[d]]
        kk, cell = pg // n_cells, pg % n_cells
        lp = kk * c_loc + (cell - s)
        lfsr_perm[d] = np.where(valid[d], lp, 0)
    cell_own = np.searchsorted(cell_starts[1:], np.arange(n_cells),
                               side="right")
    cell_inv = (cell_own * c_loc
                + (np.arange(n_cells) - cell_starts[cell_own])).astype(
                    np.int32)
    return dict(c_loc=c_loc, cell_ids=cell_ids, cell_valid=cell_valid,
                cell_inv=cell_inv, lfsr_perm=lfsr_perm)


def halo_bytes_per_sweep(plan: RowPartition, chains: int,
                         refresh_for_moments: bool = False,
                         sync=None):
    """Total float32 bytes crossing internal band cuts per full sweep.

    Under the default barrier policy: two half-sweeps, each moving every
    internal boundary spin in both directions, for every chain; +1
    exchange per sweep when moments are accumulated (the post-sweep
    refresh for boundary-edge correlations).  An `api.Sync` policy scales
    the multiplier by its exchange schedule (`Sync.exchanges_per_sweep`).
    """
    if sync is None:
        from repro_torch.api.spec import Sync
        sync = Sync()
    return sync.exchanges_per_sweep(refresh_for_moments) \
        * plan.n_boundary * chains * 4


def surviving_mesh(mesh: Mesh, dead_ids) -> Mesh | None:
    """Re-plan a 1-D row mesh onto the logical devices that outlived a
    shard loss: the survivors keep the first axis name, so every
    ``Partition(rows=axis)`` stays valid.  None when fewer than two
    survive (the caller drops ``mesh=`` and runs unsharded); raises when
    none does."""
    if mesh.ranks is not None:
        raise NotImplementedError(
            "losing a rank of a process group is not handled: re-plan a "
            "logical mesh (make_mesh) or restart the ranks")
    dead = {int(d) for d in dead_ids}
    ids = [int(d) for d in np.asarray(mesh.devices).reshape(-1)]
    survivors = [d for d in ids if d not in dead]
    if not survivors:
        raise RuntimeError(
            f"no devices survive: mesh {tuple(ids)} all marked dead "
            f"({sorted(dead)})")
    if len(survivors) < 2:
        return None
    axis = mesh.axis_names[0]
    return Mesh((axis,), {axis: len(survivors)},
                np.asarray(survivors, dtype=np.int64))


def k5_runs(sync, bands: int, n_row: int, chains: int,
            plan: RowPartition, limits) -> bool:
    """Does K5 run a launch of ``sync`` for one process's ``bands`` of the
    ``n_row`` row bands and its ``chains`` chains, on a card of
    ``limits``?  Across ranks (``bands < n_row``) a launch runs as one K5
    window of whole sweeps between exchange points, so an exchange point
    inside a sweep leaves the launch to K1 windows; and K5 needs a body
    for the shape (`exchange_resident_feasible`).  The engine's route and
    the spec's ``auto`` both ask this."""
    if bands < n_row and any(x % 2 for x in sync.exchange_points()):
        return False
    return exchange_resident_feasible(bands, chains,
                                      plan.n_loc + 2 * plan.halo, plan.halo,
                                      limits)


# ---------------------------------------------------------------------------
# The sharded engine
# ---------------------------------------------------------------------------
def _recip(x) -> torch.Tensor:
    """float32 ``1 / x`` (the reference's compiled division by a constant
    is a multiply by this reciprocal; see `core.pbit._recip`)."""
    return torch.tensor(np.float32(1.0) / np.float32(x))


class ShardedEngine:
    """Plan + mesh + sync policy -> the band-batched sweep implementations.

    Built once at `api.Session` construction when the spec carries a mesh.
    The public entry points (`sample` / `stats` / `visible_hist`) keep the
    array contracts of the single-device engine (global (B, N) spins,
    global noise state), so every workload shards without modification.

    A "device" of the mesh is a row band (and a chain shard) on the
    spec's device.  Spins live as ``(n_row, B, n_loc)``: one batched torch
    op runs every band, and the halo exchange is an index gather over the
    band axis.  The chain axis needs no layout of its own: its shards are
    contiguous blocks of the chain axis, so their global noise rows
    (`_chain_offsets`) concatenate to ``0..B-1``; what it changes is the
    moments' order (``n_chain == 1``: per-sweep means accumulated;
    ``n_chain > 1``: raw sums, the shards' sums added, one division).

    The `api.Sync` policy picks one of four loop shapes (see
    `_local_sweeps`); ``resident_exchange`` (None: the spec's device is
    CUDA) runs the fused shapes' launches through K5 instead of their
    emulation (K1 per band).

    Under a rank mesh (`make_rank_mesh`) this process is one rank and
    holds its run of ``R_loc`` bands and its chain shards
    (`core.ranks.rank_blocks`): ``n_row`` stays global, the per-band
    tables, ``_part_ids``, ``_col0`` and ``_chain_offsets`` are the rank's,
    and noise and faults still come from global coordinates.  The boundary
    rows between ranks go through the process group (`RankComm`, from
    `kernels/shard_sweep.py::halo_exchange`); K5 runs per card, a launch
    split at its exchange points into windows with ``edge_halos="block"``
    and the card's edge halos supplied between them, where every window is
    whole sweeps (else K1 windows).  Outputs are gathered, never summed,
    so every rank returns the one-process engine's global tensors — apart
    from the sums the reference takes with ``psum``: a chains partition's
    raw moments and the visible histogram's codes, sums of integers,
    exact in any order.  ``route`` names how a ``sample`` launch runs.

    ``faults`` (an `api.Faults`): stuck spins arrive as clamp arguments
    from the Session, as every backend takes them; what the engine owns
    are the per-half-sweep hooks, regenerated per band from *global*
    coordinates so the sharded trajectory reproduces the single-device
    fault draw bit for bit under the barrier policy: transient flips (a
    salted counter hash of the global (chain, node)) and stuck LFSR
    register bits (per-cell masks gathered into each band's cells).  Both
    run on the scan shapes only.
    """

    def __init__(self, graph: ChimeraGraph, mesh, partition, noise: str,
                 decimation: int, chains: int, *, sync=None,
                 backend: str = "sparse", device="cuda",
                 resident_exchange: bool | None = None, faults=None):
        if sync is None:
            from repro_torch.api.spec import Sync
            sync = Sync()
        self.graph = graph
        self.mesh = mesh
        self.noise = noise
        self.decimation = decimation
        self.chains = chains
        self.sync = sync
        self.device = dev = torch.device(device)
        self.faults = faults
        self._fused = backend == "fused_sparse"
        if self._fused and faults is not None and faults.needs_host_hooks:
            raise ValueError(
                "the fused per-band kernels cannot apply per-half-sweep "
                "fault hooks (transient flips, stuck LFSR bits); use "
                "backend='sparse'")
        self.rows_axes = partition.rows_axes
        self.chain_axes = partition.chain_axes
        self.n_row = int(np.prod([mesh.shape[a] for a in self.rows_axes],
                                 dtype=np.int64)) if self.rows_axes else 1
        self.n_chain = int(np.prod([mesh.shape[a] for a in self.chain_axes],
                                   dtype=np.int64)) if self.chain_axes else 1
        if chains % self.n_chain:
            raise ValueError(f"chains={chains} not divisible by the "
                             f"chain-axis size {self.n_chain}")
        self.b_loc = chains // self.n_chain
        # this process's run of bands [r0, r1) and chain shards [c0, c1):
        # all of them, or under a rank mesh the rank's block
        self.comm = None
        self._blocks = [(0, self.n_row, 0, self.n_chain)]
        if mesh.ranks is not None:
            self._blocks = ranks_mod.rank_blocks(mesh, self.rows_axes,
                                                 self.chain_axes)
            self.comm = ranks_mod.RankComm(mesh.group, self._blocks, dev)
        r0, r1, c0, c1 = self._blocks[0 if self.comm is None
                                      else self.comm.rank]
        self._bands = slice(r0, r1)
        self.R_loc = r1 - r0
        self._shards = range(c0, c1)
        self.chain0 = c0 * self.b_loc          # global id of chain 0 here
        self.chains_loc = (c1 - c0) * self.b_loc
        # the process group carries boundary rows: the bands are cut across
        # ranks (more than one rank along the rows)
        self._cross_rows = self.R_loc < self.n_row
        # the fused shapes: on the card one K5 launch runs a whole launch
        # for every band, the kernel owning the halo refresh (with
        # ``ex_pts=(0,)`` for a policy without mid-launch exchange, where
        # K5 has a body for the shape; else K1 per band).  Elsewhere the
        # engine emulates the same launch bit for bit: half-sweep windows
        # of K1 per band with an exchange between windows
        if resident_exchange is None:
            resident_exchange = dev.type == "cuda"
        self._resident = self._fused and bool(resident_exchange)
        self.plan = plan_row_partition(graph, self.n_row,
                                       with_lfsr=(noise == "lfsr"))
        p = self.plan
        if self._resident and (sync.kernel_fusible or self._cross_rows):
            self._resident = k5_runs(sync, self.R_loc, self.n_row,
                                     self.chains_loc, p, card_limits(dev))

        def long(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        band = self._bands
        self._part_ids = long(p.part_ids[band])
        # each band's global column 0: the counter hash's coordinate offset
        self._col0 = [int(c) for c in p.part_ids[band, 0]]
        self._inv_ids = long(p.inv_ids)
        self._edge_inv = long(p.edge_inv)
        self._dev = {
            "nbr": long(p.nbr_idx[band]),
            "send_up": long(p.send_up[band]),
            "send_dn": long(p.send_dn[band]),
            "upd": torch.as_tensor(p.upd_masks[band], device=dev),
            "cols": long(p.part_ids[band]),
            "edge_e0": long(p.edge_e0[band]),
            "edge_e1": long(p.edge_e1[band]),
        }
        if noise == "lfsr":
            self._dev["lfsr_perm"] = long(p.lfsr_perm[band])
            self._cell_ids = long(p.cell_ids[band])
            self._cell_inv = long(p.cell_inv)
            if faults is not None and faults.lfsr_stuck:
                from repro_torch.api.faults import lfsr_stuck_masks
                s0, s1 = lfsr_stuck_masks(faults, graph.n_nodes // 8)
                # (R_loc, 1, c_loc): broadcast over each band's chains
                cells = p.cell_ids[band]
                self._dev["lfsr_stuck"] = (long(s0[cells])[:, None, :],
                                           long(s1[cells])[:, None, :])
        if self._fused:
            # per-edge slot row into the kernels' (D, N_ext) correlation
            # table: edge q of band b lives at c_slots[edge_slot[b, q],
            # edge_e0[b, q]] (endpoint 0 is always local)
            es = np.zeros((p.n_shards, p.e_loc), np.int64)
            for b in range(p.n_shards):
                hit = p.nbr_idx[b][:, p.edge_e0[b]] == p.edge_e1[b][None, :]
                es[b] = np.argmax(hit, axis=0)
            self._dev["edge_slot"] = long(es[band])
            self._dev["nbr32"] = torch.as_tensor(p.nbr_idx[band], device=dev)
        self.loop_shape = self._loop_shape(collect=False, hist=False)
        self.route = self._route()

    @property
    def transport(self) -> str | None:
        """What carries the boundary rows between ranks: "nccl", "gloo" or
        "gloo (host-staged)"; None on a logical mesh."""
        return None if self.comm is None else self.comm.transport

    def _route(self) -> str:
        """How a ``sample`` launch runs: "scan" (the batched half-sweeps),
        "k5" (one K5 launch owns every exchange), "k5 per card" (K5 windows
        between exchange points, the process group between them), "k1 per
        band" or "k1 windows" (the emulation: K1 per band on half-sweep
        windows, the exchanges between them)."""
        if self.loop_shape in ("segment scan", "unrolled launch"):
            return "scan"
        if self._resident:
            return "k5 per card" if self._cross_rows else "k5"
        return "k1 per band" if self.loop_shape == "fused" else "k1 windows"

    # -- global <-> parts layout ----------------------------------------
    def _chip_parts(self, chip: EffectiveChip) -> dict:
        """The chip's per-band ``(R_loc, ...)`` slices of this process's
        bands (gathers on the plan's tables; the chip is an operand of
        every call)."""
        if chip.nbr_w is None or chip.nbr_idx is None:
            raise ValueError(
                "sharded execution needs a chip carrying the slot layout "
                "(program through the Session — e.g. Session.make_program "
                "+ sample_program — or hardware.attach_sparse)")
        ids = self._part_ids
        return {
            "w": chip.nbr_w[:, ids].permute(1, 0, 2).contiguous(),
            "h": chip.h[ids],
            "gain": chip.tanh_gain[ids],
            "off": chip.tanh_offset[ids],
            "rg": chip.rand_gain[ids],
            "co": chip.comp_offset[ids],
        }

    def _my_chains(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of this process's chains of a (B, ...) tensor."""
        return x[self.chain0:self.chain0 + self.chains_loc]

    def _m_parts(self, m: torch.Tensor) -> torch.Tensor:
        """(B, N) -> (R_loc, B_loc, n_loc): this process's bands and
        chains."""
        return self._my_chains(m)[:, self._part_ids].permute(
            1, 0, 2).contiguous()

    def _gather(self, x: torch.Tensor, band_dim: int = 0,
                chain_dim: int | None = 1) -> torch.Tensor:
        """This process's part -> the global tensor: its ``R_loc`` bands on
        ``band_dim`` (and its chains on ``chain_dim``) among every rank's,
        by ``all_gather`` — copies, never sums.  With ``chain_dim=None``
        the part has no chain axis and the chain ranks of a band block
        hold raw sums over their chains, which are added in rank order
        (integer sums: exact in any order).  Without a rank mesh, ``x``."""
        if self.comm is None:
            return x
        parts = self.comm.all_gather(x)
        shape = list(x.shape)
        shape[band_dim] = self.n_row
        if chain_dim is not None:
            shape[chain_dim] = self.chains
        out = x.new_zeros(shape)
        seen = set()
        for k, (r0, r1, c0, c1) in enumerate(self._blocks):
            at = [slice(None)] * x.ndim
            at[band_dim] = slice(r0, r1)
            if chain_dim is not None:
                at[chain_dim] = slice(c0 * self.b_loc, c1 * self.b_loc)
            at = tuple(at)
            if chain_dim is None and (r0, r1) in seen:
                out[at] = out[at] + parts[k]
            else:
                out[at] = parts[k]
            seen.add((r0, r1))
        return out

    def _m_global(self, parts: torch.Tensor) -> torch.Tensor:
        parts = self._gather(parts)
        flat = parts.permute(1, 0, 2).reshape(parts.shape[1], -1)
        return flat[:, self._inv_ids]

    def _ns_parts(self, ns):
        if self.noise == "lfsr":
            return self._my_chains(ns)[:, self._cell_ids].permute(
                1, 0, 2).contiguous()
        return ns  # counter: one (2,) state for every band

    def _ns_global(self, ns, parts):
        if self.noise == "lfsr":
            parts = self._gather(parts)
            flat = parts.permute(1, 0, 2).reshape(parts.shape[1], -1)
            return flat[:, self._cell_inv]
        return parts

    def _part_cols(self, x: torch.Tensor) -> torch.Tensor:
        """(N,) node vector -> (R_loc, n_loc)."""
        return x[self._part_ids]

    def _betas_here(self, betas: torch.Tensor) -> torch.Tensor:
        """A (S, B) per-chain schedule's columns of this process's chains
        ((S,) passes)."""
        if betas.ndim == 2:
            return betas[:, self.chain0:self.chain0 + self.chains_loc]
        return betas

    # -- band-local pieces ----------------------------------------------
    def _chain_offsets(self) -> list[int]:
        """Global id of each of this process's chain shards' first chain,
        in shard order (the reference's per-device ``_chain_offset``)."""
        return [c * self.b_loc for c in self._shards]

    def _noise_step(self):
        """Step fn regenerating the *global* noise stream's columns for
        every band at once — bit-exact against `core.pbit`'s noise."""
        dev = self.device
        if self.noise == "counter":
            rows = torch.cat([off + torch.arange(self.b_loc, device=dev)
                              for off in self._chain_offsets()])[:, None]
            cols = self._dev["cols"][:, None, :]

            def step(st):
                u = lfsr_mod.counter_uniform(st[0], st[1], rows, cols)
                nxt = torch.stack([lfsr_mod.to_u64(st[0]),
                                   (lfsr_mod.to_u64(st[1]) + 1)
                                   & 0xFFFFFFFF])
                return lfsr_mod.from_u64(nxt), u
            return step

        perm = self._dev["lfsr_perm"]
        stuck = self._dev.get("lfsr_stuck")

        def step(st):
            # stuck register bits (api.Faults.lfsr_stuck) forced after the
            # decimated clock, before the read, as `core.pbit`'s noise does
            s = lfsr_mod.force_stuck_bits(
                lfsr_mod.lfsr_step_n(lfsr_mod.to_u64(st), self.decimation),
                stuck)
            flat = lfsr_mod.flat_cell_uniforms(s)
            u = flat.gather(2, perm[:, None, :].expand(
                -1, flat.shape[1], -1))
            return lfsr_mod.from_u64(s), u
        return step

    def _flip_step(self):
        """Transient-flip draw for every band: Bernoulli(flip_prob) per
        (chain, node) per half-sweep from the salted counter stream over
        global coordinates, read from the pre-half-sweep noise state (None
        when the fault model has no flips)."""
        f = self.faults
        if f is None or f.flip_prob <= 0.0:
            return None
        from repro_torch.api.faults import counter_flip_fn
        rows = torch.cat([off + torch.arange(self.b_loc, device=self.device)
                          for off in self._chain_offsets()])[:, None]
        return counter_flip_fn(f, rows, self._dev["cols"][:, None, :])

    def _loop_shape(self, collect: bool, hist: bool) -> str:
        """Which of the four loop shapes a call takes (see
        `_local_sweeps`)."""
        sync = self.sync
        use_fused = self._fused and not collect and not hist
        if use_fused:
            return ("fused" if sync.exchange_points() == (0,)
                    else "fused-resident-exchange")
        k, L = sync.halo_every, sync.sweeps_per_launch
        if sync.exchange_points() == (0,) or (
                isinstance(k, int) and k % 2 == 0 and (2 * L) % k == 0):
            return "segment scan"
        return "unrolled launch"

    def _local_sweeps(self, clamped, collect, accumulate, hist_w):
        """The band-batched launch loop.  Returns run(chip, m, ns, betas,
        measured?, cm?, cv?, vis_idx?, vis_w?) -> ((m, ns, *accs), traj).

        The sync policy places every halo exchange at a fixed exchange
        point; between them the bands sample against a stale halo.  Async
        mode double-buffers the exchange: the values consumed at an
        exchange point were sent at the previous one.  Four loop shapes:

          * fused — launch-resident counter-noise policies with
            launch-boundary-only exchange: on the card each launch is one
            K5 launch with ``ex_pts=(0,)`` for every band where K5 has a
            body for the shape; elsewhere one K1 launch per band
            (`fused_shard_sweeps`; collect/hist use a scan shape).
          * fused-resident-exchange — fused backends whose policy has
            mid-launch exchange points: the kernel owns the halo refresh.
            On the card one K5 launch per chunk runs every band; on the
            CPU, and for the bit-exact barrier's moments, the same launch
            split at the exchange points into half-sweep windows of K1 per
            band with an exchange between windows.
          * segment scan — exchanges uniformly spaced at full-sweep
            boundaries (``halo_every`` even or inf): one exchange, then the
            sweeps of the segment.
          * unrolled launch — odd ``halo_every`` (exchange points inside a
            sweep, e.g. the k=1 barrier's two per sweep): every launch's
            half-sweeps in order, exchanging at the policy's points.

        Both fused shapes' K5 launches share one `ExchangeTables` a call
        (`exchange_tables`) and run on the extended block ``[local |
        halo_up | halo_dn]``, kept between launches and sliced once at the
        end of the call (`exchange_launch`).
        """
        n_loc = self.plan.n_loc
        sync = self.sync
        L = sync.sweeps_per_launch
        ex_pts = sync.exchange_points()
        async_ = sync.mode == "async"
        k1_exact = sync.bit_exact
        shape = self._loop_shape(collect, hist_w is not None)
        # sweeps per step of the outer loop: a segment between two
        # exchanges, or a whole launch
        chunk = sync.halo_every // 2 \
            if shape == "segment scan" and ex_pts != (0,) else L
        dev = self.device
        d = self._dev
        send_up, send_dn, nbr = d["send_up"], d["send_dn"], d["nbr"]
        R = self.R_loc
        H = self.plan.halo
        inv_b = _recip(self.chains).to(dev)
        col0 = self._col0
        row0 = self.chain0
        comm = self.comm
        windows = self._cross_rows    # K5 per card: windows, edges between

        def exchange(m):
            return halo_exchange(m, send_up, send_dn, comm)

        def edge_swap(m_ext):
            """The boundary rows of this rank's edge bands to and from its
            row neighbours: (halo_up of band 0, halo_dn of band R-1)."""
            return comm.swap_edges(m_ext[0].index_select(1, send_up[0]),
                                   m_ext[-1].index_select(1, send_dn[-1]))

        def install_edges(m_ext, edges):
            """The outer edge halos of the extended block set in place (K5
            launches with ``edge_halos="block"`` keep them); the block is
            the call's own: a concatenation, a clamp or a K5 output."""
            m_ext[0, :, n_loc:n_loc + H] = edges[0]
            m_ext[-1, :, n_loc + H:] = edges[1]
            return m_ext

        def run(chip, m, ns, betas, measured=None, cm=None, cv=None,
                vis_idx=None, vis_w=None):
            nstep = self._noise_step()
            fstep = self._flip_step()
            w, h = chip["w"], chip["h"]
            gain, off = chip["gain"], chip["off"]
            rg, co = chip["rg"], chip["co"]
            masks = [d["upd"][:, c] for c in (0, 1)]
            if clamped:
                masks = [mk & ~cm for mk in masks]
            impose = clamped and cv is not None
            exact_stats = accumulate and k1_exact
            codes = []    # histogram: each sweep's visible codes
            tables = None
            if (shape in ("fused", "fused-resident-exchange")
                    and self._resident and not exact_stats):
                # what every K5 launch of this call shares, prepared once:
                # per card, every window is a launch with one exchange
                # point, and the edge halos come from the process group
                kwc = dict(clamp_mask=cm, clamp_values=cv) if impose else {}
                tables = exchange_tables(
                    d["nbr32"], w, h, gain, off, rg, co, masks[0], masks[1],
                    col0, send_up, send_dn, chains=m.shape[1],
                    ex_pts=(0,) if windows else ex_pts, mode=sync.mode,
                    edge_halos="block" if windows else "zero", **kwc)

            S_total = int(betas.shape[0])
            if S_total % L:
                raise ValueError(
                    f"this Session's sync policy fuses sweeps_per_launch="
                    f"{L} sweeps per launch, which must divide the "
                    f"schedule length (got {S_total} sweeps); pad the "
                    f"schedule or change the Sync policy")

            def swap(m, hu, hd, pend):
                """One exchange point: barrier consumes the fresh values;
                async consumes the in-flight buffer and refills it."""
                fresh = exchange(m)
                if async_:
                    return pend[0], pend[1], fresh
                return fresh[0], fresh[1], pend

            def half_sweep(m, hu, hd, ns, c, beta_t):
                """Colour ``c`` of every band against the halos (hu, hd),
                then the transient flips drawn from the pre-draw state."""
                flips = None if fstep is None else fstep(ns)
                ns, u = nstep(ns)
                m = halo_half_sweep(m, hu, hd, nbr, w, h, gain, off, rg, co,
                                    masks[c], beta_t, u)
                if flips is not None:
                    m = torch.where(masks[c][:, None, :] & flips, -m, m)
                return m, ns

            def sweep_stats(m, ru, rd, w_t, accs):
                """Per-sweep moment / histogram accumulation against the
                halo view (ru, rd) the policy defines."""
                accs = list(accs)
                if accumulate:
                    m_ext = torch.cat([m, ru, rd], dim=2)
                    B = m.shape[1]
                    e0 = d["edge_e0"][:, None, :].expand(-1, B, -1)
                    e1 = d["edge_e1"][:, None, :].expand(-1, B, -1)
                    corr = m_ext.gather(2, e0) * m_ext.gather(2, e1)
                    if self.n_chain == 1:
                        # the single-device engine's order (any B):
                        # fma(Σ_b m, w / B, acc), one rounding
                        w_b = w_t * inv_b
                        accs[0] = fma32(m.sum(dim=1), w_b, accs[0])
                        accs[1] = fma32(corr.sum(dim=1), w_b, accs[1])
                    else:
                        # raw ±1 sums over every chain shard: one division
                        # at the end (bit-exact for power-of-two chains)
                        accs[0] = accs[0] + w_t * m.sum(dim=1)
                        accs[1] = accs[1] + w_t * corr.sum(dim=1)
                else:  # histogram: each band's visible bits, then summed
                    vi = vis_idx[:, None, :].expand(-1, m.shape[1], -1)
                    bits = (m.gather(2, vi) > 0).to(torch.int64)
                    code = (bits * vis_w[:, None, :]).sum(dim=2).sum(dim=0)
                    # counted at the end of the call (`_count_codes`)
                    codes.append((code, w_t))
                return accs

            def band_launch(m, hu, hd, ns, betas_t, meas, h0=0, n_half=None):
                """K1 on every band's extended block (halos frozen), one
                launch per band; the per-band moments gathered to edges."""
                outs_m, s_b, c_b = [], [], []
                ns_out = ns
                for r in range(R):
                    kwc = {}
                    if impose:
                        kwc = dict(clamp_mask=cm[r], clamp_values=cv[r])
                    res = fused_shard_sweeps(
                        m[r], hu[r], hd[r], d["nbr32"][r], w[r], h[r],
                        gain[r], off[r], rg[r], co[r], masks[0][r],
                        masks[1][r], betas_t, ns, row0, col0[r],
                        measured=meas, half_offset=h0, n_half=n_half, **kwc)
                    outs_m.append(res[0])
                    ns_out = res[1]
                    if meas is not None:
                        s_b.append(res[2])
                        c_b.append(res[3][d["edge_slot"][r], d["edge_e0"][r]])
                m = torch.stack(outs_m)
                if meas is None:
                    return m, ns_out, None, None
                return m, ns_out, torch.stack(s_b), torch.stack(c_b)

            def add_kernel_moments(accs, s_k, c_k, B):
                if self.n_chain == 1:
                    inv = _recip(B).to(dev)
                    s_k, c_k = s_k * inv, c_k * inv
                return [accs[0] + s_k, accs[1] + c_k]

            def launch(state, betas_t, meas_t):
                """One launch: fused (boundary-only or kernel-owned
                exchange), or L sweeps of half-sweeps in order."""
                m, ns, hu, hd, pend, accs = state
                outs = []
                B = m.shape[1]
                if shape == "fused":
                    if impose:
                        m = torch.where(cm[:, None, :], cv, m)
                    hu, hd, pend = swap(m, hu, hd, pend)
                    m, ns, s_k, c_k = band_launch(
                        m, hu, hd, ns, betas_t,
                        meas_t if accumulate else None)
                    if accumulate:
                        accs = add_kernel_moments(accs, s_k, c_k, B)
                elif shape == "fused-resident-exchange":
                    # the emulation of K5's launch: split at the exchange
                    # points into half-sweep windows of K1
                    if impose:
                        m = torch.where(cm[:, None, :], cv, m)
                    kern_meas = meas_t \
                        if (accumulate and not exact_stats) else None
                    s_l = c_l = None
                    for h0, h1 in halo_exchange_segments(ex_pts, 2 * L):
                        hu, hd, pend = swap(m, hu, hd, pend)
                        m, ns, s_w, c_w = band_launch(
                            m, hu, hd, ns, betas_t, kern_meas, h0, h1 - h0)
                        if kern_meas is not None:
                            s_l = s_w if s_l is None else s_l + s_w
                            c_l = c_w if c_l is None else c_l + c_w
                        if exact_stats and h1 % 2 == 0:
                            # post-sweep refresh for boundary edges — part
                            # of the bit-exact contract
                            ru, rd = exchange(m)
                            accs = sweep_stats(m, ru, rd,
                                               meas_t[h1 // 2 - 1], accs)
                    if kern_meas is not None:
                        accs = add_kernel_moments(accs, s_l, c_l, B)
                else:
                    for s in range(L):
                        beta_t = betas_t[s]
                        if impose:
                            m = torch.where(cm[:, None, :], cv, m)
                        for c in (0, 1):
                            if 2 * s + c in ex_pts:
                                hu, hd, pend = swap(m, hu, hd, pend)
                            m, ns = half_sweep(m, hu, hd, ns, c, beta_t)
                        if accumulate:
                            if k1_exact:
                                # post-sweep refresh for boundary edges —
                                # part of the bit-exact contract
                                ru, rd = exchange(m)
                            else:
                                # relaxed policies read the (stale) halo
                                # the sweep itself saw
                                ru, rd = hu, hd
                            accs = sweep_stats(m, ru, rd, meas_t[s], accs)
                        elif hist_w is not None:
                            accs = sweep_stats(m, hu, hd, meas_t[s], accs)
                        elif collect:
                            outs.append(m)
                return (m, ns, hu, hd, pend, accs), outs

            def resident(state, betas_t, meas_t):
                """One K5 launch for every band on the extended block the
                call keeps: the kernel installs the halos at its exchange
                points, and under async its drained last exchange is the
                next launch's first halo."""
                m_ext, ns, _, _, _, accs = state
                if impose:  # the boundary is published post-clamp
                    m_ext = torch.where(tables.clamp_mask[:, None, :],
                                        tables.clamp_values, m_ext)
                res = exchange_launch(m_ext, tables, betas_t, ns, row0,
                                      meas_t if accumulate else None)
                if accumulate:
                    accs = kernel_moments(accs, res[2], res[3],
                                          m_ext.shape[1])
                return (res[0], res[1], None, None, None, accs), []

            def kernel_moments(accs, s_k, c_k, B):
                """A K5 call's (R, N_ext) / (R, D, N_ext) sums onto the
                per-band accumulators."""
                c_k = c_k[torch.arange(R, device=dev)[:, None],
                          d["edge_slot"], d["edge_e0"]]
                return add_kernel_moments(accs, s_k[:, :n_loc], c_k, B)

            def resident_windows(state, betas_t, meas_t):
                """One launch of K5 per card: a K5 launch with
                ``edge_halos="block"`` per window between the policy's
                exchange points, the rank's edge halos from its neighbours
                before each (async: the values of the exchange before,
                and after the last window the last exchange's), so the
                windows equal the one-process launch bit for bit."""
                m_ext, ns, _, _, _, accs = state
                if impose:
                    m_ext = torch.where(tables.clamp_mask[:, None, :],
                                        tables.clamp_values, m_ext)
                s_l = c_l = pend = None
                for e, (h0, h1) in enumerate(
                        halo_exchange_segments(ex_pts, 2 * L)):
                    fresh = edge_swap(m_ext)
                    if not async_:
                        m_ext = install_edges(m_ext, fresh)
                    elif e > 0:
                        m_ext = install_edges(m_ext, pend)
                    pend = fresh
                    win = slice(h0 // 2, h1 // 2)
                    res = exchange_launch(
                        m_ext, tables, betas_t[win], ns, row0,
                        meas_t[win] if accumulate else None)
                    m_ext, ns = res[0], res[1]
                    if accumulate:
                        s_l = res[2] if s_l is None else s_l + res[2]
                        c_l = res[3] if c_l is None else c_l + res[3]
                if async_:
                    m_ext = install_edges(m_ext, pend)
                if accumulate:
                    accs = kernel_moments(accs, s_l, c_l, m_ext.shape[1])
                return (m_ext, ns, None, None, None, accs), []

            def segment(state, betas_t, meas_t):
                """One inter-exchange segment: swap once, then the
                exchange-free sweeps of the segment."""
                m, ns, hu, hd, pend, accs = state
                if impose:
                    m = torch.where(cm[:, None, :], cv, m)  # sent post-clamp
                hu, hd, pend = swap(m, hu, hd, pend)
                outs = []
                for s in range(betas_t.shape[0]):
                    if impose:
                        m = torch.where(cm[:, None, :], cv, m)
                    for c in (0, 1):
                        m, ns = half_sweep(m, hu, hd, ns, c, betas_t[s])
                    if accumulate or hist_w is not None:
                        accs = sweep_stats(m, hu, hd, meas_t[s], accs)
                    elif collect:
                        outs.append(m)
                return (m, ns, hu, hd, pend, accs), outs

            body = (segment if shape == "segment scan" else launch
                    if tables is None else
                    resident_windows if windows else resident)
            zh = m.new_zeros((R, m.shape[1], self.plan.halo))
            pend = ()
            if async_:
                # prime the in-flight buffer with the initial boundary —
                # post-clamp, exactly what the first barrier exchange
                # would send — so the first consumption matches barrier
                m_pr = torch.where(cm[:, None, :], cv, m) if impose else m
                pend = exchange(m_pr)
            accs = []
            if accumulate:
                accs = [torch.zeros((R, n_loc), dtype=torch.float32,
                                    device=dev),
                        torch.zeros((R, self.plan.e_loc),
                                    dtype=torch.float32, device=dev)]
            elif hist_w is not None:
                accs = [torch.zeros((2 ** hist_w,), dtype=torch.float32,
                                    device=dev)]
            state = (m, ns, zh, zh, pend, accs)
            if tables is not None:
                # the extended block, kept between the K5 launches, and the
                # schedule as (S, B) rows once: a launch's slice is a view
                halos = pend if async_ else (zh, zh)
                state = (torch.cat([m, *halos], dim=2), ns, None, None, None,
                         accs)
                if betas.ndim == 1:
                    betas = betas[:, None].expand(-1, m.shape[1]).contiguous()
            traj = []
            for t0 in range(0, S_total, chunk):
                meas_t = None if measured is None \
                    else measured[t0:t0 + chunk]
                state, outs = body(state, betas[t0:t0 + chunk], meas_t)
                traj += outs
            m, ns, _, _, _, accs = state
            if tables is not None:
                m = m[:, :, :n_loc]
            if codes:
                accs = [self._count_codes(accs[0], codes)]
            return (m, ns, *accs), (torch.stack(traj) if collect else None)

        return run

    # ------------------------------------------------------------------
    # public entry points (the Session delegates to these)
    # ------------------------------------------------------------------
    def _clamp_parts(self, cm, cv):
        if cm is None:
            return {}
        kw = {"cm": self._part_cols(torch.as_tensor(cm, device=self.device)
                                    .to(torch.bool))}
        if cv is not None:
            kw["cv"] = self._m_parts(torch.as_tensor(
                cv, dtype=torch.float32, device=self.device))
        return kw

    def _count_codes(self, hist, codes):
        """The per-sweep visible codes -> the histogram, counted sweep by
        sweep.  Under a rank mesh each rank's partial codes are first
        summed across the row ranks (the reference's psum; each band's
        bits are its own powers of two: exact) and laid out on the global
        chains."""
        code = torch.stack([c for c, _ in codes])        # (S, B_loc)
        if self.comm is not None:
            parts = self.comm.all_gather(code)
            code = code.new_zeros((code.shape[0], self.chains))
            for k, (_, _, c0, c1) in enumerate(self._blocks):
                cols = slice(c0 * self.b_loc, c1 * self.b_loc)
                code[:, cols] = code[:, cols] + parts[k]
        for s, (_, w_t) in enumerate(codes):
            hist = hist.index_add(0, code[s], w_t.expand(self.chains))
        return hist

    def sample(self, chip, m, ns, betas, cm=None, cv=None, collect=False):
        """(m', noise_state', traj|None), as `core.pbit.gibbs_sample`."""
        run = self._local_sweeps(cm is not None, collect, False, None)
        betas = torch.as_tensor(betas, dtype=torch.float32,
                                device=self.device)
        (m_o, ns_o), traj = run(self._chip_parts(chip), self._m_parts(m),
                                self._ns_parts(ns), self._betas_here(betas),
                                **self._clamp_parts(cm, cv))
        if collect:
            # (S, n_row, B, n_loc) -> (S, B, N)
            traj = self._gather(traj, band_dim=1, chain_dim=2)
            t = traj.permute(0, 2, 1, 3).reshape(traj.shape[0],
                                                 traj.shape[2], -1)
            traj = t[:, :, self._inv_ids]
        return self._m_global(m_o), self._ns_global(ns, ns_o), traj

    def stats(self, chip, m, ns, beta, n_sweeps, burn_in, cm=None, cv=None,
              *, sums=False):
        """(mean_spin[N], mean_edge_corr[E], m', noise_state'), or with
        ``sums`` (s_acc, c_acc, inv, m', noise_state'), as
        `core.pbit.gibbs_stats`."""
        dev = self.device
        run = self._local_sweeps(cm is not None, False, True, None)
        betas = torch.full((n_sweeps,), beta, dtype=torch.float32,
                           device=dev)
        measured = (torch.arange(n_sweeps, device=dev) >= burn_in).to(
            torch.float32)
        denom = max(n_sweeps - burn_in, 1)
        (m_o, ns_o, s_acc, c_acc), _ = run(
            self._chip_parts(chip), self._m_parts(m), self._ns_parts(ns),
            betas, measured, **self._clamp_parts(cm, cv))
        scale = (np.float32(denom) if self.n_chain == 1
                 else np.float32(denom) * np.float32(self.chains))
        inv = _recip(scale).to(dev)
        # per band: gathered across the row ranks; a chains partition's raw
        # sums added across its chain ranks (the reference's psum)
        s = self._gather(s_acc, chain_dim=None).reshape(-1)[self._inv_ids]
        c = self._gather(c_acc, chain_dim=None).reshape(-1)[self._edge_inv]
        m_o, ns_o = self._m_global(m_o), self._ns_global(ns, ns_o)
        if sums:
            return s, c, inv, m_o, ns_o
        return s * inv, c * inv, m_o, ns_o

    def visible_hist(self, chip, m, ns, betas, burn_in, visible_idx,
                     cm=None, cv=None):
        """(counts[2^nv], m', noise_state'), as
        `core.pbit.gibbs_visible_hist`."""
        dev = self.device
        visible_idx = np.asarray(visible_idx)
        nv = int(visible_idx.shape[0])
        p = self.plan
        vi = np.zeros((p.n_shards, nv), np.int64)
        vw = np.zeros((p.n_shards, nv), np.int64)
        owner = np.searchsorted(p.node_starts[1:], visible_idx,
                                side="right")
        for k, (v, d) in enumerate(zip(visible_idx, owner)):
            vi[d, k] = v - p.node_starts[d]
            vw[d, k] = 2 ** k
        run = self._local_sweeps(cm is not None, False, False, nv)
        betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
        n_sweeps = betas.shape[0]
        measured = (torch.arange(n_sweeps, device=dev) >= burn_in).to(
            torch.float32)
        (m_o, ns_o, hist), _ = run(
            self._chip_parts(chip), self._m_parts(m), self._ns_parts(ns),
            self._betas_here(betas), measured,
            vis_idx=torch.as_tensor(vi[self._bands], device=dev),
            vis_w=torch.as_tensor(vw[self._bands], device=dev),
            **self._clamp_parts(cm, cv))
        return hist, self._m_global(m_o), self._ns_global(ns, ns_o)


# ---------------------------------------------------------------------------
# SK lattices (SoA instance generator + Session-backed anneal)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    cell_rows: int
    cell_cols: int
    k: int = 4
    beta: float = 1.0
    chains: int = 1   # Gibbs replicas: couplings are read once per
                      # half-sweep and serve all chains

    @property
    def n_spins(self) -> int:
        return self.cell_rows * self.cell_cols * 2 * self.k


@dataclasses.dataclass
class LatticeChip:
    """SK-lattice couplings + neuron params, structure-of-arrays (O(N)).

    The *instance description*; `lattice_to_chip` converts it into the
    shared `EffectiveChip` slot layout the backends sample."""

    W_vh: torch.Tensor
    W_hv: torch.Tensor
    Wv_dn: torch.Tensor
    Wv_up: torch.Tensor
    Wh_rt: torch.Tensor
    Wh_lt: torch.Tensor
    h_v: torch.Tensor
    h_h: torch.Tensor
    gain_v: torch.Tensor
    gain_h: torch.Tensor
    off_v: torch.Tensor
    off_h: torch.Tensor


def make_sk_lattice(spec: LatticeSpec, gen: torch.Generator,
                    hw: HardwareConfig | None = None,
                    dtype=torch.float32, device="cuda") -> LatticeChip:
    """Random SK-style lattice instance with per-site mismatch baked in,
    drawn from ``gen`` (a `torch.Generator` on ``device``): the
    reference's formula, equal to its draw in distribution only."""
    hw = hw or HardwareConfig()
    R, C, k = spec.cell_rows, spec.cell_cols, spec.k

    def g(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, dtype=dtype,
                                   device=device)

    W_cell = g((R, C, k, k), 0.8)                       # shared edge DAC
    mis_vh = 1.0 + hw.sigma_edge_gain * g((R, C, k, k))
    mis_hv = 1.0 + hw.sigma_edge_gain * g((R, C, k, k))
    Wv = g((R, C, k), 0.8)
    Wh = g((R, C, k), 0.8)
    row = torch.arange(R, device=device)[:, None, None]
    col = torch.arange(C, device=device)[None, :, None]
    # no couplers past the lattice edge
    Wv = Wv * (row < R - 1)
    Wh = Wh * (col < C - 1)
    zeros = torch.zeros((R, C, k), dtype=dtype, device=device)
    return LatticeChip(
        W_vh=W_cell * mis_vh,
        W_hv=torch.swapaxes(W_cell, -1, -2) * mis_hv,
        Wv_dn=Wv * (1.0 + hw.sigma_edge_gain * g((R, C, k))),
        Wv_up=Wv * (1.0 + hw.sigma_edge_gain * g((R, C, k))),
        Wh_rt=Wh * (1.0 + hw.sigma_edge_gain * g((R, C, k))),
        Wh_lt=Wh * (1.0 + hw.sigma_edge_gain * g((R, C, k))),
        h_v=zeros,
        h_h=zeros.clone(),
        gain_v=1.0 + hw.sigma_tanh_gain * g((R, C, k)),
        gain_h=1.0 + hw.sigma_tanh_gain * g((R, C, k)),
        off_v=hw.sigma_tanh_offset * 0.01 * g((R, C, k)),
        off_h=zeros.clone(),
    )


def lattice_to_chip(spec: LatticeSpec, lat: LatticeChip,
                    graph: ChimeraGraph | None = None,
                    tables=None) -> EffectiveChip:
    """SoA lattice arrays -> the shared `EffectiveChip` slot layout, on the
    lattice's device.

    Directional: ``nbr_w[d, i] = W[i, nbr_idx[d, i]]`` (current INTO node
    i).  O(D·N) gathers and selects, no arithmetic: bit-equal to the
    reference's conversion of the same arrays.
    """
    g = graph if graph is not None else make_chimera(
        spec.cell_rows, spec.cell_cols, spec.k)
    if tables is None:
        nbr_idx, _ = g.neighbor_table()
        slot_ij, slot_ji = g.edge_slots(nbr_idx)
    else:
        nbr_idx, slot_ij, slot_ji = tables
    dev = lat.W_vh.device
    dtype = lat.W_vh.dtype

    def long(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    r_, c_, s_, k_ = (long(a) for a in (g.node_r, g.node_c, g.node_side,
                                        g.node_k))
    vert_node = s_ == 0
    h = torch.where(vert_node, lat.h_v[r_, c_, k_], lat.h_h[r_, c_, k_])
    gain = torch.where(vert_node, lat.gain_v[r_, c_, k_],
                       lat.gain_h[r_, c_, k_])
    off = torch.where(vert_node, lat.off_v[r_, c_, k_],
                      lat.off_h[r_, c_, k_])

    e0, e1 = long(g.edges[:, 0]), long(g.edges[:, 1])
    r0, c0, k0 = r_[e0], c_[e0], k_[e0]
    k1 = k_[e1]
    incell = (r_[e1] == r0) & (c_[e1] == c0)
    vert = (s_[e0] == 0) & (s_[e1] == 0)
    w_in0 = torch.where(
        incell, lat.W_vh[r0, c0, k0, k1],
        torch.where(vert, lat.Wv_up[r0, c0, k0], lat.Wh_lt[r0, c0, k0]))
    w_in1 = torch.where(
        incell, lat.W_hv[r0, c0, k1, k0],
        torch.where(vert, lat.Wv_dn[r0, c0, k0], lat.Wh_rt[r0, c0, k0]))
    D = nbr_idx.shape[0]
    nbr_w = torch.zeros((D, g.n_nodes), dtype=dtype, device=dev)
    nbr_w[long(slot_ij), e0] = w_in0
    nbr_w[long(slot_ji), e1] = w_in1
    ones = torch.ones((g.n_nodes,), dtype=dtype, device=dev)
    return EffectiveChip(
        W=None, h=h.to(dtype), tanh_gain=gain.to(dtype),
        tanh_offset=off.to(dtype), rand_gain=ones,
        comp_offset=0.0 * ones,
        nbr_idx=torch.as_tensor(np.asarray(nbr_idx, np.int32), device=dev),
        nbr_w=nbr_w)


def sparse_energy(chip: EffectiveChip, m: torch.Tensor,
                  engine: "ShardedEngine | None" = None) -> torch.Tensor:
    """Symmetrized Ising energy per chain from the slot layout, O(B·N·D):
    E = -1/2 Σ_i m_i Σ_j W_ij m_j - Σ_i h_i m_i (the directional W averaged
    over its two directions).

    ``engine``: a rank mesh's `ShardedEngine`.  Each rank sums the terms of
    its own bands' nodes for its own chains, and the partial energies are
    added across the row ranks in rank order, so every rank returns the
    global (B,) energies — equal to the one-process sum up to float32
    association (ROADMAP Queue 3 item 10)."""
    idx = chip.nbr_idx.to(torch.int64)
    if engine is None or engine.comm is None:
        I = sparse_neuron_input(m, idx, chip.nbr_w, 0.0)
        return -0.5 * torch.sum(m * I, dim=1) - m @ chip.h
    starts = engine.plan.node_starts
    lo = int(starts[engine._bands.start])
    hi = int(starts[engine._bands.stop])
    mc = engine._my_chains(m)
    I = sparse_neuron_input(mc, idx[:, lo:hi], chip.nbr_w[:, lo:hi], 0.0)
    own = mc[:, lo:hi]
    parts = engine.comm.all_gather(
        -0.5 * torch.sum(own * I, dim=1) - own @ chip.h[lo:hi])
    out = m.new_zeros((m.shape[0],))
    for k, (_, _, c0, c1) in enumerate(engine._blocks):
        cols = slice(c0 * engine.b_loc, c1 * engine.b_loc)
        out[cols] = out[cols] + parts[k]
    return out


def make_lattice_anneal(
    spec: LatticeSpec,
    mesh: Mesh | None,
    *,
    row_axes: tuple[str, ...] = ("data",),
    col_axes: tuple[str, ...] = ("model",),
    n_sweeps: int = 100,
    record_every: int = 10,
    device="cuda",
):
    """The (optionally row-band sharded) annealing run over the shared
    engine: cell rows partition over ``row_axes`` exactly like every other
    sharded `api.Session` workload (``col_axes`` is accepted for
    signature compatibility — the spatial cut is 1-D over cell rows).
    Under a rank mesh (`make_rank_mesh`) every rank runs it: the spins are
    the one-process run's on every rank, and the energies are summed
    across the ranks (`sparse_energy` with the engine).

    Returns run(lattice_chip, gen, betas) -> (final_m (chains, N),
    energies (n_sweeps // record_every,)); ``gen`` is a `torch.Generator`
    on ``device`` that draws the initial spins and the noise seed.
    """
    from repro_torch import api
    from repro_torch.core import pbit
    from repro_torch.core.hardware import sample_mismatch_sparse

    if n_sweeps % record_every:
        raise ValueError(f"n_sweeps={n_sweeps} must be a multiple of "
                         f"record_every={record_every}")
    del col_axes
    g = make_chimera(spec.cell_rows, spec.cell_cols, spec.k)
    nbr_idx, _ = g.neighbor_table()
    tables = (nbr_idx, *g.edge_slots(nbr_idx))
    ideal = HardwareConfig.ideal()
    mm_gen = torch.Generator(device=torch.device(device)).manual_seed(0)
    sp = api.SamplerSpec(
        graph=g, hw=ideal,
        mismatch=sample_mismatch_sparse(mm_gen, g.n_nodes, nbr_idx.shape[0],
                                        ideal, device=device),
        noise="counter", backend="sparse", chains=spec.chains,
        beta=spec.beta, mesh=mesh, device=device,
        partition=(api.Partition(rows=row_axes) if mesh is not None
                   else None))
    session = api.Session(sp)
    n_rec = n_sweeps // record_every

    def run(lat: LatticeChip, gen: torch.Generator, betas):
        chip = lattice_to_chip(spec, lat, g, tables)
        m = pbit.random_spins(gen, spec.chains, g.n_nodes, device=device)
        ns = session.noise_state(gen)
        betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
        segs = betas[:n_rec * record_every].reshape(n_rec, record_every)
        energies = []
        for b in segs:
            m, ns, _ = session.sample(chip, m, ns, b)
            energies.append(sparse_energy(chip, m, session._engine).mean())
        return m, torch.stack(energies)

    return run


def lattice_input_sharding(mesh: Mesh, row_axes=("data",),
                           col_axes=("model",)):
    """The lattice's (rows, cols) input split over ``row_axes`` and
    ``col_axes`` of the mesh (a `models.sharding.NamedSharding`)."""
    from repro_torch.models.sharding import NamedSharding, P
    return NamedSharding(mesh, P(row_axes, col_axes))
