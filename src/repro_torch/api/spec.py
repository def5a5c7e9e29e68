"""Declarative sampler specification: one frozen object describes a solver.

A `SamplerSpec` names *what* to sample (graph + chip programming model),
*how* (noise source, execution backend, beta `Schedule`) and *where*
(``device``); `api.Session` resolves it once (see session.py).
Counterpart of ``repro.api.spec``, single device:

  * ``backend`` — ``ref | pallas | fused | sparse | fused_sparse | auto``.
    ``auto`` consults ``REPRO_PBIT_BACKEND`` (a construction-time default,
    never read at call time) and otherwise picks ``fused_sparse`` when the
    spec carries the Chimera slot layout and the noise can be generated in
    the kernel (``counter`` / ``lfsr``), ``sparse`` when it carries the
    layout but the noise is host-side (``philox``), ``fused`` for a
    dense-only spec whose engine fits Hopper's limits
    (`dense_resident_feasible`), else ``ref``.
  * ``noise`` — ``philox | counter | lfsr`` (see core/pbit.py).
  * ``schedule`` — `Constant`, `Anneal` (geometric/linear) or `Tempered`
    (per-chain ladder -> (S, B) betas).
  * ``device`` — where chips, spins and noise live; default ``"cuda"``.
    A Session on the default device without a GPU raises — it does not
    carry on on the CPU.
  * ``mesh`` + ``partition`` + ``sync`` — row-band sharded execution
    (`core/distributed.py`).  A `Partition` names the mesh axis the cell
    rows shard over (contiguous row bands; only the chain-coupler boundary
    spins move between neighbouring bands) and/or the axis the chains
    shard over; a `Sync` says how often the bands exchange halos.  On one
    card every band lives on ``device``.
  * ``faults`` — an `api.Faults` realization (stuck spins, dead and
    saturated couplers, stuck LFSR bits, transient flips) that `Session`
    compiles into every backend.  Flips and stuck LFSR bits run between
    half-sweeps on the host side of the loop, so ``auto`` takes the
    half-sweep loop under them and an explicit fused backend raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Any

import numpy as np
import torch

from repro_torch.api.faults import Faults
from repro_torch.core.chimera import ChimeraGraph
from repro_torch.core.hardware import HardwareConfig, Mismatch, SparseMismatch
from repro_torch.core.distributed import k5_runs, plan_row_partition
from repro_torch.core.ranks import rank_blocks
from repro_torch.kernels.sweep_fused import (card_limits,
                                             dense_resident_feasible)

BACKENDS = ("ref", "pallas", "fused", "sparse", "fused_sparse")
FUSED_BACKENDS = ("fused", "fused_sparse")
SPARSE_BACKENDS = ("sparse", "fused_sparse")
NOISE_KINDS = ("philox", "counter", "lfsr")
IN_KERNEL_NOISE = ("counter", "lfsr")


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------
def _unit_ramp(n: int) -> np.ndarray:
    """float32 ``linspace(0, 1, n)`` with the reference's rounding: its
    compiled ``i / (n-1)`` is ``i * (1 / (n-1))`` in float32 for i < n-1,
    and the endpoint is exact."""
    if n <= 1:
        return np.zeros((max(n, 0),), np.float32)
    div = n - 1
    step = np.arange(div, dtype=np.float32) * (np.float32(1) / np.float32(div))
    return np.concatenate([step, np.ones((1,), np.float32)])


def _pow32(base: float, t: np.ndarray) -> np.ndarray:
    """float32 ``base ** t``.  The reference's compiled float32 power is
    close to correctly rounded, so the power is taken in float64 and
    rounded once; the two agree except for a last-place difference in
    under 0.1% of entries (libm's float32 ``powf`` is off far more often).
    """
    return np.power(np.float64(np.float32(base)),
                    t.astype(np.float64)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base class: a declarative inverse-temperature schedule.

    ``betas(chains)`` materializes the (S,) shared — or (S, B) per-chain —
    float32 numpy array; the Session moves it to its device.  Schedules
    are frozen, hashable value objects.  ``n_sweeps`` is keyword-only so
    subclasses keep natural positional order:
    ``Anneal(0.05, 3.0, n_sweeps=600)``.
    """

    n_sweeps: int = dataclasses.field(default=1, kw_only=True)

    def betas(self, chains: int | None = None) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(Schedule):
    """Fixed beta for every sweep — the Boltzmann-sampling workloads."""

    beta: float = 1.0

    def betas(self, chains: int | None = None) -> np.ndarray:
        return np.full((self.n_sweeps,), self.beta, np.float32)


@dataclasses.dataclass(frozen=True)
class Anneal(Schedule):
    """Simulated-annealing ramp (the chip's V_temp sweep, paper Fig. 9a)."""

    beta_start: float = 0.05
    beta_end: float = 3.0
    kind: str = "geometric"  # or "linear"

    def __post_init__(self):
        if self.kind not in ("geometric", "linear"):
            raise ValueError(
                f"Anneal.kind must be 'geometric' or 'linear', "
                f"got {self.kind!r}")

    def betas(self, chains: int | None = None) -> np.ndarray:
        t = _unit_ramp(self.n_sweeps)
        start = np.float32(self.beta_start)
        if self.kind == "geometric":
            return (start * _pow32(self.beta_end / self.beta_start, t)
                    ).astype(np.float32)
        span = np.float32(self.beta_end - self.beta_start)
        return (start + span * t).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Tempered(Schedule):
    """Per-chain beta ladder -> (S, B) matrix (parallel-tempering replicas).

    ``ladder`` is one beta per chain; every sweep runs the whole ladder.
    """

    ladder: tuple = (1.0,)

    @staticmethod
    def geometric(beta_min: float, beta_max: float, n_replicas: int,
                  n_sweeps: int = 1) -> "Tempered":
        r = (np.arange(n_replicas, dtype=np.float32)
             / np.float32(max(n_replicas - 1, 1)))
        ladder = np.float32(beta_min) * _pow32(beta_max / beta_min, r)
        return Tempered(n_sweeps=n_sweeps,
                        ladder=tuple(float(b) for b in ladder))

    def betas(self, chains: int | None = None) -> np.ndarray:
        ladder = np.asarray(self.ladder, np.float32)
        if chains is not None and ladder.shape[0] != chains:
            raise ValueError(
                f"Tempered ladder has {ladder.shape[0]} rungs but the spec "
                f"runs {chains} chains; one beta per chain is required")
        return np.broadcast_to(ladder, (self.n_sweeps, ladder.shape[0])
                               ).copy()


# ---------------------------------------------------------------------------
# Partitioning
# ---------------------------------------------------------------------------
def _norm_axes(axes) -> tuple[str, ...]:
    """None -> (); "data" -> ("data",); tuples pass through."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Declarative partition choice, resolved at Session construction.

    ``rows`` names the mesh axis (or axes, flattened in order) the Chimera
    *cell rows* shard over: each band owns a contiguous range of cell rows
    plus the O(D·n_loc) slice of the slot tables, and only the
    chain-coupler boundary spins (the vertical nodes of the band's first
    and last cell row — O(√N)) move between row neighbours.  ``chains``
    names the axis the Gibbs chains shard over.  Spins equal the
    single-device engine's for any chain count; the moments do too when
    the chains are a power of two (their shards' raw sums are then
    divided exactly).  Both may be set at once (rows x chains).  Sharded execution needs noise that regenerates per (chain,
    node) coordinate: ``noise`` "counter" or "lfsr".
    """

    rows: str | tuple[str, ...] | None = "data"
    chains: str | tuple[str, ...] | None = None

    @property
    def rows_axes(self) -> tuple[str, ...]:
        return _norm_axes(self.rows)

    @property
    def chain_axes(self) -> tuple[str, ...]:
        return _norm_axes(self.chains)


# ---------------------------------------------------------------------------
# Synchronization policy (sharded execution)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sync:
    """How often row bands exchange halos — a sampler property.

    * ``halo_every=k`` — exchange the boundary spins before every k-th
      half-sweep of a launch (a launch boundary always refreshes).  ``k=1``
      (the default) is the bit-exact barrier; ``k>1`` lets bands run on
      halos up to ``k-1`` half-sweeps stale; ``math.inf`` exchanges only at
      launch boundaries.
    * ``mode`` — ``"barrier"`` consumes each exchange at once; ``"async"``
      double-buffers it: the values consumed at exchange point t are the
      ones sent at point t-1 (deterministic, seeded staleness).
    * ``sweeps_per_launch=S`` — fuse S sweeps into one launch between
      launch boundaries.  With counter noise and ``fused_sparse`` a launch
      runs inside K1 per band (no mid-launch exchange) or, with exchange
      points inside the launch (``halo_every <= S``), inside K5, which
      refreshes the halos itself.

    ``halo_every=1`` keeps sharded == single-device bit for bit; anything
    looser is a deterministic approximation.
    """

    halo_every: int | float = 1
    mode: str = "barrier"
    sweeps_per_launch: int = 1

    def __post_init__(self):
        k = self.halo_every
        if not (k == math.inf or (isinstance(k, int) and k >= 1)):
            raise ValueError(
                f"Sync.halo_every must be an int >= 1 or math.inf, got "
                f"{k!r}")
        if self.mode not in ("barrier", "async"):
            raise ValueError(
                f"Sync.mode must be 'barrier' or 'async', got {self.mode!r}")
        if not (isinstance(self.sweeps_per_launch, int)
                and self.sweeps_per_launch >= 1):
            raise ValueError(
                f"Sync.sweeps_per_launch must be an int >= 1, got "
                f"{self.sweeps_per_launch!r}")

    @property
    def bit_exact(self) -> bool:
        """Does this policy keep the single-device spin trajectory
        exactly?  Only the per-half-sweep barrier does."""
        return self.mode == "barrier" and self.halo_every == 1

    @property
    def launch_resident(self) -> bool:
        return self.sweeps_per_launch > 1

    def exchange_points(self) -> tuple[int, ...]:
        """Within-launch half-sweep indices at which halos refresh (a
        launch spans ``2 * sweeps_per_launch`` half-sweeps; index 0, the
        launch boundary, always refreshes)."""
        n_half = 2 * self.sweeps_per_launch
        if self.halo_every == math.inf:
            return (0,)
        k = int(self.halo_every)
        return tuple(hs for hs in range(n_half) if hs % k == 0)

    @property
    def kernel_fusible(self) -> bool:
        """No mid-launch exchange: a launch is one K1 launch per band."""
        return self.exchange_points() == (0,)

    @property
    def fused_compatible(self) -> bool:
        """Can a fused backend run this policy?  With no mid-launch
        exchange (`kernel_fusible`), or when K5 owns the refresh: any
        ``halo_every <= sweeps_per_launch``.  The infeasible window is
        ``sweeps_per_launch < halo_every < 2 * sweeps_per_launch``."""
        if self.kernel_fusible:
            return True
        return (isinstance(self.halo_every, int)
                and self.halo_every <= self.sweeps_per_launch)

    def exchanges_per_sweep(self, refresh_for_moments: bool = False
                            ) -> float:
        """Average halo exchanges per full sweep under this policy (the
        halo-bytes model's multiplier)."""
        per = len(self.exchange_points()) / self.sweeps_per_launch
        if refresh_for_moments and self.bit_exact:
            per += 1.0  # post-sweep refresh for boundary-edge correlations
        return per


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class SamplerSpec:
    """Frozen description of one solver instance.

    ``Session(spec)`` validates and resolves it; specs themselves read no
    environment variables.  The mismatch tensors should live on
    ``device`` (`PBitMachine.create` draws them there).
    """

    graph: ChimeraGraph
    hw: HardwareConfig
    mismatch: Mismatch | SparseMismatch
    noise: str = "philox"
    backend: str = "auto"
    schedule: Schedule | None = None
    chains: int = 256
    beta: float = 1.0           # base inverse temperature (stats / hist)
    w_scale: float = 0.05       # weight-LSB -> coupling units
    decimation: int = 8         # LFSR clocks per half-sweep
    attach_sparse: bool = True  # carry the Chimera slot layout on dense chips
    device: str | torch.device = "cuda"
    mesh: Any = None            # core.distributed.Mesh; None -> unsharded
    partition: Partition | None = None  # how to cut over mesh
    sync: Sync | None = None    # halo exchange policy; None -> Sync()
    faults: Faults | None = None  # discrete fault injection; None -> healthy

    @property
    def sparse_native(self) -> bool:
        """Only the O(D·N) slot model exists (no dense W can ever be built)."""
        return isinstance(self.mismatch, SparseMismatch)

    @property
    def has_slot_layout(self) -> bool:
        """Will programmed chips carry the (D, N) neighbor-table view?"""
        return self.sparse_native or self.attach_sparse

    def replace(self, **kw) -> "SamplerSpec":
        return dataclasses.replace(self, **kw)

    def partitioning(self) -> Partition | None:
        """The effective Partition: rows over "data" when a mesh is given
        without an explicit partition; None when unsharded."""
        if self.mesh is None:
            return None
        return self.partition if self.partition is not None else Partition()

    def sync_policy(self) -> Sync | None:
        """The effective Sync policy: the bit-exact per-half-sweep barrier
        when a mesh is given without an explicit sync; None unsharded."""
        if self.mesh is None:
            return None
        return self.sync if self.sync is not None else Sync()

    def fingerprint(self) -> tuple:
        """Shape-bucket key for this spec (a hashable tuple).

        Two specs with equal fingerprints give interchangeable Sessions:
        the *resolved* backend (so ``backend="auto"`` and the name it
        resolves to share a key), the device type, the graph's shape
        (rows/cols/k/masked cells), the schedule/chains/beta/decimation
        statics and the mismatch *structure* (type + per-field dtype and
        shape, never the drawn values).  Chips, `Program`s and mismatch
        draws are runtime operands (`Session.sample_program`, the CD step's
        ``with_mismatch``), so two chip instances of one SKU share a key.
        The analog `HardwareConfig` scalars are not keyed: a cache mixing
        them must key on ``hw`` separately.  A `Faults` realization is
        keyed by its ``repr``: it changes programming and the update masks.
        ``REPRO_PBIT_BACKEND`` is read as `Session` construction reads it.
        """
        g = self.graph
        graph_sig = ("chimera", int(g.rows), int(g.cols), int(g.k),
                     tuple(sorted(tuple(c) for c in g.masked_cells)),
                     int(g.n_nodes), int(g.edges.shape[0]))
        mm = self.mismatch
        mm_sig = (type(mm).__name__,
                  tuple((f.name, str(getattr(mm, f.name).dtype),
                         tuple(getattr(mm, f.name).shape))
                        for f in dataclasses.fields(mm)))
        mesh_sig = None
        if self.mesh is not None:
            ranks = getattr(self.mesh, "ranks", None)
            mesh_sig = (tuple(self.mesh.axis_names),
                        tuple(int(self.mesh.shape[a])
                              for a in self.mesh.axis_names),
                        tuple(int(d) for d in
                              np.asarray(self.mesh.devices).reshape(-1)),
                        None if ranks is None else
                        tuple(int(r) for r in np.asarray(ranks).reshape(-1)))
        part = self.partitioning()
        part_sig = None if part is None else (part.rows_axes, part.chain_axes)
        sync = self.sync_policy()
        sync_sig = None if sync is None else (
            sync.halo_every, sync.mode, sync.sweeps_per_launch)
        sched_sig = None
        if self.schedule is not None:
            sched_sig = (type(self.schedule).__name__,
                         tuple(sorted(dataclasses.asdict(
                             self.schedule).items())))
        return (graph_sig, mm_sig, self.noise, resolve_backend(self),
                torch.device(self.device).type, int(self.chains),
                float(self.beta), float(self.w_scale), int(self.decimation),
                bool(self.attach_sparse), mesh_sig, part_sig, sync_sig,
                sched_sig,
                None if self.faults is None else repr(self.faults))

    def validate(self) -> "SamplerSpec":
        """Static sanity checks; raises ValueError naming the fix."""
        if self.noise not in NOISE_KINDS:
            raise ValueError(
                f"unknown noise {self.noise!r}; pick from {NOISE_KINDS}")
        if self.backend not in BACKENDS + ("auto",) and \
                self.backend is not None:
            raise ValueError(
                f"unknown backend {self.backend!r}; pick from "
                f"{BACKENDS + ('auto',)}")
        if self.backend in FUSED_BACKENDS and \
                self.noise not in IN_KERNEL_NOISE:
            raise ValueError(
                f"backend {self.backend!r} generates noise in-kernel and "
                f"needs noise='counter' or 'lfsr', got {self.noise!r}")
        if self.backend in SPARSE_BACKENDS and not self.has_slot_layout:
            raise ValueError(
                f"backend {self.backend!r} needs the Chimera slot layout; "
                f"use attach_sparse=True or a sparse-native mismatch")
        if self.sparse_native and self.backend in ("ref", "pallas", "fused"):
            raise ValueError(
                f"this spec is sparse-native (no dense W exists); backend "
                f"{self.backend!r} cannot run it — use 'sparse', "
                f"'fused_sparse', or 'auto'")
        if self.chains < 1:
            raise ValueError(f"chains must be >= 1, got {self.chains}")
        if self.schedule is not None:
            self.schedule.betas(self.chains)  # raises on ladder mismatch
        self._validate_partition()
        self._validate_faults()
        return self

    def _validate_partition(self) -> None:
        if self.partition is not None and self.mesh is None:
            raise ValueError(
                "partition= set but mesh=None; pass the mesh the partition "
                "shards over (core.distributed.make_mesh)")
        if self.sync is not None and self.mesh is None:
            raise ValueError(
                "sync= is a sharded-execution policy (how often row bands "
                "exchange halos) but mesh=None; pass mesh= or drop sync=")
        part = self.partitioning()
        if part is None:
            return
        mesh_axes = tuple(self.mesh.axis_names)
        rows, chains = part.rows_axes, part.chain_axes
        if not rows and not chains:
            raise ValueError(
                "mesh= set but the Partition shards nothing; set "
                "Partition(rows=...) and/or Partition(chains=...)")
        for ax in rows + chains:
            if ax not in mesh_axes:
                raise ValueError(
                    f"partition axis {ax!r} not in mesh axes {mesh_axes}")
        if set(rows) & set(chains):
            raise ValueError(
                f"partition axes must be disjoint; {set(rows) & set(chains)}"
                f" appear in both rows and chains")
        if self.noise not in IN_KERNEL_NOISE:
            raise ValueError(
                f"sharded execution regenerates noise per (chain, node) "
                f"coordinate and needs noise='counter' or 'lfsr', got "
                f"{self.noise!r}")
        if not self.has_slot_layout:
            raise ValueError(
                "sharded execution runs on the Chimera slot layout; use "
                "attach_sparse=True or a sparse-native mismatch")
        sync = self.sync_policy()
        if self.backend not in (None, "auto", "sparse", "fused_sparse"):
            raise ValueError(
                f"sharded Sessions run the slot-layout scan path or, under "
                f"a launch-resident sync policy, the fused per-band "
                f"kernels; backend must be 'sparse', 'fused_sparse', or "
                f"'auto', got {self.backend!r}")
        if self.backend == "fused_sparse":
            if not sync.fused_compatible:
                S = sync.sweeps_per_launch
                raise ValueError(
                    f"backend 'fused_sparse' runs whole launches inside one "
                    f"kernel; the kernel-resident halo exchange supports "
                    f"halo_every <= sweeps_per_launch, but sync={sync} has "
                    f"halo_every={sync.halo_every} with sweeps_per_launch="
                    f"{S} (exchange points {sync.exchange_points()}); "
                    f"nearest legal Sync: lower halo_every to {S} "
                    f"(kernel-resident exchange), raise it to >= {2 * S} "
                    f"or math.inf (launch-boundary exchange only), or use "
                    f"backend='sparse'")
            if self.noise != "counter":
                raise ValueError(
                    f"the fused per-band kernels regenerate noise in the "
                    f"kernel from global (chain, node) coordinates and "
                    f"need noise='counter', got {self.noise!r}; use "
                    f"backend='sparse' for lfsr")
        n_row = 1
        for ax in rows:
            n_row *= self.mesh.shape[ax]
        if n_row > self.graph.rows:
            raise ValueError(
                f"cannot shard {self.graph.rows} cell rows over {n_row} "
                f"devices; grow the lattice or shrink the rows axes")
        n_chain = 1
        for ax in chains:
            n_chain *= self.mesh.shape[ax]
        if self.chains % n_chain:
            raise ValueError(
                f"chains={self.chains} not divisible by the chain-axis "
                f"size {n_chain}")


    def _validate_faults(self) -> None:
        f = self.faults
        if f is None:
            return
        if not isinstance(f, Faults):
            raise ValueError(
                f"faults= must be an api.Faults instance, got "
                f"{type(f).__name__}")
        f.validate_for(self.graph, self.noise)
        if f.needs_host_hooks and self.backend in FUSED_BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} runs whole sweeps inside one "
                f"kernel and cannot apply per-half-sweep fault hooks "
                f"(transient flips, stuck LFSR bits); use a half-sweep "
                f"loop backend ('ref'/'pallas'/'sparse') or backend='auto' "
                f"(which takes the loop under these faults)")


def spec_fingerprint(spec: SamplerSpec) -> str:
    """Compact hex digest of `SamplerSpec.fingerprint()`: the string form
    the serving layer keys its Session cache on and prints in its health
    and metrics output."""
    return hashlib.sha1(repr(spec.fingerprint()).encode()).hexdigest()[:16]


def require_device(device) -> torch.device:
    """The spec's device, or an error when it names a GPU that is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' explicitly to run the plain "
            f"versions on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Construction-time resolution (the ONLY place env vars are consulted)
# ---------------------------------------------------------------------------
def resolve_backend(spec: SamplerSpec) -> str:
    """Spec backend -> concrete backend string, resolved once.

    Explicit names win; ``auto``/``None`` consults REPRO_PBIT_BACKEND and
    then `_auto_backend`.  The returned string is fixed in the Session —
    no env read ever happens at call time.  A sharded spec (``mesh=``)
    resolves by `_resolve_sharded_backend`.
    """
    if spec.mesh is not None:
        return _resolve_sharded_backend(spec)
    b = spec.backend
    if b in (None, "auto"):
        env = os.environ.get("REPRO_PBIT_BACKEND")
        b = env if env else _auto_backend(spec)
    if b not in BACKENDS:
        raise ValueError(f"unknown backend {b!r}; pick from {BACKENDS}")
    if b in FUSED_BACKENDS and spec.noise not in IN_KERNEL_NOISE:
        raise ValueError(
            f"backend {b!r} needs in-kernel noise ('counter' or 'lfsr'), "
            f"got {spec.noise!r}")
    if b in FUSED_BACKENDS and _fault_hooks(spec):
        raise ValueError(
            f"backend {b!r} cannot apply per-half-sweep fault hooks "
            f"(transient flips / stuck LFSR bits); unset "
            f"REPRO_PBIT_BACKEND or pick a half-sweep loop backend")
    if b in ("ref", "pallas", "fused") and spec.sparse_native:
        raise ValueError(
            f"REPRO_PBIT_BACKEND={b!r} cannot run a sparse-native spec "
            f"(no dense W); use 'sparse' or 'fused_sparse'")
    return b


def _resolve_sharded_backend(spec: SamplerSpec) -> str:
    """Backend resolution under a mesh: 'sparse' or 'fused_sparse' only.

    ``auto`` picks 'fused_sparse' for a launch-resident, fused-compatible
    policy with counter noise, else 'sparse' — and 'sparse' too when the
    policy's mid-launch exchanges need K5 and K5 does not run the launch
    (`k5_runs`: on the spec's card, the cluster body up to 16 bands at any
    chain count, else the mailbox body, whose grid must be resident at
    once; across ranks, no exchange point inside a sweep).  Fault hooks
    (flips, stuck LFSR bits) run between half-sweeps, so they keep the
    sharded spec on 'sparse'.  The env default takes part as everywhere
    else, but a value the partition cannot honour raises rather than being
    silently replaced.
    """
    sync = spec.sync_policy()
    fused_ok = (spec.noise == "counter" and sync.fused_compatible
                and not _fault_hooks(spec))
    b = spec.backend
    src = f"backend={b!r}"
    if b in (None, "auto"):
        env = os.environ.get("REPRO_PBIT_BACKEND")
        if env:
            b, src = env, f"REPRO_PBIT_BACKEND={env!r}"
        elif not (fused_ok and sync.launch_resident):
            return "sparse"
        elif sync.kernel_fusible:
            return "fused_sparse"     # K5 where it fits, else K1 per band
        else:
            return ("fused_sparse" if _exchange_fits(spec) else "sparse")
    if b == "sparse":
        return b
    if b == "fused_sparse":
        if not fused_ok:
            S = sync.sweeps_per_launch
            raise ValueError(
                f"{src} names the fused per-band kernels, but this sharded "
                f"spec cannot run them (needs noise='counter', a sync "
                f"policy with halo_every <= sweeps_per_launch or no "
                f"mid-launch exchange, and no fault hooks; got noise="
                f"{spec.noise!r}, sync={sync}, faults={spec.faults}); "
                f"nearest legal Sync: lower halo_every to "
                f"{S}, raise it to >= {2 * S} or math.inf, or use "
                f"backend='sparse'")
        return b
    raise ValueError(
        f"{src} cannot run a mesh-sharded spec: the partitioned engine "
        f"supports 'sparse' (scan over the bands) or 'fused_sparse' "
        f"(launch-resident kernels per band), and the single-device "
        f"backends cannot exchange halos")


def _exchange_fits(spec: SamplerSpec) -> bool:
    """Does K5 run a launch of this sharded spec on its card (a rank mesh:
    one rank's bands and chains; the engine's own rule, `k5_runs`)?"""
    part = spec.partitioning()
    n_row = int(np.prod([spec.mesh.shape[a] for a in part.rows_axes],
                        dtype=np.int64))
    plan = plan_row_partition(spec.graph, n_row)
    bands, chains = n_row, spec.chains
    if getattr(spec.mesh, "ranks", None) is not None:
        r0, r1, c0, c1 = rank_blocks(spec.mesh, part.rows_axes,
                                     part.chain_axes)[0]
        n_chain = int(np.prod([spec.mesh.shape[a] for a in part.chain_axes],
                              dtype=np.int64))
        bands, chains = r1 - r0, spec.chains // n_chain * (c1 - c0)
    return k5_runs(spec.sync_policy(), bands, n_row, chains, plan,
                   card_limits(spec.device))


def _fault_hooks(spec: SamplerSpec) -> bool:
    """Does the fault model need host-side per-half-sweep hooks?"""
    return spec.faults is not None and spec.faults.needs_host_hooks


def _auto_backend(spec: SamplerSpec) -> str:
    """Prefer the slot layout: the sweep-resident kernel when the noise can
    be generated in it, else the half-sweep loop.  A dense-only spec takes
    the dense resident engine when it fits Hopper's limits
    (`dense_resident_feasible`: a chain of the tile in shared memory, and
    W's rows in a cluster's shared memory or W in L2, on the spec's card:
    `card_limits`) and the noise is in-kernel, else "ref".  Fault hooks
    (transient flips, stuck LFSR bits) run between half-sweeps on the host
    side of the loop, so they take the loop backends as the reference
    does; stuck spins alone stay in the kernels (the clamp path)."""
    in_kernel = spec.noise in IN_KERNEL_NOISE and not _fault_hooks(spec)
    if spec.has_slot_layout:
        return "fused_sparse" if in_kernel else "sparse"
    if in_kernel and dense_resident_feasible(
            spec.graph.n_nodes, spec.chains, card_limits(spec.device)):
        return "fused"
    return "ref"
