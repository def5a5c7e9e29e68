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
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.chimera import ChimeraGraph
from repro_torch.core.hardware import HardwareConfig, Mismatch, SparseMismatch
from repro_torch.kernels.sweep_fused import card_limits, dense_resident_feasible

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
        them must key on ``hw`` separately.  ``REPRO_PBIT_BACKEND`` is read
        as `Session` construction reads it.  Single device: the port has
        no partition or mesh term yet.
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
        sched_sig = None
        if self.schedule is not None:
            sched_sig = (type(self.schedule).__name__,
                         tuple(sorted(dataclasses.asdict(
                             self.schedule).items())))
        return (graph_sig, mm_sig, self.noise, resolve_backend(self),
                torch.device(self.device).type, int(self.chains),
                float(self.beta), float(self.w_scale), int(self.decimation),
                bool(self.attach_sparse), sched_sig)

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
        return self


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
    no env read ever happens at call time.
    """
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
    if b in ("ref", "pallas", "fused") and spec.sparse_native:
        raise ValueError(
            f"REPRO_PBIT_BACKEND={b!r} cannot run a sparse-native spec "
            f"(no dense W); use 'sparse' or 'fused_sparse'")
    return b


def _auto_backend(spec: SamplerSpec) -> str:
    """Prefer the slot layout: the sweep-resident kernel when the noise can
    be generated in it, else the half-sweep loop.  A dense-only spec takes
    the dense resident engine when it fits Hopper's limits
    (`dense_resident_feasible`: W in L2, the tile's spins in shared memory,
    the Gram partials bounded, on the spec's card: `card_limits`) and the
    noise is in-kernel, else "ref"."""
    in_kernel = spec.noise in IN_KERNEL_NOISE
    if spec.has_slot_layout:
        return "fused_sparse" if in_kernel else "sparse"
    if in_kernel and dense_resident_feasible(
            spec.graph.n_nodes, spec.chains, card_limits(spec.device)):
        return "fused"
    return "ref"
