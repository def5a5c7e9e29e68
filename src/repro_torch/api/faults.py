"""First-class fault injection: discrete failure modes as a spec field.

The analog `Mismatch` model covers *smooth* imperfection (Gaussian process
variation); a real chip also fails *discretely*: a p-bit whose comparator
latched, a coupler bond wire that opened, a weight DAC stuck at full
scale, an RNG register bit welded to the rail.  `Faults` is the frozen,
hashable value object that names one such fault realization; it rides on
`api.SamplerSpec`, and `api.Session` compiles it into every backend:

  * **stuck-at-spin** — node ``i`` reads ±1 forever.  Compiled into the
    clamp path every backend already honours (update-mask exclusion +
    value pinning), so it runs through the half-sweep loops, the CUDA
    engines K1-K5 and the sharded halo exchange unchanged.  Noise is still
    drawn for stuck nodes (the full (B, N) stream is consumed per
    half-sweep regardless of masks), which keeps every backend bit-exact
    against the others under the same fault draw.
  * **dead coupler** — edge ``e`` is an open circuit: zero current in both
    directions (not even the disabled-coupler leakage).  Applied after
    programming, on both the dense W and the slot-layout nbr_w view.
  * **saturated coupler** — the edge's weight DAC is stuck at full scale:
    the programmed code is replaced by ±127 (sign of the requested code;
    + for zero) before the DAC transfer.  Dead and saturated couplers are
    both excluded from CD's (E,) gradient — their DACs cannot be
    reprogrammed, so accumulating gradient there only corrupts momentum.
  * **stuck LFSR bits** — register bits of specific per-cell LFSRs forced
    to 0/1 after every decimated clock (degraded RNG).  Needs
    ``noise='lfsr'`` and a half-sweep loop backend (the fused kernels step
    the LFSR in the kernel and cannot apply the mask).
  * **transient flips** — a seeded Bernoulli(``flip_prob``) draw flips
    each just-updated spin once per half-sweep (applied after it), from a
    salted stream independent of the sampling noise.  Half-sweep loop
    backends only; under a mesh the draw is addressed by *global* (chain,
    node) coordinates, so the sharded engine reproduces the single-device
    flip pattern exactly under the barrier policy.

Everything here is static host data (tuples of Python ints), so a
`Faults` instance hashes and compares by value.  Counterpart of
``repro.api.faults``: `sample_faults` makes the same numpy draws in the
same order, so a (seed, graph, rates) names the same `Faults` in both
packages, tuple for tuple.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FLIP_SALT = 0xA5A5A5A5   # XOR'd into the counter seed for the flip stream
FLIP_FOLD = 0x0F11B0B5   # XOR'd into flip_seed: the philox flip generator's seed


@dataclasses.dataclass(frozen=True)
class Faults:
    """One discrete fault realization of a virtual chip (all-static)."""

    stuck_nodes: tuple = ()        # node ids with a stuck-at-spin fault
    stuck_values: tuple = ()       # ±1 per stuck node (same length)
    dead_edges: tuple = ()         # edge-list indices: open circuit
    saturated_edges: tuple = ()    # edge-list indices: DAC stuck full-scale
    lfsr_stuck: tuple = ()         # ((cell, stuck0_mask, stuck1_mask), ...)
    flip_prob: float = 0.0         # transient flip probability per sweep
    flip_seed: int = 0             # salts the independent flip stream

    def __post_init__(self):
        if len(self.stuck_nodes) != len(self.stuck_values):
            raise ValueError(
                f"stuck_nodes ({len(self.stuck_nodes)}) and stuck_values "
                f"({len(self.stuck_values)}) must pair up one to one")
        for v in self.stuck_values:
            if v not in (-1, 1, -1.0, 1.0):
                raise ValueError(
                    f"stuck_values must be ±1 (a latched p-bit), got {v!r}")
        if len(set(self.stuck_nodes)) != len(self.stuck_nodes):
            raise ValueError("stuck_nodes contains duplicates")
        overlap = set(self.dead_edges) & set(self.saturated_edges)
        if overlap:
            raise ValueError(
                f"edges {sorted(overlap)} appear in both dead_edges and "
                f"saturated_edges; a coupler is open OR stuck, not both")
        if not (0.0 <= self.flip_prob < 1.0):
            raise ValueError(
                f"flip_prob must be in [0, 1), got {self.flip_prob}")
        for entry in self.lfsr_stuck:
            if len(entry) != 3:
                raise ValueError(
                    f"lfsr_stuck entries are (cell, stuck0, stuck1) "
                    f"triples, got {entry!r}")
            _, s0, s1 = entry
            if s0 & s1:
                raise ValueError(
                    f"lfsr_stuck masks overlap (bit stuck at 0 AND 1): "
                    f"{entry!r}")

    # -- derived ---------------------------------------------------------
    @property
    def any(self) -> bool:
        return bool(self.stuck_nodes or self.dead_edges
                    or self.saturated_edges or self.lfsr_stuck
                    or self.flip_prob > 0.0)

    @property
    def faulty_edges(self) -> tuple:
        """Edges excluded from the CD gradient (unreprogrammable DACs)."""
        return tuple(self.dead_edges) + tuple(self.saturated_edges)

    @property
    def needs_host_hooks(self) -> bool:
        """True when the fault model needs per-half-sweep host-side hooks
        (transient flips, stuck LFSR bits) the fused in-kernel engines
        cannot run — the spec then resolves to a half-sweep loop backend."""
        return self.flip_prob > 0.0 or bool(self.lfsr_stuck)

    def validate_for(self, graph, noise: str) -> None:
        """Graph/noise-dependent checks (spec.validate calls this)."""
        n, e = graph.n_nodes, graph.n_edges
        for i in self.stuck_nodes:
            if not 0 <= int(i) < n:
                raise ValueError(
                    f"stuck node {i} out of range for {n} nodes")
        for q in self.faulty_edges:
            if not 0 <= int(q) < e:
                raise ValueError(
                    f"faulty edge {q} out of range for {e} edges")
        if self.lfsr_stuck and noise != "lfsr":
            raise ValueError(
                f"lfsr_stuck models stuck register bits of the per-cell "
                f"LFSRs and needs noise='lfsr', got {noise!r}")
        if self.flip_prob > 0.0 and noise == "lfsr":
            raise ValueError(
                "transient flips draw from a salted counter/philox stream "
                "independent of the sampling noise; noise='lfsr' has no "
                "such stream — use noise='counter' or 'philox'")


def sample_faults(
    seed: int,
    graph,
    *,
    stuck_rate: float = 0.0,
    dead_rate: float = 0.0,
    saturated_rate: float = 0.0,
    flip_prob: float = 0.0,
    exclude_nodes=(),
) -> Faults:
    """Draw one random fault realization at the given rates.

    ``stuck_rate`` is the per-node stuck-at probability (value ±1 uniform),
    ``dead_rate``/``saturated_rate`` the per-edge probabilities (an edge
    drawn for both comes out dead).  ``exclude_nodes`` keeps named nodes
    fault-free — yield benchmarks exclude the task's visible nodes, since
    a chip whose *visible* p-bit is latched cannot represent the target
    distribution at all (that is a dead chip, not a mitigation question).
    Deterministic in ``seed``: the same (seed, graph, rates) always names
    the same virtual chip.
    """
    rng = np.random.default_rng(seed)
    excl = set(int(i) for i in np.asarray(exclude_nodes).reshape(-1))
    nodes = [i for i in range(graph.n_nodes) if i not in excl]
    stuck = [i for i in nodes if rng.random() < stuck_rate]
    values = [int(rng.choice((-1, 1))) for _ in stuck]
    dead, sat = [], []
    for q in range(graph.n_edges):
        is_dead = rng.random() < dead_rate
        is_sat = rng.random() < saturated_rate
        if is_dead:
            dead.append(q)
        elif is_sat:
            sat.append(q)
    return Faults(
        stuck_nodes=tuple(stuck), stuck_values=tuple(values),
        dead_edges=tuple(dead), saturated_edges=tuple(sat),
        flip_prob=float(flip_prob), flip_seed=int(seed) & 0xFFFFFFFF)


# -- the fault hooks' draws, shared by `api.Session` and the row-band engine


def lfsr_stuck_masks(faults: Faults, n_cells: int):
    """(stuck0, stuck1): int64 (n_cells,) masks of the register bits each
    per-cell LFSR has stuck at 0 and at 1 (`Faults.lfsr_stuck`)."""
    s0 = np.zeros((n_cells,), np.int64)
    s1 = np.zeros((n_cells,), np.int64)
    for cell, m0, m1 in faults.lfsr_stuck:
        if not 0 <= int(cell) < n_cells:
            raise ValueError(
                f"lfsr_stuck cell {cell} out of range for {n_cells} unit "
                f"cells")
        s0[int(cell)] |= int(m0) & 0xFFFFFFFF
        s1[int(cell)] |= int(m1) & 0xFFFFFFFF
    return s0, s1


def counter_flip_fn(faults: Faults, rows, cols):
    """The transient-flip draw under counter noise: flip(state) -> bool
    tensor, Bernoulli(``flip_prob``) at each (row, col) — global chain and
    node ids, as integer tensors that broadcast — from the counter hash of
    the pre-half-sweep (seed ^ FLIP_SALT ^ flip_seed, counter): bit-exact
    with the reference's draw, and band by band with the unsharded one."""
    from repro_torch.core import lfsr as lfsr_mod

    thresh = round(float(faults.flip_prob) * 65536.0)
    salt = (int(faults.flip_seed) ^ FLIP_SALT) & 0xFFFFFFFF

    def flip(state):
        bits = lfsr_mod.counter_bits(lfsr_mod.to_u64(state[0]) ^ salt,
                                     state[1], rows, cols)
        return ((bits >> 16) & 0xFFFF) < thresh

    return flip
