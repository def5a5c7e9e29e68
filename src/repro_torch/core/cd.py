"""In-situ hardware-aware learning: contrastive divergence through the chip.

Paper Fig. 7a: the training loop alternates
  positive phase  — clamp the visible nodes to data, Gibbs-sample the hidden
                    nodes *on the (mismatched) chip*, measure <m_i m_j>+.
  negative phase  — release the clamp, free-run the chip k sweeps, measure
                    <m_i m_j>-.
  update          — J_ij += lr (<mimj>+ - <mimj>-) on the physical couplers,
                    h_i  += lr (<mi>+   - <mi>-),
then re-program the 8-bit weight DACs.  Both phases are sampled through the
same analog non-idealities, so the learned weights absorb the mismatch.
Master couplings live on the edge list (one float per physical coupler)
and are quantized to 8-bit DAC codes on every re-program.

`PBitMachine` owns the chip description (graph + mismatch + noise/backend
choices) and hands out `api.Session`s; all sampling and programming goes
through them.  Counterpart of ``repro.core.cd`` (crash-safe training
comes with the faults slice).
Random draws come from `torch.Generator`s and agree with the reference's
in distribution only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import api
from repro_torch.api.program import stack_fleet
from repro_torch.core import energy as energy_mod
from repro_torch.core.chimera import ChimeraGraph
from repro_torch.core.hardware import (
    EffectiveChip,
    HardwareConfig,
    Mismatch,
    SparseMismatch,
    sample_mismatch,
    sample_mismatch_sparse,
)


@dataclasses.dataclass
class PBitMachine:
    """A (simulated) chip instance: graph + mismatch + programmable weights.

    With a dense `Mismatch` the machine programs the full analog model and
    attaches the Chimera-native slot view (a gather — bit-identical
    entries).  With a `SparseMismatch` (create(..., sparse=True)) nothing
    O(n²) is ever built, so it instantiates at lattice sizes where the
    dense model cannot.

    The machine is sugar over `api.SamplerSpec`/`api.Session`:
    ``sampler_spec()`` builds the declarative spec, ``session()`` builds
    (and caches) sessions per (schedule, chains).
    """

    graph: ChimeraGraph
    hw: HardwareConfig
    mismatch: Mismatch | SparseMismatch
    beta: float = 1.0
    noise: str = "philox"   # "philox" | "counter" | "lfsr"
    backend: str = "auto"   # auto | ref | pallas | fused | sparse | fused_sparse
    w_scale: float = 0.05   # weight-LSB -> coupling units (ext. resistor knob)
    device: str | torch.device = "cuda"
    mesh: object = None     # core.distributed.Mesh -> row-band sharded sessions
    partition: object = None  # api.Partition; None -> rows over "data"
    sync: object = None     # api.Sync; None -> bit-exact barrier policy

    @staticmethod
    def create(graph: ChimeraGraph, gen: torch.Generator | int,
               hw: HardwareConfig | None = None, sparse: bool = False,
               device="cuda", **kw) -> "PBitMachine":
        """Draw one chip instance on ``device``.  ``gen`` is a
        `torch.Generator` on that device, or an int seed for a new one."""
        dev = api.spec.require_device(device)
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        hw = hw or HardwareConfig()
        if sparse:
            nbr_idx, _ = graph.neighbor_table()
            mism = sample_mismatch_sparse(gen, graph.n_nodes,
                                          nbr_idx.shape[0], hw, device=dev)
        else:
            mism = sample_mismatch(gen, graph.n_nodes, hw, device=dev)
        return PBitMachine(graph=graph, hw=hw, mismatch=mism, device=dev,
                           **kw)

    @property
    def sparse_native(self) -> bool:
        """True when only the O(D·n) slot model exists (no dense W ever)."""
        return isinstance(self.mismatch, SparseMismatch)

    def to_sparse(self) -> "PBitMachine":
        """Sparse-native twin reproducing THIS chip instance exactly: the
        dense mismatch is gathered into the O(D·n) slot layout, so
        programming the same codes on both machines yields the same
        effective couplings and the same spin trajectories."""
        if self.sparse_native:
            return self
        nbr_idx, _, _, _ = self.neighbor_tables()
        backend = {"ref": "sparse", "pallas": "sparse",
                   "fused": "fused_sparse"}.get(self.backend, self.backend)
        return dataclasses.replace(
            self, mismatch=SparseMismatch.from_dense(self.mismatch, nbr_idx),
            backend=backend)

    def neighbor_tables(self):
        """(nbr_idx, nbr_mask, slot_ij, slot_ji), cached per machine."""
        nt = getattr(self, "_nbr_tables", None)
        if nt is None:
            nbr_idx, nbr_mask = self.graph.neighbor_table()
            slot_ij, slot_ji = self.graph.edge_slots(nbr_idx)
            nt = (nbr_idx, nbr_mask, slot_ij, slot_ji)
            self._nbr_tables = nt
        return nt

    # -- the api seam ----------------------------------------------------
    def sampler_spec(self, schedule: api.Schedule | None = None,
                     chains: int = 256, **kw) -> api.SamplerSpec:
        """The declarative `api.SamplerSpec` for this chip instance
        (the machine's mesh / partition / sync unless ``kw`` names
        them)."""
        kw.setdefault("device", self.device)
        kw.setdefault("mesh", self.mesh)
        kw.setdefault("partition", self.partition)
        kw.setdefault("sync", self.sync)
        return api.SamplerSpec(
            graph=self.graph, hw=self.hw, mismatch=self.mismatch,
            noise=self.noise, backend=self.backend, schedule=schedule,
            chains=chains, beta=self.beta, w_scale=self.w_scale, **kw)

    def session(self, schedule: api.Schedule | None = None,
                chains: int = 256) -> api.Session:
        """`api.Session`, cached per (schedule, chains)."""
        cache = getattr(self, "_sessions", None)
        if cache is None:
            cache = {}
            self._sessions = cache
        key = (schedule, chains)
        ses = cache.get(key)
        if ses is None:
            ses = api.Session(self.sampler_spec(schedule, chains))
            cache[key] = ses
        return ses

    # -- programming (spec-level: needs no backend/noise resolution) -----
    def program(self, J_codes, h_codes, enable=None) -> EffectiveChip:
        """Program dense (n, n) symmetric codes (chip-scale convenience)."""
        return api.program(self.sampler_spec(), J_codes, h_codes, enable,
                           tables=self.neighbor_tables())

    def program_edges(self, J_edge_codes, h_codes) -> EffectiveChip:
        """Program per-edge codes (E,) — the CD master-weight layout."""
        return api.program_edges(self.sampler_spec(), J_edge_codes, h_codes,
                                 tables=self.neighbor_tables())

    def program_master(self, Jm, hm) -> EffectiveChip:
        """Quantize float master weights — edge-list (E,) or dense (n, n) —
        to 8-bit DAC codes and program."""
        return api.program_master(self.sampler_spec(), Jm, hm,
                                  tables=self.neighbor_tables())

    def fleet_mismatch(self, gen: torch.Generator | int, n_chips: int):
        """Draw a stacked (K, ...) fleet of chip-instance mismatches.

        Every field gains a leading ``n_chips`` axis; the result feeds the
        fleet axis (`make_cd_fleet_step`, `api.Session.make_cd_fleet_step`,
        `api.Session.make_program(mismatch=api.fleet_member(draws, k))`).
        Draw k is the k-th of ``n_chips`` consecutive draws from ``gen`` (a
        `torch.Generator` on the machine's device, or an int seed for a new
        one), of this machine's type: dense, or sparse-native.  The draws
        agree with the reference's ``split(key)`` draws in distribution
        only.
        """
        dev = torch.device(self.device)
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        if self.sparse_native:
            nbr_idx, _ = self.graph.neighbor_table()
            draws = [sample_mismatch_sparse(gen, self.graph.n_nodes,
                                            nbr_idx.shape[0], self.hw,
                                            device=dev)
                     for _ in range(n_chips)]
        else:
            draws = [sample_mismatch(gen, self.graph.n_nodes, self.hw,
                                     device=dev)
                     for _ in range(n_chips)]
        return stack_fleet(draws)


@dataclasses.dataclass
class CDConfig:
    lr: float = 4.0            # in DAC-LSB units per unit correlation error
    cd_k: int = 10             # sweeps per negative phase
    pos_sweeps: int = 10       # sweeps with visibles clamped
    burn_in: int = 2
    chains: int = 256          # parallel Gibbs chains (chip reprogram batches)
    epochs: int = 60
    h_lr_scale: float = 1.0
    weight_decay: float = 0.0
    persistent: bool = False   # PCD: negative chains persist across epochs
    momentum: float = 0.0      # heavy-ball on the correlation gradient


def make_cd_step(machine: PBitMachine, cfg: CDConfig,
                 visible_idx: np.ndarray):
    """The one-epoch CD update (shim over `Session.make_cd_step`):
    step(Jm, hm, data_vis, m, noise_state, vel) ->
    (Jm, hm, m, noise_state, vel, metrics), Jm the (n_edges,) float master
    couplings, hm the (n,) master biases, data_vis (chains, n_visible) ±1
    data for the positive phase."""
    return machine.session(chains=cfg.chains).make_cd_step(cfg, visible_idx)


def make_cd_fleet_step(machine: PBitMachine, cfg: CDConfig,
                       visible_idx: np.ndarray):
    """The K-replica CD step (shim over `Session.make_cd_fleet_step`):
    K virtual chip instances — K mismatch draws of the machine's SKU,
    stacked by `PBitMachine.fleet_mismatch` — each with its own master
    weights, chains and noise stream but a shared data batch:

        step(mismatches, Jm[K,E], hm[K,N], data_vis, m[K,B,N],
             noise_state[K,...], vel) -> the same, stacked
    """
    return machine.session(chains=cfg.chains).make_cd_fleet_step(
        cfg, visible_idx)


def sample_visible_dist(machine: PBitMachine, Jm, hm,
                        visible_idx: np.ndarray, gen: torch.Generator | int,
                        chains: int = 256, sweeps: int = 200,
                        burn_in: int = 20) -> np.ndarray:
    """Free-run the programmed chip and histogram the visible marginal.

    Jm may be edge-list (E,) or dense (n, n) float master weights.  The
    histogram streams (`Session.visible_hist`): the (sweeps, chains, N)
    trajectory never materializes.
    """
    session = machine.session(
        schedule=api.Constant(beta=machine.beta, n_sweeps=sweeps),
        chains=chains)
    if not isinstance(gen, torch.Generator):
        gen = session.generator(gen)
    chip = session.program_master(Jm, hm)
    m0 = session.random_spins(gen)
    noise_state = session.noise_state(gen)
    counts, _, _ = session.visible_hist(chip, m0, noise_state, visible_idx,
                                        burn_in)
    counts = counts.detach().cpu().numpy().astype(np.float64)
    return counts / max(counts.sum(), 1.0)


@dataclasses.dataclass
class CDResult:
    """Learned master weights.  ``J_edges`` is the native (E,) edge-list
    form; ``Jm`` reconstructs the symmetric dense matrix for small-n
    reporting and eval."""

    J_edges: np.ndarray
    hm: np.ndarray
    kl_history: list
    metric_history: list
    edges: np.ndarray
    n_nodes: int

    @property
    def Jm(self) -> np.ndarray:
        J = np.zeros((self.n_nodes, self.n_nodes), np.float32)
        J[self.edges[:, 0], self.edges[:, 1]] = self.J_edges
        J[self.edges[:, 1], self.edges[:, 0]] = self.J_edges
        return J


def train_cd(
    machine: PBitMachine,
    visible_idx: np.ndarray,
    target_dist: np.ndarray,
    cfg: CDConfig,
    gen: torch.Generator | int,
    eval_every: int = 10,
    verbose: bool = False,
) -> CDResult:
    """Full in-situ CD training loop against a target visible distribution.

    ``gen`` is a `torch.Generator` on the machine's device (or an int seed
    for a new one); the initial spins and noise state, each epoch's data
    rows (drawn from ``target_dist``) and each evaluation's sampler state
    come from it in that order, so two machines that differ only in
    backend consume identical draws.
    """
    g = machine.graph
    n, nv = g.n_nodes, len(visible_idx)
    session = machine.session(chains=cfg.chains)
    step = session.make_cd_step(cfg, visible_idx)
    dev = session.device
    if not isinstance(gen, torch.Generator):
        gen = session.generator(gen)

    Jm = torch.zeros((g.n_edges,), dtype=torch.float32, device=dev)
    hm = torch.zeros((n,), dtype=torch.float32, device=dev)
    m = session.random_spins(gen)
    noise_state = session.noise_state(gen)

    # visible configs in code order, for drawing data rows from the target
    codes = torch.as_tensor(energy_mod.all_states(nv), dtype=torch.float32,
                            device=dev)
    target = torch.as_tensor(np.asarray(target_dist), dtype=torch.float64,
                             device=dev)
    vel = (torch.zeros((g.n_edges,), dtype=torch.float32, device=dev),
           torch.zeros((n,), dtype=torch.float32, device=dev))
    kl_hist, met_hist = [], []
    for epoch in range(cfg.epochs):
        idx = torch.multinomial(target, cfg.chains, replacement=True,
                                generator=gen)
        Jm, hm, m, noise_state, vel, metrics = step(Jm, hm, codes[idx], m,
                                                    noise_state, vel)
        met_hist.append({k: float(v) for k, v in metrics.items()})
        if (epoch + 1) % eval_every == 0 or epoch == cfg.epochs - 1:
            emp = sample_visible_dist(machine, Jm, hm, visible_idx, gen)
            kl = energy_mod.kl_divergence(np.asarray(target_dist), emp)
            kl_hist.append((epoch + 1, kl))
            if verbose:
                print(f"epoch {epoch+1:4d}  KL={kl:.4f}  "
                      f"corr_err={met_hist[-1]['corr_err']:.4f}")
    return CDResult(Jm.cpu().numpy(), hm.cpu().numpy(), kl_hist, met_hist,
                    edges=np.asarray(g.edges), n_nodes=n)
