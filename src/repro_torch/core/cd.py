"""The chip instance behind the sampling front door.

`PBitMachine` owns the chip description (graph + mismatch + noise/backend
choices) and hands out `api.Session`s; `sample_visible_dist` free-runs a
programmed chip and histograms its visible marginal.  Counterpart of the
sampling half of ``repro.core.cd`` — contrastive-divergence training
(`CDConfig`, `make_cd_step`, `train_cd`) is the next slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import api
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
    backend: str = "auto"   # auto | sparse | fused_sparse (dense: not ported)
    w_scale: float = 0.05   # weight-LSB -> coupling units (ext. resistor knob)
    device: str | torch.device = "cuda"

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
        """The declarative `api.SamplerSpec` for this chip instance."""
        kw.setdefault("device", self.device)
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
