"""Simulated annealing on the chip (paper Fig. 9a).

On silicon the annealing temperature is a voltage (V_temp) scaling the tanh
gain; here it is the per-sweep beta of an `api.Anneal` schedule run by an
`api.Session`.  The SK-style spin glass uses Gaussian couplings on the
*Chimera edge set* (the chip has no other current paths), quantized to
8-bit DAC codes exactly as the hardware requires.  Counterpart of
``repro.core.annealing``; instances are drawn from a `torch.Generator`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.cd import PBitMachine
from repro_torch.core.chimera import ChimeraGraph
from repro_torch.core.energy import ising_energy
from repro_torch.core.hardware import quantize_codes


@dataclasses.dataclass
class AnnealConfig:
    n_sweeps: int = 1000
    beta_start: float = 0.05
    beta_end: float = 3.0
    schedule: str = "geometric"  # or "linear"
    chains: int = 64

    def to_schedule(self) -> api.Anneal:
        """The declarative `api.Anneal` this config describes."""
        return api.Anneal(n_sweeps=self.n_sweeps,
                          beta_start=self.beta_start,
                          beta_end=self.beta_end, kind=self.schedule)


def beta_schedule(cfg: AnnealConfig) -> np.ndarray:
    """Materialize the schedule (float32, (n_sweeps,))."""
    return cfg.to_schedule().betas()


def sk_instance(graph: ChimeraGraph, gen: torch.Generator | int,
                scale: float = 64.0) -> tuple[np.ndarray, np.ndarray]:
    """Sherrington-Kirkpatrick-style Gaussian couplings on Chimera edges,
    as 8-bit DAC codes (J_codes symmetric, h = 0).  ``gen``: a CPU
    `torch.Generator` or an int seed."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    e = graph.edges
    vals = torch.randn((e.shape[0],), generator=gen,
                       device=gen.device).cpu().numpy() * scale / 2.0
    J = np.zeros((graph.n_nodes, graph.n_nodes), np.float32)
    J[e[:, 0], e[:, 1]] = vals
    J[e[:, 1], e[:, 0]] = vals
    J = np.clip(np.round(J), -128, 127)
    h = np.zeros((graph.n_nodes,), np.float32)
    return J, h


def anneal(
    machine: PBitMachine,
    J_codes: np.ndarray,
    h_codes: np.ndarray,
    cfg: AnnealConfig,
    gen: torch.Generator | int,
    record_every: int = 10,
    session: api.Session | None = None,
) -> dict:
    """Run SA; returns the energy trajectory (measured with the *ideal*
    digital weights — the figure of merit is the true problem energy, while
    dynamics run through the mismatched analog path, as on the real chip).

    Samples with ``collect=True``, so the sweeps run as a half-sweep loop
    (backend "pallas": one dense kernel launch per half-sweep).
    ``session`` lets callers (e.g. `maxcut.solve_maxcut`) supply their own
    `api.Session`; by default one is built from the machine with the
    config's `api.Anneal` schedule.
    """
    if session is None:
        session = machine.session(schedule=cfg.to_schedule(),
                                  chains=cfg.chains)
    else:
        # a mismatched schedule would silently truncate the trajectory
        if session.spec.chains != cfg.chains:
            raise ValueError(
                f"session runs {session.spec.chains} chains but "
                f"cfg.chains={cfg.chains}")
        if session.default_betas is None or \
                session.default_betas.shape[0] != cfg.n_sweeps:
            have = (None if session.default_betas is None
                    else session.default_betas.shape[0])
            raise ValueError(
                f"session schedule has {have} sweeps but "
                f"cfg.n_sweeps={cfg.n_sweeps}; build it with "
                f"schedule=cfg.to_schedule()")
    if not isinstance(gen, torch.Generator):
        gen = session.generator(gen)
    chip = session.program(quantize_codes(torch.as_tensor(J_codes)),
                           quantize_codes(torch.as_tensor(h_codes)))
    m0 = session.random_spins(gen)
    noise_state = session.noise_state(gen)

    _, _, traj = session.sample(chip, m0, noise_state, collect=True)
    Jf = torch.as_tensor(np.asarray(J_codes, np.float32), device=traj.device)
    hf = torch.as_tensor(np.asarray(h_codes, np.float32), device=traj.device)
    sel = np.arange(0, cfg.n_sweeps, record_every)
    e = ising_energy(traj[torch.as_tensor(sel, device=traj.device)], Jf,
                     hf).cpu().numpy()  # (len(sel), chains)
    final_e = ising_energy(traj[-1], Jf, hf).cpu().numpy()
    return {
        "sweeps": sel,
        "energy_mean": e.mean(axis=1),
        "energy_min": e.min(axis=1),
        "best_energy": float(final_e.min()),
        "best_state": traj[-1][int(final_e.argmin())].cpu().numpy(),
    }
