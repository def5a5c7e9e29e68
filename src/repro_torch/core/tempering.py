"""Parallel tempering (replica exchange) on the p-bit chip.

R replicas run at a beta ladder in one batched chromatic sweep (the chains
dimension); every ``swap_every`` sweeps neighbouring temperature slots
Metropolis-swap.  The ladder is an `api.Tempered` schedule; each swap round
passes the slot-permuted (swap_every, R) beta matrix to `Session.sample`,
so with a fused backend a round is one resident-sweep kernel launch.  The
swap decision is made on the host between rounds.  Counterpart of
``repro.core.tempering``; swap draws come from a `torch.Generator`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.cd import PBitMachine
from repro_torch.core.energy import ising_energy
from repro_torch.core.hardware import quantize_codes


@dataclasses.dataclass
class PTConfig:
    n_replicas: int = 16
    beta_min: float = 0.05
    beta_max: float = 3.0
    n_sweeps: int = 1000
    swap_every: int = 10

    def to_schedule(self) -> api.Tempered:
        """The declarative per-replica ladder (one swap round per run)."""
        return api.Tempered.geometric(self.beta_min, self.beta_max,
                                      self.n_replicas,
                                      n_sweeps=self.swap_every)


def beta_ladder(cfg: PTConfig) -> np.ndarray:
    """The ladder, float32 (n_replicas,)."""
    return np.asarray(cfg.to_schedule().ladder, np.float32)


def parallel_tempering(
    machine: PBitMachine,
    J_codes: np.ndarray,
    h_codes: np.ndarray,
    cfg: PTConfig,
    gen: torch.Generator | int,
) -> dict:
    """Returns best energy/state + replica-exchange statistics."""
    R = cfg.n_replicas
    session = machine.session(schedule=cfg.to_schedule(), chains=R)
    if not isinstance(gen, torch.Generator):
        gen = session.generator(gen)
    dev = session.device
    chip = session.program(quantize_codes(torch.as_tensor(J_codes)),
                           quantize_codes(torch.as_tensor(h_codes)))
    Jf = torch.as_tensor(np.asarray(J_codes, np.float32), device=dev)
    hf = torch.as_tensor(np.asarray(h_codes, np.float32), device=dev)

    m = session.random_spins(gen)
    ns = session.noise_state(gen)
    betas = torch.as_tensor(beta_ladder(cfg), device=dev)
    n_rounds = cfg.n_sweeps // cfg.swap_every
    order = torch.arange(R, device=dev)        # slot -> replica id
    i = torch.arange(R - 1, device=dev)
    e_min_hist, n_swaps = [], []
    for _ in range(n_rounds):
        slot_of = torch.argsort(order)         # replica id -> slot
        beta_rows = betas[slot_of].expand(cfg.swap_every, R).contiguous()
        m, ns, _ = session.sample(chip, m, ns, beta_rows)
        e = ising_energy(m, Jf, hf)                      # (R,)
        # Metropolis swap of adjacent temperature slots: even pairs one
        # round, odd pairs another, chosen by a fair coin
        start = int(torch.randint(0, 2, (1,), generator=gen, device=dev))
        e_slot = e[order]
        # detailed balance: accept with prob min(1, exp((b_j-b_i)(E_i-E_j)))
        delta = (betas[i + 1] - betas[i]) * (e_slot[i] - e_slot[i + 1])
        u = torch.rand((R - 1,), generator=gen, device=dev)
        accept = (torch.log(u) < delta) & ((i % 2) == start)
        lo = torch.where(accept, order[i + 1], order[i])
        hi = torch.where(accept, order[i], order[i + 1])
        new = order.clone()
        active = (i % 2) == start
        new[i[active]] = lo[active]
        new[i[active] + 1] = hi[active]
        order = new
        e_min_hist.append(float(e.min()))
        n_swaps.append(int(accept.sum()))
    e_fin = ising_energy(m, Jf, hf)
    best = int(torch.argmin(e_fin))
    return {
        "best_energy": float(e_fin[best]),
        "best_state": m[best].cpu().numpy(),
        "e_min_per_round": np.asarray(e_min_hist),
        "swap_rate": float(np.sum(n_swaps)) / max(n_rounds * (R // 2), 1),
        "final_order": order.cpu().numpy(),
    }
