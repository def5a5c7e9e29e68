"""Ising energies and exact Boltzmann references (for validation).

Convention (standard p-bit / Boltzmann machine):
    E(m) = -1/2 sum_ij J_ij m_i m_j - sum_i h_i m_i,   P(m) ∝ exp(-beta E(m))
with symmetric J, zero diagonal.  Counterpart of ``repro.core.energy``.
"""
from __future__ import annotations

import numpy as np
import torch


def ising_energy(m: torch.Tensor, J: torch.Tensor, h: torch.Tensor
                 ) -> torch.Tensor:
    """E for batched spins m: (..., N). J symmetric (N, N), h (N,)."""
    quad = -0.5 * torch.einsum("...i,ij,...j->...", m, J, m)
    return quad - m @ h


def all_states(n: int) -> np.ndarray:
    """(2^n, n) array of all ±1 configurations (n <= 22)."""
    if n > 22:
        raise ValueError("exact enumeration capped at 22 spins")
    bits = ((np.arange(2 ** n)[:, None] >> np.arange(n)[None, :]) & 1)
    return (2.0 * bits - 1.0).astype(np.float32)


def exact_boltzmann(J: np.ndarray, h: np.ndarray, beta: float) -> np.ndarray:
    """Exact P(m) over all 2^N states."""
    s = all_states(J.shape[0])
    e = ising_energy(torch.from_numpy(s),
                     torch.as_tensor(np.asarray(J, np.float32)),
                     torch.as_tensor(np.asarray(h, np.float32))).numpy()
    logp = -beta * e
    logp -= logp.max()
    p = np.exp(logp)
    return p / p.sum()


def _visible_codes(vis: np.ndarray) -> np.ndarray:
    """Bit k of the code is visible node k > 0."""
    nv = vis.shape[1]
    return ((vis > 0).astype(np.int64) * (2 ** np.arange(nv))[None, :]
            ).sum(axis=1)


def exact_visible_marginal(J: np.ndarray, h: np.ndarray, beta: float,
                           visible_idx: np.ndarray) -> np.ndarray:
    """Exact marginal over visible spins, shape (2^len(visible),)."""
    p = exact_boltzmann(J, h, beta)
    s = all_states(J.shape[0])
    out = np.zeros(2 ** len(visible_idx))
    np.add.at(out, _visible_codes(s[:, visible_idx]), p)
    return out


def empirical_visible_dist(samples: np.ndarray, visible_idx: np.ndarray,
                           n_visible: int | None = None) -> np.ndarray:
    """Histogram of visible configurations from (S, N) ±1 samples."""
    samples = np.asarray(samples)
    out = np.zeros(2 ** len(visible_idx))
    np.add.at(out, _visible_codes(samples[:, visible_idx]), 1.0)
    return out / max(len(samples), 1)


def kl_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-9) -> float:
    """KL(p || q) with epsilon smoothing of q."""
    q = (q + eps) / (q + eps).sum()
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))
