"""Max-Cut on the chip (paper Fig. 9b).

Max-Cut maximizes cut(m) = sum_{(i,j) in E} (1 - m_i m_j)/2.  With the
energy convention E(m) = -1/2 sum J_ij m_i m_j, setting J_ij = -w_ij for
each problem edge makes minimizing E equivalent to maximizing the cut.
Problems must be subgraphs of the Chimera coupler set (the chip has no other
wires); `random_chimera_maxcut` samples chip-native instances.  Counterpart
of ``repro.core.maxcut``; instances are drawn from a `torch.Generator`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.annealing import AnnealConfig, anneal
from repro_torch.core.cd import PBitMachine
from repro_torch.core.chimera import ChimeraGraph


@dataclasses.dataclass(frozen=True)
class MaxCutProblem:
    edges: np.ndarray    # (E, 2) node ids (subset of chimera edges)
    weights: np.ndarray  # (E,) positive weights, float32

    def __post_init__(self):
        # float32 throughout, like the chip's weights; the paper's
        # instances use small integer weights, exact in float32
        object.__setattr__(self, "edges",
                           np.asarray(self.edges, np.int32))
        object.__setattr__(self, "weights",
                           np.asarray(self.weights, np.float32))

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    def cut_value(self, m: np.ndarray) -> float:
        mi = m[self.edges[:, 0]]
        mj = m[self.edges[:, 1]]
        return float(np.sum(self.weights * (1.0 - mi * mj) / 2.0))


def random_chimera_maxcut(graph: ChimeraGraph, gen: torch.Generator | int,
                          edge_prob: float = 0.7,
                          weighted: bool = False) -> MaxCutProblem:
    """A chip-native instance: each coupler kept with ``edge_prob``, weights
    1 or (``weighted``) uniform in {1, 2, 3}.  ``gen``: a CPU
    `torch.Generator` or an int seed."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    keep = (torch.rand((graph.n_edges,), generator=gen, device=gen.device)
            < edge_prob).cpu().numpy()
    edges = graph.edges[keep]
    if weighted:
        w = torch.randint(1, 4, (edges.shape[0],), generator=gen,
                          device=gen.device).cpu().numpy()
    else:
        w = np.ones((edges.shape[0],))
    return MaxCutProblem(edges=edges, weights=w.astype(np.float32))


def maxcut_codes(problem: MaxCutProblem, n_nodes: int,
                 scale: float = 42.0) -> tuple[np.ndarray, np.ndarray]:
    """Problem -> 8-bit antiferromagnetic coupling codes."""
    J = np.zeros((n_nodes, n_nodes), np.float32)
    w = -problem.weights * scale / max(problem.weights.max(), 1.0)
    J[problem.edges[:, 0], problem.edges[:, 1]] = w
    J[problem.edges[:, 1], problem.edges[:, 0]] = w
    return np.clip(np.round(J), -128, 127), np.zeros((n_nodes,), np.float32)


def solve_maxcut(machine: PBitMachine, problem: MaxCutProblem,
                 cfg: AnnealConfig, gen: torch.Generator | int,
                 session: api.Session | None = None) -> dict:
    """Anneal the antiferromagnetic codes, read the best chain, then polish
    it greedily on the host (1-opt)."""
    J, h = maxcut_codes(problem, machine.graph.n_nodes)
    if session is None:
        session = machine.session(schedule=cfg.to_schedule(),
                                  chains=cfg.chains)
    out = anneal(machine, J, h, cfg, gen, session=session)
    cut = problem.cut_value(out["best_state"])
    m = out["best_state"].copy()
    improved = True
    while improved:
        improved = False
        gains = _flip_gains(problem, m)
        i = int(np.argmax(gains))
        if gains[i] > 0:
            m[i] = -m[i]
            improved = True
    out["cut"] = cut
    out["cut_polished"] = problem.cut_value(m)
    out["upper_bound"] = float(problem.weights.sum())
    return out


def _flip_gains(problem: MaxCutProblem, m: np.ndarray) -> np.ndarray:
    """Cut-value gain of flipping each node."""
    n = m.shape[0]
    g = np.zeros(n)
    mi = m[problem.edges[:, 0]]
    mj = m[problem.edges[:, 1]]
    contrib = problem.weights * mi * mj  # flip of either endpoint negates
    np.add.at(g, problem.edges[:, 0], contrib)
    np.add.at(g, problem.edges[:, 1], contrib)
    return g
