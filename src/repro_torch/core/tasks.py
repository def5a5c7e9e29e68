"""Paper workloads: logic-gate / full-adder Boltzmann targets + embeddings.

The chip learns *probability distributions* over visible spins: a gate is
represented by the uniform distribution over its valid truth-table rows
(invalid rows get probability 0).  Visible spins live on one side of one or
two Chimera cells (a 4:4 RBM per cell, per the paper), hiddens on the other.

Tasks are pure data; ``BoltzmannTask.train`` / ``.sample_dist`` are the
workload entry points and go through `core.cd` (and so `api.Session`);
`full_adder_inference` goes through the PSL compiler (`repro_torch.psl`).
Counterpart of ``repro.core.tasks``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.chimera import ChimeraGraph


@dataclasses.dataclass(frozen=True)
class BoltzmannTask:
    name: str
    visible_idx: np.ndarray     # compacted node ids
    target_dist: np.ndarray     # (2^n_visible,) — code = sum_i (m_i>0)<<i

    @property
    def n_visible(self) -> int:
        return len(self.visible_idx)

    def train(self, machine, cfg, gen, **kw):
        """In-situ CD training of this task on ``machine`` (a
        `core.cd.PBitMachine`).  Returns a `cd.CDResult`."""
        from repro_torch.core import cd
        return cd.train_cd(machine, self.visible_idx, self.target_dist,
                           cfg, gen, **kw)

    def sample_dist(self, machine, Jm, hm, gen, **kw) -> np.ndarray:
        """Empirical visible distribution of the programmed chip (streams
        through `Session.visible_hist`)."""
        from repro_torch.core import cd
        return cd.sample_visible_dist(machine, Jm, hm, self.visible_idx,
                                      gen, **kw)

    def kl_to_target(self, dist: np.ndarray) -> float:
        """KL(target || dist) — the paper's Fig 7/8 figure of merit."""
        from repro_torch.core import energy
        return float(energy.kl_divergence(np.asarray(self.target_dist),
                                          np.asarray(dist)))


def _dist_from_rows(n_vis: int, rows: list[tuple[int, ...]]) -> np.ndarray:
    """Uniform distribution over the given ±1-coded truth-table rows."""
    d = np.zeros(2 ** n_vis)
    for row in rows:
        code = sum((1 << i) for i, v in enumerate(row) if v > 0)
        d[code] = 1.0
    return d / d.sum()


def and_gate_rows() -> list[tuple[int, int, int]]:
    rows = []
    for a in (-1, 1):
        for b in (-1, 1):
            c = 1 if (a > 0 and b > 0) else -1
            rows.append((a, b, c))
    return rows


def full_adder_rows() -> list[tuple[int, ...]]:
    rows = []
    for a in (0, 1):
        for b in (0, 1):
            for cin in (0, 1):
                s = a ^ b ^ cin
                cout = (a & b) | (cin & (a ^ b))
                rows.append(tuple(2 * v - 1 for v in (a, b, cin, s, cout)))
    return rows


def and_gate_task(graph: ChimeraGraph, cell: tuple[int, int] = (0, 0)
                  ) -> BoltzmannTask:
    """AND on 3 visible spins (A, B, A∧B) = vertical nodes 0..2 of one cell;
    the cell's 4 horizontal nodes are hidden (paper Fig. 7b)."""
    vis = graph.cell_nodes(*cell, side=0)[:3]
    return BoltzmannTask("and_gate", vis, _dist_from_rows(3, and_gate_rows()))


def full_adder_task(graph: ChimeraGraph,
                    cells: tuple[tuple[int, int], tuple[int, int]] = (
                        (0, 0), (0, 1)),
                    ) -> BoltzmannTask:
    """Full adder (A, B, Cin, S, Cout): 5 visibles across two adjacent cells'
    vertical nodes; 8 hiddens = both cells' horizontal nodes (paper Fig. 8b).
    Horizontal inter-cell couplers connect the two cells' hidden layers."""
    v0 = graph.cell_nodes(*cells[0], side=0)
    v1 = graph.cell_nodes(*cells[1], side=0)
    vis = np.concatenate([v0[:3], v1[:2]])
    return BoltzmannTask(
        "full_adder", vis, _dist_from_rows(5, full_adder_rows()))


def full_adder_inference(graph: ChimeraGraph | None = None, *,
                         gen=None, chains: int = 64,
                         **compile_kw) -> dict:
    """Full-adder truth-table inference through the PSL compiler.

    This is the *fixed* inference path for the chip's Fig-8b demo: the
    exact gate Hamiltonian (psl/gates.py) chain-embedded onto ``graph``
    (default: the smallest Chimera that fits, 2x2), inputs clamped per
    row, outputs read by clause-filtered chain-majority vote
    (psl/readout.py).  The learned-machine route (`full_adder_task` +
    CD + raw clamped sampling) recovers only ~3/8 rows; this one
    recovers 8/8.

    ``gen`` is a `torch.Generator` on the compiled spec's device (seeded
    0 there when omitted); the 8 rows draw from it in turn.  Every row is
    one clamped `Session.sample` call (one K1 launch under the default
    ``fused_sparse`` resolution).  ``compile_kw`` goes to
    `psl.compile_circuit` (``device="cpu"`` runs the plain versions).

    Returns ``{"rows_correct", "rows", "broken_chain_fraction"}`` where
    ``rows`` maps (a, b, cin) -> (s, cout, ok).
    """
    import torch

    from repro_torch import psl

    if graph is None:
        from repro_torch.core.chimera import make_chimera
        graph = make_chimera(2, 2)
    cc = psl.compile_circuit(psl.full_adder_circuit(), graph,
                             chains=chains, **compile_kw)
    if gen is None:
        gen = torch.Generator(device=cc.session().device).manual_seed(0)
    rows: dict[tuple[int, int, int], tuple[int, int, bool]] = {}
    correct, broken = 0, []
    for a, b, cin, s, cout in (
            tuple((v + 1) // 2 for v in row) for row in full_adder_rows()):
        r = cc.run_forward(gen, {"a": a, "b": b, "cin": cin})
        got_s, got_c = r.infer("s"), r.infer("cout")
        ok = (got_s == s and got_c == cout)
        correct += ok
        broken.append(r.broken_chain_fraction)
        rows[(a, b, cin)] = (got_s, got_c, ok)
    return {"rows_correct": correct, "rows": rows,
            "broken_chain_fraction": float(np.mean(broken))}


def xor_gate_task(graph: ChimeraGraph, cell: tuple[int, int] = (0, 0)
                  ) -> BoltzmannTask:
    """XOR needs hidden units (not linearly separable) — a good stress test."""
    vis = graph.cell_nodes(*cell, side=0)[:3]
    rows = []
    for a in (-1, 1):
        for b in (-1, 1):
            c = 1 if (a > 0) != (b > 0) else -1
            rows.append((a, b, c))
    return BoltzmannTask("xor_gate", vis, _dist_from_rows(3, rows))
