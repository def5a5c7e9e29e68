"""Chain-majority readout: physical samples -> logical bit-strings.

The inverse of the embedding pass.  A sampled physical state assigns
±1 to every node of every chain; a healthy chain is unanimous, a
*broken* chain (thermal excitation beat the ferromagnetic chain
couplers) is not.  The decoder takes the majority vote per chain —
ties (possible: chains have even length 2M) go to the junction node,
which is chain_nodes[i][0] by the embedder's construction and also the
bias site, so the tie-breaker is the one physical spin that feels h
directly.

Decoding is pure NumPy on host-side sample arrays — it runs after
sampling, on any leading batch shape (chains, sweeps × chains, ...).
Broken-chain statistics ride along: they are the embedding-quality
signal (chain strength too low ⇒ broken fraction up ⇒ logical error
rate up) that the bench tracks and tests assert on.

Counterpart of ``repro.psl.readout`` (numpy only, identical
output); callers bring states to the host with ``m.cpu().numpy()``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.psl.circuit import LogicalIsing
from repro_torch.psl.embed import ChainEmbedding


def bits_to_int(bits: np.ndarray) -> np.ndarray:
    """(..., nbits) ±1 spins, LSB-first -> (...) integers."""
    bits = np.asarray(bits)
    weights = 1 << np.arange(bits.shape[-1], dtype=np.int64)
    return ((bits > 0).astype(np.int64) * weights).sum(axis=-1)


def int_to_spins(value: int, nbits: int) -> np.ndarray:
    """Integer -> (nbits,) ±1 spins, LSB-first."""
    if not 0 <= value < (1 << nbits):
        raise ValueError(f"{value} does not fit in {nbits} bits")
    return np.asarray([1 if (value >> i) & 1 else -1
                       for i in range(nbits)], np.int8)


def decode_states(emb: ChainEmbedding, states: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Physical (..., N_graph) ±1 states -> logical (..., n_logical).

    Returns ``(logical, broken)``: majority-voted ±1 logical spins
    (ties resolved by the junction node) and a same-shaped bool mask of
    chains that were not unanimous.
    """
    states = np.asarray(states)
    idx = emb.chain_index()                       # (L, C)
    member = states[..., idx]                     # (..., L, C)
    vote = member.sum(axis=-1)
    junction = member[..., 0]
    logical = np.where(vote > 0, 1, np.where(vote < 0, -1, junction))
    broken = np.abs(vote) != idx.shape[1]
    return logical.astype(np.int8), broken


@dataclasses.dataclass(frozen=True)
class Readout:
    """Decoded samples of one compiled circuit.

    ``logical``/``broken`` are (n_samples, n_logical); port accessors
    convert named LSB-first bit groups to integers per sample.
    """

    logical_model: LogicalIsing
    logical: np.ndarray
    broken: np.ndarray

    @property
    def n_samples(self) -> int:
        return int(self.logical.shape[0])

    @property
    def broken_chain_fraction(self) -> float:
        """Fraction of (sample, chain) readouts with a broken chain."""
        return float(self.broken.mean()) if self.broken.size else 0.0

    def broken_per_chain(self) -> np.ndarray:
        """(n_logical,) broken fraction per chain — the weak-link map."""
        return self.broken.mean(axis=0)

    def port_values(self, name: str) -> np.ndarray:
        """(n_samples,) integers read from one named port."""
        ids = list(self.logical_model.port(name))
        return bits_to_int(self.logical[:, ids])

    def port_counts(self, name: str) -> dict[int, int]:
        vals, counts = np.unique(self.port_values(name), return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}

    def port_mode(self, name: str) -> int:
        """Most frequent value on a port (the inference answer)."""
        counts = self.port_counts(name)
        return max(counts, key=lambda v: (counts[v], -v))

    def valid_mask(self) -> np.ndarray:
        """(n_samples,) bool: sample satisfies every circuit clause."""
        return np.asarray([self.logical_model.satisfied(row)
                           for row in self.logical])

    def infer(self, name: str) -> int:
        """Clause-filtered majority readout — the inference contract.

        Majority vote over the samples that satisfy every circuit
        clause; falls back to the raw majority when no sample is fully
        consistent.  The filter is what makes inference robust: an
        annealed chain can freeze into a metastable clause-violating
        state (measured on the full adder: raw mode 3–7/8 rows
        depending on the schedule, filtered 8/8 across every schedule
        tried), but conditioned on clause consistency the clamped
        problem has a unique forward answer.
        """
        valid = self.valid_mask()
        vals = self.port_values(name)
        if valid.any():
            vals = vals[valid]
        counts: dict[int, int] = {}
        for v in vals:
            counts[int(v)] = counts.get(int(v), 0) + 1
        return max(counts, key=lambda v: (counts[v], -v))

    def joint_counts(self, names: list[str]) -> dict[tuple[int, ...], int]:
        """Histogram over tuples of port values — e.g. (a, b) factor
        pairs in inverse mode.  Counts every sample, valid or not."""
        cols = np.stack([self.port_values(n) for n in names], axis=-1)
        out: dict[tuple[int, ...], int] = {}
        for row in cols:
            key = tuple(int(v) for v in row)
            out[key] = out.get(key, 0) + 1
        return out

    def summary(self) -> dict:
        valid = self.valid_mask()
        return {
            "n_samples": self.n_samples,
            "broken_chain_fraction": self.broken_chain_fraction,
            "clause_valid_fraction": float(valid.mean()),
        }


def decode_result(logical_model: LogicalIsing, emb: ChainEmbedding,
                  states: np.ndarray) -> Readout:
    """Decode (..., N_graph) sampled states into a flat `Readout`."""
    states = np.asarray(states)
    logical, broken = decode_states(emb, states)
    return Readout(
        logical_model=logical_model,
        logical=logical.reshape(-1, emb.n_logical),
        broken=broken.reshape(-1, emb.n_logical))


def clamp_arrays(emb: ChainEmbedding, logical_model: LogicalIsing,
                 assignments: Mapping[str, int], n_chains: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Port assignments -> (clamp_mask (N,), clamp_values (B, N)).

    Clamping a logical spin pins its *entire chain* to the value — the
    chain is one logical variable, and a partially clamped chain would
    fight its own ferromagnetic couplers.  Exactly the Session.sample
    clamp contract (the CD positive phase uses the same arrays).
    """
    n = emb.graph.n_nodes
    mask = np.zeros(n, bool)
    values = np.zeros(n, np.float32)
    for port, value in assignments.items():
        ids = logical_model.port(port)
        spins = int_to_spins(int(value), len(ids))
        for spin_id, s in zip(ids, spins):
            for node in emb.chain_nodes[spin_id]:
                mask[node] = True
                values[node] = float(s)
    return mask, np.broadcast_to(values, (n_chains, n)).copy()
