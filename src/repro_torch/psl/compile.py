"""Compile PSL circuits into Session-ready `api.SamplerSpec`s.

`compile_circuit(circuit, graph)` is the top of the stack: synthesize
the logical Hamiltonian (psl/circuit.py), minor-embed it (psl/embed.py),
and wrap the result in a frozen `CompiledCircuit` holding the
`api.SamplerSpec` plus everything needed to program, clamp, and decode.
`PCircuit.to_spec(graph)` is sugar for ``compile_circuit(...).spec``.

Execution goes through an *unmodified* `api.Session`:

* programming — `Session.program_edges(emb.J_codes, emb.h_codes)`:
  the embedder's code arrays already align with ``graph.edges``;
* forward mode — clamp the input ports' chains (`run_forward`), anneal,
  majority-decode the outputs;
* inverse mode — clamp the output ports' chains (`run_inverse`) and
  read the *input* distributions: the Hamiltonian has no direction, so
  a multiplier becomes a factorizer by swapping which ports are pinned.

Defaults are chosen for exactness-of-representation first: an ideal
`HardwareConfig` (the compiled Hamiltonian *is* the logical one up to
the integer code scale), a zero-sigma `SparseMismatch` (O(D·N), so
specs default to the sparse backends that scale), ``w_scale = 1 /
code_unit`` so one logical-J unit is exactly 1.0 in neuron-input units,
and a geometric anneal that ends cold enough to freeze the ground state.
With ``backend="auto"`` and counter noise the spec resolves to
``fused_sparse``: every `CompiledCircuit.run` is one `Session.sample`
call with whole chains clamped, one launch of the slot-layout kernel.

Counterpart of ``repro.psl.compile``.  Where it differs: the default
mismatch is drawn from a `torch.Generator` seeded 0 on the spec's device
(under the ideal hardware every sigma is 0, so the draw is all zeros in
both packages); ``device=`` takes the place of the reference's
``interpret=``; `CompiledCircuit.run` takes a `torch.Generator` where the
reference takes a key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.chimera import ChimeraGraph
from repro_torch.core.hardware import (
    HardwareConfig,
    Mismatch,
    SparseMismatch,
    sample_mismatch,
    sample_mismatch_sparse,
)
from repro_torch.psl.circuit import LogicalIsing, PCircuit
from repro_torch.psl.embed import ChainEmbedding, embed_circuit
from repro_torch.psl.readout import Readout, clamp_arrays, decode_result

DEFAULT_SWEEPS = 300
DEFAULT_CHAINS = 64
DEFAULT_BETA_START = 0.1
DEFAULT_BETA_END = 2.5


def _default_mismatch(graph: ChimeraGraph, hw: HardwareConfig,
                      dense: bool, gen: torch.Generator | None, device):
    """Seed-0 mismatch draw on ``device`` (deterministic); ideal hw ⇒
    all-zero sigmas, so the draw is exactly the textbook chip."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    if dense:
        return sample_mismatch(gen, graph.n_nodes, hw, device=device)
    nbr_idx, _ = graph.neighbor_table()
    return sample_mismatch_sparse(gen, graph.n_nodes, nbr_idx.shape[0], hw,
                                  device=device)


@dataclasses.dataclass(frozen=True)
class CompiledCircuit:
    """A PSL circuit compiled onto one graph: spec + embedding + decode.

    Frozen value object; the lazily-built `api.Session` and programmed
    chip are cached out-of-band (they are device state, not part of the
    circuit's identity).
    """

    name: str
    logical: LogicalIsing
    embedding: ChainEmbedding
    spec: Any  # api.SamplerSpec

    def __post_init__(self):
        object.__setattr__(self, "_cache", {})

    # -- execution helpers ----------------------------------------------
    def session(self):
        """The compiled `api.Session` (built once, cached)."""
        if "session" not in self._cache:
            from repro_torch import api
            self._cache["session"] = api.Session(self.spec)
        return self._cache["session"]

    def chip(self):
        """The programmed `EffectiveChip` (built once, cached)."""
        if "chip" not in self._cache:
            self._cache["chip"] = self.session().program_edges(
                self.embedding.J_codes, self.embedding.h_codes)
        return self._cache["chip"]

    def clamp(self, assignments: Mapping[str, int]
              ) -> tuple[np.ndarray, np.ndarray]:
        """Port assignments -> Session clamp arrays (whole chains)."""
        return clamp_arrays(self.embedding, self.logical, assignments,
                            self.spec.chains)

    def run(self, gen: torch.Generator,
            assignments: Mapping[str, int] | None = None,
            betas=None) -> Readout:
        """Anneal once and decode the final states of every Gibbs chain.

        ``gen`` is a `torch.Generator` on the Session's device; the initial
        spins and then the noise state are drawn from it, as
        `Session.init_state` does.  ``assignments`` maps port names to
        integer values; named ports' chains are clamped, everything else
        free-runs.  Forward logic clamps inputs, inverse logic clamps
        outputs — the sampler does not know the difference.
        """
        session = self.session()
        chip = self.chip()
        m0 = session.random_spins(gen)
        ns = session.noise_state(gen)
        if assignments:
            cm, cv = self.clamp(assignments)
            dev = session.device
            m, _, _ = session.sample(
                chip, m0, ns, betas,
                clamp_mask=torch.as_tensor(cm, device=dev),
                clamp_values=torch.as_tensor(cv, device=dev))
        else:
            m, _, _ = session.sample(chip, m0, ns, betas)
        return decode_result(self.logical, self.embedding, m.cpu().numpy())

    def run_forward(self, gen: torch.Generator,
                    inputs: Mapping[str, int] | None = None,
                    betas=None) -> Readout:
        """Clamp every declared input port (values required for all)."""
        inputs = dict(inputs or {})
        missing = [p for p in self.logical.inputs if p not in inputs]
        if missing:
            raise ValueError(
                f"forward run needs every input port; missing {missing}")
        return self.run(gen, inputs, betas)

    def run_inverse(self, gen: torch.Generator,
                    outputs: Mapping[str, int] | None = None,
                    betas=None) -> Readout:
        """Clamp every declared output port — invertible-logic mode."""
        outputs = dict(outputs or {})
        missing = [p for p in self.logical.outputs if p not in outputs]
        if missing:
            raise ValueError(
                f"inverse run needs every output port; missing {missing}")
        return self.run(gen, outputs, betas)


def compile_circuit(
    circuit: PCircuit | LogicalIsing,
    graph: ChimeraGraph,
    *,
    chain_scale: float = 2.0,
    origin: tuple[int, int] | None = None,
    backend: str = "auto",
    noise: str = "counter",
    chains: int = DEFAULT_CHAINS,
    n_sweeps: int = DEFAULT_SWEEPS,
    beta_start: float = DEFAULT_BETA_START,
    beta_end: float = DEFAULT_BETA_END,
    schedule=None,
    hw: HardwareConfig | None = None,
    mismatch: Mismatch | SparseMismatch | None = None,
    mismatch_key: torch.Generator | None = None,
    device: str | torch.device = "cuda",
    w_scale: float | None = None,
) -> CompiledCircuit:
    """Netlist -> Chimera-embedded `CompiledCircuit` (see module doc).

    ``backend="ref"`` (or any dense backend) switches the default
    mismatch to the dense model, since a sparse-native spec rejects
    dense backends by construction.  ``schedule`` overrides the default
    geometric `api.Anneal`; ``w_scale`` overrides the exact
    1/code_unit logical-unit scale.  ``device`` is where the spec's
    Session runs (the card unless the caller asks for the CPU);
    ``mismatch_key`` (the reference's name) is a `torch.Generator` on it
    for the default draw, seeded 0 when omitted.
    """
    from repro_torch import api

    name = getattr(circuit, "name", "pcircuit")
    logical = circuit.synthesize() if isinstance(circuit, PCircuit) \
        else circuit
    emb = embed_circuit(logical, graph, chain_scale=chain_scale,
                        origin=origin)

    hw = HardwareConfig.ideal() if hw is None else hw
    if mismatch is None:
        dense = backend in ("ref", "pallas", "fused")
        mismatch = _default_mismatch(graph, hw, dense, mismatch_key,
                                     api.spec.require_device(device))
    if schedule is None:
        schedule = api.Anneal(beta_start, beta_end, n_sweeps=n_sweeps)
    if w_scale is None:
        # one logical-J unit == 1.0 neuron-input unit, exactly: betas
        # are in logical-energy units for every circuit
        w_scale = 1.0 / emb.code_unit
    spec = api.SamplerSpec(
        graph=graph, hw=hw, mismatch=mismatch, noise=noise,
        backend=backend, schedule=schedule, chains=chains,
        beta=beta_end, w_scale=w_scale, device=device)
    return CompiledCircuit(name=name, logical=logical, embedding=emb,
                           spec=spec)
