"""Probabilistic spin logic: netlists -> Chimera-embedded SamplerSpecs.

The compiler stack (docs/psl.md):

* `psl.circuit` — `PCircuit` builder + frozen `LogicalIsing` IR;
* `psl.gates` — verified gate Hamiltonians (COPY/NOT/AND/OR/XOR,
  half/full adder) and composed modules (ripple adder, multiplier);
* `psl.embed` — deterministic clique-ladder minor embedding onto any
  masked `ChimeraGraph`, chain-strength auto-scaling, validity checks;
* `psl.compile` — `compile_circuit` / `PCircuit.to_spec` emitting an
  `api.SamplerSpec` run by an unmodified `api.Session`;
* `psl.readout` — chain-majority decoding with broken-chain stats.

Counterpart of ``repro.psl``: the same module names, exports and
`__all__`.  Everything but `psl.compile`'s Session glue is numpy; a
compiled circuit runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``.
"""
from repro_torch.psl.circuit import Clause, LogicalIsing, PCircuit
from repro_torch.psl.compile import CompiledCircuit, compile_circuit
from repro_torch.psl.embed import (ChainEmbedding, embed_circuit,
                                   validate_embedding)
from repro_torch.psl.gates import (
    and_circuit,
    and_gate,
    copy_circuit,
    copy_gate,
    full_adder,
    full_adder_circuit,
    half_adder,
    multiplier,
    multiplier_circuit,
    not_circuit,
    not_gate,
    or_circuit,
    or_gate,
    ripple_adder,
    ripple_adder_circuit,
    xor_circuit,
    xor_gate,
)
from repro_torch.psl.readout import (
    Readout,
    bits_to_int,
    clamp_arrays,
    decode_result,
    decode_states,
    int_to_spins,
)

__all__ = [
    "Clause",
    "LogicalIsing",
    "PCircuit",
    "CompiledCircuit",
    "compile_circuit",
    "ChainEmbedding",
    "embed_circuit",
    "validate_embedding",
    "and_circuit",
    "and_gate",
    "copy_circuit",
    "copy_gate",
    "full_adder",
    "full_adder_circuit",
    "half_adder",
    "multiplier",
    "multiplier_circuit",
    "not_circuit",
    "not_gate",
    "or_circuit",
    "or_gate",
    "ripple_adder",
    "ripple_adder_circuit",
    "xor_circuit",
    "xor_gate",
    "Readout",
    "bits_to_int",
    "clamp_arrays",
    "decode_result",
    "decode_states",
    "int_to_spins",
]
