"""Invertible logic: factorize by running a multiplier backwards.

The PSL compiler (src/repro_torch/psl) synthesizes an n×n-bit array
multiplier as an Ising Hamiltonian whose ground states are the valid
(a, b, a·b) triples, chain-embeds it onto the Chimera graph, and samples
it through an unmodified `api.Session`.  A Hamiltonian has no notion of
signal direction, so clamping the *product* chains and annealing leaves
the free factor chains sampling the preimage — the chip's headline
invertible-logic demo.  Twin of ``examples/factorize.py`` on the
PyTorch/CUDA port: each product is one clamped `Session.sample` call,
one launch of the slot-layout kernel on the card.

Run:  PYTHONPATH=src python examples_torch/factorize.py [--device cpu]
      (on the GPU unless ``--device cpu``)
      REPRO_EXAMPLE_QUICK=1: 2-bit multiplier, small graph (smoke job).
      Full mode: 2-bit multiplier on the paper's 440-spin chip graph.

A 3-bit multiplier also *embeds* on the chip graph (27 logical spins ->
14-spin chains across a 7x7 cell window), but clique-ladder chains that
long stop mixing under Gibbs annealing, so the runnable demo stays at
2 bits.
"""
import argparse
import os

import torch

from repro_torch import psl
from repro_torch.core.chimera import make_chimera, make_chip_graph

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device
QUICK = bool(os.environ.get("REPRO_EXAMPLE_QUICK"))

if QUICK:
    n_bits, graph, products = 2, make_chimera(3, 3), [6, 9]
    chains, n_sweeps = 64, 400
else:
    # 12 logical spins -> chains of length 6 across a 3x3 cell window of
    # the chip graph (the masked SPI cell is dodged by the placement scan)
    n_bits, graph, products = 2, make_chip_graph(), [2, 3, 4, 6, 9]
    chains, n_sweeps = 128, 800

circuit = psl.multiplier_circuit(n_bits)
cc = psl.compile_circuit(circuit, graph, chains=chains, n_sweeps=n_sweeps,
                         device=device)
st = cc.embedding.stats()
print(f"{n_bits}x{n_bits}-bit multiplier: {st['n_logical']} logical spins "
      f"-> {st['n_physical']} physical ({st['chain_length']}-spin chains), "
      f"window {st['window']} on {graph.rows}x{graph.cols} Chimera, "
      f"backend {cc.session().backend} on {cc.session().device}")

gen = torch.Generator(device=cc.session().device).manual_seed(0)
for product in products:
    r = cc.run_inverse(gen, {"prod": product})
    valid = r.valid_mask()
    a, b = r.port_values("a")[valid], r.port_values("b")[valid]
    pairs = {}
    for pa, pb in zip(a.tolist(), b.tolist()):
        pairs[(pa, pb)] = pairs.get((pa, pb), 0) + 1
    shown = ", ".join(f"{pa}x{pb} ({c})"
                      for (pa, pb), c in sorted(pairs.items()))
    wrong = [p for p in pairs if p[0] * p[1] != product]
    print(f"  {product} = {shown or '<no valid samples>'}"
          f"   [valid {valid.mean():.0%} of {r.n_samples}, "
          f"broken chains {r.broken_chain_fraction:.3f}]")
    if wrong:
        raise AssertionError(
            f"clause-valid samples with a*b != {product}: {wrong}")
    if not pairs:
        raise AssertionError(f"no valid factorization sampled for {product}")
print("every clause-valid sample is a true factorization")
