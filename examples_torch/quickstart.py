"""Quickstart: learn an AND gate on a simulated mismatched p-bit chip.

This is the paper's Fig 7 experiment end-to-end in ~40 lines of public API:
build the chip graph, sample a chip instance (process variation included),
train with in-situ contrastive divergence, and inspect the learned visible
distribution.  Twin of ``examples/quickstart.py`` on the PyTorch/CUDA port.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
(on the GPU unless ``--device cpu``; REPRO_EXAMPLE_QUICK=1 shrinks the run
for a smoke job.)
"""
import argparse
import os

from repro_torch.core import HardwareConfig, PBitMachine, CDConfig
from repro_torch.core.chimera import make_chimera
from repro_torch.core import tasks

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device

# one Chimera unit cell = a 4:4 RBM, exactly like the chip's
graph = make_chimera(1, 1)

# a chip *instance*: mismatch sampled from the process-variation model.
# All sampling below goes through one api.Session under the hood
# (machine.session(...)).
machine = PBitMachine.create(graph, 42, HardwareConfig(), beta=1.0,
                             w_scale=0.05, device=device)

# target: uniform distribution over AND's 4 valid truth-table rows
task = tasks.and_gate_task(graph)
print(f"chip: {graph.n_nodes} p-bits, task '{task.name}', "
      f"{task.n_visible} visible spins, device {device}")

quick = bool(os.environ.get("REPRO_EXAMPLE_QUICK"))
cfg = CDConfig(lr=6.0, cd_k=15, pos_sweeps=15, chains=256,
               epochs=12 if quick else 80)
result = task.train(machine, cfg, 7, eval_every=4 if quick else 20,
                    verbose=True)

dist = task.sample_dist(machine, result.Jm, result.hm, 3)
print("\nlearned visible distribution (A, B, A∧B):")
for code in range(8):
    bits = [(code >> i) & 1 for i in range(3)]
    target = task.target_dist[code]
    print(f"  A={bits[0]} B={bits[1]} C={bits[2]}  "
          f"p={dist[code]:.3f}  target={target:.3f}"
          + ("   <-- valid row" if target > 0 else ""))
