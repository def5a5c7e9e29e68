"""Paper Fig 9: optimization on the chip — SK annealing + Max-Cut.

Both workloads run through one `api.Session` per anneal schedule
(`machine.session(schedule=api.Anneal(...))`); `anneal` and
`solve_maxcut` construct no samplers of their own.  Twin of
``examples/maxcut.py`` on the PyTorch/CUDA port.

Run:  PYTHONPATH=src python examples_torch/maxcut.py [--device cpu]
(on the GPU unless ``--device cpu``; REPRO_EXAMPLE_QUICK=1 shrinks the run
for a smoke job.)
"""
import argparse
import os

import numpy as np

from repro_torch.core import (
    AnnealConfig,
    HardwareConfig,
    PBitMachine,
    anneal,
    random_chimera_maxcut,
    sk_instance,
    solve_maxcut,
)
from repro_torch.core.chimera import make_chip_graph

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device

graph = make_chip_graph()
machine = PBitMachine.create(graph, 0, HardwareConfig(), beta=1.0,
                             w_scale=0.03, device=device)
quick = bool(os.environ.get("REPRO_EXAMPLE_QUICK"))
sweeps = 150 if quick else 600
chains = 16 if quick else 64

# --- Fig 9a: SK spin glass annealing -----------------------------------
J, h = sk_instance(graph, 4)
out = anneal(machine, J, h,
             AnnealConfig(n_sweeps=sweeps, beta_start=0.02, beta_end=3.0,
                          chains=chains),
             5, record_every=sweeps // 10)
print(f"SK annealing energy trajectory (mean over {chains} chains, "
      f"device {device}):")
for s, e in zip(out["sweeps"], out["energy_mean"]):
    print(f"  sweep {s:4d}: E = {e:9.1f}")
print(f"best energy found: {out['best_energy']:.1f}")

# --- Fig 9b: Max-Cut -----------------------------------------------------
prob = random_chimera_maxcut(graph, 1, edge_prob=0.8)
cut_cfg = AnnealConfig(n_sweeps=sweeps, beta_start=0.05, beta_end=3.0,
                       chains=chains)
# explicit Session: build the anneal schedule once, hand it to the solver
session = machine.session(schedule=cut_cfg.to_schedule(),
                          chains=cut_cfg.chains)
sol = solve_maxcut(machine, prob, cut_cfg, 2, session=session)
rng = np.random.default_rng(0)
rand = max(prob.cut_value(rng.choice([-1.0, 1.0], size=graph.n_nodes))
           for _ in range(64))
print(f"\nMax-Cut on {prob.n_edges} chimera edges:")
print(f"  annealed cut : {sol['cut']:.0f}")
print(f"  + 1-opt      : {sol['cut_polished']:.0f}")
print(f"  random best  : {rand:.0f}")
print(f"  upper bound  : {sol['upper_bound']:.0f}")
