"""Paper Fig 8b: learn a full adder's probability distribution on-chip,
then *use* it for inference — two ways.  Twin of
``examples/full_adder.py`` on the PyTorch/CUDA port.

1. The learned machine: CD-trained couplings, clamp (A, B, Cin), read
   the mean of the free-running (S, Cout) spins.  This is the paper's
   original demo and it is known-weak (~3/8 truth-table rows): the
   learned Hamiltonian's ground structure is approximate and the raw
   mean readout has no error correction.
2. The PSL compiler (src/repro_torch/psl): the *exact* full-adder
   Hamiltonian chain-embedded onto the Chimera graph, inputs clamped as
   whole chains, outputs decoded by clause-filtered chain-majority
   vote.  8/8 rows.

Run:  PYTHONPATH=src python examples_torch/full_adder.py [--device cpu]
      (on the GPU unless ``--device cpu``; REPRO_EXAMPLE_QUICK=1 shrinks
      the CD run for a smoke job.)
"""
import argparse
import os

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import HardwareConfig, PBitMachine, CDConfig
from repro_torch.core import tasks
from repro_torch.core.chimera import make_chimera

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device
QUICK = bool(os.environ.get("REPRO_EXAMPLE_QUICK"))

graph = make_chimera(1, 2)   # two coupled cells: 5 visibles + 8 hiddens
machine = PBitMachine.create(graph, 0, HardwareConfig(), beta=1.0,
                             w_scale=0.05, device=device)
task = tasks.full_adder_task(graph)

cfg = CDConfig(lr=6.0, cd_k=15, pos_sweeps=15, chains=256,
               epochs=12 if QUICK else 120)
res = task.train(machine, cfg, 1, eval_every=6 if QUICK else 30,
                 verbose=True)

# -- route 1: learned machine, raw clamped inference ---------------------
session = machine.session(
    schedule=api.Constant(beta=2.0, n_sweeps=120), chains=128)
chip = session.program_master(res.Jm, res.hm)
vis = task.visible_idx
dev = session.device
clamp_mask = torch.zeros((graph.n_nodes,), dtype=torch.bool, device=dev)
clamp_mask[vis[:3]] = True
print(f"\nlearned machine, raw clamped inference (mode of S, Cout), "
      f"device {device}:")
correct = 0
for a in (0, 1):
    for b in (0, 1):
        for cin in (0, 1):
            cv = torch.zeros((128, graph.n_nodes), device=dev)
            cv[:, vis[0]] = 2 * a - 1
            cv[:, vis[1]] = 2 * b - 1
            cv[:, vis[2]] = 2 * cin - 1
            m0 = session.random_spins(session.generator(0))
            ns = session.noise_state(session.generator(2))
            m, _, traj = session.sample(
                chip, m0, ns, clamp_mask=clamp_mask, clamp_values=cv,
                collect=True)
            samples = traj[40:].cpu().numpy()
            s = int(samples[..., vis[3]].mean() > 0)
            cout = int(samples[..., vis[4]].mean() > 0)
            want_s = a ^ b ^ cin
            want_c = (a & b) | (cin & (a ^ b))
            ok = (s == want_s) and (cout == want_c)
            correct += ok
            print(f"  {a}+{b}+{cin} -> S={s} Cout={cout} "
                  f"(want {want_s},{want_c}) {'OK' if ok else 'x'}")
print(f"{correct}/8 adder rows correct (learned machine)")

# -- route 2: PSL-compiled exact Hamiltonian + chain-majority readout ----
print("\nPSL compiler (chain embedding + clause-filtered majority):")
out = tasks.full_adder_inference(
    make_chimera(2, 2), gen=torch.Generator(device=dev).manual_seed(3),
    device=device)
for (a, b, cin), (s, cout, ok) in sorted(out["rows"].items()):
    print(f"  {a}+{b}+{cin} -> S={s} Cout={cout} {'OK' if ok else 'x'}")
print(f"{out['rows_correct']}/8 adder rows correct (PSL), "
      f"broken-chain fraction {out['broken_chain_fraction']:.3f}")
