"""End-to-end example: train a ~100M-parameter LM for a few hundred steps.

Uses the production train step (fwd+bwd+AdamW under a mesh, remat,
in-place state) on a one-device host mesh.  The same entry point takes
the pod meshes via `repro_torch.launch.train` (their devices are logical,
all on one card).  Twin of ``examples/train_lm.py`` on the PyTorch/CUDA
port.

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--device cpu]
(on the GPU unless ``--device cpu``.)
"""
import argparse
import math
import time

from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=256)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# ~100M params: 12L x 768, llama-style (deepseek family geometry, scaled)
cfg = ModelCfg(
    name="lm-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
    vocab_size=32000, dtype="float32", remat=False)
shape = ShapeCfg("train", args.seq, args.batch, "train")
mesh = mesh_mod.make_host_mesh(1, 1)

opt_cfg = adamw.AdamWConfig(lr=6e-4, warmup_steps=30,
                            total_steps=args.steps)
step = make_train_step(cfg, shape, mesh, opt_cfg, device=args.device)
params = step.model.init(0)
n = sum(math.prod(p.shape) for p in adamw.tree_leaves(params))
print(f"model: {cfg.name} ({n/1e6:.1f}M params) on {step.model.device}")
opt_state = adamw.init(params)
src = make_source(DataConfig(seed=0, vocab_size=cfg.vocab_size))

t0 = time.time()
for s in range(args.steps):
    batch = src.batch(s, args.batch, args.seq, device=step.model.device)
    params, opt_state, m = step.fn(params, opt_state, batch)
    if (s + 1) % 25 == 0 or s == 0:
        print(f"step {s+1:4d}  loss={float(m['loss']):.4f}  "
              f"lr={float(m['lr']):.2e}  "
              f"gnorm={float(m['grad_norm']):.2f}")
dt = time.time() - t0
print(f"\n{args.steps} steps in {dt:.0f}s "
      f"({args.steps*args.batch*args.seq/dt/1e3:.1f}k tok/s on "
      f"{step.model.device})")
