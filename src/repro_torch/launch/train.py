"""End-to-end language-model training: the entry point.

The port of ``python -m repro.launch.train`` on one device: the train
step (fwd + bwd + AdamW, `launch.steps.make_train_step`), the stateless
data pipeline, async atomic checkpoints with resume from the latest one,
the straggler watchdog, and optional hardware-aware training through the
8-bit DAC + per-channel-gain model (`core.hwaware`, the paper's in-situ
learning generalized).  ``--device`` defaults to ``cuda``: a machine
without a GPU needs ``--device cpu``.  ``--mesh`` and ``--data-model``
come with the multi-card slice (ROADMAP item 12d).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --reduced --steps 300 --batch 8 --seq 256 --ckpt-dir runs/ckpt \\
      --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.core.hwaware import HwAwareConfig
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import StragglerWatchdog


def main(argv=None) -> list[dict]:
    """Train; returns the logged rows (step, loss, lr, grad_norm,
    ms_per_step, tokens_per_s), as printed."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--hardware-aware", action="store_true",
                    help="train through the 8-bit DAC + mismatch model")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    shape = ShapeCfg("train_cli", args.seq, args.batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(10, args.steps // 20))
    hw = HwAwareConfig() if args.hardware_aware else None
    step_obj = make_train_step(cfg, shape, opt_cfg, hw_aware=hw,
                               microbatches=args.microbatches,
                               device=args.device)
    dev = step_obj.model.device
    params = step_obj.model.init(args.seed)
    opt_state = adamw.init(params)

    start_step = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            start_step, state, _ = ckpt.load(
                args.ckpt_dir, latest, target=(params, opt_state))
            params, opt_state = state
            print(f"resumed from step {start_step}")

    source = make_source(DataConfig(seed=args.seed,
                                    vocab_size=cfg.vocab_size))
    watchdog = StragglerWatchdog(
        on_straggler=lambda s, dt, ew: print(
            f"[watchdog] step {s} took {dt:.3f}s (ewma {ew:.3f}s)"))

    n_params = sum(math.prod(p.shape) for p in adamw.tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"device={dev} batch={args.batch} seq={args.seq}")

    logged = []
    t_last = time.time()
    for step in range(start_step, args.steps):
        batch = source.batch(step, args.batch, args.seq, device=dev)
        params, opt_state, metrics = step_obj.fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            dt = (time.time() - t_last) / args.log_every
            t_last = time.time()
            watchdog.observe(step, dt)
            toks = args.batch * args.seq / max(dt, 1e-9)
            row = {"step": step + 1, "loss": loss,
                   "lr": float(metrics["lr"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "ms_per_step": dt * 1e3, "tokens_per_s": toks}
            logged.append(row)
            print(f"step {step+1:5d}  loss={loss:.4f}  "
                  f"lr={row['lr']:.2e}  gnorm={row['grad_norm']:.2f}  "
                  f"{dt*1e3:.0f} ms/step  {toks/1e3:.1f}k tok/s")
        if writer and (step + 1) % args.ckpt_every == 0:
            writer.save(step + 1, (params, opt_state))
    if writer:
        writer.save(args.steps, (params, opt_state))
        writer.wait()
        print(f"final checkpoint at {args.ckpt_dir}")
    return logged


if __name__ == "__main__":
    main()
