"""End-to-end language-model training: the entry point.

The port of ``python -m repro.launch.train``: the train step under a
mesh (fwd + bwd + AdamW, `launch.steps.make_train_step`), the stateless
data pipeline, async atomic checkpoints with resume from the latest one,
the straggler watchdog, and optional hardware-aware training through the
8-bit DAC + per-channel-gain model (`core.hwaware`, the paper's in-situ
learning generalized).  ``--mesh host`` with ``--data-model D M``, or
``pod`` / ``multipod``, names the reference's meshes (`launch.mesh`);
their devices are logical, all on ``--device``, and the step's values do
not depend on the mesh.  ``--device`` defaults to ``cuda``: a machine
without a GPU needs ``--device cpu``.

A model with a modality stub (Whisper's frames, the vision-language
model's patch prefix and its M-RoPE positions) gets them with each
step's batch, drawn from the seed and the step (`_stub_inputs`).

``--ranks N`` runs the step sharded across N processes instead, one a
position of the ``--data-model D M`` rank mesh (D x M = N; every
family): FSDP over data, tensor parallel over model (the experts, the
Mamba channels and the RWKV heads split over it too).  The
script starts its ranks itself (a ``FileStore`` in a temporary
directory), or joins torchrun's; ``--backend nccl`` (the default on
CUDA) needs a card a rank, ``gloo`` (the default on the CPU) lets ranks
share a card, its tensors staged through host memory.  Rank 0 prints; a
checkpoint holds whole leaves, so a run resumes on another number of
ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --reduced --steps 300 --batch 8 --seq 256 --ckpt-dir runs/ckpt \\
      --mesh host --data-model 2 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 20 \\
      --ranks 2 --backend gloo --data-model 1 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --reduced --steps 20 --ranks 2 \\
      --backend gloo --data-model 1 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
      --reduced --steps 20 --ranks 2 --backend gloo --data-model 1 2 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import ranks as ranks_mod
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.core.hwaware import HwAwareConfig
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.models import sharding as shd
from repro_torch.models.model import make_dummy_batch
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import ElasticState, StragglerWatchdog


def rank_device(backend: str, device: str) -> str:
    """A rank's device: its own card under NCCL; under gloo the named
    device, a CUDA rank on card ``LOCAL_RANK`` modulo the cards."""
    import torch

    if backend == "nccl":
        return f"cuda:{ranks_mod.local_rank()}"
    if torch.device(device).type == "cuda":
        return (f"cuda:{ranks_mod.local_rank() % torch.cuda.device_count()}")
    return device


def spawn_ranks(fn, argv, world: int, backend: str):
    """Run ``fn(args, ranked=True)`` in ``world`` processes of one group:
    torchrun's (this process is one of its ranks), or started here by
    ``torch.multiprocessing`` with a ``FileStore`` in a temporary
    directory.  Returns ``fn``'s result under torchrun, else None."""
    import torch
    import torch.multiprocessing as mp

    ranks_mod.require_cards(backend, world)
    if "TORCHELASTIC_RUN_ID" in os.environ:
        ranks_mod.init_rank(backend, int(os.environ["RANK"]), world)
        try:
            return fn(argv)
        finally:
            torch.distributed.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_spawned, nprocs=world, join=True,
                 args=(fn, argv, world, backend, os.path.join(tmp, "store")))
    return None


def _spawned(rank: int, fn, argv, world: int, backend: str, store: str):
    import torch

    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(rank)
    # ranks on one host share its cores
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    ranks_mod.init_rank(backend, rank, world, store_path=store)
    try:
        fn(argv)
    finally:
        torch.distributed.destroy_process_group()


def _stub_inputs(cfg, shape, step: int, seed: int, device) -> dict:
    """A step's modality stub inputs (`make_dummy_batch`'s
    ``frontend_embeds`` and ``positions``), drawn on ``device`` from a
    generator seeded by the seed and the step: the same on every rank.
    Empty for a model without a stub."""
    import torch

    if cfg.frontend == "none":
        return {}
    gen = torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)
    return {k: v for k, v in make_dummy_batch(cfg, shape, gen).items()
            if k not in ("tokens", "labels")}


def main(argv=None) -> list[dict]:
    """Train; returns the logged rows (step, loss, lr, grad_norm,
    ms_per_step, tokens_per_s), as printed (on a spawned rank mesh they
    are printed by rank 0 and None is returned)."""
    args = parse(argv)
    if args.ranks is not None:
        return spawn_ranks(_train, argv, args.ranks, args.backend)
    return _train(argv)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--data-model", type=int, nargs=2, default=[1, 1],
                    help="host mesh (data, model) shape")
    ap.add_argument("--hardware-aware", action="store_true",
                    help="train through the 8-bit DAC + mismatch model")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of a torch.distributed group, one a "
                         "position of the --data-model rank mesh")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' backend (default: nccl on CUDA, gloo "
                         "on the CPU)")
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "gloo" if args.device == "cpu" else "nccl"
    if args.ranks is not None and (
            args.mesh != "host"
            or math.prod(args.data_model) != args.ranks):
        ap.error(f"--ranks {args.ranks} runs a --mesh host --data-model D M "
                 f"rank mesh with D x M = {args.ranks}")
    return args


def _train(argv=None) -> list[dict]:
    args = parse(argv)
    ranked = args.ranks is not None
    lead = not ranked or ranks_mod.dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    shape = ShapeCfg("train_cli", args.seq, args.batch, "train")
    if ranked:
        args.device = rank_device(args.backend, args.device)
        mesh = mesh_mod.make_host_mesh(*args.data_model, ranks=True)
    elif args.mesh == "host":
        mesh = mesh_mod.make_host_mesh(*args.data_model)
    else:
        mesh = mesh_mod.make_production_mesh(
            multi_pod=args.mesh == "multipod")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(10, args.steps // 20))
    hw = HwAwareConfig() if args.hardware_aware else None
    step_obj = make_train_step(cfg, shape, mesh, opt_cfg, hw_aware=hw,
                               microbatches=args.microbatches,
                               device=args.device)
    dev = step_obj.model.device
    params = step_obj.model.init(args.seed)
    pspec, ospec, bspec = step_obj.in_specs
    if ranked:
        params = shd.shard_tree(params, pspec, mesh, dev)
    opt_state = adamw.init(params)

    start_step = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None and ranked:
            start_step, state = ElasticState(args.ckpt_dir).resume(
                mesh, lambda _: (pspec, ospec), step_obj.abstract_args[:2],
                device=dev)
            params, opt_state = state
            say(f"resumed from step {start_step}")
        elif latest is not None:
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
    kind = (f"{args.ranks} ranks, {shd.rank_comm(mesh, dev).transport}"
            if ranked else "logical")
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"mesh={dict(mesh.shape)} ({kind}, {dev}) batch={args.batch} "
        f"seq={args.seq}")

    logged = []
    t_last = time.time()
    for step in range(start_step, args.steps):
        batch = source.batch(step, args.batch, args.seq, device=dev)
        batch.update(_stub_inputs(cfg, shape, step, args.seed, dev))
        if ranked:
            batch = shd.shard_tree(batch, bspec, mesh, dev)
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
            say(f"step {step+1:5d}  loss={loss:.4f}  "
                  f"lr={row['lr']:.2e}  gnorm={row['grad_norm']:.2f}  "
                  f"{dt*1e3:.0f} ms/step  {toks/1e3:.1f}k tok/s")
        if writer and (step + 1) % args.ckpt_every == 0:
            writer.save(step + 1, (params, opt_state))
    if writer:
        writer.save(args.steps, (params, opt_state))
        writer.wait()
        say(f"final checkpoint at {args.ckpt_dir}")
    return logged


if __name__ == "__main__":
    main()
