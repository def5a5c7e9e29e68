"""How far a model's loss, gradient norm and prefill logits on a rank mesh
sit from one process's, at several depths, in bf16 and in float32.

For each depth in ``--depths`` (the config at full width, cut to that
many layers; seed 0's parameters): rank 0 first computes in one process,
in the config's dtype (bf16) and with the parameters upcast to float32,
the loss and its gradients' global norm on the pipeline's first batch
(B=8, S=256) and the last prompt position's logits of a B=4 x P=32
prefill; then both ranks of a 1 x ``--model`` mesh compute the same
through `launch.steps` on their blocks, in both dtypes.  Rank 0 prints
one JSON line a depth: each quantity, |ranks - one process| in each
dtype, and |one process bf16 - float32|: whether the split adds more
than bf16's own rounding (`chip_smoke.py`'s `lm_ranks` gates).

``--per-block`` adds, in float32 with remat off, the gradient of the
loss with respect to each layer's input (the residual stream, whole on
every rank of a 1 x M mesh): its relative gap (Frobenius norm of the
difference over the norm) between the ranks and one process, layer by
layer, and with ``--noise`` between the noisy and the clean run — where
the ranks part from one process, against where rounding alone does.

``--noise E`` adds one process's own float32 sensitivity: the same
quantities with every RWKV time mix's output multiplied by 1 + E times a
standard normal draw (a fixed generator a call, the same in forward and
in the remat's rerun), and their gaps to the clean float32 run
(``one_f32_noise_vs_f32``): how far rounding of that size alone moves
them, to hold the ranks' float32 gap against.

  PYTHONPATH=src python benchmarks_torch/lm_ranks_depth.py --reduced --device cpu
  PYTHONPATH=src python benchmarks_torch/lm_ranks_depth.py --arch rwkv6-3b --depths 2 8 32
  PYTHONPATH=src python benchmarks_torch/lm_ranks_depth.py --arch rwkv6-3b --depths 8 32 --noise 1e-7
  PYTHONPATH=src python benchmarks_torch/lm_ranks_depth.py --arch rwkv6-3b --depths 8 --noise 1e-7 --per-block
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json

import torch

B, S, PB, PROMPT = 8, 256, 4, 32


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 8, 32])
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (float32 becomes bf16)")
    ap.add_argument("--model", type=int, default=2,
                    help="ranks on the model axis (the world size)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--per-block", action="store_true",
                    help="each layer input's gradient, ranks against one "
                         "process (float32, remat off)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="relative noise on the RWKV time mix's output "
                         "for one process's float32 sensitivity (0: off)")
    return ap.parse_args(argv)


@contextlib.contextmanager
def time_mix_noise(eps: float):
    """Every `models.rwkv.rwkv_time_mix` output times 1 + ``eps`` N(0, 1),
    the draw from a generator seeded by the bits of the input's sum (a
    remat rerun, on the same input, draws the same)."""
    from repro_torch.models import rwkv

    real = rwkv.rwkv_time_mix

    def noisy(params, cfg, x, *a, **k):
        out, st = real(params, cfg, x, *a, **k)
        seed = int(x.detach().float().sum().view(torch.int32)) % (1 << 31)
        gen = torch.Generator(device=out.device).manual_seed(seed)
        z = torch.randn(out.shape, generator=gen, device=out.device,
                        dtype=torch.float32)
        return out * (1 + eps * z).to(out.dtype), st

    rwkv.rwkv_time_mix = noisy
    try:
        yield
    finally:
        rwkv.rwkv_time_mix = real


@contextlib.contextmanager
def layer_input_grads(out: list):
    """Append to ``out`` the gradient of the loss with respect to each
    `models.transformer.apply_layer` call's input, in forward order (on
    the host, once the backward has run)."""
    from repro_torch.models import transformer

    real = transformer.apply_layer

    def hooked(p, cfg, plan, x, *a, **k):
        if x.requires_grad:
            i = len(out)
            out.append(None)
            x.register_hook(lambda g: out.__setitem__(
                i, g.detach().float().cpu()))
        return real(p, cfg, plan, x, *a, **k)

    transformer.apply_layer = hooked
    try:
        yield
    finally:
        transformer.apply_layer = real


def _measure(cfg, params, mesh, device, per_block=False) -> dict:
    """The loss, the gradients' global norm and the prefill's last
    logits (whole), through the steps on ``mesh`` (None: one process);
    with ``per_block`` also each layer input's gradient
    (`layer_input_grads`)."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import steps
    from repro_torch.models import sharding as shd
    from repro_torch.optim import adamw

    ranked = shd.is_rank_mesh(mesh)
    st = steps.make_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                               device=device)
    pre = steps.make_prefill_step(cfg, ShapeCfg("p", PROMPT, PB, "prefill"),
                                  mesh, device=device)
    batch = make_source(DataConfig(seed=0, vocab_size=cfg.vocab_size)
                        ).batch(0, B, S, device=device)
    prompts = {"tokens": torch.randint(
        0, cfg.vocab_size, (PB, PROMPT),
        generator=torch.Generator().manual_seed(5)).to(device)}
    baxes = ()
    if ranked:
        params = shd.shard_tree(params, st.in_specs[0], mesh, device)
        batch = shd.shard_tree(batch, st.in_specs[2], mesh, device)
        prompts = shd.shard_tree(prompts, pre.in_specs[1], mesh, device)
        baxes = steps._batch_axes(st.in_specs[2])
    blocks: list = []
    with shd.use_mesh(mesh, device, baxes), (
            layer_input_grads(blocks) if per_block
            else contextlib.nullcontext()):
        live = [p.detach().requires_grad_()
                for p in adamw.tree_leaves(params)]
        loss = st.model.loss(adamw.tree_unflatten(params, live),
                             shd.local_tree(batch))
        grads = adamw.tree_unflatten(params, list(
            torch.autograd.grad(loss, live)))
        norm = float(adamw.global_norm(grads))
    del grads, live
    logits = pre.fn(params, prompts)[0]
    if ranked:
        with shd.use_mesh(mesh, device):
            logits = shd.full_tree(logits)
    return {"loss": float(loss), "grad_norm": norm,
            "logits": logits[:, -1].float().cpu(), "blocks": blocks}


def _rank(argv) -> None:
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import rank_device
    from repro_torch.models import sharding as shd
    from repro_torch.models.model import build_model

    args = parse(argv)
    device = rank_device(args.backend, args.device)
    mesh = make_host_mesh(1, args.model, ranks=True)
    base = (dataclasses.replace(get_reduced_config(args.arch),
                                dtype="bfloat16")
            if args.reduced else get_config(args.arch))
    for depth in args.depths:
        cfg = dataclasses.replace(base, num_layers=depth)
        f32 = dataclasses.replace(cfg, dtype="float32")
        if args.per_block:
            f32 = dataclasses.replace(f32, remat=False)
        pb = args.per_block
        got: dict = {}
        if dist.get_rank() == 0:
            params = build_model(cfg, device=device).init(0)
            got["one_bf16"] = _measure(cfg, params, None, device)
            p32 = shd.map_with_path(lambda _, x: x.float(), params)
            got["one_f32"] = _measure(f32, p32, None, device, pb)
            if args.noise:
                with time_mix_noise(args.noise):
                    got["one_f32_noise"] = _measure(f32, p32, None, device,
                                                    pb)
            del params, p32
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        dist.barrier()
        params = build_model(cfg, device=device).init(0)
        got["ranks_bf16"] = _measure(cfg, params, mesh, device)
        params = shd.map_with_path(lambda _, x: x.float(), params)
        gc.collect()
        got["ranks_f32"] = _measure(f32, params, mesh, device, pb)
        del params
        gc.collect()
        if dist.get_rank() != 0:
            continue

        def gap(a, b, key):
            x, y = got[a][key], got[b][key]
            return float((x - y).abs().max()) if key == "logits" \
                else abs(x - y)

        rec = {"arch": cfg.name, "layers": depth, "model": args.model}
        for key in ("loss", "grad_norm"):
            rec[key] = {k: v[key] for k, v in got.items()}
        rec["logit_rms"] = float(got["one_bf16"]["logits"].pow(2).mean()
                                 .sqrt())
        for key in ("loss", "grad_norm", "logits"):
            rec[f"{key}_gap"] = {
                "ranks_vs_one_bf16": gap("ranks_bf16", "one_bf16", key),
                "ranks_vs_one_f32": gap("ranks_f32", "one_f32", key),
                "one_bf16_vs_f32": gap("one_bf16", "one_f32", key)}
            if args.noise:
                rec[f"{key}_gap"]["one_f32_noise_vs_f32"] = gap(
                    "one_f32_noise", "one_f32", key)
        rec["noise"] = args.noise
        if pb:
            def block_gaps(a, b):
                return [float((x - y).norm() / y.norm()) for x, y in
                        zip(got[a]["blocks"], got[b]["blocks"])]
            rec["layer_input_grad_gap"] = {
                "ranks_vs_one_f32": block_gaps("ranks_f32", "one_f32")}
            if args.noise:
                rec["layer_input_grad_gap"]["one_f32_noise_vs_f32"] = \
                    block_gaps("one_f32_noise", "one_f32")
        print(json.dumps(rec), flush=True)


def main(argv=None) -> None:
    from repro_torch.launch.train import spawn_ranks

    args = parse(argv)
    spawn_ranks(_rank, argv, args.model, args.backend)


if __name__ == "__main__":
    main()
