"""How far bf16 logits on a rank mesh sit from one process's, next to how
far one process's bf16 logits sit from its float32 logits.

For each model (reduced configs widened to ``--width``, bf16, seed 0's
parameters) two ranks on a 1 x ``--model`` mesh run `launch.serve.
generate_ranked` (greedy, `--gen` tokens after a 16-token prompt, B=4),
and every rank runs the same steps in one process in bf16 and in float32.
Rank 0 prints one JSON line a model and step: the bf16 logits' RMS, the
largest |ranks - one process| and |one process bf16 - float32|, and
whether the greedy tokens still agree (after a parting the inputs
differ).  This is the yardstick of `chip_smoke.py`'s logit gate
(`_lmr_logit_tol`).

  PYTHONPATH=src python benchmarks_torch/lm_ranks_logits.py --device cpu
  PYTHONPATH=src python benchmarks_torch/lm_ranks_logits.py   # one card
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

ARCHS = ("jamba-v0.1-52b", "kimi-k2-1t-a32b", "granite-moe-1b-a400m",
         "gemma2-2b")
B, PROMPT, MAX_SEQ = 4, 16, 32


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--gen", type=int, default=5)
    ap.add_argument("--model", type=int, default=2,
                    help="ranks on the model axis (the world size)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _one_process(cfg, params, prompts, gen, device):
    """Every step's last logits of `serve.generate`'s greedy steps."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    model = build_model(cfg, device=device)
    with torch.no_grad():
        logits, pcache = transformer.prefill(params, cfg, prompts)
        cache = serve.graft(model.init_cache(B, MAX_SEQ), pcache)
        out = [logits[:, -1].float()]
        for i in range(gen - 1):
            tok = out[-1].argmax(-1)[:, None]
            logits, cache = model.decode_step(params, tok, PROMPT + i, cache)
            out.append(logits[:, -1].float())
    return out


def _rank(argv) -> None:
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeCfg, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import rank_device
    from repro_torch.models import sharding as shd
    from repro_torch.models.model import build_model

    args = parse(argv)
    device = rank_device(args.backend, args.device)
    mesh = make_host_mesh(1, args.model, ranks=True)
    for arch in args.archs:
        w = args.width
        cfg = reduced(get_config(arch), d_model=w, num_heads=w // 64,
                      num_kv_heads=w // 128, head_dim=64, dtype="bfloat16",
                      vocab_size=4096)
        params = build_model(cfg, device=device).init(0)
        prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                                generator=torch.Generator().manual_seed(3)
                                ).to(device)
        one = _one_process(cfg, params, prompts, args.gen, device)
        f32 = _one_process(dataclasses.replace(cfg, dtype="float32"),
                           shd.map_with_path(lambda _, x: x.float(), params),
                           prompts, args.gen, device)
        pspec = steps.make_prefill_step(
            cfg, ShapeCfg("p", PROMPT, B, "prefill"), mesh,
            device=device).in_specs[0]
        got = serve.generate_ranked(
            cfg, mesh, shd.shard_tree(params, pspec, mesh, device), prompts,
            args.gen, MAX_SEQ, device, temperature=0.0)["logits"]
        agree = torch.ones(B, dtype=torch.bool, device=device)
        for i in range(args.gen):
            if dist.get_rank() == 0:
                print(json.dumps({
                    "arch": arch, "width": w, "step": i,
                    "rms": float(one[i].pow(2).mean().sqrt()),
                    "ranks_vs_one": float((got[i] - one[i])[agree].abs()
                                          .max()) if agree.any() else None,
                    "one_bf16_vs_f32": float((one[i] - f32[i]).abs().max()),
                    "rows_agreeing": int(agree.sum())}), flush=True)
            agree &= got[i].argmax(-1) == one[i].argmax(-1)


def main(argv=None) -> None:
    from repro_torch.launch.train import spawn_ranks

    args = parse(argv)
    spawn_ranks(_rank, argv, args.model, args.backend)


if __name__ == "__main__":
    main()
