"""LANGUAGE-MODEL inference demo: batched prefill + decode for
decoder-only transformer archs.

This is NOT the p-bit sampling service, which runs as ``python -m
repro_torch.serve``.  This module is the LM-workload demo that exercises
the transformer stack (every decoder-only family; an encoder-decoder
config is refused, as the reference asserts): it builds a model from the registry with seeded
random weights (drawn on the device), runs a batched prefill of random
prompts, grafts the prefill cache into a ``max_seq`` decode cache and
decodes token by token under ``torch.inference_mode()``.  The port of
``python -m repro.launch.serve``, with ``--device`` (default ``cuda``: a
machine without a GPU needs ``--device cpu``).  ``--ranks N --backend
{nccl,gloo} --data-model D M`` serves the dense, mixture-of-experts and
hybrid families sharded across N processes, one a position of the rank
mesh (`generate_ranked`; the decode cache's positions, and Mamba's state
channels, split over "model"); rank 0 prints.  `generate_ranked` also
serves RWKV, the vision-language model (its vision prefix as
``frontend_embeds``) and Whisper (its frames) across processes.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --reduced --batch 4 --prompt-len 32 --gen 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --reduced --ranks 2 --backend gloo \\
      --data-model 1 2 --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.models import transformer
from repro_torch.models.model import Model, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def graft(cache: dict, pcache: dict) -> dict:
    """Copy every leaf of the prefill cache into the (zero) decode cache —
    the reference's zero pad of each leaf to the decode leaf's shape: the
    K/V's sequence axis grows to ``max_seq``; the prefix layers' caches
    and the Mamba / RWKV state leaves, whose shapes already match, are
    copied whole — and return the decode cache."""
    def walk(dst, src):
        if isinstance(src, dict):
            for k, v in src.items():
                walk(dst[k], v)
        elif isinstance(src, (list, tuple)):
            for d, v in zip(dst, src):
                walk(d, v)
        else:
            dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
    walk(cache, pcache)
    return cache


def graft_ranked(cache: dict, pcache: dict) -> dict:
    """`graft` for per-rank DTensor caches (a rank mesh): each prefill
    leaf gathered whole, zero-padded to the decode leaf's shape, and the
    decode leaf's block of it copied into this rank's block — the two
    caches are split differently (prefill's K/V by heads, decode's by
    position)."""
    from repro_torch.models import sharding as shd

    full = shd.full_tree(pcache)
    dst = dict(shd.leaves_with_path(cache))
    for key, src in shd.leaves_with_path(full):
        d = dst[key]
        whole = torch.zeros(d.shape, dtype=d.dtype, device=src.device)
        whole[tuple(slice(0, n) for n in src.shape)] = src
        comm = shd.rank_comm_of(d)
        for dim, axes in shd.dims_axes(d).items():
            whole = comm.block(whole, dim, axes)
        d.to_local().copy_(whole)
    return cache


def generate(model: Model, params: dict, prompts: torch.Tensor, gen: int,
             max_seq: int, temperature: float = 1.0,
             generator: torch.Generator | None = None) -> dict:
    """Prefill ``prompts`` (B, P), graft, then decode ``gen - 1`` tokens.

    The first token is the prefill logits' argmax; each next one is the
    argmax (``temperature`` 0) or a draw from softmax(logits /
    temperature) by ``generator``, equal in distribution to the
    reference's ``jax.random.categorical``.  Returns the tokens (B, gen)
    and the host-clock seconds of the prefill, the graft and each decode
    step (each ended by a device synchronise)."""
    cfg, dev = model.cfg, model.device
    B, P = prompts.shape
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, pcache = transformer.prefill(params, cfg, prompts)
        _sync(dev)
        t1 = time.perf_counter()
        cache = graft(model.init_cache(B, max_seq), pcache)
        del pcache
        _sync(dev)
        t2 = time.perf_counter()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_toks, step_s = [tok], []
        for i in range(gen - 1):
            ts = time.perf_counter()
            logits, cache = model.decode_step(params, tok, P + i, cache)
            if temperature > 0:
                probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out_toks.append(tok)
            _sync(dev)
            step_s.append(time.perf_counter() - ts)
    return {"tokens": torch.cat(out_toks, dim=1), "prefill_s": t1 - t0,
            "graft_s": t2 - t1, "decode_step_s": step_s}


def generate_ranked(cfg, mesh, params: dict, prompts: torch.Tensor,
                    gen: int, max_seq: int, device,
                    temperature: float = 1.0,
                    generator: torch.Generator | None = None,
                    frontend_embeds: torch.Tensor | None = None) -> dict:
    """`generate` on a rank mesh through the sharded steps
    (`launch.steps.make_prefill_step` / `make_serve_step`): ``params``
    per-rank DTensors, ``prompts`` (B, P) and ``frontend_embeds`` (the
    vision prefix's or the encoder's frames, (B, S_f, D)) the same on
    every rank.  An encoder-decoder's prefill is its teacher-forced
    forward's last logits; the cross cache is then filled from the
    frames (`whisper.fill_cross`) and the prompt decoded token by token
    into the self cache.  Each token is drawn from the logits gathered
    whole on every rank (the same draws everywhere: ``generator`` seeded
    alike on each).  Returns what `generate` does, plus the logits of
    every step (B, V each, float32), the collectives' record of the
    decode steps and the decode cache (the rank's blocks, as
    DTensors)."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import steps
    from repro_torch.models import sharding as shd
    from repro_torch.models import whisper

    B, P = prompts.shape
    pre = steps.make_prefill_step(cfg, ShapeCfg("prefill", P, B, "prefill"),
                                  mesh, device=device)
    dec = steps.make_serve_step(cfg, ShapeCfg("decode", max_seq, B,
                                              "decode"), mesh, device=device)
    dev, comm = pre.model.device, shd.rank_comm(mesh, device)
    bspec = pre.in_specs[1]
    tok_spec = dec.in_specs[1]

    def whole(x):
        with shd.use_mesh(mesh, dev):
            return shd.full_tree(x)

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        return torch.argmax(logits, dim=-1)[:, None]

    def toks_of(t):
        return shd.shard_tree(t.to(torch.int32), tok_spec, mesh, dev)

    with torch.no_grad():
        t0 = time.perf_counter()
        feed = {"tokens": prompts}
        if frontend_embeds is not None:
            feed["frontend_embeds"] = frontend_embeds
        batch = shd.shard_tree(feed, bspec, mesh, dev)
        logits, pcache = ((pre.fn(params, batch), None) if cfg.enc_dec
                          else pre.fn(params, batch))
        with shd.use_mesh(mesh, dev):
            cache = shd.shard_tree(pre.model.init_cache(B, max_seq),
                                   dec.in_specs[3], mesh, dev)
            if cfg.enc_dec:
                whisper.fill_cross(params, cfg, shd.local_block(
                    batch["frontend_embeds"]), cache)
        if cfg.enc_dec:
            for i in range(P):
                dec.fn(params, toks_of(prompts[:, i:i + 1]), i, cache)
        _sync(dev)
        t1 = time.perf_counter()
        if pcache is not None:
            with shd.use_mesh(mesh, dev):
                cache = graft_ranked(cache, pcache)
        del pcache
        _sync(dev)
        t2 = time.perf_counter()
        last = whole(logits)[:, -1].float()
        all_logits, tok = [last], pick(last)
        out_toks, step_s = [tok], []
        comm.reset()
        for i in range(gen - 1):
            ts = time.perf_counter()
            logits, cache = dec.fn(params, toks_of(tok), P + i, cache)
            last = whole(logits)[:, -1].float()
            tok = pick(last)
            all_logits.append(last)
            out_toks.append(tok)
            _sync(dev)
            step_s.append(time.perf_counter() - ts)
    return {"tokens": torch.cat(out_toks, dim=1), "prefill_s": t1 - t0,
            "graft_s": t2 - t1, "decode_step_s": step_s,
            "logits": all_logits, "decode_comm": comm.record(),
            "cache": cache}


def parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Language-model inference demo (decoder-only archs, "
                    "batched prefill + decode).  For the p-bit sampling "
                    "service, use `python -m repro_torch.serve` instead.")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes of a torch.distributed group, one a "
                         "position of the --data-model rank mesh")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' backend (default: nccl on CUDA, gloo "
                         "on the CPU)")
    ap.add_argument("--data-model", type=int, nargs=2, default=[1, 1],
                    help="the rank mesh's (data, model) shape")
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "gloo" if args.device == "cpu" else "nccl"
    if args.ranks is not None and math.prod(args.data_model) != args.ranks:
        ap.error(f"--ranks {args.ranks} needs --data-model D M with D x M "
                 f"= {args.ranks}")
    if get_config(args.arch).enc_dec is not None:
        ap.error(f"{args.arch} is an encoder-decoder; this demo drives "
                 "decoder-only archs")
    return args


def main(argv=None) -> None:
    args = parse(argv)
    if args.ranks is not None:
        from repro_torch.launch.train import spawn_ranks
        spawn_ranks(_serve, argv, args.ranks, args.backend)
        return
    _serve(argv)


def _serve(argv=None) -> None:
    args = parse(argv)
    ranked = args.ranks is not None
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if ranked:
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.launch.train import rank_device
        from repro_torch.models import sharding as shd
        args.device = rank_device(args.backend, args.device)
        mesh = mesh_mod.make_host_mesh(*args.data_model, ranks=True)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    gen = torch.Generator(device=model.device).manual_seed(args.seed + 1)
    B, P = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=model.device)
    if ranked:
        from repro_torch.configs.base import ShapeCfg
        from repro_torch.launch import steps
        pspec = steps.make_prefill_step(
            cfg, ShapeCfg("prefill", P, B, "prefill"), mesh,
            device=model.device).in_specs[0]
        params = shd.shard_tree(params, pspec, mesh, model.device)
        out = generate_ranked(cfg, mesh, params, prompts, args.gen,
                              args.max_seq, model.device, args.temperature,
                              gen)
        if torch.distributed.get_rank() != 0:
            return
        print(f"{args.ranks} ranks, mesh {dict(mesh.shape)}, "
              f"{out['decode_comm']['transport']}")
    else:
        out = generate(model, params, prompts, args.gen, args.max_seq,
                       args.temperature, gen)
    print(f"prefill {B}x{P} in {out['prefill_s']:.2f}s "
          f"(graft {out['graft_s'] * 1e3:.1f} ms)")
    dt = sum(out["decode_step_s"])
    print(f"decoded {args.gen - 1} steps x {B} seqs in {dt:.2f}s "
          f"({(args.gen - 1) * B / max(dt, 1e-9):.1f} tok/s)")
    print("sample token ids:", out["tokens"][0, :16].tolist())


if __name__ == "__main__":
    main()
