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
machine without a GPU needs ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --reduced --batch 4 --prompt-len 32 --gen 32 --device cpu
"""
from __future__ import annotations

import argparse
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


def main(argv=None) -> None:
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
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if cfg.enc_dec is not None:
        ap.error(f"{cfg.name} is an encoder-decoder; this demo drives "
                 "decoder-only archs")
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    gen = torch.Generator(device=model.device).manual_seed(args.seed + 1)
    B, P = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=model.device)
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
