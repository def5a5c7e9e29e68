"""Roofline terms of the port's dry-run records.

Three terms per (arch x shape x mesh) cell, in seconds, per device:
    compute    = dot_flops                / (bf16 peak FLOP/s of an H100)
    memory     = analytic HBM bytes       / (HBM bytes/s of an H100)
    collective = collective bytes         / (NVLink bytes/s one way)

The reader half of ``benchmarks/roofline.py`` over the records
``python -m repro_torch.launch.dryrun`` writes, with the H100 constants of
`repro_torch.launch.mesh`.  The port has no compiled module, so the HLO
parsers have no counterpart: the dry run traces rank 0 of the production
rank mesh, and its ``dot_flops`` is that rank's ``FlopCounterMode`` total
and its ``collectives`` that rank's `core.ranks.MeshComm` calls, in bytes
as the reference's parser charges the same ops (``total_bytes``,
ring-factored).  A record without collectives (none of the dry run's
``ok`` cells) leaves ``t_collective_s`` null and takes the bottleneck and
roofline fraction over compute and memory alone.

    PYTHONPATH=src python benchmarks_torch/roofline.py [results/dryrun]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def analytic_hbm_bytes(rec: dict) -> float:
    """Per-device HBM traffic model for one step (the reference's).

      train:   3x param reads (fwd + remat re-fwd + bwd) + grad write
               + AdamW state read/write (2 moments, f32, r+w)
               + activation streams: C_ACT x L x tokens x D (fwd+bwd)
               + CE logits (chunked): 2 passes over tokens x V_local x f32
      prefill: 1x param read + C_ACT/2 activation streams + KV-cache write
      decode:  active-param read + full KV/state-cache read + write of 1 tok
    """
    dev = max(rec.get("n_devices", 1), 1)
    P = rec.get("params", 0) / dev            # per-device param count
    P_act = rec.get("active_params", 0) / dev
    kind = rec.get("kind")
    B = rec.get("global_batch", 0)
    S = rec.get("seq_len", 0)
    # batch shards over pod x data = dev/16 (model axis = 16)
    toks_loc = B * S / max(dev / 16, 1) if kind != "decode" else \
        B * 1 / max(dev / 16, 1)
    arch = rec.get("arch", "")
    D = {"jamba-v0.1-52b": 4096, "deepseek-67b": 8192, "gemma2-9b": 3584,
         "qwen1.5-110b": 8192, "gemma2-2b": 2304, "whisper-tiny": 384,
         "qwen2-vl-72b": 8192, "granite-moe-1b-a400m": 1024,
         "kimi-k2-1t-a32b": 7168, "rwkv6-3b": 2560}.get(arch, 4096)
    L = {"jamba-v0.1-52b": 32, "deepseek-67b": 95, "gemma2-9b": 42,
         "qwen1.5-110b": 80, "gemma2-2b": 26, "whisper-tiny": 8,
         "qwen2-vl-72b": 80, "granite-moe-1b-a400m": 24,
         "kimi-k2-1t-a32b": 61, "rwkv6-3b": 32}.get(arch, 32)
    V_loc = {"jamba-v0.1-52b": 65536, "deepseek-67b": 102400,
             "gemma2-9b": 256000, "qwen1.5-110b": 152064,
             "gemma2-2b": 256000, "whisper-tiny": 51865,
             "qwen2-vl-72b": 152064, "granite-moe-1b-a400m": 49155,
             "kimi-k2-1t-a32b": 163840, "rwkv6-3b": 65536}.get(
        arch, 65536) / 16
    C_ACT = 16  # activation stream r/w coefficient per layer (fwd+bwd)
    if kind == "train":
        return (3 * P * 2 + P * 2          # param reads + grad write
                + P * 4 * 2 * 2            # mu, nu f32 read+write
                + C_ACT * L * toks_loc * D * 2
                + 2 * toks_loc * V_loc * 4)
    if kind == "prefill":
        cache = toks_loc * D * 2 * 2       # K+V bf16 write
        return P * 2 + (C_ACT / 2) * L * toks_loc * D * 2 + cache
    # decode: stream active params + the whole cache once
    cache_bytes = rec.get("memory", {}).get("argument_bytes", 0) - P * 10
    cache_bytes = max(cache_bytes, 0)
    return P_act * 2 + cache_bytes + toks_loc * D * 2 * L


def roofline_row(rec: dict) -> dict:
    cost = rec.get("cost", {})
    flops = rec.get("dot_flops") or cost.get("flops", 0.0)
    coll = rec.get("collectives")
    bytes_model = analytic_hbm_bytes(rec)
    t_c = flops / PEAK_FLOPS_BF16
    t_m = bytes_model / HBM_BW
    t_i = None if coll is None else coll.get("total_bytes", 0.0) / NVLINK_BW
    terms = [(t_c, "compute"), (t_m, "memory")]
    if t_i is not None:
        terms.append((t_i, "collective"))
    dominant = max(terms)
    # model FLOPs: 6 * N_active * tokens for train, 2 * N_active * tokens
    # for inference steps (per device)
    n_act = rec.get("active_params", 0)
    toks = rec.get("global_batch", 0) * (
        rec.get("seq_len", 0) if rec.get("kind") in ("train", "prefill")
        else 1)
    factor = 6 if rec.get("kind") == "train" else 2
    model_flops = factor * n_act * toks / max(rec.get("n_devices", 1), 1)
    bound = dominant[0]
    return {
        "cell": f"{rec['arch']} x {rec['shape']} x {rec['mesh']}",
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_i,
        "bottleneck": dominant[1],
        "hlo_flops": flops,
        "model_flops": model_flops,
        "useful_flop_frac": (model_flops / flops) if flops else 0.0,
        "roofline_frac": t_c / bound if bound > 0 else 0.0,
        "step_time_lb_s": bound,
    }


def main(argv=None) -> list[dict]:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = Path(argv[0] if argv else "results/dryrun")
    rows = []
    for p in sorted(out_dir.glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("status") != "ok" or "kind" not in rec:
            continue
        rows.append(roofline_row(rec))
    print("H100 terms per device, rank 0 of the rank mesh traced; t_coll "
          "is '-' where a record has no collectives: bound and roofl then "
          "take compute and memory alone")
    hdr = (f"{'cell':58s} {'t_comp':>9s} {'t_mem':>9s} {'t_coll':>9s} "
           f"{'bound':>10s} {'MF/HF':>6s} {'roofl':>6s}")
    print(hdr)
    for r in rows:
        t_i = r["t_collective_s"]
        print(f"{r['cell']:58s} {r['t_compute_s']:9.4f} "
              f"{r['t_memory_s']:9.4f} "
              f"{'-' if t_i is None else f'{t_i:9.4f}':>9s} "
              f"{r['bottleneck']:>10s} {r['useful_flop_frac']:6.2f} "
              f"{r['roofline_frac']:6.2f}")
    return rows


if __name__ == "__main__":
    main()
