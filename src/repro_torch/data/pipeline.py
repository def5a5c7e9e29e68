"""Deterministic, shardable token data pipeline.

The port of `repro.data.pipeline`: the same numpy code, so a batch's
tokens and labels equal the reference's bit for bit; `batch` hands them
over as int32 tensors on ``device`` (the card unless the caller asks for
the CPU).  The pipeline is *stateless given (seed, step)*: any worker can
reproduce any step's global batch, so checkpoint-restart saves no
data-loader state.  Per-host sharding slices the global batch by host id.

Sources:
  * SyntheticLM  — power-law token stream with induced bigram structure
                   (so CE actually decreases while training).
  * TextFile     — byte-level tokens from a local file, deterministic chunks.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.api.spec import require_device
from repro_torch.configs.base import ShapeCfg


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    kind: str = "synthetic"          # "synthetic" | "file"
    path: Optional[str] = None


def _local(batch: int, n_hosts: int) -> int:
    if batch % n_hosts:
        raise ValueError(f"batch {batch} does not split over {n_hosts} hosts")
    return batch // n_hosts


def _pair(toks: np.ndarray, dev: torch.device) -> dict:
    return {
        "tokens": torch.as_tensor(toks[:, :-1].astype(np.int32), device=dev),
        "labels": torch.as_tensor(toks[:, 1:].astype(np.int32), device=dev),
    }


class SyntheticLM:
    """Markov-ish synthetic stream: next ~ mix(bigram(prev), powerlaw)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        self._perm = rng.permutation(V)          # bigram successor table
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()

    def batch(self, step: int, batch: int, seq: int,
              host_id: int = 0, n_hosts: int = 1, device="cuda") -> dict:
        """Global batch for `step`, sliced for this host."""
        dev = require_device(device)
        local = _local(batch, n_hosts)
        seed = (self.cfg.seed * 1_000_003 + step) * 97 + host_id
        rng = np.random.default_rng(seed)
        base = rng.choice(self.cfg.vocab_size, size=(local, seq + 1),
                          p=self._p)
        # induce learnable structure: 50% of tokens follow the bigram table
        # (sequential so the bigram holds on the *emitted* stream)
        follow = rng.random((local, seq)) < 0.5
        toks = base.copy()
        for t in range(1, seq + 1):
            nxt = self._perm[toks[:, t - 1]]
            toks[:, t] = np.where(follow[:, t - 1], nxt, base[:, t])
        return _pair(toks, dev)


class TextFile:
    """Byte-tokenized local file, deterministic chunk addressing."""

    def __init__(self, cfg: DataConfig):
        data = Path(cfg.path).read_bytes()
        self._arr = np.frombuffer(data, dtype=np.uint8)
        self.cfg = cfg

    def batch(self, step: int, batch: int, seq: int,
              host_id: int = 0, n_hosts: int = 1, device="cuda") -> dict:
        dev = require_device(device)
        local = _local(batch, n_hosts)
        n = len(self._arr) - seq - 1
        seed = (self.cfg.seed * 1_000_003 + step) * 97 + host_id
        rng = np.random.default_rng(seed)
        starts = rng.integers(0, max(n, 1), size=local)
        toks = np.stack([self._arr[s:s + seq + 1] for s in starts])
        return _pair(toks, dev)


def make_source(cfg: DataConfig):
    if cfg.kind == "file":
        return TextFile(cfg)
    return SyntheticLM(cfg)


def batches(source, shape: ShapeCfg, start_step: int = 0,
            host_id: int = 0, n_hosts: int = 1,
            device="cuda") -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, source.batch(step, shape.global_batch, shape.seq_len,
                                 host_id, n_hosts, device)
        step += 1
