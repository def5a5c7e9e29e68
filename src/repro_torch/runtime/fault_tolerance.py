"""Fault-tolerance runtime: the control-plane logic of long unattended runs.

* `StragglerWatchdog` — EWMA of step times; flags steps slower than
  ``threshold`` x the moving average and calls back.
* `retry_step` — retries a step function on `TransientError` with capped,
  decorrelated-jitter backoff, and falls back to ``on_permanent``
  (normally: restore from a checkpoint).  Jitter matters under
  multi-tenancy: many tenants retrying one flapped link on the same
  deterministic schedule re-herd at exactly the same instants.
* `Heartbeat` — a liveness file per host; a launcher finds dead hosts by
  the time in it.
* `ElasticState` — re-homes training state onto a new mesh (the node
  count changed): each leaf's spec is checked against the new mesh, then
  the leaf is placed.  The port's meshes are logical devices of one card
  (`launch.mesh`), so placing a leaf puts it whole on the named device.

Counterpart of ``repro.runtime.fault_tolerance``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random as _random
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup: int = 5,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.ewma: Optional[float] = None
        self.count = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = (self.count > self.warmup and
                dt > self.threshold * self.ewma)
        if slow:
            self.flagged.append((step, dt))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
            # do not poison the average with the outlier
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class TransientError(RuntimeError):
    """Raised by step functions for retryable failures (link flap, etc.)."""


def retry_step(fn: Callable[[], Any], *, max_retries: int = 3,
               backoff_s: float = 0.1, max_backoff_s: float = 30.0,
               jitter: str = "decorrelated",
               rng: Optional[_random.Random] = None,
               on_permanent: Optional[Callable[[BaseException], Any]] = None,
               sleep=time.sleep) -> Any:
    """Run ``fn``, retrying `TransientError` with capped, jittered backoff.

    ``jitter="decorrelated"`` (the default) draws each delay uniformly
    from [backoff_s, 3 * previous_delay], capped at ``max_backoff_s`` —
    concurrent tenants retrying the same flapped link spread out instead
    of herding in lockstep at backoff_s * 2**attempt.  ``jitter="none"``
    keeps the deterministic exponential schedule (still capped).  ``rng``
    is an injectable `random.Random` for reproducible tests; delays never
    influence results, only pacing.
    """
    if jitter not in ("decorrelated", "none"):
        raise ValueError(
            f"jitter must be 'decorrelated' or 'none', got {jitter!r}")
    draw = (rng or _random).uniform
    last: Optional[BaseException] = None
    prev = backoff_s
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except TransientError as e:  # pragma: no branch
            last = e
            if attempt < max_retries:
                if jitter == "none":
                    delay = min(backoff_s * (2 ** attempt), max_backoff_s)
                else:
                    delay = min(max_backoff_s,
                                draw(backoff_s, max(3.0 * prev, backoff_s)))
                    prev = delay
                sleep(delay)
    if on_permanent is not None:
        return on_permanent(last)
    raise last


class Heartbeat:
    def __init__(self, directory: str | Path, host_id: int):
        self.path = Path(directory) / f"host_{host_id}.alive"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int) -> None:
        # tmp + rename: a reader (or a crash) must never observe a
        # partially-written heartbeat — the liveness file is the one
        # thing that must stay parseable while its writer is dying
        tmp = self.path.with_name(self.path.name + ".tmp")
        tmp.write_text(json.dumps({"step": step, "t": time.time()}))
        os.replace(tmp, self.path)

    @staticmethod
    def dead_hosts(directory: str | Path, timeout_s: float,
                   now: Optional[float] = None) -> list[int]:
        if now is None:   # `or` would treat an explicit now=0.0 as unset
            now = time.time()
        dead = []
        for p in sorted(Path(directory).glob("host_*.alive")):
            host = int(p.stem.split("_")[1])
            try:
                t = float(json.loads(p.read_text())["t"])
            except (ValueError, KeyError, TypeError, OSError):
                # an unparsable heartbeat (torn write from a host dying
                # mid-beat, truncated file) is evidence of death, not an
                # excuse to crash the launcher's health sweep
                dead.append(host)
                continue
            if now - t > timeout_s:
                dead.append(host)
        return dead


def _check_spec(key: str, shape: tuple, spec, mesh) -> None:
    """Raise unless ``mesh`` can hold a leaf of ``shape`` under ``spec``:
    no more entries than dims, every axis in the mesh, each axis used
    once, and every sharded dim divisible by its axes' product."""
    from repro_torch.models.sharding import NamedSharding, _spec_axes

    if len(spec) > len(shape):
        raise ValueError(f"{key}: spec {spec} has more entries than the "
                         f"leaf's {len(shape)} dims")
    axes = [a for part in spec for a in _spec_axes(part)]
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"{key}: spec {spec} names axes {missing} the "
                         f"mesh {dict(mesh.shape)} lacks")
    if len(set(axes)) != len(axes):
        raise ValueError(f"{key}: spec {spec} uses a mesh axis twice")
    try:
        NamedSharding(mesh, spec).shard_shape(shape)
    except ValueError as e:
        raise ValueError(f"{key}: {e} on mesh {dict(mesh.shape)}") from None


@dataclasses.dataclass
class ElasticState:
    """Re-homes training state onto a new mesh (node count changed).

    Because checkpoints store logical arrays and the data pipeline is
    stateless, the procedure is: rebuild mesh -> recompute specs from
    the same logical rules -> check and place.  Works for both shrink
    (lost pod) and grow (pod returned).
    """
    ckpt_dir: str

    def reshard(self, tree: Any, mesh, specs: Any, device="cuda") -> Any:
        """``tree``'s leaves (tensors or arrays) checked against their
        specs on ``mesh`` and placed on ``device``."""
        from repro_torch.api.spec import require_device
        from repro_torch.models.sharding import (leaves_with_path,
                                                 map_with_path)

        dev = require_device(device)
        by_key = dict(leaves_with_path(specs))

        def one(key, x):
            _check_spec(key, tuple(x.shape), by_key[key], mesh)
            if isinstance(x, torch.Tensor):
                return x.detach().to(dev)
            return torch.as_tensor(np.array(x)).to(dev)

        return map_with_path(one, tree)

    def resume(self, mesh, make_specs, target_shapes: Any, device="cuda"
               ) -> tuple[int, Any]:
        """The latest checkpoint in the target's structure: each leaf
        found by its key, its shape checked against the target's, its
        spec (``make_specs(target_shapes)``) against ``mesh``, and placed
        on ``device`` in the target's dtype."""
        from repro_torch.api.spec import require_device
        from repro_torch.checkpoint import checkpoint as ckpt
        from repro_torch.models.sharding import (leaves_with_path,
                                                 map_with_path)

        dev = require_device(device)
        step, arrays, _ = ckpt.load(self.ckpt_dir)
        by_key = dict(leaves_with_path(make_specs(target_shapes)))

        def one(key, leaf):
            if key not in arrays:
                raise KeyError(f"checkpoint missing {key}")
            val = torch.as_tensor(arrays[key])
            if tuple(val.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: stored {tuple(val.shape)}, "
                                 f"target {tuple(leaf.shape)}")
            _check_spec(key, tuple(val.shape), by_key[key], mesh)
            return val.to(device=dev, dtype=leaf.dtype)

        return step, map_with_path(one, target_shapes)
