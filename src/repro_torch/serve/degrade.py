"""Shard-loss detection and the serving degradation ladder.

The sharded Session distributes Chimera cell-row bands over a mesh of
logical devices (`core.distributed.Mesh`; on one card a device of the
mesh is a row band); a production service must survive losing one of
those devices mid-stream.  Detection and policy live here, action lives
in `service.SamplerService`:

1. **healthy** — requests run on the full mesh.
2. **degraded** — `surviving_mesh` re-plans the row partition over the
   devices that still heartbeat; cached Sessions built against the old
   mesh are invalidated and rebuilt lazily on the smaller mesh.
3. **single** — fewer than two survivors: drop ``mesh=`` entirely and run
   the bit-exact single-device path.  Because the barrier sync policy
   makes sharded and single-device Sessions produce *identical* spins,
   degradation changes latency, never results.

In-flight requests at the moment of loss are replayed: every launch's
random inputs derive from (service seed, launch sequence number), so the
replay on the degraded mesh reproduces exactly what the healthy launch
would have returned.  Counterpart of ``repro.serve.degrade``.
"""
from __future__ import annotations

import time
from typing import Iterable, Optional

from repro_torch.runtime.fault_tolerance import Heartbeat


class ShardLostError(RuntimeError):
    """A device in the serving mesh stopped heartbeating (or was killed by
    the fault harness); the launch must be replayed on a re-planned mesh."""

    def __init__(self, dead: Iterable[int]):
        self.dead = frozenset(int(d) for d in dead)
        super().__init__(f"shards lost: {sorted(self.dead)}")


class ShardHealthMonitor:
    """Union of two liveness signals, one query surface.

    * ``mark_dead`` — programmatic kills: the deterministic fault harness
      (`serve.faultplan`) and, in a real deployment, the cluster
      scheduler's preemption notice.
    * heartbeat files — each shard host runs a `Heartbeat`; a missing or
      stale (or torn, see `Heartbeat.dead_hosts`) file marks that host's
      device dead after ``timeout_s``.

    `dead_shards` is consulted before every launch; the service compares
    it against the current mesh's device ids.
    """

    def __init__(self, heartbeat_dir: Optional[str] = None,
                 timeout_s: float = 10.0,
                 time_fn=time.time):
        self.heartbeat_dir = heartbeat_dir
        self.timeout_s = timeout_s
        self._time = time_fn
        self._marked: set[int] = set()

    def mark_dead(self, shard_id: int) -> None:
        self._marked.add(int(shard_id))

    def mark_alive(self, shard_id: int) -> None:
        """Scheduler gave the device back (grow path — the service picks
        it up at the next cache rebuild, not retroactively)."""
        self._marked.discard(int(shard_id))

    def dead_shards(self) -> frozenset[int]:
        dead = set(self._marked)
        if self.heartbeat_dir is not None:
            dead.update(Heartbeat.dead_hosts(
                self.heartbeat_dir, self.timeout_s, now=self._time()))
        return frozenset(dead)
