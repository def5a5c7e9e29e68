"""Deterministic fault schedules for the serving layer.

"We handle shard loss" is not a property CI can check; "launch #3 loses
device 1, launch #1 sees two link flaps, launch #2 runs 50 ms slow — and
every admitted request still completes, bit-identical to a clean run" is.
A `FaultPlan` scripts exactly that: a list of events keyed by the
service's *launch sequence number* (deterministic — it advances once per
batched launch, never with wall time), injected by a `FaultInjector` the
`SamplerService` consults at the top of every launch attempt.

Event kinds
-----------
* ``kill_shard`` — mark a mesh device dead in the service's
  `ShardHealthMonitor`; the next health check raises `ShardLostError`
  and the service walks the degradation ladder.
* ``link_flap`` — raise `TransientError` for the next ``flaps`` launch
  attempts; `retry_step`'s jittered backoff absorbs it.
* ``straggler`` — return an extra ``delay_s`` the service sleeps before
  the launch, which the `StragglerWatchdog` then flags.

Plans serialize to/from JSON (a list of event objects) so CI jobs and
benchmarks can keep schedules as data:

    [{"step": 1, "kind": "link_flap", "flaps": 2},
     {"step": 2, "kind": "straggler", "delay_s": 0.05},
     {"step": 3, "kind": "kill_shard", "shard": 1}]

Counterpart of ``repro.serve.faultplan`` (pure Python, the same plans).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable

from repro_torch.runtime.fault_tolerance import TransientError

KINDS = ("kill_shard", "link_flap", "straggler")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int                 # launch sequence number the event fires at
    kind: str                 # one of KINDS
    shard: int | None = None  # kill_shard: device id to kill
    flaps: int = 1            # link_flap: consecutive attempts that raise
    delay_s: float = 0.0      # straggler: injected latency in seconds

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"pick from {KINDS}")
        if self.kind == "kill_shard" and self.shard is None:
            raise ValueError("kill_shard needs shard=<device id>")
        if self.step < 0:
            raise ValueError(f"step must be >= 0, got {self.step}")
        if self.flaps < 1:
            raise ValueError(f"flaps must be >= 1, got {self.flaps}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    events: tuple[FaultEvent, ...] = ()

    @staticmethod
    def make(events: Iterable[FaultEvent]) -> "FaultPlan":
        return FaultPlan(tuple(sorted(events, key=lambda e: e.step)))

    def events_at(self, step: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.events],
                          indent=None)

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        raw = json.loads(text)
        if not isinstance(raw, list):
            raise ValueError("fault plan JSON must be a list of events")
        return FaultPlan.make(FaultEvent(**e) for e in raw)


class FaultInjector:
    """Drives a `FaultPlan` against a running service.

    ``on_launch(step, service)`` is called at the top of every launch
    *attempt*.  Each event fires exactly once (retries of the same launch
    re-enter ``on_launch`` with the same step, so firing is tracked per
    event, not per call) — except link flaps, which by design raise on
    the next ``flaps`` attempts and then clear, letting the retry
    succeed.  Returns the straggler delay to sleep, raises
    `TransientError` while a flap is active.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired: set[int] = set()   # indices into plan.events
        self._flaps_left = 0
        self.log: list[tuple[int, str]] = []

    def on_launch(self, step: int, service) -> float:
        delay = 0.0
        for idx, ev in enumerate(self.plan.events):
            if ev.step != step or idx in self._fired:
                continue
            self._fired.add(idx)
            self.log.append((step, ev.kind))
            if ev.kind == "kill_shard":
                service.monitor.mark_dead(ev.shard)
            elif ev.kind == "link_flap":
                self._flaps_left += ev.flaps
            elif ev.kind == "straggler":
                delay += ev.delay_s
        if self._flaps_left > 0:
            self._flaps_left -= 1
            raise TransientError(
                f"scheduled link flap at launch {step} "
                f"({self._flaps_left} more)")
        return delay
