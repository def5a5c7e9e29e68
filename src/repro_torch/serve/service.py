"""`SamplerService` — the resilient multi-tenant p-bit sampling service.

One process, many tenants, one chip model: requests carry a (small)
Chimera problem; the service embeds each into a shape bucket
(`serve.cache`), multiplexes compatible requests onto the *chains* axis
of a single launch (one launch anneals every tenant's chains at once),
and returns each tenant its slice of the spins.  On the card an
unsharded bucket's launch is one launch of the slot-layout kernel K1
(`kernels/sweep_fused.py::sweep_sparse`); a meshed bucket's runs through
the sharded engine (K5, or K1 per band where K5 has no body).

Control plane
-------------
* **Admission** — a bounded FIFO; `submit` raises `AdmissionError` when
  the queue is full (backpressure, never silent drops) and
  `CircuitOpenError` for tenants whose breaker is open.  Every admitted
  request is eventually *resolved* — completed, or terminally failed
  with a reason — there is no path that loses a ticket.
* **Deadlines** — per-request; requests whose deadline passes while
  queued resolve as ``deadline_exceeded`` without burning a launch, and
  late completions are flagged and fed to the tenant's circuit breaker.
* **Batching** — the queue head defines the launch group: every queued
  request with the same `program_digest` (same bucket chip, betas, clamp
  *mask*; clamp *values* are per-chain and free to differ) packs into
  the launch until ``capacity_chains`` is reached, FIFO order preserved
  for the rest.
* **Determinism** — launch ``seq`` numbers the batched launches; every
  random input of a launch derives from ``launch_seed(seed, seq)``.  An
  identical admission sequence therefore produces identical results
  regardless of retries, replays, or mesh degradation (barrier-sync
  sharding is bit-exact vs single device), which is how the
  fault-schedule tests can demand bit-identical output from a faulted
  meshed run and a clean single-device run.

Data plane resilience (see `serve.degrade`, `serve.faultplan`)
--------------------------------------------------------------
`TransientError` (link flap) is absorbed by `retry_step` with jittered
backoff; `ShardLostError` walks the degradation ladder (re-plan the row
partition on survivors, else single-device) and *replays* the launch
from its recorded ``seq`` — in-flight requests survive shard loss.  A
`StragglerWatchdog` flags slow launches.  ``healthz()``/``readyz()``
are the probe surface.

The service is deliberately synchronous: callers drive it with
``pump()`` (one launch) or ``drain()`` (until the queue is empty), which
keeps every test deterministic.

Counterpart of ``repro.serve.service``.  Where it differs:

* the bucket spec names ``fused_sparse`` wherever the port's
  `api.resolve_backend` admits it — unsharded with counter or lfsr
  noise; on a mesh with counter noise under a fused-compatible `Sync` —
  and ``sparse`` elsewhere, where the reference always names ``sparse``.
  The two are bit-equal siblings in the port; the choice decides which
  engine computes a launch (the kernel on the card), never its result;
* a launch's seed is the counter hash of (seed, seq) (`launch_seed`,
  as `core.cd.epoch_seed` derives an epoch's), and its spins and then
  its noise state are drawn from one `torch.Generator` seeded with it on
  the Session's device, as `Session.init_state` draws them;
  `RequestResult.launch_key` holds that seed.  The reference folds the
  launch number into a key and splits it;
* a bucket's mismatch is drawn from a generator seeded with the counter
  hash of (mismatch_seed, rows * 1009 + cols), so it equals the
  reference's in distribution only;
* ``transient_retries`` counts the retries of `TransientError` only;
  the reference also counts the attempt that replays a launch after a
  shard loss (both count it in ``launch_attempts_total`` and a result's
  ``attempts``);
* ``device=`` (default ``"cuda"``) takes the place of ``interpret=``;
  the mesh is the port's `core.distributed.Mesh` of logical device ids.
"""
from __future__ import annotations

import dataclasses
import random as _random
import time
from collections import Counter, deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.api.spec import require_device
from repro_torch.core.cd import epoch_seed
from repro_torch.core.chimera import ChimeraGraph
from repro_torch.core.distributed import surviving_mesh
from repro_torch.core.hardware import HardwareConfig, sample_mismatch_sparse
from repro_torch.runtime.fault_tolerance import StragglerWatchdog, retry_step
from repro_torch.serve.cache import (
    DEFAULT_BUCKETS,
    CacheEntry,
    Embedding,
    SessionCache,
    bucket_shape,
    embed_graph,
    embed_program,
    make_bucket_graph,
    program_digest,
)
from repro_torch.serve.degrade import ShardHealthMonitor, ShardLostError

# counter-hash streams of the service's seeds, beside `core.cd`'s
# INIT / DATA / EVAL streams (0, 1, 2)
LAUNCH_STREAM, BUCKET_STREAM = 3, 4


def launch_seed(seed: int, seq: int) -> int:
    """The 32-bit seed of launch ``seq``: the counter hash of (seed, seq),
    a fixed integer mix, so a replayed launch redraws the same state."""
    return epoch_seed(seed, LAUNCH_STREAM, seq)


class ServiceError(RuntimeError):
    """Base class for request-rejection errors raised by `submit`."""


class AdmissionError(ServiceError):
    """Queue full — backpressure; the client should retry later."""


class CircuitOpenError(ServiceError):
    """This tenant's circuit breaker is open (repeated deadline misses)."""


@dataclasses.dataclass
class SampleRequest:
    """One tenant's problem: a Chimera graph plus edge-list programming.

    ``betas`` (an explicit (S,) float array) overrides the
    ``n_sweeps``/``beta`` pair.  ``clamp_mask`` is (N,) over the
    *request* graph; ``clamp_values`` is (chains, N) — per-chain data,
    the multiplexing axis (think: same RBM chip, each chain clamped to a
    different tenant query).
    """

    tenant: str
    graph: ChimeraGraph
    J_codes: Any
    h_codes: Any
    chains: int = 1
    n_sweeps: int = 8
    beta: float = 1.0
    betas: Any = None
    clamp_mask: Any = None
    clamp_values: Any = None
    timeout_s: Optional[float] = None


@dataclasses.dataclass
class RequestResult:
    """Terminal state of an admitted request."""

    status: str                       # ok | deadline_exceeded | failed
    tenant: str
    spins: Optional[np.ndarray]       # (chains, n_request_nodes) ±1 float32
    degraded: bool = False            # ran after a shard loss
    deadline_missed: bool = False     # completed, but past its deadline
    error: Optional[str] = None
    t_admitted: float = 0.0
    t_finished: float = 0.0
    queue_s: float = 0.0              # admission -> launch start
    exec_s: float = 0.0               # launch wall time (shared by batch)
    attempts: int = 1                 # launch attempts incl. flap retries
    launch_seq: int = -1
    chain_offset: int = -1
    bucket_shape: Optional[tuple] = None
    bucket_fingerprint: Optional[str] = None
    launch_key: Optional[int] = None  # `launch_seed`: full replay recipe
                                      # (tests rebuild the launch from it)


class Ticket:
    """Handle returned by `submit`; resolved by `pump`/`drain`."""

    def __init__(self, req: SampleRequest, *, deadline: Optional[float],
                 t_admitted: float, bshape: tuple[int, int],
                 emb: Embedding, Jb: np.ndarray, hb: np.ndarray,
                 betas: np.ndarray, bucket_mask: Optional[np.ndarray],
                 digest: str):
        self.req = req
        self.deadline = deadline
        self.t_admitted = t_admitted
        self.bshape = bshape
        self.emb = emb
        self.Jb = Jb
        self.hb = hb
        self.betas = betas
        self.bucket_mask = bucket_mask
        self.digest = digest
        self._result: Optional[RequestResult] = None

    @property
    def done(self) -> bool:
        return self._result is not None

    def result(self) -> RequestResult:
        if self._result is None:
            raise ServiceError(
                "request not resolved yet — drive the service with "
                "pump() or drain()")
        return self._result

    def _resolve(self, result: RequestResult) -> None:
        self._result = result


class CircuitBreaker:
    """Per-tenant closed -> open -> half-open breaker on deadline misses.

    ``threshold`` consecutive failures open the circuit for
    ``cooldown_s``; after cooldown one probe request is admitted
    (half-open) — success closes the circuit, failure reopens it
    immediately.  Protects other tenants' latency from one tenant whose
    problems chronically blow their deadlines.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._st: dict[str, dict] = {}

    def state(self, tenant: str, now: float) -> str:
        st = self._st.get(tenant)
        if st is None or st["open_until"] is None:
            return "closed"
        return "open" if now < st["open_until"] else "half_open"

    def allow(self, tenant: str, now: float) -> bool:
        s = self.state(tenant, now)
        if s == "open":
            return False
        if s == "half_open":
            self._st[tenant]["probing"] = True
        return True

    def record(self, tenant: str, ok: bool, now: float) -> None:
        if ok:
            self._st.pop(tenant, None)
            return
        st = self._st.setdefault(
            tenant, {"fails": 0, "open_until": None, "probing": False})
        st["fails"] += 1
        if st["probing"] or st["fails"] >= self.threshold:
            st["open_until"] = now + self.cooldown_s
            st["probing"] = False
            st["fails"] = 0

    def open_tenants(self, now: float) -> list[str]:
        return sorted(t for t in self._st
                      if self.state(t, now) == "open")


def _mesh_ids(mesh) -> list[int]:
    return [int(d) for d in np.asarray(mesh.devices).reshape(-1)]


class SamplerService:
    """See module docstring.  All time sources (``clock``, ``sleep``,
    ``rng``) are injectable so the fault-schedule tests run with virtual
    time and recorded backoffs; none of them influence sampled results.
    """

    def __init__(self, *,
                 hw: Optional[HardwareConfig] = None,
                 mismatch_seed: int = 0,
                 seed: int = 0,
                 mesh: Any = None,
                 capacity_chains: int = 16,
                 max_queue: int = 64,
                 default_timeout_s: float = 60.0,
                 noise: str = "counter",
                 sync: Optional[api.Sync] = None,
                 buckets=DEFAULT_BUCKETS,
                 cache_capacity: int = 8,
                 breaker: Optional[CircuitBreaker] = None,
                 monitor: Optional[ShardHealthMonitor] = None,
                 injector: Any = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 max_retries: int = 3,
                 backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0,
                 rng: Optional[_random.Random] = None,
                 clock=time.monotonic,
                 sleep=time.sleep,
                 device: str | torch.device = "cuda"):
        if capacity_chains < 1:
            raise ValueError(
                f"capacity_chains must be >= 1, got {capacity_chains}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.hw = hw if hw is not None else HardwareConfig()
        self.mismatch_seed = mismatch_seed
        self.seed = seed
        self.mesh = mesh
        self.capacity_chains = capacity_chains
        self.max_queue = max_queue
        self.default_timeout_s = default_timeout_s
        self.noise = noise
        self.sync = sync
        self.buckets = tuple(tuple(b) for b in buckets)
        self.cache = SessionCache(cache_capacity)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.monitor = monitor
        self.injector = injector
        self.watchdog = (watchdog if watchdog is not None
                         else StragglerWatchdog(threshold=3.0))
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self._rng = rng
        self._clock = clock
        self._sleep = sleep
        self.device = require_device(device)
        self.state = "healthy" if mesh is not None else "single"
        self.metrics: Counter = Counter()
        self._queue: deque[Ticket] = deque()
        self._dead: set[int] = set()
        self._launch_seq = 0
        self._bucket_graphs: dict[tuple, ChimeraGraph] = {}
        self._bucket_mismatch: dict[tuple, Any] = {}
        self._embeddings: dict[tuple, Embedding] = {}

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, req: SampleRequest) -> Ticket:
        now = self._clock()
        if not self.breaker.allow(req.tenant, now):
            self.metrics["rejected_breaker"] += 1
            raise CircuitOpenError(
                f"tenant {req.tenant!r}: circuit open after repeated "
                f"deadline misses; retry after cooldown")
        if len(self._queue) >= self.max_queue:
            self.metrics["rejected_backpressure"] += 1
            raise AdmissionError(
                f"admission queue full ({self.max_queue}); apply "
                f"backpressure upstream and retry")
        if not (1 <= req.chains <= self.capacity_chains):
            raise ValueError(
                f"chains={req.chains} out of range [1, "
                f"{self.capacity_chains}] (capacity_chains)")
        bshape = bucket_shape(req.graph, self.buckets)
        emb = self._embedding(req.graph, bshape)
        J = np.asarray(req.J_codes, np.int32)
        h = np.asarray(req.h_codes, np.int32)
        if J.shape != (req.graph.edges.shape[0],):
            raise ValueError(
                f"J_codes shape {J.shape} != (E,)="
                f"({req.graph.edges.shape[0]},)")
        if h.shape != (req.graph.n_nodes,):
            raise ValueError(
                f"h_codes shape {h.shape} != (N,)=({req.graph.n_nodes},)")
        Jb, hb = embed_program(emb, J, h)
        betas = self._canon_betas(req)
        bucket_mask = None
        if req.clamp_mask is not None:
            cm = np.asarray(req.clamp_mask, bool)
            if cm.shape != (req.graph.n_nodes,):
                raise ValueError(
                    f"clamp_mask shape {cm.shape} != (N,)")
            cv = np.asarray(req.clamp_values, np.float32)
            if cv.shape != (req.chains, req.graph.n_nodes):
                raise ValueError(
                    f"clamp_values shape {cv.shape} != (chains, N)="
                    f"({req.chains}, {req.graph.n_nodes})")
            bucket_mask = np.zeros(emb.bucket.n_nodes, bool)
            bucket_mask[emb.node_map] = cm
        timeout = (req.timeout_s if req.timeout_s is not None
                   else self.default_timeout_s)
        ticket = Ticket(
            req, deadline=now + timeout, t_admitted=now, bshape=bshape,
            emb=emb, Jb=Jb, hb=hb, betas=betas, bucket_mask=bucket_mask,
            digest=program_digest(bshape, Jb, hb, betas, bucket_mask))
        self._queue.append(ticket)
        self.metrics["admitted"] += 1
        return ticket

    def _canon_betas(self, req: SampleRequest) -> np.ndarray:
        if req.betas is not None:
            betas = np.asarray(req.betas, np.float32)
            if betas.ndim != 1 or betas.shape[0] < 1:
                raise ValueError(
                    f"betas must be a 1-D (S,) array, got {betas.shape}")
            return betas
        if req.n_sweeps < 1:
            raise ValueError(f"n_sweeps must be >= 1, got {req.n_sweeps}")
        return np.full(req.n_sweeps, req.beta, np.float32)

    def _embedding(self, graph: ChimeraGraph,
                   bshape: tuple[int, int]) -> Embedding:
        sig = (int(graph.rows), int(graph.cols), int(graph.k),
               tuple(sorted(tuple(c) for c in (graph.masked_cells or ()))),
               bshape)
        emb = self._embeddings.get(sig)
        if emb is None:
            bg = self._bucket_graph(bshape)
            emb = embed_graph(graph, bg)
            self._embeddings[sig] = emb
        return emb

    # ------------------------------------------------------------------
    # bucket specs (the Session-cache key surface)
    # ------------------------------------------------------------------
    def _bucket_graph(self, bshape: tuple[int, int]) -> ChimeraGraph:
        bg = self._bucket_graphs.get(bshape)
        if bg is None:
            bg = make_bucket_graph(*bshape)
            self._bucket_graphs[bshape] = bg
        return bg

    def _mismatch_for(self, bshape: tuple[int, int], bg: ChimeraGraph):
        # one virtual chip instance per bucket (a bucket is a chip SKU):
        # derived from (mismatch_seed, bucket shape) so it is identical
        # across mesh states — degradation must not change the physics
        mm = self._bucket_mismatch.get(bshape)
        if mm is None:
            nbr_idx, _ = bg.neighbor_table()
            gen = torch.Generator(device=self.device).manual_seed(
                epoch_seed(self.mismatch_seed, BUCKET_STREAM,
                           bshape[0] * 1009 + bshape[1]))
            mm = sample_mismatch_sparse(gen, bg.n_nodes, nbr_idx.shape[0],
                                        self.hw, device=self.device)
            self._bucket_mismatch[bshape] = mm
        return mm

    def bucket_spec(self, graph: ChimeraGraph) -> api.SamplerSpec:
        """The spec a request on ``graph`` runs under *right now*
        (current mesh state) — public so tests and benchmarks can rebuild
        the exact Session a result came from."""
        return self._spec_for_bucket(bucket_shape(graph, self.buckets))

    def _backend(self, meshed: bool) -> str:
        """``fused_sparse`` where `api.resolve_backend` admits it, else
        ``sparse``: decided from the spec's fields, before the Session is
        built.  The service injects no fault hooks, so the rule reads the
        noise and, on a mesh, the sync policy."""
        if not meshed:
            fused = self.noise in api.IN_KERNEL_NOISE
        else:
            sync = self.sync if self.sync is not None else api.Sync()
            fused = self.noise == "counter" and sync.fused_compatible
        return "fused_sparse" if fused else "sparse"

    def _spec_for_bucket(self, bshape: tuple[int, int]) -> api.SamplerSpec:
        bg = self._bucket_graph(bshape)
        mm = self._mismatch_for(bshape, bg)
        kw: dict = {}
        mesh = self.mesh
        if mesh is not None:
            n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
            # a bucket with fewer cell rows than devices cannot row-shard;
            # it runs single-device even while the service is healthy
            if n_dev <= bg.rows:
                kw = dict(mesh=mesh,
                          partition=api.Partition(rows=mesh.axis_names[0]))
                if self.sync is not None:
                    kw["sync"] = self.sync
        return api.SamplerSpec(
            graph=bg, hw=self.hw, mismatch=mm, noise=self.noise,
            backend=self._backend("mesh" in kw),
            chains=self.capacity_chains, device=self.device, **kw)

    def _entry_for(self, bshape: tuple[int, int]
                   ) -> tuple[str, CacheEntry]:
        spec = self._spec_for_bucket(bshape)
        fp = api.spec_fingerprint(spec)

        def build() -> CacheEntry:
            t0 = time.monotonic()
            session = api.Session(spec)
            return CacheEntry(session=session, spec=spec,
                              embeddable=spec.graph,
                              meshed=spec.mesh is not None,
                              build_s=time.monotonic() - t0)

        return fp, self.cache.get_or_build(fp, build)

    # ------------------------------------------------------------------
    # the pump: one batched launch per call
    # ------------------------------------------------------------------
    def pump(self) -> int:
        """Form one launch group from the queue head, execute it, resolve
        its tickets.  Returns the number of requests resolved (including
        queue-expired ones)."""
        batch, expired = self._next_batch()
        if not batch:
            return expired
        self._execute(batch)
        return expired + len(batch)

    def drain(self) -> int:
        """Pump until the queue is empty; returns requests resolved."""
        total = 0
        while self._queue:
            total += self.pump()
        return total

    def _next_batch(self) -> tuple[list[Ticket], int]:
        now = self._clock()
        batch: list[Ticket] = []
        free = self.capacity_chains
        rest: deque[Ticket] = deque()
        expired = 0
        while self._queue:
            t = self._queue.popleft()
            if now > t.deadline:
                self._resolve_expired(t, now)
                expired += 1
                continue
            if not batch:
                batch.append(t)
                free -= t.req.chains
            elif (t.digest == batch[0].digest
                  and t.req.chains <= free):
                batch.append(t)
                free -= t.req.chains
            else:
                rest.append(t)
        self._queue = rest
        return batch, expired

    def _resolve_expired(self, t: Ticket, now: float) -> None:
        self.metrics["deadline_expired_queued"] += 1
        self.breaker.record(t.req.tenant, ok=False, now=now)
        t._resolve(RequestResult(
            status="deadline_exceeded", tenant=t.req.tenant, spins=None,
            error="deadline passed while queued",
            t_admitted=t.t_admitted, t_finished=now,
            queue_s=now - t.t_admitted))

    def _execute(self, batch: list[Ticket]) -> None:
        seq = self._launch_seq
        self._launch_seq += 1
        key = launch_seed(self.seed, seq)
        t_start = self._clock()
        attempts = [0]

        def attempt():
            attempts[0] += 1
            return self._attempt(batch, seq, key)

        n_dev = 0 if self.mesh is None else len(_mesh_ids(self.mesh))
        replays = 0
        while True:
            try:
                m, fp, entry = retry_step(
                    attempt, max_retries=self.max_retries,
                    backoff_s=self.backoff_s,
                    max_backoff_s=self.max_backoff_s,
                    rng=self._rng, sleep=self._sleep)
                break
            except ShardLostError as e:
                replays += 1
                self._degrade(e.dead)
                if replays > n_dev + 1:   # can't happen: ladder is finite
                    now = self._clock()
                    for t in batch:
                        t._resolve(RequestResult(
                            status="failed", tenant=t.req.tenant,
                            spins=None, error=str(e),
                            t_admitted=t.t_admitted, t_finished=now))
                    self.metrics["failed"] += len(batch)
                    return
        now = self._clock()
        exec_s = now - t_start
        self.metrics["launches"] += 1
        self.metrics["launch_attempts_total"] += attempts[0]
        # a replay's attempt after a shard loss is not a transient retry
        if attempts[0] > 1 + replays:
            self.metrics["transient_retries"] += attempts[0] - 1 - replays
        if replays:
            self.metrics["replays"] += replays
        if self.watchdog.observe(seq, exec_s):
            self.metrics["stragglers_flagged"] += 1
        degraded = bool(self._dead)
        off = 0
        for t in batch:
            spins = m[off:off + t.req.chains][:, t.emb.node_map]
            missed = now > t.deadline
            self.breaker.record(t.req.tenant, ok=not missed, now=now)
            self.metrics["completed"] += 1
            if missed:
                self.metrics["deadline_missed_exec"] += 1
            t._resolve(RequestResult(
                status="ok", tenant=t.req.tenant, spins=spins,
                degraded=degraded, deadline_missed=missed,
                t_admitted=t.t_admitted, t_finished=now,
                queue_s=t_start - t.t_admitted, exec_s=exec_s,
                attempts=attempts[0], launch_seq=seq, chain_offset=off,
                bucket_shape=t.bshape, bucket_fingerprint=fp,
                launch_key=key))
            off += t.req.chains

    def _launch_state(self, session, key: int):
        """A launch's initial (spins, noise state): drawn in that order
        from one generator seeded with ``key`` on the Session's device,
        as `Session.init_state` draws them."""
        gen = session.generator(key)
        return session.random_spins(gen), session.noise_state(gen)

    def _attempt(self, batch: list[Ticket], seq: int, key: int):
        if self.injector is not None:
            delay = self.injector.on_launch(seq, self)  # may raise Transient
            if delay:
                self.metrics["straggler_delay_injected"] += 1
                self._sleep(delay)
        self._check_shards()
        head = batch[0]
        fp, entry = self._entry_for(head.bshape)
        session = entry.session
        m0, ns = self._launch_state(session, key)
        cm, cv = self._assemble_clamps(batch, entry.embeddable)
        # scatter codes, call: the program (codes + clamps) is a runtime
        # operand of the bucket Session — no per-digest chip cache
        prog = session.make_program(head.Jb, head.hb, clamp_mask=cm,
                                    clamp_values=cv)
        m, _, _ = session.sample_program(prog, m0, ns, head.betas)
        # copy to the host *inside* the attempt (it synchronizes): a shard
        # dying mid-launch surfaces here, where the replay machinery sees it
        return m.cpu().numpy(), fp, entry

    def _assemble_clamps(self, batch: list[Ticket], bg: ChimeraGraph):
        head = batch[0]
        if head.bucket_mask is None:
            return None, None
        cv = np.zeros((self.capacity_chains, bg.n_nodes), np.float32)
        off = 0
        for t in batch:
            vals = np.asarray(t.req.clamp_values, np.float32)
            cv[off:off + t.req.chains, t.emb.node_map] = vals
            off += t.req.chains
        return head.bucket_mask, cv

    # ------------------------------------------------------------------
    # degradation ladder
    # ------------------------------------------------------------------
    def _check_shards(self) -> None:
        if self.mesh is None or self.monitor is None:
            return
        dead = set(self.monitor.dead_shards()) & set(_mesh_ids(self.mesh))
        if dead:
            raise ShardLostError(dead)

    def _degrade(self, dead) -> None:
        self._dead.update(int(d) for d in dead)
        self.metrics["shard_losses"] += len(set(dead))
        self.metrics["degradations"] += 1
        self.mesh = surviving_mesh(self.mesh, self._dead)
        self.state = "degraded" if self.mesh is not None else "single"
        # every Session built against the dead mesh is garbage now;
        # survivors rebuild lazily on the re-planned mesh (the numpy row
        # plan comes from the memoized `plan_row_partition`)
        self.metrics["cache_invalidated"] += self.cache.invalidate(
            lambda fp, e: e.meshed)

    # ------------------------------------------------------------------
    # probes
    # ------------------------------------------------------------------
    def healthz(self) -> dict:
        now = self._clock()
        return {
            "state": self.state,
            "mesh_devices": [] if self.mesh is None else _mesh_ids(self.mesh),
            "dead_shards": sorted(self._dead),
            "queue_depth": len(self._queue),
            "open_breakers": self.breaker.open_tenants(now),
            "cache": self.cache.stats(),
            "stragglers": len(self.watchdog.flagged),
            "metrics": dict(self.metrics),
        }

    def readyz(self) -> bool:
        """Ready = still admitting: queue has room.  Degraded and
        single-device states stay ready — capacity shrank, correctness
        did not."""
        return len(self._queue) < self.max_queue
