"""Solver sessions: a `SamplerSpec` resolved once, then programmed and sampled.

`Session(spec)` is the one choke point between every workload and the
execution backends in core/pbit.py + kernels/.  Construction does all the
one-time work: validates the spec, resolves ``backend`` (the only place
REPRO_PBIT_BACKEND is read) and ``device`` (a missing GPU raises), builds
the noise step function, moves the graph's colour / edge / slot tables to
the device and materializes the spec's `Schedule`.  A spec with a mesh
builds the row-band `core.distributed.ShardedEngine` here, and every
sampling entry point delegates to it with the same array contracts.  The
spec's `api.Faults` are compiled here too: saturated and dead couplers
into programming, stuck spins into every entry point's clamp arguments,
stuck LFSR bits into the noise step and transient flips into a hook the
half-sweep loop runs.

State threading is explicit everywhere: chips, spins and noise state are
arguments and return values, never hidden attributes.  A problem can also
arrive as a runtime `Program` (`make_program` / `sample_program`), and a
stack of them as a fleet (`sample_fleet`, `make_cd_fleet_step`).  Counterpart of
``repro.api.session``; PyTorch runs eagerly, so the reference's cache of
compiled closures has nothing to cache and is gone.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.api.faults import (FLIP_FOLD, counter_flip_fn,
                                    lfsr_stuck_masks)
from repro_torch.api.program import Program, fleet_member
from repro_torch.api.spec import SamplerSpec, require_device, resolve_backend
from repro_torch.core import pbit
from repro_torch.core.hardware import (
    EffectiveChip,
    program_weights,
    program_weights_sparse,
    quantize_codes,
)
from repro_torch.kernels.ref import scatter_edge_slots


class SessionState(NamedTuple):
    """Spins + noise state, the carry every entry point threads explicitly."""

    m: torch.Tensor
    noise_state: object


# ---------------------------------------------------------------------------
# chip programming (spec-level: needs no backend/noise resolution —
# programming only depends on the graph, the mismatch instance and the
# analog model; everything is computed on the mismatch's device)
# ---------------------------------------------------------------------------
def _graph_tables(spec: SamplerSpec, tables=None):
    if tables is not None:
        return tables
    nbr_idx, nbr_mask = spec.graph.neighbor_table()
    slot_ij, slot_ji = spec.graph.edge_slots(nbr_idx)
    return nbr_idx, nbr_mask, slot_ij, slot_ji


def _scale_chip(spec: SamplerSpec, chip: EffectiveChip) -> EffectiveChip:
    # external-resistor scale: DAC LSB units -> neuron-input units
    upd = {"h": chip.h * spec.w_scale}
    if chip.W is not None:
        upd["W"] = chip.W * spec.w_scale
    if chip.nbr_w is not None:
        upd["nbr_w"] = chip.nbr_w * spec.w_scale
    return dataclasses.replace(chip, **upd)


def _long(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=dev).to(torch.int64)


def _full_scale(codes: torch.Tensor) -> torch.Tensor:
    """±127 with the sign of the requested codes (+ for zero)."""
    return torch.where(codes < 0, -127, 127).to(codes.dtype)


def _saturate_edge_codes(spec: SamplerSpec, codes: torch.Tensor
                         ) -> torch.Tensor:
    """Apply stuck-at-full-scale weight DACs to (E,) edge codes.

    A saturated coupler drives ±127 regardless of the programmed code
    (sign follows the requested code; + when zero).  Idempotent, so the
    dense programming route may apply it again at the (n, n) level."""
    f = spec.faults
    if f is None or not f.saturated_edges:
        return codes
    sat = _long(f.saturated_edges, codes.device)
    codes = codes.clone()
    codes[sat] = _full_scale(codes[sat])
    return codes


def _apply_code_faults(spec: SamplerSpec, J_codes: torch.Tensor, enable):
    """Dense-codes view of the saturation fault (+ forced enable)."""
    f = spec.faults
    if f is None or not f.saturated_edges:
        return J_codes, enable
    e = spec.graph.edges
    sat = np.asarray(f.saturated_edges, np.int64)
    i, j = _long(e[sat, 0], J_codes.device), _long(e[sat, 1], J_codes.device)
    full = _full_scale(J_codes[i, j])
    J_codes = J_codes.clone()
    J_codes[i, j] = full
    J_codes[j, i] = full
    if enable is not None:
        # the stuck DAC drives current whether or not the coupler was
        # meant to be enabled
        enable = enable.clone()
        enable[i, j] = True
        enable[j, i] = True
    return J_codes, enable


def _kill_dead_edges(spec: SamplerSpec, chip: EffectiveChip,
                     tables) -> EffectiveChip:
    """Open-circuit the dead couplers: zero coupling in both directions,
    including the disabled-coupler leakage (a broken bond wire carries no
    current at all).  Runs after programming and scaling, so it is the
    last word on those entries."""
    f = spec.faults
    if f is None or not f.dead_edges:
        return chip
    _, _, slot_ij, slot_ji = tables
    dev = chip.h.device
    de = np.asarray(f.dead_edges, np.int64)
    e = spec.graph.edges
    i, j = _long(e[de, 0], dev), _long(e[de, 1], dev)
    upd = {}
    if chip.W is not None:
        W = chip.W.clone()
        W[i, j] = 0.0
        W[j, i] = 0.0
        upd["W"] = W
    if chip.nbr_w is not None:
        nbr_w = chip.nbr_w.clone()
        nbr_w[_long(np.asarray(slot_ij)[de], dev), i] = 0.0
        nbr_w[_long(np.asarray(slot_ji)[de], dev), j] = 0.0
        upd["nbr_w"] = nbr_w
    return dataclasses.replace(chip, **upd) if upd else chip


def program(spec: SamplerSpec, J_codes, h_codes, enable=None, *,
            tables=None) -> EffectiveChip:
    """Program dense (n, n) symmetric 8-bit codes through the spec's
    analog model (sparse-native specs gather the codes into slots).

    The spec's `Faults` apply here: saturated couplers override their
    codes with ±127 before the DAC transfer, dead couplers are
    open-circuited after programming."""
    tables = _graph_tables(spec, tables)
    nbr_idx, nbr_mask, _, _ = tables
    dev = spec.mismatch.device
    J_codes = torch.as_tensor(J_codes, device=dev)
    h_codes = torch.as_tensor(h_codes, device=dev)
    if enable is not None:
        enable = torch.as_tensor(enable, device=dev)
    J_codes, enable = _apply_code_faults(spec, J_codes, enable)
    if enable is None:
        enable = torch.abs(J_codes) > 0
    if spec.sparse_native:
        rows = torch.arange(spec.graph.n_nodes, device=dev)[None, :]
        idx = _long(nbr_idx, dev)
        chip = program_weights_sparse(
            J_codes[rows, idx], h_codes, enable[rows, idx], spec.mismatch,
            spec.hw, idx, torch.as_tensor(nbr_mask, device=dev))
    else:
        adj = torch.as_tensor(spec.graph.adjacency(), device=dev)
        neighbors = _long(nbr_idx, dev) if spec.attach_sparse else None
        chip = program_weights(J_codes, h_codes, enable, spec.mismatch,
                               spec.hw, adjacency=adj, neighbors=neighbors)
    return _kill_dead_edges(spec, _scale_chip(spec, chip), tables)


def program_edges(spec: SamplerSpec, J_edge_codes, h_codes, *,
                  tables=None) -> EffectiveChip:
    """Program per-edge codes (E,) — the CD master-weight layout."""
    tables = _graph_tables(spec, tables)
    nbr_idx, nbr_mask, slot_ij, slot_ji = tables
    dev = spec.mismatch.device
    e = _long(spec.graph.edges, dev)
    codes = _saturate_edge_codes(spec,
                                 torch.as_tensor(J_edge_codes, device=dev))
    if spec.sparse_native:
        J_slots = scatter_edge_slots(
            codes, e, _long(slot_ij, dev), _long(slot_ji, dev),
            nbr_idx.shape[0], spec.graph.n_nodes)
        chip = program_weights_sparse(
            J_slots, torch.as_tensor(h_codes, device=dev),
            torch.abs(J_slots) > 0, spec.mismatch, spec.hw,
            _long(nbr_idx, dev), torch.as_tensor(nbr_mask, device=dev))
        return _kill_dead_edges(spec, _scale_chip(spec, chip), tables)
    n = spec.graph.n_nodes
    J = torch.zeros((n, n), dtype=codes.dtype, device=dev)
    J[e[:, 0], e[:, 1]] = codes
    J[e[:, 1], e[:, 0]] = codes
    return program(spec, J, h_codes, tables=tables)


def program_master(spec: SamplerSpec, Jm, hm, *, tables=None
                   ) -> EffectiveChip:
    """Quantize float masters — edge-list (E,) or dense (n, n) — and
    program."""
    Jm = torch.as_tensor(Jm)
    if Jm.ndim == 1:
        return program_edges(spec, quantize_codes(Jm), quantize_codes(hm),
                             tables=tables)
    return program(spec, quantize_codes(Jm), quantize_codes(hm),
                   tables=tables)


def program_chip(spec: SamplerSpec, prog: Program, *, tables=None
                 ) -> EffectiveChip:
    """Program a runtime `Program` through the spec's analog model.

    A program-borne ``mismatch`` overrides the spec's draw (its type must
    be the spec's; `Session.make_program` enforces that)."""
    if prog.mismatch is not None:
        spec = spec.replace(mismatch=prog.mismatch)
    return program_edges(spec, prog.J_codes, prog.h_codes, tables=tables)


def _stack_states(states):
    """Stacked noise states of a fleet: a (K, ...) tensor for counter /
    lfsr bit patterns, the list of K generators for philox."""
    if isinstance(states[0], torch.Tensor):
        return torch.stack(states)
    return list(states)


class Session:
    """A resolved solver: spec-level programming + sampling entry points."""

    def __init__(self, spec: SamplerSpec):
        self.spec = spec.validate()
        self.backend = resolve_backend(spec)
        self.device = require_device(spec.device)
        g = spec.graph
        self.graph = g
        self._color = torch.as_tensor(g.color, device=self.device)
        self._edges = _long(g.edges, self.device)
        nbr_idx, nbr_mask = g.neighbor_table()
        slot_ij, slot_ji = g.edge_slots(nbr_idx)
        self._nbr = (nbr_idx, nbr_mask, slot_ij, slot_ji)
        self._fault_cm, self._fault_cv, self._alive_edges = \
            self._compile_faults()
        self._noise_init, self._noise_step = self._make_noise()
        self._flip_fn = self._make_flip_fn()
        self._engine = None
        if spec.mesh is not None:
            # row-band sharded execution: the plan, the sync policy's loop
            # and the per-band kernels live in core/distributed.py.  Stuck
            # spins reach it as clamp arguments; flips and stuck LFSR bits
            # it regenerates per band from global coordinates
            from repro_torch.core.distributed import ShardedEngine
            self._engine = ShardedEngine(
                g, spec.mesh, spec.partitioning(), spec.noise,
                spec.decimation, spec.chains, sync=spec.sync_policy(),
                backend=self.backend, device=self.device,
                faults=spec.faults)
        self.default_betas = (
            None if spec.schedule is None
            else torch.as_tensor(spec.schedule.betas(spec.chains),
                                 device=self.device))

    @property
    def partition_plan(self):
        """The `core.distributed.RowPartition` of a sharded Session (None
        when mesh=None): the handle for halo / boundary accounting
        (`core.distributed.halo_bytes_per_sweep`)."""
        return None if self._engine is None else self._engine.plan

    def _compile_faults(self):
        """The spec's fault draw -> tensors on the Session's device.

        Stuck-at-spin faults become a (N,) clamp mask + values merged into
        every entry point's clamp arguments (the path the CD positive phase
        and every kernel already take, which keeps the injection bit-exact
        across backends).  Dead and saturated couplers become the (E,)
        alive mask that gates the CD gradient: their DACs cannot take an
        update.
        """
        f = self.spec.faults
        n, n_edges = self.graph.n_nodes, self.graph.n_edges
        cm = cv = alive = None
        if f is not None and f.stuck_nodes:
            cm_np = np.zeros((n,), bool)
            cv_np = np.zeros((n,), np.float32)
            cm_np[list(f.stuck_nodes)] = True
            cv_np[list(f.stuck_nodes)] = np.asarray(f.stuck_values,
                                                    np.float32)
            cm = torch.as_tensor(cm_np, device=self.device)
            cv = torch.as_tensor(cv_np, device=self.device)
        if f is not None and f.faulty_edges:
            alive_np = np.ones((n_edges,), np.float32)
            alive_np[list(f.faulty_edges)] = 0.0
            alive = torch.as_tensor(alive_np, device=self.device)
        return cm, cv, alive

    def _merge_faults(self, m, cm, cv):
        """Fold the stuck-spin fault clamp into a caller's clamp args.

        The stuck values are written into ``m`` up front, so a mask-only
        (freeze-in-place) caller clamp stays mask-only; explicit caller
        values are overridden at fault positions — a latched p-bit reads
        its latched value even when driven by data.
        """
        fm, fv = self._fault_cm, self._fault_cv
        if fm is None:
            return m, cm, cv
        m = torch.where(fm, fv, m.to(torch.float32)).to(m.dtype)
        if cm is None:
            return m, fm, None
        cm2 = torch.as_tensor(cm, device=self.device).to(torch.bool) | fm
        if cv is None:
            return m, cm2, None
        cv = torch.as_tensor(cv, dtype=torch.float32, device=self.device)
        return m, cm2, torch.where(fm, fv, cv)

    def _make_noise(self) -> tuple[Callable, pbit.NoiseFn]:
        spec, dev = self.spec, self.device
        if spec.noise == "lfsr":
            f = spec.faults
            stuck = (lfsr_stuck_masks(f, self.graph.n_nodes // 8)
                     if f is not None and f.lfsr_stuck else None)
            return pbit.make_lfsr_noise(spec.graph, spec.chains,
                                        spec.decimation, device=dev,
                                        stuck=stuck)
        if spec.noise == "counter":
            return pbit.make_counter_noise(spec.chains, spec.graph.n_nodes,
                                           device=dev)
        step = pbit.make_philox_noise(spec.chains, spec.graph.n_nodes,
                                      device=dev)
        return (lambda gen: gen), step

    def _make_flip_fn(self):
        """Seeded transient-flip hook (`api.Faults.flip_prob`):
        flip(noise_state) -> (B, N) bool, called with the noise state
        *before* the half-sweep's draw.

        Counter noise: a salted counter hash (seed ^ FLIP_SALT) addressed
        by the pre-half-sweep (seed, counter) and the global (chain, node),
        bit-exact against the reference and across shards.  Philox noise:
        a generator seeded from a digest of the sampling generator's
        pre-half-sweep state and ``FLIP_FOLD ^ flip_seed``; it never
        advances the sampling generator, is the same on every loop backend
        and replays on a resumed run, and agrees with the reference's
        flips by rate only.
        """
        f = self.spec.faults
        if f is None or f.flip_prob <= 0.0:
            return None
        p = float(f.flip_prob)
        dev = self.device
        B, n = self.spec.chains, self.graph.n_nodes
        if self.spec.noise == "counter":
            return counter_flip_fn(f, torch.arange(B, device=dev)[:, None],
                                   torch.arange(n, device=dev)[None, :])
        if self.spec.noise == "philox":
            fold = ((FLIP_FOLD ^ int(f.flip_seed)) & 0xFFFFFFFF).to_bytes(
                4, "little")

            def flip(gen0):
                state = gen0.get_state().numpy().tobytes()
                seed = int.from_bytes(hashlib.blake2b(
                    fold + state, digest_size=8).digest(), "little")
                g = torch.Generator(device=dev).manual_seed(seed)
                return torch.rand((B, n), generator=g, device=dev) < p

            return flip
        return None  # lfsr noise + flips: rejected by spec validation

    def _betas(self, betas) -> torch.Tensor:
        if betas is None:
            if self.default_betas is None:
                raise ValueError(
                    "this Session's spec has no schedule; pass betas "
                    "explicitly or build the spec with schedule=")
            return self.default_betas
        if isinstance(betas, torch.Tensor):
            return betas.to(device=self.device, dtype=torch.float32)
        return torch.tensor(np.asarray(betas), dtype=torch.float32,
                            device=self.device)

    # ------------------------------------------------------------------
    # state initialization (explicit generator threading)
    # ------------------------------------------------------------------
    def generator(self, seed: int) -> torch.Generator:
        """A seeded `torch.Generator` on this Session's device."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def random_spins(self, gen: torch.Generator) -> torch.Tensor:
        return pbit.random_spins(gen, self.spec.chains, self.graph.n_nodes,
                                 device=self.device)

    def noise_state(self, gen: torch.Generator):
        """Initial noise state drawn from ``gen``: int32 bit patterns for
        counter / lfsr noise, the generator itself for philox."""
        return self._noise_init(gen)

    def init_state(self, gen: torch.Generator) -> SessionState:
        return SessionState(self.random_spins(gen), self.noise_state(gen))

    # ------------------------------------------------------------------
    # chip programming (dense or sparse-native, per the spec's mismatch)
    # ------------------------------------------------------------------
    def program(self, J_codes, h_codes, enable=None) -> EffectiveChip:
        """Program dense (n, n) symmetric 8-bit codes."""
        return program(self.spec, J_codes, h_codes, enable,
                       tables=self._nbr).to(self.device)

    def program_edges(self, J_edge_codes, h_codes) -> EffectiveChip:
        """Program per-edge codes (E,) — the CD master-weight layout."""
        return program_edges(self.spec, J_edge_codes, h_codes,
                             tables=self._nbr).to(self.device)

    def program_master(self, Jm, hm) -> EffectiveChip:
        """Quantize float masters — edge-list (E,) or dense (n, n) — and
        program."""
        return program_master(self.spec, Jm, hm,
                              tables=self._nbr).to(self.device)

    # ------------------------------------------------------------------
    # runtime weight streaming (the program as an operand)
    # ------------------------------------------------------------------
    def make_program(self, J_edge_codes, h_codes, *, mismatch=None,
                     clamp_mask=None, clamp_values=None,
                     betas=None) -> Program:
        """Package edge-list codes (E,) + bias codes (N,) as a runtime
        `Program` for `sample_program` / `sample_fleet`, on this Session's
        device.  An explicit ``mismatch`` must be the same type as the
        spec's: the dense/sparse programming route is fixed by the spec.
        """
        E, n = self.graph.n_edges, self.graph.n_nodes
        dev = self.device
        J = torch.as_tensor(J_edge_codes, device=dev)
        h = torch.as_tensor(h_codes, device=dev)
        if tuple(J.shape) != (E,):
            raise ValueError(
                f"J_edge_codes must be edge-list shaped ({E},), got "
                f"{tuple(J.shape)}; scatter dense codes to the edge list "
                f"first")
        if tuple(h.shape) != (n,):
            raise ValueError(f"h_codes must be ({n},), got {tuple(h.shape)}")
        if mismatch is not None:
            if type(mismatch) is not type(self.spec.mismatch):
                raise ValueError(
                    f"program mismatch type {type(mismatch).__name__} does "
                    f"not match the spec's "
                    f"{type(self.spec.mismatch).__name__}; the dense/sparse "
                    f"programming route is fixed by the spec")
            mismatch = mismatch.to(dev)
        if clamp_mask is not None:
            clamp_mask = torch.as_tensor(clamp_mask, device=dev).to(
                torch.bool)
            if clamp_values is not None:
                clamp_values = torch.as_tensor(
                    clamp_values, dtype=torch.float32, device=dev)
        elif clamp_values is not None:
            raise ValueError("clamp_values without clamp_mask")
        if betas is not None:
            betas = self._betas(betas)
        return Program(J_codes=J, h_codes=h, mismatch=mismatch,
                       clamp_mask=clamp_mask, clamp_values=clamp_values,
                       betas=betas)

    def sample_program(self, prog: Program, m, noise_state, betas=None, *,
                       collect: bool = False):
        """`sample`, with the chip programmed from a runtime `Program`:
        (m', state', traj|None).  Equal bit for bit to `program_edges` of
        the same codes followed by `sample` with the program's clamps.
        Beta priority: explicit ``betas`` > ``prog.betas`` > the spec's
        schedule.
        """
        if betas is None:
            betas = prog.betas
        chip = program_chip(self.spec, prog, tables=self._nbr).to(
            self.device)
        return self.sample(chip, m, noise_state, betas,
                           clamp_mask=prog.clamp_mask,
                           clamp_values=prog.clamp_values, collect=collect)

    def sample_fleet(self, progs: Program, m, noise_state, betas=None):
        """Run a stacked K-program fleet (see `api.stack_programs`):
        (m'[K, B, N], state'[K, ...], None).

        ``m`` / ``noise_state`` carry a leading K axis (philox: a sequence
        of K generators); ``betas`` (or the spec's schedule) is shared
        across the fleet unless the programs carry their own.  Each member
        runs through this Session's own backend (``fused_sparse``: one K1
        launch per member), so the fleet equals K sequential
        `sample_program` calls bit for bit.  Single-device only.
        """
        if self._engine is not None:
            raise ValueError(
                "sample_fleet runs on single-device Sessions; a sharded "
                "mesh already owns the device axis — run one fleet per "
                "device instead")
        K = progs.J_codes.shape[0]
        outs = [self.sample_program(fleet_member(progs, k), m[k],
                                    noise_state[k], betas)
                for k in range(K)]
        return (torch.stack([o[0] for o in outs]),
                _stack_states([o[1] for o in outs]), None)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def sample(self, chip: EffectiveChip, m, noise_state, betas=None, *,
               clamp_mask=None, clamp_values=None, collect: bool = False):
        """Run the schedule (or explicit ``betas``): (m', state', traj|None).

        ``collect=True`` returns the (S, B, N) per-sweep trajectory and
        forces the half-sweep loop (the fused engine cannot emit it).
        """
        m, cm, cv = self._merge_faults(m, clamp_mask, clamp_values)
        if self._engine is not None:
            return self._engine.sample(chip, m, noise_state,
                                       self._betas(betas), cm, cv, collect)
        return pbit.gibbs_sample(
            chip, self._color, m, self._betas(betas), noise_state,
            self._noise_step, clamp_mask=cm, clamp_values=cv,
            collect=collect, backend=self.backend, flip_fn=self._flip_fn)

    def stats(self, chip: EffectiveChip, m, noise_state, n_sweeps: int,
              burn_in: int, *, clamp_mask=None, clamp_values=None,
              beta: float | None = None):
        """On-line first/second moments at the spec's base beta:
        (mean_spin[N], mean_edge_corr[E], m', noise_state')."""
        beta = self.spec.beta if beta is None else float(beta)
        m, cm, cv = self._merge_faults(m, clamp_mask, clamp_values)
        if self._engine is not None:
            return self._engine.stats(chip, m, noise_state, beta, n_sweeps,
                                      burn_in, cm, cv)
        return pbit.gibbs_stats(
            chip, self._color, m, beta, n_sweeps, burn_in, noise_state,
            self._noise_step, self._edges, clamp_mask=cm, clamp_values=cv,
            backend=self.backend, flip_fn=self._flip_fn)

    def visible_hist(self, chip: EffectiveChip, m, noise_state,
                     visible_idx: np.ndarray, burn_in: int, betas=None):
        """Streaming visible-pattern histogram: (counts[2^nv], m', state').
        Stuck spins arrive as a mask-only clamp (their values written into
        ``m``), which the fused kernels' histogram takes."""
        m, cm, cv = self._merge_faults(m, None, None)
        if self._engine is not None:
            return self._engine.visible_hist(chip, m, noise_state,
                                             self._betas(betas), burn_in,
                                             np.asarray(visible_idx), cm, cv)
        return pbit.gibbs_visible_hist(
            chip, self._color, m, self._betas(betas), burn_in, noise_state,
            self._noise_step, np.asarray(visible_idx), backend=self.backend,
            clamp_mask=cm, clamp_values=cv, flip_fn=self._flip_fn)

    # ------------------------------------------------------------------
    # contrastive divergence (the in-situ learning step)
    # ------------------------------------------------------------------
    def make_cd_step(self, cfg, visible_idx: np.ndarray):
        """Build the one-epoch CD update (paper Fig. 7a).

        ``cfg`` is a `core.cd.CDConfig` (duck-typed).  Returns
        step(Jm, hm, data_vis, m, noise_state, vel) ->
        (Jm, hm, m, noise_state, vel, metrics) with (E,) edge-list master
        couplings; both Gibbs phases run through this session's backend.
        The mismatch draw is an argument of the inner step
        (``step.with_mismatch(mismatch, Jm, hm, ...)``); ``step`` applies
        the spec's own draw.
        """
        if cfg.chains != self.spec.chains:
            raise ValueError(
                f"CDConfig.chains={cfg.chains} but this Session runs "
                f"chains={self.spec.chains}; build the session with "
                f"chains=cfg.chains")
        return self._build_cd_step(cfg, np.asarray(visible_idx))

    def make_cd_fleet_step(self, cfg, visible_idx: np.ndarray):
        """Build the K-replica hardware-aware CD step: per-chip mismatch
        draws are operands.

        Returns step(mismatches, Jm, hm, data_vis, m, noise_state, vel)
        -> (Jm, hm, m, noise_state, vel, metrics) where every argument
        except ``data_vis`` (the shared data batch) carries a leading K
        fleet axis: ``mismatches`` is a stacked draw (see
        `core.cd.PBitMachine.fleet_mismatch`), Jm (K, E), hm (K, N),
        m (K, B, N), vel a pair of (K, E) / (K, N) tensors; metrics come
        back stacked per chip.  Chip k runs ``make_cd_step``'s
        ``with_mismatch`` on its own draw, so the fleet equals K
        sequential per-chip epochs bit for bit.  Single-device only.
        """
        if self._engine is not None:
            raise ValueError(
                "fleet CD runs on single-device Sessions; a sharded mesh "
                "already owns the device axis — run one fleet per device")
        step_mm = self.make_cd_step(cfg, visible_idx).with_mismatch

        def step(mismatches, Jm, hm, data_vis, m, noise_state, vel):
            outs = [step_mm(fleet_member(mismatches, k), Jm[k], hm[k],
                            data_vis, m[k], noise_state[k],
                            (vel[0][k], vel[1][k]))
                    for k in range(Jm.shape[0])]
            Jm, hm, m = (torch.stack([o[i] for o in outs]) for i in range(3))
            vel = tuple(torch.stack([o[4][i] for o in outs])
                        for i in range(2))
            metrics = {name: torch.stack([o[5][name] for o in outs])
                       for name in outs[0][5]}
            return (Jm, hm, m, _stack_states([o[3] for o in outs]), vel,
                    metrics)

        return step

    def _build_cd_step(self, cfg, visible_idx):
        step_mm = self._build_cd_step_mm(cfg, visible_idx)
        mm = self.spec.mismatch

        def step(Jm, hm, data_vis, m, noise_state, vel):
            return step_mm(mm, Jm, hm, data_vis, m, noise_state, vel)

        step.with_mismatch = step_mm
        return step

    def _build_cd_step_mm(self, cfg, visible_idx):
        from repro_torch.core.hardware import WMAX, WMIN

        n = self.graph.n_nodes
        dev = self.device
        vis = torch.as_tensor(visible_idx, device=dev).to(torch.int64)
        clamp_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        clamp_mask[vis] = True
        beta = self.spec.beta

        def f32(x):
            return torch.tensor(np.float32(x), device=dev)

        def decayed(W, lr, vel):
            """(1 - wd)·W + lr·vel as the reference compiles it."""
            if cfg.weight_decay == 0:
                return pbit.fma32(lr, vel, W)
            return pbit.fma32(f32(1.0 - cfg.weight_decay), W, lr * vel)

        def phase(chip, m0, n_sweeps, ns, cm=None, cv=None):
            if self._engine is not None:
                # sharded phases: the rows partition exchanges halos, a
                # chains partition sums its shards' moments once per phase
                return self._engine.stats(chip, m0, ns, beta, n_sweeps,
                                          cfg.burn_in, cm, cv, sums=True)
            return pbit.gibbs_stats(
                chip, self._color, m0, beta, n_sweeps, cfg.burn_in, ns,
                self._noise_step, self._edges, clamp_mask=cm,
                clamp_values=cv, backend=self.backend, sums=True,
                flip_fn=self._flip_fn)

        def difference(pos, neg):
            """pos_acc·pos_inv - neg_acc·neg_inv as the reference's
            compiled step fuses it: fma(pos_acc, pos_inv, -(neg moment))."""
            return pbit.fma32(pos[0], pos[1], -(neg[0] * neg[1]))

        def step(mismatch, Jm, hm, data_vis, m, noise_state, vel):
            chip = program_edges(self.spec.replace(mismatch=mismatch),
                                 quantize_codes(Jm), quantize_codes(hm),
                                 tables=self._nbr).to(dev)
            clamp_values = torch.zeros((cfg.chains, n), dtype=torch.float32,
                                       device=dev)
            clamp_values[:, vis] = torch.as_tensor(
                data_vis, dtype=torch.float32, device=dev)

            # positive phase: visibles pinned to data (stuck p-bits win
            # over the data drive — the latch reads its latched value)
            m, pos_cm, pos_cv = self._merge_faults(m, clamp_mask,
                                                   clamp_values)
            pos_s, pos_c, pos_inv, m_pos, noise_state = phase(
                chip, m, cfg.pos_sweeps, noise_state, pos_cm, pos_cv)
            # negative phase: CD-k from the positive-phase state, or from
            # the persistent chains (PCD)
            neg_init = m if cfg.persistent else m_pos
            neg_s, neg_c, neg_inv, m_neg, noise_state = phase(
                chip, neg_init, cfg.cd_k, noise_state, self._fault_cm)

            d_corr = difference((pos_c, pos_inv), (neg_c, neg_inv))
            gh = difference((pos_s, pos_inv), (neg_s, neg_inv))
            gJ = d_corr
            if self._alive_edges is not None:
                # dead/saturated couplers carry no reprogrammable DAC: their
                # gradient is noise and would only corrupt momentum.  A
                # multiply, as the reference does: a NaN there still trips
                # the guard below
                gJ = gJ * self._alive_edges
            # skip-and-log guard: a non-finite gradient (bad data batch,
            # device fault) must never reach the master weights
            ok = torch.isfinite(gJ).all() & torch.isfinite(gh).all()
            vel_J, vel_h = vel
            # the reference's compiled update, each step one FMA:
            # fma(mom, vel, g), then fma(lr, vel', W) without weight decay
            # or fma(1 - wd, W, round(lr·vel')) with it
            vel_J_new = pbit.fma32(f32(cfg.momentum), vel_J, gJ)
            vel_h_new = pbit.fma32(f32(cfg.momentum), vel_h, gh)
            Jm_new = decayed(Jm, f32(cfg.lr), vel_J_new)
            hm_new = decayed(hm, f32(cfg.lr * cfg.h_lr_scale), vel_h_new)
            Jm_new = torch.clamp(Jm_new, WMIN, WMAX)
            hm_new = torch.clamp(hm_new, WMIN, WMAX)
            Jm = torch.where(ok, Jm_new, Jm)
            hm = torch.where(ok, hm_new, hm)
            vel_J = torch.where(ok, vel_J_new, vel_J)
            vel_h = torch.where(ok, vel_h_new, vel_h)
            # the chains too: NaNs in m_neg would poison the next epoch
            m_out = torch.where(ok, m_neg, m)
            inv_e = pbit._recip(gJ.shape[0]).to(dev)
            inv_n = pbit._recip(gh.shape[0]).to(dev)
            metrics = {
                "corr_err": torch.abs(d_corr).sum() * inv_e,
                "mean_err": torch.abs(gh).sum() * inv_n,
                "update_skipped": 1.0 - ok.to(torch.float32),
            }
            return Jm, hm, m_out, noise_state, (vel_J, vel_h), metrics

        return step
