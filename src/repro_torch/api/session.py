"""Solver sessions: a `SamplerSpec` resolved once, then programmed and sampled.

`Session(spec)` is the one choke point between every workload and the
execution backends in core/pbit.py + kernels/.  Construction does all the
one-time work: validates the spec, resolves ``backend`` (the only place
REPRO_PBIT_BACKEND is read) and ``device`` (a missing GPU raises), builds
the noise step function, moves the graph's colour / edge / slot tables to
the device and materializes the spec's `Schedule`.  A spec with a mesh
builds the row-band `core.distributed.ShardedEngine` here, and every
sampling entry point delegates to it with the same array contracts.

State threading is explicit everywhere: chips, spins and noise state are
arguments and return values, never hidden attributes.  A problem can also
arrive as a runtime `Program` (`make_program` / `sample_program`), and a
stack of them as a fleet (`sample_fleet`, `make_cd_fleet_step`).  Counterpart of
``repro.api.session``; PyTorch runs eagerly, so the reference's cache of
compiled closures has nothing to cache and is gone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

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


def program(spec: SamplerSpec, J_codes, h_codes, enable=None, *,
            tables=None) -> EffectiveChip:
    """Program dense (n, n) symmetric 8-bit codes through the spec's
    analog model (sparse-native specs gather the codes into slots)."""
    nbr_idx, nbr_mask, _, _ = _graph_tables(spec, tables)
    dev = spec.mismatch.device
    J_codes = torch.as_tensor(J_codes, device=dev)
    h_codes = torch.as_tensor(h_codes, device=dev)
    if enable is None:
        enable = torch.abs(J_codes) > 0
    else:
        enable = torch.as_tensor(enable, device=dev)
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
    return _scale_chip(spec, chip)


def program_edges(spec: SamplerSpec, J_edge_codes, h_codes, *,
                  tables=None) -> EffectiveChip:
    """Program per-edge codes (E,) — the CD master-weight layout."""
    tables = _graph_tables(spec, tables)
    nbr_idx, nbr_mask, slot_ij, slot_ji = tables
    dev = spec.mismatch.device
    e = _long(spec.graph.edges, dev)
    codes = torch.as_tensor(J_edge_codes, device=dev)
    if spec.sparse_native:
        J_slots = scatter_edge_slots(
            codes, e, _long(slot_ij, dev), _long(slot_ji, dev),
            nbr_idx.shape[0], spec.graph.n_nodes)
        chip = program_weights_sparse(
            J_slots, torch.as_tensor(h_codes, device=dev),
            torch.abs(J_slots) > 0, spec.mismatch, spec.hw,
            _long(nbr_idx, dev), torch.as_tensor(nbr_mask, device=dev))
        return _scale_chip(spec, chip)
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
        self._noise_init, self._noise_step = self._make_noise()
        self._engine = None
        if spec.mesh is not None:
            # row-band sharded execution: the plan, the sync policy's loop
            # and the per-band kernels live in core/distributed.py
            from repro_torch.core.distributed import ShardedEngine
            self._engine = ShardedEngine(
                g, spec.mesh, spec.partitioning(), spec.noise,
                spec.decimation, spec.chains, sync=spec.sync_policy(),
                backend=self.backend, device=self.device)
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

    def _make_noise(self) -> tuple[Callable, pbit.NoiseFn]:
        spec, dev = self.spec, self.device
        if spec.noise == "lfsr":
            return pbit.make_lfsr_noise(spec.graph, spec.chains,
                                        spec.decimation, device=dev)
        if spec.noise == "counter":
            return pbit.make_counter_noise(spec.chains, spec.graph.n_nodes,
                                           device=dev)
        step = pbit.make_philox_noise(spec.chains, spec.graph.n_nodes,
                                      device=dev)
        return (lambda gen: gen), step

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
        if self._engine is not None:
            return self._engine.sample(chip, m, noise_state,
                                       self._betas(betas), clamp_mask,
                                       clamp_values, collect)
        return pbit.gibbs_sample(
            chip, self._color, m, self._betas(betas), noise_state,
            self._noise_step, clamp_mask=clamp_mask,
            clamp_values=clamp_values, collect=collect,
            backend=self.backend)

    def stats(self, chip: EffectiveChip, m, noise_state, n_sweeps: int,
              burn_in: int, *, clamp_mask=None, clamp_values=None,
              beta: float | None = None):
        """On-line first/second moments at the spec's base beta:
        (mean_spin[N], mean_edge_corr[E], m', noise_state')."""
        beta = self.spec.beta if beta is None else float(beta)
        if self._engine is not None:
            return self._engine.stats(chip, m, noise_state, beta, n_sweeps,
                                      burn_in, clamp_mask, clamp_values)
        return pbit.gibbs_stats(
            chip, self._color, m, beta, n_sweeps, burn_in, noise_state,
            self._noise_step, self._edges, clamp_mask=clamp_mask,
            clamp_values=clamp_values, backend=self.backend)

    def visible_hist(self, chip: EffectiveChip, m, noise_state,
                     visible_idx: np.ndarray, burn_in: int, betas=None):
        """Streaming visible-pattern histogram: (counts[2^nv], m', state')."""
        if self._engine is not None:
            return self._engine.visible_hist(chip, m, noise_state,
                                             self._betas(betas), burn_in,
                                             np.asarray(visible_idx))
        return pbit.gibbs_visible_hist(
            chip, self._color, m, self._betas(betas), burn_in, noise_state,
            self._noise_step, np.asarray(visible_idx), backend=self.backend)

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

        def phase(chip, m0, n_sweeps, ns, cm=None, cv=None):
            if self._engine is not None:
                # sharded phases: the rows partition exchanges halos, a
                # chains partition sums its shards' moments once per phase
                return self._engine.stats(chip, m0, ns, beta, n_sweeps,
                                          cfg.burn_in, cm, cv)
            return pbit.gibbs_stats(
                chip, self._color, m0, beta, n_sweeps, cfg.burn_in, ns,
                self._noise_step, self._edges, clamp_mask=cm,
                clamp_values=cv, backend=self.backend)

        def step(mismatch, Jm, hm, data_vis, m, noise_state, vel):
            chip = program_edges(self.spec.replace(mismatch=mismatch),
                                 quantize_codes(Jm), quantize_codes(hm),
                                 tables=self._nbr).to(dev)
            clamp_values = torch.zeros((cfg.chains, n), dtype=torch.float32,
                                       device=dev)
            clamp_values[:, vis] = torch.as_tensor(
                data_vis, dtype=torch.float32, device=dev)

            # positive phase: visibles pinned to data
            pos_s, pos_c, m_pos, noise_state = phase(
                chip, m, cfg.pos_sweeps, noise_state, clamp_mask,
                clamp_values)
            # negative phase: CD-k from the positive-phase state, or from
            # the persistent chains (PCD)
            neg_init = m if cfg.persistent else m_pos
            neg_s, neg_c, m_neg, noise_state = phase(
                chip, neg_init, cfg.cd_k, noise_state)

            gJ = pos_c - neg_c
            gh = pos_s - neg_s
            # skip-and-log guard: a non-finite gradient (bad data batch,
            # device fault) must never reach the master weights
            ok = torch.isfinite(gJ).all() & torch.isfinite(gh).all()
            vel_J, vel_h = vel
            vel_J_new = cfg.momentum * vel_J + gJ
            vel_h_new = cfg.momentum * vel_h + gh
            Jm_new = (1.0 - cfg.weight_decay) * Jm + cfg.lr * vel_J_new
            hm_new = (1.0 - cfg.weight_decay) * hm \
                + cfg.lr * cfg.h_lr_scale * vel_h_new
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
                "corr_err": torch.abs(pos_c - neg_c).sum() * inv_e,
                "mean_err": torch.abs(pos_s - neg_s).sum() * inv_n,
                "update_skipped": 1.0 - ok.to(torch.float32),
            }
            return Jm, hm, m_out, noise_state, (vel_J, vel_h), metrics

        return step
