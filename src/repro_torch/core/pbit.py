"""The p-bit sampling engine (paper eqns 1 & 2), vectorized + batched.

Eqn 1:  I_i = sum_{j != i} J_ij m_j + h_i        (current summation)
Eqn 2:  m_i = sgn( tanh(beta I_i) + U(-1, +1) )  (stochastic neuron)

The exact digital emulation of the chip's parallel analog update on a
2-colourable graph (Chimera is — see chimera.py) is *chromatic Gibbs*:
update colour class 0 in parallel, then class 1, each with fresh noise.

Counterpart of ``repro.core.pbit``.  Execution backends:
  * "ref"          — a Python loop over half-sweeps of the plain dense
                     half-sweep (`half_sweep`: the ascending row reduction
                     of `kernels/ref.py`); the reference's scan path, not a
                     kernel there either.  The default.
  * "pallas"       — the same loop with the dense half-sweep CUDA kernel
                     (`kernels/pbit_update.py`), one launch per half-sweep.
  * "fused"        — the dense sweep-resident CUDA engine
                     (`kernels/sweep_fused.py::sweep_fused`): S sweeps per
                     launch, spins in shared memory, W read from L2, noise
                     generated in the kernel, moments (Gram matrix) and
                     histogram accumulated on-line.  Needs "counter" or
                     "lfsr" noise.
  * "sparse"       — the loop of "ref" on the Chimera slot layout.
  * "fused_sparse" — the sweep-resident engine on the slot layout
                     (`sweep_sparse`).  Needs "counter" or "lfsr" noise.
On a Chimera chip with counter or lfsr noise all five give the same spins
bit for bit: every eqn-1 sum is the same ascending float32 sum.

Noise state is explicit everywhere: "counter" and "lfsr" carry public
``torch.int32`` bit patterns (see `core/lfsr.py`), "philox" carries the
`torch.Generator` it draws from.
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import lfsr as lfsr_mod
from repro_torch.core.chimera import ChimeraGraph
from repro_torch.core.hardware import EffectiveChip

NoiseFn = Callable

BACKENDS = ("ref", "pallas", "fused", "sparse", "fused_sparse")
FUSED_BACKENDS = ("fused", "fused_sparse")


def resolve_backend(backend: str | None = None) -> str:
    """Map None/"auto" to the env default ("ref"); validate explicit
    choices."""
    if backend in (None, "auto"):
        backend = os.environ.get("REPRO_PBIT_BACKEND", "ref")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
    return backend


class NoiseSpec(NamedTuple):
    """Static description of a noise source, attached to step fns as
    ``step.spec`` so the fused kernel can regenerate the same stream."""

    kind: str                        # "philox" | "counter" | "lfsr"
    decimation: int = 8
    gather_perm: tuple | None = None  # node -> flat LFSR column (static)


# ---------------------------------------------------------------------------
# Noise sources
# ---------------------------------------------------------------------------
def make_philox_noise(batch: int, n_nodes: int, quantize: bool = True,
                      device="cuda") -> NoiseFn:
    """Generator-drawn noise: the state is a `torch.Generator` on
    ``device``, advanced in place and handed back.

    Agrees with the reference's philox noise in distribution only; not
    reproducible inside the fused kernel — use `make_counter_noise`.
    """

    def step(gen: torch.Generator):
        if quantize:  # mimic the 8-bit RNG DAC's discrete levels
            b = torch.randint(0, 256, (batch, n_nodes), generator=gen,
                              device=device)
            u = (b.to(torch.float32) - 127.5) / 128.0
        else:
            u = torch.rand((batch, n_nodes), generator=gen,
                           device=device) * 2.0 - 1.0
        return gen, u

    step.spec = NoiseSpec(kind="philox")
    return step


def make_counter_noise(batch: int, n_nodes: int, device="cuda"
                       ) -> tuple[Callable, NoiseFn]:
    """Stateless-hash noise, bit-exact between the plain path and the
    fused kernel.

    State is int32[2] bits = (seed, step counter); every step consumes one
    counter tick and hashes (seed, ctr, chain, node).  Returns
    (init_fn(generator) -> state, step_fn).
    """
    rows = torch.arange(batch, device=device)[:, None]
    cols = torch.arange(n_nodes, device=device)[None, :]

    def init(gen: torch.Generator) -> torch.Tensor:
        seed = torch.randint(0, 2 ** 32, (1,), generator=gen, device=device,
                             dtype=torch.int64)
        return lfsr_mod.from_u64(torch.cat([seed, torch.zeros_like(seed)]))

    def step(state: torch.Tensor):
        u = lfsr_mod.counter_uniform(state[0], state[1], rows, cols)
        nxt = torch.stack([lfsr_mod.to_u64(state[0]),
                           (lfsr_mod.to_u64(state[1]) + 1) & 0xFFFFFFFF])
        return lfsr_mod.from_u64(nxt), u

    step.spec = NoiseSpec(kind="counter")
    return init, step


def make_lfsr_noise(graph: ChimeraGraph, batch: int, decimation: int = 8,
                    device="cuda") -> tuple[Callable, NoiseFn]:
    """Chip-faithful noise: one 32-bit LFSR per unit cell.

    Returns (init_fn(generator) -> state, step_fn(state) -> (state,
    u[batch, N])).  Vertical nodes read the register bytes; horizontal
    nodes read the bit-reversed bytes (paper's sharing trick).
    """
    cells = sorted(
        {(int(r), int(c)) for r, c in zip(graph.node_r, graph.node_c)}
    )
    vert = np.stack([graph.cell_nodes(r, c, side=0) for r, c in cells])
    horiz = np.stack([graph.cell_nodes(r, c, side=1) for r, c in cells])
    perm = lfsr_mod.node_gather_perm(vert, horiz, graph.n_nodes)
    perm_t = torch.as_tensor(perm.astype(np.int64), device=device)
    n_cells = len(cells)

    def init(gen: torch.Generator) -> torch.Tensor:
        return lfsr_mod.seed_states(gen, (batch, n_cells), device=device)

    def step(state: torch.Tensor):
        return lfsr_mod.lfsr_uniform_for_graph(state, perm_t, decimation)

    step.spec = NoiseSpec(kind="lfsr", decimation=decimation,
                          gather_perm=tuple(int(x) for x in perm))
    return init, step


# ---------------------------------------------------------------------------
# Core update
# ---------------------------------------------------------------------------
def neuron_input(m: torch.Tensor, chip: EffectiveChip) -> torch.Tensor:
    """Eqn 1 for every node: I[b, i] = Σ_j W[i, j] m[b, j] + h[i], as the
    ascending row reduction (`kernels/ref.py::dense_neuron_input`).
    m: (B, N) in {-1, +1}."""
    if chip.W is None:
        raise ValueError(
            "this chip carries only the sparse slot layout (W=None); use a "
            "sparse backend ('sparse' or 'fused_sparse'), e.g. "
            "PBitMachine(backend='sparse') or REPRO_PBIT_BACKEND=sparse")
    from repro_torch.kernels.ref import dense_neuron_input
    return dense_neuron_input(m, chip.W, chip.h)


def half_sweep(m: torch.Tensor, chip: EffectiveChip,
               update_mask: torch.Tensor, beta, u: torch.Tensor
               ) -> torch.Tensor:
    """Parallel update of the nodes selected by ``update_mask`` (eqn 2),
    the plain dense half-sweep.  ``beta`` may be a scalar or a (B,)
    per-chain vector (tempering ladder)."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.ref_half_sweep(m, chip, update_mask, beta, u)


def make_sweep_fn(
    chip: EffectiveChip,
    color: torch.Tensor,
    noise_fn: NoiseFn,
    clamp_mask: torch.Tensor | None = None,
    clamp_values: torch.Tensor | None = None,
    kernel: Callable | None = None,
):
    """Build one full Gibbs sweep (two chromatic half-sweeps).

    clamp_mask: (N,) bool — nodes held at clamp_values (B, N) (CD positive
    phase).  ``kernel`` is the half-sweep implementation
    ``(m, chip, update_mask, beta, u) -> m``; default: the plain dense
    `half_sweep`.  Returns sweep(m, noise_state, beta) -> (m, noise_state).
    """
    hs = kernel if kernel is not None else half_sweep
    masks = [(color == c) for c in (0, 1)]
    if clamp_mask is not None:
        masks = [mk & (~clamp_mask) for mk in masks]

    def sweep(m, ns, beta):
        if clamp_values is not None:
            m = torch.where(clamp_mask, clamp_values, m)
        for mk in masks:
            ns, u = noise_fn(ns)
            m = hs(m, chip, mk, beta, u)
        return m, ns

    return sweep


def _resolve_kernel(backend: str, kernel: Callable | None
                    ) -> Callable | None:
    """Half-sweep implementation for the loop backends."""
    if kernel is not None:
        return kernel
    from repro_torch.kernels import ops as kernel_ops
    if backend == "pallas":
        return kernel_ops.make_kernel_half_sweep()
    if backend in ("sparse", "fused_sparse"):
        # "fused_sparse" lands here only on the collect=True loop
        return kernel_ops.sparse_half_sweep
    return None  # "ref" (and "fused"'s loop) use the plain dense half_sweep


def _use_fused(backend: str, kernel) -> bool:
    return backend in FUSED_BACKENDS and kernel is None


def _recip(x) -> torch.Tensor:
    """float32 ``1 / x``: the reference's compiled division by a trace-time
    constant is a multiply by this reciprocal, so the port multiplies too
    (a true division differs in the last place for some x)."""
    return torch.tensor(np.float32(1.0) / np.float32(x))


def gibbs_sample(
    chip: EffectiveChip,
    color: torch.Tensor,
    init_m: torch.Tensor,
    betas: torch.Tensor,
    noise_state,
    noise_fn: NoiseFn,
    clamp_mask: torch.Tensor | None = None,
    clamp_values: torch.Tensor | None = None,
    collect: bool = False,
    kernel: Callable | None = None,
    backend: str | None = None,
):
    """Run n_sweeps sweeps.  Returns (final_m, noise_state, traj|None).

    betas: (n_sweeps,) shared schedule or (n_sweeps, B) per-chain inverse
    temperatures (parallel-tempering replicas).
    traj (if collect): (n_sweeps, B, N) spin states after every sweep.
    The fused engine runs every sweep inside one kernel launch; it cannot
    emit per-sweep trajectories, so ``collect`` (and an explicit
    ``kernel=``) falls back to the half-sweep loop.
    """
    backend = resolve_backend(backend)
    if _use_fused(backend, kernel) and not collect:
        from repro_torch.kernels import ops as kernel_ops
        m, ns = kernel_ops.fused_sweeps(
            init_m, chip, color, betas, noise_state,
            getattr(noise_fn, "spec", None),
            clamp_mask=clamp_mask, clamp_values=clamp_values,
            sparse=(backend == "fused_sparse"))
        return m, ns, None

    sweep = make_sweep_fn(chip, color, noise_fn, clamp_mask, clamp_values,
                          _resolve_kernel(backend, kernel))
    m, ns = init_m, noise_state
    traj = []
    for beta in betas:
        m, ns = sweep(m, ns, beta)
        if collect:
            traj.append(m)
    if collect:
        traj = (torch.stack(traj) if traj
                else init_m.new_zeros((0,) + tuple(init_m.shape)))
    return m, ns, (traj if collect else None)


def gibbs_stats(
    chip: EffectiveChip,
    color: torch.Tensor,
    init_m: torch.Tensor,
    beta: float,
    n_sweeps: int,
    burn_in: int,
    noise_state,
    noise_fn: NoiseFn,
    edges: torch.Tensor,
    clamp_mask: torch.Tensor | None = None,
    clamp_values: torch.Tensor | None = None,
    kernel: Callable | None = None,
    backend: str | None = None,
):
    """Accumulate first/second moments on-line (no trajectory storage).

    Returns (mean_spin[N], mean_edge_corr[E], final_m, noise_state), with
    moments averaged over chains and post-burn-in sweeps — exactly the
    statistics contrastive divergence needs.  With backend="fused" or
    "fused_sparse" the whole phase (every sweep AND the moment
    accumulation) is one kernel launch; edge correlations are read out of
    the Gram matrix (dense) or the (D, N) per-slot table (slot layout).
    Every division by a count is a multiply by its float32 reciprocal, as
    the reference compiles it.
    """
    backend = resolve_backend(backend)
    dev = init_m.device
    edges = torch.as_tensor(edges, device=dev).to(torch.int64)
    e0, e1 = edges[:, 0], edges[:, 1]
    betas = torch.full((n_sweeps,), beta, dtype=torch.float32, device=dev)
    denom = max(n_sweeps - burn_in, 1)
    measured = (torch.arange(n_sweeps, device=dev) >= burn_in).to(
        torch.float32)

    if _use_fused(backend, kernel):
        from repro_torch.kernels import ops as kernel_ops
        sparse = backend == "fused_sparse"
        m, ns, s_sum, c_sum = kernel_ops.fused_sweeps(
            init_m, chip, color, betas, noise_state,
            getattr(noise_fn, "spec", None),
            clamp_mask=clamp_mask, clamp_values=clamp_values,
            measured=measured, sparse=sparse)
        inv = _recip(np.float32(denom) * np.float32(init_m.shape[0])).to(dev)
        if sparse:
            # edge (i, j) lives at slot row d with nbr_idx[d, i] == j
            slot = torch.argmax(
                (chip.nbr_idx[:, e0] == e1[None, :]).to(torch.int8), dim=0)
            c_edge = c_sum[slot, e0]
        else:
            c_edge = c_sum[e0, e1]
        return s_sum * inv, c_edge * inv, m, ns

    sweep = make_sweep_fn(chip, color, noise_fn, clamp_mask, clamp_values,
                          _resolve_kernel(backend, kernel))
    inv_b = _recip(init_m.shape[0]).to(dev)
    m, ns = init_m, noise_state
    s_sum = torch.zeros((init_m.shape[1],), dtype=torch.float32, device=dev)
    c_sum = torch.zeros((edges.shape[0],), dtype=torch.float32, device=dev)
    for t in range(n_sweeps):
        m, ns = sweep(m, ns, betas[t])
        w = measured[t]
        s_sum = s_sum + w * (m.sum(dim=0) * inv_b)
        c_sum = c_sum + w * ((m[:, e0] * m[:, e1]).sum(dim=0) * inv_b)
    inv = _recip(denom).to(dev)
    return s_sum * inv, c_sum * inv, m, ns


def gibbs_visible_hist(
    chip: EffectiveChip,
    color: torch.Tensor,
    init_m: torch.Tensor,
    betas: torch.Tensor,
    burn_in: int,
    noise_state,
    noise_fn: NoiseFn,
    visible_idx: np.ndarray,
    backend: str | None = None,
    clamp_mask: torch.Tensor | None = None,
    clamp_values: torch.Tensor | None = None,
):
    """Free-run and histogram the visible bit patterns, streaming.

    Returns (counts[2^nv], final_m, noise_state): counts[c] is the number
    of (chain, post-burn-in sweep) samples whose visible spins encode c
    (`energy.empirical_visible_dist` code order).  The fused backend
    accumulates the histogram inside the kernel; a clamped call, philox
    noise or a visible set wider than the kernel's histogram use the
    half-sweep loop.
    """
    from repro_torch.kernels.sweep_fused import MAX_HIST_VISIBLE
    backend = resolve_backend(backend)
    dev = init_m.device
    visible_idx = np.asarray(visible_idx)
    nv = int(visible_idx.shape[0])
    n_sweeps = betas.shape[0]
    measured = (torch.arange(n_sweeps, device=dev) >= burn_in).to(
        torch.float32)

    if backend in FUSED_BACKENDS and clamp_mask is None:
        spec = getattr(noise_fn, "spec", None)
        if (spec is not None and spec.kind in ("counter", "lfsr")
                and nv <= MAX_HIST_VISIBLE):
            from repro_torch.kernels import ops as kernel_ops
            m, ns, hist = kernel_ops.fused_visible_hist(
                init_m, chip, color, betas, noise_state, spec, visible_idx,
                measured, sparse=(backend == "fused_sparse"))
            return hist, m, ns

    sweep = make_sweep_fn(chip, color, noise_fn, clamp_mask, clamp_values,
                          _resolve_kernel(backend, None))
    vis = torch.as_tensor(visible_idx, device=dev).to(torch.int64)
    pow2 = 2 ** torch.arange(nv, device=dev)
    m, ns = init_m, noise_state
    hist = torch.zeros((2 ** nv,), dtype=torch.float32, device=dev)
    for t in range(n_sweeps):
        m, ns = sweep(m, ns, betas[t])
        codes = ((m[:, vis] > 0).to(torch.int64) * pow2).sum(dim=1)
        hist = hist.index_add(
            0, codes, measured[t].expand(codes.shape[0]))
    return hist, m, ns


def random_spins(gen: torch.Generator, batch: int, n_nodes: int,
                 device="cuda") -> torch.Tensor:
    """Uniform ±1 spins, float32 (B, N), drawn from ``gen`` on ``device``."""
    bits = torch.randint(0, 2, (batch, n_nodes), generator=gen,
                         device=device)
    return (bits.to(torch.float32) * 2.0 - 1.0)
