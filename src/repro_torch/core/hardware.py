"""Analog hardware model of the chip's non-idealities.

`program_weights[_sparse]` compiles digital 8-bit weights through the
physics model (R-2R DAC branch mismatch, per-direction multiplier gain,
disabled-coupler leakage, soft compression, per-node tanh gain/offset, RNG
amplitude, comparator offset) into the *effective* analog quantities the
sampler sees.  Counterpart of ``repro.core.hardware``: the elementwise
order of the analog chain (DAC -> edge gain -> enable/leak ->
adjacency/mask -> compression) is the reference's, so programmed chips
agree to float32 rounding.  Mismatch *draws* come from a `torch.Generator`
and agree with the reference's only in distribution.
"""
from __future__ import annotations

import dataclasses

import torch

WMIN, WMAX = -128, 127  # 8-bit signed DAC codes


def quantize_codes(w: torch.Tensor, lsb: float = 1.0) -> torch.Tensor:
    """Float master weights -> signed 8-bit DAC codes (round half even)."""
    w = torch.as_tensor(w)
    return torch.clamp(torch.round(w / lsb), WMIN, WMAX).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """Process-variation sigmas (fraction of nominal unless noted)."""

    sigma_dac_bit: float = 0.04      # per-R-2R-branch current mismatch
    sigma_edge_gain: float = 0.05    # Gilbert multiplier gain, per direction
    sigma_tanh_gain: float = 0.08    # WTA tanh beta spread per node
    sigma_tanh_offset: float = 2.0   # input-referred offset, LSB units
    sigma_rand_gain: float = 0.05    # RNG DAC amplitude spread per node
    sigma_comp_offset: float = 0.02  # comparator offset, fraction of FS
    leak_frac: float = 0.004         # disabled-coupler leakage, fraction of FS
    compression: float = 3e-3        # soft saturation: I/(1+compression*|I|/FS)

    @staticmethod
    def ideal() -> "HardwareConfig":
        return HardwareConfig(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def is_ideal(self) -> bool:
        return all(
            getattr(self, f.name) == 0.0 for f in dataclasses.fields(self)
        )


class _TensorRecord:
    """Mixin for dataclasses of tensors: ``.to(device)`` moves every field."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        return self.tanh_gain.device


@dataclasses.dataclass
class Mismatch(_TensorRecord):
    """Sampled per-instance variation, dense layout."""

    dac_bit_j: torch.Tensor      # (N, N, 8) per-bit branch error for J DACs
    dac_bit_h: torch.Tensor      # (N, 8)
    edge_gain: torch.Tensor      # (N, N) directional multiplier gain error
    tanh_gain: torch.Tensor      # (N,)   multiplicative beta error
    tanh_offset: torch.Tensor    # (N,)   additive input offset (LSB units)
    rand_gain: torch.Tensor      # (N,)
    comp_offset: torch.Tensor    # (N,)
    leak: torch.Tensor           # (N, N) leakage of disabled couplers


@dataclasses.dataclass
class SparseMismatch(_TensorRecord):
    """Per-instance variation in the fixed-degree slot layout.

    Pair fields are (D, N) — one entry per physical coupler *direction*
    (slot d of node i); O(D·N) memory, so chip instances exist at lattice
    sizes where the dense `Mismatch` (N² and N²·8 arrays) cannot.
    """

    dac_bit_j: torch.Tensor      # (D, N, 8)
    dac_bit_h: torch.Tensor      # (N, 8)
    edge_gain: torch.Tensor      # (D, N)
    tanh_gain: torch.Tensor      # (N,)
    tanh_offset: torch.Tensor    # (N,)
    rand_gain: torch.Tensor      # (N,)
    comp_offset: torch.Tensor    # (N,)
    leak: torch.Tensor           # (D, N)

    @classmethod
    def from_dense(cls, mism: Mismatch, nbr_idx: torch.Tensor
                   ) -> "SparseMismatch":
        """Reproduce a *given* dense chip instance in the slot layout:
        gathers exactly the on-graph entries of the dense draw."""
        idx = torch.as_tensor(nbr_idx, device=mism.device).to(torch.int64)
        rows = torch.arange(mism.tanh_gain.shape[0],
                            device=mism.device)[None, :]
        return cls(
            dac_bit_j=mism.dac_bit_j[rows, idx],
            dac_bit_h=mism.dac_bit_h,
            edge_gain=mism.edge_gain[rows, idx],
            tanh_gain=mism.tanh_gain,
            tanh_offset=mism.tanh_offset,
            rand_gain=mism.rand_gain,
            comp_offset=mism.comp_offset,
            leak=mism.leak[rows, idx],
        )


def gather_mismatch(mism: Mismatch, nbr_idx: torch.Tensor) -> SparseMismatch:
    """Dense (N, N) mismatch -> (D, N) slot layout."""
    return SparseMismatch.from_dense(mism, nbr_idx)


def _draw(gen: torch.Generator, pair_shape, n: int, cfg: HardwareConfig,
          device):
    def g(shape, sigma):
        if sigma == 0.0:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return sigma * torch.randn(shape, generator=gen, device=device,
                                   dtype=torch.float32)

    return dict(
        dac_bit_j=g(pair_shape + (8,), cfg.sigma_dac_bit),
        dac_bit_h=g((n, 8), cfg.sigma_dac_bit),
        edge_gain=g(pair_shape, cfg.sigma_edge_gain),
        tanh_gain=g((n,), cfg.sigma_tanh_gain),
        tanh_offset=g((n,), cfg.sigma_tanh_offset),
        rand_gain=g((n,), cfg.sigma_rand_gain),
        comp_offset=g((n,), cfg.sigma_comp_offset),
        leak=torch.abs(g(pair_shape, cfg.leak_frac)),
    )


def sample_mismatch(gen: torch.Generator, n_nodes: int, cfg: HardwareConfig,
                    device="cuda") -> Mismatch:
    """Draw one chip instance's process variation (dense layout).

    ``gen`` is a `torch.Generator` on ``device``."""
    return Mismatch(**_draw(gen, (n_nodes, n_nodes), n_nodes, cfg, device))


def sample_mismatch_sparse(gen: torch.Generator, n_nodes: int, degree: int,
                           cfg: HardwareConfig, device="cuda"
                           ) -> SparseMismatch:
    """Draw one chip instance's process variation, slot layout (O(D·N))."""
    return SparseMismatch(**_draw(gen, (degree, n_nodes), n_nodes, cfg,
                                  device))


def _bits(w_mag: torch.Tensor) -> torch.Tensor:
    """Binary expansion of |code| in [0, 128]. Returns float (..., 8)."""
    shifts = torch.arange(8, dtype=torch.int32, device=w_mag.device)
    return ((w_mag[..., None].to(torch.int32) >> shifts) & 1).to(
        torch.float32)


def dac_transfer(code: torch.Tensor, bit_err: torch.Tensor) -> torch.Tensor:
    """R-2R DAC: signed 8-bit code -> analog current (weight-LSB units).

    Sign-magnitude current steering with per-branch mismatch:
      I = sign(code) * sum_b bit_b(|code|) * 2^b * (1 + eps_b)
    """
    code = torch.as_tensor(code, device=bit_err.device)
    sign = torch.sign(code.to(torch.float32))
    mag = torch.abs(code.to(torch.int32))
    weights = (2.0 ** torch.arange(8, dtype=torch.float32,
                                   device=bit_err.device)) * (1.0 + bit_err)
    return sign * torch.sum(_bits(mag) * weights, dim=-1)


@dataclasses.dataclass
class EffectiveChip(_TensorRecord):
    """Digital weights compiled through the analog model — what physics sees.

    W is *directional*: W[i, j] is the current injected into node i per unit
    spin m_j, so in general W != W.T under mismatch, exactly as on silicon.
    ``nbr_idx``/``nbr_w`` are the Chimera-native fixed-degree slot layout
    (`ChimeraGraph.neighbor_table`): ``nbr_w[d, i] = W[i, nbr_idx[d, i]]``.
    A chip may carry both views, or only the sparse one (W=None).
    """

    W: torch.Tensor | None     # (N, N) effective couplings, LSB units
    h: torch.Tensor            # (N,)  effective biases
    tanh_gain: torch.Tensor    # (N,)  multiplicative on beta
    tanh_offset: torch.Tensor  # (N,)  additive current offset
    rand_gain: torch.Tensor    # (N,)
    comp_offset: torch.Tensor  # (N,)
    nbr_idx: torch.Tensor | None = None  # (D, N) int32 neighbor table
    nbr_w: torch.Tensor | None = None    # (D, N) per-slot couplings

    @property
    def n_nodes(self) -> int:
        return self.h.shape[-1]

    @property
    def degree(self) -> int:
        """Slot count D of the sparse layout (0 when dense-only)."""
        return 0 if self.nbr_idx is None else int(self.nbr_idx.shape[0])


def _compress(Wdir: torch.Tensor, cfg: HardwareConfig) -> torch.Tensor:
    # soft compression from finite DAC output resistance / supply droop
    if cfg.compression > 0.0:
        return Wdir / (1.0 + cfg.compression * torch.abs(Wdir))
    return Wdir


def program_weights(
    J: torch.Tensor,
    h: torch.Tensor,
    enable: torch.Tensor,
    mism: Mismatch,
    cfg: HardwareConfig,
    adjacency: torch.Tensor | None = None,
    neighbors: torch.Tensor | None = None,
) -> EffectiveChip:
    """Compile digital (int8) weights into effective analog quantities.

    J: (N, N) symmetric codes; h: (N,) codes; enable: (N, N) bool
    coupler-enable bits; adjacency: (N, N) bool physical couplers;
    neighbors: optional (D, N) neighbor table — when given, the sparse slot
    view is attached (a gather of the final W, bit-identical entries).
    All tensors live on the mismatch's device.
    """
    dev = mism.device
    J = torch.as_tensor(J, device=dev)
    n = J.shape[0]
    Wdac = dac_transfer(J, mism.dac_bit_j)           # shared per-edge DAC
    Wdir = Wdac * (1.0 + mism.edge_gain)             # per-direction multiplier
    # enable bit: disabled couplers leak a small fraction of full scale
    Wdir = torch.where(torch.as_tensor(enable, device=dev), Wdir,
                       torch.sign(Wdir) * mism.leak * 128.0)
    if adjacency is not None:
        Wdir = torch.where(torch.as_tensor(adjacency, device=dev), Wdir, 0.0)
    Wdir = Wdir * (1.0 - torch.eye(n, dtype=Wdir.dtype, device=dev))
    Wdir = _compress(Wdir, cfg)
    chip = EffectiveChip(
        W=Wdir.to(torch.float32),
        h=dac_transfer(h, mism.dac_bit_h).to(torch.float32),
        tanh_gain=1.0 + mism.tanh_gain,
        tanh_offset=mism.tanh_offset,
        rand_gain=1.0 + mism.rand_gain,
        comp_offset=mism.comp_offset,
    )
    if neighbors is not None:
        chip = attach_sparse(chip, neighbors)
    return chip


def attach_sparse(chip: EffectiveChip, nbr_idx: torch.Tensor
                  ) -> EffectiveChip:
    """Gather the dense W into the (D, N) slot layout:
    ``nbr_w[d, i] = W[i, nbr_idx[d, i]]``.  Self-pointing padding slots
    read the (zero) diagonal."""
    idx = torch.as_tensor(nbr_idx, device=chip.device)
    rows = torch.arange(chip.n_nodes, device=chip.device)[None, :]
    nbr_w = chip.W[rows, idx.to(torch.int64)].to(torch.float32)
    return dataclasses.replace(chip, nbr_idx=idx.to(torch.int32).contiguous(),
                               nbr_w=nbr_w.contiguous())


def program_weights_sparse(
    J_slots: torch.Tensor,
    h: torch.Tensor,
    enable_slots: torch.Tensor,
    mism: SparseMismatch,
    cfg: HardwareConfig,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
) -> EffectiveChip:
    """Sparse-native programming: slot codes -> EffectiveChip with W=None.

    J_slots/enable_slots: (D, N) codes / enable bits in the neighbor-table
    layout; nbr_mask marks physical couplers.  Same elementwise chain as
    `program_weights`; never touches O(N²) memory.
    """
    dev = mism.device
    Wdac = dac_transfer(torch.as_tensor(J_slots, device=dev), mism.dac_bit_j)
    Wdir = Wdac * (1.0 + mism.edge_gain)
    Wdir = torch.where(torch.as_tensor(enable_slots, device=dev), Wdir,
                       torch.sign(Wdir) * mism.leak * 128.0)
    Wdir = torch.where(torch.as_tensor(nbr_mask, device=dev), Wdir, 0.0)
    Wdir = _compress(Wdir, cfg)
    return EffectiveChip(
        W=None,
        h=dac_transfer(h, mism.dac_bit_h).to(torch.float32),
        tanh_gain=1.0 + mism.tanh_gain,
        tanh_offset=mism.tanh_offset,
        rand_gain=1.0 + mism.rand_gain,
        comp_offset=mism.comp_offset,
        nbr_idx=torch.as_tensor(nbr_idx, device=dev).to(
            torch.int32).contiguous(),
        nbr_w=Wdir.to(torch.float32).contiguous(),
    )


def ideal_chip(J: torch.Tensor, h: torch.Tensor,
               adjacency: torch.Tensor | None = None,
               neighbors: torch.Tensor | None = None,
               device="cuda") -> EffectiveChip:
    """Zero-mismatch chip from float or int weights (the textbook p-bit)."""
    J = torch.as_tensor(J, device=device).to(torch.float32)
    n = J.shape[0]
    W = J * (1.0 - torch.eye(n, dtype=torch.float32, device=device))
    if adjacency is not None:
        W = torch.where(torch.as_tensor(adjacency, device=device), W, 0.0)
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    chip = EffectiveChip(
        W=W,
        h=torch.as_tensor(h, device=device).to(torch.float32),
        tanh_gain=ones,
        tanh_offset=0.0 * ones,
        rand_gain=ones,
        comp_offset=0.0 * ones,
    )
    if neighbors is not None:
        chip = attach_sparse(chip, neighbors)
    return chip
