"""State carried across: numpy arrays -> the port's objects on a device.

The reference (`repro`, JAX) and this package never import each other.
What crosses between them crosses as numpy: ``np.asarray`` of a spin or
noise array, or the leaves of an `EffectiveChip` / `Mismatch` /
`SparseMismatch` / `LatticeChip` in field order (what
``jax.tree_util.tree_leaves`` gives, with absent ``None`` fields dropped)
or a ``{field: array}`` dict; a `Program` crosses as a ``{field: array}``
dict, an `api.Faults` as the reference's ``dataclasses.asdict`` of it and a
CD training state as the reference's ``CDTrainState.tree`` (numpy leaves).
The tests use only these functions to move state between the packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.faults import Faults
from repro_torch.api.program import Program
from repro_torch.core import lfsr as lfsr_mod
from repro_torch.core.distributed import LatticeChip
from repro_torch.core.hardware import EffectiveChip, Mismatch, SparseMismatch

_CHIP_FIELDS = tuple(f.name for f in dataclasses.fields(EffectiveChip))
_MISMATCH_FIELDS = tuple(f.name for f in dataclasses.fields(Mismatch))
_LATTICE_FIELDS = tuple(f.name for f in dataclasses.fields(LatticeChip))


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32).copy(), device=device)


def _named(arrays, fields) -> dict:
    """A ``{field: array}`` dict, or leaves in the order of ``fields``."""
    if isinstance(arrays, dict):
        return dict(arrays)
    arrays = list(arrays)
    if len(arrays) != len(fields):
        raise ValueError(
            f"expected {len(fields)} arrays in field order {fields}, got "
            f"{len(arrays)}")
    return dict(zip(fields, arrays))


def chip_from_numpy(arrays, device="cuda") -> EffectiveChip:
    """`EffectiveChip` from its numpy leaves or a ``{field: array}`` dict.

    Leaves come in field order ``(W, h, tanh_gain, tanh_offset, rand_gain,
    comp_offset, nbr_idx, nbr_w)`` with ``None`` fields absent: 8 arrays
    for a chip with both layouts, 7 for a sparse-native chip (no ``W``),
    6 for a dense-only chip (no slot pair)."""
    if not isinstance(arrays, dict):
        arrays = list(arrays)
        fields = {8: _CHIP_FIELDS, 7: _CHIP_FIELDS[1:],
                  6: _CHIP_FIELDS[:6]}.get(len(arrays), _CHIP_FIELDS)
        arrays = _named(arrays, fields)
    kw = {}
    for name in _CHIP_FIELDS:
        a = arrays.get(name)
        if a is None:
            kw[name] = None
        elif name == "nbr_idx":
            kw[name] = torch.as_tensor(
                np.asarray(a, np.int32).copy(), device=device)
        else:
            kw[name] = _f32(a, device)
    return EffectiveChip(**kw)


def mismatch_from_numpy(arrays, device="cuda") -> Mismatch | SparseMismatch:
    """Dense or sparse mismatch from its 8 numpy leaves (field order) or a
    dict; a (D, N) or (N, N) ``edge_gain`` with D != N tells which.  A
    stacked fleet draw (every leaf with a leading K axis, as
    ``PBitMachine.fleet_mismatch`` returns it in both packages) converts
    the same way, into a stacked record."""
    named = _named(arrays, _MISMATCH_FIELDS)
    n = np.asarray(named["tanh_gain"]).shape[-1]
    dense = np.asarray(named["edge_gain"]).shape[-2:] == (n, n) and \
        np.asarray(named["dac_bit_j"]).shape[-3:] == (n, n, 8)
    cls = Mismatch if dense else SparseMismatch
    return cls(**{k: _f32(named[k], device) for k in _MISMATCH_FIELDS})


def program_from_numpy(fields: dict, device="cuda") -> Program:
    """`api.Program` from a ``{field: array}`` dict (absent or ``None``
    fields stay absent): int32 codes, a bool clamp mask, float32 clamp
    values and betas; ``mismatch`` as `mismatch_from_numpy` takes it
    (leaves or a dict, stacked or not).  Stacked fields convert as they
    are."""
    def opt(name, dtype):
        a = fields.get(name)
        return None if a is None else torch.as_tensor(
            np.asarray(a, dtype).copy(), device=device)

    mm = fields.get("mismatch")
    return Program(
        J_codes=opt("J_codes", np.int32), h_codes=opt("h_codes", np.int32),
        mismatch=None if mm is None else mismatch_from_numpy(mm, device),
        clamp_mask=opt("clamp_mask", bool),
        clamp_values=opt("clamp_values", np.float32),
        betas=opt("betas", np.float32))


def lattice_from_numpy(arrays, device="cuda") -> LatticeChip:
    """`core.distributed.LatticeChip` from its 12 numpy leaves in field
    order ``(W_vh, W_hv, Wv_dn, Wv_up, Wh_rt, Wh_lt, h_v, h_h, gain_v,
    gain_h, off_v, off_h)`` or a ``{field: array}`` dict, float32."""
    named = _named(arrays, _LATTICE_FIELDS)
    return LatticeChip(**{k: _f32(named[k], device) for k in _LATTICE_FIELDS})


def noise_state_from_numpy(state, device="cuda") -> torch.Tensor:
    """uint32 counter pair ``(2,)`` or LFSR registers ``(B, C)`` -> the
    port's public int32 bit-pattern tensor (bit for bit)."""
    return lfsr_mod.state_from_numpy(np.asarray(state), device=device)


def noise_state_to_numpy(state: torch.Tensor) -> np.ndarray:
    """Public int32 bit-pattern noise state -> numpy uint32 (bit for bit)."""
    return lfsr_mod.state_to_numpy(state)


def spins_from_numpy(m, device="cuda") -> torch.Tensor:
    """(B, N) ±1 spins -> float32 tensor."""
    return _f32(m, device)


def _plain(x):
    """A numpy scalar (or nested tuple of them) as Python numbers."""
    if isinstance(x, (tuple, list, np.ndarray)):
        return tuple(_plain(v) for v in x)
    return x.item() if isinstance(x, np.generic) else x


def faults_from_reference_fields(fields: dict) -> Faults:
    """`api.Faults` from the reference's ``dataclasses.asdict(faults)``:
    the same field values, so the two compare equal field for field."""
    names = {f.name for f in dataclasses.fields(Faults)}
    extra = set(fields) - names
    if extra:
        raise ValueError(f"not fields of Faults: {sorted(extra)}")
    return Faults(**{k: _plain(v) for k, v in fields.items()})


def cd_state_from_numpy(tree: dict, epoch: int = 0, device="cuda"):
    """`core.cd.CDTrainState` from the reference's ``CDTrainState.tree``
    (numpy leaves ``Jm, hm, m, noise_state, vel_J, vel_h``; its
    ``base_key`` is the reference's own and is not carried).  The noise
    state must be the counter pair or LFSR registers (uint32)."""
    from repro_torch.core.cd import CDTrainState
    return CDTrainState(
        Jm=_f32(tree["Jm"], device), hm=_f32(tree["hm"], device),
        m=_f32(tree["m"], device),
        noise_state=noise_state_from_numpy(tree["noise_state"], device),
        vel_J=_f32(tree["vel_J"], device), vel_h=_f32(tree["vel_h"], device),
        epoch=int(epoch))
