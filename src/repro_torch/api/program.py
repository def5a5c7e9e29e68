"""Runtime chip programs: the weight-streaming operand.

On silicon, reprogramming is an SPI write of DAC codes, never a new
circuit.  A `Program` is the software twin: the runtime description of one
programmed problem (edge codes, bias codes, optional clamps, optional
per-chip mismatch draw, optional schedule), handed to a `api.Session` as an
argument:

    prog = session.make_program(J_codes, h_codes)
    m, ns, _ = session.sample_program(prog, m, ns, betas)

PyTorch runs eagerly, so swapping problems builds no new kernel: the chip
is programmed from the codes on the device and the same CUDA kernels run.
Stacking programs along a leading axis (`stack_programs`) gives the
**fleet axis**: `Session.sample_fleet` and `Session.make_cd_fleet_step`
run K mismatch draws / tenants / CD replicas, member by member.

The optional ``mismatch`` field carries a per-program chip-instance draw
(the spec's type: `Mismatch` or `SparseMismatch`); ``None`` means "use
the Session spec's draw".  Counterpart of ``repro.api.program``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Program:
    """One runtime chip program: tensors, or ``None`` where a field is absent.

    ``J_codes``/``h_codes`` are signed 8-bit DAC codes in the edge-list
    layout ((E,) / (N,)); clamp fields follow `Session.sample`'s contract
    ((N,) bool mask, (B, N) values); ``betas`` optionally carries the
    program's own (S,) or (S, B) schedule; ``mismatch`` optionally
    overrides the spec's chip-instance draw.

    Fields may carry a leading fleet axis (K, ...): see `stack_programs`
    and `Session.sample_fleet`.
    """

    J_codes: torch.Tensor
    h_codes: torch.Tensor
    mismatch: object | None = None
    clamp_mask: torch.Tensor | None = None
    clamp_values: torch.Tensor | None = None
    betas: torch.Tensor | None = None


def _structure(prog: Program) -> tuple:
    """Which optional fields a program carries, and its mismatch type."""
    return tuple(getattr(prog, f.name) is None
                 for f in dataclasses.fields(prog)) + (
        type(prog.mismatch).__name__,)


def stack_fleet(values):
    """Stack K same-shaped members along a new leading fleet axis: tensors,
    or records of tensors (a mismatch draw) field by field; ``None``
    members stay ``None``.  The inverse of `fleet_member`."""
    if values[0] is None:
        return None
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    cls = type(values[0])
    return cls(**{f.name: torch.stack([getattr(v, f.name) for v in values])
                  for f in dataclasses.fields(cls)})


def stack_programs(programs) -> Program:
    """Stack same-structure programs along a new leading fleet axis.

    Every program must carry the same optional-field structure (all have
    clamps or none do, all carry a mismatch or none does).  Returns a
    `Program` whose every tensor has shape (K, ...), ready for
    `Session.sample_fleet` / `Session.make_cd_fleet_step`.
    """
    programs = list(programs)
    if not programs:
        raise ValueError("stack_programs needs at least one program")
    ref = _structure(programs[0])
    for k, p in enumerate(programs[1:], 1):
        if _structure(p) != ref:
            raise ValueError(
                f"program {k} has a different optional-field structure "
                f"than program 0; every member of a fleet must carry the "
                f"same fields")
    return Program(**{
        f.name: stack_fleet([getattr(p, f.name) for p in programs])
        for f in dataclasses.fields(Program)})


def fleet_member(x, k: int):
    """Member ``k`` of a stacked fleet: every tensor of a `Program`, a
    stacked mismatch record or a tensor indexed at ``k`` on its leading
    axis (``None`` stays ``None``)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[k]
    return dataclasses.replace(x, **{
        f.name: fleet_member(getattr(x, f.name), k)
        for f in dataclasses.fields(x)})
