"""Unified solver API: declarative `SamplerSpec` -> resolved `Session`.

    spec = api.SamplerSpec(graph=g, hw=hw, mismatch=mism,
                           noise="counter", backend="auto",
                           schedule=api.Anneal(0.05, 3.0, n_sweeps=600),
                           chains=64)               # device="cuda"
    session = api.Session(spec)       # env + backend + device resolved HERE
    chip = session.program(J_codes, h_codes)
    state = session.init_state(session.generator(0))
    m, ns, _ = session.sample(chip, state.m, state.noise_state)
    prog = session.make_program(J_edge_codes, h_codes)   # or as an operand
    m, ns, _ = session.sample_program(prog, state.m, state.noise_state)

`core.cd.PBitMachine.session(...)` builds specs/sessions from the familiar
machine object.  A spec with ``mesh=core.distributed.make_mesh((4,),
("data",))``, ``partition=api.Partition(rows="data")`` and
``sync=api.Sync(...)`` runs row-band sharded (`core.distributed`); a spec
with ``faults=api.sample_faults(seed, g, stuck_rate=..., dead_rate=...)``
samples a faulty chip on every backend.  Counterpart of ``repro.api``.
"""
from repro_torch.api.faults import Faults, sample_faults
from repro_torch.api.program import Program, fleet_member, stack_programs
from repro_torch.api.spec import (
    BACKENDS,
    FUSED_BACKENDS,
    IN_KERNEL_NOISE,
    NOISE_KINDS,
    SPARSE_BACKENDS,
    Anneal,
    Constant,
    Partition,
    SamplerSpec,
    Schedule,
    Sync,
    Tempered,
    resolve_backend,
)
from repro_torch.api.session import (
    Session,
    SessionState,
    program,
    program_chip,
    program_edges,
    program_master,
)

__all__ = [
    "BACKENDS", "FUSED_BACKENDS", "IN_KERNEL_NOISE", "NOISE_KINDS",
    "SPARSE_BACKENDS",
    "Schedule", "Constant", "Anneal", "Tempered",
    "SamplerSpec", "Session", "SessionState", "Partition", "Sync",
    "Faults", "sample_faults",
    "program", "program_edges", "program_master",
    "Program", "fleet_member", "program_chip", "stack_programs",
    "resolve_backend",
]
