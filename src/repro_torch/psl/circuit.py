"""Probabilistic-spin-logic circuit IR: composable gates -> sparse (J, h).

A PSL circuit (Camsari/Sutton/Datta, "p-bits for probabilistic spin
logic") is an Ising Hamiltonian whose *degenerate ground states* are
exactly the valid truth-table rows of a Boolean circuit.  Run forward
(inputs clamped) the free spins relax to the unique consistent output;
run backward (outputs clamped) they sample the preimage — division,
factorization, SAT — for free, because a Hamiltonian has no notion of
signal direction.

`PCircuit` is the mutable builder: gate modules (psl/gates.py) allocate
logical spins and *superpose* their clause Hamiltonians onto shared
spins — composition is literally addition of (J, h) terms, which
preserves ground states because every gate's valid rows are energy-
degenerate within the gate.  `synthesize()` freezes the accumulated
terms into a `LogicalIsing`: an edge-list `(E, 2)/(E,)` sparse coupling
set plus `(N,)` biases — the exact format `core/cd.py` master weights
and the sparse backends use.  Nothing dense is ever built at any stage.

The IR also records *clauses* (which gate touched which spins, and its
valid-row table) and *clamp roles* (named input/output port groups,
LSB-first bit vectors).  Clauses give an exact satisfiability oracle for
tests and decoders; ports tell the compile layer (psl/compile.py) what
to clamp in forward vs inverse mode.

Counterpart of ``repro.psl.circuit`` (numpy only, identical output).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Clause:
    """One gate instance: which logical spins it binds, and its truth
    table as ±1 rows (the gate's degenerate ground set)."""

    gate: str
    spins: tuple[int, ...]
    table: tuple[tuple[int, ...], ...]

    def satisfied(self, assignment: Sequence[int]) -> bool:
        row = tuple(1 if assignment[s] > 0 else -1 for s in self.spins)
        return row in self.table


@dataclasses.dataclass(frozen=True)
class LogicalIsing:
    """Synthesized circuit Hamiltonian in sparse edge-list form.

    ``edges``/``J`` are the (E, 2) int32 / (E,) float32 coupling list
    (i < j, lexicographically sorted — the same canonical order
    `ChimeraGraph.edges` uses), ``h`` the (N,) float32 biases.  Ports
    are named LSB-first bit vectors of logical spin ids.
    """

    n_spins: int
    names: tuple[str, ...]
    edges: np.ndarray          # (E, 2) int32, i < j
    J: np.ndarray              # (E,) float32
    h: np.ndarray              # (N,) float32
    inputs: tuple[str, ...]    # port names, declaration order
    outputs: tuple[str, ...]
    ports: tuple[tuple[str, tuple[int, ...]], ...]  # name -> spin ids
    clauses: tuple[Clause, ...]

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def max_coupling(self) -> float:
        """max |J| over the synthesized couplers — the reference scale the
        embedder's chain strength auto-scales against."""
        return float(np.abs(self.J).max()) if self.J.size else 0.0

    def port(self, name: str) -> tuple[int, ...]:
        for pname, ids in self.ports:
            if pname == name:
                return ids
        raise KeyError(
            f"no port {name!r}; have {[p for p, _ in self.ports]}")

    def port_spins(self, names: Iterable[str]) -> tuple[int, ...]:
        out: list[int] = []
        for n in names:
            out.extend(self.port(n))
        return tuple(out)

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.n_spins, np.int32)
        np.add.at(d, self.edges[:, 0], 1)
        np.add.at(d, self.edges[:, 1], 1)
        return d

    def dense(self) -> tuple[np.ndarray, np.ndarray]:
        """Dense (N, N)/(N,) reconstruction — small-N test oracle ONLY
        (the compile path never calls this)."""
        Jd = np.zeros((self.n_spins, self.n_spins), np.float32)
        Jd[self.edges[:, 0], self.edges[:, 1]] = self.J
        Jd[self.edges[:, 1], self.edges[:, 0]] = self.J
        return Jd, self.h.copy()

    def satisfied(self, assignment: Sequence[int]) -> bool:
        """Does a full ±1 assignment satisfy every clause?"""
        return all(c.satisfied(assignment) for c in self.clauses)

    def valid_assignments(self) -> np.ndarray:
        """All clause-consistent ±1 assignments, shape (n_valid, N).

        Exact enumeration (capped at 20 spins) — the ground-state oracle
        tests/test_psl.py and tests/test_torch_psl.py check the
        synthesized Hamiltonian against.
        """
        if self.n_spins > 20:
            raise ValueError(
                f"valid_assignments enumerates 2^N states; N="
                f"{self.n_spins} > 20")
        rows = [a for a in itertools.product((-1, 1), repeat=self.n_spins)
                if self.satisfied(a)]
        return np.asarray(rows, np.int8).reshape(len(rows), self.n_spins)


class PCircuit:
    """Mutable PSL circuit builder (gate modules compose onto this).

    Spins are allocated by `spin()`; gate helpers in psl/gates.py add
    couplings/biases/clauses; `mark_input`/`mark_output` declare named
    port groups (LSB-first).  `synthesize()` freezes to `LogicalIsing`;
    `compile()`/`to_spec()` go all the way to an embedded
    `api.SamplerSpec` (psl/compile.py).
    """

    def __init__(self, name: str = "pcircuit"):
        self.name = name
        self._names: list[str] = []
        self._J: dict[tuple[int, int], float] = {}
        self._h: dict[int, float] = {}
        self._ports: dict[str, tuple[int, ...]] = {}
        self._port_order: list[str] = []
        self._inputs: list[str] = []
        self._outputs: list[str] = []
        self._clauses: list[Clause] = []

    # -- spins ----------------------------------------------------------
    @property
    def n_spins(self) -> int:
        return len(self._names)

    def spin(self, name: str | None = None) -> int:
        """Allocate one logical spin; returns its id."""
        i = len(self._names)
        self._names.append(name if name is not None else f"s{i}")
        return i

    def spins(self, prefix: str, n: int) -> list[int]:
        """Allocate an n-bit vector (LSB-first): prefix0, prefix1, ..."""
        return [self.spin(f"{prefix}{k}") for k in range(n)]

    def _check(self, i: int) -> None:
        if not 0 <= i < self.n_spins:
            raise ValueError(
                f"spin id {i} out of range (have {self.n_spins})")

    # -- Hamiltonian terms (superposition: += is gate composition) ------
    def add_coupling(self, i: int, j: int, w: float) -> None:
        self._check(i), self._check(j)
        if i == j:
            raise ValueError(f"self-coupling on spin {i}")
        key = (min(i, j), max(i, j))
        self._J[key] = self._J.get(key, 0.0) + float(w)

    def add_bias(self, i: int, w: float) -> None:
        self._check(i)
        self._h[i] = self._h.get(i, 0.0) + float(w)

    def add_clause(self, gate: str, spins: Sequence[int],
                   table: Iterable[tuple[int, ...]]) -> None:
        for s in spins:
            self._check(s)
        self._clauses.append(
            Clause(gate, tuple(int(s) for s in spins),
                   tuple(tuple(int(v) for v in row) for row in table)))

    # -- clamp roles ----------------------------------------------------
    def _mark(self, name: str, ids: Sequence[int] | int,
              role: list[str]) -> None:
        if name in self._ports:
            raise ValueError(f"port {name!r} already declared")
        ids = (ids,) if isinstance(ids, (int, np.integer)) else tuple(ids)
        for i in ids:
            self._check(int(i))
        self._ports[name] = tuple(int(i) for i in ids)
        self._port_order.append(name)
        role.append(name)

    def mark_input(self, name: str, ids: Sequence[int] | int) -> None:
        """Declare a named input port (bit vector, LSB-first).  Forward
        mode clamps these chains; inverse mode reads them out."""
        self._mark(name, ids, self._inputs)

    def mark_output(self, name: str, ids: Sequence[int] | int) -> None:
        """Declare a named output port.  Forward mode reads these out;
        inverse/factorization mode clamps them."""
        self._mark(name, ids, self._outputs)

    # -- synthesis ------------------------------------------------------
    def synthesize(self) -> LogicalIsing:
        """Freeze to the sparse edge-list Hamiltonian (drops couplers
        that cancelled to exactly zero)."""
        items = sorted((k, v) for k, v in self._J.items() if v != 0.0)
        edges = (np.asarray([k for k, _ in items], np.int32)
                 .reshape(len(items), 2))
        J = np.asarray([v for _, v in items], np.float32)
        h = np.zeros(self.n_spins, np.float32)
        for i, v in self._h.items():
            h[i] = v
        return LogicalIsing(
            n_spins=self.n_spins,
            names=tuple(self._names),
            edges=edges, J=J, h=h,
            inputs=tuple(self._inputs), outputs=tuple(self._outputs),
            ports=tuple((n, self._ports[n]) for n in self._port_order),
            clauses=tuple(self._clauses))

    # -- straight-through compile sugar (psl/compile.py) ----------------
    def compile(self, graph, **kw):
        """Synthesize + minor-embed onto ``graph`` + build the sampler
        spec: returns a `psl.compile.CompiledCircuit`."""
        from repro_torch.psl.compile import compile_circuit
        return compile_circuit(self, graph, **kw)

    def to_spec(self, graph, **kw):
        """The `api.SamplerSpec` of `compile()` — the one-call path from
        a logic netlist to a Session-ready spec."""
        return self.compile(graph, **kw).spec
