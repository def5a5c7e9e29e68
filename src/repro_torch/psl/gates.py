"""PSL gate library: invertible Boolean gates as Ising ground-state sets.

Every gate here is a small (J, h) whose *degenerate ground states* are
exactly the gate's valid truth-table rows under the repo's energy
convention (core/energy.py):

    E(m) = -1/2 sum_ij J_ij m_i m_j - sum_i h_i m_i

The constants were solved as a linear program (pin valid rows to a
common E0, force invalid rows >= E0 + gap, symmetric in the commutative
inputs) and verified by exhaustive enumeration — tests/test_psl.py
(tests/test_torch_psl.py for the port) re-derives the ground sets from
scratch for every gate.  Gaps: COPY/NOT 2, AND/OR 4, half adder 2, full
adder 2 (all in logical-J units).

Gate functions take the target `PCircuit` plus input spin ids, allocate
output/ancilla spins, superpose their (J, h) clause, and return the
output ids — so `ripple_adder` and `multiplier` are nothing but plain
Python composition over shared spins.  Bit vectors are LSB-first
everywhere.  XOR is the one gate needing an ancilla: 3-spin parity has
no pairwise Ising realization, so it is a half adder whose carry is
left free.

Counterpart of ``repro.psl.gates`` (numpy only, identical output).
"""
from __future__ import annotations

from repro_torch.psl.circuit import PCircuit

# ---------------------------------------------------------------------------
# truth tables (±1 rows, spin order as in each gate's docstring)
# ---------------------------------------------------------------------------
def _rows(n_in, fn):
    out = []
    for code in range(2 ** n_in):
        bits = [(code >> i) & 1 for i in range(n_in)]
        row = bits + list(fn(*bits))
        out.append(tuple(2 * b - 1 for b in row))
    return tuple(out)


COPY_TABLE = _rows(1, lambda a: (a,))
NOT_TABLE = _rows(1, lambda a: (1 - a,))
AND_TABLE = _rows(2, lambda a, b: (a & b,))
OR_TABLE = _rows(2, lambda a, b: (a | b,))
XOR_TABLE = _rows(2, lambda a, b: (a ^ b,))
HALF_ADDER_TABLE = _rows(2, lambda a, b: (a ^ b, a & b))
FULL_ADDER_TABLE = _rows(
    3, lambda a, b, c: ((a + b + c) & 1, (a + b + c) >> 1))


# ---------------------------------------------------------------------------
# primitive gates
# ---------------------------------------------------------------------------
def copy_gate(c: PCircuit, a: int, y: int | None = None) -> int:
    """Y = A: one ferromagnetic bond (J = +1, gap 2)."""
    y = c.spin() if y is None else y
    c.add_coupling(a, y, 1.0)
    c.add_clause("COPY", (a, y), COPY_TABLE)
    return y


def not_gate(c: PCircuit, a: int, y: int | None = None) -> int:
    """Y = ¬A: one antiferromagnetic bond (J = -1, gap 2)."""
    y = c.spin() if y is None else y
    c.add_coupling(a, y, -1.0)
    c.add_clause("NOT", (a, y), NOT_TABLE)
    return y


def and_gate(c: PCircuit, a: int, b: int, y: int | None = None) -> int:
    """Y = A∧B.  J = (AB: -1, AY: 2, BY: 2), h = (1, 1, -2); gap 4."""
    y = c.spin() if y is None else y
    c.add_coupling(a, b, -1.0)
    c.add_coupling(a, y, 2.0)
    c.add_coupling(b, y, 2.0)
    c.add_bias(a, 1.0)
    c.add_bias(b, 1.0)
    c.add_bias(y, -2.0)
    c.add_clause("AND", (a, b, y), AND_TABLE)
    return y


def or_gate(c: PCircuit, a: int, b: int, y: int | None = None) -> int:
    """Y = A∨B: the AND gate with all biases negated (De Morgan); gap 4."""
    y = c.spin() if y is None else y
    c.add_coupling(a, b, -1.0)
    c.add_coupling(a, y, 2.0)
    c.add_coupling(b, y, 2.0)
    c.add_bias(a, -1.0)
    c.add_bias(b, -1.0)
    c.add_bias(y, 2.0)
    c.add_clause("OR", (a, b, y), OR_TABLE)
    return y


def half_adder(c: PCircuit, a: int, b: int,
               s: int | None = None, cy: int | None = None
               ) -> tuple[int, int]:
    """(S, C) = (A⊕B, A∧B).

    J = (AB: -1, AS: 1, BS: 1, AC: 2, BC: 2, SC: -2),
    h = (A: 1, B: 1, S: -1, C: -2); gap 2.
    """
    s = c.spin() if s is None else s
    cy = c.spin() if cy is None else cy
    c.add_coupling(a, b, -1.0)
    c.add_coupling(a, s, 1.0)
    c.add_coupling(b, s, 1.0)
    c.add_coupling(a, cy, 2.0)
    c.add_coupling(b, cy, 2.0)
    c.add_coupling(s, cy, -2.0)
    c.add_bias(a, 1.0)
    c.add_bias(b, 1.0)
    c.add_bias(s, -1.0)
    c.add_bias(cy, -2.0)
    c.add_clause("HALF_ADDER", (a, b, s, cy), HALF_ADDER_TABLE)
    return s, cy


def xor_gate(c: PCircuit, a: int, b: int, y: int | None = None) -> int:
    """Y = A⊕B.  Pairwise Ising cannot express 3-spin parity (its valid
    rows are not linearly separable from the invalid ones in the
    (m_im_j, m_i) feature space), so XOR is a half adder whose carry
    ancilla is left free — the clause recorded is still pure XOR."""
    y = c.spin() if y is None else y
    half_adder(c, a, b, s=y)
    c.add_clause("XOR", (a, b, y), XOR_TABLE)
    return y


def full_adder(c: PCircuit, a: int, b: int, cin: int,
               s: int | None = None, cout: int | None = None
               ) -> tuple[int, int]:
    """(S, Cout) = A + B + Cin.

    Zero-bias, input-symmetric solution (the valid-row set is closed
    under global spin flip, so h = 0): J(input, input) = -3,
    J(input, S) = 3, J(input, Cout) = 4, J(S, Cout) = -4; gap 2.
    """
    s = c.spin() if s is None else s
    cout = c.spin() if cout is None else cout
    ins = (a, b, cin)
    for i in range(3):
        for j in range(i + 1, 3):
            c.add_coupling(ins[i], ins[j], -3.0)
    for x in ins:
        c.add_coupling(x, s, 3.0)
        c.add_coupling(x, cout, 4.0)
    c.add_coupling(s, cout, -4.0)
    c.add_clause("FULL_ADDER", (a, b, cin, s, cout), FULL_ADDER_TABLE)
    return s, cout


# ---------------------------------------------------------------------------
# composed modules (plain Python over shared spins)
# ---------------------------------------------------------------------------
def ripple_adder(c: PCircuit, a_bits, b_bits, cin: int | None = None
                 ) -> tuple[list[int], int]:
    """n-bit ripple-carry adder: (sum_bits, carry_out), LSB-first.

    Stage 0 is a half adder unless a carry-in spin is supplied.
    """
    if len(a_bits) != len(b_bits):
        raise ValueError(
            f"addend widths differ: {len(a_bits)} vs {len(b_bits)}")
    s_bits: list[int] = []
    carry = cin
    for a, b in zip(a_bits, b_bits):
        if carry is None:
            s, carry = half_adder(c, a, b)
        else:
            s, carry = full_adder(c, a, b, carry)
        s_bits.append(s)
    return s_bits, carry


def multiplier(c: PCircuit, a_bits, b_bits) -> list[int]:
    """Array multiplier: AND partial products + column carry-save
    reduction with half/full adders.  Returns the (na+nb)-bit product,
    LSB-first.  Run in reverse — product clamped, factor chains free —
    this is the chip's factorization demo.
    """
    na, nb = len(a_bits), len(b_bits)
    cols: list[list[int]] = [[] for _ in range(na + nb)]
    for i, a in enumerate(a_bits):
        for j, b in enumerate(b_bits):
            cols[i + j].append(and_gate(c, a, b))
    for col in range(len(cols)):
        while len(cols[col]) > 1:
            if col + 1 >= len(cols):
                cols.append([])
            if len(cols[col]) >= 3:
                x, y, z = cols[col][:3]
                del cols[col][:3]
                s, cy = full_adder(c, x, y, z)
            else:
                x, y = cols[col][:2]
                del cols[col][:2]
                s, cy = half_adder(c, x, y)
            cols[col].append(s)
            cols[col + 1].append(cy)
    prod = [col[0] for col in cols[:na + nb] if col]
    assert len(prod) == na + nb and all(
        len(col) == 0 for col in cols[na + nb:]), \
        "column reduction overflowed the product width"
    return prod


# ---------------------------------------------------------------------------
# ready-made circuits (ports declared, LSB-first)
# ---------------------------------------------------------------------------
def _gate_circuit(name: str, gate_fn, n_in: int = 2) -> PCircuit:
    c = PCircuit(name)
    ins = [c.spin(chr(ord("a") + i)) for i in range(n_in)]
    y = gate_fn(c, *ins)
    for i, s in enumerate(ins):
        c.mark_input(chr(ord("a") + i), s)
    c.mark_output("y", y)
    return c


def copy_circuit() -> PCircuit:
    return _gate_circuit("copy", copy_gate, n_in=1)


def not_circuit() -> PCircuit:
    return _gate_circuit("not", not_gate, n_in=1)


def and_circuit() -> PCircuit:
    return _gate_circuit("and", and_gate)


def or_circuit() -> PCircuit:
    return _gate_circuit("or", or_gate)


def xor_circuit() -> PCircuit:
    return _gate_circuit("xor", xor_gate)


def full_adder_circuit() -> PCircuit:
    """Ports: a, b, cin (inputs) -> s, cout (outputs), 1 bit each."""
    c = PCircuit("full_adder")
    a, b, cin = c.spin("a"), c.spin("b"), c.spin("cin")
    s, cout = full_adder(c, a, b, cin)
    c.mark_input("a", a)
    c.mark_input("b", b)
    c.mark_input("cin", cin)
    c.mark_output("s", s)
    c.mark_output("cout", cout)
    return c


def ripple_adder_circuit(n: int, with_cin: bool = False) -> PCircuit:
    """n-bit adder.  Ports: a, b (n bits), optional cin (1 bit) ->
    sum (n bits), cout (1 bit)."""
    c = PCircuit(f"adder{n}")
    a = c.spins("a", n)
    b = c.spins("b", n)
    cin = c.spin("cin") if with_cin else None
    s_bits, cout = ripple_adder(c, a, b, cin)
    c.mark_input("a", a)
    c.mark_input("b", b)
    if with_cin:
        c.mark_input("cin", cin)
    c.mark_output("sum", s_bits)
    c.mark_output("cout", cout)
    return c


def multiplier_circuit(n: int) -> PCircuit:
    """n×n-bit multiplier.  Ports: a, b (n bits) -> prod (2n bits).
    Clamp prod and read a/b for factorization."""
    c = PCircuit(f"mult{n}")
    a = c.spins("a", n)
    b = c.spins("b", n)
    prod = multiplier(c, a, b)
    c.mark_input("a", a)
    c.mark_input("b", b)
    c.mark_output("prod", prod)
    return c
