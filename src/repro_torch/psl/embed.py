"""Minor-embedding of logical PSL spins onto a masked Chimera graph.

A logical Ising problem is all-to-all in the worst case; the chip's
Chimera fabric has degree 6.  The classic fix (Choi's TRIAD / D-Wave's
clique embedding) represents each logical spin as a *chain* of
physical spins locked together by strong ferromagnetic couplers, routed
so every logical pair's chains touch somewhere.

This embedder is the deterministic L-ladder clique layout on an M×M
window of unit cells, M = ceil(n_logical / k):

* logical spin i (block b = i // k, unit u = i % k) owns an L-shaped
  chain: the vertical-side unit-u nodes of the window column ``c0 + b``
  (all M cell rows) plus the horizontal-side unit-u nodes of the window
  row ``r0 + b`` (all M cell columns), joined by the in-cell K_{k,k}
  edge at the corner cell ``(r0 + b, c0 + b)``.  Chain length 2M,
  2M - 1 intra-chain couplers, and chains are disjoint by construction
  (distinct (block, unit) pairs).
* logical coupler (i, j), i < j, is realized on the in-cell edge
  horizontal(u_i) — vertical(u_j) of cell ``(r0 + b_i, c0 + b_j)``:
  i's horizontal ladder crosses j's vertical ladder exactly there.
  Distinct pairs land on distinct physical edges (same-block pairs
  share the corner cell with the junctions but use different K44
  edges, since units differ).

The window origin ``(r0, c0)`` is found by a deterministic first-fit
row-major scan over placements whose M×M cell window avoids every
masked cell — the same coordinate-LUT addressing the serving layer's
bucket embedder uses (`ChimeraGraph.coord_lut`).  No randomness
anywhere: the same (circuit, graph, options) always yields the same
embedding, byte for byte.

Chain strength auto-scales against the problem: ferromagnetic chain
couplers get ``chain_scale × max|J_logical|`` (default 2.0 — strong
enough that breaking a chain always costs more than violating any one
logical clause, cheap enough not to crush the logical energy scale
after 8-bit quantization).  Integer DAC codes are derived with one
shared ``code_unit = floor(127 / max(chain, |J|, |h|))`` so every
integer-valued logical weight stays *exact* in code space.  Biases are
placed whole on the chain's junction node.

`validate_embedding` re-checks the three invariants from scratch
(disjoint chains, chain connectivity through real graph edges, every
logical coupler realized) and is run on every `embed_circuit` result.

Counterpart of ``repro.psl.embed`` on the port's `ChimeraGraph`
(numpy only, identical output).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.chimera import ChimeraGraph
from repro_torch.psl.circuit import LogicalIsing


@dataclasses.dataclass(frozen=True)
class ChainEmbedding:
    """One logical->physical embedding plus its programmed code arrays.

    ``J_codes``/``h_codes`` align with ``graph.edges``/node ids — ready
    for `api.program_edges` as-is.  ``chain_nodes[i]`` lists logical
    spin i's physical chain (junction node first: the bias site and the
    majority-vote tie-breaker).
    """

    graph: ChimeraGraph
    n_logical: int
    window: tuple[int, int, int]        # (r0, c0, M) in unit cells
    chain_nodes: tuple[tuple[int, ...], ...]
    chain_edge_idx: np.ndarray          # intra-chain rows into graph.edges
    coupler_edge_idx: np.ndarray        # (E_logical,) rows into graph.edges
    chain_strength: float               # in logical-J units
    code_unit: int                      # DAC codes per logical-J unit
    J_codes: np.ndarray                 # (E_graph,) int32
    h_codes: np.ndarray                 # (N_graph,) int32

    @property
    def chain_length(self) -> int:
        return len(self.chain_nodes[0]) if self.chain_nodes else 0

    @property
    def n_physical(self) -> int:
        """Physical spins used (chains are disjoint)."""
        return sum(len(ch) for ch in self.chain_nodes)

    @property
    def overhead_spins(self) -> int:
        """Physical spins spent beyond one-per-logical."""
        return self.n_physical - self.n_logical

    def chain_index(self) -> np.ndarray:
        """(n_logical, chain_length) int32 node-id matrix (for decoding)."""
        return np.asarray(self.chain_nodes, np.int32)

    def node_to_logical(self) -> np.ndarray:
        """(N_graph,) int32: owning logical spin per node, -1 if unused."""
        out = -np.ones(self.graph.n_nodes, np.int32)
        for i, ch in enumerate(self.chain_nodes):
            out[list(ch)] = i
        return out

    def stats(self) -> dict:
        """Embedding-quality numbers the bench tracks."""
        return {
            "n_logical": int(self.n_logical),
            "n_physical": int(self.n_physical),
            "chain_length": int(self.chain_length),
            "overhead_spins": int(self.overhead_spins),
            "graph_nodes": int(self.graph.n_nodes),
            "utilization": float(self.n_physical / self.graph.n_nodes),
            "chain_strength": float(self.chain_strength),
            "code_unit": int(self.code_unit),
            "window": [int(v) for v in self.window],
        }


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def find_window(graph: ChimeraGraph, m_cells: int,
                origin: tuple[int, int] | None = None) -> tuple[int, int]:
    """First (row-major) M×M cell window avoiding every masked cell.

    An explicit ``origin`` skips the scan but is still checked — a
    pinned placement over a masked cell is an error, not a silently
    misprogrammed chip.
    """
    masked = set(graph.masked_cells)

    def ok(r0, c0):
        return all((r, c) not in masked
                   for r in range(r0, r0 + m_cells)
                   for c in range(c0, c0 + m_cells))

    if origin is not None:
        r0, c0 = int(origin[0]), int(origin[1])
        if r0 < 0 or c0 < 0 or r0 + m_cells > graph.rows \
                or c0 + m_cells > graph.cols or not ok(r0, c0):
            raise ValueError(
                f"window origin {origin} cannot host {m_cells}x{m_cells} "
                f"unmasked cells on this {graph.rows}x{graph.cols} graph")
        return r0, c0
    for r0 in range(graph.rows - m_cells + 1):
        for c0 in range(graph.cols - m_cells + 1):
            if ok(r0, c0):
                return r0, c0
    raise ValueError(
        f"no {m_cells}x{m_cells} unmasked cell window on this "
        f"{graph.rows}x{graph.cols} Chimera (masked: {graph.masked_cells})"
        f" — the circuit needs a bigger graph")


# ---------------------------------------------------------------------------
# the embedder
# ---------------------------------------------------------------------------
def embed_circuit(logical: LogicalIsing, graph: ChimeraGraph, *,
                  chain_scale: float = 2.0,
                  origin: tuple[int, int] | None = None) -> ChainEmbedding:
    """Embed a synthesized `LogicalIsing` onto ``graph``; deterministic."""
    n, k = logical.n_spins, graph.k
    if n == 0:
        raise ValueError("cannot embed an empty circuit")
    m_cells = math.ceil(n / k)
    r0, c0 = find_window(graph, m_cells, origin)
    lut = graph.coord_lut()

    chains: list[tuple[int, ...]] = []
    chain_edges: list[tuple[int, int]] = []
    for i in range(n):
        b, u = divmod(i, k)
        vert = [int(lut[r0 + r, c0 + b, 0, u]) for r in range(m_cells)]
        horiz = [int(lut[r0 + b, c0 + c, 1, u]) for c in range(m_cells)]
        nodes = vert + horiz
        if any(v < 0 for v in nodes):
            raise ValueError(
                f"window ({r0},{c0}) lost nodes to masking mid-chain "
                f"(logical spin {i})")
        # junction node first: the corner cell's vertical node is the
        # bias site and the decoder's tie-breaker
        junction = vert[b]
        chain = [junction] + [x for x in nodes if x != junction]
        chains.append(tuple(chain))
        for r in range(m_cells - 1):       # vertical inter-cell ladder
            chain_edges.append((vert[r], vert[r + 1]))
        for c in range(m_cells - 1):       # horizontal inter-cell ladder
            chain_edges.append((horiz[c], horiz[c + 1]))
        chain_edges.append((vert[b], horiz[b]))  # in-cell junction

    eidx = graph.edge_index()

    def edge_row(a: int, b: int, what: str) -> int:
        key = (min(a, b), max(a, b))
        row = eidx.get(key)
        if row is None:
            raise ValueError(f"{what}: physical edge {key} not in graph")
        return row

    chain_edge_idx = np.asarray(
        [edge_row(a, b, "chain coupler") for a, b in chain_edges], np.int64)

    coupler_rows = []
    for (i, j) in np.asarray(logical.edges):
        bi, ui = divmod(int(i), k)
        bj, uj = divmod(int(j), k)
        a = int(lut[r0 + bi, c0 + bj, 1, ui])   # i's horizontal ladder
        b = int(lut[r0 + bi, c0 + bj, 0, uj])   # j's vertical ladder
        coupler_rows.append(edge_row(a, b, f"logical coupler ({i},{j})"))
    coupler_edge_idx = np.asarray(coupler_rows, np.int64)

    # -- code scaling ----------------------------------------------------
    max_j = logical.max_coupling
    max_h = float(np.abs(logical.h).max()) if logical.h.size else 0.0
    chain_strength = chain_scale * max_j if max_j > 0 else chain_scale
    top = max(chain_strength, max_j, max_h, 1e-12)
    code_unit = int(127.0 // top)
    if code_unit < 1:
        raise ValueError(
            f"logical weights too large for 8-bit codes: max scale {top} "
            f"> 127; rescale the circuit")

    J_codes = np.zeros(graph.n_edges, np.int32)
    J_codes[chain_edge_idx] = int(round(chain_strength * code_unit))
    J_codes[coupler_edge_idx] = np.round(
        logical.J * code_unit).astype(np.int32)
    h_codes = np.zeros(graph.n_nodes, np.int32)
    roots = np.asarray([ch[0] for ch in chains])
    h_codes[roots] = np.round(logical.h * code_unit).astype(np.int32)

    emb = ChainEmbedding(
        graph=graph, n_logical=n, window=(r0, c0, m_cells),
        chain_nodes=tuple(chains), chain_edge_idx=chain_edge_idx,
        coupler_edge_idx=coupler_edge_idx, chain_strength=chain_strength,
        code_unit=code_unit, J_codes=J_codes, h_codes=h_codes)
    validate_embedding(emb, logical)
    return emb


# ---------------------------------------------------------------------------
# validity checker (re-derives the invariants from scratch)
# ---------------------------------------------------------------------------
def validate_embedding(emb: ChainEmbedding, logical: LogicalIsing) -> None:
    """Raise ValueError unless the embedding is a true minor embedding:
    disjoint chains, each chain connected via graph edges, every logical
    coupler realized on a physical edge between the right two chains."""
    g = emb.graph
    # 1. no physical spin serves two logical spins
    flat = [x for ch in emb.chain_nodes for x in ch]
    if len(flat) != len(set(flat)):
        raise ValueError("embedding reuses physical spins across chains")
    if min(flat) < 0 or max(flat) >= g.n_nodes:
        raise ValueError("embedding references nodes outside the graph")

    # adjacency restricted to the ferromagnetic chain couplers
    owner = emb.node_to_logical()
    ce = g.edges[emb.chain_edge_idx]
    for i, ch in enumerate(emb.chain_nodes):
        members = set(ch)
        adj: dict[int, list[int]] = {x: [] for x in ch}
        for a, b in ce:
            a, b = int(a), int(b)
            if a in members and b in members:
                adj[a].append(b)
                adj[b].append(a)
        # BFS over the chain's own couplers
        seen = {ch[0]}
        frontier = [ch[0]]
        while frontier:
            x = frontier.pop()
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    frontier.append(y)
        if seen != members:
            raise ValueError(
                f"chain {i} is not connected through ferromagnetic "
                f"couplers ({len(seen)}/{len(members)} reachable)")
        if any(owner[int(a)] == i and owner[int(b)] != i
               or owner[int(b)] == i and owner[int(a)] != i
               for a, b in ce):
            raise ValueError(
                f"a chain coupler of chain {i} leaves the chain")

    # 2. every logical coupler lands on an edge joining the right chains
    if emb.coupler_edge_idx.shape[0] != logical.n_edges:
        raise ValueError(
            f"{logical.n_edges} logical couplers but "
            f"{emb.coupler_edge_idx.shape[0]} realized")
    pe = g.edges[emb.coupler_edge_idx]
    for (li, lj), (a, b) in zip(np.asarray(logical.edges), pe):
        got = {int(owner[int(a)]), int(owner[int(b)])}
        if got != {int(li), int(lj)}:
            raise ValueError(
                f"logical coupler ({li},{lj}) realized on physical edge "
                f"({a},{b}) owned by chains {sorted(got)}")

    # 3. code arrays are consistent with the edge roles
    overlap = set(emb.chain_edge_idx.tolist()) \
        & set(emb.coupler_edge_idx.tolist())
    if overlap:
        raise ValueError(
            f"edges {sorted(overlap)} serve as both chain and logical "
            f"couplers")
