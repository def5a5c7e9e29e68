"""Chimera graph topology (D-Wave style), as used by the paper's chip.

Pure numpy; array-equal to ``repro.core.chimera`` (the port keeps its own
copy so that it imports nothing of the JAX package).

The chip arranges 440 spins as a 7x8 array of Chimera unit cells with one
cell replaced by bias circuits / SPI (=> 55 cells x 8 spins = 440).

Each unit cell is a K_{4,4} bipartite "restricted Boltzmann machine":
4 *vertical* nodes (side=0) fully connected to 4 *horizontal* nodes (side=1).
Inter-cell couplers connect vertical node i of cell (r, c) to vertical node i
of cells (r±1, c), and horizontal node j of (r, c) to horizontal node j of
(r, c±1).  Maximum degree is therefore 4 (in-cell) + 2 (inter-cell) = 6,
matching the paper's "each node has 6 current inputs".

Chimera is 2-colorable: color(r, c, side=0) = (r + c) % 2 and
color(r, c, side=1) = (r + c + 1) % 2 is a proper coloring (in-cell edges
cross sides; vertical inter-cell edges change r; horizontal change c).
Chromatic Gibbs therefore needs exactly two parallel half-sweeps per sweep —
the digital analogue of the chip's fully parallel analog update.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

K_CELL = 4  # nodes per side of a unit cell


@dataclasses.dataclass(frozen=True)
class ChimeraGraph:
    """Static description of a (possibly cell-masked) Chimera graph.

    Nodes of masked cells are removed entirely; all index arrays refer to the
    *compacted* node numbering [0, n_nodes).
    """

    rows: int
    cols: int
    k: int
    masked_cells: tuple[tuple[int, int], ...]
    n_nodes: int
    # per-node coordinates, shape (n_nodes,)
    node_r: np.ndarray
    node_c: np.ndarray
    node_side: np.ndarray  # 0 = vertical, 1 = horizontal
    node_k: np.ndarray     # 0..k-1 within side
    color: np.ndarray      # chromatic class in {0, 1}
    edges: np.ndarray      # (n_edges, 2) int32, i < j, compacted ids

    # ------------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def n_cells(self) -> int:
        return self.rows * self.cols - len(self.masked_cells)

    def adjacency(self) -> np.ndarray:
        """Dense boolean adjacency (n_nodes, n_nodes)."""
        a = np.zeros((self.n_nodes, self.n_nodes), dtype=bool)
        a[self.edges[:, 0], self.edges[:, 1]] = True
        a[self.edges[:, 1], self.edges[:, 0]] = True
        return a

    def degree(self) -> np.ndarray:
        a = self.adjacency()
        return a.sum(axis=1).astype(np.int32)

    def color_mask(self, color: int) -> np.ndarray:
        return self.color == color

    def cell_nodes(self, r: int, c: int, side: int | None = None) -> np.ndarray:
        """Compacted node ids of cell (r, c), optionally one side only."""
        sel = (self.node_r == r) & (self.node_c == c)
        if side is not None:
            sel &= self.node_side == side
        return np.nonzero(sel)[0].astype(np.int32)

    def validate_two_coloring(self) -> bool:
        e = self.edges
        return bool(np.all(self.color[e[:, 0]] != self.color[e[:, 1]]))

    def coord_lut(self) -> np.ndarray:
        """Coordinate -> compacted-node-id lookup table.

        ``lut[r, c, side, k]`` is the compacted node id at that Chimera
        coordinate, or -1 where the cell is masked.  This is the inverse
        of the (node_r, node_c, node_side, node_k) arrays and the basis
        of every coordinate-addressed embedding (the serving layer's
        shape buckets, the PSL chain embedder).
        """
        lut = -np.ones((self.rows, self.cols, 2, self.k), np.int64)
        lut[self.node_r, self.node_c, self.node_side,
            self.node_k] = np.arange(self.n_nodes)
        return lut

    def edge_index(self) -> dict[tuple[int, int], int]:
        """Map (i, j) with i < j -> row index into ``edges``."""
        return {(int(i), int(j)): e
                for e, (i, j) in enumerate(np.asarray(self.edges))}

    # -- fixed-degree sparse layout -------------------------------------
    def neighbor_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Fixed-degree neighbor table (ELL layout) of the coupler set.

        Returns ``(nbr_idx, nbr_mask)``, both ``(D, n_nodes)`` with
        D = max degree (k + 2 on an unmasked Chimera: k in-cell K_{k,k}
        partners + 2 chain couplers).  ``nbr_idx[d, i]`` is node i's d-th
        neighbor in ascending node order; unused slots point at i itself
        (mask False) so gathers stay in bounds and gathered weights are 0.
        Ascending order matters: it makes the slot-major sparse sum visit
        nonzeros in the same order as a sequential dense row reduction,
        which is what keeps the sparse backends bit-exact vs the dense ref
        (zeros are additive identities).

        Built from the edge list in O(E) — never materializes the dense
        adjacency, so it scales to lattices where (N, N) does not fit.
        """
        e = self.edges
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        deg = np.bincount(src, minlength=self.n_nodes)
        max_deg = int(deg.max()) if deg.size else 0
        D = max(max_deg, 1)
        starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
        slot = np.arange(src.size) - starts[src]
        nbr_idx = np.tile(np.arange(self.n_nodes, dtype=np.int32), (D, 1))
        nbr_mask = np.zeros((D, self.n_nodes), dtype=bool)
        nbr_idx[slot, src] = dst
        nbr_mask[slot, src] = True
        return nbr_idx, nbr_mask

    def edge_slots(self, nbr_idx: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Per-edge slot coordinates in the neighbor table.

        For edge e = (i, j): ``slot_ij[e]`` is the row d with
        ``nbr_idx[d, i] == j`` and ``slot_ji[e]`` the row with
        ``nbr_idx[d, j] == i`` — the two directed entries every undirected
        coupler owns in the (D, N) slot layout.
        """
        if nbr_idx is None:
            nbr_idx, _ = self.neighbor_table()
        e0, e1 = self.edges[:, 0], self.edges[:, 1]
        slot_ij = np.argmax(nbr_idx[:, e0] == e1[None, :], axis=0)
        slot_ji = np.argmax(nbr_idx[:, e1] == e0[None, :], axis=0)
        return slot_ij.astype(np.int32), slot_ji.astype(np.int32)


def make_chimera(
    rows: int,
    cols: int,
    k: int = K_CELL,
    masked_cells: Sequence[tuple[int, int]] = (),
) -> ChimeraGraph:
    """Build a Chimera graph C(rows, cols, k) with optional masked cells."""
    masked = set((int(r), int(c)) for r, c in masked_cells)
    for (r, c) in masked:
        if not (0 <= r < rows and 0 <= c < cols):
            raise ValueError(f"masked cell {(r, c)} out of range")

    # raw id -> compact id
    def raw_id(r: int, c: int, s: int, kk: int) -> int:
        return (((r * cols) + c) * 2 + s) * k + kk

    n_raw = rows * cols * 2 * k
    compact = -np.ones(n_raw, dtype=np.int64)
    node_r, node_c, node_side, node_k, color = [], [], [], [], []
    nid = 0
    for r in range(rows):
        for c in range(cols):
            if (r, c) in masked:
                continue
            for s in range(2):
                for kk in range(k):
                    compact[raw_id(r, c, s, kk)] = nid
                    node_r.append(r)
                    node_c.append(c)
                    node_side.append(s)
                    node_k.append(kk)
                    color.append((r + c + s) % 2)
                    nid += 1

    edges = []

    def add_edge(a: int, b: int) -> None:
        ca, cb = compact[a], compact[b]
        if ca >= 0 and cb >= 0:
            edges.append((min(ca, cb), max(ca, cb)))

    for r in range(rows):
        for c in range(cols):
            if (r, c) in masked:
                continue
            # in-cell K_{k,k}
            for i in range(k):
                for j in range(k):
                    add_edge(raw_id(r, c, 0, i), raw_id(r, c, 1, j))
            # vertical inter-cell (row direction, side 0)
            if r + 1 < rows and (r + 1, c) not in masked:
                for i in range(k):
                    add_edge(raw_id(r, c, 0, i), raw_id(r + 1, c, 0, i))
            # horizontal inter-cell (col direction, side 1)
            if c + 1 < cols and (r, c + 1) not in masked:
                for j in range(k):
                    add_edge(raw_id(r, c, 1, j), raw_id(r, c + 1, 1, j))

    edges_arr = np.array(sorted(set(edges)), dtype=np.int32)
    if edges_arr.size == 0:
        edges_arr = np.zeros((0, 2), dtype=np.int32)
    g = ChimeraGraph(
        rows=rows,
        cols=cols,
        k=k,
        masked_cells=tuple(sorted(masked)),
        n_nodes=nid,
        node_r=np.array(node_r, dtype=np.int32),
        node_c=np.array(node_c, dtype=np.int32),
        node_side=np.array(node_side, dtype=np.int32),
        node_k=np.array(node_k, dtype=np.int32),
        color=np.array(color, dtype=np.int32),
        edges=edges_arr,
    )
    assert g.validate_two_coloring(), "Chimera 2-coloring broken"
    return g


def make_chip_graph() -> ChimeraGraph:
    """The paper's chip: 7x8 Chimera with one cell replaced by bias/SPI.

    440 spins = (7*8 - 1) cells * 8 spins.
    """
    return make_chimera(7, 8, K_CELL, masked_cells=[(6, 7)])
