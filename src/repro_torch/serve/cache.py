"""Shape-bucketed Session cache for the sampling service.

Serving many tenants means many *problems*, not many *Sessions*: a
13-spin full adder and a 440-spin chip instance differ only in which
couplers are programmed, so building a fresh `api.Session` per request
(validation, slot tables, noise, a sharded engine's partition plan and
device tables) would be paid for every sample.  Two pieces make reuse
systematic:

* **Shape buckets + minor embedding.**  Every request graph is embedded
  into the smallest Chimera bucket that contains it (coordinate
  embedding: Chimera nodes are addressed by (row, col, side, k), so a
  small grid maps into a bigger one by cell coordinates — no search).
  The request's edge-list codes are scattered into the bucket's edge
  list; couplers outside the embedded region keep code 0 (disabled), so
  the off-region spins free-run without influencing the embedded
  problem.  One Session per bucket serves every graph that fits it.
* **An LRU over `SamplerSpec.fingerprint()`.**  The fingerprint is a
  pure shape-bucket key (graph bucket, resolved backend, device type,
  partition/sync/mesh, mismatch *structure* — never drawn values): the
  programmed chip is a runtime operand of the cached Session
  (`api.Program` + `Session.sample_program`), so a cache entry needs no
  per-program state at all — dispatch is "scatter codes, call".  The
  service holds one bucket-sized spec per fingerprint and evicts
  least-recently-used Sessions under memory pressure.  Hit/miss/
  eviction counters report how often a launch found its Session built.

Counterpart of ``repro.serve.cache``; everything but the Session is
numpy and equal to the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.chimera import ChimeraGraph, make_chimera

# Bucket ladder: (rows, cols) Chimera shapes, smallest first.  (7, 8) is
# the paper's 440-spin chip (one masked cell on the real die; buckets use
# the unmasked grid so any masked variant embeds).
DEFAULT_BUCKETS = ((1, 1), (2, 2), (4, 4), (7, 8))


def bucket_shape(graph: ChimeraGraph,
                 buckets=DEFAULT_BUCKETS) -> tuple[int, int]:
    """Smallest bucket (rows, cols) containing ``graph``; oversize graphs
    get a dedicated bucket of their own shape."""
    for rows, cols in buckets:
        if graph.rows <= rows and graph.cols <= cols:
            return (int(rows), int(cols))
    return (int(graph.rows), int(graph.cols))


@dataclasses.dataclass(frozen=True)
class Embedding:
    """Coordinate embedding of a request graph into a bucket graph."""

    bucket: ChimeraGraph
    node_map: np.ndarray  # (n_small,) int — small node id -> bucket node id
    edge_map: np.ndarray  # (E_small,) int — small edge id -> bucket edge id


def embed_graph(graph: ChimeraGraph, bucket: ChimeraGraph) -> Embedding:
    """Map ``graph``'s nodes/edges into ``bucket`` by (r, c, side, k).

    Requires ``graph`` to fit (rows/cols <=, same k, and none of its
    cells masked out of the bucket).  Raises ValueError naming the
    violation — the service turns that into a request rejection.
    """
    if graph.k != bucket.k:
        raise ValueError(
            f"cannot embed k={graph.k} graph into k={bucket.k} bucket")
    if graph.rows > bucket.rows or graph.cols > bucket.cols:
        raise ValueError(
            f"graph {graph.rows}x{graph.cols} does not fit bucket "
            f"{bucket.rows}x{bucket.cols}")
    lut = bucket.coord_lut()
    node_map = lut[graph.node_r, graph.node_c, graph.node_side, graph.node_k]
    if (node_map < 0).any():
        bad = np.unique(graph.node_r[node_map < 0] * 1000
                        + graph.node_c[node_map < 0])
        raise ValueError(
            f"graph uses cells masked out of the bucket: "
            f"{[(int(b) // 1000, int(b) % 1000) for b in bad]}")
    edge_lut = bucket.edge_index()
    be = node_map[np.asarray(graph.edges)]  # (E_small, 2) bucket node ids
    edge_map = np.empty(be.shape[0], np.int64)
    for e, (a, b) in enumerate(be):
        key = (int(min(a, b)), int(max(a, b)))
        if key not in edge_lut:
            raise ValueError(
                f"graph edge {e} maps to ({key}) which is not a bucket "
                f"coupler — graph is not Chimera-structured for this bucket")
        edge_map[e] = edge_lut[key]
    return Embedding(bucket=bucket, node_map=node_map, edge_map=edge_map)


def embed_program(emb: Embedding, J_codes, h_codes
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Scatter per-edge / per-node codes into bucket-sized arrays.

    Unmapped bucket couplers keep code 0 — the chip's *disabled* state —
    so spins outside the embedded region decouple from the problem.
    """
    Jb = np.zeros(emb.bucket.edges.shape[0], np.int32)
    hb = np.zeros(emb.bucket.n_nodes, np.int32)
    Jb[emb.edge_map] = np.asarray(J_codes, np.int32)
    hb[emb.node_map] = np.asarray(h_codes, np.int32)
    return Jb, hb


def make_bucket_graph(rows: int, cols: int, k: int = 4) -> ChimeraGraph:
    """The canonical (unmasked) bucket lattice for a ladder entry."""
    return make_chimera(rows, cols, k)


def program_digest(bucket_key: tuple[int, int], J_codes, h_codes,
                   betas, clamp_mask) -> str:
    """Batch-compatibility digest: requests may share one launch iff they
    program the same chip, anneal over the same betas, and clamp the same
    node set (per-chain clamp *values* are free to differ — that is the
    multiplexing axis)."""
    h = hashlib.sha1()
    h.update(repr(bucket_key).encode())
    h.update(np.ascontiguousarray(np.asarray(J_codes, np.int32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(h_codes, np.int32)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(betas, np.float32)).tobytes())
    if clamp_mask is None:
        h.update(b"-")
    else:
        h.update(np.ascontiguousarray(
            np.asarray(clamp_mask, bool)).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class CacheEntry:
    """One built Session — programs stream in at call time.

    There is deliberately no per-program state here: with
    `Session.sample_program` the program is an operand of the Session,
    so dispatch re-scatters the O(E) codes every launch and the cache's
    only job is holding built Sessions.
    """

    session: Any                 # api.Session
    spec: Any                    # api.SamplerSpec (bucket-sized)
    embeddable: ChimeraGraph     # the bucket graph
    meshed: bool                 # built against a device mesh?
    build_s: float               # wall-clock spent constructing


class SessionCache:
    """LRU of fingerprint -> `CacheEntry` with hit/miss/eviction counters."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict[str, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, fingerprint: str) -> Optional[CacheEntry]:
        entry = self._entries.get(fingerprint)
        if entry is None:
            return None
        self._entries.move_to_end(fingerprint)
        self.hits += 1
        return entry

    def get_or_build(self, fingerprint: str,
                     build: Callable[[], CacheEntry]) -> CacheEntry:
        entry = self.get(fingerprint)
        if entry is not None:
            return entry
        self.misses += 1
        t0 = time.monotonic()
        entry = build()
        if not entry.build_s:
            entry.build_s = time.monotonic() - t0
        self._entries[fingerprint] = entry
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry

    def invalidate(self, predicate: Callable[[str, CacheEntry], bool]
                   ) -> int:
        """Drop entries matching ``predicate`` (e.g. everything compiled
        against a mesh that just lost a shard).  Returns the drop count."""
        doomed = [fp for fp, e in self._entries.items() if predicate(fp, e)]
        for fp in doomed:
            del self._entries[fp]
        return len(doomed)

    def stats(self) -> dict:
        return {"size": len(self._entries), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
