"""Production mesh definitions, as logical devices of one card.

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 devices, axes (pod, data, model) — the "pod"
axis carries only data parallelism, "model" stays where the fast link is.

The port of ``repro.launch.mesh``.  Its meshes are the port's
`core.distributed.Mesh`: logical devices that all live on one card, with
the reference's axis names and shapes.  A spec over such a mesh changes
no value and moves no data; per-device sizes come from the specs
(`models.sharding.NamedSharding.shard_shape`).  Several cards through
``torch.distributed`` are not built: a mesh naming more than one CUDA
device raises (`core.distributed.make_mesh`).

Functions, not module constants, and no CUDA call at import: the dry run
(`launch.dryrun`) traces on fake tensors and must never touch the card.
"""
from __future__ import annotations

from repro_torch.core.distributed import Mesh, make_mesh

# NVIDIA H100 SXM5 80 GB (roofline + napkin math), per card
PEAK_FLOPS_BF16 = 989e12   # dense bf16 tensor-core FLOP/s (H100 datasheet)
HBM_BW = 3.35e12           # HBM3 bytes/s (H100 SXM datasheet)
HBM_BYTES = 80e9           # 80 GB HBM3 (H100 SXM datasheet)
# NVLink 4: 900 GB/s per GPU, both directions together (H100 datasheet),
# so 450 GB/s one way
NVLINK_BW = 450e9
# an assumption, not a published figure: the fixed cost of one
# card-to-card transfer (launch + synchronization), in seconds
NVLINK_LAT_S = 2e-6


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh of ``data * model`` logical devices."""
    return make_mesh((data, model), ("data", "model"))


def make_line_mesh(n: int | None = None, axis: str = "data") -> Mesh:
    """1-D mesh of n logical devices — the shape the sharded p-bit
    lattice wants (cell rows partition over one axis).  A logical mesh
    has no device count to fill, so n=None means one band."""
    return make_mesh((1 if n is None else n,), (axis,))


def halo_vs_hbm_seconds(halo_bytes: int, hbm_bytes: int,
                        exchanges: float = 0.0) -> dict:
    """Napkin math for one sharded sweep: time on the card-to-card link
    moving the halo vs time streaming the local state+weights from HBM.
    Ratio << 1 means the halo exchange hides entirely behind the local
    half-sweep — the regime the O(√N) boundary guarantees.

    The keys keep the reference's names: on this card "ici" is the
    card-to-card link (NVLink, `NVLINK_BW` and `NVLINK_LAT_S`).
    ``exchanges`` is the policy's per-sweep transfer count
    (`Sync.exchanges_per_sweep()`); each transfer pays the fixed
    ``NVLINK_LAT_S`` on top of the bandwidth term, and
    ``ici_latency_share`` says how much of the link time that fixed cost
    is."""
    t_bw = halo_bytes / NVLINK_BW
    t_lat = exchanges * NVLINK_LAT_S
    t_ici = t_bw + t_lat
    t_hbm = hbm_bytes / HBM_BW
    return {"ici_s": t_ici, "hbm_s": t_hbm,
            "ici_latency_s": t_lat,
            "ici_latency_share": t_lat / max(t_ici, 1e-30),
            "ici_over_hbm": t_ici / max(t_hbm, 1e-30)}


def n_chips(mesh: Mesh) -> int:
    """The mesh's logical devices."""
    out = 1
    for v in mesh.shape.values():
        out *= v
    return out
