"""`repro_torch.launch.mesh` against `repro.launch.mesh`: the production
and host meshes as logical devices (the reference's axis names and
shapes), `n_chips`, and `halo_vs_hbm_seconds` — equal to the reference's
formula once the reference is given the port's H100 constants (patched
at test time).  Also `core.distributed.lattice_input_sharding` and
`core.hardware.measure_node_transfer` against the reference's."""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro.core import hardware as RH
from repro.core.distributed import lattice_input_sharding as ref_lis
from repro.launch import mesh as ref_mesh
from repro_torch.core import hardware as PH
from repro_torch.core.distributed import lattice_input_sharding, make_mesh
from repro_torch.launch import mesh as mesh_mod


def test_mesh_shapes_and_chip_counts():
    pod = mesh_mod.make_production_mesh()
    assert pod.axis_names == ("data", "model")
    assert pod.shape == {"data": 16, "model": 16}
    assert mesh_mod.n_chips(pod) == 256
    multi = mesh_mod.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_mod.n_chips(multi) == 512
    assert multi.devices.shape == (2, 16, 16)
    host = mesh_mod.make_host_mesh(2, 4)
    assert host.shape == {"data": 2, "model": 4}
    assert mesh_mod.n_chips(host) == 8
    assert mesh_mod.make_line_mesh(4).shape == {"data": 4}
    assert mesh_mod.make_line_mesh(3, axis="rows").shape == {"rows": 3}
    # a logical mesh has no device count to fill: None is one band
    assert mesh_mod.make_line_mesh().shape == {"data": 1}
    # the reference's n_chips reads the same shape
    assert ref_mesh.n_chips(multi) == 512


def test_h100_constants():
    assert mesh_mod.PEAK_FLOPS_BF16 == 989e12
    assert mesh_mod.HBM_BW == 3.35e12
    assert mesh_mod.HBM_BYTES == 80e9
    assert mesh_mod.NVLINK_BW == 450e9
    assert 0 < mesh_mod.NVLINK_LAT_S < 1e-4


@pytest.mark.parametrize("halo,hbm,exchanges", [
    (0, 1, 0.0), (6144, 1 << 20, 2.0), (1536, 98304, 0.5),
    (10 ** 9, 3 * 10 ** 9, 0.25), (64, 0, 4.0)])
def test_halo_vs_hbm_seconds_is_the_reference_formula(monkeypatch, halo, hbm,
                                                      exchanges):
    monkeypatch.setattr(ref_mesh, "HBM_BW", mesh_mod.HBM_BW)
    monkeypatch.setattr(ref_mesh, "ICI_BW", mesh_mod.NVLINK_BW)
    monkeypatch.setattr(ref_mesh, "ICI_LAT_S", mesh_mod.NVLINK_LAT_S)
    want = ref_mesh.halo_vs_hbm_seconds(halo, hbm, exchanges=exchanges)
    got = mesh_mod.halo_vs_hbm_seconds(halo, hbm, exchanges=exchanges)
    assert got == want


def test_several_cuda_devices_raise():
    """A mesh is logical devices of one card: naming two CUDA devices
    raises, and nothing falls back to fewer devices or to the CPU."""
    with pytest.raises(NotImplementedError, match="CUDA devices"):
        make_mesh((2,), ("data",), devices=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="CUDA devices"):
        make_mesh((2, 2), ("data", "model"),
                  devices=[torch.device("cuda", i % 2) for i in range(4)])
    one = make_mesh((2,), ("data",), devices=["cuda:0", "cuda:0"])
    assert one.shape == {"data": 2}


@pytest.mark.parametrize("rows,cols", [(("data",), ("model",)),
                                       (("data", "model"), ()),
                                       (("pod", "data"), ("model",))])
def test_lattice_input_sharding_matches_reference(rows, cols):
    multi = mesh_mod.make_production_mesh(multi_pod=True)
    amesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    got = lattice_input_sharding(multi, rows, cols)
    want = ref_lis(amesh, rows, cols)
    assert tuple(got.spec) == tuple(want.spec)
    assert got.shard_shape((512, 1024)) == \
        JNamedSharding(amesh, want.spec).shard_shape((512, 1024))


def test_measure_node_transfer_matches_reference():
    """The Fig. 8a sweep: one row per bias code, stacked, from a caller's
    sampler (a tensor here, an array for the reference)."""
    w = np.linspace(-1, 1, 7, dtype=np.float32)

    def ref_sampler(b, gain=1.0):
        return np.tanh(gain * b * w / 64.0)

    def port_sampler(b, gain=1.0):
        return torch.tanh(gain * b * torch.as_tensor(w) / 64.0)

    codes = np.arange(-128, 128, 16)
    want = RH.measure_node_transfer(ref_sampler, codes, gain=2.0)
    got = PH.measure_node_transfer(port_sampler, codes, gain=2.0)
    assert got.shape == want.shape == (len(codes), 7)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
