"""`repro_torch.runtime.fault_tolerance.ElasticState`: re-homing training
state onto a new mesh (the reference's `tests/test_elastic.py` on the
port, whose meshes are logical devices of one device).

* `reshard` checks every leaf's spec against the mesh and places the
  leaf (values untouched); a round trip from a 2 x 4 to a 4 x 2 mesh;
  a spec the mesh cannot hold raises.
* a checkpoint written under one mesh resumes under a shrunk and a grown
  one, bit for bit.
* a reduced gemma2-2b checkpoint written by the reference under a forced
  2 x 4 host mesh resumes in the port under a 4 x 2 logical mesh, leaf
  for leaf equal.
"""
import numpy as np
import pytest
import torch

from _torch_port import run_forced_reference
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import get_reduced_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import abstract_train_state
from repro_torch.models import sharding as shd
from repro_torch.models.model import ShapeDtype
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import ElasticState

P = shd.P


def _tree():
    return {"w": np.arange(48, dtype=np.float32).reshape(8, 6),
            "stats": {"m2": np.linspace(-1, 1, 16, dtype=np.float32)}}


def test_reshard_in_process():
    mesh = mesh_mod.make_line_mesh(1)
    tree = {"w": np.arange(8, dtype=np.float32).reshape(2, 4),
            "b": np.ones(4, np.float32)}
    out = ElasticState(ckpt_dir="unused").reshard(
        tree, mesh, {"w": P("data"), "b": P()}, device="cpu")
    assert isinstance(out["w"], torch.Tensor)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(out["b"].numpy(), tree["b"])


def test_reshard_round_trip_2x4_to_4x2():
    """A tree placed under a 2 x 4 mesh's specs, then under a 4 x 2
    mesh's (the same logical rules), comes back bit for bit."""
    params = {"tok_embed": torch.randn(64, 16),
              "blocks": {"w_up": torch.randn(3, 16, 32),
                         "w_down": torch.randn(3, 32, 16),
                         "norm": torch.randn(3, 16)}}
    state = ElasticState("unused")
    m24, m42 = mesh_mod.make_host_mesh(2, 4), mesh_mod.make_host_mesh(4, 2)
    s24 = shd.param_specs(params, m24)
    assert s24["blocks"]["w_up"] == P(None, "data", "model")
    a = state.reshard(params, m24, s24, device="cpu")
    b = state.reshard(a, m42, shd.param_specs(a, m42), device="cpu")
    for (k, x), (_, y) in zip(shd.leaves_with_path(params),
                              shd.leaves_with_path(b)):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("spec,match", [
    (P(None, "model"), "split"),           # 6 % 4 != 0
    (P("pod"), "lacks"),                   # no such axis
    (P("data", "data"), "twice"),          # one axis, two dims
    (P("data", None, None), "more entries"),
])
def test_reshard_refuses_a_spec_the_mesh_cannot_hold(spec, match):
    mesh = mesh_mod.make_host_mesh(2, 4)
    with pytest.raises(ValueError, match=match):
        ElasticState("unused").reshard(
            {"w": np.zeros((8, 6), np.float32)}, mesh, {"w": spec},
            device="cpu")


@pytest.mark.parametrize("resume_bands", [1, 4],
                         ids=["shrunk-1band", "grown-4band"])
def test_resume_across_mesh_sizes(tmp_path, resume_bands):
    """Save under 2 bands; resume under a shrunk and a grown mesh —
    bit-identical logical arrays, each spec checked on the new mesh."""
    tree = _tree()

    def make_specs(t):
        return {"w": P("data"), "stats": {"m2": P()}}

    sharded = ElasticState(str(tmp_path)).reshard(
        tree, mesh_mod.make_line_mesh(2), make_specs(tree), device="cpu")
    ckpt.save(tmp_path, 7, sharded)
    target = {"w": ShapeDtype((8, 6), torch.float32),
              "stats": {"m2": ShapeDtype((16,), torch.float32)}}
    step, out = ElasticState(str(tmp_path)).resume(
        mesh_mod.make_line_mesh(resume_bands), make_specs, target,
        device="cpu")
    assert step == 7
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(out["stats"]["m2"].numpy(),
                                  tree["stats"]["m2"])


def test_resume_refuses_a_mesh_that_cannot_hold_the_state(tmp_path):
    ckpt.save(tmp_path, 3, _tree())
    target = {"w": ShapeDtype((8, 6), torch.float32),
              "stats": {"m2": ShapeDtype((16,), torch.float32)}}
    with pytest.raises(ValueError, match="split"):
        ElasticState(str(tmp_path)).resume(
            mesh_mod.make_line_mesh(3),
            lambda t: {"w": P("data"), "stats": {"m2": P()}}, target,
            device="cpu")
    with pytest.raises(ValueError, match="stored"):
        ElasticState(str(tmp_path)).resume(
            mesh_mod.make_line_mesh(2),
            lambda t: {"w": P(), "stats": {"m2": P()}},
            {"w": ShapeDtype((6, 8), torch.float32),
             "stats": {"m2": ShapeDtype((16,), torch.float32)}},
            device="cpu")


_REF_SAVE = """
from repro.checkpoint import checkpoint as ckpt
from repro.configs.registry import get_reduced_config
from repro.models import sharding as shd
from repro.models.model import build_model
from repro.optim import adamw
from repro.runtime.fault_tolerance import ElasticState

cfg = get_reduced_config("gemma2-2b")
params = build_model(cfg).init(jax.random.PRNGKey(0))
mesh = auto_mesh((2, 4), ("data", "model"))
state = (params, adamw.init(params))
specs = (shd.param_specs(params, mesh),
         adamw.OptState(step=jax.sharding.PartitionSpec(),
                        mu=shd.param_specs(params, mesh),
                        nu=shd.param_specs(params, mesh)))
sharded = ElasticState(sys.argv[1]).reshard(state, mesh, specs)
assert len(jax.tree.leaves(sharded)[1].sharding.device_set) > 1
ckpt.save(sys.argv[1], 11, sharded)
for k, v in jax.tree_util.tree_flatten_with_path(sharded)[0]:
    save(jax.tree_util.keystr(k), v)
"""


def test_reference_checkpoint_resumes_under_another_mesh(tmp_path):
    """The reference writes reduced gemma2-2b's (params, opt_state) under
    a forced 2 x 4 mesh; the port resumes it under a 4 x 2 logical mesh
    through `ElasticState.resume`, every leaf equal."""
    ckdir = tmp_path / "ck"
    script = _REF_SAVE.replace("sys.argv[1]", repr(str(ckdir)))
    want = run_forced_reference(script, 8, tmp_path)
    cfg = get_reduced_config("gemma2-2b")
    params, opt = abstract_train_state(cfg)
    mesh = mesh_mod.make_host_mesh(4, 2)

    def make_specs(t):
        return (shd.param_specs(t[0], mesh),
                adamw.OptState(step=P(), mu=shd.param_specs(t[0], mesh),
                               nu=shd.param_specs(t[0], mesh)))

    step, (p, o) = ElasticState(str(ckdir)).resume(
        mesh, make_specs, (params, opt), device="cpu")
    assert step == 11
    got = dict(shd.leaves_with_path((p, o)))
    assert set(got) == set(want)
    for k, (w,) in want.items():
        assert got[k].dtype == getattr(torch, str(w.dtype)), k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
