"""The port's sharding rules (`repro_torch.models.sharding`) and the step
specs built on them (`repro_torch.launch.steps`) against the reference's,
at full width for all ten architectures, on both production meshes.

Everything here is shapes: the reference's trees come from
``jax.eval_shape`` and the port's from fake tensors, so no parameter is
drawn.  Specs compare entry for entry (the port's `PartitionSpec` is a
tuple), keyed by the reference's ``keystr``; every leaf's per-device
shape equals ``jax.sharding.NamedSharding(AbstractMesh(...), spec)``'s.
The ``fsdp`` preset is read at import in both packages: the reference's
specs come from one subprocess with ``REPRO_PARALLELISM=fsdp``, the
port's from a copy of its module loaded under the same environment.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs.base import LM_SHAPES as R_SHAPES
from repro.configs.base import shape_applicable
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as ref_config
from repro.launch import steps as RS
from repro.models import model as RM
from repro.models import sharding as RSH
from repro_torch.configs.base import LM_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as PS
from repro_torch.models import model as PM
from repro_torch.models import sharding as PSH

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}
AXES = {"pod": ("data", "model"), "multipod": ("pod", "data", "model")}


class _ShapeOnly:
    """What the reference's `spec` reads of a mesh: its shape."""

    def __init__(self, tag):
        self.shape = dict(zip(AXES[tag], MESHES[tag]))


def _ref_specs(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _ref_leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def states():
    """Per arch, once: both packages' abstract train states (32- and
    8-bit moments) at full width."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = {
                bits: (RS.abstract_train_state(ref_config(arch), bits),
                       PS.abstract_train_state(get_config(arch), bits))
                for bits in (32, 8)}
        return cache[arch]
    return get


def _assert_specs_equal(port_tree, ref_tree, port_specs, ref_specs, tag):
    """Same keys, equal specs, each leaf's shape and dtype equal to the
    reference's, and its shard shape equal to the reference's
    NamedSharding on an AbstractMesh."""
    got = dict(PSH.leaves_with_path(port_specs))
    want = _ref_specs(ref_specs)
    assert set(got) == set(want)
    shapes = dict(PSH.leaves_with_path(port_tree))
    ref_shapes = _ref_leaves(ref_tree)
    amesh = AbstractMesh(MESHES[tag], AXES[tag])
    pmesh = make_mesh(MESHES[tag], AXES[tag])
    for key, w in want.items():
        assert tuple(got[key]) == tuple(w), key
        shape = tuple(shapes[key].shape)
        assert shape == tuple(ref_shapes[key].shape), key
        assert str(shapes[key].dtype).split(".")[-1] == \
            str(ref_shapes[key].dtype), key
        assert PSH.NamedSharding(pmesh, got[key]).shard_shape(shape) == \
            JNamedSharding(amesh, w).shard_shape(shape), key


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_moment_specs_match_reference(states, arch, tag):
    """`param_specs` and `_opt_moment_specs` (float32 and 8-bit moments)
    equal the reference's leaf for leaf, at full width."""
    pmesh = make_mesh(MESHES[tag], AXES[tag])
    for bits, ((rp, ro), (pp, po)) in states(arch).items():
        if bits == 32:
            _assert_specs_equal(pp, rp, PSH.param_specs(pp, pmesh),
                                RSH.param_specs(rp, _ShapeOnly(tag)), tag)
        for moment in ("mu", "nu"):
            _assert_specs_equal(
                getattr(po, moment), getattr(ro, moment),
                PS._opt_moment_specs(getattr(po, moment), pmesh),
                RS._opt_moment_specs(getattr(ro, moment), _ShapeOnly(tag)),
                tag)


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, tag):
    """`batch_specs` of `train_input_specs` (train, prefill) and
    `cache_specs` of `decode_input_specs` (decode) for every applicable
    cell equal the reference's, shard shapes included."""
    pmesh = make_mesh(MESHES[tag], AXES[tag])
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in LM_SHAPES.items():
        if not shape_applicable(rcfg, R_SHAPES[name])[0]:
            continue
        if shape.kind == "decode":
            pc = PM.decode_input_specs(cfg, shape)["cache"]
            rc = RM.decode_input_specs(rcfg, R_SHAPES[name])["cache"]
            _assert_specs_equal(pc, rc, PS.cache_specs(pc, pmesh),
                                RS.cache_specs(rc, _ShapeOnly(tag)), tag)
        else:
            pb = PM.train_input_specs(cfg, shape)
            rb = RM.train_input_specs(rcfg, R_SHAPES[name])
            _assert_specs_equal(pb, rb, PS.batch_specs(pb, pmesh),
                                RS.batch_specs(rb, _ShapeOnly(tag)), tag)


_FSDP_SCRIPT = textwrap.dedent("""
    import json
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs.registry import ARCH_IDS, get_config
    from repro.models import sharding as shd
    from repro.models.model import build_model

    class M:
        def __init__(self, shape):
            self.shape = shape

    assert shd.PARALLELISM == "fsdp"
    out = {}
    for arch in ARCH_IDS:
        params = jax.eval_shape(lambda: build_model(
            get_config(arch)).init(jax.random.PRNGKey(0)))
        for tag, mesh in (("pod", {"data": 16, "model": 16}),
                          ("multipod", {"pod": 2, "data": 16, "model": 16})):
            specs = shd.param_specs(params, M(mesh))
            flat = jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))[0]
            out[f"{arch}/{tag}"] = {
                jax.tree_util.keystr(k): [list(p) if isinstance(p, tuple)
                                          else p for p in v]
                for k, v in flat}
    print(json.dumps(out))
""")


def _listed(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


def test_fsdp_preset_matches_reference(states, monkeypatch):
    """``REPRO_PARALLELISM=fsdp`` read at import: the port's module loaded
    under it gives the reference's parameter specs for all ten archs on
    both meshes; the imported module keeps the 2d preset."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_PARALLELISM="fsdp",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _FSDP_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])

    monkeypatch.setenv("REPRO_PARALLELISM", "fsdp")
    spec = importlib.util.spec_from_file_location(
        "repro_torch.models._sharding_fsdp", PSH.__file__)
    fsdp = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, fsdp)
    spec.loader.exec_module(fsdp)
    monkeypatch.delenv("REPRO_PARALLELISM")
    assert fsdp.PARALLELISM == "fsdp" and PSH.PARALLELISM == "2d"
    assert fsdp.LOGICAL_RULES["batch"] == ("pod", "data", "model")
    for arch in ARCH_IDS:
        params = states(arch)[32][1][0]
        for tag in MESHES:
            got = dict(fsdp.leaves_with_path(fsdp.param_specs(
                params, make_mesh(MESHES[tag], AXES[tag]))))
            assert {k: _listed(v) for k, v in got.items()} == \
                want[f"{arch}/{tag}"], (arch, tag)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_is_the_reference_eval_shape(states, arch):
    """`abstract_train_state` at full width: the reference's ``eval_shape``
    leaf for leaf (keys, shapes, dtypes; 8-bit `QTensor` payloads and
    scales), every leaf a fake tensor — nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensor
    for (rp, ro), (pp, po) in states(arch).values():
        got = dict(PSH.leaves_with_path((pp, po)))
        want = _ref_leaves((rp, ro))
        assert set(got) == set(want)
        for k, w in want.items():
            assert isinstance(got[k], FakeTensor), k
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k


def test_spec_divisibility_fallback():
    mesh = make_mesh((1,), ("model",))  # one logical device, axis size 1
    assert PSH.spec((40, 64), ("heads", None), mesh) == ("model", None)

    class FakeMesh:
        shape = {"data": 16, "model": 16, "pod": 2}
    s = PSH.spec((40, 64), ("heads", None), FakeMesh())
    assert s == PSH.P(None, None)    # 40 % 16 != 0 -> replicate
    s = PSH.spec((64, 64), ("heads", "fsdp"), FakeMesh())
    assert s == PSH.P("model", "data")
    # batch falls back to a prefix of (pod, data) when not divisible by 32
    s = PSH.spec((2, 8), ("batch", None), FakeMesh())
    assert s == PSH.P("pod", None)
    assert PSH.spec((2, 8), ("batch", None), None) == PSH.P()


def test_one_mesh_axis_shards_one_dim_only():
    class FakeMesh:
        shape = {"data": 16, "model": 16}
    s = PSH.spec((32768, 16, 128), ("kv_seq", "kv_heads", None), FakeMesh())
    # kv_seq takes model first; kv_heads then must replicate
    assert s == PSH.P("model", None, None)


def test_constrain_checks_the_rank_and_returns_the_tensor():
    """On logical devices of one card a layout constraint moves nothing:
    ``constrain`` returns its tensor as it is, under a mesh or not, and
    raises on names that do not match the rank."""
    import torch
    x = torch.arange(12.0).reshape(3, 4)
    with PSH.use_mesh(mesh_mod.make_host_mesh(2, 4)):
        assert PSH.current_mesh().shape == {"data": 2, "model": 4}
        assert PSH.constrain(x, ("batch", None)) is x
        with pytest.raises(ValueError, match="rank 2"):
            PSH.constrain(x, ("batch",))
    assert PSH.current_mesh() is None
    assert PSH.constrain(x, (None, None)) is x


def test_named_sharding_refuses_what_does_not_split():
    mesh = mesh_mod.make_host_mesh(2, 4)
    ns = PSH.named_sharding(mesh, (8, 6), ("fsdp", "mlp"))
    assert ns.spec == PSH.P("data", None)        # 6 % 4 != 0 -> replicate
    assert ns.shard_shape((8, 6)) == (4, 6)
    with pytest.raises(ValueError, match="split"):
        PSH.NamedSharding(mesh, PSH.P(None, "model")).shard_shape((8, 6))
    sh = PSH.param_shardings({"w_up": np.zeros((8, 8), np.float32)}, mesh)
    assert sh["w_up"].shard_shape((8, 8)) == (4, 2)
