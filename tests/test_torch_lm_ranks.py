"""The dense language model's steps across processes, held on the CPU by
gloo ranks.

* One spawn of each world size (`_torch_port.run_ranks`) runs the cases
  of `_torch_lm_ranks_cases.py` on rank meshes
  (`core.distributed.make_rank_mesh`): reduced gemma2-2b in float32, the
  reference's parameters, on 1 x 2 (tensor parallel), 2 x 1 (FSDP) and
  2 x 2.  This process runs the same cases with ``mesh=None``.  The loss,
  the gradients, the float32 moments, the prefill and decode logits agree
  to 1e-5 (the ranks add partial sums in another order: the row-parallel
  products, the batch mean, the gradient norm); the parameters after
  AdamW to 1e-5 relative plus a fifth of the learning rate absolute
  (AdamW divides each gradient by its root mean square: where a gradient
  is within a few ``eps`` of 0 its ~1e-7 relative difference moves the
  update by up to ~0.06 of the learning rate; measured 1.9e-5 at lr
  3e-4).  The greedy tokens are equal.
* A 1 x 1 rank mesh (world 1) equals ``mesh=None`` bit for bit.
* Every rank holds only its block of each parameter, moment and batch
  leaf: the shapes `NamedSharding.shard_shape` gives.
* The 2-rank loss and gradients equal the reference's own jitted
  ``value_and_grad`` on a 1 x 2 forced-host mesh with its constraints on
  (`run_forced_reference`, ``Auto`` axes).
* ``REPRO_SEQ_SHARD_ATTN=1`` with 3 heads on the 2-way model axis takes
  the flash path's ``seq_shard`` branch and equals one process.
* A one-process checkpoint resumes on 2 ranks and a 2-rank checkpoint
  in one process (`ElasticState`, whole leaves written by rank 0).
* A rank holding several positions and 8-bit moments (the dense
  model's and Whisper's) are refused on a rank mesh (the other families
  run there: `test_torch_lm_ranks_moe.py`,
  `test_torch_lm_ranks_families.py`).
* The gathers of both transports (`core.ranks`: the language model's
  `MeshComm`, the p-bit engine's `RankComm`) copy every bit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import steps
from repro_torch.models import sharding as shd
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import ElasticState

import _torch_lm_ranks_cases as cases
from _torch_port import (flat_tree, lm_state, run_forced_reference,
                         run_ranks)

TESTS = str(Path(__file__).resolve().parent)
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
TOL = 1e-5
PARAM_ATOL = 0.2 * cases.OPT.lr

_PRELUDE = """
import sys
sys.path.insert(0, {tests!r})
import _torch_lm_ranks_cases as cases
from repro_torch.core.distributed import make_rank_mesh
from repro_torch.models import sharding as shd
c = cases.cfg()
params = cases.params_of(INPUTS, c)

def mesh(shape):
    return make_rank_mesh(shape, ("data", "model"))
"""

_WORLD1 = _PRELUDE + """
for tag, m in (("none", None), ("ranks", mesh((1, 1)))):
    cases.train(save, m, c, params, tag=tag + "/train")
    cases.loss_and_grads(save, m, c, params, tag=tag + "/grads")
    cases.generate(save, m, c, params, tag=tag + "/gen")
"""

_WORLD2 = _PRELUDE + """
for name, shape in (("1x2", (1, 2)), ("2x1", (2, 1))):
    m = mesh(shape)
    cases.train(save, m, c, params, tag=name + "/train")
    cases.loss_and_grads(save, m, c, params, tag=name + "/grads")
    cases.generate(save, m, c, params, tag=name + "/gen")
    cases.loss_and_grads(save, m, c, params, tag=name + "/hw", hw=cases.HW)
cases.train(save, mesh((2, 1)), c, params, tag="micro", steps_=1,
            microbatches=2)
sc = cases.seq_shard_cfg()
with cases.seq_shard_flash():
    cases.loss_and_grads(save, mesh((1, 2)), sc, cases.params_of(dict(), sc),
                         tag="seq_shard")
cases.refusals(save, make_rank_mesh)
cases.transport(save, mesh((1, 2)))
cases.checkpoints(save, mesh((1, 2)), c, params, {ckpt_in!r}, {ckpt_out!r})
"""

_WORLD4 = _PRELUDE + """
m = mesh((2, 2))
cases.train(save, m, c, params, tag="2x2/train")
cases.loss_and_grads(save, m, c, params, tag="2x2/grads")
cases.generate(save, m, c, params, tag="2x2/gen")
"""


def _collect(fn, *args, **kw) -> dict:
    out: dict = {}

    def save(name, *arrays):
        out[name] = [a.detach().numpy() if isinstance(a, torch.Tensor)
                     else np.asarray(a) for a in arrays]
    fn(save, *args, **kw)
    return out


@pytest.fixture(scope="module")
def state():
    """The reference's reduced gemma2-2b (float32) and its parameters as
    the ranks' inputs."""
    st = lm_state("gemma2-2b", batch=cases.B, seq=cases.S)
    inputs = {"p/" + k: v.numpy() for k, v in flat_tree(st[4]).items()}
    return st, inputs


@pytest.fixture(scope="module")
def one_process(state, tmp_path_factory):
    """The cases with ``mesh=None`` in this process, and a one-process
    checkpoint after one step for the ranks to resume."""
    st, _ = state
    c, params = cases.cfg(), st[4]
    out = _collect(cases.train, None, c, params, tag="train")
    out.update(_collect(cases.loss_and_grads, None, c, params, tag="grads"))
    out.update(_collect(cases.generate, None, c, params, tag="gen"))
    out.update(_collect(cases.loss_and_grads, None, c, params, tag="hw",
                        hw=cases.HW))
    out.update(_collect(cases.train, None, c, params, tag="micro", steps_=1,
                        microbatches=2))
    sc = cases.seq_shard_cfg()
    with cases.seq_shard_flash():
        out.update(_collect(cases.loss_and_grads, None, sc,
                            cases.params_of({}, sc), tag="seq_shard"))
    ckpt_in = tmp_path_factory.mktemp("ckpt_in")
    step1 = steps.make_train_step(c, ShapeCfg("t", cases.S, cases.B,
                                              "train"), None, cases.OPT,
                                  device="cpu")
    p1 = shd.map_with_path(lambda _, x: x.clone(), params)
    o1 = adamw.init(p1)
    p1, o1, _ = step1.fn(p1, o1, cases.batch_of(c))
    from repro_torch.checkpoint import checkpoint as ckpt
    ckpt.save(ckpt_in, 1, (p1, o1))
    out["ckpt_state"] = (p1, o1)
    return out, ckpt_in


@pytest.fixture(scope="module")
def world1(state, tmp_path_factory):
    return run_ranks(_WORLD1.format(tests=TESTS), 1,
                     tmp_path_factory.mktemp("w1"), state[1])[0]


@pytest.fixture(scope="module")
def world2(state, one_process, tmp_path_factory):
    out = tmp_path_factory.mktemp("w2")
    ckpt_out = out / "ckpt_out"
    code = _WORLD2.format(tests=TESTS, ckpt_in=str(one_process[1]),
                          ckpt_out=str(ckpt_out))
    return run_ranks(code, 2, out, state[1], timeout=300), ckpt_out


@pytest.fixture(scope="module")
def world4(state, tmp_path_factory):
    return run_ranks(_WORLD4.format(tests=TESTS), 4,
                     tmp_path_factory.mktemp("w4"), state[1], timeout=300)


def _ranks_of(name, world2, world4):
    return world4 if name == "2x2" else world2[0]


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _tree_close(rank, one, tag, prefix, atol=TOL):
    keys = [k for k in one if k.startswith(f"{prefix}[")]
    assert keys, prefix
    for k in keys:
        _close(rank[f"{tag}/{k}"][0], one[k][0], atol=atol, what=k)


def test_one_by_one_rank_mesh_equals_no_mesh_bit_for_bit(world1):
    none = {k[5:]: v for k, v in world1.items() if k.startswith("none/")}
    ranks = {k[6:]: v for k, v in world1.items() if k.startswith("ranks/")}
    assert none.keys() - {"gen/comm"} == ranks.keys() - {"gen/comm"}
    for k, v in none.items():
        np.testing.assert_array_equal(ranks[k][0], v[0], err_msg=k)


@pytest.mark.parametrize("name", list(MESHES))
def test_train_steps_match_one_process(name, world2, world4, one_process):
    one = one_process[0]
    for rank in _ranks_of(name, world2, world4):
        for i in range(cases.STEPS):
            _close(rank[f"{name}/train/loss/{i}"][0],
                   one[f"train/loss/{i}"][0], what=f"loss {i}")
            _close(rank[f"{name}/train/grad_norm/{i}"][0],
                   one[f"train/grad_norm/{i}"][0], what=f"grad_norm {i}")
        _tree_close(rank, one, name, "train/mu")
        _tree_close(rank, one, name, "train/nu")
        _tree_close(rank, one, name, "train/params", atol=PARAM_ATOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_loss_and_gradients_match_one_process(name, world2, world4,
                                              one_process):
    one = one_process[0]
    for rank in _ranks_of(name, world2, world4):
        _close(rank[f"{name}/grads/loss"][0], one["grads/loss"][0])
        _tree_close(rank, one, name, "grads/grads")


@pytest.mark.parametrize("name", list(MESHES))
def test_prefill_and_decode_match_one_process(name, world2, world4,
                                              one_process):
    one = one_process[0]
    for rank in _ranks_of(name, world2, world4):
        for i in range(cases.GEN):
            _close(rank[f"{name}/gen/logits/{i}"][0],
                   one[f"gen/logits/{i}"][0], what=f"logits {i}")
        np.testing.assert_array_equal(rank[f"{name}/gen/tokens"][0],
                                      one["gen/tokens"][0])
        assert int(rank[f"{name}/gen/comm"][0]) > 0


@pytest.mark.parametrize("name", list(MESHES))
def test_each_rank_holds_its_shard_shape(name, world2, world4, one_process):
    """Parameters, moments and the batch: each rank's block has the shape
    the specs give on a mesh of the same shape."""
    c = cases.cfg()
    mesh = make_mesh(MESHES[name], ("data", "model"))
    st = steps.make_train_step(c, ShapeCfg("t", cases.S, cases.B, "train"),
                               mesh, cases.OPT, device="cpu")
    pspec, ospec, bspec = st.in_specs
    p_a, o_a, b_a = st.abstract_args
    sharded = 0
    for rank in _ranks_of(name, world2, world4):
        for tag, tree, specs in (("params", p_a, pspec),
                                 ("mu", o_a.mu, ospec.mu),
                                 ("nu", o_a.nu, ospec.nu),
                                 ("batch", b_a, bspec)):
            by_key = dict(shd.leaves_with_path(specs))
            for key, leaf in shd.leaves_with_path(tree):
                want = shd.NamedSharding(mesh, by_key[key]).shard_shape(
                    leaf.shape)
                got = tuple(rank[f"shape/{name}/train/{tag}{key}"][0])
                assert got == want, (tag, key)
                sharded += want != tuple(leaf.shape)
    assert sharded > 0


def test_train_gradients_match_the_reference_meshed_step(state, world2,
                                                         tmp_path):
    """The 2-rank (1 x 2) loss and gradients against the reference's
    jitted ``value_and_grad`` under a 1 x 2 mesh with its constraints."""
    st, inputs = state
    batch = cases.batch_of(cases.cfg())
    np.savez(tmp_path / "batch.npz",
             **{k: v.numpy() for k, v in batch.items()})
    ref = run_forced_reference(f"""
        from jax.sharding import NamedSharding, PartitionSpec
        from repro.configs.registry import get_reduced_config
        from repro.launch.steps import batch_specs
        from repro.models import sharding as shd
        from repro.models.model import build_model
        mesh = auto_mesh((1, 2), ("data", "model"))
        model = build_model(get_reduced_config("gemma2-2b"))
        params = model.init(jax.random.PRNGKey(0))
        with np.load({str(tmp_path / 'batch.npz')!r}) as f:
            batch = {{k: f[k] for k in f.files}}
        ns = lambda specs: jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        with shd.use_mesh(mesh):
            fn = jax.jit(jax.value_and_grad(model.loss), in_shardings=(
                ns(shd.param_specs(params, mesh)),
                ns(batch_specs(batch, mesh))))
            loss, grads = fn(params, batch)
        save("loss", loss)
        save("grads", *jax.tree.leaves(grads))
    """, 2, tmp_path)
    for rank in world2[0]:
        _close(rank["1x2/grads/loss"][0], ref["loss"][0])
        got = [rank[f"1x2/grads/grads{k}"][0]
               for k in sorted_keys(st[4])]
        assert len(got) == len(ref["grads"])
        for g, w in zip(got, ref["grads"]):
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def sorted_keys(params):
    """The port's leaf keys in the reference's leaf order (sorted keys)."""
    keys = [k for k, _ in shd.leaves_with_path(params)]
    order = {id(x): i for i, x in enumerate(adamw.tree_leaves(params))}
    leaves = dict(shd.leaves_with_path(params))
    return sorted(keys, key=lambda k: order[id(leaves[k])])


@pytest.mark.parametrize("name", ["1x2", "2x1"])
def test_hardware_aware_loss_and_gradients_match_one_process(name, world2,
                                                             one_process):
    """The DAC quantizer's scale is the whole tensor's maximum and the
    gains are the block's channels: the same loss and gradients."""
    one = one_process[0]
    for rank in world2[0]:
        _close(rank[f"{name}/hw/loss"][0], one["hw/loss"][0])
        _tree_close(rank, one, name, "hw/grads")


def test_microbatches_match_one_process(world2, one_process):
    one = one_process[0]
    for rank in world2[0]:
        _close(rank["micro/loss/0"][0], one["micro/loss/0"][0])
        keys = [k for k in one if k.startswith("micro/mu[")]
        assert keys
        for k in keys:
            _close(rank[k][0], one[k][0], what=k)


def test_train_entry_point_on_ranks_resumes_in_one_process(tmp_path):
    """``launch.train --ranks 2`` (its own spawn, gloo, 2 x 1) logs one
    process's losses and writes a checkpoint of whole leaves, which a
    one-process run resumes."""
    import subprocess

    from repro_torch.launch import train

    argv = ["--reduced", "--steps", "2", "--log-every", "1", "--batch", "4",
            "--seq", "64", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck")]
    env = dict(__import__("os").environ, PYTHONPATH=str(
        Path(TESTS).parent / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--ranks", "2", "--backend", "gloo", "--data-model", "2", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "(2 ranks, gloo, cpu)" in proc.stdout
    ranked = [ln.split()[2] for ln in proc.stdout.splitlines()
              if ln.startswith("step")]
    one = train.main(argv[:-2] + ["--ckpt-dir", str(tmp_path / "one")])
    assert ranked == [f"loss={r['loss']:.4f}" for r in one]
    rows = train.main(["--reduced", "--steps", "3"] + argv[3:])
    assert [r["step"] for r in rows] == [3]


def test_seq_shard_attention_matches_one_process(world2, one_process):
    one = one_process[0]
    for rank in world2[0]:
        _close(rank["seq_shard/loss"][0], one["seq_shard/loss"][0])
        keys = [k for k in one if k.startswith("seq_shard/grads")]
        assert keys
        for k in keys:
            _close(rank[k][0], one[k][0], what=k)


def test_checkpoints_cross_rank_counts(world2, one_process):
    """The one-process checkpoint resumed on 2 ranks holds its values in
    blocks; the 2 ranks' checkpoint after one more step resumes in one
    process, equal to the ranks' state."""
    p1, o1 = one_process[0]["ckpt_state"]
    ranks, ckpt_out = world2
    want = flat_tree(p1)
    for rank in ranks:
        assert int(rank["ckpt/resumed_step"][0]) == 1
        for k, w in want.items():
            np.testing.assert_array_equal(rank[f"ckpt/resumed{k}"][0],
                                          w.numpy(), err_msg=k)
    c = cases.cfg()
    mesh = make_mesh((1, 1), ("data", "model"))
    st = steps.make_train_step(c, ShapeCfg("t", cases.S, cases.B, "train"),
                               mesh, cases.OPT, device="cpu")
    step, (p2, o2) = ElasticState(str(ckpt_out)).resume(
        mesh, lambda _: st.in_specs[:2], st.abstract_args[:2], device="cpu")
    assert step == 2 and int(o2.step) == 2
    # one more step in one process from the same state
    p_one, _, m = st.fn(shd.map_with_path(lambda _, x: x.clone(), p1),
                        _clone_opt(o1), cases.batch_of(c))
    _close(ranks[0]["ckpt/loss"][0], m["loss"].numpy())
    for (k, a), (_, b) in zip(shd.leaves_with_path(p2),
                              shd.leaves_with_path(p_one)):
        _close(a.numpy(), b.numpy(), atol=PARAM_ATOL, what=k)


def _clone_opt(o):
    return adamw.OptState(o.step.clone(),
                          adamw.tree_map(lambda x: x.clone(), o.mu),
                          adamw.tree_map(lambda x: x.clone(), o.nu))


@pytest.mark.parametrize("case,kind", [
    ("several_positions", "ValueError"),
    ("eight_bit_step", "NotImplementedError"),
    ("eight_bit_init", "NotImplementedError"),
    ("eight_bit_whisper", "NotImplementedError"),
])
def test_rank_mesh_refusals(case, kind, world2):
    for rank in world2[0]:
        said = str(rank[f"refused/{case}"][0])
        assert said.startswith(kind + ":"), said
        if kind == "NotImplementedError":
            assert "12e" in said, said


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"))
    assert shd.placements(shd.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        shd.placements(shd.P(("data", "pod")), mesh)


@pytest.mark.parametrize("name", [n for n, _, _ in cases.TRANSPORT_DTYPES])
def test_gathers_copy_every_bit(name, world2):
    """Both transports' gathers (a sum of integers with zeros under gloo)
    return every rank's block bit for bit: negative zeros, NaN payloads,
    infinities, and sizes that are not a multiple of 4 bytes."""
    _, dtype, bits = next(t for t in cases.TRANSPORT_DTYPES if t[0] == name)
    want = torch.cat([cases.transport_block(r, dtype) for r in range(2)]
                     ).view(bits).numpy()
    for rank in world2[0]:
        mesh_gather, pbit_gather = rank[f"transport/{name}"]
        np.testing.assert_array_equal(mesh_gather, want)
        np.testing.assert_array_equal(pbit_gather, want)


def test_nccl_with_fewer_cards_than_ranks_raises():
    """The entry points ask `core.ranks.require_cards` before spawning:
    NCCL is never turned into gloo or the CPU."""
    from repro_torch.launch import serve, train

    with pytest.raises(RuntimeError, match="NCCL runs one card a rank"):
        train.main(["--reduced", "--ranks", "2", "--backend", "nccl",
                    "--data-model", "1", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="NCCL runs one card a rank"):
        serve.main(["--reduced", "--ranks", "2", "--backend", "nccl",
                    "--data-model", "1", "2", "--device", "cpu"])
