"""The dense language model's steps across processes, held on the CPU by
gloo ranks.

* One spawn of each world size (`_torch_port.start_ranks`, the three
  started together with the reference's steps) runs the cases
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
  (`start_forced_reference`, ``Auto`` axes).
* ``REPRO_SEQ_SHARD_ATTN=1`` with 3 heads on the 2-way model axis takes
  the flash path's ``seq_shard`` branch and equals one process.
* A one-process checkpoint resumes on 2 ranks and a 2-rank checkpoint
  in one process (`ElasticState`, whole leaves written by rank 0).
* 8-bit AdamW moments (`optim.adamw.QTensor`, their quantization blocks
  split over ("data", "model") as the reference's ``opt_blocks`` specs
  say): a 1 x 1 rank mesh equals ``mesh=None`` bit for bit; on 1 x 2 and
  2 x 1 two steps hold the losses and gradient norms to 1e-5 and the
  state after the first step to the 8-bit contract (ROADMAP Queue 3
  item 33: parameters to 1e-5 + lr/5, codes within one, scales to 1e-6
  relative); `adamw.apply` on the ranks' own state and gradients equals
  one process's bit for bit with the clip inactive (1 x 2, 2 x 2) and by
  the contract with it active.  The step equals the reference's jitted
  meshed 8-bit step, and each rank's ``q`` and ``scale`` blocks have the
  shapes the reference's specs give.  8-bit checkpoints cross rank
  counts (one process to 1 x 2, 1 x 2 to 2 x 1).  Trajectories beyond a
  step are not held (8-bit moments make them sensitive to a gradient's
  last digit: Queue 3 item 19).
* A rank holding several positions is refused on a rank mesh.
* The gathers of both transports (`core.ranks`: the language model's
  `MeshComm`, the p-bit engine's `RankComm`) copy every bit.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import dryrun, steps
from repro_torch.models import sharding as shd
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import ElasticState

import _torch_lm_ranks_cases as cases
from _torch_port import (finish_forced_reference, finish_ranks, flat_tree,
                         lm_state, start_forced_reference, start_ranks)

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
    cases.eight_bit(save, m, c, params, tag=tag + "/q8")
"""

_WORLD2 = _PRELUDE + """
for name, shape in (("1x2", (1, 2)), ("2x1", (2, 1))):
    m = mesh(shape)
    cases.train(save, m, c, params, tag=name + "/train")
    cases.loss_and_grads(save, m, c, params, tag=name + "/grads")
    cases.generate(save, m, c, params, tag=name + "/gen")
    cases.loss_and_grads(save, m, c, params, tag=name + "/hw", hw=cases.HW)
    cases.eight_bit(save, m, c, params, tag=name + "/q8")
    cases.comm_step(save, m, c, tag=name + "/comm32")
cases.comm_step(save, mesh((1, 2)), c, tag="1x2/comm8", opt_cfg=cases.OPT8)
cases.train(save, mesh((2, 1)), c, params, tag="micro", steps_=1,
            microbatches=2)
sc = cases.seq_shard_cfg()
with cases.seq_shard_flash():
    cases.loss_and_grads(save, mesh((1, 2)), sc, cases.params_of(dict(), sc),
                         tag="seq_shard")
cases.eight_bit(save, mesh((1, 2)), c, params, tag="1x2/q8nc",
                opt=cases.OPT8_NOCLIP)
cases.refusals(save, make_rank_mesh)
cases.transport(save, mesh((1, 2)))
cases.checkpoints(save, mesh((1, 2)), c, params, {ckpt_in!r}, {ckpt_out!r})
cases.checkpoints(save, mesh((1, 2)), c, params, {ckpt8_in!r},
                  {ckpt8_out!r}, prefix="q8/", opt_cfg=cases.OPT8)
cases.checkpoints(save, mesh((2, 1)), c, params, {ckpt8_out!r},
                  {ckpt8_out2!r}, prefix="q8b/", opt_cfg=cases.OPT8,
                  asynchronous=True)
"""

_WORLD4 = _PRELUDE + """
m = mesh((2, 2))
cases.train(save, m, c, params, tag="2x2/train")
cases.loss_and_grads(save, m, c, params, tag="2x2/grads")
cases.generate(save, m, c, params, tag="2x2/gen")
cases.eight_bit(save, m, c, params, tag="2x2/q8nc", opt=cases.OPT8_NOCLIP)
cases.comm_step(save, m, c, tag="2x2/comm32")
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


def _one_step(c, params, opt_cfg):
    """One train step in one process from ``params``: (params, state)."""
    st = steps.make_train_step(c, ShapeCfg("t", cases.S, cases.B, "train"),
                               None, opt_cfg, device="cpu")
    p1 = shd.map_with_path(lambda _, x: x.clone(), params)
    p1, o1, _ = st.fn(p1, adamw.init(p1, opt_cfg.state_bits),
                      cases.batch_of(c))
    return p1, o1


@pytest.fixture(scope="module")
def ckpt_in(state, tmp_path_factory):
    """One-process checkpoints after one step, float32 and 8-bit moments,
    for the ranks to resume: {bits: (directory, (params, state))}."""
    from repro_torch.checkpoint import checkpoint as ckpt

    out = {}
    for opt_cfg in (cases.OPT, cases.OPT8):
        path = tmp_path_factory.mktemp(f"ckpt_in{opt_cfg.state_bits}")
        p1, o1 = _one_step(cases.cfg(), state[0][4], opt_cfg)
        ckpt.save(path, 1, (p1, o1))
        out[opt_cfg.state_bits] = (path, (p1, o1))
    return out


@pytest.fixture(scope="module")
def started(state, ckpt_in, tmp_path_factory):
    """The three worlds' ranks and the reference's meshed steps, started
    together (each fixture below waits for its own)."""
    w2 = tmp_path_factory.mktemp("w2")
    code2 = _WORLD2.format(
        tests=TESTS, ckpt_in=str(ckpt_in[32][0]),
        ckpt_out=str(w2 / "ckpt_out"), ckpt8_in=str(ckpt_in[8][0]),
        ckpt8_out=str(w2 / "ckpt8_out"), ckpt8_out2=str(w2 / "ckpt8_out2"))
    return {
        "reference": _start_reference(state, tmp_path_factory.mktemp("ref")),
        "world1": start_ranks(_WORLD1.format(tests=TESTS), 1,
                              tmp_path_factory.mktemp("w1"), state[1]),
        "world2": (start_ranks(code2, 2, w2, state[1]), w2),
        "world4": start_ranks(_WORLD4.format(tests=TESTS), 4,
                              tmp_path_factory.mktemp("w4"), state[1]),
    }


@pytest.fixture(scope="module")
def one_process(state, started):
    """The cases with ``mesh=None`` in this process (while the ranks run,
    on one thread as each rank: the cores are theirs)."""
    st, _ = state
    c, params = cases.cfg(), st[4]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _collect(cases.train, None, c, params, tag="train")
        out.update(_collect(cases.loss_and_grads, None, c, params,
                            tag="grads"))
        out.update(_collect(cases.generate, None, c, params, tag="gen"))
        out.update(_collect(cases.loss_and_grads, None, c, params, tag="hw",
                            hw=cases.HW))
        out.update(_collect(cases.train, None, c, params, tag="micro",
                            steps_=1, microbatches=2))
        sc = cases.seq_shard_cfg()
        with cases.seq_shard_flash():
            out.update(_collect(cases.loss_and_grads, None, sc,
                                cases.params_of({}, sc), tag="seq_shard"))
        out.update(_collect(cases.eight_bit, None, c, params, tag="q8"))
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def world1(started):
    return finish_ranks(started["world1"], timeout=300)[0]


@pytest.fixture(scope="module")
def world2(started):
    procs, out = started["world2"]
    ranks = finish_ranks(procs, timeout=300)
    return ranks, out / "ckpt_out", out / "ckpt8_out", out / "ckpt8_out2"


@pytest.fixture(scope="module")
def world4(started):
    return finish_ranks(started["world4"], timeout=300)


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


@pytest.fixture(scope="module")
def dry_runs(started):
    """`launch.dryrun.rank_trace` of every rank of the ranks' B = 32 step
    (``<mesh>/comm32``) and of 1 x 2's first 8-bit step (``1x2/q8``),
    traced in this process while the ranks run: {(tag, rank): record}."""
    c = cases.cfg()
    runs = [(f"{n}/comm32", dm, 32) for n, dm in MESHES.items()]
    runs.append(("1x2/comm8", MESHES["1x2"], 8))
    shape = ShapeCfg("t", cases.S, cases.COMM_B, "train")
    return {(tag, r): dryrun.rank_trace(c, shape, {"data": d, "model": m},
                                        r, opt_bits=bits)
            for tag, (d, m), bits in runs for r in range(d * m)}


@pytest.mark.parametrize("tag", [f"{n}/comm32" for n in MESHES]
                         + ["1x2/comm8"])
def test_dry_run_collectives_equal_the_ranks(tag, dry_runs, world2, world4):
    """The dry run's trace of a rank (`launch.dryrun.rank_trace`: the
    same step as that rank of the rank mesh, on meta tensors under a
    process group that moves nothing) makes the collectives the gloo
    rank made, call for call and byte for byte by kind: the B = 32, S =
    64 train step on 1 x 2, 2 x 1 and 2 x 2, and with 8-bit moments on
    1 x 2 (their exchanges)."""
    name = tag.split("/")[0]
    ranks = _ranks_of(name, world2, world4)
    assert len(ranks) == math.prod(MESHES[name])
    for r, rank in enumerate(ranks):
        got = dry_runs[tag, r]["collectives"]
        for kind in got["calls"]:
            assert got["calls"][kind] == int(
                rank[f"{tag}/calls/{kind}"][0]), (r, kind)
            assert got["bytes"][kind] == int(
                rank[f"{tag}/bytes/{kind}"][0]), (r, kind)
        assert sum(got["calls"].values()) > 0
    if tag.endswith("comm8"):
        assert got["calls"]["exchange"] > 0


@pytest.mark.parametrize("name", list(MESHES))
def test_train_steps_match_one_process(name, world2, world4, one_process):
    one = one_process
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
    one = one_process
    for rank in _ranks_of(name, world2, world4):
        _close(rank[f"{name}/grads/loss"][0], one["grads/loss"][0])
        _tree_close(rank, one, name, "grads/grads")


@pytest.mark.parametrize("name", list(MESHES))
def test_prefill_and_decode_match_one_process(name, world2, world4,
                                              one_process):
    one = one_process
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


def _start_reference(state, tmp):
    """The reference's jitted meshed steps on forced host devices, on the
    ranks' parameters and batch: ``value_and_grad`` of the loss under a
    1 x 2 mesh with its constraints, one 8-bit train step
    (`make_train_step(..., AdamWConfig(state_bits=8))`) on the same mesh,
    and the shard shapes its 8-bit moment specs give on 1 x 2 and 2 x 1
    (``mu`` / ``nu`` leaves in order)."""
    batch = cases.batch_of(cases.cfg())
    np.savez(tmp / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    return start_forced_reference(f"""
        from jax.sharding import NamedSharding, PartitionSpec
        from repro.configs.base import ShapeCfg
        from repro.configs.registry import get_reduced_config
        from repro.launch.steps import batch_specs, make_train_step
        from repro.models import sharding as shd
        from repro.models.model import build_model
        from repro.optim import adamw
        mesh = auto_mesh((1, 2), ("data", "model"))
        cfg = get_reduced_config("gemma2-2b")
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        with np.load({str(tmp / 'batch.npz')!r}) as f:
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
        ocfg = adamw.AdamWConfig(warmup_steps=1, state_bits=8)
        shape = ShapeCfg("t", {cases.S}, {cases.B}, "train")
        opt = adamw.init(params, 8)
        for name, dm in (("1x2", (1, 2)), ("2x1", (2, 1))):
            st = make_train_step(cfg, shape, auto_mesh(dm, ("data", "model")),
                                 ocfg)
            mo = st.in_shardings[1]
            save(f"q8/shapes/{{name}}", *[
                np.array(sh.shard_shape(x.shape)) for sh, x in zip(
                    jax.tree.leaves((mo.mu, mo.nu)),
                    jax.tree.leaves((opt.mu, opt.nu)))])
        st = make_train_step(cfg, shape, mesh, ocfg)
        p1, o1, m = st.fn(params, opt, batch)
        save("q8/loss", m["loss"])
        save("q8/grad_norm", m["grad_norm"])
        save("q8/params", *jax.tree.leaves(p1))
        save("q8/moments", *jax.tree.leaves((o1.mu, o1.nu)))
    """, 2, tmp)


@pytest.fixture(scope="module")
def reference(started):
    return finish_forced_reference(started["reference"], timeout=300)


def test_train_gradients_match_the_reference_meshed_step(state, world2,
                                                         reference):
    """The 2-rank (1 x 2) loss and gradients against the reference's
    jitted ``value_and_grad`` under a 1 x 2 mesh with its constraints."""
    st, _ = state
    for rank in world2[0]:
        _close(rank["1x2/grads/loss"][0], reference["loss"][0])
        got = [rank[f"1x2/grads/grads{k}"][0]
               for k in sorted_keys(st[4])]
        assert len(got) == len(reference["grads"])
        for g, w in zip(got, reference["grads"]):
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
    one = one_process
    for rank in world2[0]:
        _close(rank[f"{name}/hw/loss"][0], one["hw/loss"][0])
        _tree_close(rank, one, name, "hw/grads")


def test_microbatches_match_one_process(world2, one_process):
    one = one_process
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
    one = one_process
    for rank in world2[0]:
        _close(rank["seq_shard/loss"][0], one["seq_shard/loss"][0])
        keys = [k for k in one if k.startswith("seq_shard/grads")]
        assert keys
        for k in keys:
            _close(rank[k][0], one[k][0], what=k)


def test_checkpoints_cross_rank_counts(world2, ckpt_in):
    """The one-process checkpoint resumed on 2 ranks holds its values in
    blocks; the 2 ranks' checkpoint after one more step resumes in one
    process, equal to the ranks' state."""
    p1, o1 = ckpt_in[32][1]
    ranks, ckpt_out = world2[:2]
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
])
def test_rank_mesh_refusals(case, kind, world2):
    for rank in world2[0]:
        said = str(rank[f"refused/{case}"][0])
        assert said.startswith(kind + ":"), said


# ---------------------------------------------------------------------------
# 8-bit moments
# ---------------------------------------------------------------------------
Q, SCALE = cases.Q, cases.SCALE


def test_eight_bit_one_by_one_rank_mesh_equals_no_mesh_bit_for_bit(world1):
    """Two 8-bit steps: losses, parameters, every ``q`` and ``scale``."""
    none = cases.sub(world1, "none/q8/state2")
    assert none.keys() == cases.sub(world1, "ranks/q8/state2").keys()
    cases.eight_bit_close(cases.sub(world1, "ranks/q8/state2"), none,
                          exact=True)
    for i in range(cases.STEPS):
        np.testing.assert_array_equal(world1[f"ranks/q8/loss/{i}"][0],
                                      world1[f"none/q8/loss/{i}"][0])


@pytest.mark.parametrize("name", ["1x2", "2x1"])
def test_eight_bit_steps_match_one_process(name, world2, one_process):
    """Two steps with the clip active: every loss and gradient norm to
    1e-5, the state after the first step by the 8-bit contract with the
    scales to 1e-5 (the first step's moments are the gradients', which
    agree to 1e-5).  The second step's state is `adamw.apply`'s
    (`test_eight_bit_apply_matches_one_process`): beyond it the moments'
    codes make the trajectory sensitive to a gradient's last digit
    (Queue 3 item 19)."""
    one = one_process
    for rank in world2[0]:
        for i in range(cases.STEPS):
            _close(rank[f"{name}/q8/loss/{i}"][0], one[f"q8/loss/{i}"][0])
            _close(rank[f"{name}/q8/grad_norm/{i}"][0],
                   one[f"q8/grad_norm/{i}"][0])
        cases.eight_bit_close(cases.sub(rank, f"{name}/q8/state1"),
                              cases.sub(one, "q8/state1"),
                              scale_rtol=cases.GRAD_SCALE_RTOL)


@pytest.mark.parametrize("name,tag,exact", [
    ("1x2", "q8", False), ("2x1", "q8", False), ("1x2", "q8nc", True),
    ("2x2", "q8nc", True)])
def test_eight_bit_apply_matches_one_process(name, tag, exact, world2,
                                             world4):
    """The ranks' second `adamw.apply` against one process's on the same
    state and gradients: bit for bit when the gradient norm is under the
    clip (``q8nc``, whatever order the ranks summed it in), by the 8-bit
    contract when the clip scales the gradients."""
    opt_cfg = cases.OPT8_NOCLIP if exact else cases.OPT8
    for rank in _ranks_of(name, world2, world4):
        if exact:
            assert float(rank[f"{name}/{tag}/grad_norm/1"][0]) < \
                opt_cfg.grad_clip
        want = cases.replayed(rank, f"{name}/{tag}", cases.cfg(), opt_cfg)
        cases.eight_bit_close(cases.sub(rank, f"{name}/{tag}/state2"), want,
                              exact)


@pytest.mark.parametrize("name", ["1x2", "2x1"])
def test_eight_bit_moments_hold_the_reference_specs_shards(name, state,
                                                           world2,
                                                           reference):
    """Each rank's ``q`` and ``scale`` blocks have the shapes the
    reference's 8-bit moment specs (``opt_blocks`` over data x model)
    give: leaves whose block count the two ranks do not divide whole,
    the rest split."""
    _, opt_a = steps.abstract_train_state(cases.cfg(), 8)
    whole = dict(shd.leaves_with_path(opt_a.mu))
    leaves = [(m, k + part) for m in ("mu", "nu")
              for k in sorted_keys(state[0][4]) for part in (Q, SCALE)]
    want = reference[f"q8/shapes/{name}"]
    assert len(leaves) == len(want)
    for rank in world2[0]:
        held = set()
        for (m, k), w in zip(leaves, want):
            got = rank[f"shape/{name}/q8/{m}{k}"][0]
            np.testing.assert_array_equal(got, w, err_msg=k)
            held.add(int(got[0]) == whole[k].shape[0])
        assert held == {True, False}


def test_eight_bit_step_matches_the_reference_meshed_step(state, world2,
                                                          reference):
    """The 1 x 2 ranks' first 8-bit step against the reference's jitted
    ``make_train_step(..., AdamWConfig(state_bits=8))`` on 2 forced host
    devices: the loss to 1e-5, the parameters to 1e-5 + lr/5, the codes
    within one, the scales to 1e-5 relative."""
    keys = sorted_keys(state[0][4])
    want = {f"[0]{k}": w for k, w in zip(keys, reference["q8/params"])}
    moments = iter(reference["q8/moments"])
    for i in (1, 2):
        for k in keys:
            want[f"[{i}]{k}{Q}"] = next(moments)
            want[f"[{i}]{k}{SCALE}"] = next(moments)
    for rank in world2[0]:
        _close(rank["1x2/q8/loss/0"][0], reference["q8/loss"][0])
        _close(rank["1x2/q8/grad_norm/0"][0], reference["q8/grad_norm"][0])
        cases.eight_bit_close(cases.sub(rank, "1x2/q8/state1"), want,
                              scale_rtol=cases.GRAD_SCALE_RTOL)


def test_eight_bit_checkpoints_cross_rank_counts(world2, ckpt_in):
    """A one-process 8-bit checkpoint resumed on 1 x 2 and the 1 x 2
    ranks' checkpoint after one more step resumed on 2 x 1: each holds
    the checkpoint's values bit for bit, its loss is one process's from
    the same checkpoint, and its step's `adamw.apply` equals one
    process's on the checkpoint's state and the ranks' gradients by the
    8-bit contract.  The 2 x 1 ranks' state after their step, written by
    `checkpoint.AsyncCheckpointer`, resumes in one process bit for bit:
    whole leaves, as one process writes them."""
    ranks, _, ckpt8_out, ckpt8_out2 = world2
    c = cases.cfg()
    mesh = make_mesh((1, 1), ("data", "model"))
    st = steps.make_train_step(c, ShapeCfg("t", cases.S, cases.B, "train"),
                               mesh, cases.OPT8, device="cpu")
    for prefix, path in (("q8/", ckpt_in[8][0]), ("q8b/", ckpt8_out)):
        step, (p, opt) = ElasticState(str(path)).resume(
            mesh, lambda _: st.in_specs[:2], st.abstract_args[:2],
            device="cpu")
        want = {k: v.numpy() for k, v in shd.leaves_with_path(
            (p, opt.mu, opt.nu))}
        for rank in ranks:
            assert int(rank[f"{prefix}ckpt/resumed_step"][0]) == step
            cases.eight_bit_close(cases.sub(rank, f"{prefix}ckpt/resumed"),
                                  want, exact=True)
            replayed = cases.replayed(rank, f"{prefix}ckpt", c, cases.OPT8,
                                      (p, opt.mu, opt.nu), step, call=1)
            cases.eight_bit_close(cases.sub(rank, f"{prefix}ckpt/state1"),
                                  replayed)
        _, _, m = st.fn(p, opt, cases.batch_of(c))
        for rank in ranks:
            _close(rank[f"{prefix}ckpt/loss"][0], m["loss"].numpy())
    step, (p, opt) = ElasticState(str(ckpt8_out2)).resume(
        mesh, lambda _: st.in_specs[:2], st.abstract_args[:2], device="cpu")
    assert step == 3 and int(opt.step) == 3
    written = {k: v.numpy() for k, v in shd.leaves_with_path(
        (p, opt.mu, opt.nu))}
    for rank in ranks:
        cases.eight_bit_close(written, cases.sub(rank, "q8b/ckpt/state1"),
                              exact=True)


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
