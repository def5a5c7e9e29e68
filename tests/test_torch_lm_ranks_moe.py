"""The mixture-of-experts and hybrid (Mamba) language models' steps across
processes, held on the CPU by gloo ranks.

* One spawn of each world size (`_torch_port.start_ranks`, the three
  started together with the reference's step below) runs the cases
  of `_torch_lm_ranks_moe_cases.py` on rank meshes for three reduced
  models in float32, the port's parameters from seed 0: granite-moe with
  an odd vocabulary of 511 (whole on the model axis, as granite's 49155),
  jamba's one period (7 Mamba layers, 1 attention, 4 MoE) and kimi-k2's
  dense prefix with one MoE layer and its shared expert; on 1 x 2 (the
  experts and the Mamba channels split, expert and tensor parallel),
  2 x 1 (FSDP) and 2 x 2, and granite-moe on 1 x 4 (its 4 query heads
  split, its 2 KV heads whole on every rank, as granite's 16 / 8 on a
  16-way axis).  This process runs the same cases with
  ``mesh=None``.  The batch's 64 positions take two MoE token chunks and
  four Mamba scan chunks.  The loss and every gradient of the train
  step's first step (the router's too), the float32 moments after two
  steps, the aux loss, the prefill and decode logits, and a Mamba
  block's output and gradients over two sequence chunks
  agree to 1e-5, the parameters after AdamW to 1e-5 plus a fifth of the
  learning rate (as `test_torch_lm_ranks.py` says why); the greedy
  tokens are equal.
* A 1 x 1 rank mesh (world 1) equals ``mesh=None`` bit for bit.
* Every rank holds only its block of each parameter, moment, batch and
  decode cache leaf, the shapes `NamedSharding.shard_shape` gives: E/M
  experts, d_in/M Mamba channels with the conv and ssm cache blocks.
* The 2-rank (1 x 2) loss and gradients of granite-moe and jamba equal
  the reference's own jitted ``value_and_grad`` on a 1 x 2 forced-host
  mesh with its constraints on (`start_forced_reference`, ``Auto`` axes),
  on the same parameters handed over by their ``keystr`` paths.
* A one-process granite-moe checkpoint resumes on 2 ranks and the 2
  ranks' checkpoint in one process (`ElasticState`, whole leaves).
"""
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

import _torch_lm_ranks_cases as base
import _torch_lm_ranks_moe_cases as cases
from _torch_port import (finish_forced_reference, finish_ranks, flat_tree,
                         start_forced_reference, start_ranks)

TESTS = str(Path(__file__).resolve().parent)
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
ARCHS = cases.ARCHS
GRANITE = ARCHS[0]
REF_ARCHS = (GRANITE, "jamba-v0.1-52b")     # held to the reference's step
TOL = 1e-5
PARAM_ATOL = 0.2 * base.OPT.lr

_PRELUDE = """
import sys
sys.path.insert(0, {tests!r})
import _torch_lm_ranks_moe_cases as cases
from repro_torch.core.distributed import make_rank_mesh

def mesh(shape):
    return make_rank_mesh(shape, ("data", "model"))
"""

_WORLD1 = _PRELUDE + """
for arch in cases.ARCHS:
    for tag, m in (("none", None), ("ranks", mesh((1, 1)))):
        cases.run(save, m, arch, tag, aux=True)
"""

_WORLD2 = _PRELUDE + """
for arch in cases.ARCHS:
    for name, shape in (("1x2", (1, 2)), ("2x1", (2, 1))):
        ck = (({ckpt_in!r}, {ckpt_out!r})
              if arch == cases.ARCHS[0] and name == "1x2" else None)
        cases.run(save, mesh(shape), arch, name, aux=True, ckpt=ck)
cases.mamba_seq_chunks(save, mesh((1, 2)), tag="seq_chunks/1x2")
"""

_WORLD4 = _PRELUDE + """
for arch in cases.ARCHS:
    cases.run(save, mesh((2, 2)), arch, "2x2", aux=True)
cases.run(save, mesh((1, 4)), cases.ARCHS[0], "1x4", aux=True)
with cases.chunks():
    cases.base.comm_step(save, mesh((2, 2)), cases.cfg(cases.ARCHS[0]),
                         tag="comm/2x2", batch=cases.base.B)
"""


def _collect(fn, *args, **kw) -> dict:
    out: dict = {}

    def save(name, *arrays):
        out[name] = [a.detach().numpy() if isinstance(a, torch.Tensor)
                     else np.asarray(a) for a in arrays]
    fn(save, *args, **kw)
    return out


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """A one-process granite-moe checkpoint after one step for the ranks
    to resume, then the three worlds' ranks and the reference's meshed
    step, all started together (each fixture below waits for its own)."""
    c = cases.cfg(GRANITE)
    ckpt_in = tmp_path_factory.mktemp("ckpt_in")
    step1 = steps.make_train_step(c, ShapeCfg("t", base.S, base.B, "train"),
                                  None, base.OPT, device="cpu")
    p1 = cases.params_of(c)
    o1 = adamw.init(p1)
    with cases.chunks():
        p1, o1, _ = step1.fn(p1, o1, base.batch_of(c))
    from repro_torch.checkpoint import checkpoint as ckpt
    ckpt.save(ckpt_in, 1, (p1, o1))
    w2 = tmp_path_factory.mktemp("w2")
    return {
        "ckpt_state": (p1, o1),
        "reference": _start_reference(tmp_path_factory.mktemp("ref")),
        "world1": start_ranks(_WORLD1.format(tests=TESTS), 1,
                              tmp_path_factory.mktemp("w1")),
        "world2": (start_ranks(_WORLD2.format(
            tests=TESTS, ckpt_in=str(ckpt_in),
            ckpt_out=str(w2 / "ckpt_out")), 2, w2), w2 / "ckpt_out"),
        "world4": start_ranks(_WORLD4.format(tests=TESTS), 4,
                              tmp_path_factory.mktemp("w4")),
    }


@pytest.fixture(scope="module")
def one_process(started):
    """The cases with ``mesh=None`` in this process (while the ranks run,
    on one thread as each rank: the cores are theirs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _collect(cases.mamba_seq_chunks, None, tag="seq_chunks/one")
        for arch in ARCHS:
            out.update(_collect(cases.run, None, arch, "one", aux=True))
    finally:
        torch.set_num_threads(threads)
    out["ckpt_state"] = started["ckpt_state"]
    return out, None


@pytest.fixture(scope="module")
def world1(started, one_process):
    return finish_ranks(started["world1"], timeout=300)[0]


@pytest.fixture(scope="module")
def world2(started):
    procs, ckpt_out = started["world2"]
    return finish_ranks(procs, timeout=300), ckpt_out


@pytest.fixture(scope="module")
def world4(started):
    return finish_ranks(started["world4"], timeout=300)


def _ranks_of(name, world2, world4):
    return world4 if name in ("2x2", "1x4") else world2[0]


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _tree_close(rank, one, arch, name, prefix, atol=TOL):
    keys = [k for k in one if k.startswith(f"{arch}/one/{prefix}[")]
    assert keys, prefix
    for k in keys:
        got = rank[k.replace("/one/", f"/{name}/", 1)][0]
        _close(got, one[k][0], atol=atol, what=k)
    return keys


CASES = [(a, n) for a in ARCHS for n in ("1x2", "2x1", "2x2")] + [
    (GRANITE, "1x4")]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_rank_mesh_equals_no_mesh_bit_for_bit(arch, world1):
    none = {k[len(arch) + 6:]: v for k, v in world1.items()
            if k.startswith(f"{arch}/none/")}
    ranks = {k[len(arch) + 7:]: v for k, v in world1.items()
             if k.startswith(f"{arch}/ranks/")}
    assert none and none.keys() == {k for k in ranks
                                    if not k.startswith(("gen/comm",
                                                         "gen/cache"))}
    for k, v in none.items():
        np.testing.assert_array_equal(ranks[k][0], v[0], err_msg=k)


@pytest.fixture(scope="module")
def dry_runs(started):
    """`launch.dryrun.rank_trace` of each rank of granite-moe's train
    step on 2 x 2 (B = 4, S = 64, the chunks the ranks run at), traced in
    this process while the ranks run: [record by rank]."""
    c = cases.cfg(GRANITE)
    with cases.chunks():
        return [dryrun.rank_trace(c, ShapeCfg("t", base.S, base.B, "train"),
                                  {"data": 2, "model": 2}, r)
                for r in range(4)]


def test_dry_run_collectives_equal_the_ranks(dry_runs, world4):
    """The dry run's trace of each rank of 2 x 2 (`launch.dryrun.
    rank_trace`: meta tensors under a process group that moves nothing)
    makes the collectives granite-moe's gloo rank made in the same train
    step (``comm/2x2``), call for call and byte for byte by kind: the
    experts' dispatch and combine over "model" among them."""
    for r, rank in enumerate(world4):
        got = dry_runs[r]["collectives"]
        for kind in got["calls"]:
            saved = "comm/2x2"
            assert got["calls"][kind] == int(
                rank[f"{saved}/calls/{kind}"][0]), (r, kind)
            assert got["bytes"][kind] == int(
                rank[f"{saved}/bytes/{kind}"][0]), (r, kind)
        assert sum(got["calls"].values()) > 0


@pytest.mark.parametrize("arch,name", CASES)
def test_train_steps_match_one_process(arch, name, world2, world4,
                                       one_process):
    one = one_process[0]
    for rank in _ranks_of(name, world2, world4):
        for i in range(base.STEPS):
            for what in ("loss", "grad_norm"):
                _close(rank[f"{arch}/{name}/train/{what}/{i}"][0],
                       one[f"{arch}/one/train/{what}/{i}"][0],
                       what=f"{what} {i}")
        _tree_close(rank, one, arch, name, "train/mu")
        _tree_close(rank, one, arch, name, "train/nu")
        _tree_close(rank, one, arch, name, "train/params", atol=PARAM_ATOL)


@pytest.mark.parametrize("arch,name", CASES)
def test_loss_and_gradients_match_one_process(arch, name, world2, world4,
                                              one_process):
    """Every leaf's gradient, the router's included: its dispatch and
    gate columns are split to the rank's experts by a constraint whose
    backward gathers them, so a rank that kept only its experts' part
    would fail here."""
    one = one_process[0]
    for rank in _ranks_of(name, world2, world4):
        _close(rank[f"{arch}/{name}/train/loss/0"][0],
               one[f"{arch}/one/train/loss/0"][0])
        keys = _tree_close(rank, one, arch, name, "train/grads")
        routers = [k for k in keys if k.endswith("['router']")]
        assert routers and all(np.abs(one[k][0]).max() > 0
                               for k in routers)


@pytest.mark.parametrize("arch,name", CASES)
def test_aux_loss_matches_one_process(arch, name, world2, world4,
                                      one_process):
    """The load-balance term's statistics are batch means: with the rows
    split over "data" each rank averages them across the batch's ranks
    before their product."""
    one = one_process[0]
    want = one[f"{arch}/one/aux"][0]
    assert want > 0
    for rank in _ranks_of(name, world2, world4):
        _close(rank[f"{arch}/{name}/aux"][0], want)


@pytest.mark.parametrize("arch,name", CASES)
def test_prefill_and_decode_match_one_process(arch, name, world2, world4,
                                              one_process):
    one = one_process[0]
    for rank in _ranks_of(name, world2, world4):
        for i in range(base.GEN):
            _close(rank[f"{arch}/{name}/gen/logits/{i}"][0],
                   one[f"{arch}/one/gen/logits/{i}"][0], what=f"logits {i}")
        np.testing.assert_array_equal(rank[f"{arch}/{name}/gen/tokens"][0],
                                      one[f"{arch}/one/gen/tokens"][0])
        assert int(rank[f"{arch}/{name}/gen/comm"][0]) > 0


@pytest.mark.parametrize("arch,name", CASES)
def test_each_rank_holds_its_shard_shape(arch, name, world2, world4):
    """Parameters, moments, the batch and the decode cache: each rank's
    block has the shape the specs give on a mesh of the same shape; on a
    2-way model axis that is half the experts and half the Mamba
    channels."""
    c = cases.cfg(arch)
    mesh = make_mesh(MESHES[name], ("data", "model"))
    st = steps.make_train_step(c, ShapeCfg("t", base.S, base.B, "train"),
                               mesh, base.OPT, device="cpu")
    dec = steps.make_serve_step(c, ShapeCfg("d", base.MAX_SEQ, base.B,
                                            "decode"), mesh, device="cpu")
    pspec, ospec, bspec = st.in_specs
    p_a, o_a, b_a = st.abstract_args
    M = MESHES[name][1]
    for rank in _ranks_of(name, world2, world4):
        for tag, tree, specs in (("train/params", p_a, pspec),
                                 ("train/mu", o_a.mu, ospec.mu),
                                 ("train/nu", o_a.nu, ospec.nu),
                                 ("train/batch", b_a, bspec),
                                 ("gen/cache", dec.abstract_args[3],
                                  dec.in_specs[3])):
            by_key = dict(shd.leaves_with_path(specs))
            for key, leaf in shd.leaves_with_path(tree):
                want = shd.NamedSharding(mesh, by_key[key]).shard_shape(
                    leaf.shape)
                got = tuple(rank[f"shape/{arch}/{name}/{tag}{key}"][0])
                assert got == want, (tag, key)
        shapes = {k: tuple(v[0]) for k, v in rank.items()
                  if k.startswith(f"shape/{arch}/{name}/")}
        experts = [s for k, s in shapes.items() if k.endswith("we_up']")]
        assert experts and all(s[-3] == c.moe.num_experts // M
                               for s in experts)
        if c.hybrid is not None:
            d_in = c.hybrid.expand * c.d_model
            for leaf, dim in (("conv_w']", -2), ("A_log']", -2),
                              ("['conv']", -1), ("['ssm']", -2)):
                got = [s for k, s in shapes.items() if k.endswith(leaf)]
                assert got and all(s[dim] == d_in // M for s in got), leaf


def _start_reference(tmp):
    """The reference's jitted ``value_and_grad`` of reduced granite-moe
    and jamba on a 1 x 2 forced-host mesh with its constraints, at the
    chunk sizes the ranks run, on the parameters and batches the ranks
    get (the port's, carried by their ``keystr`` paths; started:
    `finish_forced_reference` waits for it)."""
    given = {}
    for arch in REF_ARCHS:
        c = cases.cfg(arch)
        given.update({f"{arch}/p{k}": v.numpy() for k, v in
                      flat_tree(cases.params_of(c)).items()})
        given.update({f"{arch}/batch/{k}": v.numpy()
                      for k, v in base.batch_of(c).items()})
    np.savez(tmp / "inputs.npz", **given)
    return start_forced_reference(f"""
        from jax.sharding import NamedSharding, PartitionSpec
        from repro.configs.base import reduced
        from repro.configs.registry import get_config, get_reduced_config
        from repro.launch.steps import batch_specs
        from repro.models import mamba, moe
        from repro.models import sharding as shd
        from repro.models.model import build_model
        moe.TOK_CHUNK = {cases.CHUNKS["moe.TOK_CHUNK"]}
        mamba.CHUNK = {cases.CHUNKS["mamba.CHUNK"]}
        mesh = auto_mesh((1, 2), ("data", "model"))
        with np.load({str(tmp / 'inputs.npz')!r}) as f:
            given = {{k: f[k] for k in f.files}}
        ns = lambda specs: jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        for arch, cfg in (
                ({GRANITE!r}, reduced(get_config({GRANITE!r}),
                                      vocab_size={cases.GRANITE_VOCAB})),
                ("jamba-v0.1-52b", get_reduced_config("jamba-v0.1-52b"))):
            model = build_model(cfg)
            # the parameters handed in, in the tree init draws
            paths, tree = jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(model.init, jax.random.PRNGKey(0)))
            params = jax.tree_util.tree_unflatten(tree, [
                given[arch + "/p" + jax.tree_util.keystr(p)]
                for p, _ in paths])
            b = {{k.rsplit("/", 1)[1]: v for k, v in given.items()
                  if k.startswith(arch + "/batch/")}}
            with shd.use_mesh(mesh):
                fn = jax.jit(jax.value_and_grad(model.loss), in_shardings=(
                    ns(shd.param_specs(params, mesh)),
                    ns(batch_specs(b, mesh))))
                loss, grads = fn(params, b)
            save(arch + "/loss", loss)
            save(arch + "/grads", *jax.tree.leaves(grads))
    """, 2, tmp)


@pytest.fixture(scope="module")
def reference(started):
    return finish_forced_reference(started["reference"], timeout=300)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_train_gradients_match_the_reference_meshed_step(arch, reference,
                                                         world2):
    """The 2-rank (1 x 2) loss and gradients against the reference's
    jitted ``value_and_grad`` under a 1 x 2 mesh with its constraints."""
    c = cases.cfg(arch)
    like = cases.params_of(c)
    for rank in world2[0]:
        _close(rank[f"{arch}/1x2/train/loss/0"][0],
               reference[f"{arch}/loss"][0])
        got = [rank[f"{arch}/1x2/train/grads{k}"][0]
               for k in _sorted_keys(like)]
        want = reference[f"{arch}/grads"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def _sorted_keys(params):
    """The port's leaf keys in the reference's leaf order (sorted keys)."""
    order = {id(x): i for i, x in enumerate(adamw.tree_leaves(params))}
    pairs = shd.leaves_with_path(params)
    return [k for k, x in sorted(pairs, key=lambda kx: order[id(kx[1])])]


def test_checkpoints_cross_rank_counts(world2, one_process):
    """The one-process granite-moe checkpoint resumed on 2 ranks (1 x 2)
    holds its values in blocks; the 2 ranks' checkpoint after one more
    step resumes in one process, equal to the ranks' state."""
    p1, o1 = one_process[0]["ckpt_state"]
    ranks, ckpt_out = world2
    want = flat_tree(p1)
    for rank in ranks:
        assert int(rank[f"{GRANITE}/ckpt/resumed_step"][0]) == 1
        for k, w in want.items():
            np.testing.assert_array_equal(
                rank[f"{GRANITE}/ckpt/resumed{k}"][0], w.numpy(), err_msg=k)
    c = cases.cfg(GRANITE)
    mesh = make_mesh((1, 1), ("data", "model"))
    st = steps.make_train_step(c, ShapeCfg("t", base.S, base.B, "train"),
                               mesh, base.OPT, device="cpu")
    step, (p2, o2) = ElasticState(str(ckpt_out)).resume(
        mesh, lambda _: st.in_specs[:2], st.abstract_args[:2], device="cpu")
    assert step == 2 and int(o2.step) == 2
    with cases.chunks():
        p_one, _, m = st.fn(shd.map_with_path(lambda _, x: x.clone(), p1),
                            adamw.OptState(
                                o1.step.clone(),
                                adamw.tree_map(lambda x: x.clone(), o1.mu),
                                adamw.tree_map(lambda x: x.clone(), o1.nu)),
                            base.batch_of(c))
    _close(ranks[0][f"{GRANITE}/ckpt/loss"][0], m["loss"].numpy())
    for (k, a), (_, b) in zip(shd.leaves_with_path(p2),
                              shd.leaves_with_path(p_one)):
        _close(a.numpy(), b.numpy(), atol=PARAM_ATOL, what=k)


def test_mamba_sequence_chunks_match_one_process(world2, one_process):
    """A Mamba block over two sequence chunks on 1 x 2 (its channels
    split, the states carried, each chunk recomputed in backward with its
    collectives): the output and every gradient."""
    one = one_process[0]
    keys = [k for k in one if k.startswith("seq_chunks/one[")]
    assert len(keys) == 11
    for rank in world2[0]:
        for k in keys:
            _close(rank[k.replace("/one", "/1x2")][0], one[k][0], what=k)
