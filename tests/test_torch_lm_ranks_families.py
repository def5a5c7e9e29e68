"""The RWKV, Whisper and vision-language models' steps across processes,
held on the CPU by gloo ranks.

* One spawn of each world size (`_torch_port.start_ranks`, the three
  started together with the reference's step and the training entry
  point below) runs the cases of `_torch_lm_ranks_families_cases.py` on
  rank meshes for three reduced models in float32, the port's parameters
  from seed 0: rwkv6-3b (two 64-wide heads), Whisper with whisper-tiny's
  indivisibilities (an odd vocabulary of 511, 6 heads) and qwen2-vl (its
  qkv biases, M-RoPE, a 24-row patch prefix with three distinct position
  rows and text after it); on 1 x 2 (tensor parallel: RWKV's heads,
  Whisper's heads and d_ff, qwen2-vl's heads and d_ff), 2 x 1 (FSDP) and
  2 x 2, and on 1 x 4 Whisper (its heads whole, d_ff split), RWKV
  (its 128 channels in blocks of 32, half a head: the WKV runs on every
  head of the gathered channels) and qwen2-vl (its 4 query heads split,
  its 2 KV heads and their biases whole on every rank: a rank's query
  head attends KV head r // 2), and a Whisper with 4 query / 2 KV heads
  on 1 x 4 (its self- and cross-attention's KV heads whole, the
  encoder's K/V cached whole).  This process runs the same cases with
  ``mesh=None``.  The loss and every gradient of the train step's first
  step, the float32 moments after two steps, the prefill logits and
  caches (RWKV's wkv state gathered whole over the heads), every decode
  step's logits and the decode cache agree to 1e-5, the parameters after
  AdamW to 1e-5 plus a fifth of the learning rate (as
  `test_torch_lm_ranks.py` says why); the greedy tokens are equal.  The
  second step's loss and gradient norm are held to one process's at the
  parameters that mesh's first step left.
* A 1 x 1 rank mesh (world 1) equals ``mesh=None`` bit for bit.
* Every rank holds only its block of each parameter, moment, batch and
  decode cache leaf, the shapes `NamedSharding.shard_shape` gives: RWKV's
  wkv state whole over "model", Whisper's tied vocabulary whole.
* The 2-rank (1 x 2) loss and gradients equal the reference's own jitted
  ``value_and_grad`` on a 1 x 2 forced-host mesh with its constraints on
  (`start_forced_reference`, ``Auto`` axes), on the same parameters
  handed over by their ``keystr`` paths.
* ``launch.train --arch whisper-tiny --ranks 2`` logs one process's
  losses.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import all_cells, get_config
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import steps
from repro_torch.models import sharding as shd
from repro_torch.optim import adamw

import _torch_lm_ranks_cases as base
import _torch_lm_ranks_families_cases as cases
from _torch_port import (finish_forced_reference, finish_ranks, flat_tree,
                         start_forced_reference, start_ranks)

TESTS = str(Path(__file__).resolve().parent)
ARCHS = cases.ARCHS
RWKV, WHISPER, VLM = ARCHS
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
CASES = ([(a, n) for a in ARCHS for n in ("1x2", "2x1", "2x2")]
         + [(WHISPER, "1x4"), (RWKV, "1x4"), (VLM, "1x4"),
            (cases.WHISPER_GQA, "1x4")])
TOL = 1e-5
# parameters after AdamW: 1e-5 + lr/5 (ROADMAP Queue 3 item 28's rule)
PARAM_ATOL = TOL + 0.2 * base.OPT.lr
# the second step's gradient norm against one process's at the same
# parameters: reduced RWKV after one AdamW step is ill-conditioned (in one
# process, 1e-7 relative noise on the time mix's output moves its
# gradients by 2.3e-4 of their max and their norm by up to 2.0e-5, where
# at the initial parameters it moves them by 1e-5 and 1.4e-6), and the
# ranks add such noise at every partial sum; ROADMAP Queue 3 item 30
STEP1_NORM_RTOL = {RWKV: 2e-4}
CLI = ["--arch", WHISPER, "--reduced", "--steps", "2", "--log-every", "1",
       "--batch", "4", "--seq", "32", "--device", "cpu"]

_PRELUDE = """
import sys
sys.path.insert(0, {tests!r})
import _torch_lm_ranks_families_cases as cases
from repro_torch.core.distributed import make_rank_mesh

def mesh(shape):
    return make_rank_mesh(shape, ("data", "model"))
"""

_WORLD1 = _PRELUDE + """
for arch in cases.ARCHS:
    for tag, m in (("none", None), ("ranks", mesh((1, 1)))):
        cases.run(save, m, arch, tag)
"""

_WORLD2 = _PRELUDE + """
for arch in cases.ARCHS:
    for name, shape in (("1x2", (1, 2)), ("2x1", (2, 1))):
        cases.run(save, mesh(shape), arch, name)
"""

_WORLD4 = _PRELUDE + """
for arch in cases.ARCHS:
    cases.run(save, mesh((2, 2)), arch, "2x2")
for arch in (cases.WHISPER, cases.RWKV, cases.VLM, cases.WHISPER_GQA):
    cases.run(save, mesh((1, 4)), arch, "1x4")
cases.eight_bit(save, mesh((2, 2)), cases.WHISPER, "2x2")
cases.constrain_move(save, mesh((2, 2)))
"""


def _collect(fn, *args, **kw) -> dict:
    out: dict = {}

    def save(name, *arrays):
        out[name] = [a.detach().numpy() if isinstance(a, torch.Tensor)
                     else np.asarray(a) for a in arrays]
    fn(save, *args, **kw)
    return out


def _start_cli():
    """``launch.train --arch whisper-tiny --reduced --ranks 2`` (gloo,
    1 x 2: its own spawn), started: `test_train_entry_point_runs_whisper
    _on_ranks` waits for it."""
    env = dict(os.environ, PYTHONPATH=str(Path(TESTS).parent / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI, "--ranks",
         "2", "--backend", "gloo", "--data-model", "1", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The three worlds' ranks, the reference's meshed step and the
    training entry point, all started together (each fixture below waits
    for its own)."""
    return {
        "reference": _start_reference(tmp_path_factory.mktemp("ref")),
        "world1": start_ranks(_WORLD1.format(tests=TESTS), 1,
                              tmp_path_factory.mktemp("w1")),
        "world2": start_ranks(_WORLD2.format(tests=TESTS), 2,
                              tmp_path_factory.mktemp("w2")),
        "world4": start_ranks(_WORLD4.format(tests=TESTS), 4,
                              tmp_path_factory.mktemp("w4")),
        "cli": _start_cli(),
    }


@pytest.fixture(scope="module")
def one_process(started):
    """The cases with ``mesh=None`` in this process (while the ranks run,
    on one thread as each rank: the cores are theirs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arch in ARCHS + (cases.WHISPER_GQA,):
            out.update(_collect(cases.run, None, arch, "one"))
        out.update(_collect(cases.eight_bit, None, WHISPER, "one"))
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def world1(started, one_process):
    return finish_ranks(started["world1"], timeout=300)[0]


@pytest.fixture(scope="module")
def world2(started):
    return finish_ranks(started["world2"], timeout=300)


@pytest.fixture(scope="module")
def world4(started):
    return finish_ranks(started["world4"], timeout=300)


def _ranks_of(name, world2, world4):
    return world4 if name in ("2x2", "1x4") else world2


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _tree_close(rank, one, arch, name, prefix, atol=TOL, scaled=False):
    """Every leaf under ``prefix``; ``scaled``: ``atol`` times the leaf's
    max |x| where that exceeds 1 (`_torch_port.assert_lm_tree_close`'s
    rule: the wkv state reaches ~12 and the chunk einsums' order moves
    it by a few 1e-5)."""
    keys = [k for k in one if k.startswith(f"{arch}/one/{prefix}[")]
    assert keys, prefix
    for k in keys:
        got, want = rank[k.replace("/one/", f"/{name}/", 1)][0], one[k][0]
        scale = max(1.0, float(np.abs(want).max())) if scaled and \
            want.size else 1.0
        _close(got, want, atol=atol * scale, what=k)
    return keys


def test_every_family_runs_on_a_rank_mesh():
    """`rank_setup` admits every family of the registry's models."""
    assert {get_config(a).family for a, _ in all_cells()} == set(
        steps.RANKED_FAMILIES)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_rank_mesh_equals_no_mesh_bit_for_bit(arch, world1):
    none = {k[len(arch) + 6:]: v for k, v in world1.items()
            if k.startswith(f"{arch}/none/")}
    ranks = {k[len(arch) + 7:]: v for k, v in world1.items()
             if k.startswith(f"{arch}/ranks/")}
    assert none and none.keys() == {k for k in ranks
                                    if not k.startswith("gen/comm")}
    for k, v in none.items():
        np.testing.assert_array_equal(ranks[k][0], v[0], err_msg=k)


@pytest.fixture(scope="module")
def replayed(world2, world4):
    """One process's loss and gradient norm at each mesh's parameters
    after its first step (rank 0's, gathered whole): what that mesh's
    second step must compute."""
    out = {}
    for arch, name in CASES:
        rank = _ranks_of(name, world2, world4)[0]
        c = cases.cfg(arch)
        p1 = shd.map_with_path(lambda k, _: torch.from_numpy(
            rank[f"{arch}/{name}/train/params1{k}"][0]), cases.params_of(c))
        with cases.batches():
            out[arch, name] = [x.numpy()
                               for x in cases.loss_and_norm(c, p1)]
    return out


@pytest.mark.parametrize("arch,name", CASES)
def test_train_steps_match_one_process(arch, name, world2, world4,
                                       one_process, replayed):
    """The first step's loss and gradient norm, each step's loss, the
    parameters after each step, the moments after two.  The second
    step's gradient norm is held to one process's at the parameters
    this mesh's first step left (AdamW's first update is ~lr times the
    sign of each gradient entry, so an entry within the ranks' summation
    noise of 0 moves its parameter by up to lr: the lr/5 rule), RWKV's
    to `STEP1_NORM_RTOL`."""
    one = one_process
    for rank in _ranks_of(name, world2, world4):
        for i in range(base.STEPS):
            _close(rank[f"{arch}/{name}/train/loss/{i}"][0],
                   one[f"{arch}/one/train/loss/{i}"][0], what=f"loss {i}")
        _close(rank[f"{arch}/{name}/train/grad_norm/0"][0],
               one[f"{arch}/one/train/grad_norm/0"][0], what="grad_norm 0")
        loss1, norm1 = replayed[arch, name]
        _close(rank[f"{arch}/{name}/train/loss/1"][0], loss1)
        _close(rank[f"{arch}/{name}/train/grad_norm/1"][0], norm1,
               rtol=STEP1_NORM_RTOL.get(arch, TOL), what="grad_norm 1")
        _tree_close(rank, one, arch, name, "train/params1", atol=PARAM_ATOL)
        _tree_close(rank, one, arch, name, "train/mu")
        _tree_close(rank, one, arch, name, "train/nu")
        _tree_close(rank, one, arch, name, "train/params", atol=PARAM_ATOL)


@pytest.mark.parametrize("arch,name", CASES)
def test_loss_and_gradients_match_one_process(arch, name, world2, world4,
                                              one_process):
    """Every leaf's gradient, the whole leaves split to a rank's channels
    by `constrain` (RWKV's decay, bonus and group-norm scale) among them:
    their gradients are gathered from every rank's channels."""
    one = one_process
    for rank in _ranks_of(name, world2, world4):
        _close(rank[f"{arch}/{name}/train/loss/0"][0],
               one[f"{arch}/one/train/loss/0"][0])
        keys = _tree_close(rank, one, arch, name, "train/grads")
        assert all(np.abs(one[k][0]).max() > 0 for k in keys
                   if k.endswith(("['u_bonus']", "['decay_b']",
                                  "['tok_embed']", "['bq']")))


@pytest.mark.parametrize("arch,name", CASES)
def test_prefill_and_decode_match_one_process(arch, name, world2, world4,
                                              one_process):
    """The prefill step's logits and cache, every decode step's logits,
    the greedy tokens and the decode cache after them (Whisper's self and
    cross caches, RWKV's states, qwen2-vl's K/V)."""
    one = one_process
    for rank in _ranks_of(name, world2, world4):
        _close(rank[f"{arch}/{name}/prefill/logits"][0],
               one[f"{arch}/one/prefill/logits"][0])
        if cases.cfg(arch).enc_dec is None:
            _tree_close(rank, one, arch, name, "prefill/cache",
                        scaled=True)
        for i in range(base.GEN):
            _close(rank[f"{arch}/{name}/gen/logits/{i}"][0],
                   one[f"{arch}/one/gen/logits/{i}"][0], what=f"logits {i}")
        np.testing.assert_array_equal(rank[f"{arch}/{name}/gen/tokens"][0],
                                      one[f"{arch}/one/gen/tokens"][0])
        _tree_close(rank, one, arch, name, "gen/cache", scaled=True)
        assert int(rank[f"{arch}/{name}/gen/comm"][0]) > 0


@pytest.mark.parametrize("arch,name", CASES)
def test_each_rank_holds_its_shard_shape(arch, name, world2, world4):
    """Parameters, moments, the batch, the decode cache and the prefill
    cache: each rank's block has the shape the specs give on a mesh of the
    same shape.  RWKV's wkv state is whole over "model" (H heads on every
    rank) in both caches; Whisper's 511-row tied embedding is whole."""
    c = cases.cfg(arch)
    mesh = make_mesh(MESHES[name], ("data", "model"))
    st = steps.make_train_step(c, ShapeCfg("t", base.S, base.B, "train"),
                               mesh, base.OPT, device="cpu")
    dec = steps.make_serve_step(c, ShapeCfg("d", base.MAX_SEQ, base.B,
                                            "decode"), mesh, device="cpu")
    pspec, ospec, bspec = st.in_specs
    p_a, o_a, b_a = st.abstract_args
    for rank in _ranks_of(name, world2, world4):
        for tag, tree, specs in (("train/params", p_a, pspec),
                                 ("train/mu", o_a.mu, ospec.mu),
                                 ("train/nu", o_a.nu, ospec.nu),
                                 ("gen/cache", dec.abstract_args[3],
                                  dec.in_specs[3])):
            by_key = dict(shd.leaves_with_path(specs))
            for key, leaf in shd.leaves_with_path(tree):
                want = shd.NamedSharding(mesh, by_key[key]).shard_shape(
                    leaf.shape)
                got = tuple(rank[f"shape/{arch}/{name}/{tag}{key}"][0])
                assert got == want, (tag, key)
        by_key = dict(shd.leaves_with_path(bspec))
        for key, leaf in shd.leaves_with_path(cases.batch_of(c)):
            want = shd.NamedSharding(mesh, by_key[key]).shard_shape(
                leaf.shape)
            assert tuple(rank[f"shape/{arch}/{name}/train/batch{key}"][0]) \
                == want, key
        shapes = {k: tuple(v[0]) for k, v in rank.items()
                  if k.startswith(f"shape/{arch}/{name}/")}
        data = MESHES[name][0]
        if arch == RWKV:
            H, hd = c.d_model // c.rwkv.head_dim, c.rwkv.head_dim
            for tag in ("gen", "prefill"):
                wkv = [s for k, s in shapes.items()
                       if k.startswith(f"shape/{arch}/{name}/{tag}/cache")
                       and k.endswith("['wkv']")]
                assert wkv and all(s[-4:] == (base.B // data, H, hd, hd)
                                   for s in wkv), (tag, wkv)
        if arch == WHISPER:
            emb = shapes[f"shape/{arch}/{name}/train/params['tok_embed']"]
            assert emb == (c.vocab_size, c.d_model // data)


def test_whole_dims_are_not_summed_over_the_model_axis(world4, one_process):
    """On 1 x 4 the rules leave Whisper's 6 heads and its 511-row tied
    embedding whole: every model rank computes them whole, and their
    gradients are one process's, not 4 times it (no row-parallel sum runs
    on them)."""
    c = cases.cfg(WHISPER)
    mesh = make_mesh((1, 4), ("data", "model"))
    p_a = steps._abstract_params(c)
    specs = dict(shd.leaves_with_path(shd.param_specs(p_a, mesh)))
    whole = [k for k in specs if k.endswith(("['wq']", "['wo']",
                                             "['tok_embed']"))]
    assert whole and all("model" not in shd._spec_axes(p)
                         for k in whole for p in specs[k])
    for rank in world4:
        for k in whole:
            got = rank[f"{WHISPER}/1x4/train/grads{k}"][0]
            want = one_process[f"{WHISPER}/one/train/grads{k}"][0]
            assert np.abs(want).max() > 0
            _close(got, want, what=k)


def _start_reference(tmp):
    """The reference's jitted ``value_and_grad`` of the three reduced
    models on a 1 x 2 forced-host mesh with its constraints, on the
    parameters and batches the ranks get (the port's, carried by their
    ``keystr`` paths; started: `finish_forced_reference` waits for it)."""
    given = {}
    for arch in ARCHS:
        c = cases.cfg(arch)
        given.update({f"{arch}/p{k}": v.numpy() for k, v in
                      flat_tree(cases.params_of(c)).items()})
        given.update({f"{arch}/batch/{k}": v.numpy()
                      for k, v in cases.batch_of(c).items()})
    np.savez(tmp / "inputs.npz", **given)
    return start_forced_reference(f"""
        from jax.sharding import NamedSharding, PartitionSpec
        from repro.configs.base import reduced
        from repro.configs.registry import get_config, get_reduced_config
        from repro.launch.steps import batch_specs
        from repro.models import rwkv
        from repro.models import sharding as shd
        from repro.models.model import build_model
        rwkv.CHUNK = {cases.WKV_CHUNK}
        mesh = auto_mesh((1, 2), ("data", "model"))
        with np.load({str(tmp / 'inputs.npz')!r}) as f:
            given = {{k: f[k] for k in f.files}}
        ns = lambda specs: jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        for arch, cfg in (
                ({RWKV!r}, get_reduced_config({RWKV!r})),
                ({WHISPER!r}, reduced(
                    get_config({WHISPER!r}),
                    vocab_size={cases.WHISPER_VOCAB},
                    num_heads={cases.WHISPER_HEADS},
                    num_kv_heads={cases.WHISPER_HEADS}, head_dim=16)),
                ({VLM!r}, get_reduced_config({VLM!r}))):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_gradients_match_the_reference_meshed_step(arch, reference,
                                                         world2):
    """The 2-rank (1 x 2) loss and gradients against the reference's
    jitted ``value_and_grad`` under a 1 x 2 mesh with its constraints."""
    c = cases.cfg(arch)
    like = cases.params_of(c)
    for rank in world2:
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


def test_train_entry_point_runs_whisper_on_ranks(started):
    """``launch.train --arch whisper-tiny --ranks 2`` (gloo, 1 x 2; the
    frames drawn with each step's batch) logs one process's losses."""
    from repro_torch.launch import train

    proc = started["cli"]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    assert "(2 ranks, gloo, cpu)" in out
    ranked = [ln.split()[2] for ln in out.splitlines()
              if ln.startswith("step")]
    one = train.main(CLI)
    assert ranked and ranked == [f"loss={r['loss']:.4f}" for r in one]


def test_constrain_moves_the_model_axis_between_dims(world4):
    """`models.sharding.constrain` on a 2 x 2 gloo mesh: a block held with
    "model" on the heads, asked for with it on the positions, is the
    block of the gathered whole the rules give, bit for bit (the axis is
    gathered off the heads before the positions split; ROADMAP Queue 3
    item 31)."""
    for rank in world4:
        got, want = rank["constrain/got"][0], rank["constrain/want"][0]
        assert got.shape == want.shape
        assert tuple(rank["constrain/held"][0]) != want.shape
        np.testing.assert_array_equal(got, want)
    blocks = [tuple(np.unique(r["constrain/got"][0])) for r in world4]
    assert len(set(blocks)) == 4


def test_whisper_eight_bit_steps_match_one_process(world4, one_process):
    """Whisper on 2 x 2 with 8-bit moments: both steps' losses and the
    first's gradient norm to 1e-5, the state after the first step by the
    8-bit contract (ROADMAP Queue 3 item 33; scales to 1e-5, as the
    gradients), and the second `adamw.apply` equal to one process's on
    the ranks' own state and gradients (bit for bit where the gradient
    norm is under the clip)."""
    one, tag = one_process, f"{WHISPER}/2x2/q8"
    c = cases.cfg(WHISPER)
    for rank in world4:
        for i in range(base.STEPS):
            _close(rank[f"{tag}/loss/{i}"][0],
                   one[f"{WHISPER}/one/q8/loss/{i}"][0])
        _close(rank[f"{tag}/grad_norm/0"][0],
               one[f"{WHISPER}/one/q8/grad_norm/0"][0])
        base.eight_bit_close(base.sub(rank, f"{tag}/state1"),
                             base.sub(one, f"{WHISPER}/one/q8/state1"),
                             scale_rtol=base.GRAD_SCALE_RTOL)
        exact = float(rank[f"{tag}/grad_norm/1"][0]) < base.OPT8.grad_clip
        base.eight_bit_close(base.sub(rank, f"{tag}/state2"),
                             base.replayed(rank, tag, c, base.OPT8),
                             exact=exact)
