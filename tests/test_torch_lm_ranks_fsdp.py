"""Every family's steps across processes under ``REPRO_PARALLELISM=fsdp``,
held on the CPU by gloo ranks.

The ``fsdp`` preset splits the batch over every mesh axis and every
parameter's ``fsdp`` dim over ("data", "model"), with no tensor
parallelism (`models.sharding.LOGICAL_RULES`).  Each rank process reads
the preset at import, so the spawns set it in their environment; this
process keeps the ``2d`` rules.

* One spawn of 4 gloo ranks (`_torch_port.start_ranks`, started with a
  1-rank spawn and the reference's meshed steps) runs the cases of
  `_torch_lm_ranks_fsdp_cases.py` on 2 x 2 and 1 x 4: the loss and
  gradients of one reduced model of each family, and two train steps,
  prefill and greedy decode of the dense and MoE models.  This process
  runs the same cases with ``mesh=None``.  They agree to 1e-5, the
  parameters after AdamW to 1e-5 + lr/5 (ROADMAP Queue 3 item 28); the
  greedy tokens are equal.
* A batch of 2 rows on 2 x 2 splits over "data" alone (the rules' prefix
  fallback) and its gradients are one process's.
* Every rank holds the parameter, moment and batch blocks the
  reference's ``fsdp`` specs give (`NamedSharding.shard_shape`).
* A 1 x 1 rank mesh equals ``mesh=None`` bit for bit.
* Every family's train step with 8-bit moments on 2 x 2: the loss and
  gradient norm to 1e-5, the state after it by the 8-bit contract
  (ROADMAP Queue 3 item 33), and its `adamw.apply` equal to one
  process's on the ranks' own gradients.
* The 2 x 2 loss and gradients of the dense and MoE models equal the
  reference's jitted ``value_and_grad`` under ``fsdp`` on 4 forced host
  devices (`start_forced_reference`, ``Auto`` axes), on the same
  parameters handed over by their ``keystr`` paths.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models import sharding as shd
from repro_torch.optim import adamw

import _torch_lm_ranks_cases as base
import _torch_lm_ranks_fsdp_cases as cases
import _torch_lm_ranks_moe_cases as moe
from _torch_port import (finish_forced_reference, finish_ranks, flat_tree,
                         start_forced_reference, start_ranks)

TESTS = str(Path(__file__).resolve().parent)
FSDP = {"REPRO_PARALLELISM": "fsdp"}
MESHES = ("2x2", "1x4")
FAMILIES = list(cases.FAMILIES.values())
SERVED = (cases.DENSE, cases.MOE)
TOL = 1e-5
PARAM_ATOL = TOL + 0.2 * base.OPT.lr

_PRELUDE = """
import sys
sys.path.insert(0, {tests!r})
import _torch_lm_ranks_fsdp_cases as cases
from repro_torch.core.distributed import make_rank_mesh
from repro_torch.models import sharding as shd
assert shd.PARALLELISM == "fsdp", shd.PARALLELISM

def mesh(shape):
    return make_rank_mesh(shape, ("data", "model"))
"""

_WORLD1 = _PRELUDE + """
for tag, m in (("none", None), ("ranks", mesh((1, 1)))):
    for arch in (cases.DENSE, cases.MOE):
        cases.train_and_serve(save, m, arch, tag)
"""

_WORLD4 = _PRELUDE + """
for name, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
    m = mesh(shape)
    for arch in cases.FAMILIES.values():
        cases.grads(save, m, arch, name)
    for arch in (cases.DENSE, cases.MOE):
        cases.train_and_serve(save, m, arch, name)
cases.fallback(save, mesh((2, 2)), "2x2")
for arch in cases.FAMILIES.values():
    cases.eight_bit(save, mesh((2, 2)), arch, "2x2")
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
    """The ranks and the reference, all started together."""
    return {
        "reference": _start_reference(tmp_path_factory.mktemp("ref")),
        "world1": start_ranks(_WORLD1.format(tests=TESTS), 1,
                              tmp_path_factory.mktemp("w1"), env=FSDP),
        "world4": start_ranks(_WORLD4.format(tests=TESTS), 4,
                              tmp_path_factory.mktemp("w4"), env=FSDP),
    }


@pytest.fixture(scope="module")
def one_process(started):
    """The cases with ``mesh=None`` in this process (while the ranks run,
    on one thread as each rank: the cores are theirs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arch in FAMILIES:
            out.update(_collect(cases.grads, None, arch, "one"))
        for arch in SERVED:
            out.update(_collect(cases.train_and_serve, None, arch, "one"))
        out.update(_collect(cases.fallback, None, "one"))
        for arch in FAMILIES:
            out.update(_collect(cases.eight_bit, None, arch, "one"))
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def world1(started, one_process):
    return finish_ranks(started["world1"], timeout=300)[0]


@pytest.fixture(scope="module")
def world4(started):
    return finish_ranks(started["world4"], timeout=300)


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _tree_close(rank, one, arch, name, prefix, atol=TOL):
    keys = [k for k in one if k.startswith(f"{arch}/one/{prefix}[")]
    assert keys, prefix
    for k in keys:
        got = rank[k.replace("/one/", f"/{name}/", 1)][0]
        _close(got, one[k][0], atol=atol, what=k)


def test_the_ranks_run_the_fsdp_rules(world4):
    """The spawns' preset: no parameter block is split on a dim the 2d
    rules would split over "model" alone, and the batch is split four
    ways on 2 x 2."""
    assert shd.PARALLELISM == "2d"       # this process's
    for rank in world4:
        tokens = rank[f"shape/{cases.DENSE}/2x2/train/batch['tokens']"][0]
        assert tokens[0] == base.B // 4


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_one_process(arch, name, world4,
                                              one_process):
    for rank in world4:
        _close(rank[f"{arch}/{name}/grads/loss"][0],
               one_process[f"{arch}/one/grads/loss"][0])
        _tree_close(rank, one_process, arch, name, "grads/grads")


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", SERVED)
def test_train_steps_match_one_process(arch, name, world4, one_process):
    one = one_process
    for rank in world4:
        for i in range(base.STEPS):
            for what in ("loss", "grad_norm"):
                _close(rank[f"{arch}/{name}/train/{what}/{i}"][0],
                       one[f"{arch}/one/train/{what}/{i}"][0], what=what)
        _tree_close(rank, one, arch, name, "train/mu")
        _tree_close(rank, one, arch, name, "train/nu")
        _tree_close(rank, one, arch, name, "train/params", atol=PARAM_ATOL)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_match_one_process(arch, name, world4,
                                              one_process):
    one = one_process
    for rank in world4:
        for i in range(base.GEN):
            _close(rank[f"{arch}/{name}/gen/logits/{i}"][0],
                   one[f"{arch}/one/gen/logits/{i}"][0], what=f"logits {i}")
        np.testing.assert_array_equal(rank[f"{arch}/{name}/gen/tokens"][0],
                                      one[f"{arch}/one/gen/tokens"][0])


def test_batch_that_does_not_split_four_ways_falls_back_to_data(
        world4, one_process):
    """2 rows on 2 x 2: each rank holds one row (split over "data"), and
    the gradients sum over "data" alone."""
    arch, tag = cases.DENSE, f"b{cases.FALLBACK_B}"
    for rank in world4:
        assert rank["shape/2x2/batch"][0][0] == cases.FALLBACK_B // 2
        _close(rank[f"{arch}/2x2/{tag}/grads/loss"][0],
               one_process[f"{arch}/one/{tag}/grads/loss"][0])
        _tree_close(rank, one_process, arch, "2x2", f"{tag}/grads/grads")


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", SERVED)
def test_each_rank_holds_the_reference_fsdp_shard_shapes(arch, name, world4,
                                                         reference):
    """Parameters, float32 moments and the batch: each rank's block has
    the shape the reference's ``fsdp`` specs give on the same mesh."""
    keys = _sorted_keys(cases.cfg(arch))
    for rank in world4:
        for part in ("params", "mu", "nu"):
            want = reference[f"{arch}/{name}/shapes"]
            got = [rank[f"shape/{arch}/{name}/train/{part}{k}"][0]
                   for k in keys]
            assert len(got) == len(want)
            for k, g, w in zip(keys, got, want):
                np.testing.assert_array_equal(g, w, err_msg=k)
        np.testing.assert_array_equal(
            rank[f"shape/{arch}/{name}/train/batch['tokens']"][0],
            reference[f"{arch}/{name}/batch_shape"][0])


@pytest.mark.parametrize("arch", FAMILIES)
def test_eight_bit_step_matches_one_process(arch, world4, one_process):
    """One step with 8-bit moments (their blocks split over data x model)
    on 2 x 2: the loss and gradient norm, the state after it by the 8-bit
    contract with the scales to 1e-5 (the gradients' own tolerance), and
    the ranks' `adamw.apply` against one process's on the ranks' own
    gradients from the zero state: bit for bit where the gradient norm
    is under the clip."""
    c = cases.cfg(arch)
    like = moe.params_of(c)
    zero = adamw.init(like, 8)
    tag = f"{arch}/2x2/q8"
    for rank in world4:
        for what in ("loss", "grad_norm"):
            _close(rank[f"{tag}/{what}/0"][0],
                   one_process[f"{arch}/one/q8/{what}/0"][0], what=what)
        base.eight_bit_close(base.sub(rank, f"{tag}/state1"),
                             base.sub(one_process, f"{arch}/one/q8/state1"),
                             scale_rtol=base.GRAD_SCALE_RTOL)
        exact = float(rank[f"{tag}/grad_norm/0"][0]) < base.OPT8.grad_clip
        want = base.replayed(rank, tag, c, base.OPT8,
                             (like, zero.mu, zero.nu), step=0, call=1)
        base.eight_bit_close(base.sub(rank, f"{tag}/state1"), want, exact)


def test_one_by_one_rank_mesh_equals_no_mesh_bit_for_bit(world1):
    none = {k[5:]: v for k, v in world1.items() if k.startswith("none/")}
    ranks = {k[6:]: v for k, v in world1.items() if k.startswith("ranks/")}
    assert none.keys() - {k for k in none if k.endswith("/comm")} == \
        ranks.keys() - {k for k in ranks if k.endswith("/comm")}
    for k, v in none.items():
        if not k.endswith("/comm"):
            np.testing.assert_array_equal(ranks[k][0], v[0], err_msg=k)


def _sorted_keys(c):
    """The port's leaf keys in the reference's leaf order (sorted keys)."""
    params = moe.params_of(c)
    order = {id(x): i for i, x in enumerate(adamw.tree_leaves(params))}
    pairs = shd.leaves_with_path(params)
    return [k for k, x in sorted(pairs, key=lambda kx: order[id(kx[1])])]


def _start_reference(tmp):
    """Under ``REPRO_PARALLELISM=fsdp`` on 4 forced host devices: the
    reference's jitted ``value_and_grad`` of the dense and MoE models on
    2 x 2 with its constraints (the chunks the ranks run, the port's
    parameters by their ``keystr`` paths), and the shard shapes its
    parameter and batch specs give on 2 x 2 and 1 x 4."""
    given = {}
    for arch in SERVED:
        c = cases.cfg(arch)
        given.update({f"{arch}/p{k}": v.numpy() for k, v in
                      flat_tree(moe.params_of(c)).items()})
        given.update({f"{arch}/batch/{k}": v.numpy()
                      for k, v in base.batch_of(c).items()})
    np.savez(tmp / "inputs.npz", **given)
    return start_forced_reference(f"""
        from jax.sharding import NamedSharding, PartitionSpec
        from repro.configs.base import reduced
        from repro.configs.registry import get_config, get_reduced_config
        from repro.launch.steps import batch_specs
        from repro.models import moe
        from repro.models import sharding as shd
        from repro.models.model import build_model
        assert shd.PARALLELISM == "fsdp"
        moe.TOK_CHUNK = {moe.CHUNKS["moe.TOK_CHUNK"]}
        with np.load({str(tmp / 'inputs.npz')!r}) as f:
            given = {{k: f[k] for k in f.files}}
        for arch, cfg in (
                ({cases.DENSE!r}, get_reduced_config({cases.DENSE!r})),
                ({cases.MOE!r}, reduced(get_config({cases.MOE!r}),
                                        vocab_size={moe.GRANITE_VOCAB}))):
            model = build_model(cfg)
            paths, tree = jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(model.init, jax.random.PRNGKey(0)))
            params = jax.tree_util.tree_unflatten(tree, [
                given[arch + "/p" + jax.tree_util.keystr(p)]
                for p, _ in paths])
            b = {{k.rsplit("/", 1)[1]: v for k, v in given.items()
                  if k.startswith(arch + "/batch/")}}
            for name, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
                mesh = auto_mesh(shape, ("data", "model"))
                specs = shd.param_specs(params, mesh)
                save(f"{{arch}}/{{name}}/shapes", *[
                    np.array(NamedSharding(mesh, s).shard_shape(x.shape))
                    for s, x in zip(
                        jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
                            s, PartitionSpec)), jax.tree.leaves(params))])
                save(f"{{arch}}/{{name}}/batch_shape", np.array(
                    NamedSharding(mesh, batch_specs(b, mesh)["tokens"])
                    .shard_shape(b["tokens"].shape)))
            mesh = auto_mesh((2, 2), ("data", "model"))
            ns = lambda specs: jax.tree.map(
                lambda s: NamedSharding(mesh, s), specs,
                is_leaf=lambda s: isinstance(s, PartitionSpec))
            with shd.use_mesh(mesh):
                fn = jax.jit(jax.value_and_grad(model.loss), in_shardings=(
                    ns(shd.param_specs(params, mesh)),
                    ns(batch_specs(b, mesh))))
                loss, grads = fn(params, b)
            save(arch + "/loss", loss)
            save(arch + "/grads", *jax.tree.leaves(grads))
    """, 4, tmp, env=FSDP)


@pytest.fixture(scope="module")
def reference(started):
    return finish_forced_reference(started["reference"], timeout=300)


@pytest.mark.parametrize("arch", SERVED)
def test_gradients_match_the_reference_fsdp_meshed_step(arch, reference,
                                                        world4):
    """The 2 x 2 loss and gradients against the reference's jitted
    ``value_and_grad`` under ``fsdp`` on a 2 x 2 mesh: within 1e-4 of each
    leaf's max."""
    keys = _sorted_keys(cases.cfg(arch))
    for rank in world4:
        _close(rank[f"{arch}/2x2/grads/loss"][0], reference[f"{arch}/loss"][0])
        got = [rank[f"{arch}/2x2/grads/grads{k}"][0] for k in keys]
        want = reference[f"{arch}/grads"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
