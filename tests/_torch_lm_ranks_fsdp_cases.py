"""Every family's steps on rank meshes under ``REPRO_PARALLELISM=fsdp``:
the cases that `test_torch_lm_ranks_fsdp.py` runs in gloo ranks (whose
environment sets the preset before `repro_torch` is imported) and, with
``mesh=None``, in one process.  The cases are those of the other rank
test modules (`_torch_lm_ranks_cases`, `_torch_lm_ranks_moe_cases`,
`_torch_lm_ranks_families_cases`): one reduced model of each family at
their sizes and chunks, the port's parameters from seed 0.

No jax here: the ranks import this module.
"""
import contextlib

import numpy as np

import _torch_lm_ranks_cases as base
import _torch_lm_ranks_families_cases as fam
import _torch_lm_ranks_moe_cases as moe
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import steps
from repro_torch.models import sharding as shd

DENSE, MOE = "gemma2-2b", "granite-moe-1b-a400m"
# one model of each family, the family first
FAMILIES = {"dense": DENSE, "moe": MOE, "hybrid": "jamba-v0.1-52b",
            "ssm": fam.RWKV, "audio": fam.WHISPER, "vlm": fam.VLM}
# the batch a 2 x 2 mesh cannot split four ways: the rows go over "data"
# alone and every "model" rank holds them whole
FALLBACK_B = 2


def cfg(arch):
    if arch == DENSE:
        return base.cfg()
    if arch in moe.ARCHS:
        return moe.cfg(arch)
    return fam.cfg(arch)


@contextlib.contextmanager
def sized(arch):
    """The chunks and batch each model's rank tests run it at."""
    if arch in moe.ARCHS:
        with moe.chunks():
            yield
    elif arch in fam.ARCHS:
        with fam.batches():
            yield
    else:
        yield


def grads(save, mesh, arch, name):
    """`Model.loss` and its gradients, whole, tagged
    ``<arch>/<name>/grads``."""
    c = cfg(arch)
    with sized(arch):
        base.loss_and_grads(save, mesh, c, moe.params_of(c),
                            tag=f"{arch}/{name}/grads")


def train_and_serve(save, mesh, arch, name):
    """Two train steps and greedy generation (`_torch_lm_ranks_cases`),
    tagged ``<arch>/<name>/train`` and ``/gen``."""
    c = cfg(arch)
    with sized(arch):
        base.train(save, mesh, c, moe.params_of(c), tag=f"{arch}/{name}/train")
        base.generate(save, mesh, c, moe.params_of(c),
                      tag=f"{arch}/{name}/gen")


def eight_bit(save, mesh, arch, name):
    """One train step with 8-bit moments, and the gradients and state
    its `adamw.apply` saw and returned (`_torch_lm_ranks_cases.applies`),
    tagged ``<arch>/<name>/q8``."""
    c = cfg(arch)
    tag = f"{arch}/{name}/q8"
    with sized(arch), base.applies(save, mesh, tag, calls=1):
        base.train(save, mesh, c, moe.params_of(c), tag=tag, steps_=1,
                   opt_cfg=base.OPT8)


@contextlib.contextmanager
def small_batch():
    """`_torch_lm_ranks_cases`' batch cut to `FALLBACK_B` rows."""
    saved = base.B
    base.B = FALLBACK_B
    try:
        yield
    finally:
        base.B = saved


def fallback(save, mesh, name):
    """The dense model's loss and gradients on `FALLBACK_B` rows, and the
    batch block each rank holds (``shape/<name>/batch``)."""
    with small_batch():
        grads(save, mesh, DENSE, f"{name}/b{FALLBACK_B}")
        if shd.is_rank_mesh(mesh):
            c = cfg(DENSE)
            st = steps.make_train_step(c, ShapeCfg("t", base.S, base.B,
                                                   "train"), mesh, base.OPT,
                                       device="cpu")
            batch = shd.shard_tree(base.batch_of(c), st.in_specs[2], mesh,
                                   "cpu")
            save(f"shape/{name}/batch", np.array(
                shd.local_block(batch["tokens"]).shape, dtype=np.int64))
