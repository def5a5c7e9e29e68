"""Helpers for the port's parity tests: move reference state to the port.

State crosses as numpy only, through `repro_torch.convert` — the two
packages never see each other's objects.
"""
import jax
import numpy as np

from repro_torch import convert


def leaves(tree):
    """numpy leaves of a reference pytree (None fields dropped)."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def port_chip(ref_chip):
    return convert.chip_from_numpy(leaves(ref_chip), device="cpu")


def port_mismatch(ref_mismatch):
    return convert.mismatch_from_numpy(leaves(ref_mismatch), device="cpu")


def assert_chip_close(port, ref, rtol=1e-6):
    """Programmed chips agree to float32 rounding: 1e-6 relative (the
    8-term DAC sum may associate differently in the two frameworks)."""
    for name in ("W", "h", "tanh_gain", "tanh_offset", "rand_gain",
                 "comp_offset", "nbr_w"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.numpy().dtype == np.float32, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=1e-7, err_msg=name)
    assert (port.nbr_idx is None) == (ref.nbr_idx is None)
    if port.nbr_idx is not None:
        np.testing.assert_array_equal(port.nbr_idx.numpy(),
                                      np.asarray(ref.nbr_idx))


# ---------------------------------------------------------------------------
# the reference's multi-device engine, on forced host devices
# ---------------------------------------------------------------------------
# The reference's sharded tests build their meshes with ``jax.make_mesh``,
# whose axes default to Explicit in this jax and then fail inside the
# engine's gathers; built with ``axis_types=(AxisType.Auto,) * n`` the same
# engine runs unchanged.  The prelude below gives each script an
# ``auto_mesh`` helper and ``save`` for its outputs.
_FORCED_PRELUDE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n_dev}"
import numpy as np
import jax
from jax.sharding import AxisType

def auto_mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

OUT = {{}}

def save(name, *arrays):
    for i, a in enumerate(arrays):
        OUT[f"{{name}}/{{i}}"] = np.asarray(a)
"""


def run_forced_reference(script: str, n_dev: int, out_dir,
                         timeout: int = 300) -> dict:
    """Run ``script`` (after the prelude) in a fresh interpreter with
    ``n_dev`` forced host devices; returns ``{name: [arrays]}`` of what it
    passed to ``save(name, *arrays)``."""
    return finish_forced_reference(
        start_forced_reference(script, n_dev, out_dir), timeout)


def start_forced_reference(script: str, n_dev: int, out_dir,
                           env: dict | None = None):
    """`run_forced_reference`'s interpreter, started and not waited for:
    hand the result to `finish_forced_reference`.  ``env``: variables
    set for it (``REPRO_PARALLELISM``, read at import)."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = Path(out_dir) / "reference.npz"
    code = (_FORCED_PRELUDE.format(n_dev=n_dev) + textwrap.dedent(script)
            + f"\nnp.savez({str(out)!r}, **OUT)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"), **(env or {}))
    # output to a file: a pipe nobody reads yet could fill and stall
    log = Path(out_dir) / "reference.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                stderr=subprocess.STDOUT, env=env, cwd=root)
    return proc, out, log


def finish_forced_reference(started, timeout: int = 300) -> dict:
    """Wait for `start_forced_reference`'s interpreter (killed after
    ``timeout`` seconds) and read what it saved."""
    import subprocess

    proc, out, log = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    assert proc.returncode == 0, log.read_text()[-3000:]
    return _load_saved(out)


def _load_saved(path) -> dict:
    """``{name: [arrays]}`` of an npz written from ``save(name, *arrays)``
    (keys ``name/i``)."""
    got: dict = {}
    with np.load(path) as data:
        for key in sorted(data.files, key=lambda k: (
                k.rsplit("/", 1)[0], int(k.rsplit("/", 1)[1]))):
            got.setdefault(key.rsplit("/", 1)[0], []).append(data[key])
    return got


# ---------------------------------------------------------------------------
# the port's sharded engine across processes: gloo ranks on the CPU
# ---------------------------------------------------------------------------
# Each rank runs the prelude, then the script: one thread, the default
# process group joined through a FileStore in the output directory (no
# ports), ``INPUTS`` the arrays the test passed, and ``save`` for what the
# rank returns.  A peer that hangs fails the rank after RANK_TIMEOUT_S.
_RANK_PRELUDE = """
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import ranks
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
ranks.init_rank("gloo", RANK, WORLD, store_path={store!r},
                timeout_s={timeout!r})
with np.load({inputs!r}) as _f:
    INPUTS = {{k: _f[k] for k in _f.files}}
OUT = {{}}

def save(name, *arrays):
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        OUT[f"{{name}}/{{i}}"] = np.asarray(a)
"""

RANK_TIMEOUT_S = 60


def run_ranks(script: str, world: int, out_dir, inputs: dict | None = None,
              timeout: int = 180) -> list[dict]:
    """Run ``script`` (after the prelude) in ``world`` fresh interpreters,
    ranks 0..world-1 of one gloo group; returns each rank's ``{name:
    [arrays]}`` of what it passed to ``save(name, *arrays)``.  Every rank
    must exit 0 within ``timeout`` seconds (the others are killed when one
    fails or hangs)."""
    return finish_ranks(start_ranks(script, world, out_dir, inputs), timeout)


def start_ranks(script: str, world: int, out_dir,
                inputs: dict | None = None, env: dict | None = None):
    """`run_ranks`' interpreters, started and not waited for: hand the
    result to `finish_ranks`.  ``env``: variables set in every rank
    before it imports `repro_torch` (``REPRO_PARALLELISM``)."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    in_path = out_dir / "inputs.npz"
    np.savez(in_path, **(inputs or {}))
    code = (_RANK_PRELUDE.format(store=str(out_dir / "store"),
                                 timeout=RANK_TIMEOUT_S,
                                 inputs=str(in_path))
            + textwrap.dedent(script)
            + f"\nnp.savez({str(out_dir)!r} + f'/rank{{RANK}}.npz', **OUT)\n"
            + "torch.distributed.destroy_process_group()\n")
    procs = []
    for rank in range(world):
        rank_env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                        PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1",
                        **(env or {}))
        # output to files: a pipe nobody reads yet could fill and stall
        with open(out_dir / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], stdout=log,
                stderr=subprocess.STDOUT, env=rank_env, cwd=root))
    return procs, out_dir


def finish_ranks(started, timeout: int = 180) -> list[dict]:
    """Wait for `start_ranks`' interpreters: every rank must exit 0 within
    ``timeout`` seconds of this call (the others are killed when one fails
    or hangs); returns each rank's saved arrays."""
    import time

    procs, out_dir = started
    deadline = time.monotonic() + timeout
    errs = []
    try:
        for rank, proc in enumerate(procs):
            left = max(1.0, deadline - time.monotonic())
            proc.wait(timeout=left)
            if proc.returncode != 0:
                err = (out_dir / f"rank{rank}.log").read_text()
                errs.append(f"rank {rank} exited {proc.returncode}: "
                            f"{err[-3000:]}")
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errs, errs[0]
    return [_load_saved(out_dir / f"rank{rank}.npz")
            for rank in range(len(procs))]


# ---------------------------------------------------------------------------
# language models: the reference's reduced models carried to the port
# ---------------------------------------------------------------------------
def lm_state(arch: str, batch: int = 2, seq: int = 64):
    """The reference's reduced ``arch`` (float32): (port cfg, ref cfg, ref
    model, ref params, port params, ref batch, port batch), the
    parameters drawn from ``PRNGKey(0)`` and carried across by
    `convert.lm_tree_from_numpy`, the batch `make_dummy_batch`'s from
    ``PRNGKey(1)``."""
    import torch
    from repro.configs.base import ShapeCfg
    from repro.configs.registry import get_reduced_config as ref_reduced
    from repro.models.model import build_model as ref_build
    from repro.models.model import make_dummy_batch
    from repro_torch.configs.registry import get_reduced_config

    rcfg = ref_reduced(arch)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    rbatch = make_dummy_batch(rcfg, ShapeCfg("smoke", seq, batch, "train"),
                              jax.random.PRNGKey(1))
    pparams = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, rparams),
                                         "cpu")
    pbatch = {k: torch.as_tensor(np.array(v)) for k, v in rbatch.items()}
    pbatch["tokens"] = pbatch["tokens"].long()
    return (get_reduced_config(arch), rcfg, rmodel, rparams, pparams, rbatch,
            pbatch)


def flat_tree(tree, path=""):
    """{path: leaf} over dicts and lists, the paths in the reference's
    ``jax.tree_util.keystr`` form (``['prefix'][0]['attn']['wq']``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{path}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def ref_flat_tree(tree):
    """`flat_tree` of a reference pytree."""
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_lm_tree_close(port, ref, rtol=1e-5, atol=1e-5):
    """A port tree against a reference pytree leaf for leaf: the same
    paths, shapes and dtypes, and values to ``rtol`` plus ``atol`` times
    the leaf's max |x| where that exceeds 1 (RWKV's wkv state reaches
    ~12, and summation order moves its entries by up to 4.6e-5, 3.8e-6 of
    the max)."""
    got, want = flat_tree(port), ref_flat_tree(ref)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
        scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
        np.testing.assert_allclose(got[k].float().numpy(), w, rtol=rtol,
                                   atol=atol * scale, err_msg=k)


# the hardware-aware transform of the loss tests: 8 bits, no gain mismatch
# (the packages draw other chips at sigma > 0, ROADMAP Queue 3 item 18),
# every matrix of 256 entries or more (the reduced models' are small)
LM_HW = dict(bits=8, sigma_gain=0.0, min_size=256)


def assert_loss_and_grads_match(state, hw: bool):
    """`Model.loss` against the reference's on the same parameters and
    batch, to 1e-5 relative.  Plainly (``hw`` False) also its gradients
    (``torch.autograd.grad`` over every leaf against
    ``jax.value_and_grad``), each leaf to 1e-4 of its max |g| (as
    `test_torch_train.py`); hardware-aware (`LM_HW`) the loss alone."""
    import pytest
    import torch
    from repro.core.hwaware import HwAwareConfig as RHw
    from repro.models.model import build_model as ref_build
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw

    cfg, rcfg, _, rparams, pparams, rbatch, pbatch = state
    rmodel = ref_build(rcfg, hw_aware=RHw(**LM_HW) if hw else None)
    model = build_model(cfg, hw_aware=HwAwareConfig(**LM_HW) if hw else None,
                        device="cpu")
    if hw:
        want = float(rmodel.loss(rparams, rbatch))
        assert float(model.loss(pparams, pbatch)) == pytest.approx(
            want, rel=1e-5)
        return
    want_loss, want_g = jax.value_and_grad(rmodel.loss)(rparams, rbatch)
    live = [p.detach().requires_grad_() for p in adamw.tree_leaves(pparams)]
    loss = model.loss(adamw.tree_unflatten(pparams, live), pbatch)
    grads = torch.autograd.grad(loss, live)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    want = jax.tree.leaves(want_g)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def assert_hw_transform_matches(state):
    """`core.hwaware.apply_hardware` under `LM_HW` on the same tree: each
    package's `_should_quantize` selects the same leaves (none of them an
    embedding), some of them change, and every leaf equals the
    reference's transform bit for bit.  Returns the selected paths."""
    from repro.core import hwaware as RH
    from repro_torch.core import hwaware as PH

    rparams, pparams = state[3], state[4]
    rcfg, pcfg = RH.HwAwareConfig(**LM_HW), PH.HwAwareConfig(**LM_HW)
    src, port_src = ref_flat_tree(rparams), flat_tree(pparams)
    chosen = {k for k, w in src.items() if RH._should_quantize(k, w, rcfg)}
    assert chosen == {k for k, w in port_src.items()
                      if PH._should_quantize(k, w, pcfg)}
    assert chosen and not any("embed" in k for k in chosen)
    want = ref_flat_tree(RH.apply_hardware(rparams, rcfg,
                                           jax.random.PRNGKey(0)))
    got = flat_tree(PH.apply_hardware(pparams, pcfg, 0))
    assert any(not np.array_equal(np.asarray(want[k]), np.asarray(src[k]))
               for k in chosen)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)
    return chosen
