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
               PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got: dict = {}
    with np.load(out) as data:
        for key in sorted(data.files, key=lambda k: (k.rsplit("/", 1)[0],
                                                     int(k.rsplit("/", 1)[1]))):
            got.setdefault(key.rsplit("/", 1)[0], []).append(data[key])
    return got
