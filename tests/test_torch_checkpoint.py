"""The crash-consistency contract of `repro_torch.checkpoint`, as the
reference's `tests/test_checkpoint.py` states it for its own: atomic
writes (tmp dir + os.replace), readers trust only directories carrying
the ``.complete`` marker, bfloat16 survives the npz round trip, the async
writer never exposes a torn checkpoint.  Plus what the port adds: tensors
come back on the target's device with its dtype, and a directory written
by the reference's `checkpoint.save` loads here (and the other way).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.optim import adamw as ref_adamw
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.optim import adamw


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(7, 3)).astype(np.float32),
        "step_key": np.asarray([seed, seed + 1], np.uint32),
        "nested": {"v": rng.normal(size=(5,)).astype(np.float32)},
    }


def _torch_tree(seed=0):
    t = _tree(seed)
    return {"w": torch.as_tensor(t["w"]),
            "step_key": torch.as_tensor(t["step_key"].view(np.int32)),
            "nested": {"v": torch.as_tensor(t["nested"]["v"])},
            "pair": (torch.arange(3, dtype=torch.int64), np.ones(2, bool))}


def test_save_load_round_trip(tmp_path):
    tree = _tree(1)
    path = ckpt.save(tmp_path, 12, tree, extra={"kl": [0.5, 0.4]})
    assert path.name == "step_000000012"
    step, got, extra = ckpt.load(tmp_path, target=_tree(99))
    assert step == 12
    assert extra == {"kl": [0.5, 0.4]}
    for k in ("w", "step_key"):
        np.testing.assert_array_equal(np.asarray(got[k]), tree[k])
    np.testing.assert_array_equal(np.asarray(got["nested"]["v"]),
                                  tree["nested"]["v"])


def test_tensors_come_back_on_the_targets_device_and_dtype(tmp_path):
    tree = _torch_tree(2)
    ckpt.save(tmp_path, 1, tree)
    target = {"w": torch.zeros((7, 3), dtype=torch.float64),
              "step_key": torch.zeros(2, dtype=torch.int32),
              "nested": {"v": torch.zeros(5)},
              "pair": (torch.zeros(3, dtype=torch.int64),
                       np.zeros(2, bool))}
    _, got, _ = ckpt.load(tmp_path, target=target)
    assert got["w"].dtype == torch.float64
    assert torch.equal(got["w"], tree["w"].to(torch.float64))
    assert torch.equal(got["step_key"], tree["step_key"])
    assert torch.equal(got["nested"]["v"], tree["nested"]["v"])
    assert isinstance(got["pair"], tuple)
    assert torch.equal(got["pair"][0], tree["pair"][0])
    assert got["pair"][1].dtype == bool and got["pair"][1].all()
    _, flat, _ = ckpt.load(tmp_path)
    assert sorted(flat) == ["['nested']['v']", "['pair'][0]",
                            "['pair'][1]", "['step_key']", "['w']"]
    with pytest.raises(KeyError, match="missing"):
        ckpt.load(tmp_path, target={"absent": torch.zeros(1)})


def test_marker_honored(tmp_path):
    """latest_step/load only trust directories with the commit marker."""
    ckpt.save(tmp_path, 3, _tree())
    ckpt.save(tmp_path, 7, _tree())
    assert ckpt.latest_step(tmp_path) == 7
    (tmp_path / "step_000000007" / ".complete").unlink()
    assert ckpt.latest_step(tmp_path) == 3
    step, _, _ = ckpt.load(tmp_path, target=_tree())
    assert step == 3
    with pytest.raises(FileNotFoundError):
        ckpt.load(tmp_path, step=7, target=_tree())
    assert ckpt.latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        ckpt.load(tmp_path / "absent")


def test_killed_mid_write_dir_ignored(tmp_path):
    """A writer killed mid-write leaves step_*.tmp — readers never see it."""
    ckpt.save(tmp_path, 5, _tree())
    torn = tmp_path / "step_000000009.tmp"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"\x00partial")
    (torn / "meta.json").write_text(json.dumps({"step": 9}))
    assert ckpt.latest_step(tmp_path) == 5
    # the next writer at the same step clears the stale tmp dir
    ckpt.save(tmp_path, 9, _tree(2))
    assert ckpt.latest_step(tmp_path) == 9
    assert not torn.exists()


def test_bf16_round_trip(tmp_path):
    tree = {"p": torch.arange(16, dtype=torch.bfloat16) / 7.0,
            "q": np.ones((3,), np.float32)}
    ckpt.save(tmp_path, 1, tree)
    meta = json.loads((tmp_path / "step_000000001" / "meta.json")
                      .read_text())
    assert meta["logical_dtypes"] == {"['p']": "bfloat16"}
    assert meta["dtypes"]["__bf16__['p']"] == "uint16"
    _, raw, _ = ckpt.load(tmp_path)
    # stored as uint16 bits; load() gives the bfloat16 values back
    assert raw["['p']"].dtype == torch.bfloat16
    assert torch.equal(raw["['p']"].view(torch.int16),
                       tree["p"].view(torch.int16))
    _, typed, _ = ckpt.load(tmp_path, target=tree)
    assert typed["p"].dtype == torch.bfloat16
    assert torch.equal(typed["p"].view(torch.int16),
                       tree["p"].view(torch.int16))


def test_async_checkpointer_overlap(tmp_path):
    """AsyncCheckpointer commits in the background; a second save blocks
    on (and therefore observes) the first; keep= collects old steps."""
    ac = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        ac.save(step, _torch_tree(step))
    ac.wait()
    assert ckpt.latest_step(tmp_path) == 3
    assert not (tmp_path / "step_000000001").exists()
    assert (tmp_path / "step_000000002").exists()
    # the host copy is taken before save() returns: writing the tensor
    # afterwards does not change what is committed
    live = {"w": torch.full((4,), 2.5)}
    ac.save(4, live)
    live["w"].fill_(-1.0)
    ac.wait()
    _, got, _ = ckpt.load(tmp_path, step=4)
    np.testing.assert_array_equal(got["['w']"], np.full((4,), 2.5,
                                                        np.float32))


def test_async_checkpointer_error_propagates(tmp_path):
    ac = ckpt.AsyncCheckpointer(tmp_path / "file_in_the_way")
    (tmp_path / "file_in_the_way").write_text("not a directory")
    ac.save(1, _tree())
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()                             # the error is raised once


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """The same layout and keys: a directory written by one package's
    `save` loads in the other's `load`, values and extra intact."""
    tree = _tree(4)
    extra = {"kl_history": [[3, 0.25]], "spec": {"noise": "counter"}}
    (ref_ckpt if writer == "reference" else ckpt).save(tmp_path, 6, tree,
                                                       extra=extra)
    assert ckpt.latest_step(tmp_path) == ref_ckpt.latest_step(tmp_path) == 6
    target = {"w": torch.zeros((7, 3)), "step_key": np.zeros(2, np.uint32),
              "nested": {"v": torch.zeros(5)}}
    step, got, got_extra = ckpt.load(tmp_path, target=target)
    assert step == 6 and got_extra == extra
    assert torch.equal(got["w"], torch.as_tensor(tree["w"]))
    np.testing.assert_array_equal(got["step_key"], tree["step_key"])
    assert torch.equal(got["nested"]["v"], torch.as_tensor(
        tree["nested"]["v"]))
    _, ref_got, _ = ref_ckpt.load(tmp_path, target=_tree(0))
    for k in ("w", "step_key"):
        np.testing.assert_array_equal(np.asarray(ref_got[k]), tree[k])


def _train_state(bits):
    """The reference's (params, opt_state) one AdamW step in: a stacked
    bf16 slot, a float32 norm and a leaf of 300 entries (padded to two
    8-bit blocks)."""
    rng = np.random.default_rng(bits)
    params = {"blocks": {"w": jnp.asarray(rng.normal(size=(2, 8, 40)),
                                          jnp.bfloat16)},
              "final_norm": jnp.asarray(rng.normal(size=(8,)), jnp.float32),
              "tok": jnp.asarray(rng.normal(size=(300,)), jnp.float32)}
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, params)
    cfg = ref_adamw.AdamWConfig(state_bits=bits)
    return ref_adamw.apply(cfg, grads, ref_adamw.init(params, bits),
                           params)[:2]


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_training_state_crosses_between_the_packages(tmp_path, writer, bits):
    """``(params, opt_state)`` keys alike in both packages (the named
    tuple's fields as ``.step``, an 8-bit moment's children as
    ``[<flat index 0>]``), so a training checkpoint written by either
    loads in the other with equal leaves."""
    state = _train_state(bits)
    np_state = jax.tree.map(np.asarray, state)
    port = (convert.lm_tree_from_numpy(np_state[0], "cpu"),
            convert.opt_state_from_numpy(np_state[1], "cpu"))
    keys = [k for k, _ in ckpt._leaves(port)]
    assert keys == [jax.tree_util.keystr(p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(state)[0]]
    assert "[1].step" in keys
    if bits == 8:
        assert "[1].mu['blocks']['w'][<flat index 0>]" in keys
    if writer == "reference":
        ref_ckpt.save(tmp_path, 1, state)
    else:
        ckpt.save(tmp_path, 1, port)
    target = (convert.lm_tree_from_numpy(
        jax.tree.map(np.zeros_like, np_state[0]), "cpu"),
        adamw.init(convert.lm_tree_from_numpy(np_state[0], "cpu"), bits))
    _, got, _ = ckpt.load(tmp_path, target=target)
    assert isinstance(got[1], adamw.OptState)
    for a, b in zip(ckpt._leaves(got), ckpt._leaves(port)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1]), a[0]
    _, ref_got, _ = ref_ckpt.load(tmp_path, target=state)
    for a, b in zip(jax.tree.leaves(ref_got), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
