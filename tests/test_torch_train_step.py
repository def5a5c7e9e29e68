"""The language model's train step (`launch.steps.make_train_step`) and
entry point (`launch.train`) on the port, against the reference's where
the two can be compared: reduced gemma2-2b (float32), the reference's
parameters carried across by `repro_torch.convert`.

A 5-step loss trajectory against the reference's train step to 1e-4
relative: losses, not parameters, because at step 1 AdamW's update is
about sign(g), and a near-zero gradient entry that differs in its 7th
digit can move its parameter by 2 lr either way.  Then the reference's
own system tests on the port, and a resumed `launch.train` run equal to
the uninterrupted one bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCfg as RShape
from repro.configs.registry import get_reduced_config as ref_reduced
from repro.core.hwaware import HwAwareConfig as RHw
from repro.data.pipeline import DataConfig as RData
from repro.data.pipeline import SyntheticLM as RSynth
from repro.launch import mesh as ref_mesh
from repro.launch.steps import make_train_step as ref_train_step
from repro.models.model import build_model as ref_build
from repro.optim import adamw as RA
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.hwaware import HwAwareConfig
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch import train as lm_train
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw

HW = dict(bits=8, sigma_gain=0.0, min_size=256)
B, S = 2, 64


def test_loss_trajectory_matches_reference():
    """5 train steps from the same state and batches: the reference's
    `make_train_step` on a one-device host mesh, the port's on the CPU
    (hardware-aware at sigma 0, warmup 2): losses to 1e-4 relative."""
    np_params = jax.tree.map(np.asarray, ref_build(
        ref_reduced("gemma2-2b")).init(jax.random.PRNGKey(0)))
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    ref_step = ref_train_step(
        ref_reduced("gemma2-2b"), RShape("t", S, B, "train"),
        ref_mesh.make_host_mesh(1, 1), RA.AdamWConfig(**ocfg),
        hw_aware=RHw(**HW))
    step = make_train_step(get_reduced_config("gemma2-2b"),
                           ShapeCfg("t", S, B, "train"),
                           adamw.AdamWConfig(**ocfg),
                           hw_aware=HwAwareConfig(**HW), device="cpu")
    rp = jax.tree.map(jnp.asarray, np_params)
    ro = RA.init(rp)
    pp = convert.lm_tree_from_numpy(np_params, "cpu")
    po = adamw.init(pp)
    rsrc = RSynth(RData(seed=0, vocab_size=512))
    psrc = make_source(DataConfig(seed=0, vocab_size=512))
    want, got = [], []
    for s in range(5):
        rp, ro, rm = ref_step.fn(rp, ro, rsrc.batch(s, B, S))
        pp, po, pm = step.fn(pp, po, psrc.batch(s, B, S, device="cpu"))
        want.append(float(rm["loss"]))
        got.append(float(pm["loss"]))
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert got[-1] < got[0]


# --------------------------- the reference's own system tests on the port
def test_hwaware_training_step_decreases_loss():
    """The generalized in-situ learning: optimize THROUGH the hardware
    model; loss on the 'hardware' forward decreases."""
    cfg = get_reduced_config("gemma2-2b")
    hw = HwAwareConfig(bits=8, sigma_gain=0.05, min_size=256)
    step = make_train_step(
        cfg, ShapeCfg("t", 64, 4, "train"),
        adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50),
        hw_aware=hw, device="cpu")
    params = step.model.init(0)
    opt = adamw.init(params)
    src = make_source(DataConfig(seed=0, vocab_size=cfg.vocab_size))
    losses = []
    for s in range(15):
        params, opt, m = step.fn(params, opt, src.batch(s, 4, 64,
                                                        device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses


def test_microbatched_step_matches_full_batch():
    cfg = get_reduced_config("deepseek-67b")
    shape = ShapeCfg("t", 32, 8, "train")
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    src = make_source(DataConfig(seed=0, vocab_size=cfg.vocab_size))
    batch = src.batch(0, 8, 32, device="cpu")
    outs = []
    for mb in (1, 4):
        step = make_train_step(cfg, shape, ocfg, microbatches=mb,
                               device="cpu")
        params = step.model.init(0)
        _, _, m = step.fn(params, adamw.init(params), batch)
        outs.append((float(m["loss"]), float(m["grad_norm"])))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-3)
    assert outs[0][1] == pytest.approx(outs[1][1], rel=2e-2)


def test_train_main_logs_and_resumes_bit_equal(tmp_path, capsys):
    """`python -m repro_torch.launch.train --reduced --device cpu` for 6
    steps with a checkpoint every 2; with steps 4 and 6 deleted a second
    run resumes from step 2 and ends on the first run's step-6
    parameters and moments, bit for bit."""
    argv = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "32", "--ckpt-every", "2", "--log-every", "2",
            "--hardware-aware", "--ckpt-dir", str(tmp_path)]
    rows = lm_train.main(argv)
    out = capsys.readouterr().out
    assert "arch=gemma2-2b-reduced" in out and "step     6  loss=" in out
    assert [r["step"] for r in rows] == [1, 2, 4, 6]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in rows)
    _, first, _ = ckpt.load(tmp_path, 6)
    for s in (6, 4):
        ckpt.shutil.rmtree(tmp_path / f"step_{s:09d}")
    assert ckpt.latest_step(tmp_path) == 2
    lm_train.main(argv)
    assert "resumed from step 2" in capsys.readouterr().out
    _, second, _ = ckpt.load(tmp_path, 6)
    assert sorted(first) == sorted(second)
    assert "[1].step" in first and int(second["[1].step"]) == 6
    for k in first:
        a, b = first[k], second[k]
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(a, b)), k
