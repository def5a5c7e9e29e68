"""Crash-safe CD training and the fault-tolerance runtime of the port,
mirroring the reference's `tests/test_resilience.py`.

The headline contract: a training run that is killed mid-flight and
resumed from its latest checkpoint ends with master weights bit-identical
to a run that never crashed.  `train_cd_resilient` makes that hold by
deriving each epoch's generators from (seed, stream, epoch) and
checkpointing the full `CDTrainState` atomically.  Also covered: retry
backoff, the watchdog and the heartbeat, refusing a foreign checkpoint,
and faults (stuck spins, dead couplers, flips, stuck LFSR bits) through the
row-band engine: 2 bands equal 1 band and equal the reference's engine on
two forced host devices.
"""
from __future__ import annotations

import json
import random
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import cd as ref_cd
from repro.core.chimera import make_chimera
from repro_torch import api
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import distributed as dist
from repro_torch.core import tasks
from repro_torch.core.hardware import HardwareConfig
from repro_torch.core.cd import (CDConfig, PBitMachine, epoch_seed,
                                 train_cd_resilient)
from repro_torch.runtime.fault_tolerance import (
    Heartbeat,
    StragglerWatchdog,
    TransientError,
    retry_step,
)

from _torch_port import run_forced_reference

ROOT = Path(__file__).resolve().parent.parent
FAULTS = api.Faults(stuck_nodes=(5,), stuck_values=(-1,), dead_edges=(2,),
                    saturated_edges=(7,))


def _quick_cfg(epochs=6):
    return CDConfig(epochs=epochs, chains=32, cd_k=3, pos_sweeps=3,
                    burn_in=1)


def _machine(seed=42, **kw):
    g = make_chimera(1, 1)
    kw.setdefault("noise", "counter")
    kw.setdefault("faults", FAULTS)
    return PBitMachine.create(g, seed, device="cpu", **kw)


def _task():
    return tasks.and_gate_task(make_chimera(1, 1))


# ---------------------------------------------------------------------------
# runtime primitives
# ---------------------------------------------------------------------------
def test_heartbeat_dead_hosts_honors_explicit_time_zero(tmp_path):
    """now=0.0 is a clock value, not "use wall time"."""
    hb = Heartbeat(tmp_path, host_id=0)
    hb.path.write_text(json.dumps({"step": 1, "t": -10.0}))
    assert Heartbeat.dead_hosts(tmp_path, timeout_s=50.0, now=0.0) == []
    assert Heartbeat.dead_hosts(tmp_path, timeout_s=5.0, now=0.0) == [0]


def test_heartbeat_atomic_beat_and_unparsable_is_dead(tmp_path):
    hb = Heartbeat(tmp_path, host_id=0)
    hb.beat(step=7)
    payload = json.loads(hb.path.read_text())
    assert payload["step"] == 7
    assert Heartbeat.dead_hosts(tmp_path, timeout_s=60.0,
                                now=payload["t"]) == []
    hb.beat(step=8)
    assert json.loads(hb.path.read_text())["step"] == 8
    assert not list(Path(tmp_path).glob("*.tmp"))
    (tmp_path / "host_1.alive").write_text('{"step": 3, "t": 1')
    (tmp_path / "host_2.alive").write_text('{"nope": true}')
    assert Heartbeat.dead_hosts(tmp_path, timeout_s=60.0,
                                now=payload["t"]) == [1, 2]


def test_retry_step_backoff_and_permanent():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("link flap")
        return "ok"

    assert retry_step(flaky, max_retries=3, backoff_s=0.1, jitter="none",
                      sleep=sleeps.append) == "ok"
    assert sleeps == [0.1, 0.2]

    def always():
        raise TransientError("dead")

    assert retry_step(always, max_retries=2, backoff_s=0.0,
                      on_permanent=lambda e: "fallback",
                      sleep=lambda s: None) == "fallback"
    with pytest.raises(TransientError):
        retry_step(always, max_retries=1, backoff_s=0.0,
                   sleep=lambda s: None)

    def broken():
        raise KeyError("not transient")

    with pytest.raises(KeyError):         # only TransientError is retried
        retry_step(broken, max_retries=3, sleep=sleeps.append)


def test_retry_step_backoff_is_capped():
    sleeps = []

    def always():
        raise TransientError("dead")

    with pytest.raises(TransientError):
        retry_step(always, max_retries=8, backoff_s=1.0, max_backoff_s=3.0,
                   jitter="none", sleep=sleeps.append)
    assert sleeps == [1.0, 2.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]
    sleeps = []
    with pytest.raises(TransientError):
        retry_step(always, max_retries=20, backoff_s=0.5, max_backoff_s=2.0,
                   rng=random.Random(7), sleep=sleeps.append)
    assert len(sleeps) == 20 and all(s <= 2.0 for s in sleeps)


def test_retry_step_decorrelated_jitter():
    """Each delay is uniform on [base, 3 * previous]; two tenants with
    different rngs do not sleep in lockstep; one seed replays."""
    def always():
        raise TransientError("dead")

    def delays(seed):
        out = []
        with pytest.raises(TransientError):
            retry_step(always, max_retries=5, backoff_s=0.1,
                       max_backoff_s=10.0, rng=random.Random(seed),
                       sleep=out.append)
        return out

    a, b = delays(1), delays(2)
    assert len(a) == len(b) == 5 and a != b
    prev = 0.1
    for d in a:
        assert 0.1 <= d <= min(10.0, 3.0 * max(prev, 0.1) + 1e-12)
        prev = d
    assert delays(3) == delays(3)
    with pytest.raises(ValueError, match="jitter"):
        retry_step(always, max_retries=1, jitter="bogus",
                   sleep=lambda s: None)


def test_straggler_watchdog_flags_slow_step():
    flagged = []
    wd = StragglerWatchdog(threshold=2.0, warmup=3,
                           on_straggler=lambda s, dt, ema: flagged.append(s))
    for step in range(5):
        assert not wd.observe(step, 1.0)
    assert wd.observe(5, 10.0)
    assert flagged == [5]
    assert [s for s, _ in wd.flagged] == [5]
    assert wd.ewma == pytest.approx(1.0)  # the outlier is kept out


def test_new_modules_import_without_jax():
    code = ("import sys; sys.path.insert(0, 'src');"
            "import repro_torch.api.faults, repro_torch.checkpoint.checkpoint,"
            " repro_torch.runtime.fault_tolerance, repro_torch.core.cd;"
            "bad = [m for m in ('jax', 'jaxlib', 'repro') if m in sys.modules];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# crash-safe training (in-process)
# ---------------------------------------------------------------------------
def test_epoch_seed_is_a_fixed_mix():
    seeds = {epoch_seed(7, s, e) for s in range(3) for e in range(50)}
    assert len(seeds) == 150
    assert all(0 <= x < 2 ** 32 for x in seeds)
    assert epoch_seed(7, 1, 4) == epoch_seed(7, 1, 4)
    assert epoch_seed(7, 1, 4) != epoch_seed(7 + 2 ** 32, 1, 4)


@pytest.mark.parametrize("noise", ["counter", "lfsr", "philox"])
def test_resume_matches_uninterrupted(tmp_path, noise):
    """Resumed from the epoch-4 checkpoint, the run ends where the
    uninterrupted one does — philox too, its generator checkpointed by its
    state bytes."""
    task = _task()
    cfg = _quick_cfg()
    full = train_cd_resilient(_machine(noise=noise), task.visible_idx,
                              task.target_dist, cfg, 7,
                              ckpt_dir=tmp_path / "a", save_every=2,
                              eval_every=3)
    src, dst = tmp_path / "a", tmp_path / "b"
    shutil.copytree(src, dst)
    shutil.rmtree(dst / f"step_{cfg.epochs:09d}")
    assert ckpt.latest_step(dst) == 4
    res = train_cd_resilient(_machine(noise=noise), task.visible_idx,
                             task.target_dist, cfg, 7, ckpt_dir=dst,
                             save_every=2, eval_every=3)
    np.testing.assert_array_equal(res.J_edges, full.J_edges)
    np.testing.assert_array_equal(res.hm, full.hm)
    assert res.kl_history == full.kl_history
    assert res.metric_history == full.metric_history
    # the masked couplers never left zero
    assert full.J_edges[2] == 0.0 and full.J_edges[7] == 0.0
    assert np.abs(full.J_edges).sum() > 0


def test_transient_errors_inside_training_are_retried():
    task = _task()
    cfg = _quick_cfg(epochs=3)
    for noise in ("counter", "philox"):
        clean = train_cd_resilient(_machine(noise=noise), task.visible_idx,
                                   task.target_dist, cfg, 7,
                                   eval_every=cfg.epochs)
        fails = {"left": 2}

        def hiccup(epoch):
            if epoch == 1 and fails["left"]:
                fails["left"] -= 1
                raise TransientError("simulated preemption")

        noisy = train_cd_resilient(_machine(noise=noise), task.visible_idx,
                                   task.target_dist, cfg, 7,
                                   on_epoch_start=hiccup, backoff_s=0.0,
                                   sleep=lambda s: None,
                                   eval_every=cfg.epochs)
        assert fails["left"] == 0
        np.testing.assert_array_equal(noisy.J_edges, clean.J_edges)
        np.testing.assert_array_equal(noisy.hm, clean.hm)


def test_watchdog_observes_every_epoch():
    task = _task()
    cfg = _quick_cfg(epochs=3)
    seen = []
    wd = StragglerWatchdog(threshold=100.0, warmup=1)
    real = wd.observe
    wd.observe = lambda step, dt: seen.append(step) or real(step, dt)
    train_cd_resilient(_machine(), task.visible_idx, task.target_dist, cfg,
                       7, watchdog=wd, eval_every=cfg.epochs)
    assert seen == [0, 1, 2]
    assert wd.ewma is not None and wd.flagged == []


def test_resume_rejects_foreign_checkpoint(tmp_path):
    task = _task()
    cfg = _quick_cfg(epochs=2)
    train_cd_resilient(_machine(), task.visible_idx, task.target_dist, cfg,
                       7, ckpt_dir=tmp_path, save_every=1,
                       eval_every=cfg.epochs)
    with pytest.raises(ValueError, match="different run"):
        train_cd_resilient(_machine(noise="lfsr"), task.visible_idx,
                           task.target_dist, cfg, 7, ckpt_dir=tmp_path,
                           eval_every=cfg.epochs)
    with pytest.raises(ValueError, match="different run"):
        train_cd_resilient(_machine(faults=api.Faults(dead_edges=(3,))),
                           task.visible_idx, task.target_dist, cfg, 7,
                           ckpt_dir=tmp_path, eval_every=cfg.epochs)
    with pytest.raises(ValueError, match="different seed"):
        train_cd_resilient(_machine(), task.visible_idx, task.target_dist,
                           cfg, 8, ckpt_dir=tmp_path, eval_every=cfg.epochs)
    # resume=False starts over in the same directory
    fresh = train_cd_resilient(_machine(), task.visible_idx,
                               task.target_dist, cfg, 8, ckpt_dir=tmp_path,
                               resume=False, eval_every=cfg.epochs)
    assert len(fresh.metric_history) == cfg.epochs


def test_reference_train_state_carries_across():
    """The reference's `CDTrainState.tree` becomes the port's state, and
    the port's state checkpoints and restores to the same values."""
    g = make_chimera(1, 1)
    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(1),
                                    noise="counter")
    ses = ref.session(chains=8)
    st = ses.init_state(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    ref_state = ref_cd.CDTrainState(
        Jm=jax.numpy.asarray(rng.normal(size=g.n_edges), "float32"),
        hm=jax.numpy.zeros((g.n_nodes,)), m=st.m,
        noise_state=st.noise_state,
        vel_J=jax.numpy.ones((g.n_edges,)),
        vel_h=jax.numpy.zeros((g.n_nodes,)), epoch=4)
    tree = {k: np.asarray(v) for k, v in
            ref_state.tree(jax.random.PRNGKey(0)).items()}
    port = convert.cd_state_from_numpy(tree, epoch=4, device="cpu")
    assert port.epoch == 4
    np.testing.assert_array_equal(port.Jm.numpy(), tree["Jm"])
    np.testing.assert_array_equal(port.m.numpy(), tree["m"])
    np.testing.assert_array_equal(
        convert.noise_state_to_numpy(port.noise_state), tree["noise_state"])
    assert port.noise_state.dtype == torch.int32


# ---------------------------------------------------------------------------
# kill-and-resume (subprocess)
# ---------------------------------------------------------------------------
_TRAIN_SCRIPT = """
    import json, os, sys
    sys.path.insert(0, "src")
    from repro_torch import api
    from repro_torch.core import tasks
    from repro_torch.core.cd import CDConfig, PBitMachine, train_cd_resilient
    from repro_torch.core.chimera import make_chimera

    ckpt_dir = sys.argv[1]
    kill_at = int(sys.argv[2])      # -1: run to completion

    g = make_chimera(1, 1)
    task = tasks.and_gate_task(g)
    faults = api.Faults(stuck_nodes=(5,), stuck_values=(-1,),
                        dead_edges=(2,), saturated_edges=(7,))
    machine = PBitMachine.create(g, 42, noise="counter", faults=faults,
                                 device="cpu")
    cfg = CDConfig(epochs=10, chains=32, cd_k=3, pos_sweeps=3, burn_in=1)

    def maybe_kill(epoch):
        if kill_at >= 0 and epoch == kill_at:
            os._exit(3)             # hard kill: no cleanup, no final save

    res = train_cd_resilient(machine, task.visible_idx, task.target_dist,
                             cfg, 7, ckpt_dir=ckpt_dir, save_every=3,
                             eval_every=cfg.epochs, on_epoch_start=maybe_kill)
    print(json.dumps({"J": res.J_edges.tolist(), "h": res.hm.tolist(),
                      "kl": res.kl_history[-1][1]}))
"""


def _run_train(ckpt_dir, kill_at, timeout=300):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_TRAIN_SCRIPT),
         str(ckpt_dir), str(kill_at)],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_kill_and_resume_bit_identical(tmp_path):
    """Kill training at epoch 7 (after the epoch-6 checkpoint), resume,
    and require master weights bit-identical to the uninterrupted run."""
    clean = _run_train(tmp_path / "clean", kill_at=-1)
    assert clean.returncode == 0, clean.stderr[-3000:]
    ref = json.loads(clean.stdout.strip().splitlines()[-1])

    killed = _run_train(tmp_path / "crash", kill_at=7)
    assert killed.returncode == 3          # died mid-run, as instructed
    assert ckpt.latest_step(tmp_path / "crash") == 6

    resumed = _run_train(tmp_path / "crash", kill_at=-1)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    got = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert got == ref
    assert ref["J"][2] == 0.0 and ref["J"][7] == 0.0


# ---------------------------------------------------------------------------
# faults through the row-band engine
# ---------------------------------------------------------------------------
SHARD_FAULTS = dict(stuck_nodes=(3, 17), stuck_values=(1, -1),
                    dead_edges=(5,), flip_prob=0.15, flip_seed=9)
LFSR_FAULTS = dict(stuck_nodes=(3, 17), stuck_values=(1, -1),
                   dead_edges=(5,), lfsr_stuck=((0, 0b1010, 0b0101),
                                                (2, 0xF0, 0x0F00)))


def _banded(noise, faults, n_row, sync=None):
    g = make_chimera(2, 2)
    mach = PBitMachine.create(g, 0, noise=noise, backend="sparse",
                              device="cpu", faults=api.Faults(**faults))
    kw = {}
    if n_row > 1:
        kw = dict(mesh=dist.make_mesh((n_row,), ("data",)),
                  partition=api.Partition(rows="data"), sync=sync)
    return g, api.Session(mach.sampler_spec(chains=8, **kw))


@pytest.mark.parametrize("noise,faults", [("counter", SHARD_FAULTS),
                                          ("lfsr", LFSR_FAULTS)])
def test_two_bands_equal_one_band_under_faults(noise, faults):
    g, one = _banded(noise, faults, 1)
    _, two = _banded(noise, faults, 2)
    assert two._engine is not None and two.backend == "sparse"
    rng = np.random.default_rng(1)
    chip = one.program_edges(rng.integers(-50, 50, g.n_edges),
                             rng.integers(-10, 10, g.n_nodes))
    st = one.init_state(one.generator(2))
    betas = torch.linspace(0.3, 1.5, 6)
    a = one.sample(chip, st.m, st.noise_state, betas, collect=True)
    b = two.sample(chip, st.m, st.noise_state, betas, collect=True)
    assert torch.equal(a[2], b[2]) and torch.equal(a[0], b[0])
    assert torch.equal(a[1], b[1])
    assert (b[2][:, :, 3] == 1.0).all() and (b[2][:, :, 17] == -1.0).all()
    sa = one.stats(chip, st.m, st.noise_state, 6, 1)
    sb = two.stats(chip, st.m, st.noise_state, 6, 1)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    vis = np.array([0, 3, 20])
    ha = one.visible_hist(chip, st.m, st.noise_state, vis, 1, betas)
    hb = two.visible_hist(chip, st.m, st.noise_state, vis, 1, betas)
    assert torch.equal(ha[0], hb[0])
    if noise == "counter":      # the flips act
        _, healthy = _banded(noise, dict(SHARD_FAULTS, flip_prob=0.0), 2)
        c = healthy.sample(chip, st.m, st.noise_state, betas)
        assert not torch.equal(c[0], b[0])


def test_fused_sharded_spec_with_flips_takes_the_scan():
    g = make_chimera(2, 2)
    mach = PBitMachine.create(g, 0, noise="counter", device="cpu",
                              faults=api.Faults(**SHARD_FAULTS))
    spec = mach.sampler_spec(
        chains=8, mesh=dist.make_mesh((2,), ("data",)),
        sync=api.Sync(halo_every=2, sweeps_per_launch=2))
    assert api.resolve_backend(spec) == "sparse"
    with pytest.raises(ValueError, match="fault hooks"):
        api.resolve_backend(spec.replace(backend="fused_sparse"))
    with pytest.raises(ValueError, match="fault hooks"):
        dist.ShardedEngine(g, dist.make_mesh((2,), ("data",)),
                           api.Partition(), "counter", 8, 8,
                           backend="fused_sparse", device="cpu",
                           faults=api.Faults(**SHARD_FAULTS))
    # stuck spins and dead couplers alone keep the fused per-band kernels
    stuck = spec.replace(faults=api.Faults(stuck_nodes=(3,),
                                           stuck_values=(1,),
                                           dead_edges=(5,)))
    assert api.resolve_backend(stuck) == "fused_sparse"


_SHARDED_REFERENCE = """
    import jax.numpy as jnp
    from repro import api
    from repro.core.cd import PBitMachine
    from repro.core.chimera import make_chimera
    from repro.core.hardware import HardwareConfig

    g = make_chimera(2, 2)
    B, S = 8, 6
    rng = np.random.default_rng(1)
    codes = jnp.asarray(rng.integers(-50, 50, g.n_edges), jnp.int32)
    h = jnp.asarray(rng.integers(-10, 10, g.n_nodes), jnp.int32)
    betas = jnp.linspace(0.3, 1.5, S)
    for name, noise, fields in (("counter", "counter", {counter}),
                                ("lfsr", "lfsr", {lfsr})):
        mach = PBitMachine.create(g, jax.random.PRNGKey(0),
                                  HardwareConfig(), noise=noise,
                                  backend="sparse",
                                  faults=api.Faults(**fields))
        ses = api.Session(mach.sampler_spec(
            chains=B, mesh=auto_mesh((2,), ("data",)),
            partition=api.Partition(rows="data")))
        chip = ses.program_edges(codes, h)
        m0 = ses.random_spins(jax.random.PRNGKey(2))
        ns = ses.noise_state(jax.random.PRNGKey(3))
        m, ns1, traj = ses.sample(chip, m0, ns, betas, collect=True)
        save(name + "/mismatch", *jax.tree_util.tree_leaves(mach.mismatch))
        save(name + "/chip", *jax.tree_util.tree_leaves(chip))
        save(name + "/inputs", m0, ns, betas, codes, h)
        save(name + "/out", m, ns1, traj)
"""


def test_two_bands_equal_the_reference_engine(tmp_path):
    """The port's 2-band engine and the reference's on two forced host
    devices, the same faulted chip: stuck spins, a dead coupler and
    counter flips (or stuck LFSR bits) — equal spins, noise states and
    trajectories, bit for bit."""
    got = run_forced_reference(
        _SHARDED_REFERENCE.replace("{counter}", repr(SHARD_FAULTS))
        .replace("{lfsr}", repr(LFSR_FAULTS)), 2, tmp_path)
    g = make_chimera(2, 2)
    for name, noise, fields in (("counter", "counter", SHARD_FAULTS),
                                ("lfsr", "lfsr", LFSR_FAULTS)):
        m0, ns0, betas, codes, h = got[name + "/inputs"]
        mach = PBitMachine(
            graph=g, hw=HardwareConfig(),
            mismatch=convert.mismatch_from_numpy(got[name + "/mismatch"],
                                                 "cpu"),
            noise=noise, backend="sparse", device="cpu",
            faults=api.Faults(**fields))
        ses = api.Session(mach.sampler_spec(
            chains=8, mesh=dist.make_mesh((2,), ("data",)),
            partition=api.Partition(rows="data")))
        ref_chip = convert.chip_from_numpy(got[name + "/chip"], "cpu")
        chip = ses.program_edges(codes, h)
        for field in ("W", "nbr_w", "h"):
            np.testing.assert_allclose(getattr(chip, field).numpy(),
                                       getattr(ref_chip, field).numpy(),
                                       rtol=1e-6, atol=1e-7)
        m, ns, traj = ses.sample(
            ref_chip, convert.spins_from_numpy(m0, "cpu"),
            convert.noise_state_from_numpy(ns0, "cpu"),
            torch.as_tensor(betas), collect=True)
        want_m, want_ns, want_traj = got[name + "/out"]
        np.testing.assert_array_equal(traj.numpy(), want_traj)
        np.testing.assert_array_equal(m.numpy(), want_m)
        np.testing.assert_array_equal(convert.noise_state_to_numpy(ns),
                                      want_ns)
        assert (traj[:, :, 3] == 1.0).all() and (traj[:, :, 17] == -1.0).all()
