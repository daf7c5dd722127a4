"""Events parity: the T1 env's ``step`` against the JAX env's with pushes and
external forces on, at the escalation schedules' last stage.

Both envs start from one JAX state whose common step is 1,704,001, the
committed walking lineage's (``checkpoints_torch/t1_dh_stand/...
/model_71000.pt``): pushes of 0.3 s every 6 s and external forces of 0.15 s
every 4 s, both inside their window from the first step.  Half the envs
are given a stand command, since the external force is applied to standing
envs only (from the window's second step).  The random streams
differ between the packages (threefry against Philox), so the JAX env's
event draws are recorded (``jax.random.uniform`` inside its ``_events``) and
fed to the port's ``_events`` in the same order (``legged.uniform``); obs
noise and torque noise are off, as in ``tests/test_torch_env.py``.  The
port runs both of its decimation paths on the CPU.

Tolerances are the reference's (tests/test_megakernel.py:52-67,168-175):
state atol 2e-4, contact forces atol 2 N + rtol 2e-3, rewards atol 1e-4,
episode sums 1e-3, obs atol 1e-2 (bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg as JCfg
from ti5_isaacgym_tpu.envs.t1_dh_stand import T1DHStandEnv as JEnv
from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg as TCfg
from ti5_isaacgym_tpu_torch.envs import legged
from ti5_isaacgym_tpu_torch.envs.convert import state_from_numpy
from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv as TEnv

N, STEPS = 16, 3
COMMON_STEP = 1704001      # the committed lineage's (model_71000)
EVENT_FIELDS = ("push_force", "push_torque", "ext_force", "ext_torque", "ext_force_apply",
                "ext_torque_apply")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread, here and in the processes a test starts: the ops
    are small, and the workers of a parallel test run share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _cfg(cls, **sim):
    cfg = cls()
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, num_envs=N),
        sim=dataclasses.replace(cfg.sim, **sim),
        noise=dataclasses.replace(cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(cfg.domain_rand, randomize_torque=False,
                                        push_robots=True, add_ext_force=True),
        terrain=dataclasses.replace(cfg.terrain, num_rows=2, num_cols=2, border_size=2.0))


def _actions():
    rng = np.random.default_rng(1)
    return [rng.uniform(-1, 1, size=(N, 12)).astype(np.float32) for _ in range(STEPS)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX env's 3 steps from common step 1,704,001, and every draw its
    ``_events`` made, in order."""
    draws = []
    real = jax.random.uniform

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        draws.append(np.asarray(out))
        return out

    with jax.disable_jit():
        env = JEnv(_cfg(JCfg), seed=0)
        inner = env._events

        def events(state, key):
            jax.random.uniform = recorded
            try:
                return inner(state, key)
            finally:
                jax.random.uniform = real

        env._events = events
        s = env.init_state(jax.random.PRNGKey(5))
        # half the envs stand: the external force is applied to standing envs only
        s = s.replace(common_step=jnp.asarray(COMMON_STEP, s.common_step.dtype),
                      commands=s.commands.at[:N // 2, :3].set(0.0))
        s0, out = _np(s), []
        for a in _actions():
            s, obs, priv, rew, done, _ = env.step(s, jnp.asarray(a))
            out.append((_np(s), np.asarray(obs, np.float32), np.asarray(priv, np.float32),
                        np.asarray(rew), np.asarray(done)))
    return s0, draws, out


def _close(got, want, name, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=name)


def _fed_events(env, draws):
    """``env._events`` with its uniform draws taken from ``draws`` in order."""
    inner = env._events

    def fed(gen, shape, lo, hi):
        d = draws.pop(0)
        assert d.shape == tuple(shape), (d.shape, shape)
        return torch.from_numpy(d.copy())

    def events(state):
        real = legged.uniform
        legged.uniform = fed
        try:
            return inner(state)
        finally:
            legged.uniform = real

    return events


@pytest.mark.parametrize("path", ["loop", "kernel_plain"])
def test_events_match_jax(jax_run, path):
    s0, draws, out = jax_run
    assert len(draws) == 6 * STEPS            # push xy, push ang, fx, fy, fz, torque
    env = TEnv(_cfg(TCfg, megakernel_interpret=(path == "kernel_plain")), seed=0, device="cpu")
    assert env.use_kernel_path == (path == "kernel_plain")
    queue = list(draws)
    env._events = _fed_events(env, queue)
    s = state_from_numpy(s0, seed=1, device="cpu")
    assert int(s.common_step) == COMMON_STEP
    pushed = applied = 0
    for i, (a, (js, jobs, jpriv, jrew, jdone)) in enumerate(zip(_actions(), out)):
        s, obs, priv, rew, done, _ = env.step(s, torch.from_numpy(a))
        assert not bool(done.any()) and not jdone.any()
        for k in EVENT_FIELDS:
            _close(getattr(s, k), getattr(js, k), f"step {i} {k}", 1e-6)
        for k in ("is_first_push", "is_first_add_force"):
            assert bool(getattr(s, k)) == bool(getattr(js, k)), (i, k)
        pushed += int((s.push_force != 0).any(-1).sum())
        applied += int((s.ext_force_apply != 0).any(-1).sum())
        for k in ("base_pos", "base_quat", "base_vel", "qpos", "qvel", "cp_anchor"):
            _close(getattr(s.phys, k), getattr(js.phys, k), f"step {i} {k}", 2e-4)
        _close(s.contact_forces, js.contact_forces, f"step {i} contact forces", 2.0, 2e-3)
        _close(s.lag_buffer, js.lag_buffer, f"step {i} lag ring", 1e-6)
        _close(s.dof_lag_buffer, js.dof_lag_buffer, f"step {i} dof ring", 2e-4)
        _close(s.imu_lag_buffer, js.imu_lag_buffer, f"step {i} imu ring", 2e-4)
        _close(rew, jrew, f"step {i} rewards", 1e-4)
        _close(s.episode_sums, js.episode_sums, f"step {i} episode sums", 1e-3)
        _close(obs, jobs, f"step {i} obs", 1e-2)
        _close(priv, jpriv, f"step {i} privileged obs", 1e-2)
        for k in ("commands", "feet_air_time", "feet_height", "last_feet_z", "last_root_vel"):
            _close(getattr(s, k), getattr(js, k), f"step {i} {k}", 2e-4)
        assert int(s.common_step) == int(js.common_step) == COMMON_STEP + i + 1
    assert not queue
    assert pushed == N * STEPS, pushed           # every env pushed at every step
    assert applied == N // 2 * (STEPS - 1), applied   # the standing half, from step 2
