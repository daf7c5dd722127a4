"""Port parity: the T1 env's ``step`` against the JAX env's, from one state.

The JAX env (16 envs, 2x2 terrain) makes the initial state; ``state_from_numpy``
carries it into the port; both packages then step 3 times with the same
seeded actions.  Obs noise, torque noise, pushes and external forces are off
(tests/test_megakernel.py:13-29 turns off the same draws), so the random
streams, which differ between the packages, touch nothing that is compared.
The port runs both of its decimation paths on the CPU: the per-substep loop
and the kernel path's pack/unpack around ``run_decimation_plain``.

The JAX side runs with ``jax.disable_jit()``: compiling its step on the CPU
takes minutes, running it op by op seconds.  Tolerances are the reference's
(tests/test_megakernel.py:52-67,168-175): state atol 2e-4, contact forces
atol 2 N + rtol 2e-3, action ring 1e-6, rewards atol 1e-4, episode sums
1e-3, obs atol 1e-2 (bf16).
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
from ti5_isaacgym_tpu_torch.envs.convert import state_from_numpy
from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv as TEnv

N, STEPS = 16, 3


def _cfg(cls, **sim):
    cfg = cls()
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, num_envs=N),
        sim=dataclasses.replace(cfg.sim, **sim),
        noise=dataclasses.replace(cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(cfg.domain_rand, randomize_torque=False,
                                        push_robots=False, add_ext_force=False),
        terrain=dataclasses.replace(cfg.terrain, num_rows=2, num_cols=2, border_size=2.0))


def _actions():
    rng = np.random.default_rng(0)
    return [rng.uniform(-1, 1, size=(N, 12)).astype(np.float32) for _ in range(STEPS)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    with jax.disable_jit():
        env = JEnv(_cfg(JCfg), seed=0)
        s = env.init_state(jax.random.PRNGKey(3))
        s0, out = _np(s), []
        for a in _actions():
            s, obs, priv, rew, done, _ = env.step(s, jnp.asarray(a))
            out.append((_np(s), np.asarray(obs, np.float32), np.asarray(priv, np.float32),
                        np.asarray(rew), np.asarray(done)))
    return env, s0, out


def _close(got, want, name, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("path", ["loop", "kernel_plain"])
def test_env_step_matches_jax(jax_run, path):
    jenv, s0, out = jax_run
    env = TEnv(_cfg(TCfg, megakernel_interpret=(path == "kernel_plain")), seed=0, device="cpu")
    assert env.use_kernel_path == (path == "kernel_plain")
    np.testing.assert_array_equal(env.heightfield.height.numpy(), np.asarray(jenv.heightfield.height))
    np.testing.assert_allclose(env.cp_meff, np.asarray(jenv.cp_meff), rtol=1e-3)
    assert env.reward_names == jenv.reward_names
    s = state_from_numpy(s0, seed=1, device="cpu")
    for i, (a, (js, jobs, jpriv, jrew, jdone)) in enumerate(zip(_actions(), out)):
        s, obs, priv, rew, done, _ = env.step(s, torch.from_numpy(a))
        assert not bool(done.any()) and not jdone.any()
        for k in ("base_pos", "base_quat", "base_vel", "qpos", "qvel", "cp_anchor"):
            _close(getattr(s.phys, k), getattr(js.phys, k), f"step {i} {k}", 2e-4)
        _close(s.contact_forces, js.contact_forces, f"step {i} contact forces", 2.0, 2e-3)
        _close(s.torques, js.torques, f"step {i} torques", 5e-2)
        _close(s.lag_buffer, js.lag_buffer, f"step {i} lag ring", 1e-6)
        _close(s.dof_lag_buffer, js.dof_lag_buffer, f"step {i} dof ring", 2e-4)
        _close(s.imu_lag_buffer, js.imu_lag_buffer, f"step {i} imu ring", 2e-4)
        _close(rew, jrew, f"step {i} rewards", 1e-4)
        _close(s.episode_sums, js.episode_sums, f"step {i} episode sums", 1e-3)
        _close(obs, jobs, f"step {i} obs", 1e-2)
        _close(priv, jpriv, f"step {i} privileged obs", 1e-2)
        for k in ("commands", "feet_air_time", "feet_height", "last_feet_z", "ref_dof_pos",
                  "last_root_vel"):
            _close(getattr(s, k), getattr(js, k), f"step {i} {k}", 2e-4)
        np.testing.assert_array_equal(s.episode_length.numpy(), js.episode_length)
        np.testing.assert_array_equal(s.last_contacts.numpy(), js.last_contacts)
