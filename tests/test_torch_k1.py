"""The second robot (K1) through the port, against the JAX package.

``k1_model.json`` is the JAX package's byte for byte; the K1 env's ``step``
equals JAX's from one state for 3 steps in both of the port's decimation
paths (the per-substep loop and the kernel path's plain version), with the
tolerances of tests/test_torch_env.py (state atol 2e-4, contact forces atol
2 N + rtol 2e-3, rewards 1e-4, obs 1e-2); and K1 stands under the PD law at
its default pose, as tests/test_k1.py:33-70 requires of the JAX engine.

As in tests/test_torch_env.py, the JAX side runs with ``jax.disable_jit()``
and the draws that differ between threefry and Philox (obs noise, torque
noise, pushes, external forces) are off.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.envs.t1_dh_stand import T1DHStandEnv as JEnv
from ti5_isaacgym_tpu.utils.registry import task_registry as jregistry
from ti5_isaacgym_tpu_torch.envs.convert import state_from_numpy
from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv as TEnv
from ti5_isaacgym_tpu_torch.physics import model as tmodel
from ti5_isaacgym_tpu_torch.utils.registry import task_registry

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N, STEPS = 16, 3


def test_k1_model_spec_is_the_jax_packages():
    with open(os.path.join(ROOT, "ti5_isaacgym_tpu", "resources", "k1_model.json"), "rb") as f:
        want = f.read()
    with open(os.path.join(tmodel.RESOURCES, "k1_model.json"), "rb") as f:
        assert f.read() == want
    k1 = tmodel.load(os.path.join(tmodel.RESOURCES, "k1_model.json"))
    assert k1.nb == 13 and k1.num_dof == 12 and k1.ncp == 16
    assert k1.dof_names[0] == "leg_l1_joint"


def _cfg(base, **sim):
    return dataclasses.replace(
        base,
        env=dataclasses.replace(base.env, num_envs=N),
        sim=dataclasses.replace(base.sim, **sim),
        noise=dataclasses.replace(base.noise, add_noise=False),
        domain_rand=dataclasses.replace(base.domain_rand, randomize_torque=False,
                                        push_robots=False, add_ext_force=False),
        terrain=dataclasses.replace(base.terrain, num_rows=2, num_cols=2, border_size=2.0))


def _actions():
    rng = np.random.default_rng(1)
    return [rng.uniform(-1, 1, size=(N, 12)).astype(np.float32) for _ in range(STEPS)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    with jax.disable_jit():
        env = JEnv(_cfg(jregistry.get_cfgs("k1_dh_stand")[0]), seed=0)
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
def test_k1_env_step_matches_jax(jax_run, path):
    jenv, s0, out = jax_run
    cfg = _cfg(task_registry.get_cfgs("k1_dh_stand")[0],
               megakernel_interpret=(path == "kernel_plain"))
    env = TEnv(cfg, seed=0, device="cpu")
    assert env.model.ncp == 16 and env.use_kernel_path == (path == "kernel_plain")
    np.testing.assert_array_equal(env.heightfield.height.numpy(),
                                  np.asarray(jenv.heightfield.height))
    np.testing.assert_allclose(env.cp_meff, np.asarray(jenv.cp_meff), rtol=1e-3)
    assert env.reward_names == jenv.reward_names
    assert env.supertable.M == jenv.supertable.M and env.supertable.PG == jenv.supertable.PG
    s = state_from_numpy(s0, seed=1, device="cpu")
    for i, (a, (js, jobs, jpriv, jrew, jdone)) in enumerate(zip(_actions(), out)):
        s, obs, priv, rew, done, _ = env.step(s, torch.from_numpy(a))
        np.testing.assert_array_equal(done.numpy(), jdone)
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
        for k in ("commands", "feet_air_time", "feet_height", "last_feet_z", "ref_dof_pos"):
            _close(getattr(s, k), getattr(js, k), f"step {i} {k}", 2e-4)
        np.testing.assert_array_equal(s.episode_length.numpy(), js.episode_length)
        np.testing.assert_array_equal(s.last_contacts.numpy(), js.last_contacts)


def test_k1_stands_under_pd():
    """As tests/test_k1.py:33-70: 4 envs on a plane, zero actions (the PD law
    at the default pose) for 50 policy steps: finite observations and
    rewards, and every base near K1's standing height (~1.05 m), never
    T1's 0.95."""
    env_cfg, _ = task_registry.get_cfgs("k1_dh_stand")
    env_cfg = dataclasses.replace(
        env_cfg,
        env=dataclasses.replace(env_cfg.env, num_envs=4),
        terrain=dataclasses.replace(env_cfg.terrain, mesh_type="plane"),
        noise=dataclasses.replace(env_cfg.noise, add_noise=False),
        domain_rand=dataclasses.replace(
            env_cfg.domain_rand, push_robots=False, add_ext_force=False,
            randomize_base_mass=False, randomize_com=False, randomize_link_mass=False,
            randomize_gains=False, randomize_torque=False, randomize_motor_offset=False,
            randomize_coulomb_friction=False))
    env = TEnv(env_cfg, seed=0, device="cpu")
    s, obs, _ = env.reset(env.init_state(0))
    with torch.no_grad():
        for _ in range(50):
            s, obs, _, rew, _, _ = env.step(s, torch.zeros(4, env.num_actions))
            assert bool(torch.isfinite(obs.float()).all()) and bool(torch.isfinite(rew).all())
    final_z = s.phys.base_pos[:, 2].numpy()
    assert (final_z > 0.95).all() and (final_z < 1.15).all(), final_z
