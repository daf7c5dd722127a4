"""Port parity of the masked reset and both curricula, on forced resets.

From one JAX state (16 envs, 2x2 terrain, carried into the port with
``state_from_numpy``) three envs time out (``episode_length`` at the limit)
and two have fallen (lying on their backs, the base link on the ground);
the shared step counter sits on the command curriculum's trigger, the done
envs' tracking sums are high enough to widen the command range, and the
done envs' positions and levels make the terrain curriculum move one env up,
two down, keep one and send one past the last row (a random level).  One
``step`` of each package, then the deterministic fields are compared: which
envs reset, ``time_outs``, the episode sums zeroed and ``episode_sums_done``
/ ``walked_distance_sum``, terrain levels and origins, the command range and
the zeroed histories and state.  The reset's random draws (joint positions,
root jitter, gains, lags, the random level) are held to their ranges.

Draws that differ between the packages are off, as in tests/test_torch_env.py
(obs noise, torque noise, pushes, external forces).  Tolerances: episode
sums and ``episode_sums_done`` atol 1e-3 (as the env test), walked distance
atol 1e-3 (positions agree within 2e-4 per env); everything else exact.
The curriculum functions are also held against JAX's directly, on seeded
inputs where no random level is drawn.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg as JCfg
from ti5_isaacgym_tpu.envs import legged as jlegged
from ti5_isaacgym_tpu.envs.t1_dh_stand import T1DHStandEnv as JEnv
from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg as TCfg
from ti5_isaacgym_tpu_torch.envs import legged as tlegged
from ti5_isaacgym_tpu_torch.envs.convert import state_from_numpy
from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv as TEnv

N = 16
TIMEOUT, FALLEN = [0, 1, 2], [3, 4]
DONE = TIMEOUT + FALLEN
RANDOM_LEVEL = 2          # moves up from the last row: a random level


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


def _forced(s, env):
    """The JAX initial state (numpy leaves) with the forced resets."""
    el = s.episode_length.copy()
    el[TIMEOUT] = env.max_episode_length
    level = s.terrain_level.copy()
    level[DONE] = [0, 1, 1, 0, 1]
    origin = np.asarray(env.terrain_origins)[np.minimum(level, 1), s.terrain_type]
    bp, q = s.phys.base_pos.copy(), s.phys.base_quat.copy()
    bp[:, :2] = origin[:, :2]
    bp[[0, 2], 0] += 4.5                      # walked beyond half a terrain: up
    # fallen: on the back (90 degrees about y), the base link on the ground
    bp[FALLEN, 2] = origin[FALLEN, 2] + 0.1
    q[FALLEN] = [np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0]
    cmds = s.commands.copy()
    cmds[[1, 3], :2] = [0.5, 0.0]             # at the origin with a command: down
    cmds[4, :3] = 0.0                         # standing at the origin: stays
    sums = np.random.default_rng(0).uniform(0.0, 1.0, size=s.episode_sums.shape)
    t_idx = env.reward_names.index("tracking_lin_vel")
    sums[:, t_idx] = env.max_episode_length * env.reward_scales_dt["tracking_lin_vel"]
    return s.replace(
        phys=s.phys.replace(base_pos=bp, base_quat=q), episode_length=el, terrain_level=level,
        env_origin=origin.astype(np.float32), commands=cmds,
        episode_sums=sums.astype(np.float32),
        common_step=np.asarray(env.max_episode_length - 1, np.int32))


@pytest.fixture(scope="module")
def jax_reset():
    with jax.disable_jit():
        env = JEnv(_cfg(JCfg), seed=0)
        s0 = _forced(jax.tree.map(np.asarray, env.init_state(jax.random.PRNGKey(3))), env)
        s1, _, _, _, done, extras = env.step(jax.tree.map(jnp.asarray, s0), jnp.zeros((N, 12)))
    return env, s0, jax.tree.map(np.asarray, s1), np.asarray(done), jax.tree.map(
        np.asarray, extras)


@pytest.mark.parametrize("path", ["loop", "kernel_plain"])
def test_forced_resets_match_jax(jax_reset, path):
    jenv, s0, js, jdone, jex = jax_reset
    env = TEnv(_cfg(TCfg, megakernel_interpret=(path == "kernel_plain")), seed=0, device="cpu")
    assert env.use_kernel_path == (path == "kernel_plain")
    s, _, _, _, done, ex = env.step(state_from_numpy(s0, seed=1, device="cpu"), torch.zeros(N, 12))
    ex = {k: v.numpy() for k, v in ex.items()}
    done = done.numpy()
    np.testing.assert_array_equal(done, jdone)
    assert np.flatnonzero(done).tolist() == DONE
    np.testing.assert_array_equal(ex["time_outs"], jex["time_outs"])
    assert np.flatnonzero(ex["time_outs"]).tolist() == TIMEOUT
    assert int(ex["done_count"]) == int(jex["done_count"]) == len(DONE)
    assert int(ex["episode_length_sum"]) == int(jex["episode_length_sum"])
    np.testing.assert_allclose(ex["episode_sums_done"], jex["episode_sums_done"], atol=1e-3)
    np.testing.assert_allclose(ex["walked_distance_sum"], jex["walked_distance_sum"], atol=1e-3)
    assert float(ex["walked_distance_sum"]) > 2 * 4.5
    assert float(ex["max_command_x"]) == float(jex["max_command_x"])

    keep = ~done
    sums = s.episode_sums.numpy()
    assert not sums[done].any() and not js.episode_sums[done].any()
    np.testing.assert_allclose(sums[keep], js.episode_sums[keep], atol=1e-3)

    # curricula: the command range widened; levels and origins
    np.testing.assert_array_equal(s.cmd_vx_range.numpy(), js.cmd_vx_range)
    np.testing.assert_allclose(js.cmd_vx_range, [-0.75, 1.0])
    level, jlevel = s.terrain_level.numpy(), js.terrain_level
    fixed = np.arange(N) != RANDOM_LEVEL
    np.testing.assert_array_equal(level[fixed], jlevel[fixed])
    np.testing.assert_array_equal(level[DONE][:2], [1, 0])
    assert 0 <= level[RANDOM_LEVEL] < 2 and 0 <= jlevel[RANDOM_LEVEL] < 2
    np.testing.assert_array_equal(s.env_origin.numpy()[fixed], js.env_origin[fixed])

    # zeroed at the reset (and not refilled in the same step)
    for name in ("lag_buffer", "dof_lag_buffer", "imu_lag_buffer", "actions", "last_actions",
                 "last_last_actions", "last_dof_vel", "last_root_vel", "feet_air_time",
                 "episode_length", "phase_length"):
        got, want = getattr(s, name).numpy()[done], getattr(js, name)[done]
        assert not got.any() and not want.any(), name
    for name in ("base_vel", "qvel", "cp_anchor"):
        assert not getattr(s.phys, name).numpy()[done].any(), name
    np.testing.assert_array_equal(s.phys.base_quat.numpy()[done], js.phys.base_quat[done])
    # the histories hold only the frame written after the reset
    k_o, k_p = env.cfg.env.num_single_obs, env.priv_frame_dim
    for got, want, k in ((s.obs_hist, js.obs_hist, k_o), (s.critic_hist, js.critic_hist, k_p)):
        assert not got.float().numpy()[done, :-k].any()
        assert not np.asarray(want, np.float32)[done, :-k].any()
        assert got.float().numpy()[done, -k:].any()

    # the reset's random draws, within their ranges
    cfg, dr = env.cfg, env.cfg.domain_rand
    q0 = env.default_dof_pos.numpy()
    assert np.all(np.abs(s.phys.qpos.numpy()[done] - q0) <= 0.1 + 1e-6)
    origin = s.env_origin.numpy()[done]
    base = s.phys.base_pos.numpy()[done]
    assert np.all(np.abs(base[:, :2] - origin[:, :2]) <= cfg.terrain.platform / 3.0 + 1e-5)
    np.testing.assert_allclose(base[:, 2], origin[:, 2] + cfg.init_state.pos[2], atol=1e-6)
    assert set(s.gait_start.numpy()[done].tolist()) <= {0.0, 0.5}
    p_mult = s.params.p_gains.numpy()[done] / env.p_gains_nom.numpy()
    lo, hi = dr.stiffness_multiplier_range
    assert np.all((p_mult >= lo - 1e-6) & (p_mult <= hi + 1e-6))
    lag = s.params.lag_steps.numpy()[done]
    assert np.all((lag >= dr.lag_timesteps_range[0]) & (lag <= dr.lag_timesteps_range[1]))
    # envs that did not reset keep their gait schedule
    np.testing.assert_array_equal(s.gait_time.numpy()[keep], js.gait_time[keep])


def test_terrain_curriculum_matches_jax():
    """Levels and origins of ``terrain_curriculum_update`` on 64 seeded
    envs, none of which passes the last row (no random level): exact."""
    rng = np.random.default_rng(2)
    n, rows, cols = 64, 20, 20
    origins = rng.uniform(0.0, 160.0, size=(rows, cols, 3)).astype(np.float32)
    level = rng.integers(0, rows - 1, size=n).astype(np.int32)
    ttype = rng.integers(0, cols, size=n).astype(np.int32)
    origin = origins[level, ttype]
    xy = (origin[:, :2] + rng.uniform(-6.0, 6.0, size=(n, 2))).astype(np.float32)
    cmds = rng.uniform(-1.0, 1.0, size=(n, 4)).astype(np.float32)
    cmds[::4, :2] = 0.0
    done = rng.uniform(size=n) < 0.6
    jl, jo = jlegged.terrain_curriculum_update(
        JCfg(), jax.random.PRNGKey(0), jnp.asarray(done), jnp.asarray(xy), jnp.asarray(origin),
        jnp.asarray(cmds), jnp.asarray(level), jnp.asarray(ttype), jnp.asarray(origins))
    gen = torch.Generator()
    gen.manual_seed(0)
    tl, to = tlegged.terrain_curriculum_update(
        TCfg(), gen, torch.from_numpy(done), torch.from_numpy(xy), torch.from_numpy(origin),
        torch.from_numpy(cmds), torch.from_numpy(level), torch.from_numpy(ttype),
        torch.from_numpy(origins))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    moved = tl.numpy() != level
    assert (tl.numpy() > level).any() and (tl.numpy() < level).any() and not moved[~done].any()


@pytest.mark.parametrize("step,scale,n_done", [(2400, 1.0, 3), (2400, 0.5, 3), (2399, 1.0, 3),
                                               (2400, 1.0, 0)])
def test_command_curriculum_matches_jax(step, scale, n_done):
    """``command_curriculum_update`` against JAX's: at and off the trigger
    step, with the tracking sums above and below 80% of their maximum, and
    with no done env: exact."""
    max_len, scale_dt = 2400.0, 1.5 * 0.01
    done = np.zeros(8, bool)
    done[:n_done] = True
    sums = np.full(8, scale * max_len * scale_dt, np.float32)
    rng = np.array([-0.5, 0.5], np.float32)
    want = jlegged.command_curriculum_update(
        JCfg(), jnp.asarray(done), jnp.asarray(step, jnp.int32), jnp.asarray(sums),
        jnp.asarray(rng), max_len, scale_dt)
    got = tlegged.command_curriculum_update(
        TCfg(), torch.from_numpy(done), torch.tensor(step, dtype=torch.int32),
        torch.from_numpy(sums), torch.from_numpy(rng), max_len, scale_dt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    widened = step % 2400 == 0 and scale > 0.8 and n_done > 0
    assert bool((got.numpy() != rng).any()) == widened
