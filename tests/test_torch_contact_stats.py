"""The contact-statistics oracle (``scripts/contact_stats.py``) against the
JAX tool (``tools/contact_stats_oracle.py``, imported by path here only).

The JAX env is built once with the tool's overrides (4 envs, a plane, the
domain randomization, lags, events and noise off), its initial state made
op by op (``jax.disable_jit``) and stepped through one ``jax.jit`` of its
step (about 75 s to compile here, then milliseconds a step), shared by the
matched drop and the policy rollout.  The tool resets the env first; its
reset costs more than either rollout here (half a minute op by op, over a
minute to compile) and changes nothing the comparison needs: with a plane
the env's seed (the tool's 0 and 11) seeds nothing, the drop overwrites
every physics field the reset draws, and the rollout only needs one state
that both packages start from.

* the drop: the port's ``drop_engine`` for 25 policy steps against the
  engine half of the tool's ``run_matched_drop`` (``:185``), driven as it
  drives it; first contact at step 11 on both;
* the rollout: ``engine_rollout`` (what ``run_engine`` steps) from the JAX
  env's initial state carried into the port, against the tool's
  ``run_engine`` loop for :data:`ROLLOUT_STEPS` steps with the same policy
  (the round-5 export on the port's side, the orbax checkpoint it was
  exported from on JAX's), and the gait statistics of both with the settle
  lowered to 0;
* ``gait_stats`` against the tool's on seeded forces, bit for bit;
* ``main`` at 30 steps (both engines), whose JSON has the keys of
  ``eval_round5/contact_stats.json``.

Tolerances: the drop, the reference's state and contact tolerances
(tests/test_megakernel.py:52-67: base z 2e-4, feet forces 2 N + 2e-3);
the closed-loop rollout, :data:`ROLLOUT_FORCE_TOL` and :data:`ROLLOUT_VX_TOL`.
"""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu_torch.envs.convert import state_from_numpy
from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv
from ti5_isaacgym_tpu_torch.scripts import contact_stats as cs
from ti5_isaacgym_tpu_torch.utils.registry import task_registry

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NPZ = os.path.join(ROOT, "eval_round5", "final", "exported", "policy_dh.npz")
JAX_CKPT = os.path.join(ROOT, "checkpoints", "t1_dh_stand", "Aug21_19-21-52_probe_s21",
                        "model_71000")
CMD = [0.4, 0.0, 0.0]
DROP_STEPS = 25
ROLLOUT_STEPS = 16
ROLLOUT_FORCE_TOL = (2.0, 2e-3)
ROLLOUT_VX_TOL = 2e-4


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread, here and in the processes a test starts: the ops
    are small, and the workers of a parallel test run share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_contact_stats_oracle", os.path.join(ROOT, "tools", "contact_stats_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_cfg(env_cfg):
    """The overrides of the tool's ``run_engine`` and ``run_matched_drop``."""
    return dataclasses.replace(
        env_cfg,
        env=dataclasses.replace(env_cfg.env, num_envs=4),
        terrain=dataclasses.replace(env_cfg.terrain, mesh_type="plane", curriculum=False),
        domain_rand=dataclasses.replace(
            env_cfg.domain_rand, randomize_friction=False,
            randomize_base_mass=False, randomize_com=False,
            randomize_link_mass=False, randomize_gains=False,
            randomize_torque=False, randomize_motor_offset=False,
            randomize_joint_armature=False, randomize_coulomb_friction=False,
            add_lag=False, add_dof_lag=False, add_imu_lag=False,
            push_robots=False, add_ext_force=False),
        noise=dataclasses.replace(env_cfg.noise, add_noise=False))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX env's initial state (numpy), its drop (feet forces [T', 2],
    base z [T']) and its policy rollout (feet forces [T, 4, 2], base vx
    [T, 4])."""
    from ti5_isaacgym_tpu.algo.runner import build_network
    from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
    from ti5_isaacgym_tpu.envs.t1_dh_stand import T1DHStandEnv as JEnv
    from ti5_isaacgym_tpu.export.policy import restore_policy_params

    cfg = _tool_cfg(T1EnvCfg())
    with jax.disable_jit():
        env = JEnv(cfg, seed=11)
        start = env.init_state(jax.random.PRNGKey(11))
    step = jax.jit(env.step)
    feet = list(env.model.feet_bodies)
    n = cfg.env.num_envs

    # run_matched_drop's engine half
    ph = start.phys.replace(
        base_pos=jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (n, 1)),
        base_quat=jnp.tile(jnp.asarray([1.0, 0.0, 0.0, 0.0]), (n, 1)),
        base_vel=jnp.zeros((n, 6)),
        qpos=jnp.tile(jnp.asarray(cfg.init_state.default_joint_angles), (n, 1)),
        qvel=jnp.zeros((n, 12)))
    state = start.replace(phys=ph)
    zero = jnp.zeros((n, env.num_actions))
    g_d, z_d = [], []
    for _ in range(DROP_STEPS):
        state, _o, _p, _r, done, _ex = step(state, zero)
        if bool(done[0]):
            break
        g_d.append(np.asarray(state.contact_forces[0, feet, 2]))
        z_d.append(float(state.phys.base_pos[0, 2]))

    # run_engine's loop
    params, _ = restore_policy_params(JAX_CKPT)
    net = build_network(T1TrainCfg(), cfg)
    policy = jax.jit(lambda o: net.apply(params, o, method="act_mean"))
    state, obs = start, start.obs_hist
    fixed = jnp.asarray(CMD, jnp.float32)
    grf, vx = [], []
    for _ in range(ROLLOUT_STEPS):
        state = state.replace(commands=state.commands.at[:, :3].set(fixed),
                              gait_time=jnp.full_like(state.gait_time, 1 << 30))
        state, obs, _p, _r, _d, _ex = step(state, policy(obs))
        grf.append(np.asarray(state.contact_forces[:, feet, 2]))
        vx.append(np.asarray(state.phys.base_vel[:, 3]))
    return dict(start=jax.tree.map(np.asarray, start), drop=(np.stack(g_d), np.asarray(z_d)),
                rollout=(np.stack(grf), np.stack(vx)), dt=env.dt)


def test_engine_cfg_is_the_tools():
    """The port's oracle overrides are the tool's, field for field."""
    from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg

    want = _tool_cfg(T1EnvCfg())
    got = cs.engine_cfg(task_registry.get_cfgs("t1_dh_stand")[0], 4)
    for part in ("env", "terrain", "domain_rand", "noise"):
        w, g = dataclasses.asdict(getattr(want, part)), dataclasses.asdict(getattr(got, part))
        assert {k: g[k] for k in w} == w, part


def test_gait_stats_matches_the_tool():
    tool = _jax_tool()
    rng = np.random.default_rng(0)
    on = rng.random((400, 6, 2)) < 0.6
    grf = np.where(on, rng.uniform(0, 900, (400, 6, 2)), rng.uniform(0, 4, (400, 6, 2)))
    for settle in (200, 0):
        assert cs.gait_stats(grf, 0.01, 547.0, settle) == tool.gait_stats(grf, 0.01, 547.0,
                                                                         settle)
    assert (cs.CONTACT_N, cs.LAND_WIN) == (tool.CONTACT_N, tool.LAND_WIN)


def test_drop_engine_matches_jax(jax_side):
    env_cfg = task_registry.get_cfgs("t1_dh_stand")[0]
    g, z, dt = cs.drop_engine(env_cfg, steps=DROP_STEPS, device="cpu")
    jg, jz = jax_side["drop"]
    assert g.shape == jg.shape == (DROP_STEPS, 2) and dt == jax_side["dt"]
    np.testing.assert_allclose(z, jz, atol=2e-4, err_msg="base z")
    np.testing.assert_allclose(g, jg, atol=2.0, rtol=2e-3, err_msg="feet forces")
    ours, theirs = cs.drop_stats(g, z, dt), cs.drop_stats(jg, jz, dt)
    assert ours["first_contact_s"] == theirs["first_contact_s"] == 0.11
    assert int(np.argmax(g.sum(-1) > cs.CONTACT_N)) == 11
    assert abs(ours["landing_peak_N"] - theirs["landing_peak_N"]) <= 2.0 + 2e-3 * abs(
        theirs["landing_peak_N"])


def test_engine_rollout_matches_jax(jax_side):
    """The policy rollout from the JAX env's initial state, both packages,
    and the gait statistics of both with the settle lowered to 0."""
    env_cfg = task_registry.get_cfgs("t1_dh_stand")[0]
    env = T1DHStandEnv(cs.engine_cfg(env_cfg, 4), seed=11, device="cpu")
    state = state_from_numpy(jax_side["start"], seed=11, device="cpu")
    net = cs.load_policy_network(env_cfg, npz=NPZ).eval()
    g, vx, resets = cs.engine_rollout(env, net, state, state.obs_hist, CMD, ROLLOUT_STEPS)
    assert resets.tolist() == [0, 0, 0, 0]
    jg, jvx = jax_side["rollout"]
    assert g.shape == jg.shape == (ROLLOUT_STEPS, 4, 2)
    np.testing.assert_allclose(vx, jvx, atol=ROLLOUT_VX_TOL, err_msg="base vx")
    np.testing.assert_allclose(g, jg, atol=ROLLOUT_FORCE_TOL[0], rtol=ROLLOUT_FORCE_TOL[1],
                               err_msg="feet forces")
    ours = cs.gait_stats(g, jax_side["dt"], cs.ENGINE_WEIGHT_N, settle=0)
    theirs = _jax_tool().gait_stats(jg, jax_side["dt"], 55.746 * 9.81, settle=0)
    for k in ("double_support_frac", "single_support_frac", "flight_frac", "footfalls_per_s"):
        assert ours[k] == theirs[k], k
    assert ours["support_ratio"] == pytest.approx(theirs["support_ratio"], abs=5e-3)


def test_main_writes_the_tools_schema(tmp_path):
    """``main`` at 30 steps (the settle lowered to 15): the engine and MuJoCo
    rows, and the JSON keys of eval_round5/contact_stats.json."""
    out = tmp_path / "contact_stats.json"
    payload = cs.main(["--device", "cpu", "--policy", NPZ, "--steps", "30", "--out", str(out)])
    with open(os.path.join(ROOT, "eval_round5", "contact_stats.json")) as f:
        ref = json.load(f)
    with open(out) as f:
        got = json.load(f)
    assert set(got) == set(ref) and set(got["stats"]) == set(ref["stats"])
    assert all(set(v) == {"engine", "mujoco", "ratio"} for v in got["stats"].values())
    assert set(got["mean_vx"]) == {"engine", "mujoco"} and got["steps"] == 30
    assert got["cmd"] == ref["cmd"] and got["checkpoint"] == NPZ and got["iteration"] is None
    assert got["stats"] == payload["stats"]
    assert all(np.isfinite(v["engine"]) and np.isfinite(v["mujoco"])
               for v in got["stats"].values())
