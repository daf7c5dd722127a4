"""Contact statistics of a walking policy: the port's engine against the
MuJoCo oracle (port of ``tools/contact_stats_oracle.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.contact_stats --device cpu \\
        --policy eval_round5/final/exported/policy_dh.npz [--steps 800] [--cmd 0.4 0 0] \\
        [--out contact_stats.json]
    python -m ti5_isaacgym_tpu_torch.scripts.contact_stats --skip_policy [--out drop.json]

Runs the same walking policy through (a) the port's env (flat plane,
curriculum, domain randomization, lags and noise off, the command fixed, the
gait clock frozen; :func:`run_engine`) and (b) the MuJoCo deployment
pipeline of ``scripts/sim2sim.py`` on the nominal model (:func:`run_mujoco`),
and compares the gait's contact statistics (:func:`gait_stats`): support
ratio (mean total vertical foot force over the weight), double / single
support and flight fractions, footfalls per second, landing peak and
impulse.  The table and the JSON (``--out``) have the schema of
``eval_round5/contact_stats.json``.

``--skip_policy`` runs only the open-loop matched drop instead: both
engines start from the same state (default pose, base at 1 m, at rest)
under zero actions, so the first landing is each contact model's response
to one pre-impact state (:func:`drop_engine`, :func:`drop_mujoco`,
:func:`drop_stats`; the JSON of ``eval_round5/matched_drop.json``).

The engine half runs on ``--device`` (``cuda`` unless ``cpu``; without a
card it raises); the MuJoCo half needs a host with MuJoCo.  The policy is
the newest checkpoint under ``--log_root`` (``checkpoints_torch``, the
task's experiment directory in it) or ``--policy <npz>``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..algo.convert import load_npz
from ..algo.runner import build_network
from ..configs.t1_dh_stand import T1TrainCfg
from ..envs.t1_dh_stand import T1DHStandEnv
from ..export.policy import restore_policy_params
from ..utils.device import resolve_device
from ..utils.registry import LEGGED_GYM_ROOT, resolve_load_path, task_registry
from . import sim2sim

CONTACT_N = 5.0          # a foot is "in contact" above this vertical force
LAND_WIN = 8             # landing window: 80 ms at 100 Hz
SETTLE = 200             # policy steps left out of the gait statistics
# the engine's weight in the JAX tool (its env has no ``spec``): 55.746 kg
ENGINE_WEIGHT_N = 55.746 * 9.81
# the domain randomization, lag and event switches the oracle turns off
OFF_IN_ORACLE = ("randomize_friction", "randomize_base_mass", "randomize_com",
                 "randomize_link_mass", "randomize_gains", "randomize_torque",
                 "randomize_motor_offset", "randomize_joint_armature",
                 "randomize_coulomb_friction", "add_lag", "add_dof_lag", "add_imu_lag",
                 "push_robots", "add_ext_force")


def gait_stats(grf, dt, weight, settle=SETTLE):
    """grf: [T, n_envs, 2] vertical foot forces at 100 Hz -> stats dict."""
    g = np.asarray(grf, float)[settle:]
    T, N, _ = g.shape
    contact = g > CONTACT_N
    ncon = contact.sum(-1)                     # [T, N] 0/1/2 feet down
    stats = {
        "support_ratio": float(g.sum(-1).mean() / weight),
        "double_support_frac": float((ncon == 2).mean()),
        "single_support_frac": float((ncon == 1).mean()),
        "flight_frac": float((ncon == 0).mean()),
    }
    onsets = contact[1:] & ~contact[:-1]       # [T-1, N, 2]
    peaks, impulses, rate = [], [], []
    for env in range(N):
        for foot in range(2):
            idx = np.flatnonzero(onsets[:, env, foot]) + 1
            rate.append(len(idx) / (T * dt))
            for t0 in idx:
                w = g[t0:t0 + LAND_WIN, env, foot]
                if len(w):
                    peaks.append(w.max())
                    impulses.append(w.sum() * dt)
    stats["footfalls_per_s"] = float(np.mean(rate))
    stats["landing_peak_N"] = float(np.mean(peaks)) if peaks else 0.0
    stats["landing_peak_p95_N"] = float(np.percentile(peaks, 95)) if peaks else 0.0
    stats["landing_impulse_Ns"] = float(np.mean(impulses)) if impulses else 0.0
    return stats


def engine_cfg(env_cfg, n_envs: int):
    """``env_cfg`` with the oracle's overrides: ``n_envs`` envs on a plane,
    no terrain curriculum, every domain randomization, lag and event off,
    no observation noise."""
    return dataclasses.replace(
        env_cfg,
        env=dataclasses.replace(env_cfg.env, num_envs=n_envs),
        terrain=dataclasses.replace(env_cfg.terrain, mesh_type="plane", curriculum=False),
        domain_rand=dataclasses.replace(env_cfg.domain_rand,
                                        **{k: False for k in OFF_IN_ORACLE}),
        noise=dataclasses.replace(env_cfg.noise, add_noise=False))


def load_policy_network(env_cfg, params=None, npz=None):
    """The task's network (on the CPU) with ``params`` (a state dict) or the
    weights of an exported npz."""
    network = build_network(T1TrainCfg(), env_cfg)
    if npz is not None:
        return load_npz(npz, network)
    network.load_state_dict(params)
    return network


@torch.no_grad()
def engine_rollout(env, network, state, obs, cmd, steps: int):
    """``steps`` policy steps of ``network``'s action mean with the command
    fixed to ``cmd`` and the gait clock frozen: (vertical foot forces
    [steps, N, 2], base vx [steps, N], resets [N]: how often each env
    terminated and restarted) as numpy, read once at the end."""
    feet = list(env.model.feet_bodies)
    fixed = torch.as_tensor(cmd, dtype=torch.float32, device=env.device)
    grf, vx = [], []
    resets = torch.zeros(env.num_envs, dtype=torch.int32, device=env.device)
    for _ in range(steps):
        cmds = state.commands.clone()
        cmds[:, :3] = fixed
        state = state.replace(commands=cmds,
                              gait_time=torch.full_like(state.gait_time, 1 << 30))
        state, obs, _priv, _rew, done, _ex = env.step(state, network.act_mean(obs))
        grf.append(state.contact_forces[:, feet, 2])
        vx.append(state.phys.base_vel[:, 3])
        resets += done
    return (torch.stack(grf).cpu().numpy(), torch.stack(vx).cpu().numpy(),
            resets.cpu().numpy())


def run_engine(env_cfg, params, cmd, steps, n_envs=4, device="cuda", network=None):
    """The port's env under the oracle's overrides (:func:`engine_cfg`,
    seed 11) driven by the policy for ``steps`` steps: (grf [T, N, 2], mean
    base vx over the second half, weight N, policy dt)."""
    dev = resolve_device(device)
    cfg = engine_cfg(env_cfg, n_envs)
    env = T1DHStandEnv(cfg, seed=11, device=dev)
    net = (network or load_policy_network(cfg, params)).to(dev).eval()
    state, obs, _ = env.reset(env.init_state(11))
    grf, vx, _resets = engine_rollout(env, net, state, obs, cmd, steps)
    return grf, float(np.mean(vx[len(vx) // 2:])), ENGINE_WEIGHT_N, env.dt


def drop_state(env, state, z0: float = 1.0):
    """``state`` with every robot in the default pose, its base at height
    ``z0``, upright and at rest."""
    n, dev = env.num_envs, env.device
    q0 = torch.as_tensor(env.cfg.init_state.default_joint_angles, dtype=torch.float32,
                         device=dev)
    phys = state.phys.replace(
        base_pos=torch.tensor([0.0, 0.0, z0], device=dev).repeat(n, 1),
        base_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(n, 1),
        base_vel=torch.zeros((n, 6), device=dev), qpos=q0.repeat(n, 1),
        qvel=torch.zeros((n, 12), device=dev))
    return state.replace(phys=phys)


@torch.no_grad()
def drop_rollout(env, state, steps: int):
    """Up to ``steps`` zero-action steps (the PD holds the default pose);
    env 0's vertical foot forces [T', 2] and base height [T'], until its
    first termination (which would reset it to its spawn)."""
    feet = list(env.model.feet_bodies)
    zero = torch.zeros((env.num_envs, env.num_actions), device=env.device)
    g, z = [], []
    for _ in range(steps):
        state, _obs, _priv, _rew, done, _ex = env.step(state, zero)
        if bool(done[0]):
            break
        g.append(state.contact_forces[0, feet, 2])
        z.append(state.phys.base_pos[0, 2])
    if not g:
        return np.zeros((0, 2)), np.zeros((0,))
    return torch.stack(g).cpu().numpy(), torch.stack(z).cpu().numpy()


def drop_engine(env_cfg, steps=300, z0=1.0, device="cuda"):
    """The engine half of the matched drop: the port's env under the
    oracle's overrides at 4 envs (seed 0), the robots dropped from ``z0``.
    Returns (g [T', 2], z [T'], policy dt)."""
    dev = resolve_device(device)
    env = T1DHStandEnv(engine_cfg(env_cfg, 4), seed=0, device=dev)
    state, _, _ = env.reset(env.init_state(0))
    g, z = drop_rollout(env, drop_state(env, state, z0), steps)
    return g, z, env.dt


def _mujoco_start(env_cfg, z0):
    import mujoco

    m = sim2sim.build_model(env_cfg)
    d = mujoco.MjData(m)
    d.qpos[:3] = [0, 0, z0]
    d.qpos[3:7] = [1, 0, 0, 0]
    d.qpos[7:] = np.asarray(env_cfg.init_state.default_joint_angles)
    feet = [mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, n)
            for n in ("leg_l6_link", "leg_r6_link")]
    return m, d, feet


def _mujoco_pd_steps(env_cfg, m, d, target):
    import mujoco

    c = env_cfg
    kp = np.asarray(c.control.stiffness, float)
    kd = np.asarray(c.control.damping, float)
    tlim = sim2sim.T1_EFFORT * c.safety.torque_limit
    for _ in range(c.control.decimation):
        d.ctrl[:] = np.clip(kp * (target - d.qpos[7:]) - kd * d.qvel[6:], -tlim, tlim)
        mujoco.mj_step(m, d)
    # cfrc_ext (contact + external wrench per body, world frame, rows
    # [torque, force]) is filled only by mj_rnePostConstraint
    mujoco.mj_rnePostConstraint(m, d)


def run_mujoco(env_cfg, network, cmd, steps, device="cuda"):
    """The policy in MuJoCo through sim2sim's deployment frame, history and
    policy step (on ``device``): (grf [T, 1, 2], mean vx over the second
    half, weight N, policy dt).  Raises if the robot falls."""
    import mujoco

    sim2sim.check_t1(env_cfg)
    c = env_cfg
    policy = sim2sim.make_policy(network, device)
    m, d, feet = _mujoco_start(c, 1.0)
    default_q = np.asarray(c.init_state.default_joint_angles)
    hist = np.zeros((c.env.frame_stack, c.env.num_single_obs), np.float32)
    actions = np.zeros(12, np.float32)
    dt_pol = c.control.decimation * c.sim.dt
    grf, vx = [], []
    for step in range(steps):
        phase = (step * dt_pol / c.rewards.cycle_time) % 1.0
        frame = sim2sim.deployment_frame(c, phase, cmd, d.qpos[7:] - default_q, d.qvel[6:],
                                         actions, d.qvel[3:6], d.qpos[3:7])
        hist = sim2sim.push_frame(hist, frame)
        act_mean, _ = policy(hist.reshape(1, -1))
        actions = np.clip(np.asarray(act_mean)[0], -c.normalization.clip_actions,
                          c.normalization.clip_actions)
        _mujoco_pd_steps(c, m, d, actions * c.control.action_scale + default_q)
        grf.append(np.array([[max(d.cfrc_ext[b][5], 0.0) for b in feet]]))
        R = np.zeros(9)
        mujoco.mju_quat2Mat(R, d.qpos[3:7])
        vx.append((R.reshape(3, 3).T @ d.qvel[:3])[0])
        if d.qpos[2] < 0.4:
            raise SystemExit("policy fell in MuJoCo — pick a walking checkpoint")
    return np.stack(grf), float(np.mean(vx[len(vx) // 2:])), float(m.body_mass.sum() * 9.81), \
        dt_pol


def drop_mujoco(env_cfg, steps=300, z0=1.0):
    """The MuJoCo half of the matched drop: (g [T, 2], z [T], policy dt)."""
    m, d, feet = _mujoco_start(env_cfg, z0)
    dq = np.asarray(env_cfg.init_state.default_joint_angles)
    g, z = [], []
    for _ in range(steps):
        _mujoco_pd_steps(env_cfg, m, d, dq)
        g.append(np.array([max(d.cfrc_ext[b][5], 0.0) for b in feet]))
        z.append(float(d.qpos[2]))
    return np.asarray(g), np.asarray(z), env_cfg.control.decimation * env_cfg.sim.dt


def drop_stats(g, z, dt):
    """g [T', 2] vertical foot forces, z [T'] base height -> the landing's
    statistics: first contact, peak and impulse over the 200 ms after it,
    the mean force 0.3-0.8 s after it, and when the base falls below 0.4 m
    (the horizon when it does not)."""
    g = np.asarray(g)
    z = np.asarray(z)
    tot = g.sum(-1)
    t_c = int(np.argmax(tot > CONTACT_N))
    win = tot[t_c:t_c + 20]
    post = tot[t_c + 30:t_c + 80]
    fallen = np.flatnonzero(z < 0.4)
    return {
        "first_contact_s": t_c * dt,
        "landing_peak_N": float(win.max()) if len(win) else 0.0,
        "landing_impulse_Ns": float(win.sum() * dt),
        "post_landing_grf_N": float(post.mean()) if len(post) else 0.0,
        "topple_s": float(fallen[0] * dt) if len(fallen) else len(z) * dt,
    }


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch contact_stats")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--cmd", type=float, nargs=3, default=[0.4, 0.0, 0.0])
    p.add_argument("--log_root", default=os.path.join(LEGGED_GYM_ROOT, "checkpoints_torch"))
    p.add_argument("--load_run", default=None)
    p.add_argument("--policy", default=None, help="an exported npz instead of a checkpoint")
    p.add_argument("--out", default=None)
    p.add_argument("--skip_policy", action="store_true",
                   help="only the matched-state open-loop drop")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def _write(payload, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {path}")


def main(argv=None) -> dict:
    args = get_args(argv)
    resolve_device(args.device)
    env_cfg, train_cfg = task_registry.get_cfgs("t1_dh_stand")
    if args.skip_policy:
        g_e, z_e, dt = drop_engine(env_cfg, device=args.device)
        g_m, z_m, _ = drop_mujoco(env_cfg)
        payload = {"engine": drop_stats(g_e, z_e, dt), "mujoco": drop_stats(g_m, z_m, dt)}
        for k in payload["engine"]:
            print(f"{k:24s} {payload['engine'][k]:10.3f} {payload['mujoco'][k]:10.3f}")
        if args.out:
            _write(payload, args.out)
        return payload
    if args.policy:
        path, it = os.path.abspath(args.policy), None
        network = load_policy_network(env_cfg, npz=args.policy)
    else:
        root = os.path.join(args.log_root, train_cfg.runner.experiment_name)
        path = resolve_load_path(root, args.load_run or -1, -1)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
        params, it = restore_policy_params(path)
        network = load_policy_network(env_cfg, params)
    print(f"policy: {path}")
    settle = min(SETTLE, args.steps // 2)
    print("running engine rollout...", flush=True)
    g_e, vx_e, w_e, dt = run_engine(env_cfg, None, args.cmd, args.steps,
                                    device=args.device, network=network)
    print("running MuJoCo rollout...", flush=True)
    g_m, vx_m, w_m, _ = run_mujoco(env_cfg, network, args.cmd, args.steps, args.device)
    s_e = gait_stats(g_e, dt, w_e, settle)
    s_m = gait_stats(g_m, dt, w_m, settle)
    print(f"\n{'stat':24s} {'engine':>10s} {'mujoco':>10s}   ratio")
    rows = {}
    for k in s_e:
        r = s_e[k] / s_m[k] if s_m[k] else float("inf")
        rows[k] = {"engine": s_e[k], "mujoco": s_m[k], "ratio": r}
        print(f"{k:24s} {s_e[k]:10.3f} {s_m[k]:10.3f}   {r:5.2f}")
    print(f"{'mean vx (cmd %.2f)' % args.cmd[0]:24s} {vx_e:10.3f} {vx_m:10.3f}")
    payload = {"checkpoint": path, "iteration": it, "steps": args.steps, "cmd": args.cmd,
               "stats": rows, "mean_vx": {"engine": vx_e, "mujoco": vx_m}}
    if args.out:
        _write(payload, args.out)
    return payload


if __name__ == "__main__":
    main()
