"""Sim-to-sim policy transfer check in MuJoCo (port of
``ti5_isaacgym_tpu/scripts/sim2sim.py``; the reference's README documents
MuJoCo transfer as the integration gate, reference ``README.md:31-36``).

Loads a policy (a runner checkpoint found through the task registry, an
exported npz with ``--policy``, or flax-style random weights with
``--random_policy``), rebuilds the deployment-side observation pipeline
(47-dim frame with sin/cos phase, commands, lagless joint states, IMU;
stacked 66 deep, :func:`deployment_frame`), and runs the robot in MuJoCo on
the spec-generated MJCF with the same 1 kHz PD / 100 Hz policy timing.
MuJoCo runs on the host; the policy's forward (``act_inference``) runs on
``--device`` (``cuda`` unless ``cpu`` is asked for), one observation copied
to it and one result copied back per policy step.

Two modes:

* single command (``--command vx vy wz``): one episode, prints a
  ``sim2sim:`` result line;
* ``--sweep``: the command table :data:`SWEEP` x ``--episodes`` episodes
  each, every episode on a MuJoCo model whose link masses, base mass and
  ground friction are drawn as training's domain randomization draws them,
  from a seed fixed by ``--seed``, the row's name and the episode
  (:func:`sweep_seed`); a horizon of at least 20 s; per-command survival and
  tracking errors against thresholds; a ``sim2sim_table:`` JSON line.  Exit
  code 1 when a required row (stand, 0.4 m/s forward) fails.

    python -m ti5_isaacgym_tpu_torch.scripts.sim2sim --policy \\
        eval_round5/final/exported/policy_dh.npz --sweep --device cpu

Only T1 tasks run: the deployment torque limits are T1's motors'
(:data:`T1_EFFORT`); another robot raises.
"""
from __future__ import annotations

import argparse
import json
import os
import zlib

import numpy as np
import torch

from ..algo.convert import load_npz
from ..algo.networks import init_like_flax_
from ..algo.runner import build_network
from ..export.mjcf import spec_to_mjcf
from ..export.policy import restore_policy_params
from ..physics.model import RESOURCES
from ..utils.device import resolve_device
from ..utils.registry import resolve_load_path, task_registry

T1_SPEC = "t1_model.json"
# T1's motor effort limits (Nm) in the deployment controller, joint order of
# the spec (reference sim2sim's table)
T1_EFFORT = np.array([102, 102, 267, 267, 80, 40, 102, 102, 267, 267, 80, 40.2])
# the sweep's horizon is at least this many policy steps (20 s at 100 Hz)
MIN_SWEEP_STEPS = 2000


def quat_to_euler_wxyz(q):
    w, x, y, z = q
    roll = np.arctan2(2 * (w * x + y * z), w * w - x * x - y * y + z * z)
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
    yaw = np.arctan2(2 * (w * z + x * y), w * w + x * x - y * y - z * z)
    e = np.array([roll, pitch, yaw])
    e = np.mod(e, 2 * np.pi)
    return np.where(e > np.pi, e - 2 * np.pi, e)


def check_t1(env_cfg):
    """Raise unless the task's robot is T1, whose motors :data:`T1_EFFORT` lists."""
    spec = env_cfg.asset.model_spec
    if spec != T1_SPEC:
        raise ValueError(
            f"sim2sim runs T1 only: the task's robot is {env_cfg.asset.name!r} ({spec}), and "
            f"the deployment torque limits T1_EFFORT are T1's motors'")


def build_model(env_cfg, rng=None):
    """MuJoCo model from the task's model spec; when ``rng`` is given, the
    model parameters are randomized the way training DR does (reference
    ``legged_robot.py:692-729`` mass / ``:797-824`` friction), so the gate
    measures transfer onto a *distribution* of worlds, not one nominal one."""
    import mujoco

    with open(os.path.join(RESOURCES, env_cfg.asset.model_spec)) as f:
        spec = json.load(f)
    m = mujoco.MjModel.from_xml_string(spec_to_mjcf(spec, with_geoms=True, limited=True))
    # mid-range armature like training
    m.dof_armature[6:] = [(a + b) / 2 for a, b in env_cfg.domain_rand.joint_armature_ranges]
    if rng is not None:
        dr = env_cfg.domain_rand
        # link masses x U[link_mass_range]; base payload + U[base_mass_range]
        lo, hi = dr.added_link_mass_range
        m.body_mass[1:] *= rng.uniform(lo, hi, m.body_mass[1:].shape)
        blo, bhi = dr.added_mass_range
        m.body_mass[1] += rng.uniform(blo, bhi)
        # ground friction from the training bucket range
        flo, fhi = dr.friction_range
        m.geom_friction[:, 0] = np.clip(rng.uniform(flo, fhi), 0.05, None)
    return m


def deployment_frame(env_cfg, phase, cmd, q, dq, actions, ang_vel, quat) -> np.ndarray:
    """One 47-dim float32 observation frame as the robot's controller builds
    it: sin/cos of the gait phase, the scaled command, joint positions about
    the default pose and joint velocities, the last actions, the body-frame
    angular velocity and the Euler angles of the base quaternion (wxyz), all
    scaled as in training.  Computed in float64 and cast once at the end."""
    os_ = env_cfg.normalization.obs_scales
    cmd_scale = np.array([os_.lin_vel, os_.lin_vel, os_.ang_vel])
    return np.concatenate([
        [np.sin(2 * np.pi * phase), np.cos(2 * np.pi * phase)],
        np.asarray(cmd, float) * cmd_scale,
        q * os_.dof_pos, dq * os_.dof_vel, actions,
        ang_vel * os_.ang_vel, quat_to_euler_wxyz(quat) * os_.quat,
    ]).astype(np.float32)


def push_frame(hist: np.ndarray, frame: np.ndarray) -> np.ndarray:
    """The ``[frame_stack, 47]`` history with the oldest frame dropped and
    ``frame`` appended."""
    return np.concatenate([hist[1:], frame[None]], axis=0)


def make_policy(network, device="cuda"):
    """``obs [1, 66*47] float32 -> (act_mean [1, 12], est_vel [1, 3])``, numpy
    in and out: ``network.act_inference`` on ``device``, the observation
    copied there and both results back in one copy."""
    dev = resolve_device(device)
    net = network.to(dev).eval()

    @torch.no_grad()
    def policy(obs):
        act, est = net.act_inference(torch.as_tensor(obs).to(dev))
        out = torch.cat([act, est], dim=-1).cpu().numpy()
        return out[:, :act.shape[-1]], out[:, act.shape[-1]:]

    return policy


def run_episode(env_cfg, policy, cmd, steps, model, settle_s: float = 2.0):
    """One deployment-pipeline episode; returns survival + tracking stats."""
    import mujoco

    check_t1(env_cfg)
    c = env_cfg
    d = mujoco.MjData(model)
    default_q = np.asarray(c.init_state.default_joint_angles)
    kp = np.asarray(c.control.stiffness, float)
    kd = np.asarray(c.control.damping, float)
    tlim = T1_EFFORT * c.safety.torque_limit
    d.qpos[:3] = [0, 0, 1.0]
    d.qpos[3:7] = [1, 0, 0, 0]
    d.qpos[7:] = default_q

    cmd = np.asarray(cmd, float)
    hist = np.zeros((c.env.frame_stack, c.env.num_single_obs), np.float32)
    actions = np.zeros(12, np.float32)
    dec = c.control.decimation
    dt_pol = dec * c.sim.dt
    stand = np.linalg.norm(cmd) <= c.commands.stand_com_threshold
    # tracking stats skip the initial transient, but short probe horizons
    # (CLI --steps below 2*settle) must still produce samples
    settle = min(int(settle_s / dt_pol), steps // 2)
    err_acc = np.zeros(3)
    n_acc, t_alive, fell = 0, 0, False
    for step in range(steps):
        phase = 0.0 if stand else (step * dt_pol / c.rewards.cycle_time) % 1.0
        # free-joint angular velocity (qvel[3:6]) is body-frame
        frame = deployment_frame(c, phase, cmd, d.qpos[7:] - default_q, d.qvel[6:], actions,
                                 d.qvel[3:6], d.qpos[3:7])
        hist = push_frame(hist, frame)
        act_mean, _ = policy(hist.reshape(1, -1))
        actions = np.clip(np.asarray(act_mean)[0], -c.normalization.clip_actions,
                          c.normalization.clip_actions)
        target = actions * c.control.action_scale + default_q
        for _ in range(dec):
            tau = np.clip(kp * (target - d.qpos[7:]) - kd * d.qvel[6:], -tlim, tlim)
            d.ctrl[:] = tau
            mujoco.mj_step(model, d)
        # base-frame velocities vs the command (after the settle window)
        R = np.zeros(9)
        mujoco.mju_quat2Mat(R, d.qpos[3:7])
        v_body = R.reshape(3, 3).T @ d.qvel[:3]
        if step >= settle:
            err_acc += np.abs([v_body[0] - cmd[0], v_body[1] - cmd[1], d.qvel[5] - cmd[2]])
            n_acc += 1
        t_alive = step
        if d.qpos[2] < 0.4:
            fell = True
            break
    if n_acc == 0:
        # fell before the settle window: no tracking samples is a failure,
        # not perfect tracking
        err_acc = np.full(3, np.inf)
        n_acc = 1
    return dict(survived_s=(t_alive + 1) * dt_pol, horizon_s=steps * dt_pol,
                fell=fell, vx_err=err_acc[0] / n_acc, vy_err=err_acc[1] / n_acc,
                wz_err=err_acc[2] / n_acc, final_z=float(d.qpos[2]))


# (name, command, required-for-gate, vx/vy/wz error thresholds)
SWEEP = [
    ("stand",   (0.0, 0.0, 0.0), True,  (0.10, 0.10, 0.20)),
    ("fwd_0.4", (0.4, 0.0, 0.0), True,  (0.25, 0.15, 0.30)),
    ("fwd_1.0", (1.0, 0.0, 0.0), False, (0.60, 0.20, 0.40)),
    ("lat_0.3", (0.0, 0.3, 0.0), False, (0.20, 0.30, 0.40)),
    ("turn_0.5", (0.0, 0.0, 0.5), False, (0.20, 0.20, 0.50)),
]


def sweep_seed(seed: int, name: str, episode: int) -> int:
    """The seed of a sweep episode's randomized model: a function of
    ``--seed``, the row's name (through CRC-32, the same in every process)
    and the episode."""
    return seed * 10007 + zlib.crc32(name.encode()) % 1000 + episode


def load_network(args, env_cfg, train_cfg):
    """The task's network with the weights ``args`` name, on the CPU."""
    if args.policy and args.random_policy:
        raise SystemExit("pass --policy <npz> or --random_policy, not both")
    network = build_network(train_cfg, env_cfg)
    if args.random_policy:
        init_like_flax_(network, torch.Generator().manual_seed(0))
    elif args.policy:
        load_npz(args.policy, network)
    else:
        root = args.log_root or task_registry.log_root(args.task, train_cfg)
        path = resolve_load_path(root, args.load_run or -1, args.checkpoint or -1)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
        print(f"loading {path}")
        params, it = restore_policy_params(path)
        network.load_state_dict(params)
        print(f"checkpoint iteration {it}")
    return network


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch sim2sim")
    p.add_argument("--task", type=str, default="t1_dh_stand")
    p.add_argument("--steps", type=int, default=1000, help="policy steps (100 Hz)")
    p.add_argument("--command", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--sweep", action="store_true",
                   help="hardened gate: command table x randomized models")
    p.add_argument("--episodes", type=int, default=2,
                   help="episodes per command in --sweep (randomized models)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_run", type=str, default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--log_root", type=str, default=None)
    p.add_argument("--policy", type=str, default=None, help="exported policy npz")
    p.add_argument("--random_policy", action="store_true",
                   help="flax-style random weights from seed 0 (no checkpoint)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the policy's forward: cuda (raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    check_t1(env_cfg)
    policy = make_policy(load_network(args, env_cfg, train_cfg), args.device)

    if not args.sweep:
        m = build_model(env_cfg)
        r = run_episode(env_cfg, policy, args.command, args.steps, m)
        if r["fell"]:
            print(f"fell at t={r['survived_s']:.2f}s")
        print(f"sim2sim: survived {r['survived_s']:.2f}s / {r['horizon_s']:.2f}s, "
              f"mean |vx err| = {r['vx_err']:.3f} m/s, final z = {r['final_z']:.3f}")
        return 0

    # --- hardened sweep gate ---
    steps = max(args.steps, MIN_SWEEP_STEPS)
    rows = []
    required_ok = True
    for name, cmd, required, thr in SWEEP:
        surv, errs = [], []
        for ep in range(args.episodes):
            rng = np.random.default_rng(sweep_seed(args.seed, name, ep))
            m = build_model(env_cfg, rng=rng)
            r = run_episode(env_cfg, policy, cmd, steps, m)
            surv.append(r["survived_s"] / r["horizon_s"])
            errs.append([r["vx_err"], r["vy_err"], r["wz_err"]])
        surv_frac = float(np.mean(surv))
        err = np.mean(errs, axis=0)
        ok = surv_frac >= 0.999 and all(err[i] <= thr[i] for i in range(3))
        if required and not ok:
            required_ok = False
        rows.append((name, cmd, surv_frac, err, thr, ok, required))
        print(f"sweep {name:9s} cmd=({cmd[0]:+.1f},{cmd[1]:+.1f},{cmd[2]:+.1f})"
              f" survived {surv_frac * 100:5.1f}% |"
              f" err vx {err[0]:.3f}/{thr[0]:.2f} vy {err[1]:.3f}/{thr[1]:.2f}"
              f" wz {err[2]:.3f}/{thr[2]:.2f} -> "
              f"{'PASS' if ok else 'FAIL'}{' (required)' if required else ''}",
              flush=True)

    n_pass = sum(1 for r in rows if r[5])
    # machine-readable summary (the lines tools/eval_report.py parses)
    print(f"sim2sim: sweep {n_pass}/{len(rows)} commands pass "
          f"({steps / 100:.0f}s horizon, {args.episodes} randomized models each); "
          f"required gates {'PASS' if required_ok else 'FAIL'}")
    print("sim2sim_table: " + json.dumps([
        dict(name=n, cmd=list(c), survival=s, vx_err=float(e[0]),
             vy_err=float(e[1]), wz_err=float(e[2]), thresholds=list(t),
             passed=bool(o), required=bool(q))
        for n, c, s, e, t, o, q in rows]))
    return 0 if required_ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
