"""Policy evaluation (port of ``ti5_isaacgym_tpu/scripts/play.py:49-209``).

Runs a policy in a small eval-configured env batch of a registered task,
logs robot 0's state panels and the per-episode reward terms
(:class:`~..utils.logger.Logger`), and can export robot 0's trajectory:

    python -m ti5_isaacgym_tpu_torch.scripts.play --task k1_dh_stand \\
        --log_root logs/k1_dh_stand [--load_run -1] [--checkpoint -1] [--fix_command]
    python -m ti5_isaacgym_tpu_torch.scripts.play --num_envs 4096 --steps 24 \\
        --policy eval_round5/final/exported/policy_dh.npz

The policy is the params of a training checkpoint found through the task
registry (by default), an exported npz (``--policy``, the file
``native/ti5_infer`` reads) or flax-style random weights from the training
seed (``--random_policy``).  The reference's eval-time overrides apply (3x3
terrain without curriculum, no pushes, no external forces;
``make_env_cfg(full_task=True)`` keeps the task's own terrain grid and
domain randomization, as ``chip_smoke.py`` does).  ``--video``, ``--live``
and ``--teleop`` are ROADMAP Queue 1 item 5 and raise.  Runs on ``cuda``
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..algo.convert import load_npz
from ..algo.networks import ActorCriticDH, init_like_flax_
from ..algo.runner import OnPolicyRunner
from ..configs.t1_dh_stand import T1EnvCfg
from ..envs.t1_dh_stand import T1DHStandEnv
from ..utils.device import resolve_device
from ..utils.logger import Logger
from ..utils.registry import resolve_load_path, task_registry


def get_play_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch play")
    p.add_argument("--task", type=str, default="t1_dh_stand")
    p.add_argument("--num_envs", type=int, default=9)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--load_run", type=str, default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--log_root", type=str, default=None)
    p.add_argument("--policy", type=str, default=None, help="exported policy npz")
    p.add_argument("--random_policy", action="store_true",
                   help="random weights from the training seed (no checkpoint)")
    p.add_argument("--fix_command", action="store_true",
                   help="drive a fixed command instead of the schedule")
    p.add_argument("--command", type=float, nargs=3, default=[0.4, 0.0, 0.0])
    p.add_argument("--export_traj", type=str, default=None,
                   help="write robot 0's base pose and joint trajectory to this .npz")
    p.add_argument("--out_dir", type=str, default="eval_out")
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--live", action="store_true")
    p.add_argument("--teleop", type=str, default="off",
                   choices=["off", "auto", "joystick", "keyboard"])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def make_env_cfg(num_envs: int, full_task: bool = False, task: str = "t1_dh_stand") -> T1EnvCfg:
    cfg, _ = task_registry.get_cfgs(task)
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, num_envs=num_envs))
    if full_task:
        return cfg
    # eval-time overrides (reference play.py:66-110): no pushes, no external
    # forces, small terrain; lag and noise stay on
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, episode_length_s=1000.0),
        terrain=dataclasses.replace(cfg.terrain, num_rows=3, num_cols=3, curriculum=False,
                                    border_size=5.0),
        domain_rand=dataclasses.replace(cfg.domain_rand, push_robots=False,
                                        add_ext_force=False))


def make_policy(env_cfg: T1EnvCfg, policy_path=None, seed: int = 0, device="cuda") -> ActorCriticDH:
    """The policy from an exported npz, or random weights made from ``seed``."""
    dev = resolve_device(device)
    if policy_path:
        net = load_npz(policy_path, device=dev)
    else:
        net = init_like_flax_(ActorCriticDH(num_critic_obs=env_cfg.env.num_privileged_obs),
                              torch.Generator().manual_seed(seed)).to(dev)
    return net.eval()


@torch.no_grad()
def rollout(env: T1DHStandEnv, policy: ActorCriticDH, state, obs, steps: int):
    """``steps`` policy steps from (state, obs).  Returns (state, obs, stats):
    env-steps per second over the loop (synchronized on a card), the share of
    envs reset, and the last rewards."""
    n = env.num_envs
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    t0 = time.perf_counter()
    resets = torch.zeros((), device=env.device)
    rew = None
    for _ in range(steps):
        actions = policy.act_mean(obs)
        state, obs, _, rew, done, _ = env.step(state, actions)
        resets = resets + done.sum()
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    secs = time.perf_counter() - t0
    stats = {"seconds": secs, "env_steps_per_s": n * steps / secs,
             "reset_share": float(resets) / (n * steps), "rewards": rew}
    return state, obs, stats


def load_policy(args, env, env_cfg, train_cfg):
    """(policy callable obs -> action mean, env state, obs) for ``args``."""
    if args.policy or args.random_policy:
        policy = make_policy(env_cfg, None if args.random_policy else args.policy,
                             train_cfg.seed, env.device)
        state, obs, _ = env.reset(env.init_state(train_cfg.seed))
        return policy.act_mean, state, obs
    root = args.log_root or task_registry.log_root(args.task, train_cfg)
    path = resolve_load_path(root, args.load_run or -1, args.checkpoint or -1)
    if path is None:
        raise FileNotFoundError(f"no checkpoint found under {root}")
    print(f"loading {path}")
    runner = OnPolicyRunner(env, env_cfg, train_cfg, log_dir=None)
    carry = runner.load(path, params_only=True)
    return runner.get_inference_policy(carry.ts.params), carry.env_state, carry.obs


def play(args):
    for flag, on in (("--video", args.video), ("--live", args.live),
                     ("--teleop", args.teleop != "off")):
        if on:
            raise NotImplementedError(f"{flag} is not ported to ti5_isaacgym_tpu_torch yet "
                                      "(ROADMAP Queue 1 item 5, sim2sim and viewers)")
    if args.policy and args.random_policy:
        raise SystemExit("pass --policy <npz> or --random_policy, not both")
    env_cfg = make_env_cfg(args.num_envs, task=args.task)
    _, train_cfg = task_registry.get_cfgs(args.task)
    env = T1DHStandEnv(env_cfg, seed=train_cfg.seed, device=args.device)
    policy, state, obs = load_policy(args, env, env_cfg, train_cfg)

    logger = Logger(env.dt)
    fixed_cmd = torch.tensor(args.command, dtype=torch.float32, device=env.device)
    feet = list(env.model.feet_bodies)
    robot, traj = 0, []
    resets = torch.zeros((), device=env.device)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(args.steps):
            if args.fix_command:
                n = state.commands.shape[0]
                state = state.replace(
                    commands=torch.cat([fixed_cmd.expand(n, 3), state.commands[:, 3:]], -1),
                    gait_time=torch.full_like(state.gait_time, 1 << 30))
            state, obs, _, rew, done, extras = env.step(state, policy(obs))
            resets = resets + done.sum()
            phys = state.phys
            logger.log_states({
                "base_vel_x": phys.base_vel[robot, 3], "base_vel_y": phys.base_vel[robot, 4],
                "base_vel_z": phys.base_vel[robot, 5], "base_vel_yaw": phys.base_vel[robot, 2],
                "command_x": state.commands[robot, 0], "command_y": state.commands[robot, 1],
                "command_yaw": state.commands[robot, 2],
                "base_height": phys.base_pos[robot, 2],
                "contact_forces_z_l": state.contact_forces[robot, feet[0], 2],
                "contact_forces_z_r": state.contact_forces[robot, feet[1], 2],
                "dof_pos": phys.qpos[robot, 3],
                "dof_pos_target": state.actions[robot, 3] * env.cfg.control.action_scale
                + env.default_dof_pos[3],
                "dof_vel": phys.qvel[robot, 3], "dof_torque": state.torques[robot, 3],
            })
            n_done = int(extras["done_count"])
            if n_done:
                sums = extras["episode_sums_done"].cpu().numpy()
                logger.log_rewards({f"rew_{k}": s / n_done
                                    for k, s in zip(env.reward_names, sums)}, n_done)
            if args.export_traj:
                traj.append(torch.cat([phys.base_pos[robot], phys.base_quat[robot],
                                       phys.qpos[robot]]).cpu().numpy())
            if i % 200 == 0:
                print(f"step {i}: base z {float(phys.base_pos[robot, 2]):.3f} "
                      f"vx {float(phys.base_vel[robot, 3]):+.2f} "
                      f"(cmd {float(state.commands[robot, 0]):+.2f})", flush=True)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    secs = time.perf_counter() - t0
    stats = {"seconds": secs, "env_steps_per_s": env.num_envs * args.steps / secs,
             "reset_share": float(resets) / max(env.num_envs * args.steps, 1)}
    logger.print_rewards()
    logger.plot_states(args.out_dir)
    if args.export_traj:
        np.savez(args.export_traj, qpos=np.stack(traj), dt=env.dt)
        print(f"wrote {args.export_traj}")
    print(f"{args.steps} steps x {env.num_envs} envs of {args.task} on {env.device}: "
          f"{stats['env_steps_per_s']:.1f} env-steps/s (with per-step logging), reset share "
          f"{stats['reset_share']:.4f}, base z mean {float(state.phys.base_pos[:, 2].mean()):.3f}",
          flush=True)
    return state, stats


def main(argv=None):
    play(get_play_args(argv))


if __name__ == "__main__":
    main()
