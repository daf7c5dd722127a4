"""Headless policy rollout (port of ``ti5_isaacgym_tpu/scripts/play.py:49-209``).

Builds ``t1_dh_stand``, loads a policy exported as npz (the file
``scripts/sim2sim.py`` reads) or a random one, resets, and steps the env
with the policy's action mean:

    python -m ti5_isaacgym_tpu_torch.scripts.play --num_envs 4096 --steps 24 \\
        --policy eval_round5/final/exported/policy_dh.npz

The reference's eval-time overrides apply (3x3 terrain without curriculum,
no pushes, no external forces; ``make_env_cfg(full_task=True)`` keeps the
task's own terrain grid and domain randomization, as ``chip_smoke.py``
does).  Random weights are drawn as flax's defaults draw them
(:func:`~..algo.networks.init_like_flax_`) from the training seed.  No
viewer, video or teleop.  Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..algo.convert import load_npz
from ..algo.networks import ActorCriticDH, init_like_flax_
from ..configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
from ..envs.t1_dh_stand import T1DHStandEnv
from ..utils.device import resolve_device


def get_play_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch play")
    p.add_argument("--num_envs", type=int, default=9)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--policy", type=str, default=None, help="exported policy npz")
    p.add_argument("--random_policy", action="store_true",
                   help="random weights from the training seed instead of --policy")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def make_env_cfg(num_envs: int, full_task: bool = False) -> T1EnvCfg:
    cfg = T1EnvCfg()
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


def play(args):
    env_cfg, seed = make_env_cfg(args.num_envs), T1TrainCfg().seed
    if not args.policy and not args.random_policy:
        raise SystemExit("pass --policy <npz> or --random_policy")
    env = T1DHStandEnv(env_cfg, seed=seed, device=args.device)
    policy = make_policy(env_cfg, None if args.random_policy else args.policy, seed, args.device)
    state, obs, _ = env.reset(env.init_state(seed))
    state, obs, stats = rollout(env, policy, state, obs, args.steps)
    base_z = state.phys.base_pos[:, 2]
    print(f"{args.steps} steps x {env.num_envs} envs on {env.device}: "
          f"{stats['env_steps_per_s']:.1f} env-steps/s, reset share {stats['reset_share']:.4f}, "
          f"base z mean {float(base_z.mean()):.3f}, reward mean {float(stats['rewards'].mean()):.4f}",
          flush=True)
    return state, stats


def main(argv=None):
    play(get_play_args(argv))


if __name__ == "__main__":
    main()
