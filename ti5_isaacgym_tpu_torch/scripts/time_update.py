"""What cuDNN's deterministic algorithms cost the learner on the card.

    python -m ti5_isaacgym_tpu_torch.scripts.time_update [--num_envs 8192] [--reps 3]

The training runner sets ``torch.backends.cudnn.deterministic`` so that a
resumed run repeats the original bit for bit.  This script times, with the
flag on and off in the order on, off, off, on: one ``PPO.update`` of the
training configuration (``T1TrainCfg``'s 2 epochs x 4 minibatches over
``num_steps_per_env`` x ``--num_envs`` samples) and the rollout's policy
forward (``PPO.act`` on ``--num_envs`` envs, ``num_steps_per_env`` calls).
The network is initialised as flax does and the batch is drawn from a numpy
seed at the env's widths (the work does not depend on the values).  Each
time is the mean of ``--reps`` calls on CUDA events after one warm call.
Prints one JSON line with the card's ``nvidia-smi`` name and power limit.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..algo import networks as nets
from ..algo.ppo import init_train_state
from ..algo.rollout import Transition
from ..algo.runner import build_network, make_ppo
from ..configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
from ..utils.device import resolve_device
from . import play


def synthetic_batch(T: int, n: int, env_cfg: T1EnvCfg, dev, seed: int = 0) -> Transition:
    """A [T, n] trajectory at the env's widths, observations as bf16."""
    rng = np.random.default_rng(seed)
    na = env_cfg.env.num_actions

    def draw(*shape, scale=1.0):
        x = rng.standard_normal((T, n) + shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(dev)

    return Transition(obs=draw(env_cfg.env.num_observations).to(torch.bfloat16),
                      critic_obs=draw(env_cfg.env.num_privileged_obs).to(torch.bfloat16),
                      actions=draw(na), rewards=draw(),
                      dones=torch.zeros((T, n), dtype=torch.bool, device=dev),
                      values=draw(), log_probs=draw(), mu=draw(na, scale=0.1),
                      sigma=torch.ones((T, n, na), device=dev))


def _mean_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None):
    p = argparse.ArgumentParser("time the PPO update with cuDNN determinism on and off")
    p.add_argument("--num_envs", type=int, default=8192)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True,
                         stdin=subprocess.DEVNULL).stdout.strip().splitlines()[0]
    n, train_cfg = args.num_envs, T1TrainCfg()
    env_cfg = play.make_env_cfg(n, full_task=True)
    T = train_cfg.runner.num_steps_per_env
    net = build_network(train_cfg, env_cfg)
    nets.init_like_flax_(net, torch.Generator().manual_seed(train_cfg.seed))
    net = net.to(dev).requires_grad_(False)
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    alg = make_ppo(train_cfg, net)
    traj = synthetic_batch(T, n, env_cfg, dev)
    returns, adv = traj.rewards, traj.values
    gen = torch.Generator(device=dev).manual_seed(0)
    ts = init_train_state(alg.cfg, params)

    def update():
        alg.update(ts, traj, returns, adv, gen)

    def act():
        for t in range(T):
            alg.act(params, traj.obs[t], traj.critic_obs[t], gen)

    out = {"card": smi, "num_envs": n, "steps_per_env": T, "reps": args.reps, "runs": []}
    for flag in (True, False, False, True):
        torch.backends.cudnn.deterministic = flag
        row = {"cudnn_deterministic": flag, "update_ms": _mean_ms(update, args.reps),
               "rollout_policy_forward_ms": _mean_ms(act, args.reps)}
        out["runs"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
