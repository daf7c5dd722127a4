"""Where a policy step of the rollout spends its time on the card.

    python -m ti5_isaacgym_tpu_torch.scripts.profile_rollout [--num_envs 4096] [--steps 10]

Builds the full ``t1_dh_stand`` task (as ``chip_smoke.py`` does), loads the
exported round-5 policy, settles 30 steps, then traces ``--steps`` policy
steps with ``torch.profiler`` (CPU and CUDA).  Prints, per policy step: the
wall time (of the same steps run unprofiled), the device busy time (sum of
the kernels' times on the one stream) and the idle share, the number of
kernels launched, the device time of the decimation kernel, the CPU time of
the env's phases (``env.*`` spans), and the kernels with the most device
time.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs.t1_dh_stand import T1TrainCfg
from ..envs.t1_dh_stand import T1DHStandEnv
from ..utils.device import resolve_device
from . import play

POLICY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "eval_round5",
                      "final", "exported", "policy_dh.npz")


def _dev_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    p = argparse.ArgumentParser("profile the torch rollout")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True,
                         stdin=subprocess.DEVNULL).stdout.strip().splitlines()[0]
    seed = T1TrainCfg().seed
    cfg = play.make_env_cfg(args.num_envs, full_task=True)
    env = T1DHStandEnv(cfg, seed=seed, device=dev)
    policy = play.make_policy(cfg, POLICY, device=dev)
    state, obs, _ = env.reset(env.init_state(seed))
    state, obs, _ = play.rollout(env, policy, state, obs, 30)
    # the same steps unprofiled: the wall time the idle share is taken against
    state, obs, plain = play.rollout(env, policy, state, obs, args.steps)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, obs, _ = play.rollout(env, policy, state, obs, args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side kernel events only: CPU ops also carry the time of the
    # kernels they launch, and each env.* span has a device-side twin
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.key.startswith("env.")]
    busy_us = sum(_dev_time(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    decim_us = sum(_dev_time(e) for e in kernels if "decimation_kernel" in e.key)
    steps = args.steps
    spans = {e.key: e.cpu_time_total / steps / 1e3 for e in events
             if e.key.startswith("env.") and e.device_type == DeviceType.CPU}
    top = sorted(kernels, key=_dev_time, reverse=True)[:args.top]
    out = {
        "card": smi, "num_envs": args.num_envs, "steps": steps,
        "wall_ms_per_step": 1e3 * plain["seconds"] / steps,
        "wall_ms_per_step_profiled": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "idle_share": 1.0 - (busy_us / 1e6) / plain["seconds"],
        "kernels_per_step": n_kernels / steps,
        "decimation_kernel_ms_per_step": decim_us / steps / 1e3,
        "env_span_cpu_ms_per_step": spans,
        "top_kernels_ms_per_step": [[e.key[:80], _dev_time(e) / steps / 1e3, e.count // steps]
                                    for e in top],
    }
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
