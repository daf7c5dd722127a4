"""CLI argument parsing and seeding (port of ``ti5_isaacgym_tpu/utils/helpers.py``).

The flags of the JAX CLI are all parsed.  Those of features the port does
not have yet (data parallelism) raise an error that names the ROADMAP item
that will port them; none is ignored.  ``--device`` (default ``cuda``) picks
the card or the CPU.
"""
from __future__ import annotations

import argparse
import random

import numpy as np

# flag -> the ROADMAP item (Queue 1) that ports its feature
NOT_PORTED = {
    "n_devices": "item 6, data parallelism",
    "coordinator": "item 6, data parallelism",
    "num_processes": "item 6, data parallelism",
    "process_id": "item 6, data parallelism",
}


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5_isaacgym_tpu_torch")
    p.add_argument("--task", type=str, default="t1_dh_stand")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--resume", action="store_true", default=None)
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--load_run", type=str, default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--headless", action="store_true", default=True)
    p.add_argument("--use_ref_actions", type=int, default=None, choices=(0, 1),
                   help="override cfg.env.use_ref_actions (gait bootstrap)")
    p.add_argument("--reward_scales", type=str, default=None,
                   help="comma list of name=scale overrides for cfg.rewards.scales, "
                        "e.g. 'feet_air_time=8,feet_clearance=4'")
    p.add_argument("--log_root", type=str, default=None)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of iterations 3-5 into DIR")
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    args = p.parse_args(argv)
    for name, item in NOT_PORTED.items():
        v = getattr(args, name)
        if v is not None and not (name == "n_devices" and v == 1):
            raise NotImplementedError(
                f"--{name} is not ported to ti5_isaacgym_tpu_torch yet (ROADMAP Queue 1 {item})")
    return args


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
