"""CLI argument parsing and seeding (port of ``ti5_isaacgym_tpu/utils/helpers.py``).

The flags of the JAX CLI are all parsed; none is ignored.  ``--device``
(default ``cuda``) picks the card or the CPU.  Data parallelism:
``--n_devices N`` is the global number of ranks (one process and one device
each), ``--num_processes P`` the number of hosts (each starts N/P ranks),
``--process_id`` this host's index and ``--coordinator`` the ``host:port``
of process 0's rendezvous store; the combinations are checked here.
"""
from __future__ import annotations

import argparse
import random

import numpy as np


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
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks over all hosts, one device each")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of iterations 3-5 into DIR")
    p.add_argument("--coordinator", type=str, default=None, metavar="HOST:PORT",
                   help="rendezvous store of a multi-host run, served by process 0")
    p.add_argument("--num_processes", type=int, default=None,
                   help="hosts of a multi-host run (needs --coordinator)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this host's index in [0, num_processes) (needs --coordinator)")
    args = p.parse_args(argv)
    procs = 1 if args.num_processes is None else args.num_processes
    if args.coordinator is None and (args.num_processes is not None
                                     or args.process_id is not None):
        p.error("--num_processes and --process_id need --coordinator")
    if procs < 1:
        p.error(f"--num_processes {procs} must be at least 1")
    if args.coordinator is not None and procs > 1 and args.process_id is None:
        p.error(f"--num_processes {procs} needs --process_id")
    if not 0 <= (args.process_id or 0) < procs:
        p.error(f"--process_id {args.process_id} must lie in [0, {procs})")
    if args.n_devices is not None and (args.n_devices < 1 or args.n_devices % procs):
        p.error(f"--n_devices {args.n_devices} must be a positive multiple of "
                f"--num_processes {procs}")
    return args


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
