"""One-command bring-up of the long training run (port of
``tools/resume_round.sh``).

    python -m ti5_isaacgym_tpu_torch.scripts.resume_round [num_envs] [iters] [--device cpu]

Resumes ``t1_dh_stand`` from the newest slim checkpoint under
``checkpoints_torch/t1_dh_stand`` through ``scripts/resume_migrate.py``, or
starts a fresh run (``scripts/train.py``, run name ``cont``) when there is
none, into ``<log_root>/t1_dh_stand/<stamp>_cont``.  The run is started in
the background in a session of its own; its output goes to
``<log_root>/train_cont.console`` and its pid to ``<log_root>/train_cont.pid``.
Paths are relative to the repository root unless absolute.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from datetime import datetime

from ..utils.device import resolve_device
from ..utils.registry import LEGGED_GYM_ROOT
from .sync_checkpoint import newest_checkpoint

TASK = "t1_dh_stand"


def entry(module: str) -> list:
    """The command that runs the port's ``scripts/<module>.py``."""
    return [sys.executable, "-m", f"ti5_isaacgym_tpu_torch.scripts.{module}"]


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch resume_round")
    p.add_argument("num_envs", nargs="?", type=int, default=4096)
    p.add_argument("iters", nargs="?", type=int, default=400000)
    p.add_argument("--log_root", default="logs")
    p.add_argument("--ckpt_root", default="checkpoints_torch")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None, entry=entry) -> subprocess.Popen:
    """Start the run; returns its process.  ``entry(module)`` is the
    command of a port script (tests cut the tasks through it)."""
    args = get_args(argv)
    resolve_device(args.device)
    log_root, ckpt_root = (os.path.join(LEGGED_GYM_ROOT, r) for r in (args.log_root,
                                                                        args.ckpt_root))
    slim = newest_checkpoint(ckpt_root, TASK)
    log_dir = os.path.join(log_root, TASK, datetime.now().strftime("%b%d_%H-%M-%S") + "_cont")
    common = ["--num_envs", str(args.num_envs), "--log_every", "100", "--device", args.device]
    if slim is not None:
        print(f"resuming from {slim} -> {log_dir}")
        cmd = entry("resume_migrate") + ["--ckpt", slim, "--task", TASK, "--iters",
                                         str(args.iters), "--log_dir", log_dir] + common
    else:
        print("no committed checkpoint; fresh run")
        cmd = entry("train") + ["--task", TASK, "--max_iterations", str(args.iters),
                                "--run_name", "cont", "--log_root",
                                os.path.join(log_root, TASK)] + common
    os.makedirs(log_root, exist_ok=True)
    with open(os.path.join(log_root, "train_cont.console"), "w") as console:
        proc = subprocess.Popen(cmd, stdout=console, stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL, cwd=LEGGED_GYM_ROOT,
                                start_new_session=True)
    with open(os.path.join(log_root, "train_cont.pid"), "w") as f:
        f.write(f"pid: {proc.pid}\n")
    print(f"pid: {proc.pid}")
    return proc


if __name__ == "__main__":
    main()
