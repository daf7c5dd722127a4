"""Persist the newest training checkpoint, slimmed, into the committed
checkpoint root (port of ``tools/sync_checkpoint.sh``).

    python -m ti5_isaacgym_tpu_torch.scripts.sync_checkpoint [task] [--device cpu]

Slims the newest ``<log_root>/<task>/<run>/model_<it>.pt`` (by modification
time; a name sort orders runs by the month token) into
``<ckpt_root>/<task>/<run>/model_<it>.pt``, deletes the older slim
checkpoints of that task there (exactly one is kept) and the run
directories that leaves empty, and copies the run's ``metrics.csv`` and
``config.json`` beside it.  ``ckpt_root`` is ``checkpoints_torch``, which no
tool of the JAX package globs (their ``checkpoints/<task>/*/model_*`` would
hand a ``.pt`` to orbax).  ``scripts/resume_round.py`` resumes from it.
Paths are relative to the repository root unless absolute.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil

from ..utils.device import resolve_device
from ..utils.registry import LEGGED_GYM_ROOT, checkpoints_in
from . import slim_checkpoint


def newest_checkpoint(root: str, task: str):
    """The newest ``<root>/<task>/<run>/model_<it>.pt`` by modification
    time, or None."""
    found = [os.path.join(run, name)
             for run in glob.glob(os.path.join(root, task, "*")) if os.path.isdir(run)
             for name in checkpoints_in(run)]
    return max(found, key=os.path.getmtime, default=None)


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch sync_checkpoint")
    p.add_argument("task", nargs="?", default="t1_dh_stand")
    p.add_argument("--log_root", default="logs", help="where the runs are (default logs)")
    p.add_argument("--ckpt_root", default="checkpoints_torch",
                   help="the committed root of slim checkpoints (default checkpoints_torch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = get_args(argv)
    resolve_device(args.device)
    log_root, ckpt_root = (os.path.join(LEGGED_GYM_ROOT, r) for r in (args.log_root,
                                                                        args.ckpt_root))
    newest = newest_checkpoint(log_root, args.task)
    if newest is None:
        raise SystemExit(f"no checkpoints under {os.path.join(log_root, args.task)}")
    run_dir = os.path.dirname(newest)
    dest_dir = os.path.join(ckpt_root, args.task, os.path.basename(run_dir))
    dest = os.path.join(dest_dir, os.path.basename(newest))
    if os.path.exists(dest):
        print(f"already synced: {dest}")
    else:
        slim_checkpoint.main([newest, dest, "--device", args.device])
        for run in glob.glob(os.path.join(ckpt_root, args.task, "*")):
            for name in checkpoints_in(run) if os.path.isdir(run) else ():
                old = os.path.join(run, name)
                if old != dest:
                    os.remove(old)
            if os.path.isdir(run) and not os.listdir(run):
                os.rmdir(run)
        print(f"synced {newest} -> {dest}")
    for name in ("metrics.csv", "config.json"):
        if os.path.exists(os.path.join(run_dir, name)):
            shutil.copyfile(os.path.join(run_dir, name), os.path.join(dest_dir, name))
    return dest


if __name__ == "__main__":
    main()
