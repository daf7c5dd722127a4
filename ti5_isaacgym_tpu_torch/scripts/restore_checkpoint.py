"""Copy the committed checkpoints of a task back under the log root, so
that ``train --resume`` (which scans ``<log_root>/<task>/<run>/model_*.pt``)
finds them (port of ``tools/restore_checkpoint.sh``; the inverse of
``scripts/sync_checkpoint.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.restore_checkpoint [task]   # default t1_dh_stand

Copies ``<ckpt_root>/<task>/`` (``checkpoints_torch`` by default) into
``<log_root>/<task>/`` (``logs``), never overwriting a file that is there
(``cp -n``), and lists the newest three checkpoints restored.  Exits 1
when the task has no committed directory, and when any ``model_*.pt`` in it
is slim (``utils.checkpoint.is_slim``): a full-carry resume cannot load a
slim file, ``scripts/resume_round.py`` grafts it instead.  The committed
71k walking lineage is slim, so the default call refuses.  Paths are
relative to the repository root unless absolute.  Reads the checkpoints on
the CPU and computes nothing.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys

from ..utils.checkpoint import is_slim, load
from ..utils.registry import LEGGED_GYM_ROOT


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch restore_checkpoint")
    p.add_argument("task", nargs="?", default="t1_dh_stand")
    p.add_argument("--ckpt_root", default="checkpoints_torch",
                   help="the committed root of checkpoints (default checkpoints_torch)")
    p.add_argument("--log_root", default="logs", help="where train --resume looks (default logs)")
    return p.parse_args(argv)


def _copy_unless_there(src: str, dst: str):
    if not os.path.exists(dst):
        shutil.copy2(src, dst)


def main(argv=None) -> int:
    args = get_args(argv)
    src, dst = (os.path.join(LEGGED_GYM_ROOT, r, args.task) for r in (args.ckpt_root,
                                                                      args.log_root))
    if not os.path.isdir(src):
        print(f"no committed checkpoints for {args.task} in {src}", file=sys.stderr)
        return 1
    for path in sorted(glob.glob(os.path.join(src, "*", "model_*.pt"))):
        if is_slim(load(path)):
            print(f"ERROR: {path} is a SLIM checkpoint; 'train --resume' cannot load it.  "
                  "Use scripts/resume_round.py (python -m ti5_isaacgym_tpu_torch.scripts."
                  "resume_round), which grafts it through scripts/resume_migrate.py, instead.",
                  file=sys.stderr)
            return 1
    shutil.copytree(src, dst, copy_function=_copy_unless_there, dirs_exist_ok=True)
    print("restored:")
    models = glob.glob(os.path.join(dst, "*", "model_*.pt"))
    for path in sorted(models, key=os.path.getmtime, reverse=True)[:3]:
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
