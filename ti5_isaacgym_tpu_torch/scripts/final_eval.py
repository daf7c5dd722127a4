"""End-of-round evaluation: the deployment gate of ``scripts/eval_report.py``
on the newest run (port of ``tools/final_eval.sh``).

    python -m ti5_isaacgym_tpu_torch.scripts.final_eval [run_dir] [steps] \
        [--out build/eval_final] [--device cpu]

``run_dir`` defaults to the newest directory (by modification time) under
``<log_root>/t1_dh_stand`` and ``steps`` to 600.  Runs ``eval_report`` on it
with ``--out`` (default ``build/eval_final``, which git ignores) and
``--device`` passed on, lists what it wrote and returns its exit code.
Paths are relative to the repository root unless absolute.  ``eval_report``
needs MuJoCo, cv2 and matplotlib: a CPU host, not the card's machine.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

from ..utils.device import resolve_device
from ..utils.registry import LEGGED_GYM_ROOT
from . import eval_report

TASK = "t1_dh_stand"


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch final_eval")
    p.add_argument("run", nargs="?", default=None,
                   help="the run directory (default: the newest under <log_root>/t1_dh_stand)")
    p.add_argument("steps", nargs="?", type=int, default=600)
    p.add_argument("--log_root", default="logs")
    p.add_argument("--out", default=os.path.join("build", "eval_final"))
    p.add_argument("--device", type=str, default="cuda",
                   help="passed to eval_report: cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    resolve_device(args.device)
    runs = [d for d in glob.glob(os.path.join(LEGGED_GYM_ROOT, args.log_root, TASK, "*"))
            if os.path.isdir(d)]
    run = args.run or max(runs, key=os.path.getmtime, default=None)
    if run is None:
        print(f"no run under {os.path.join(args.log_root, TASK)}", file=sys.stderr)
        return 1
    out = os.path.join(LEGGED_GYM_ROOT, args.out)
    print(f"evaluating {run} ({args.steps} steps)", flush=True)
    try:
        eval_report.main(["--run", os.path.join(LEGGED_GYM_ROOT, run), "--out", out,
                          "--steps", str(args.steps), "--device", args.device])
        rc = 0
    except SystemExit as e:         # eval_report exits 1 when a gate failed
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    print(f"eval_report rc={rc}")
    for name in sorted(os.listdir(out)) if os.path.isdir(out) else ():
        print(f"{os.path.getsize(os.path.join(out, name)):>12}  {name}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
