"""Seed probe for reference-config walking (port of ``tools/seed_probe.sh``).

    python -m ti5_isaacgym_tpu_torch.scripts.seed_probe [seed ...]     # default 21-26

Under the shipped config the walking optimum is reached in about 1 of 4
fresh runs, and the outcome is readable early from the feet-air-time
episode reward (a walker ~9e-4 at iteration 500 rising to 3e-3 by 3k; a
shuffle ~2e-4 and falling).  For each seed this starts a fresh
``t1_dh_stand`` run (``scripts/train.py``, run name ``probe_s<seed>``) in
the background, polls its ``metrics.csv`` until ``PROBE_ITERS``, takes the
mean ``rew_feet_air_time`` over the last 500 iterations up to it, and
leaves the first run above ``THRESH`` training (its pid in
``<log_root>/train_probe_s<seed>.pid``; slim it later with
``scripts/sync_checkpoint.py``), ending the others.  A run that dies is
reported and skipped.  Exit code 1 when no seed walks.

Knobs from the environment: ``NUM_ENVS`` (4096), ``PROBE_ITERS`` (1500),
``THRESH`` (5e-4).  Runs on ``cuda`` unless ``--device cpu``; without a card
it raises.  Runs and console logs go under ``--log_root`` (``logs/t1_dh_stand``).
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import subprocess
import sys
import time
from datetime import datetime

from ..utils.device import resolve_device
from ..utils.registry import LEGGED_GYM_ROOT, task_registry
from .resume_round import entry

TASK = "t1_dh_stand"
WINDOW = 500       # iterations averaged up to PROBE_ITERS


def air_time(csv_path: str, probe_iters: int) -> float:
    """Mean ``rew_feet_air_time`` over the rows with iteration in
    ``[probe_iters - WINDOW, probe_iters]``."""
    with open(csv_path) as f:
        win = [float(r["rew_feet_air_time"]) for r in csv.DictReader(f)
               if probe_iters - WINDOW <= int(r["iteration"]) <= probe_iters]
    return sum(win) / max(len(win), 1)


def last_iteration(csv_path: str) -> int:
    if not os.path.exists(csv_path):
        return -1
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    return int(rows[-1]["iteration"]) if rows else -1


def end(proc: subprocess.Popen, timeout: float = 30.0):
    proc.terminate()
    try:
        proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def probe(seeds, num_envs: int, probe_iters: int, thresh: float, device: str,
          log_root: str, poll_s: float = 30.0, entry=entry):
    """(seed, process) of the first walking seed, or None.  ``entry(module)``
    is the command of a port script (tests cut the task through it)."""
    os.makedirs(log_root, exist_ok=True)
    for seed in seeds:
        run = f"probe_s{seed}"
        print(f"== probing seed {seed} ==", flush=True)
        started = datetime.now().timestamp()
        console_path = os.path.join(log_root, f"train_{run}.console")
        with open(console_path, "w") as console:
            proc = subprocess.Popen(
                entry("train") + ["--task", TASK, "--num_envs", str(num_envs),
                                  "--max_iterations", "400000", "--seed", str(seed),
                                  "--run_name", run, "--log_every", "100", "--device", device,
                                  "--log_root", log_root],
                stdout=console, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                cwd=LEGGED_GYM_ROOT, start_new_session=True)
        print(f"pid {proc.pid}", flush=True)
        csv_path = None
        while proc.poll() is None:
            time.sleep(poll_s)
            runs = [d for d in glob.glob(os.path.join(log_root, f"*_{run}"))
                    if os.path.getmtime(d) >= started - 1]
            csv_path = os.path.join(max(runs, key=os.path.getmtime), "metrics.csv") \
                if runs else None
            if csv_path and last_iteration(csv_path) >= probe_iters:
                break
        if proc.poll() is not None:
            print(f"seed {seed}: process died (rc {proc.returncode}); see {console_path}",
                  flush=True)
            continue
        value = air_time(csv_path, probe_iters)
        print(f"seed {seed}: feet_air_time(mean it {probe_iters - WINDOW}-{probe_iters}) = "
              f"{value}", flush=True)
        if value > thresh:
            print(f"seed {seed} WALKS — leaving it training (pid {proc.pid})", flush=True)
            with open(os.path.join(log_root, f"train_{run}.pid"), "w") as f:
                f.write(f"pid: {proc.pid}\n")
            return seed, proc
        print(f"seed {seed} shuffles — ending it", flush=True)
        end(proc)
    print(f"no walking seed found in: {' '.join(str(s) for s in seeds)}", flush=True)
    return None


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch seed_probe")
    p.add_argument("seeds", nargs="*", type=int, default=[21, 22, 23, 24, 25, 26])
    p.add_argument("--log_root", type=str, default=None,
                   help="runs and console logs (default logs/t1_dh_stand)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None, environ=os.environ, poll_s: float = 30.0, entry=entry) -> int:
    args = get_args(argv)
    resolve_device(args.device)
    found = probe(args.seeds, int(environ.get("NUM_ENVS", 4096)),
                  int(environ.get("PROBE_ITERS", 1500)), float(environ.get("THRESH", 5e-4)),
                  args.device, args.log_root or task_registry.log_root(TASK), poll_s, entry)
    return 0 if found is not None else 1


if __name__ == "__main__":
    sys.exit(main())
