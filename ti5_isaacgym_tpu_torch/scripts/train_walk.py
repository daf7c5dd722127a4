"""One-command reproduction of the walking recipe (port of
``tools/train_walk.sh``): the round-3 phase schedule.

    python -m ti5_isaacgym_tpu_torch.scripts.train_walk            # the full recipe on the card
    SMOKE=1 python -m ti5_isaacgym_tpu_torch.scripts.train_walk --device cpu

* phase A, the gait bootstrap: a fresh policy trained through
  ``scripts/train.py`` with the reference's ref-action overlay on
  (``--use_ref_actions 1``) and boosted stepping shaping
  (:data:`SHAPING`), so that stepping is the policy's experience from
  iteration 0;
* the newest phase-A checkpoint with its exploration std reheated to
  ``STD`` (``scripts/reheat_std.py``), written beside it as
  ``reheated_model_<it>.pt``;
* phase B, internalization: ``scripts/resume_migrate.py`` from the reheated
  file with the overlay off and the reference's reward scales.

Knobs from the environment, as the shell recipe takes them: ``TASK``
(t1_dh_stand), ``NUM_ENVS`` (4096), ``P1_ITERS`` (18000), ``P2_ITERS``
(80000), ``STD`` (0.4), ``LOG_EVERY`` (100); ``SMOKE=1`` sets 16 envs, 3
iterations per phase and ``LOG_EVERY=1``: the mechanics (train ->
checkpoint -> reheat -> resume) end to end in minutes.  Runs on ``cuda``
unless ``--device cpu``; without a card it raises.  Runs go under
``--log_root`` (``logs/<task>`` by default).
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from datetime import datetime

from ..utils.device import resolve_device
from ..utils.registry import checkpoints_in, task_registry
from . import reheat_std, resume_migrate, train

SHAPING = "feet_air_time=8.0,feet_clearance=4.0,feet_contact_number=2.4"


@dataclass(frozen=True)
class Knobs:
    task: str
    num_envs: int
    p1_iters: int
    p2_iters: int
    std: float
    log_every: int
    device: str
    log_root: str


def knobs(argv=None, environ=os.environ) -> Knobs:
    p = argparse.ArgumentParser("ti5 torch train_walk")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--log_root", type=str, default=None,
                   help="where both phases' runs go (default logs/<task>)")
    args = p.parse_args(argv)
    task = environ.get("TASK", "t1_dh_stand")
    k = dict(num_envs=int(environ.get("NUM_ENVS", 4096)),
             p1_iters=int(environ.get("P1_ITERS", 18000)),
             p2_iters=int(environ.get("P2_ITERS", 80000)),
             log_every=int(environ.get("LOG_EVERY", 100)))
    if environ.get("SMOKE", "0") == "1":
        k = dict(num_envs=16, p1_iters=3, p2_iters=3, log_every=1)
    return Knobs(task=task, std=float(environ.get("STD", 0.4)), device=args.device,
                 log_root=args.log_root or task_registry.log_root(task), **k)


def phase_a_argv(k: Knobs) -> list:
    return ["--task", k.task, "--num_envs", str(k.num_envs), "--max_iterations",
            str(k.p1_iters), "--run_name", "walkA", "--log_every", str(k.log_every),
            "--use_ref_actions", "1", "--reward_scales", SHAPING, "--device", k.device,
            "--log_root", k.log_root]


def phase_b_argv(k: Knobs, reheated: str, log_dir: str) -> list:
    return ["--ckpt", reheated, "--task", k.task, "--num_envs", str(k.num_envs), "--iters",
            str(k.p2_iters), "--log_dir", log_dir, "--log_every", str(k.log_every),
            "--device", k.device]


def newest_in(run_dir: str) -> str:
    models = checkpoints_in(run_dir)
    if not models:
        raise FileNotFoundError(f"phase A wrote no checkpoint into {run_dir}")
    return os.path.join(run_dir, models[-1])


def reheated_path(ckpt: str) -> str:
    return os.path.join(os.path.dirname(ckpt), "reheated_" + os.path.basename(ckpt))


def main(argv=None) -> dict:
    k = knobs(argv)
    resolve_device(k.device)
    print(f"== phase A: gait bootstrap (overlay + shaping, {k.p1_iters} iters) ==", flush=True)
    ckpt = newest_in(train.main(phase_a_argv(k)).log_dir)
    print(f"== phase A checkpoint: {ckpt} ==", flush=True)
    reheated = reheat_std.main([ckpt, reheated_path(ckpt), "--std", str(k.std),
                                "--device", k.device])
    print(f"== std reheated to {k.std}: {reheated} ==", flush=True)
    print(f"== phase B: internalization (reference scales, overlay off, {k.p2_iters} "
          "iters) ==", flush=True)
    log_dir = os.path.join(k.log_root, datetime.now().strftime("%b%d_%H-%M-%S") + "_walkB")
    runner = resume_migrate.main(phase_b_argv(k, reheated, log_dir))
    print(f"== done: {log_dir} ==", flush=True)
    return {"phase_a": ckpt, "reheated": reheated, "phase_b": runner}


if __name__ == "__main__":
    main()
