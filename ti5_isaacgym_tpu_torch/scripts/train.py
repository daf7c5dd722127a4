"""Training entry point (port of ``ti5_isaacgym_tpu/scripts/train.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.train --task t1_dh_stand --num_envs 8192
    python -m ti5_isaacgym_tpu_torch.scripts.train --device cpu --task k1_dh_stand \\
        --num_envs 16 --max_iterations 2 --log_root /tmp/x
    python -m ti5_isaacgym_tpu_torch.scripts.train ... --resume --max_iterations 1

Builds any registered ``--task`` and its :class:`~..algo.runner.OnPolicyRunner`
through the task registry, writes ``config.json`` into the run's log dir
(``<log_root>/<stamp>_<run_name>``, ``log_root`` by default
``logs/<experiment_name>`` in the repo), and trains ``max_iterations``
iterations with ``metrics.csv``, TensorBoard where it is installed, and
``model_<iteration>.pt`` checkpoints.

``--resume`` continues from the newest checkpoint under ``log_root`` (or the
one ``--load_run`` / ``--checkpoint`` name) with its full carry: params,
optimizer state, env state and generators, so that a resumed run repeats
the straight one bit for bit.  The checkpoint's env count must equal
``--num_envs``.  ``--profile DIR`` runs two warm iterations, writes a
``torch.profiler`` trace (CPU and, on a card, CUDA activity) of the next
three to ``DIR/trace.json.gz``, then runs the remaining ``max_iterations - 5``.
Runs on ``cuda`` unless ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import os
import time

from ..utils.device import resolve_device
from ..utils.helpers import get_args, set_seed
from ..utils.registry import task_registry
from .record_config import record_config


def profile_iterations(runner, carry, trace_dir: str, iterations: int = 3):
    """``iterations`` training iterations under ``torch.profiler``; the
    Chrome trace goes to ``trace_dir/trace.json.gz`` (gzip: a step launches
    thousands of small ops, so the trace is large).  Returns the carry."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        carry = runner.learn(iterations, carry=carry, log_every=1)
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json.gz")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)
    return carry


def train(args):
    os.environ.setdefault("TI5_VERBOSE", "1")   # bring-up prints on for the CLI
    device = resolve_device(args.device)
    t0 = time.time()
    print(f"[train] building {args.task} env/runner on {device} (t=0.0s)", flush=True)
    env, env_cfg = task_registry.make_env(args.task, args, device=device)
    runner, train_cfg = task_registry.make_alg_runner(env, args.task, args,
                                                      log_root=args.log_root)
    if train_cfg.runner.resume and runner.resume_path is None:
        raise FileNotFoundError(
            f"--resume: no checkpoint under {os.path.dirname(runner.log_dir)} "
            f"(load_run {train_cfg.runner.load_run}, checkpoint {train_cfg.runner.checkpoint})")
    set_seed(train_cfg.seed)
    record_config(runner.log_dir, env_cfg, train_cfg)
    print(f"[train] env/runner ready (t={time.time() - t0:.1f}s), logging to {runner.log_dir}",
          flush=True)
    # a full restore: the checkpoint's env count must be this env's
    carry = runner.load(runner.resume_path) if runner.resume_path else None
    n_iter = train_cfg.runner.max_iterations
    if args.profile:
        carry = runner.learn(2, carry=carry, log_every=1)
        carry = profile_iterations(runner, carry, args.profile)
        n_iter = max(n_iter - 5, 0)
    runner.learn(n_iter, carry=carry, log_every=args.log_every)
    return runner


def main(argv=None):
    return train(get_args(argv))


if __name__ == "__main__":
    main()
