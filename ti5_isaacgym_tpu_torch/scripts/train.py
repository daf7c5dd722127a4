"""Training entry point (port of ``ti5_isaacgym_tpu/scripts/train.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.train --task t1_dh_stand --num_envs 8192
    python -m ti5_isaacgym_tpu_torch.scripts.train --device cpu --task k1_dh_stand \\
        --num_envs 16 --max_iterations 2 --log_root /tmp/x
    python -m ti5_isaacgym_tpu_torch.scripts.train ... --resume --max_iterations 1
    python -m ti5_isaacgym_tpu_torch.scripts.train --n_devices 4 --num_envs 32768
    python -m ti5_isaacgym_tpu_torch.scripts.train --n_devices 8 --num_processes 2 \
        --process_id 0 --coordinator host0:29500 ...      (and --process_id 1 on host1)

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

Data parallelism (``--n_devices N`` > 1, or ``--coordinator``): N ranks, one
process and one device each, train ``--num_envs`` envs split evenly between
them (:mod:`..parallel.trainer`).  One host starts its N ranks itself
(``spawn``, rendezvous in a temporary file); with ``--num_processes P``
each host starts N/P ranks on ``cuda:0..N/P-1`` and process 0 serves the
rendezvous store at ``--coordinator``.  NCCL links ranks on cards, gloo
ranks on the CPU; more ranks on a host than it has cards raises.  The
kernel is built once, before any rank starts.  Only rank 0 prints metric
rows and writes ``config.json``, the CSV, TensorBoard and checkpoints,
which hold the learning state only; ``--resume`` restores that state on
every rank onto a fresh env state, from the checkpoint the lead resolves
under its ``--log_root`` (a filesystem every host reads; a rank that
cannot read the file fails all ranks).
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from ..parallel.trainer import (DEFAULT_TIMEOUT_S, ShardedRunner, failing_ranks, run_rank,
                                spawn_local)
from ..utils.device import resolve_device
from ..utils.helpers import get_args, set_seed
from ..utils.registry import task_registry
from .record_config import record_config


def profile_iterations(runner, carry, trace_dir: str, iterations: int = 3):
    """``iterations`` training iterations under ``torch.profiler``; the
    Chrome trace goes to ``trace_dir/trace.json.gz`` (gzip: a step launches
    thousands of small ops, so the trace is large).  Returns the carry."""
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


def train(args, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Train as ``args`` say: the runner of a single-process run, or under
    data parallelism each of this host's ranks' ``{"rank", "log_dir",
    "iteration"}``.  ``timeout_s`` bounds the ranks' rendezvous and each
    collective (how long a rank waits for the others), not the run."""
    os.environ.setdefault("TI5_VERBOSE", "1")   # bring-up prints on for the CLI
    procs = args.num_processes or 1
    n_devices = args.n_devices or procs
    if n_devices == 1 and args.coordinator is None:
        return train_process(args, resolve_device(args.device))
    local = n_devices // procs
    first = (args.process_id or 0) * local
    if torch.device(args.device).type == "cuda":
        have = torch.cuda.device_count()
        if local > have:
            raise ValueError(f"--n_devices {n_devices} over {procs} process(es) puts {local} "
                             f"ranks on this host, which has {have} CUDA device(s): one rank "
                             "per card")
        from ..physics import megakernel

        megakernel.build()          # once, before any rank loads it
        devices, backend = [f"cuda:{i}" for i in range(local)], "nccl"
    else:
        devices, backend = ["cpu"] * local, "gloo"
    if local == 1 and args.coordinator is not None:
        return [run_rank(_train_rank, first, n_devices, devices[0], backend, (args,),
                         coordinator=args.coordinator, timeout_s=timeout_s)]
    return spawn_local(_train_rank, devices, backend, (args,), world_size=n_devices,
                       rank_offset=first, coordinator=args.coordinator, timeout_s=timeout_s)


def _train_rank(rank, device, args):
    runner = train_process(args, torch.device(device), data_parallel=True)
    return {"rank": rank, "log_dir": runner.log_dir, "iteration": runner.iteration_count}


def train_process(args, device, data_parallel: bool = False):
    """Train in this process: alone, or as one rank of the process group."""
    lead = not data_parallel or dist.get_rank() == 0
    t0 = time.time()
    if lead:
        print(f"[train] building {args.task} env/runner on {device} (t=0.0s)", flush=True)
    env, env_cfg = task_registry.make_env(args.task, args, device=device)
    runner, train_cfg = task_registry.make_alg_runner(env, args.task, args,
                                                      log_root=args.log_root)
    # under data parallelism every rank has the lead's answer, so all raise
    # together
    if train_cfg.runner.resume and runner.resume_path is None:
        raise FileNotFoundError(
            f"--resume: no checkpoint under {os.path.dirname(runner.log_dir)} "
            f"(load_run {train_cfg.runner.load_run}, checkpoint {train_cfg.runner.checkpoint})")
    if data_parallel and runner.resume_path is not None:
        unreadable = failing_ranks("resume_readable", os.access(runner.resume_path, os.R_OK))
        if unreadable:
            raise FileNotFoundError(
                f"--resume: rank(s) {unreadable} cannot read the lead's checkpoint "
                f"{runner.resume_path}; every rank loads the file the lead resolved under its "
                "--log_root, so that must be a filesystem all hosts share")
    set_seed(train_cfg.seed)
    trainer = ShardedRunner(runner) if data_parallel else runner
    if lead:
        record_config(runner.log_dir, env_cfg, train_cfg)
        print(f"[train] env/runner ready (t={time.time() - t0:.1f}s), logging to "
              f"{runner.log_dir}" + (f"; rank 0 of {trainer.world_size}, {trainer.num_envs} "
                                     f"envs per rank" if data_parallel else ""), flush=True)
    # a single process restores the full carry (the checkpoint's env count);
    # data parallelism the learning state on a fresh env state
    carry = trainer.load(runner.resume_path) if runner.resume_path else None
    n_iter = train_cfg.runner.max_iterations
    if args.profile:
        carry = trainer.learn(2, carry=carry, log_every=1)
        carry = (profile_iterations(runner, carry, args.profile) if lead
                 else trainer.learn(3, carry=carry, log_every=1))
        n_iter = max(n_iter - 5, 0)
    trainer.learn(n_iter, carry=carry, log_every=args.log_every)
    return runner


def main(argv=None):
    return train(get_args(argv))


if __name__ == "__main__":
    main()
