"""Resume training from a slim (or any) checkpoint by grafting it onto a
fresh carry (port of ``tools/resume_migrate.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.resume_migrate \\
        --ckpt checkpoints_torch/t1_dh_stand/<run>/model_71000.pt \\
        --num_envs 4096 --iters 170000 --log_dir logs/t1_dh_stand/<new_run>

Builds ``--task`` at ``--num_envs`` and a runner seeded from ``--seed`` (the
task's training seed by default), overlays every field the checkpoint holds
onto the runner's fresh carry (``utils.checkpoint.graft``: the train state,
the curriculum fields, the run's generator where the checkpoint has one;
the rest stays fresh; a field of another shape raises), restarts the
episodes on the restored terrain tiles when the checkpoint is slim
(``utils.checkpoint.restart_episodes``; JAX's tool leaves the robots on the
fresh carry's tiles), continues the iteration count from the checkpoint's
and trains ``--iters`` iterations,
writing ``model_<it>.pt`` into ``--log_dir`` when one is given.  Runs on
``cuda`` unless ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse

from ..algo.runner import OnPolicyRunner
from ..utils.checkpoint import graft, is_slim, load, restart_episodes
from ..utils.config import update_cfg_from_args
from ..utils.device import resolve_device
from ..utils.registry import task_registry


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch resume_migrate")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--task", type=str, default="t1_dh_stand")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--iters", type=int, default=170000)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=None,
                   help="the fresh carry's seed (default: the task's training seed)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def migrate(args):
    """(runner, carry): the runner of ``args`` and its fresh carry with the
    checkpoint grafted on (and, from a slim checkpoint, its episodes
    restarted on the restored tiles); the runner's iteration count is the
    checkpoint's."""
    dev = resolve_device(args.device)
    env, env_cfg = task_registry.make_env(args.task, args, device=dev)
    _, train_cfg = update_cfg_from_args(None, task_registry.get_cfgs(args.task)[1], args)
    runner = OnPolicyRunner(env, env_cfg, train_cfg, log_dir=args.log_dir)
    saved = load(args.ckpt)
    carry = graft(runner.init_carry(), saved)
    if is_slim(saved):
        carry = restart_episodes(env, carry)
    runner.iteration_count = int(saved["iteration"])
    print(f"migrated resume from {args.ckpt} at iteration {runner.iteration_count}"
          + ("" if "rng" in saved else f" (no generator state in it: the run's is seeded "
                                       f"from seed {runner.seed})"), flush=True)
    return runner, carry


def main(argv=None):
    args = get_args(argv)
    runner, carry = migrate(args)
    runner.learn(args.iters, carry=carry, log_every=args.log_every)
    return runner


if __name__ == "__main__":
    main()
