"""Training entry point (port of ``ti5_isaacgym_tpu/scripts/train.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.train --num_envs 8192
    python -m ti5_isaacgym_tpu_torch.scripts.train --device cpu --num_envs 16 --max_iterations 2

Builds ``t1_dh_stand`` and an :class:`~..algo.runner.OnPolicyRunner`, writes
``config.json`` into the run's log dir (``<log_root>/<stamp>_<run_name>``,
``log_root`` by default ``logs/<experiment_name>`` in the repo), and trains
``max_iterations`` iterations with ``metrics.csv``, TensorBoard where it is
installed, and ``model_<iteration>.pt`` checkpoints.  Runs on ``cuda``
unless ``--device cpu``; without a card it raises.  ``--task`` is
``t1_dh_stand`` until the task registry is ported.
"""
from __future__ import annotations

import os
import time
from datetime import datetime

from ..algo.runner import OnPolicyRunner
from ..configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
from ..envs.t1_dh_stand import T1DHStandEnv
from ..utils.config import update_cfg_from_args
from ..utils.device import resolve_device
from ..utils.helpers import get_args, set_seed
from .record_config import record_config

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def train(args):
    os.environ.setdefault("TI5_VERBOSE", "1")   # bring-up prints on for the CLI
    if args.task != "t1_dh_stand":
        raise ValueError(f"--task {args.task!r}: only t1_dh_stand is ported "
                         "(the task registry is ROADMAP Queue 1 item 2)")
    device = resolve_device(args.device)
    env_cfg, train_cfg = update_cfg_from_args(T1EnvCfg(), T1TrainCfg(), args)
    t0 = time.time()
    print(f"[train] building env/runner on {device} (t=0.0s)", flush=True)
    env = T1DHStandEnv(env_cfg, seed=train_cfg.seed, device=device)
    log_root = args.log_root or os.path.join(REPO_ROOT, "logs",
                                             train_cfg.runner.experiment_name)
    stamp = datetime.now().strftime("%b%d_%H-%M-%S")
    log_dir = os.path.join(log_root, f"{stamp}_{train_cfg.runner.run_name}")
    runner = OnPolicyRunner(env, env_cfg, train_cfg, log_dir=log_dir)
    set_seed(train_cfg.seed)
    record_config(log_dir, env_cfg, train_cfg)
    print(f"[train] env/runner ready (t={time.time() - t0:.1f}s), logging to {log_dir}",
          flush=True)
    runner.learn(train_cfg.runner.max_iterations, log_every=args.log_every)
    return runner


def main(argv=None):
    return train(get_args(argv))


if __name__ == "__main__":
    main()
