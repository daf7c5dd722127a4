"""Task registry (port of ``ti5_isaacgym_tpu/utils/registry.py``).

Maps a task name to (env class, env cfg, train cfg) and provides the
``make_env`` / ``make_alg_runner`` factories the CLI scripts consume, and
:func:`resolve_load_path`, which finds the checkpoint a resume, a play or an
export reads.  Built-in tasks: ``t1_dh_stand``, ``t1_flat`` (1024 envs,
plane terrain, no domain randomization, lag or noise) and ``k1_dh_stand``.

Run directories are ``<log_root>/<%b%d_%H-%M-%S>_<run_name>``: two runs
started in the same second with the same ``run_name`` share one, so code
that starts runs back to back passes distinct run names.  Under data
parallelism the stamp is the lead rank's, shared through the process
group's store.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import datetime
from typing import Callable, Dict, Optional, Tuple

import torch

from ..algo.runner import OnPolicyRunner
from ..configs.k1_dh_stand import k1_env_cfg, k1_train_cfg
from ..configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
from ..envs.t1_dh_stand import T1DHStandEnv
from ..parallel.trainer import lead_value
from .config import update_cfg_from_args

LEGGED_GYM_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


class TaskRegistry:
    def __init__(self):
        self._tasks: Dict[str, Tuple[Callable, object, object]] = {}

    def register(self, name: str, env_class, env_cfg, train_cfg):
        self._tasks[name] = (env_class, env_cfg, train_cfg)

    def _get(self, name: str):
        if name not in self._tasks:
            raise KeyError(
                f"unknown task {name!r}; registered tasks: {', '.join(self.task_names())}")
        return self._tasks[name]

    def get_cfgs(self, name: str):
        _, env_cfg, train_cfg = self._get(name)
        return env_cfg, train_cfg

    def task_names(self):
        return sorted(self._tasks)

    def log_root(self, name: str, train_cfg=None) -> str:
        """The default log root of a task: ``logs/<experiment_name>`` in the repo."""
        if train_cfg is None:
            train_cfg = self._get(name)[2]
        return os.path.join(LEGGED_GYM_ROOT, "logs", train_cfg.runner.experiment_name)

    def make_env(self, name: str, args=None, env_cfg=None, device="cuda"):
        """(env, env cfg): the task's env with the CLI overlay of ``args``
        on ``device``, seeded from ``args.seed`` or the train cfg's seed."""
        env_class, default_cfg, train_cfg = self._get(name)
        if env_cfg is None:
            env_cfg = default_cfg
        env_cfg, _ = update_cfg_from_args(env_cfg, train_cfg, args)
        seed = getattr(args, "seed", None)
        env = env_class(env_cfg, seed=seed if seed is not None else train_cfg.seed,
                        device=device)
        return env, env_cfg

    def make_alg_runner(self, env, name: str, args=None, train_cfg=None,
                        log_root: Optional[str] = None, device=None):
        """(runner, train cfg) for ``env``, logging to a new run directory
        under ``log_root``.  The runner lives on the env's device; a
        ``device`` other than it raises.  With ``runner.resume`` set, the
        checkpoint to resume from is resolved here (by the lead rank, for
        all ranks) and left in ``runner.resume_path`` (None when there is
        none)."""
        _, env_cfg_default, default_train = self._get(name)
        if device is not None and torch.device(device).type != env.device.type:
            raise ValueError(f"runner device {device} differs from the env's {env.device}")
        if train_cfg is None:
            train_cfg = default_train
        _, train_cfg = update_cfg_from_args(None, train_cfg, args)
        env_cfg = getattr(env, "cfg", env_cfg_default)
        if log_root is None:
            log_root = self.log_root(name, train_cfg)
        # under data parallelism every rank takes the lead rank's stamp, so
        # that all agree on the run directory
        stamp = lead_value("run_stamp", datetime.now().strftime("%b%d_%H-%M-%S"))
        log_dir = os.path.join(log_root, stamp + "_" + train_cfg.runner.run_name)
        runner = OnPolicyRunner(env, env_cfg, train_cfg, log_dir=log_dir)
        runner.resume_path = None
        if train_cfg.runner.resume:
            # under data parallelism the lead resolves the checkpoint under
            # its log root, and every rank takes that path
            path = (resolve_load_path(log_root, train_cfg.runner.load_run,
                                      train_cfg.runner.checkpoint) if runner.is_lead else None)
            runner.resume_path = lead_value("resume_path", path or "") or None
            if runner.resume_path and runner.is_lead:
                print(f"resuming from {runner.resume_path}", flush=True)
        return runner, train_cfg


def checkpoints_in(run_dir: str):
    """The completed ``model_<N>.pt`` checkpoints of a run directory, by N.
    In-flight saves (``model_<N>.pt.tmp``), directories and names whose N is
    not an integer are skipped."""
    named = []
    for name in os.listdir(run_dir):
        stem, ext = os.path.splitext(name)
        if not (name.startswith("model_") and ext == ".pt"
                and os.path.isfile(os.path.join(run_dir, name))):
            continue
        try:
            named.append((int(stem.split("_", 1)[1]), name))
        except ValueError:
            continue
    return [name for _, name in sorted(named)]


def resolve_load_path(root: str, load_run=-1, checkpoint=-1) -> Optional[str]:
    """The checkpoint to load under ``root``: ``model_<checkpoint>.pt`` (by
    default the newest) of run ``load_run`` (by default the newest run, by
    mtime, that holds a checkpoint, so that the caller's own fresh run
    directory does not shadow the run to resume).  None when there is none."""
    if not os.path.isdir(root):
        return None
    # newest by mtime: run directories are named by a month token (Aug21_...)
    # that sorts wrongly across months
    runs = sorted((d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))),
                  key=lambda d: os.path.getmtime(os.path.join(root, d)))
    if load_run in (-1, "-1", None):
        run_dir = next((os.path.join(root, r) for r in reversed(runs)
                        if checkpoints_in(os.path.join(root, r))), None)
        if run_dir is None:
            return None
    else:
        run_dir = os.path.join(root, str(load_run))
        if not os.path.isdir(run_dir):
            return None
    models = checkpoints_in(run_dir)
    if not models:
        return None
    model = models[-1] if checkpoint in (-1, "-1", None) else f"model_{checkpoint}.pt"
    return os.path.join(run_dir, model)


def t1_flat_env_cfg() -> T1EnvCfg:
    """Flat T1: 1024 envs, plane terrain, no domain randomization, lag or
    observation noise."""
    base = T1EnvCfg()
    return dataclasses.replace(
        base,
        env=dataclasses.replace(base.env, num_envs=1024),
        terrain=dataclasses.replace(base.terrain, mesh_type="plane", curriculum=False),
        domain_rand=dataclasses.replace(
            base.domain_rand,
            randomize_friction=False, randomize_base_mass=False, randomize_com=False,
            randomize_link_mass=False, randomize_gains=False, randomize_torque=False,
            randomize_motor_offset=False, randomize_coulomb_friction=False,
            add_lag=False, add_dof_lag=False, add_imu_lag=False, add_ext_force=False),
        noise=dataclasses.replace(base.noise, add_noise=False),
    )


task_registry = TaskRegistry()
task_registry.register("t1_dh_stand", T1DHStandEnv, T1EnvCfg(), T1TrainCfg())
task_registry.register("t1_flat", T1DHStandEnv, t1_flat_env_cfg(), T1TrainCfg())
task_registry.register("k1_dh_stand", T1DHStandEnv, k1_env_cfg(), k1_train_cfg())
