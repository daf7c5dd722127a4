"""A port script with the registered tasks cut to a 2x2 terrain and 4 steps
per env, for the lifecycle tests (``tests/test_torch_checkpoint.py``,
``tests/test_torch_lifecycle.py``) that start runs as processes:

    python tests/torch_cut_cli.py train --device cpu --num_envs 16 ...
    python tests/torch_cut_cli.py resume_migrate --device cpu --ckpt ... --num_envs 8

runs ``ti5_isaacgym_tpu_torch.scripts.<name>.main`` on the remaining
arguments.  :func:`entry` is the ``entry`` argument of
``scripts/resume_round.main`` and ``scripts/seed_probe.main``.  Imports no
JAX.
"""
import dataclasses
import importlib
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from ti5_isaacgym_tpu_torch.utils.registry import task_registry  # noqa: E402


def cut_tasks(registry=task_registry):
    """Register every task again with a 2x2 terrain and 4 steps per env."""
    for name in registry.task_names():
        cls, env_cfg, train_cfg = registry._get(name)
        registry.register(
            name, cls,
            dataclasses.replace(env_cfg, terrain=dataclasses.replace(
                env_cfg.terrain, num_rows=2, num_cols=2, border_size=2.0)),
            dataclasses.replace(train_cfg, runner=dataclasses.replace(
                train_cfg.runner, num_steps_per_env=4)))


def patch_registry(monkeypatch, registry=task_registry):
    """Cut every task of ``registry`` for the duration of a test."""
    from ti5_isaacgym_tpu_torch.utils.registry import TaskRegistry

    cut = TaskRegistry()
    for name in registry.task_names():
        cut.register(name, *registry._get(name))
    cut_tasks(cut)
    for name in cut.task_names():
        monkeypatch.setitem(registry._tasks, name, cut._get(name))


def entry(module: str) -> list:
    return [sys.executable, os.path.abspath(__file__), module]


if __name__ == "__main__":
    cut_tasks()
    importlib.import_module(f"ti5_isaacgym_tpu_torch.scripts.{sys.argv[1]}").main(sys.argv[2:])
