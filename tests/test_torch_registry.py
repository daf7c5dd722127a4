"""The port's task registry against the JAX package's.

The registered tasks, their env classes' names and their configs equal
JAX's field by field (``utils/config.to_dict``); ``resolve_load_path``
follows the rules of ``tests/test_runner.py:172-189`` with the port's
``model_<N>.pt`` checkpoint files, skips in-flight ``.tmp`` saves,
directories and names that are no checkpoint, and honours an explicit run
and checkpoint.
"""
import os
import time

import pytest

from ti5_isaacgym_tpu.utils import config as jconfig
from ti5_isaacgym_tpu.utils.registry import task_registry as jregistry
from ti5_isaacgym_tpu_torch.utils import config
from ti5_isaacgym_tpu_torch.utils.registry import (checkpoints_in, resolve_load_path,
                                                   task_registry)


def test_registered_tasks_match_jax():
    assert task_registry.task_names() == jregistry.task_names() == \
        ["k1_dh_stand", "t1_dh_stand", "t1_flat"]


@pytest.mark.parametrize("task", ["t1_dh_stand", "t1_flat", "k1_dh_stand"])
def test_task_configs_match_jax(task):
    env_cfg, train_cfg = task_registry.get_cfgs(task)
    jenv_cfg, jtrain_cfg = jregistry.get_cfgs(task)
    assert config.to_dict(env_cfg) == jconfig.to_dict(jenv_cfg)
    assert config.to_dict(train_cfg) == jconfig.to_dict(jtrain_cfg)
    assert task_registry._get(task)[0].__name__ == jregistry._get(task)[0].__name__


def test_flat_and_k1_configs():
    flat, _ = task_registry.get_cfgs("t1_flat")
    assert flat.env.num_envs == 1024 and flat.terrain.mesh_type == "plane"
    dr = flat.domain_rand
    assert not (dr.add_lag or dr.add_dof_lag or dr.add_imu_lag or dr.randomize_friction
                or dr.randomize_torque or flat.noise.add_noise)
    k1, k1_train = task_registry.get_cfgs("k1_dh_stand")
    assert k1.asset.model_spec == "k1_model.json" and k1.init_state.pos[2] == 1.12
    assert k1_train.runner.experiment_name == "k1_dh_stand"


def test_unknown_task_lists_the_registered_ones():
    with pytest.raises(KeyError, match="k1_dh_stand, t1_dh_stand, t1_flat"):
        task_registry.get_cfgs("nope")


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"x")


def test_resolve_load_path_prefers_newest_run_with_checkpoints(tmp_path):
    """As tests/test_runner.py:172-189, with ``.pt`` files: a fresh empty run
    does not shadow the run to resume, and runs are ordered by mtime (month
    tokens sort wrongly across months)."""
    _touch(tmp_path / "Dec30_23-59-59_old" / "model_100.pt")
    time.sleep(0.02)
    _touch(tmp_path / "Aug21_00-00-00_new" / "model_7.pt")
    time.sleep(0.02)
    (tmp_path / "Aug21_00-00-01_fresh_empty").mkdir()
    got = resolve_load_path(str(tmp_path))
    assert got == str(tmp_path / "Aug21_00-00-00_new" / "model_7.pt")
    assert resolve_load_path(str(tmp_path), "Dec30_23-59-59_old") == \
        str(tmp_path / "Dec30_23-59-59_old" / "model_100.pt")
    assert resolve_load_path(str(tmp_path), "Aug21_00-00-01_fresh_empty") is None
    assert resolve_load_path(str(tmp_path / "missing")) is None


def test_resolve_load_path_skips_what_is_no_checkpoint(tmp_path):
    """In-flight ``model_9.pt.tmp``, a directory ``model_x``, a file
    ``model_x.pt`` and a directory ``model_12.pt`` are no checkpoints: the
    newest is ``model_10.pt`` (by number, not by name), and a run that holds
    nothing else counts as empty."""
    run = tmp_path / "Oct01_00-00-00_a"
    for name in ("model_2.pt", "model_10.pt", "model_9.pt.tmp", "model_x.pt", "notes.txt"):
        _touch(run / name)
    (run / "model_x").mkdir()
    (run / "model_12.pt").mkdir()
    assert checkpoints_in(str(run)) == ["model_2.pt", "model_10.pt"]
    assert resolve_load_path(str(tmp_path)) == str(run / "model_10.pt")
    time.sleep(0.02)
    _touch(tmp_path / "Oct01_00-00-01_b" / "model_9.pt.tmp")
    assert resolve_load_path(str(tmp_path)) == str(run / "model_10.pt")


def test_resolve_load_path_explicit_run_and_checkpoint(tmp_path):
    _touch(tmp_path / "r1" / "model_3.pt")
    _touch(tmp_path / "r1" / "model_5.pt")
    time.sleep(0.02)
    _touch(tmp_path / "r2" / "model_1.pt")
    assert resolve_load_path(str(tmp_path)) == str(tmp_path / "r2" / "model_1.pt")
    assert resolve_load_path(str(tmp_path), "r1") == str(tmp_path / "r1" / "model_5.pt")
    assert resolve_load_path(str(tmp_path), "r1", 3) == str(tmp_path / "r1" / "model_3.pt")
    assert resolve_load_path(str(tmp_path), -1, "-1") == str(tmp_path / "r2" / "model_1.pt")
    assert resolve_load_path(str(tmp_path), "nope") is None


def test_make_env_and_runner_on_cpu(tmp_path):
    """``make_env`` / ``make_alg_runner`` with a device: the runner sits on
    the env's device, another device raises, and ``--resume`` leaves the
    resolved path (None when there is none) in ``runner.resume_path``."""
    from ti5_isaacgym_tpu_torch.utils.helpers import get_args

    args = get_args(["--task", "t1_flat", "--num_envs", "4", "--device", "cpu", "--resume"])
    env, env_cfg = task_registry.make_env("t1_flat", args, device="cpu")
    assert env.num_envs == 4 and env.device.type == "cpu" and env.terrain is None
    runner, train_cfg = task_registry.make_alg_runner(env, "t1_flat", args,
                                                      log_root=str(tmp_path), device="cpu")
    assert runner.device == env.device and train_cfg.runner.resume
    assert runner.resume_path is None and runner.log_dir.startswith(str(tmp_path))
    with pytest.raises(ValueError, match="device"):
        task_registry.make_alg_runner(env, "t1_flat", args, log_root=str(tmp_path),
                                      device="meta")
