"""The port's training CLI on the CPU, and its argument handling.

``python -m ti5_isaacgym_tpu_torch.scripts.train --device cpu --num_envs 16
--max_iterations 2`` runs the full task (20x20 terrain, 24 steps per env) to
the end and writes ``config.json``, ``metrics.csv`` and a checkpoint; every
registered ``--task`` trains (``k1_dh_stand`` and ``t1_flat`` one iteration
each); ``--resume`` continues from the newest checkpoint and repeats a
straight run bit for bit, and refuses another ``--num_envs``; ``--profile``
writes a trace; an unknown task raises; the config overlay equals the JAX
package's on the same arguments.  (The data-parallel flags are tested in
tests/test_torch_parallel.py.)  The resume
and profile tests run the registered tasks cut to a 2x2 terrain and 4 steps
per env (``small_tasks``).
"""
import csv
import dataclasses
import gzip
import json
import os

import pytest
import torch

from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg as JEnvCfg
from ti5_isaacgym_tpu.configs.t1_dh_stand import T1TrainCfg as JTrainCfg
from ti5_isaacgym_tpu.utils import config as jconfig
from ti5_isaacgym_tpu.utils import helpers as jhelpers
from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
from ti5_isaacgym_tpu_torch.scripts import train
from ti5_isaacgym_tpu_torch.utils import config, helpers
from ti5_isaacgym_tpu_torch.utils.registry import task_registry


def test_train_cli_on_cpu_writes_its_run(tmp_path):
    runner = train.main(["--device", "cpu", "--num_envs", "16", "--max_iterations", "2",
                         "--log_root", str(tmp_path), "--log_every", "1"])
    (run,) = os.listdir(tmp_path)
    files = set(os.listdir(tmp_path / run))
    assert {"config.json", "metrics.csv", "model_2.pt"} <= files
    with open(tmp_path / run / "config.json") as f:
        cfg = json.load(f)
    assert cfg["env_cfg"]["env"]["num_envs"] == 16
    assert cfg["train_cfg"]["runner"]["max_iterations"] == 2
    with open(tmp_path / run / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["iteration"] for r in rows] == ["1", "2"]
    assert runner.iteration_count == 2 and runner.device.type == "cpu"
    sd = torch.load(tmp_path / run / "model_2.pt", map_location="cpu", weights_only=True)
    assert sd["iteration"] == 2


def test_train_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal only happens without one")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--num_envs", "16", "--max_iterations", "1", "--log_root", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_unported_task_raises(tmp_path):
    """An unknown task raises a KeyError that lists the registered ones."""
    with pytest.raises(KeyError, match="k1_dh_stand, t1_dh_stand, t1_flat"):
        train.main(["--task", "k2_dh_stand", "--device", "cpu", "--log_root", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_config_overlay_matches_jax():
    """The same arguments give the same resolved configs in both packages."""
    argv = ["--num_envs", "8", "--seed", "3", "--max_iterations", "7", "--run_name", "r",
            "--use_ref_actions", "1", "--reward_scales", "feet_air_time=8,feet_clearance=4"]
    args = helpers.get_args(argv + ["--device", "cpu", "--n_devices", "1"])
    assert args.device == "cpu"
    got = config.update_cfg_from_args(T1EnvCfg(), T1TrainCfg(), args)
    want = jconfig.update_cfg_from_args(JEnvCfg(), JTrainCfg(), jhelpers.get_args(argv))
    for g, w in zip(got, want):
        assert config.to_dict(g) == jconfig.to_dict(w)
    with pytest.raises(ValueError):
        config.update_cfg_from_args(T1EnvCfg(), T1TrainCfg(),
                                    helpers.get_args(["--reward_scales", "not_a_term=1"]))
    over = config.update_from_dict(T1TrainCfg(), {"runner": {"num_steps_per_env": 4}})
    assert over.runner.num_steps_per_env == 4 and over.runner.max_iterations == 30001


@pytest.mark.parametrize("task", ["k1_dh_stand", "t1_flat"])
def test_train_cli_runs_registered_task(task, tmp_path):
    """One iteration of the registered task at its own config, 16 envs."""
    runner = train.main(["--device", "cpu", "--task", task, "--num_envs", "16",
                         "--max_iterations", "1", "--log_root", str(tmp_path)])
    (run,) = os.listdir(tmp_path)
    assert "model_1.pt" in os.listdir(tmp_path / run)
    with open(tmp_path / run / "config.json") as f:
        cfg = json.load(f)
    want_env, want_train = task_registry.get_cfgs(task)
    assert cfg["env_cfg"]["asset"] == config.to_dict(want_env.asset)
    assert cfg["env_cfg"]["terrain"]["mesh_type"] == want_env.terrain.mesh_type
    assert cfg["train_cfg"]["runner"]["experiment_name"] == want_train.runner.experiment_name
    assert runner.env.model.ncp == (16 if task == "k1_dh_stand" else 32)
    assert runner.iteration_count == 1


@pytest.fixture
def small_tasks(monkeypatch):
    """The registered tasks on a 2x2 terrain with 4 steps per env."""
    for name in task_registry.task_names():
        cls, env_cfg, train_cfg = task_registry._get(name)
        env_cfg = dataclasses.replace(env_cfg, terrain=dataclasses.replace(
            env_cfg.terrain, num_rows=2, num_cols=2, border_size=2.0))
        train_cfg = dataclasses.replace(train_cfg, runner=dataclasses.replace(
            train_cfg.runner, num_steps_per_env=4))
        monkeypatch.setitem(task_registry._tasks, name, (cls, env_cfg, train_cfg))


def _cli(root, *flags):
    return train.main(["--device", "cpu", "--task", "k1_dh_stand", "--num_envs", "16",
                       "--log_root", str(root), "--log_every", "1", *flags])


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def test_train_cli_resume_continues_newest_checkpoint(small_tasks, tmp_path):
    """2 iterations, then ``--resume --max_iterations 1`` in a new run: it
    picks the first run's model_2.pt and writes model_3.pt, equal bit for bit
    (params, Adam state, lr, env state, generators) to a straight 3-iteration
    run's."""
    _cli(tmp_path / "a", "--max_iterations", "2", "--run_name", "first")
    (first,) = os.listdir(tmp_path / "a")
    resumed = _cli(tmp_path / "a", "--max_iterations", "1", "--resume", "--run_name", "second")
    assert resumed.resume_path == str(tmp_path / "a" / first / "model_2.pt")
    assert os.listdir(resumed.log_dir) and "model_3.pt" in os.listdir(resumed.log_dir)
    straight = _cli(tmp_path / "b", "--max_iterations", "3", "--run_name", "straight")
    got = _flat(_load(os.path.join(resumed.log_dir, "model_3.pt")))
    want = _flat(_load(os.path.join(straight.log_dir, "model_3.pt")))
    assert set(got) == set(want) and got["iteration"] == 3
    for k, v in want.items():
        g = got[k]
        assert (g == v if not torch.is_tensor(v) else
                g.dtype == v.dtype and g.shape == v.shape and torch.equal(g, v)), k
    with open(os.path.join(resumed.log_dir, "metrics.csv")) as f:
        assert [r["iteration"] for r in csv.DictReader(f)] == ["3"]


def test_train_cli_resume_with_other_num_envs_raises(small_tasks, tmp_path):
    _cli(tmp_path, "--max_iterations", "1", "--run_name", "first")
    with pytest.raises(ValueError, match="holds 16 envs but the env has 8"):
        train.main(["--device", "cpu", "--task", "k1_dh_stand", "--num_envs", "8",
                    "--log_root", str(tmp_path), "--resume", "--max_iterations", "1",
                    "--run_name", "second"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _cli(tmp_path / "empty", "--resume", "--max_iterations", "1")


def test_train_cli_profile_writes_a_trace(small_tasks, tmp_path):
    """``--profile DIR``: 2 warm iterations, a gzipped Chrome trace of 3 that
    holds the env's spans, the rest (1 step per env here: the CPU trace of
    a step holds tens of thousands of ops)."""
    cls, env_cfg, train_cfg = task_registry._get("t1_flat")
    task_registry._tasks["t1_flat"] = (cls, env_cfg, dataclasses.replace(
        train_cfg, runner=dataclasses.replace(train_cfg.runner, num_steps_per_env=1)))
    runner = _cli(tmp_path / "logs", "--task", "t1_flat", "--max_iterations", "6",
                  "--profile", str(tmp_path / "trace"))
    found, tail = False, b""
    with gzip.open(tmp_path / "trace" / "trace.json.gz", "rb") as f:
        while not found and (chunk := f.read(1 << 20)):
            found = b'"env.post_physics"' in tail + chunk
            tail = chunk[-64:]
    assert found
    assert runner.iteration_count == 6
    assert {"model_2.pt", "model_5.pt", "model_6.pt"} <= set(os.listdir(runner.log_dir))


def test_play_loads_the_newest_checkpoint(small_tasks, tmp_path):
    """``scripts/play.py --task --log_root`` finds the run's checkpoint
    through the registry and plays its params (4 envs, another count than
    the checkpoint's 16) with a fixed command."""
    from ti5_isaacgym_tpu_torch.algo import networks as nets
    from ti5_isaacgym_tpu_torch.algo.runner import build_network
    from ti5_isaacgym_tpu_torch.scripts import play

    runner = _cli(tmp_path / "logs", "--max_iterations", "1", "--run_name", "r")
    want = _load(os.path.join(runner.log_dir, "model_1.pt"))["ts"]["params"]
    seen = {}
    real = play.load_policy

    def spy(*a):
        seen["policy"], state, seen["obs"] = real(*a)
        return seen["policy"], state, seen["obs"]

    play.load_policy = spy
    try:
        state, stats = play.play(play.get_play_args(
            ["--task", "k1_dh_stand", "--log_root", str(tmp_path / "logs"), "--num_envs", "4",
             "--steps", "2", "--fix_command", "--device", "cpu",
             "--out_dir", str(tmp_path / "eval")]))
    finally:
        play.load_policy = real
    env_cfg, train_cfg = task_registry.get_cfgs("k1_dh_stand")
    with torch.no_grad():
        ref = nets.apply(build_network(train_cfg, env_cfg), want, "act_mean", seen["obs"])
    assert torch.equal(seen["policy"](seen["obs"]), ref)
    assert state.phys.base_pos.shape == (4, 3) and stats["env_steps_per_s"] > 0
    assert torch.allclose(state.commands[:, 0], torch.tensor(0.4))
