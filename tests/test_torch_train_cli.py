"""The port's training CLI on the CPU, and its argument handling.

``python -m ti5_isaacgym_tpu_torch.scripts.train --device cpu --num_envs 16
--max_iterations 2`` runs the full task (20x20 terrain, 24 steps per env) to
the end and writes ``config.json``, ``metrics.csv`` and a checkpoint; the
flags of features the port does not have yet raise; the config overlay
equals the JAX package's on the same arguments.
"""
import csv
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


@pytest.mark.parametrize("flags", [["--n_devices", "2"], ["--coordinator", "h:1"],
                                   ["--num_processes", "2"], ["--process_id", "0"],
                                   ["--profile", "trace"], ["--resume"], ["--load_run", "x"],
                                   ["--checkpoint", "3"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        helpers.get_args(flags)


def test_unported_task_raises(tmp_path):
    with pytest.raises(ValueError, match="registry"):
        train.main(["--task", "k1_dh_stand", "--device", "cpu", "--log_root", str(tmp_path)])


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
