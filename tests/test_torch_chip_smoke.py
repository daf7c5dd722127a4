"""Rehearsal of chip_smoke.py's control flow on the CPU at 16 envs.

The script's phases are imported and run on a small full-task env (2x2
terrain) through the plain path: the kernel-vs-plain comparison (here the
plain version against itself), the rollout, the bound computed from the
inputs, the training phase's checks, and the shape of the result lines.
The device and build phases need a card and are not run here.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402


def test_phases_run_on_cpu():
    env, policy, state, obs = chip_smoke.make_env(16, "cpu", terrain_rows=2, settle_steps=3)
    assert not env.use_kernel_path          # CPU envs take the per-substep loop
    assert chip_smoke.phase_compare(env, state, obs, policy) == 0.0
    inputs = chip_smoke.decimation_inputs(env, state, obs, policy)
    cases = chip_smoke.compare_cases(env, inputs)
    assert [tuple(c["state_rows"].shape) for _, c in cases] == [(37, 16), (37, 15), (37, 16)]
    assert all(c["lagged_rows"].is_contiguous() for _, c in cases)
    extw = cases[2][1]["extw_rows"]
    assert bool((extw.abs() > 0).all())
    assert bool((extw.abs() <= torch.tensor(chip_smoke.EXTW_MAX)[:, None]).all())
    state, obs, launches, stats = chip_smoke.phase_rollout(env, policy, state, obs, steps=2)
    assert launches == 0                    # the plain version never counts
    assert stats["env_steps_per_s"] > 0 and 0.0 <= stats["reset_share"] <= 1.0
    assert bool(torch.isfinite(state.phys.qpos).all())
    bound_ms, bound_by, nbytes, ops = chip_smoke.kernel_bound(
        env, chip_smoke.decimation_inputs(env, state, obs, policy))
    # 878 input and 518 output float32 rows per env
    assert nbytes == 4 * 16 * (878 + 518)
    assert ops > 0 and bound_by in ("bytes", "operations") and bound_ms > 0


def test_result_lines():
    times = dict(ms=0.2, ms_wide=0.35, host_us=60.0, plain_ms=1900.0, bound_ms=0.0128,
                 bound_by="operations")
    rank = dict(num_envs=4096, launches=[24] * 4, all_reduce_ms=3.0,
                counts={"curriculum": 24, "gae": 1, "update": 8, "metrics": 1})
    parallel = chip_smoke.parallel_configuration(dict(
        ranks=[rank, rank], backend="gloo", devices=["cuda:0", "cuda:0"],
        ms_per_iteration=2000.0, env_steps_per_s=98304.0))
    assert parallel["world_size"] == 2 and parallel["num_envs_per_rank"] == 4096
    assert parallel["launches_per_training_iteration"] == [[24] * 4, [24] * 4]
    configs = [dict(task="k1_dh_stand", num_envs=8192, bit_equal_share=1.0, max_abs_err=0.0,
                    launches_per_training_iteration=[24] * 4, ms=0.3), parallel]
    lines = chip_smoke.result_lines("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 1,
                                    24, 1e-3, times, [24, 24], configs)
    kernels = json.loads(lines[0])["kernels"]
    assert set(kernels[0]) == {"name", "route", "source", "replaces", "launches",
                               "launches_per_training_iteration", "max_abs_err", "ms",
                               "ms_8192_envs", "plain_ms", "bound_ms", "bound_by", "library_ms",
                               "configurations"}
    assert kernels[0]["configurations"] == configs
    assert kernels[0]["ms"] == 0.2 and kernels[0]["ms_8192_envs"] == 0.35
    assert kernels[0]["launches_per_training_iteration"] == [24, 24]
    assert os.path.exists(os.path.join(chip_smoke.ROOT, kernels[0]["source"]))
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_training_phase_runs_on_cpu(tmp_path):
    """Phase 6 at 16 envs (2x2 terrain, 4 steps per env) through the kernel
    path's plain version: the launch-count check counts the plain version's
    calls (one per step of every iteration), the metrics and params are
    finite and moved, lr in range, the save -> load round trip and the
    iteration after it are bit-equal, and the comparison after an iteration
    runs (the plain version against itself here); a corrupted restore is
    caught."""
    runner = chip_smoke.make_runner(16, "cpu", terrain_rows=2, steps=4, kernel_path_on_cpu=True)
    assert runner.env.use_kernel_path and runner.env.num_envs == 16
    out = chip_smoke.phase_train(runner, checkpoint=str(tmp_path / "model.pt"))
    assert out["launches"] == [4] * 6 and out["peak_bytes"] is None and out["worst"] == 0.0
    assert set(out["stats"]) == {"value_loss", "surrogate_loss", "estimator_loss", "kl", "lr"}
    assert runner.ppo_cfg.min_lr <= out["stats"]["lr"] <= runner.ppo_cfg.max_lr
    assert 0.0 <= out["reset_share"] <= 1.0 and out["checkpoint_fields"] > 100
    assert out["rollout_ms"] > 0 and out["gae_ms"] > 0 and out["update_ms"] > 0
    a = {"x": {"y": torch.zeros(3)}, "g": torch.tensor(1)}
    assert chip_smoke._bit_equal(a, {"x": {"y": torch.zeros(3)}, "g": torch.tensor(1)}, "a") == 2
    for other in ({"x": {"y": -torch.zeros(3)}, "g": torch.tensor(1)},
                  {"x": {"y": torch.zeros(3)}, "g": torch.tensor(2)},
                  {"x": {"y": torch.zeros(3, dtype=torch.float64)}, "g": torch.tensor(1)}):
        with pytest.raises(AssertionError, match="not bit-equal"):
            chip_smoke._bit_equal(a, other, "a")


def test_parallel_phase_runs_on_cpu(tmp_path):
    """Phase 8 at 16 global envs (2x2 terrain, 4 steps per env) through the
    kernel path's plain version, on CPU ranks over gloo: world size 1
    bit-equal to the plain runner with 4 + 1 + 8 + 1 collectives; 2 ranks
    of 8 envs, the full-batch gradients, update and GAE within their limits, 4 counted
    plain runs per rank in each of 4 iterations, the train state bit-equal
    across ranks, the lead's checkpoint alone."""
    out = chip_smoke.phase_parallel("cpu", num_envs=16, terrain_rows=2, steps=4,
                                    kernel_path_on_cpu=True, root=str(tmp_path))
    counts = {"curriculum": 4, "gae": 1, "update": 8, "metrics": 1}
    assert out["world1"]["counts"] == counts and out["world1"]["launches"] == 4
    assert out["backend"] == "gloo" and out["devices"] == ["cpu", "cpu"]
    for r in out["ranks"]:
        assert r["launches"] == [4] * 4 and r["counts"] == counts and r["num_envs"] == 8
        assert r["replicated"] == [(0, 0.0)] * 4 and r["moved"] > 0
    assert out["ranks"][0]["gaps"]["params"] <= 1e-5
    assert out["ranks"][0]["gaps"]["grads"] <= 1e-5
    assert sorted(os.listdir(tmp_path)) == ["model_4.pt"]
    entry = chip_smoke.parallel_configuration(out)
    assert entry["launches_per_training_iteration"] == [[4] * 4, [4] * 4]


def test_play_entry_point_and_vec_env_on_cpu(tmp_path):
    """The headless play CLI and the VecEnv facade at 4 envs on the CPU; play
    writes its state panels and robot 0's trajectory to ``tmp_path``."""
    from ti5_isaacgym_tpu_torch.envs.vec_env import VecEnv
    from ti5_isaacgym_tpu_torch.scripts import play

    state, stats = play.play(play.get_play_args(
        ["--num_envs", "4", "--steps", "2", "--random_policy", "--device", "cpu",
         "--out_dir", str(tmp_path), "--export_traj", str(tmp_path / "traj.npz")]))
    assert bool(torch.isfinite(state.phys.base_pos).all()) and stats["env_steps_per_s"] > 0
    assert (tmp_path / "eval_states.png").exists()
    with np.load(tmp_path / "traj.npz") as f:
        assert f["qpos"].shape == (2, 3 + 4 + 12)
    env = play.T1DHStandEnv(play.make_env_cfg(4), seed=0, device="cpu")
    venv = VecEnv(env, seed=0)
    obs, priv = venv.reset()
    assert obs.shape == (4, venv.num_obs) and priv.shape == (4, venv.num_privileged_obs)
    obs, priv, rew, done, extras = venv.step(torch.zeros(4, venv.num_actions))
    assert rew.shape == (4,) and done.dtype == torch.bool and "done_count" in extras


def test_events_and_heading_paths_run_on_cpu():
    """Pushes, external forces (both triggered often) and the heading command
    mode, on both CPU decimation paths: finite states, the events fire, and
    the heading mode rewrites the yaw-rate command."""
    import dataclasses

    from ti5_isaacgym_tpu_torch.scripts import play

    base = play.make_env_cfg(8, full_task=True)
    for kernel_path in (False, True):
        cfg = dataclasses.replace(
            base,
            terrain=dataclasses.replace(base.terrain, num_rows=2, num_cols=2, border_size=2.0),
            sim=dataclasses.replace(base.sim, megakernel_interpret=kernel_path),
            commands=dataclasses.replace(base.commands, heading_command=True),
            domain_rand=dataclasses.replace(
                base.domain_rand, push_robots=True, push_interval_s=0.03, update_step=24,
                push_duration=(0.02,), ext_force_interval_s=0.03, add_update_step=24,
                add_duration=(0.02,)))
        env = play.T1DHStandEnv(cfg, seed=0, device="cpu")
        assert env.use_kernel_path == kernel_path
        state, obs, _ = env.reset(env.init_state(0))
        pushed = applied = False
        for _ in range(4):
            state, obs, _, rew, _, _ = env.step(state, torch.zeros(8, 12))
            pushed |= bool((state.push_force != 0).any())
            applied |= bool((state.ext_force != 0).any())   # applied only when standing
            assert bool(torch.isfinite(state.phys.qvel).all()) and bool(torch.isfinite(rew).all())
        assert pushed and applied
        assert bool((state.commands[:, 2].abs() <= 1.0).all())


def test_tasks_phase_runs_on_cpu(tmp_path, monkeypatch):
    """Phase 7 at 16 envs with the registered tasks cut to a 2x2 terrain and
    4 steps per env, through the kernel path's plain version: K1 and flat T1
    through the registry (4 counted plain runs per iteration, the cells
    against gather_contact_cells), the CLI resume bit-equal to a straight
    run, the export checked against the runner's policy, the ONNX runtime
    and the native runtime, and the golden round-5 bytes."""
    import dataclasses

    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    for name in task_registry.task_names():
        cls, env_cfg, train_cfg = task_registry._get(name)
        env_cfg = dataclasses.replace(
            env_cfg,
            terrain=dataclasses.replace(env_cfg.terrain, num_rows=2, num_cols=2,
                                        border_size=2.0),
            sim=dataclasses.replace(env_cfg.sim, megakernel_interpret=True))
        train_cfg = dataclasses.replace(train_cfg, runner=dataclasses.replace(
            train_cfg.runner, num_steps_per_env=4))
        monkeypatch.setitem(task_registry._tasks, name, (cls, env_cfg, train_cfg))
    out = chip_smoke.phase_tasks("cpu", root=str(tmp_path), k1_envs=16, flat_envs=16)
    k1, flat = out["k1_dh_stand"], out["t1_flat"]
    assert k1["launches"] == [4] * 4 and flat["launches"] == [4] * 3
    assert k1["worst"] == 0.0 and k1["bit_equal_share"] == 1.0
    assert k1["cells"]["same_cell"] == k1["cells"]["points"] == 16 * 16
    assert k1["cells"]["reciprocal_moves"] == 0           # the CPU divides
    assert flat["cells"]["same_cell"] is None and flat["cells"]["points"] == 32 * 16
    assert out["resume"]["fields"] > 100
    assert max(out["export"]["gaps"].values()) <= 2e-4
    assert out["golden"] == ["policy_config.yaml", "policy_dh.json", "ti5_dh_policy.onnx"]


def test_play_refuses_unported_viewers(monkeypatch, tmp_path):
    """Play refuses a viewer it cannot run instead of going on without it:
    ``--video`` where ``cv2`` is missing raises before the env is built,
    ``--live`` raises the viewer's own error, and an overlay that fails
    stops the replay with its error."""
    mujoco = pytest.importorskip("mujoco")
    import mujoco.viewer

    from ti5_isaacgym_tpu_torch.scripts import play

    def args(*flags):
        return play.get_play_args(list(flags) + ["--device", "cpu", "--random_policy",
                                                 "--num_envs", "2", "--steps", "1",
                                                 "--out_dir", str(tmp_path)])

    built = []
    monkeypatch.setattr(play, "T1DHStandEnv", lambda *a, **k: built.append(a) or 1 / 0)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        with pytest.raises(ImportError):
            play.play(args("--video", str(tmp_path / "x.mp4")))

    def no_display(model, data):
        raise RuntimeError("no display")

    monkeypatch.setattr(mujoco.viewer, "launch_passive", no_display)
    with pytest.raises(RuntimeError, match="no display"):
        play.play(args("--live"))
    assert built == []
    monkeypatch.undo()

    class BrokenScene:
        def is_running(self):
            return True

        def close(self):
            self.closed = True

    viewer = BrokenScene()                  # no user_scn: the overlay fails
    monkeypatch.setattr(mujoco.viewer, "launch_passive", lambda model, data: viewer)
    with pytest.raises(AttributeError, match="user_scn"):
        play.play(args("--live"))
    assert viewer.closed


def test_viewer_phase_runs_on_cpu(tmp_path):
    """Phase 9 on the CPU: (a) sim2sim's policy on two CPU copies (equal),
    (b) the overlays of a 16-env full-task state against its CPU copy (the
    same tensors), (c) play with ``--teleop auto`` at 4 envs for 2 steps
    (the CPU env takes the per-substep loop: no counted launch)."""
    a = chip_smoke.phase_sim2sim_policy(devices=("cpu", "cpu"))
    assert a["max_abs_err"] == 0.0 and set(a["ms"]) == {"cpu"} and a["ms"]["cpu"] > 0
    frames = chip_smoke.sim2sim_frames(4)
    assert [f.shape for f in frames] == [(47,)] * 4 and frames[0].dtype == np.float32
    env, _, state, _ = chip_smoke.make_env(16, "cpu", terrain_rows=2, settle_steps=3)
    b = chip_smoke.phase_overlays(env, state)
    assert b["robots"] == [0, 15] and b["max_abs_err"] == 0.0 and len(b["segments"]) == 2
    c = chip_smoke.phase_play("cpu", num_envs=4, steps=2, root=str(tmp_path))
    assert c["launches"] == 0 and c["env_steps_per_s"] > 0
