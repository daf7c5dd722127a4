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


def _cut(monkeypatch, task: str = "t1_dh_stand"):
    """Register ``task`` cut to a 2x2 terrain, 4 steps per env and the
    kernel path's plain version (its calls are counted on the CPU), with
    every command counted as standing (the external force is applied to
    standing envs only, and 8 envs may have none)."""
    import dataclasses

    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    cls, env_cfg, train_cfg = task_registry._get(task)
    env_cfg = dataclasses.replace(
        env_cfg,
        terrain=dataclasses.replace(env_cfg.terrain, num_rows=2, num_cols=2, border_size=2.0),
        sim=dataclasses.replace(env_cfg.sim, megakernel_interpret=True),
        commands=dataclasses.replace(env_cfg.commands, stand_com_threshold=1e9))
    train_cfg = dataclasses.replace(train_cfg, runner=dataclasses.replace(
        train_cfg.runner, num_steps_per_env=4))
    monkeypatch.setitem(task_registry._tasks, task, (cls, env_cfg, train_cfg))
    return cls, env_cfg, train_cfg


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of small ops (the workers of a
    parallel test run share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_lifecycle_phase_runs_on_cpu(tmp_path, monkeypatch, one_thread):
    """Phase 10 at 8 envs on the cut task through the kernel path's plain
    version: (a) the lineage's learning state, common step and command
    range with 8 envs' curriculum fields (levels folded onto the 2x2 grid,
    origins of a fresh carry) grafted bit-equal, 3 iterations of 4 counted
    plain runs, an external force applied, no push (pushes are off in the
    config), then every env pushed at the next window; (b) the bootstrap's
    phases, 4 plain runs each (and phase A's reset), the std reheated; (c)
    the oracle's engine half for a few steps, unchecked, its plain runs
    counted, and the configuration entry."""
    import dataclasses

    from ti5_isaacgym_tpu_torch.algo.runner import OnPolicyRunner
    from ti5_isaacgym_tpu_torch.utils import checkpoint as ck

    cls, env_cfg, train_cfg = _cut(monkeypatch)
    n = 8
    cfg = dataclasses.replace(env_cfg, env=dataclasses.replace(env_cfg.env, num_envs=n))
    fresh = OnPolicyRunner(cls(cfg, seed=0, device="cpu"), cfg, train_cfg,
                           verbose=False).init_carry()
    payload = ck.load(chip_smoke.LINEAGE)
    env = payload["env_state"]
    payload["env_state"] = dict(env, terrain_level=env["terrain_level"][:n] % 2,
                                terrain_type=env["terrain_type"][:n] % 2,
                                env_origin=fresh.env_state.env_origin)
    ckpt = str(tmp_path / "model_71000.pt")
    ck.save(payload, ckpt)
    shares = []
    a = chip_smoke.phase_lineage("cpu", str(tmp_path / "a"), ckpt=ckpt, num_envs=n,
                                 shares=shares)
    assert a["launches"] == [4] * 3 and a["start_iteration"] == 71000
    assert a["adam_count"] == 568000 and a["common_step"] == 1704001
    assert a["ext_s"] == 0.15 and a["push_s"] == 0.3 and not a["pushes_on"]
    assert a["ext_steps"] > 0 and a["pushed"] == n and a["push_s_next"] == 0.3
    assert a["worst"] == 0.0 and shares == [1.0, 1.0]
    assert a["lineage"]["iterations"] == (70901, 71000)
    b = chip_smoke.phase_bootstrap("cpu", str(tmp_path / "b"), num_envs=n)
    assert b["launches"] == [5, 4]          # phase A: its iteration and the reset's step
    c = chip_smoke.phase_oracle("cpu", steps=6, wide_envs=8, drop_steps=6, check=False)
    assert (c["launches4"], c["launches_wide"], c["launches_drop"]) == (7, 6, 7)  # and resets
    assert sum(c["envs_reset_by_quarter"]) == c["envs_reset_wide"] <= 8
    assert set(c["stats4"]) == set(chip_smoke.ORACLE_TOL) and c["drop_steps"] == 6
    entry = chip_smoke.lifecycle_configuration(
        {"lineage": a, "bootstrap": b, "oracle": c, "bit_equal_share": min(shares)})
    assert entry["launches_per_training_iteration"] == {"lineage": [4] * 3,
                                                        "bootstrap_phase_b": [4]}
    assert entry["launches_bootstrap_phase_a_with_reset"] == 5


def test_oracle_tolerances_are_the_stated_ones():
    """The limits phase 10 holds the oracle to cover every statistic of the
    JAX tool's JSON and of its matched drop."""
    stats = json.load(open(os.path.join(chip_smoke.ROOT, "eval_round5", "contact_stats.json")))
    drop = json.load(open(os.path.join(chip_smoke.ROOT, "eval_round5", "matched_drop.json")))
    assert set(chip_smoke.ORACLE_TOL) == set(stats["stats"]) | {"mean_vx"}
    assert set(chip_smoke.DROP_TOL) == set(drop["engine"])
    assert all(v > 0 for v in list(chip_smoke.ORACLE_TOL.values())
               + list(chip_smoke.DROP_TOL.values()))


def test_asset_phase_runs_on_cpu(tmp_path, monkeypatch, one_thread):
    """Phase 11 (a) at 8 envs on the cut tasks through the kernel path's
    plain version: K1's extracted spec byte-equal to the committed one, one
    iteration of 4 counted plain runs from it, the plain version against
    itself after it; T1's round-tripped spec within 1e-8 of the committed
    one, and the plain decimation with it within phase 3's tolerances of
    the committed spec's; then the configuration entries."""
    for task in ("k1_dh_stand", "t1_dh_stand"):
        _cut(monkeypatch, task)
    shares = []
    a = chip_smoke.phase_assets("cpu", str(tmp_path), k1_envs=8, t1_envs=8, terrain_rows=2,
                                settle_steps=3, shares=shares)
    assert a["k1_launches"] == 4 and a["k1_worst"] == 0.0 and shares == [1.0, 1.0]
    assert 0.0 < a["spec_gap"] <= 1e-8 and a["t1_share"] > 0.0
    with open(tmp_path / "k1" / "k1.urdf") as f:
        assert f.read().startswith('<?xml version="1.0"?>\n<robot name="k1">')
    b = dict(launches=[4, 4], iter_ms=1.0, means={"mean_step_reward": 0.09})
    entries = chip_smoke.assets_configurations(
        {"assets": a, "long_run": b, "bit_equal_share": min(shares)})
    assert [e["task"] for e in entries] == ["k1_dh_stand", "t1_dh_stand", "t1_dh_stand"]
    assert entries[0]["launches_per_training_iteration"] == [4]
    assert entries[2]["iterations"] == 2 and entries[2]["launches_per_training_iteration"] == [4]


def test_long_run_phase_runs_on_cpu(tmp_path, monkeypatch, one_thread):
    """Phase 11 (b) at 8 envs on the cut task, 3 iterations of 4 counted
    plain runs from the lineage (its curriculum fields folded onto the 2x2
    grid, as in the lifecycle test), the means of iterations 2-3 reported
    unchecked (the bounds are for the card's 240 iterations at 4096 envs),
    ``metrics.csv`` with the JAX columns."""
    import dataclasses

    from ti5_isaacgym_tpu_torch.algo.runner import OnPolicyRunner
    from ti5_isaacgym_tpu_torch.utils import checkpoint as ck

    cls, env_cfg, train_cfg = _cut(monkeypatch)
    n = 8
    cfg = dataclasses.replace(env_cfg, env=dataclasses.replace(env_cfg.env, num_envs=n))
    fresh = OnPolicyRunner(cls(cfg, seed=0, device="cpu"), cfg, train_cfg,
                           verbose=False).init_carry()
    payload = ck.load(chip_smoke.LINEAGE)
    env = payload["env_state"]
    payload["env_state"] = dict(env, terrain_level=env["terrain_level"][:n] % 2,
                                terrain_type=env["terrain_type"][:n] % 2,
                                env_origin=fresh.env_state.env_origin)
    ckpt = str(tmp_path / "model_71000.pt")
    ck.save(payload, ckpt)
    b = chip_smoke.phase_long_run("cpu", str(tmp_path), ckpt=ckpt, num_envs=n, iters=3,
                                  hold=(2, 3), bounds=None)
    assert b["launches"] == [4] * 3 and b["start_iteration"] == 71000
    assert b["adam_steps"] == 3 * 8 and b["waves"] == [] and b["falls"] >= 0
    assert set(b["means"]) == set(chip_smoke.LONG_RUN_BOUNDS)
    assert all(np.isfinite(v) for v in b["means"].values())
    with pytest.raises(AssertionError, match="outside their bounds"):
        chip_smoke.phase_long_run("cpu", str(tmp_path / "again"), ckpt=ckpt, num_envs=n,
                                  iters=1, hold=(1, 1),
                                  bounds={"mean_step_reward": (1e9, 2e9)})


def test_long_horizon_bounds_are_the_stated_ones():
    """Phase 11 (b)'s bounds are those that ``tests/torch_long_run_bounds.py``
    computes from the lineage's committed metric rows, for the run it
    models; the rows' own steady state lies inside the bounds of the four
    quantities that do not depend on when the episodes started, and outside
    the model's range of the CSV's air-time term (the graft's waves)."""
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_long_run_bounds as lrb

    got = lrb.bounds()
    assert set(got) == set(chip_smoke.LONG_RUN_BOUNDS)
    for k, (lo, hi) in got.items():
        assert chip_smoke.LONG_RUN_BOUNDS[k] == pytest.approx((lo, hi), rel=1e-12), k
    assert (lrb.ITERS, lrb.HOLD, lrb.NUM_ENVS) == (chip_smoke.LONG_ITERS, chip_smoke.LONG_HOLD,
                                                    chip_smoke.LINEAGE_ENVS)
    rows = lrb.row_stats()
    for k, col in (("mean_step_reward", "mean_step_reward"), ("terrain_level", "terrain_level"),
                   ("ended_episode_length", "mean_episode_length"),
                   ("ended_feet_air_time", "rew_feet_air_time")):
        lo, hi = got[k]
        assert lo < rows[col][0] < hi and hi - lo == pytest.approx(8 * rows[col][1])
    assert rows["rew_feet_air_time"][0] > got["rew_feet_air_time"][1]
