"""The walking recipe, the seed probe and the evaluation report
(``scripts/train_walk.py``, ``scripts/seed_probe.py``,
``scripts/eval_report.py``) on the CPU.

The tasks are cut to a 2x2 terrain and 4 steps per env
(``tests/torch_cut_cli.py``): in this process through the task registry,
in the seed probe's training processes through the script's ``entry``.
"""
import csv
import json
import os
import subprocess
import sys

import pytest
import torch

from ti5_isaacgym_tpu_torch.scripts import eval_report, seed_probe, train_walk
from ti5_isaacgym_tpu_torch.utils import checkpoint as ck

sys.path.insert(0, os.path.dirname(__file__))
import torch_cut_cli  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread, here and in the processes a test starts: the ops
    are small, and the workers of a parallel test run share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cut_registry(monkeypatch):
    """The process's task registry with every task cut (restored after)."""
    torch_cut_cli.patch_registry(monkeypatch)


def test_train_walk_smoke(cut_registry, tmp_path, monkeypatch):
    """SMOKE=1: 16 envs, phase A (3 iterations with the overlay and the
    shaped scales), the reheat, phase B (3 more from the reheated file,
    overlay off, the reference scales)."""
    for k in ("NUM_ENVS", "P1_ITERS", "P2_ITERS", "LOG_EVERY", "TASK", "STD"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SMOKE", "1")
    k = train_walk.knobs(["--device", "cpu"])
    assert (k.num_envs, k.p1_iters, k.p2_iters, k.log_every, k.std) == (16, 3, 3, 1, 0.4)
    out = train_walk.main(["--device", "cpu", "--log_root", str(tmp_path)])
    assert os.path.basename(out["phase_a"]) == "model_3.pt"
    run_a = os.path.dirname(out["phase_a"])
    assert run_a.endswith("_walkA")
    with open(os.path.join(run_a, "config.json")) as f:
        cfg_a = json.load(f)["env_cfg"]
    assert cfg_a["env"]["use_ref_actions"] is True
    scales = dict(map(tuple, cfg_a["rewards"]["scales"]))
    assert {k: scales[k] for k in
            ("feet_air_time", "feet_clearance", "feet_contact_number")} == \
        {"feet_air_time": 8.0, "feet_clearance": 4.0, "feet_contact_number": 2.4}
    reheated = ck.load(out["reheated"])["ts"]
    assert out["reheated"] == os.path.join(run_a, "reheated_model_3.pt")
    assert bool((reheated["params"]["std"] == torch.tensor(0.4)).all())
    assert not reheated["mu"]["std"].any() and not reheated["nu"]["std"].any()
    runner = out["phase_b"]
    assert runner.iteration_count == 6 and not runner.env.cfg.env.use_ref_actions
    assert dict(runner.env.cfg.rewards.scales)["feet_air_time"] != 8.0
    assert os.path.exists(os.path.join(runner.log_dir, "model_6.pt"))
    with open(os.path.join(runner.log_dir, "metrics.csv")) as f:
        assert [int(r["iteration"]) for r in csv.DictReader(f)] == [4, 5, 6]


@pytest.mark.parametrize("walks", [True, False])
def test_seed_probe(tmp_path, monkeypatch, walks):
    """A threshold every run passes: exit 0, the run left training (its pid
    written); one none passes: exit 1, the run ended."""
    started = []
    real = subprocess.Popen

    def popen(*args, **kwargs):
        started.append(real(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(seed_probe.subprocess, "Popen", popen)
    env = {"NUM_ENVS": "16", "PROBE_ITERS": "2", "THRESH": "-1" if walks else "1e9"}
    try:
        rc = seed_probe.main(["21", "--device", "cpu", "--log_root", str(tmp_path)],
                             environ=env, poll_s=0.5, entry=torch_cut_cli.entry)
        (proc,) = started
        console = open(tmp_path / "train_probe_s21.console").read()
        (run,) = [d for d in os.listdir(tmp_path) if d.endswith("_probe_s21")]
        with open(tmp_path / run / "metrics.csv") as f:
            assert int(list(csv.DictReader(f))[-1]["iteration"]) >= 2, console
        if walks:
            assert rc == 0 and proc.poll() is None, console
            assert open(tmp_path / "train_probe_s21.pid").read() == f"pid: {proc.pid}\n"
        else:
            assert rc == 1 and proc.poll() is not None
            assert not os.path.exists(tmp_path / "train_probe_s21.pid")
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_seed_probe_reports_a_dead_run(tmp_path, capsys):
    """A training process that dies before the probe iteration is reported
    and skipped; no seed walks: exit 1."""
    rc = seed_probe.main(["7", "--device", "cpu", "--log_root", str(tmp_path)],
                         environ={"PROBE_ITERS": "2"}, poll_s=0.1,
                         entry=lambda m: [sys.executable, "-c", "raise SystemExit(3)"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "seed 7: process died (rc 3)" in out and "no walking seed found in: 7" in out


def _fake_run_dir(tmp_path, rows=3, checkpoint=True):
    run = tmp_path / "logs" / "t1_dh_stand" / "FakeRun"
    run.mkdir(parents=True)
    with open(run / "metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "iteration", "mean_episode_length", "mean_episode_reward",
            "mean_step_reward", "terrain_level", "max_command_x",
            "estimator_loss"])
        w.writeheader()
        for i in range(rows):
            w.writerow({"iteration": i, "mean_episode_length": 100 + i,
                        "mean_episode_reward": 1.0, "mean_step_reward": 0.01,
                        "terrain_level": i / max(rows - 1, 1), "max_command_x": 0.5,
                        "estimator_loss": 0.1})
    if checkpoint:
        # not a checkpoint: the export crashes on it
        (run / "model_7.pt").write_text("not a checkpoint")
    return run


def test_eval_report_propagates_gate_failure(tmp_path):
    """A port of tests/test_eval_report.py: a gate that crashes is a failed
    evaluation, loudly (rc != 0, EVAL FAILED, a FAILURES section), never
    '(skipped)'."""
    run = _fake_run_dir(tmp_path)
    out = tmp_path / "eval_out"
    r = subprocess.run(
        [sys.executable, "-m", "ti5_isaacgym_tpu_torch.scripts.eval_report", "--run", str(run),
         "--out", str(out), "--skip_play", "--skip_sim2sim", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=600, stdin=subprocess.DEVNULL)
    assert r.returncode != 0, f"eval_report exited 0 over a crashed gate:\n{r.stdout}"
    assert "EVAL FAILED" in r.stderr
    md = (out / "EVAL.md").read_text()
    assert "| export | **FAILED** (rc=1) |" in md
    assert "## FAILURES" in md and "**export** exited rc=1" in md
    assert "(skipped)" not in md
    assert "Checkpoint: `model_7.pt`" in md


SIM2SIM_OUT = ("sweep forward   cmd=(+0.4,+0.0,+0.0) survived 100.0% | err vx 0.050/0.25 vy "
               "0.020/0.25 wz 0.030/0.40 -> PASS (required)\n"
               "sim2sim: sweep 5/5 commands pass (20s horizon, 2 randomized models each); "
               "required gates PASS\n")


def _fake_gates(monkeypatch, sim2sim_out):
    """``eval_report.run_cmd`` answering for play, sim2sim and the export
    without starting them; the commands it was given."""
    calls = []

    def run_cmd(args_list, log_path):
        calls.append(args_list)
        text = sim2sim_out if "ti5_isaacgym_tpu_torch.scripts.sim2sim" in args_list else "ok\n"
        with open(log_path, "w") as f:
            f.write(text)
        return 0, text

    monkeypatch.setattr(eval_report, "run_cmd", run_cmd)
    return calls


def test_eval_report_curves_and_sim2sim_line(tmp_path, monkeypatch):
    """On a fake run of 400 logged iterations: the curves' summary is the
    mean of the last 2% (at least 10 rows), the sim2sim result line and
    sweep rows land in EVAL.md, every gate passed, and each gate ran the
    port's module with --device passed on."""
    run = _fake_run_dir(tmp_path, rows=400)
    out = tmp_path / "eval_out"
    calls = _fake_gates(monkeypatch, SIM2SIM_OUT)
    eval_report.main(["--run", str(run), "--out", str(out), "--device", "cpu"])
    assert (out / "training_curves.png").stat().st_size > 0
    summary = eval_report.plot_curves(str(run), str(tmp_path / "c.png"))
    assert summary["mean_episode_length"] == pytest.approx(100 + sum(range(390, 400)) / 10)
    assert summary["max_command_x"] == 0.5
    md = (out / "EVAL.md").read_text()
    assert SIM2SIM_OUT.splitlines()[1] in md and SIM2SIM_OUT.splitlines()[0] in md
    for gate in ("play", "sim2sim", "export"):
        assert f"| {gate} | PASSED |" in md
    assert "FAILURES" not in md and "StableHLO" not in md
    modules = [c[c.index("-m") + 1] for c in calls]
    assert modules == [f"ti5_isaacgym_tpu_torch.scripts.{m}"
                       for m in ("play", "sim2sim", "export_policy")]
    assert all(c[c.index("--device") + 1] == "cpu" for c in calls)
    play = calls[0]
    assert "--video" in play and "--export_traj" in play and "FakeRun" in play


def test_eval_report_fails_without_the_sim2sim_line(tmp_path, monkeypatch, capsys):
    """sim2sim exiting 0 without its result line is a failed gate."""
    run = _fake_run_dir(tmp_path, rows=5)
    out = tmp_path / "eval_out"
    _fake_gates(monkeypatch, "nothing to parse\n")
    with pytest.raises(SystemExit) as e:
        eval_report.main(["--run", str(run), "--out", str(out), "--device", "cpu"])
    assert e.value.code == 1
    assert "EVAL FAILED" in capsys.readouterr().err
    md = (out / "EVAL.md").read_text()
    assert "| sim2sim | **FAILED** (rc=1) |" in md and "**sim2sim-parse** exited rc=1" in md
