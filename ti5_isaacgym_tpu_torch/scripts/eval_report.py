"""The training evaluation report: curves, play, the sim2sim sweep, the
export (port of ``tools/eval_report.py``; ``tools/final_eval.sh`` runs it
on the newest run).

    python -m ti5_isaacgym_tpu_torch.scripts.eval_report --run logs/t1_dh_stand/<run> \
        [--steps 1200] [--out eval_out] [--device cpu]

Writes into ``--out``:

* ``training_curves.png``: windowed episode statistics, the curricula and
  the estimator loss from the run's ``metrics.csv`` (the port's runner
  writes the JAX package's columns);
* play's metrics, robot 0's trajectory and an mp4 (``scripts/play.py``
  with ``--video`` and ``--export_traj``), then the sim2sim sweep
  (``scripts/sim2sim.py --sweep --episodes 2``), then the deployment files
  (``scripts/export_policy.py``), each run as ``python -m
  ti5_isaacgym_tpu_torch.scripts.<name>`` with ``--device`` passed on;
* ``EVAL.md``, the summary.

The checkpoint is the run's newest ``model_<it>.pt``.  A gate that exits
non-zero (or a sim2sim run without its result line) is a failure: its row
says FAILED, ``EVAL.md`` gets a ``## FAILURES`` section with the log's
tail, ``EVAL FAILED`` goes to stderr and the exit code is 1.  Needs a host
with MuJoCo, cv2 and matplotlib (the card's machine has none of them).
"""
from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys

import numpy as np

from ..utils.device import resolve_device
from ..utils.registry import LEGGED_GYM_ROOT as ROOT
from ..utils.registry import checkpoints_in

BLUE = "#2a78d6"       # categorical slot 1 (skill-validated palette)
RAW = "#c9ced6"        # recessive raw-series ink
INK = "#3a3f47"        # text
GRID = "#e8eaee"


def plot_curves(run_dir: str, out_png: str) -> dict:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = list(csv.DictReader(open(os.path.join(run_dir, "metrics.csv"))))
    it = np.array([int(r["iteration"]) for r in rows])

    def col(name):
        return np.array([float(r[name]) for r in rows])

    panels = [
        ("Episode length (steps, 100-episode window)", "mean_episode_length"),
        ("Episode reward (100-episode window)", "mean_episode_reward"),
        ("Mean step reward", "mean_step_reward"),
        ("Terrain curriculum level (mean)", "terrain_level"),
        ("Command curriculum: max vx (m/s)", "max_command_x"),
        ("State-estimator loss", "estimator_loss"),
    ]
    fig, axes = plt.subplots(3, 2, figsize=(11, 9), dpi=120)
    fig.patch.set_facecolor("white")
    summary = {}
    for ax, (title, name) in zip(axes.ravel(), panels):
        y = col(name)
        ax.plot(it, y, color=RAW, linewidth=0.8)
        if len(y) > 200:                      # smoothed reading line
            k = max(len(y) // 200, 1)
            ys = np.convolve(y, np.ones(k) / k, mode="valid")
            ax.plot(it[k - 1:], ys, color=BLUE, linewidth=2.0)
            summary[name] = float(np.mean(y[-max(len(y) // 50, 10):]))
        else:
            ax.plot(it, y, color=BLUE, linewidth=2.0)
            summary[name] = float(y[-1]) if len(y) else float("nan")
        ax.set_title(title, fontsize=10, color=INK, loc="left")
        ax.tick_params(colors=INK, labelsize=8)
        ax.grid(color=GRID, linewidth=0.7)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        for s in ("left", "bottom"):
            ax.spines[s].set_color(GRID)
    axes[-1, 0].set_xlabel("iteration", fontsize=9, color=INK)
    axes[-1, 1].set_xlabel("iteration", fontsize=9, color=INK)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_png)), exist_ok=True)
    fig.savefig(out_png, facecolor="white")
    plt.close(fig)
    return summary


def run_cmd(args_list, log_path):
    print("+", " ".join(args_list), flush=True)
    with open(log_path, "w") as f:
        try:
            r = subprocess.run(args_list, stdout=f, stderr=subprocess.STDOUT,
                               cwd=ROOT, timeout=3600)
            rc = r.returncode
        except subprocess.TimeoutExpired:
            f.write("\n[eval_report] TIMEOUT after 3600s\n")
            rc = 124
    out = open(log_path).read()
    return rc, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True, help="training run dir (metrics.csv + model_*)")
    ap.add_argument("--out", default="eval_out")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--task", default="t1_dh_stand")
    ap.add_argument("--skip_play", action="store_true")
    ap.add_argument("--skip_sim2sim", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="passed to play, sim2sim and the export: cuda (the default; they "
                         "raise without a card) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    run_dir = os.path.abspath(args.run)
    log_root = os.path.dirname(run_dir)
    run_name = os.path.basename(run_dir)

    summary = plot_curves(run_dir, os.path.join(out, "training_curves.png"))
    print("curves:", {k: round(v, 2) for k, v in summary.items()}, flush=True)

    models = checkpoints_in(run_dir)
    ckpt = models[-1] if models else None
    play_out = s2s_out = ""
    # Each gate records (name, rc).  A nonzero rc is a FAILED eval, not a
    # skip: it is reported loudly in EVAL.md and propagates to our exit code
    # (round-2's report silently printed "(skipped)" over two rc=1 crashes).
    gates: list = []
    if ckpt and not args.skip_play:
        rc, play_out = run_cmd(
            [sys.executable, "-m", "ti5_isaacgym_tpu_torch.scripts.play",
             "--task", args.task, "--num_envs", "9",
             "--steps", str(args.steps), "--fix_command",
             "--command", "0.4", "0.0", "0.0",
             "--log_root", log_root, "--load_run", run_name,
             "--out_dir", out,
             "--video", os.path.join(out, "t1_walk.mp4"),
             "--export_traj", os.path.join(out, "t1_traj.npz"), "--device", args.device],
            os.path.join(out, "play.log"))
        print("play rc:", rc, flush=True)
        gates.append(("play", rc))
    if ckpt and not args.skip_sim2sim:
        rc, s2s_out = run_cmd(
            [sys.executable, "-m", "ti5_isaacgym_tpu_torch.scripts.sim2sim",
             "--task", args.task, "--steps", str(max(args.steps, 2000)),
             "--sweep", "--episodes", "2",
             "--log_root", log_root, "--load_run", run_name, "--device", args.device],
            os.path.join(out, "sim2sim.log"))
        print("sim2sim rc:", rc, flush=True)
        gates.append(("sim2sim", rc))

    # deployment artifacts from the blessed checkpoint (npz + manifest, ONNX,
    # controller YAML; the JAX exporter's StableHLO has no counterpart)
    if ckpt:
        rc, _ = run_cmd(
            [sys.executable, "-m", "ti5_isaacgym_tpu_torch.scripts.export_policy",
             "--task", args.task, "--log_root", log_root,
             "--load_run", run_name, "--out", os.path.join(out, "exported"),
             "--device", args.device],
            os.path.join(out, "export.log"))
        print("export rc:", rc, flush=True)
        gates.append(("export", rc))

    s2s_rc = dict(gates).get("sim2sim")
    if s2s_rc is None:
        s2s_line = "(skipped by --skip_sim2sim)" if ckpt else "(no checkpoint)"
    elif s2s_rc != 0:
        s2s_line = f"FAILED (rc={s2s_rc}; see sim2sim.log)"
    else:
        s2s_line = next((l for l in s2s_out.splitlines()
                         if l.startswith("sim2sim:")),
                        "FAILED (rc=0 but no result line; see sim2sim.log)")
        if s2s_line.startswith("FAILED"):
            # rc=0 but no parseable result: the gate itself is a failure —
            # reflected in the table AND the failures list (ADVICE r3: the
            # two must not contradict each other)
            gates = [(n, rc if n != "sim2sim" else 1) for n, rc in gates]
            gates.append(("sim2sim-parse", 1))
    failures = [(n, rc) for n, rc in gates if rc != 0]
    gate_table = "\n".join(
        f"| {n} | {'PASSED' if rc == 0 else f'**FAILED** (rc={rc})'} |"
        for n, rc in gates) or "| (no checkpoint found — nothing ran) | — |"
    with open(os.path.join(out, "EVAL.md"), "w") as f:
        f.write(f"""# Evaluation report — {run_name}

Checkpoint: `{ckpt}` · task `{args.task}`

## Gate results

| gate | result |
|---|---|
{gate_table}

## Windowed training statistics (final ~2% of run)

| metric | value |
|---|---|
| mean episode length (of 2400 max) | {summary.get('mean_episode_length', float('nan')):.0f} |
| mean episode reward | {summary.get('mean_episode_reward', float('nan')):.2f} |
| terrain curriculum level | {summary.get('terrain_level', float('nan')):.2f} |
| command curriculum max vx | {summary.get('max_command_x', float('nan')):.2f} m/s |

![training curves](training_curves.png)

## Sim-to-sim transfer (MuJoCo, command sweep x randomized models)

```
{s2s_line}
{chr(10).join(l for l in (s2s_out or "").splitlines() if l.startswith("sweep "))}
```

## Artifacts

* `exported/` — `policy_dh.npz` + manifest, `ti5_dh_policy.onnx`, `policy_config.yaml`
* `t1_walk.mp4` — offscreen MuJoCo render of the policy walking (robot 0)
* `t1_traj.npz` — robot-0 qpos trajectory
* `play.log` / `sim2sim.log` — full eval console output
""")
        if failures:
            f.write("\n## FAILURES\n\n")
            for n, rc in failures:
                log = os.path.join(out, f"{n.split('-')[0]}.log")
                tail = ""
                if os.path.exists(log):
                    tail = "".join(open(log).readlines()[-12:])
                f.write(f"**{n}** exited rc={rc}. Log tail:\n\n```\n{tail}```\n\n")
    print(f"wrote {os.path.join(out, 'EVAL.md')}", flush=True)
    if failures:
        print(f"EVAL FAILED: {failures}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
