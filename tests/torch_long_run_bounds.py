"""The bounds that ``chip_smoke.py`` phase 11 (b) holds the walking lineage's
240-iteration run to (``chip_smoke.LONG_RUN_BOUNDS``), computed from the
lineage's 500 committed metric rows (JAX, iterations 70,728-71,227):

    python tests/torch_long_run_bounds.py

prints them.  ``tests/test_torch_chip_smoke.py`` recomputes them and holds
the constants to them.  Imports numpy and the standard library only.

The run grafts ``model_71000.pt`` onto a fresh carry, so all 4096 episodes
start together (at the reset's zero-action step, one step before the first
iteration), and an episode that does not fall times out at its 2401st step
(``episode_length > 2400``).  The time-outs come in waves, in iterations
100 and 201 after the graft, and only the falls spread the episodes out
again.  So over iterations 141-240 (one whole episode period, after the
first wave):

* ``mean_step_reward`` and ``terrain_level`` see every phase of an episode
  once and every env's curriculum step once, as the rows' steady state does:
  they are held to the rows' mean +- 4 standard deviations of a row;
* the mean length and the feet-air-time term of the episodes that *ended* in
  those iterations (their sums over the ended episodes, divided by their
  number) are the rows' quantities too, whatever the synchronisation: the
  same bound (the ``ended_`` keys);
* the CSV's own ``mean_episode_length`` (the runner's window of the last
  >= 100 ended episodes, ``algo/runner.py``) and ``rew_feet_air_time`` (the
  term's mean over the ended episodes of each iteration, 0 when none ended)
  are not: between the waves only the falls and the time-outs of envs that
  fell earlier end, so both depend on when in an episode the falls happen,
  which the rows cannot tell.  Their bounds are the range of a renewal model
  of the run, widened by 4 standard deviations of a row: every episode falls
  with probability ``p`` at a step uniform on ``1..m`` or times out, each
  ended episode scores the term in proportion to its length (a full one
  scoring what makes the model's steady state match the rows), the window as
  the runner keeps it; ``m`` in :data:`SHAPES` and ``p`` the rows' (from
  their mean episode length) times each of :data:`RATES`, 8 seeds each.  The
  same model without the graft (random episode phases, every shape at the
  rows' rate) reproduces the rows' means of both columns to 0.1% and their
  standard deviations to within 40%.
"""
import csv
import os

import numpy as np

ROWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "checkpoints_torch",
                    "t1_dh_stand", "Aug21_19-21-52_probe_s21", "metrics.csv")
TIMEOUT = 2401          # steps of an episode that does not fall
STEPS = 24              # policy steps per env per iteration
ITERS = 240             # iterations after the graft
HOLD = (141, 240)       # the iterations (after the graft) whose means are held
NUM_ENVS = 4096
SHAPES = (24, 240, 1200, TIMEOUT)   # falls uniform on the first m steps of an episode
RATES = (0.5, 1.0, 2.0)             # the fall probability against the rows'
SEEDS = range(8)
K = 4.0                             # standard deviations of a row


def row_stats(path: str = ROWS) -> dict:
    """(mean, standard deviation) of each column of the rows."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {k: (float(np.mean(v)), float(np.std(v)))
            for k in rows[0] for v in [np.array([float(r[k]) for r in rows])]}


def simulate(p: float, m: int, air_full: float, seed: int, num_envs: int = NUM_ENVS,
             iters: int = ITERS):
    """Per iteration after the graft: the runner's ``mean_episode_length``
    and the CSV's ``rew_feet_air_time`` of the renewal model (module
    docstring)."""
    rng = np.random.default_rng(seed)
    horizon = iters * STEPS
    start = np.full(num_envs, -1.0)     # the reset's step, which the runner does not count
    ends, lengths = [], []
    while (start < horizon).any():
        fall = rng.random(num_envs) < p
        end = start + np.where(fall, rng.integers(1, m + 1, num_envs), TIMEOUT)
        keep = (end >= 1) & (end <= horizon)
        ends.append(end[keep])
        lengths.append((end - np.maximum(start, 0.0))[keep])
        start = end
    it = ((np.concatenate(ends) - 1) // STEPS).astype(int)
    length = np.concatenate(lengths)
    done = np.bincount(it, minlength=iters).astype(float)
    len_sum = np.bincount(it, weights=length, minlength=iters)
    air = air_full * len_sum / TIMEOUT / np.maximum(done, 1.0)
    window, count, total, mean_len = [], 0.0, 0.0, []
    for d, s in zip(done, len_sum):
        window.append((d, s))
        count, total = count + d, total + s
        while len(window) > 1 and count - window[0][0] >= 100.0:
            d0, s0 = window.pop(0)
            count, total = count - d0, total - s0
        mean_len.append(total / max(count, 1.0))
    return np.array(mean_len), air


def bounds(path: str = ROWS) -> dict:
    """``{name: (low, high)}`` of phase 11 (b)."""
    st = row_stats(path)
    out = {}
    for name, col in (("mean_step_reward", "mean_step_reward"),
                      ("terrain_level", "terrain_level"),
                      ("ended_episode_length", "mean_episode_length"),
                      ("ended_feet_air_time", "rew_feet_air_time")):
        mean, std = st[col]
        out[name] = (mean - K * std, mean + K * std)
    ep_len, air = st["mean_episode_length"][0], st["rew_feet_air_time"][0]
    air_full = air * TIMEOUT / ep_len
    lo, hi = HOLD[0] - 1, HOLD[1]
    model = {"mean_episode_length": [], "rew_feet_air_time": []}
    for m in SHAPES:
        p0 = (TIMEOUT - ep_len) / (TIMEOUT - (m + 1) / 2.0)
        for rate in RATES:
            for seed in SEEDS:
                mean_len, air_it = simulate(p0 * rate, m, air_full, seed)
                model["mean_episode_length"].append(float(mean_len[lo:hi].mean()))
                model["rew_feet_air_time"].append(float(air_it[lo:hi].mean()))
    for col, values in model.items():
        std = st[col][1]
        out[col] = (min(values) - K * std, max(values) + K * std)
    return out


if __name__ == "__main__":
    for k, v in bounds().items():
        print(f"{k!r}: ({v[0]!r}, {v[1]!r}),")
