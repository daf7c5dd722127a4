#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths at the task's full width (the 20x20 rough-terrain
grid, full domain randomization, action/dof/IMU lag, the decimation kernel
on): the ``t1_dh_stand`` policy rollout at 4096 envs, the DH-PPO training
iteration at 8192 envs, every registered task through the task
registry with a CLI resume and the deployment export, data-parallel
training over two ranks, the parts of sim2sim and the viewers that run
on the card, the training lifecycle (the committed walking lineage
resumed, the gait bootstrap, the contact-statistics oracle's engine half),
and robots read from URDFs by the asset pipeline with the lineage trained
for 240 iterations.
Phases, each printing one line with its elapsed seconds:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: ``nvcc`` of ``csrc/decimation.cu`` into ``build/ti5_torch_kernels``
   (seconds, ptxas registers and spills);
3. kernel against its plain version on one decimation's real inputs, with
   Coulomb friction and torque noise off and on (the same noise rows fed to
   both), every output within its stated tolerance, in three cases: all 4096
   envs; the first 4095 (the last block partly empty); all 4096 with an
   external wrench drawn from a numpy seed (after settling the env's own
   wrench is mostly zero);
4. rollout: 24 policy steps of the round-5 walking policy
   (``eval_round5/final/exported/policy_dh.npz``) through the play loop,
   exactly 24 kernel launches, finite states, observations and rewards;
5. times: the kernel at 4096 envs and at 8192 (the 4096 inputs tiled along
   N), each the mean of 50 warm launches on CUDA events with the host ahead
   of the device (a ``torch.cuda._sleep`` enqueued first), beside the host's
   enqueue time per launch; the plain version (one launch) and the kernel's
   bound;
6. training: ``OnPolicyRunner`` at 8192 envs (``T1TrainCfg``'s defaults:
   24 steps per env, 2 epochs x 4 minibatches), the network initialised as
   flax does from the training seed; 1 warm and 2 timed iterations
   (synchronised before the clock is read) and one more split into rollout /
   GAE / update by synchronising at those two borders; exactly 24 kernel
   launches in every iteration, finite params, losses and metrics, params
   moved, ``lr`` within ``[min_lr, max_lr]``; a ``save`` -> ``load`` round
   trip under ``build/`` that restores params, Adam state, lr, the env state
   and the generators bit for bit, and one more iteration from the restored
   carry equal, bit for bit, to one from the original; last, the kernel
   against its plain version at 8192 envs (two waves of blocks), flags off
   and on, with phase 3's tolerances, on the inputs of the step after that
   iteration (sampled actions, envs just reset among them).  Prints the
   iteration time, env-steps/s, the split, the five update stats, the reset
   share and the peak memory;
7. tasks, resume, export, all under ``build/ti5_torch_smoke/phase7``:
   ``k1_dh_stand`` at 8192 envs (1 warm, 2 timed and 1 split iteration) and
   ``t1_flat`` at its own 1024 (1 warm, 1 split) through
   ``task_registry.make_env`` / ``make_alg_runner``, each with phase 6's
   per-iteration checks, then on the next step's inputs the kernel against
   its plain version (flags off and on) and every contact point's cell
   against the per-point ``gather_contact_cells``; the kernel's time at
   K1 x 8192 as phase 5 takes it; ``scripts/train.main`` for K1 at 8192 envs
   for 2 iterations, ``--resume`` for 1, and 3 straight, the resumed
   ``model_3.pt`` bit-equal to the straight one; ``scripts/export_policy``
   on it, ``load_npz`` of the export bit-equal to the runner's policy on 64
   observations, the port's ONNX runtime and ``native/ti5_infer`` (built
   with g++ under ``build/``) within 2e-4; the export of the committed
   round-5 policy byte-equal to the committed ONNX, manifest and YAML.

8. data parallelism, under ``build/ti5_torch_smoke/phase8``, through
   ``parallel.trainer.spawn_local`` (the kernel is built by then): (a) one
   rank in a world of 1 over NCCL, T1 at 8192 envs from seed 5: a
   ``ShardedRunner`` iteration, its collectives running, bit-equal to the
   plain runner's from the same carry, with the all-reduces and launches
   counted; (b) two ranks of 4096 envs each, over NCCL on two cards where
   there are two, else both on the one card over gloo (tensors on the
   card): the full-batch update of one rollout's trajectory split in
   halves against the single-process update of the whole of it and the
   GAE moments against ``compute_gae`` on all of it
   (tests/test_parallel.py's limits), then 1 warm, 2 timed and 1 split
   iteration, 24 launches per rank in each, the train state bit-equal
   across the ranks after each, the global env-steps/s and each rank's
   split and peak memory, the ranks' env generators drawing different
   values, and only rank 0 writing ``model_4.pt``, which loads back through
   ``params_only``; last, the time of one update buffer's all-reduce (in
   (a) too) and of one rollout on both ranks with the curriculum's
   all-reduce off.
9. sim2sim and the viewers (MuJoCo, cv2 and pygame are not on the card's
   machine; what touches torch runs here), under
   ``build/ti5_torch_smoke/phase9``: (a) sim2sim's per-step policy
   (``scripts/sim2sim.make_policy``, the round-5 policy) on 220
   deployment frames built by ``sim2sim.deployment_frame`` from a
   numpy-seeded sequence of states, stacked by ``sim2sim.push_frame``, on
   the card and on the CPU: every ``act_mean`` and ``est_vel`` within 1e-5
   (TF32 off), and the time per call at batch 1 (mean of 200 after 20 warm,
   host clock); (b) right after phase 6, the live viewer's overlays
   (``utils/debug_viz``) for robots 0 and 8191 of phase 6's env state on
   the card against a CPU copy, within 1e-5; (c) ``scripts/play.main`` with
   ``--teleop auto`` at 4096 envs for 24 steps with the round-5 policy,
   stdin not a tty: the headless line printed, 25 kernel launches (24 steps
   and the reset's zero-action step), a finite ``[24, 19]`` trajectory.

10. the training lifecycle, under ``build/ti5_torch_smoke/phase10``: (a)
   ``scripts/resume_migrate`` from the committed walking lineage
   (``checkpoints_torch/t1_dh_stand/Aug21_19-21-52_probe_s21/model_71000.pt``,
   JAX's iteration 71,000) at its 4096 envs on the full task: right after
   the graft the train state and the five curriculum fields bit-equal to the
   file, the iteration count going on from 71,000 and the Adam count from
   568,000; 1 warm and 2 timed iterations through ``learn``, 24 launches
   each, finite metrics; the external forces of the escalation schedule at
   its last stage (0.15 s every 4 s) counted in the warm iteration (the
   lineage's config has pushes off: none may fire); then one step with
   pushes on at the start of the next push window (0.3 s), every env
   pushed, and the kernel against its plain version on the step after it,
   flags off and on, phase 3's tolerances; the reset share and step reward
   beside the lineage's last logged rows; (b) ``scripts/train_walk``'s
   phases at 4096 envs with one iteration each: phase A with the overlay and
   the shaped scales, the reheat (std exactly 0.4, its Adam moments zero),
   phase B from the reheated file, 24 launches in each; (c) the oracle's
   engine half (``scripts/contact_stats``) with the round-5 policy: 800
   steps at 4 envs and at 4096, every gait statistic and the mean vx within
   :data:`ORACLE_TOL` of the JAX engine's (``eval_round5/contact_stats.json``),
   the spread of the 1,024 groups of 4 printed; the matched drop (300
   steps) within :data:`DROP_TOL` of ``eval_round5/matched_drop.json``.
11. the asset pipeline and the long training run, under
   ``build/ti5_torch_smoke/phase11``: (a) K1's URDF from
   ``scripts/make_k1_urdf``, its spec from ``scripts/extract_model``
   byte-equal to the committed ``k1_model.json``, ``k1_dh_stand`` built from
   that file through the registry at 8192 envs, one training iteration with
   24 launches and finite metrics, then the kernel against its plain version
   on the next step's inputs, flags off and on, phase 3's tolerances; T1's
   committed spec through ``scripts/spec_to_urdf`` and back (within 1e-8),
   T1 at 4096 envs with it and with the committed spec on one decimation's
   inputs: the kernel's outputs of the two within phase 3's tolerances,
   flags off and on; (b) ``scripts/resume_migrate`` from the committed
   lineage at its 4096 envs for :data:`LONG_ITERS` iterations through
   ``learn``: 24 launches in every iteration, finite params and metrics,
   the iteration count 71,000 -> 71,240, the Adam count + 240 x 8,
   ``metrics.csv`` with the JAX columns; over the iterations
   :data:`LONG_HOLD` after the graft the means of the step reward, the
   terrain level, the CSV's episode length and air-time term, and the
   length and air-time term of the episodes that ended there, each within
   :data:`LONG_RUN_BOUNDS` and printed beside the JAX rows' mean, with the
   iteration ms, env-steps/s and the phase's seconds.

It then prints the kernels' JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
line.  Imports only the port, torch, numpy and the standard library; needs
no network; writes only under ``build/`` (and phase 8's rendezvous file in a
temporary directory).  The kernels' JSON line lists the one kernel, with a
``configurations`` entry per task it ran on, one for phase 8, one for
phase 10 and three for phase 11.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
POLICY = os.path.join(ROOT, "eval_round5", "final", "exported", "policy_dh.npz")
KERNEL_SOURCE = "ti5_isaacgym_tpu_torch/csrc/decimation.cu"
REPLACES = "ti5_isaacgym_tpu/physics/megakernel.py:236"
NUM_ENVS = 4096
TRAIN_ENVS = 8192      # the training width of bench.py
STEPS = 24
SETTLE_STEPS = 30      # policy steps after reset so the feet are on the ground
SEED = 5
# external wrench of the third comparison case: uniform within the task's
# push limits (configs/t1_dh_stand.py ext_force_max_x/y/z) and +-20 Nm
EXTW_MAX = (600.0, 400.0, 5.0, 20.0, 20.0, 20.0)
# device cycles enqueued before the timed launches (~50 ms at 1.98 GHz), far
# longer than the host needs to enqueue them
SLEEP_CYCLES = 100_000_000
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor float32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# kernel vs plain version; the reference's own tolerances
# (tests/test_megakernel.py:52-67): state and kinematics atol 2e-4, contact
# forces atol 2 N + rtol 2e-3; torques follow from the state through gains
# of at most 144 Nm/rad and 14.4 Nm s/rad: atol 0.05 Nm
TOLERANCES = {"state": (2e-4, 0.0), "anchors": (2e-4, 0.0), "forces": (2.0, 2e-3),
              "torques": (5e-2, 0.0), "dof_snapshots": (2e-4, 0.0),
              "imu_snapshots": (2e-4, 0.0), "ctx": (2e-4, 0.0)}
OUTPUTS = tuple(TOLERANCES)
CHECKPOINT = os.path.join(ROOT, "build", "ti5_torch_smoke", "model_smoke.pt")
PHASE7_ROOT = os.path.join(ROOT, "build", "ti5_torch_smoke", "phase7")
PHASE8_ROOT = os.path.join(ROOT, "build", "ti5_torch_smoke", "phase8")
FLAT_ENVS = 1024       # t1_flat's own width
PHASE9_ROOT = os.path.join(ROOT, "build", "ti5_torch_smoke", "phase9")
SIM2SIM_CALLS = 200    # timed policy calls of phase 9 (a), after
SIM2SIM_WARM = 20      # warm ones
PHASE10_ROOT = os.path.join(ROOT, "build", "ti5_torch_smoke", "phase10")
# the committed walking lineage (JAX's model_71000 carried across) and its width
LINEAGE = os.path.join(ROOT, "checkpoints_torch", "t1_dh_stand", "Aug21_19-21-52_probe_s21",
                       "model_71000.pt")
LINEAGE_ENVS = 4096
ORACLE_STEPS = 800     # the JAX oracle's horizon (eval_round5/contact_stats.json)
DROP_STEPS = 300
# phase 10 (c): each gait statistic of the port's engine against the JAX
# engine's (eval_round5/contact_stats.json, itself 4 envs): 4 standard
# deviations (to within 0.5%) of the statistic over the 16 groups of 4 envs
# of a 64-env, 800-step CPU run of the port
# (`python tests/torch_oracle_spread.py port 64 800 <out.json>`; PERF.md §6)
ORACLE_TOL = {"support_ratio": 0.1004, "double_support_frac": 0.0988,
              "single_support_frac": 0.1272, "flight_frac": 0.0408, "footfalls_per_s": 0.4428,
              "landing_peak_N": 241.66, "landing_peak_p95_N": 431.61,
              "landing_impulse_Ns": 6.235, "mean_vx": 0.2164}
# the matched drop against eval_round5/matched_drop.json's engine column: the
# port on the CPU matched it within 4e-3 N, 1e-4 N s and to the step (PERF.md
# §6); the limits allow the card's rounding: first contact to the step, the
# forces the kernel's contact tolerance (2 N + 0.2%), topple 3 steps
DROP_TOL = {"first_contact_s": 0.005, "landing_peak_N": 6.3, "landing_impulse_Ns": 1.0,
            "post_landing_grf_N": 5.0, "topple_s": 0.03}
PHASE11_ROOT = os.path.join(ROOT, "build", "ti5_torch_smoke", "phase11")
LONG_ITERS = 240       # phase 11 (b): the lineage's iterations after the graft
LONG_HOLD = (141, 240)  # the iterations after the graft whose means are held
# phase 11 (b): the bounds of those means, from the lineage's 500 committed
# metric rows (JAX, iterations 70,728-71,227) and a model of the episodes the
# graft synchronises (`python tests/torch_long_run_bounds.py`, which says
# how; PERF.md §6): the rows' mean +- 4 standard deviations of a row for the
# step reward, the terrain level and the length and air-time term of the
# episodes that ended in the held iterations; the model's range widened by
# 4 standard deviations for the CSV's windowed episode length and per-
# iteration air-time term
LONG_RUN_BOUNDS = {
    "mean_step_reward": (0.09047326904751218, 0.09769120952271068),
    "terrain_level": (5.053542121721319, 5.252990104841181),
    "ended_episode_length": (2322.954473722326, 2437.4077510169627),
    "ended_feet_air_time": (0.0064149082973546335, 0.007142519000364834),
    "mean_episode_length": (1374.5383134803978, 2452.700292035972),
    "rew_feet_air_time": (-0.0002958053388975556, 0.005774016109772702),
}
T0 = time.perf_counter()


def log(msg: str):
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True,
                         stdin=subprocess.DEVNULL).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi}")
    return smi, name


def phase_build():
    from ti5_isaacgym_tpu_torch.physics import megakernel as mk

    t0 = time.perf_counter()
    mk.build()
    secs = time.perf_counter() - t0
    report = mk.last_build.get("ptxas", "")
    regs = "; ".join(ln.strip() for ln in report.splitlines()
                     if "registers" in ln or "spill" in ln) or "cached build"
    log(f"build: {secs:.1f} s, ptxas: {regs}")
    return {"seconds": secs, "ptxas": regs}


def make_env(num_envs: int, device, terrain_rows=None, settle_steps: int = SETTLE_STEPS):
    """The full task (terrain grid, domain randomization, lags, kernel)
    through the play loop's config entry point; ``terrain_rows`` shrinks the
    grid for a CPU rehearsal."""
    import dataclasses

    from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv
    from ti5_isaacgym_tpu_torch.scripts import play

    cfg = play.make_env_cfg(num_envs, full_task=True)
    if terrain_rows is not None:
        cfg = dataclasses.replace(cfg, terrain=dataclasses.replace(
            cfg.terrain, num_rows=terrain_rows, num_cols=terrain_rows, border_size=2.0))
    t0 = time.perf_counter()
    env = T1DHStandEnv(cfg, seed=SEED, device=device)
    policy = play.make_policy(cfg, POLICY, device=device)
    state, obs, _ = env.reset(env.init_state(SEED))
    # the robots spawn above the ground: settle so the compared decimation
    # runs the contact path
    state, obs, _ = play.rollout(env, policy, state, obs, settle_steps)
    hf = tuple(env.heightfield.height.shape)
    log(f"env: {num_envs} envs, heightfield {hf[0]}x{hf[1]}, reset and {settle_steps} "
        f"settling steps in {time.perf_counter() - t0:.1f} s")
    return env, policy, state, obs


def decimation_inputs(env, state, obs, policy):
    import torch

    with torch.no_grad():
        actions = policy.act_mean(obs)
    inputs, _ = env.pack_decimation(state, actions, env.contact_cells(state))
    return inputs


def within_tolerances(got, want, what: str):
    """Hold each decimation output of ``got`` to ``want`` within
    :data:`TOLERANCES`; raises if one is not finite or out of its tolerance,
    else returns (largest gap, share of values bit-equal, per-output gaps)."""
    import torch

    worst, gaps, same, total = 0.0, [], 0, 0
    for name, g, w in zip(OUTPUTS, got, want):
        same += int((g == w).sum())
        total += g.numel()
        atol, rtol = TOLERANCES[name]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"kernel output {name} is not finite ({what})")
        err = (g - w).abs()
        gap = float(err.max())
        worst = max(worst, gap)
        gaps.append(f"{name} {gap:.3g}")
        if float((err - (atol + rtol * w.abs())).max()) > 0:
            raise AssertionError(f"kernel output {name} differs by {gap:.3g} (atol {atol}, "
                                 f"rtol {rtol}; {what})")
    return worst, same / total, gaps


def compare(env, inputs, flags: bool, label: str, shares=None) -> float:
    """``run_decimation`` on the env's device against ``run_decimation_plain``
    on the same inputs; raises if an output is not finite or out of its
    tolerance, else returns the largest gap (and appends the share of output
    values that are bit-equal to ``shares``)."""
    import torch

    from ti5_isaacgym_tpu_torch.physics.megakernel import run_decimation, run_decimation_plain

    args = dict(env.decimation_args(), use_coulomb=flags, use_noise=flags)
    got = run_decimation(**args, **inputs)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    want = run_decimation_plain(**args, **inputs)
    worst, share, gaps = within_tolerances(got, want, f"the kernel against the plain version; "
                                                      f"{label}, flags {flags}")
    if shares is not None:
        shares.append(share)
    feet = list(env.model.feet_bodies)
    fz = want[2].reshape(env.model.nb, 3, -1)[feet, 2]
    in_contact = float((fz > 5.0).any(dim=0).float().mean())
    log(f"compare {label}, coulomb/noise={'on' if flags else 'off'} ({in_contact:.0%} of envs "
        f"with a foot in contact; {share:.4%} of output values bit-equal): "
        f"max |kernel - plain|: " + ", ".join(gaps))
    return worst


def compare_cases(env, inputs) -> list:
    """(label, inputs) of the comparison cases: all envs, all but the last
    (a ragged env count), all envs with a seeded nonzero external wrench."""
    import numpy as np
    import torch

    n = int(inputs["state_rows"].shape[1])
    rng = np.random.default_rng(SEED)
    lim = np.asarray(EXTW_MAX, np.float32)[:, None]
    extw = torch.as_tensor(rng.uniform(-1.0, 1.0, size=(6, n)).astype(np.float32) * lim,
                           device=inputs["extw_rows"].device)
    return [(f"{n} envs", inputs),
            (f"first {n - 1} envs", {k: v[:, :n - 1].contiguous() for k, v in inputs.items()}),
            (f"{n} envs, external wrench", dict(inputs, extw_rows=extw))]


def phase_compare(env, state, obs, policy, shares=None):
    """The kernel against its plain version in every case of
    :func:`compare_cases`, flags off and on; returns the largest gap."""
    inputs = decimation_inputs(env, state, obs, policy)
    worst = 0.0
    for label, case in compare_cases(env, inputs):
        for flags in (False, True):
            worst = max(worst, compare(env, case, flags, label, shares))
    return worst


def phase_rollout(env, policy, state, obs, steps: int = STEPS):
    """The main path: ``steps`` policy steps through the play loop, the
    kernel's launch count reset just before and read just after."""
    import torch

    from ti5_isaacgym_tpu_torch.physics import megakernel as mk
    from ti5_isaacgym_tpu_torch.scripts import play

    mk.launches = 0
    state, obs, stats = play.rollout(env, policy, state, obs, steps)
    launches = mk.launches
    for name, t in (("qpos", state.phys.qpos), ("base_pos", state.phys.base_pos),
                    ("obs", obs), ("rewards", stats["rewards"])):
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"rollout {name} is not finite")
    if obs.shape != (env.num_envs, env.cfg.env.num_observations):
        raise AssertionError(f"rollout obs shape {tuple(obs.shape)}")
    log(f"rollout: {steps} steps x {env.num_envs} envs, {stats['env_steps_per_s']:.1f} "
        f"env-steps/s, kernel launches {launches}, reset share {stats['reset_share']:.4f}")
    return state, obs, launches, stats


def kernel_bound(env, inputs):
    """(bound ms, 'bytes' or 'operations', bytes, operations): the larger of
    the bytes the kernel must move over HBM bandwidth and its float32
    operations (counted on the plain version with these inputs) over the
    non-tensor float32 peak."""
    from ti5_isaacgym_tpu_torch.physics import megakernel as mk

    args = env.decimation_args()
    mc, dec = args["mc"], args["decimation"]
    n = int(inputs["state_rows"].shape[1])
    rows_in = sum(int(v.shape[0]) for v in inputs.values()) + 2 * mc.ncp   # + meff rows
    rows_out = sum(mk._out_rows(mc, dec, True, len(args["feet_bodies"]),
                                len(args["knee_bodies"])))
    nbytes = 4 * n * (rows_in + rows_out)
    ops = mk.count_float_ops(mk.run_decimation_plain, **args, **inputs)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def time_kernel(args, inputs, reps: int = 50):
    """(device ms per launch, host enqueue us per launch, host ahead): the
    mean of ``reps`` warm launches on CUDA events, a ``torch.cuda._sleep``
    enqueued first so the host has enqueued them all before the device
    reaches them (checked: the sleep is still running when the host is
    done)."""
    import torch

    from ti5_isaacgym_tpu_torch.physics.megakernel import run_decimation

    for _ in range(3):
        run_decimation(**args, **inputs)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        run_decimation(**args, **inputs)
    host_us = (time.perf_counter() - h0) / reps * 1e6
    ahead = not t0.query()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, host_us, ahead


def phase_times(env, state, obs, policy, reps: int = 50):
    """Phase 5: :func:`time_width` at the env's width, and the kernel alone
    at twice it (the inputs tiled along N)."""
    import torch

    inputs = decimation_inputs(env, state, obs, policy)
    out = time_width(env, inputs, reps)
    wide = {k: torch.cat([v, v], dim=1).contiguous() for k, v in inputs.items()}
    out["ms_wide"], host_us_wide, ahead = time_kernel(env.decimation_args(), wide, reps)
    del wide
    if not ahead:
        raise AssertionError("the host fell behind the device while enqueueing the timed "
                             "launches: the times would be the host's")
    log(f"times: kernel {out['ms_wide']:.4f} ms at {2 * env.num_envs} envs (mean of {reps}; "
        f"host enqueue {host_us_wide:.1f} us per launch, host ahead), bound "
        f"{2 * out['bound_ms']:.5f} ms, library: none")
    return out


def make_runner(num_envs: int, device, terrain_rows=None, steps=None,
                kernel_path_on_cpu: bool = False, log_dir=None):
    """The training runner on the full task at ``num_envs`` with
    ``T1TrainCfg``'s defaults, logging to ``log_dir`` if given;
    ``terrain_rows``, ``steps`` (per env and iteration) and
    ``kernel_path_on_cpu`` (the kernel path's plain version on the CPU) cut
    a CPU rehearsal down."""
    import dataclasses

    from ti5_isaacgym_tpu_torch.algo.runner import OnPolicyRunner
    from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1TrainCfg
    from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv
    from ti5_isaacgym_tpu_torch.scripts import play

    cfg = play.make_env_cfg(num_envs, full_task=True)
    if terrain_rows is not None:
        cfg = dataclasses.replace(cfg, terrain=dataclasses.replace(
            cfg.terrain, num_rows=terrain_rows, num_cols=terrain_rows, border_size=2.0))
    if kernel_path_on_cpu:
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, megakernel_interpret=True))
    tcfg = T1TrainCfg()
    if steps is not None:
        tcfg = dataclasses.replace(tcfg, runner=dataclasses.replace(
            tcfg.runner, num_steps_per_env=steps))
    env = T1DHStandEnv(cfg, seed=tcfg.seed, device=device)
    return OnPolicyRunner(env, cfg, tcfg, log_dir=log_dir, verbose=False)


def _launch_count(device) -> int:
    """The kernel's launch count on a card; the plain version's call count
    on the CPU (a rehearsal of the check)."""
    from ti5_isaacgym_tpu_torch.physics import megakernel as mk

    return mk.launches if device.type == "cuda" else mk.plain_runs


def _reset_launch_count():
    from ti5_isaacgym_tpu_torch.physics import megakernel as mk

    mk.launches = mk.plain_runs = 0


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flat(tree, prefix=""):
    """Nested dicts of tensors -> {path: tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bit_equal(a, b, what: str) -> int:
    """Raise unless two nested dicts of tensors are equal bit for bit;
    return the number of tensors compared."""
    import torch

    def raw(t):
        return t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)

    fa, fb = _flat(a), _flat(b)
    if set(fa) != set(fb):
        raise AssertionError(f"{what}: different fields {sorted(set(fa) ^ set(fb))}")
    bad = [k for k in fa if fa[k].dtype != fb[k].dtype or fa[k].shape != fb[k].shape
           or not torch.equal(raw(fa[k]), raw(fb[k]))]
    if bad:
        raise AssertionError(f"{what}: not bit-equal in {bad[:8]}")
    return len(fa)


def phase_train(runner, checkpoint: str = CHECKPOINT):
    """Phase 6: training iterations of ``runner`` from a fresh carry, with
    the checks listed in the module docstring.  Returns the measured
    numbers."""
    import torch

    from ti5_isaacgym_tpu_torch.algo.runner import carry_to_dict

    dev = runner.device
    n, steps = runner.env.num_envs, runner.num_steps_per_env
    cfg = runner.ppo_cfg
    iteration = runner._make_iteration()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    carry = runner.init_carry()
    _sync(dev)
    init_s = time.perf_counter() - t0
    params0 = {k: v.clone() for k, v in carry.ts.params.items()}
    done, counts = [], []

    def run(c, mark=None):
        """One iteration, its launches counted from 0 just before it."""
        _reset_launch_count()
        c, m = iteration(c, mark)
        _sync(dev)
        launches = _launch_count(dev)
        counts.append(launches)
        if launches != steps:
            raise AssertionError(f"a training iteration launched the decimation kernel "
                                 f"{launches} times, expected {steps}")
        for k, v in m.items():
            if not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"training metric {k} is not finite: {v}")
        done.append(float(m["done_count"]))
        return c, m

    t0 = time.perf_counter()
    carry, _ = run(carry)                                # warm
    warm_s = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(2):
        carry, metrics = run(carry)
    iter_ms = (time.perf_counter() - t0) / 2 * 1e3
    borders = []
    _sync(dev)
    t0 = time.perf_counter()

    def mark(_name):
        _sync(dev)
        borders.append(time.perf_counter())

    carry, metrics = run(carry, mark)
    rollout_ms, gae_ms, update_ms = (1e3 * (b - a) for a, b in zip([t0] + borders[:2], borders))

    for k, v in carry.ts.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"parameter {k} is not finite")
    moved = max(float((carry.ts.params[k] - params0[k]).abs().max()) for k in params0)
    if not moved > 0:
        raise AssertionError("training did not move the parameters")
    lr = float(carry.ts.lr)
    if not cfg.min_lr <= lr <= cfg.max_lr:
        raise AssertionError(f"lr {lr} outside [{cfg.min_lr}, {cfg.max_lr}]")

    # save -> load round trip, then one more iteration from each carry
    path = runner.save(carry, path=checkpoint, keep_last=0)
    restored = runner.load(path, carry=carry)
    fields = _bit_equal(carry_to_dict(carry), carry_to_dict(restored), "restored carry")
    c1, m1 = run(carry)
    c2, m2 = run(restored)
    _bit_equal({"carry": carry_to_dict(c1), "metrics": m1},
               {"carry": carry_to_dict(c2), "metrics": m2}, "iteration after the restore")
    shares = []
    worst = compare_after_iteration(runner, c1, shares)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    stats = {k: float(metrics[k]) for k in
             ("value_loss", "surrogate_loss", "estimator_loss", "kl", "lr")}
    out = dict(init_s=init_s, warm_s=warm_s, iter_ms=iter_ms,
               env_steps_per_s=n * steps / (iter_ms / 1e3), rollout_ms=rollout_ms,
               gae_ms=gae_ms, update_ms=update_ms, launches=counts, worst=worst,
               bit_equal_share=min(shares), stats=stats,
               reset_share=sum(done) / (n * steps * len(done)), peak_bytes=peak,
               checkpoint_fields=fields, checkpoint_bytes=os.path.getsize(path),
               state=c1.env_state)
    mem = f"{peak / 2**30:.2f} GiB" if peak is not None else "not measured (CPU)"
    log(f"training: {n} envs x {steps} steps, {iter_ms:.1f} ms per iteration "
        f"({out['env_steps_per_s']:.1f} env-steps/s; mean of 2 after 1 warm of {warm_s:.1f} s), "
        f"split rollout {rollout_ms:.1f} / GAE {gae_ms:.1f} / update {update_ms:.1f} ms, "
        f"kernel launches per iteration {counts}")
    log("training: update stats " + ", ".join(f"{k} {v:.6g}" for k, v in stats.items())
        + f"; reset share {out['reset_share']:.4f}; peak memory {mem}; params moved "
        f"(max {moved:.3g}); save -> load bit-equal in {fields} fields "
        f"({out['checkpoint_bytes']} B) and one more iteration equal from both")
    return out


def compare_after_iteration(runner, carry, shares=None) -> float:
    """The kernel against its plain version at the training width, flags off
    and on, on the inputs of the step that follows ``carry`` (an iteration's
    end): actions sampled as the rollout samples them, the envs reset in the
    iteration's last step among them.  Draws from the carry's generators, so
    it comes after every check that uses them.  Returns the largest gap."""
    import torch

    env, state = runner.env, carry.env_state
    with torch.no_grad():
        actions = runner.alg.act(carry.ts.params, carry.obs, carry.priv_obs, carry.rng)[0]
    inputs, _ = env.pack_decimation(state, actions, env.contact_cells(state))
    fresh = int((state.episode_length == 0).sum())
    label = f"{env.num_envs} envs after a training iteration ({fresh} just reset)"
    return max(compare(env, inputs, flags, label, shares) for flags in (False, True))


# --- phase 7: the registered tasks, a CLI resume, the export ------------------


def make_task_runner(task: str, num_envs: int, device, log_root: str):
    """``task``'s env and runner through the task registry at ``num_envs``,
    its own config otherwise."""
    import dataclasses

    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    cfg, _ = task_registry.get_cfgs(task)
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, num_envs=num_envs))
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=device)
    runner, _ = task_registry.make_alg_runner(env, task, log_root=log_root, device=device)
    return runner


def compare_cells(env, state) -> dict:
    """The env's contact cells (the supercell gather on rough terrain, the
    analytic plane cache on flat ground) against the per-point reference
    ``gather_contact_cells`` for every contact point of every env of
    ``state``: the same cell for every point and equal corner heights (the
    reference reads the bf16-rounded map, the values the patch table
    stores); raises otherwise.  Also the largest gap to the float32 map."""
    import torch

    from ti5_isaacgym_tpu_torch.physics.contact import gather_contact_cells, packed_cell_corners
    from ti5_isaacgym_tpu_torch.physics.engine_core import _div, contact_point_xy

    px, py = contact_point_xy(env.model, state.phys)
    got = env.contact_cells(state)
    hf = env.heightfield
    heights = ("h00", "h10", "h01", "h11")
    if env.terrain is None:
        # a plane: every corner height is 0, whatever cell holds the point
        want = gather_contact_cells(hf, packed_cell_corners(hf.height), px, py)
        same_cell = reciprocal_moves = None
        bad = [f for f in heights if not (torch.equal(getattr(got, f), getattr(want, f))
                                          and not bool(getattr(got, f).any()))]
        f32_gap = 0.0
    else:
        hf16 = hf.replace(height=hf.height.to(torch.bfloat16).float())
        want = gather_contact_cells(hf16, packed_cell_corners(hf16.height), px, py)
        same_cell = int(((got.x0 == want.x0) & (got.y0 == want.y0)).sum())
        if same_cell != px.numel():
            raise AssertionError(f"the supercell gather picked another cell than "
                                 f"gather_contact_cells for {px.numel() - same_cell} of "
                                 f"{px.numel()} points")
        bad = [f for f in heights if not torch.equal(getattr(got, f), getattr(want, f))]
        want32 = gather_contact_cells(hf, packed_cell_corners(hf.height), px, py)
        f32_gap = max(float((getattr(got, f) - getattr(want32, f)).abs().max()) for f in heights)
        # the points whose cell row or column PyTorch's own division by the
        # cell size (on a card a multiply by the reciprocal) would move: what
        # routing the gathers' divisions through engine_core._div avoids
        moved = torch.zeros_like(px, dtype=torch.bool)
        for p in (px, py):
            moved |= (torch.floor(_div(p + hf.offset, hf.hscale))
                      != torch.floor((p + hf.offset) / hf.hscale))
        reciprocal_moves = int(moved.sum())
    if bad:
        raise AssertionError(f"contact cell corner heights differ from gather_contact_cells "
                             f"in {bad}")
    return {"points": px.numel(), "same_cell": same_cell, "f32_gap": f32_gap,
            "reciprocal_moves": reciprocal_moves}


def phase_task(task: str, runner, timed: int, time_kernel_too: bool = False) -> dict:
    """One registered task's training iterations and checks (phase 7, steps
    1-2): 1 warm iteration, ``timed`` timed ones and one split into rollout /
    GAE / update, each launching the kernel once per step; finite params,
    metrics and losses, params moved; then, on the inputs of the next step,
    the kernel against its plain version (flags off and on, phase 3's
    tolerances) and the env's contact cells against
    ``gather_contact_cells``; with ``time_kernel_too`` the kernel's time,
    the plain version's and the bound at this width (as in phase 5)."""
    import torch

    t_start = time.perf_counter()
    env, dev = runner.env, runner.device
    n, steps = env.num_envs, runner.num_steps_per_env
    iteration = runner._make_iteration()
    carry = runner.init_carry()
    params0 = {k: v.clone() for k, v in carry.ts.params.items()}
    counts = []

    def run(c, mark=None):
        _reset_launch_count()
        c, m = iteration(c, mark)
        _sync(dev)
        counts.append(_launch_count(dev))
        if counts[-1] != steps:
            raise AssertionError(f"a {task} iteration launched the decimation "
                                 f"kernel {counts[-1]} times, expected {steps}")
        for k, v in m.items():
            if not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"training metric {k} is not finite: {v}")
        return c, m

    carry, _ = run(carry)                                  # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(timed):
        carry, metrics = run(carry)
    iter_ms = (time.perf_counter() - t0) / timed * 1e3
    borders = []
    _sync(dev)
    t0 = time.perf_counter()

    def mark(_name):
        _sync(dev)
        borders.append(time.perf_counter())

    carry, metrics = run(carry, mark)
    split = [1e3 * (b - a) for a, b in zip([t0] + borders[:2], borders)]
    for k, v in carry.ts.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"parameter {k} is not finite")
    moved = max(float((carry.ts.params[k] - params0[k]).abs().max()) for k in params0)
    if not moved > 0:
        raise AssertionError("training did not move the parameters")
    cells = compare_cells(env, carry.env_state)
    shares = []
    worst = compare_after_iteration(runner, carry, shares)
    out = dict(num_envs=n, iter_ms=iter_ms, env_steps_per_s=n * steps / (iter_ms / 1e3),
               split_ms=split, launches=counts, worst=worst, bit_equal_share=min(shares),
               cells=cells, params_moved=moved)
    if time_kernel_too and dev.type == "cuda":
        with torch.no_grad():
            actions = runner.alg.act(carry.ts.params, carry.obs, carry.priv_obs, carry.rng)[0]
        inputs, _ = env.pack_decimation(carry.env_state, actions,
                                        env.contact_cells(carry.env_state))
        out["times"] = time_width(env, inputs)
    cell_msg = (f"{cells['same_cell']} of {cells['points']} points in the same cell as "
                f"gather_contact_cells, corner heights equal to the bf16 map "
                f"(max {cells['f32_gap']:.3g} m from the float32 map; PyTorch's own division "
                f"by the cell size would move {cells['reciprocal_moves']} of them)"
                if cells["same_cell"] is not None else
                f"{cells['points']} points on a plane, every corner height 0 both ways")
    log(f"task {task}: {n} envs x {steps} steps, {iter_ms:.1f} ms per iteration "
        f"({out['env_steps_per_s']:.1f} env-steps/s; mean of {timed} after 1 warm), split "
        f"rollout {split[0]:.1f} / GAE {split[1]:.1f} / update {split[2]:.1f} ms, kernel "
        f"launches per iteration {counts}; params moved (max {moved:.3g}); {cell_msg}; "
        f"kernel vs plain {min(shares):.4%} bit-equal, max gap {worst:.3g} "
        f"({time.perf_counter() - t_start:.1f} s)")
    return out


def time_width(env, inputs, reps: int = 50) -> dict:
    """The kernel's time on ``inputs`` (mean of ``reps`` warm launches on
    CUDA events, the host ahead), one launch of the plain version, and the
    bound (phases 5 and 7)."""
    import torch

    from ti5_isaacgym_tpu_torch.physics.megakernel import run_decimation_plain

    args = env.decimation_args()
    ms, host_us, ahead = time_kernel(args, inputs, reps)
    if not ahead:
        raise AssertionError("the host fell behind the device while enqueueing the timed "
                             "launches: the times would be the host's")
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    run_decimation_plain(**args, **inputs)
    t1.record()
    torch.cuda.synchronize()
    bound_ms, bound_by, nbytes, ops = kernel_bound(env, inputs)
    n = int(inputs["state_rows"].shape[1])
    log(f"times ({env.cfg.asset.name}, {n} envs, {env.model.ncp} contact points): kernel "
        f"{ms:.4f} ms (mean of {reps}; host enqueue {host_us:.1f} us per launch, host ahead), "
        f"plain {t0.elapsed_time(t1):.2f} ms, bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B, "
        f"{ops} float32 ops)")
    return dict(ms=ms, host_us=host_us, plain_ms=t0.elapsed_time(t1), bound_ms=bound_ms,
                bound_by=bound_by)


def phase_resume(device, root: str, num_envs: int, task: str = "k1_dh_stand") -> dict:
    """Phase 7, step 3: ``scripts/train.main`` three times: 2 iterations;
    ``--resume --max_iterations 1``; a straight 3-iteration run under
    another log root.  The resume must pick the first run's model_2.pt and
    write model_3.pt, bit-equal (params, Adam state, lr, env state,
    generators) to the straight run's.  Returns the resumed run's runner."""
    import torch

    from ti5_isaacgym_tpu_torch.scripts import train

    t0 = time.perf_counter()
    dev = str(device)

    def cli(log_root, run_name, *flags):
        return train.main(["--task", task, "--num_envs", str(num_envs), "--device", dev,
                           "--log_root", log_root, "--run_name", run_name, "--log_every", "1",
                           *flags])

    def free(runner):
        log_dir = runner.log_dir
        del runner
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return log_dir

    first = free(cli(os.path.join(root, "runs"), "first", "--max_iterations", "2"))
    runner = cli(os.path.join(root, "runs"), "resumed", "--max_iterations", "1", "--resume")
    resumed, picked = runner.log_dir, runner.resume_path
    if picked != os.path.join(first, "model_2.pt"):
        raise AssertionError(f"--resume picked {picked}, not the first run's model_2.pt")
    straight = free(cli(os.path.join(root, "straight"), "straight", "--max_iterations", "3"))
    got = os.path.join(resumed, "model_3.pt")
    if not os.path.exists(got):
        raise AssertionError(f"the resumed run wrote {sorted(os.listdir(resumed))}, no model_3.pt")

    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    a, b = load(got), load(os.path.join(straight, "model_3.pt"))
    if a.pop("iteration") != 3 or b.pop("iteration") != 3:
        raise AssertionError("model_3.pt does not hold iteration 3")
    fields = _bit_equal(a, b, "resumed model_3.pt against the straight run's")
    log(f"resume: {task} at {num_envs} envs, 2 iterations, then --resume from "
        f"{os.path.relpath(picked, ROOT)} for 1, against 3 straight: model_3.pt bit-equal in "
        f"{fields} tensors ({time.perf_counter() - t0:.1f} s)")
    return {"runner": runner, "checkpoint": got, "fields": fields}


def phase_export(device, root: str, runner, task: str = "k1_dh_stand", rows: int = 64) -> dict:
    """Phase 7, step 4: ``scripts/export_policy.main`` on the last checkpoint
    of ``runner``'s run (the resumed run's model_3.pt); ``load_npz`` of the
    export gives the actions of the runner's
    ``get_inference_policy`` and its velocity estimates bit for bit on
    ``rows`` observations of the checkpoint's last step; the port's ONNX
    runtime and the native runtime (``native/ti5_infer.cc`` built with g++
    under ``root``) agree with the forward within 2e-4
    (tests/test_native.py)."""
    import numpy as np
    import torch

    from ti5_isaacgym_tpu_torch.algo import networks as nets
    from ti5_isaacgym_tpu_torch.algo.convert import load_npz
    from ti5_isaacgym_tpu_torch.export import native, onnx_runtime
    from ti5_isaacgym_tpu_torch.export.policy import restore_policy_params
    from ti5_isaacgym_tpu_torch.scripts import export_policy

    t0 = time.perf_counter()
    run_dir, it = runner.log_dir, runner.iteration_count
    paths = export_policy.main(["--task", task, "--log_root", os.path.dirname(run_dir),
                                "--load_run", os.path.basename(run_dir), "--checkpoint", str(it),
                                "--out", os.path.join(root, "export"), "--device", str(device)])
    ckpt = os.path.join(run_dir, f"model_{it}.pt")
    params, _ = restore_policy_params(ckpt)
    params = {k: v.to(device) for k, v in params.items()}
    obs = torch.load(ckpt, map_location="cpu", weights_only=True)["env_state"]["obs_hist"]
    obs = obs[:rows].to(device)
    with torch.no_grad():
        want_act = runner.get_inference_policy(params)(obs)
        want_est = nets.apply(runner.network, params, "estimate_velocity", obs)
        got_act, got_est = load_npz(paths["npz"], device=device).act_inference(obs)
    _bit_equal({"actions": got_act, "velocity": got_est},
               {"actions": want_act, "velocity": want_est}, "load_npz of the export")
    want = torch.cat([want_act, want_est], dim=-1).cpu().numpy()
    obs_np = obs.float().cpu().numpy()
    model = onnx_runtime.load_model(paths["onnx"])    # a batch-1 graph: one row at a time
    got = np.concatenate([np.concatenate([r["action_mean"], r["est_vel"]], -1) for r in
                          (onnx_runtime.run_model(model, {"obs": o[None]}) for o in obs_np)])
    gaps = {"onnx_runtime": float(np.abs(got - want).max())}
    binary = native.build(os.path.join(root, "native"))
    for kind in ("npz", "onnx"):
        got = native.run(binary, paths[kind], obs_np, root)
        gaps[f"native_{kind}"] = float(np.abs(got - want).max())
    bad = {k: v for k, v in gaps.items() if not v <= 2e-4}
    if bad:
        raise AssertionError(f"runtimes differ from the torch forward by more than 2e-4: {bad}")
    log(f"export: {task} model_{it}.pt -> npz, manifest, YAML, ONNX; load_npz bit-equal to the "
        f"runner's policy on {rows} observations of the last step; max |runtime - torch|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f" (limit 2e-4) ({time.perf_counter() - t0:.1f} s)")
    return {"paths": paths, "gaps": gaps}


def phase_golden(root: str) -> list:
    """Phase 7, step 5: the port's export of the committed round-5 policy
    writes ``ti5_dh_policy.onnx`` and ``policy_dh.json`` byte-equal to the
    committed files, and ``export_controller_yaml(T1EnvCfg())`` the
    committed ``policy_config.yaml``."""
    import numpy as np

    from ti5_isaacgym_tpu_torch.algo.convert import params_from_flat
    from ti5_isaacgym_tpu_torch.algo.networks import ActorCriticDH
    from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg
    from ti5_isaacgym_tpu_torch.export.onnx import export_onnx_dh
    from ti5_isaacgym_tpu_torch.export.policy import export_controller_yaml, export_npz

    t0 = time.perf_counter()
    out = os.path.join(root, "golden")
    os.makedirs(out, exist_ok=True)
    with np.load(POLICY) as f:
        params = params_from_flat({k: f[k] for k in f.files})
    written = {"ti5_dh_policy.onnx": export_onnx_dh(params, os.path.join(out, "ti5_dh_policy.onnx")),
               "policy_dh.json": export_npz(ActorCriticDH(num_critic_obs=219), params,
                                            out)[:-len(".npz")] + ".json",
               "policy_config.yaml": export_controller_yaml(T1EnvCfg(), out)}
    for name, path in written.items():
        with open(path, "rb") as got, open(os.path.join(os.path.dirname(POLICY), name), "rb") as want:
            if got.read() != want.read():
                raise AssertionError(f"{name} written by the port differs from the committed one")
    log(f"golden: {', '.join(written)} byte-equal to eval_round5/final/exported "
        f"({time.perf_counter() - t0:.1f} s)")
    return sorted(written)


def phase_tasks(device, root: str = PHASE7_ROOT, k1_envs: int = TRAIN_ENVS,
                flat_envs: int = FLAT_ENVS) -> dict:
    """Phase 7: K1 and flat T1 through the registry, the CLI resume, the
    export and the golden bytes."""
    import shutil

    import torch

    device = torch.device(device)
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for task, n, timed in (("k1_dh_stand", k1_envs, 2), ("t1_flat", flat_envs, 1)):
        runner = make_task_runner(task, n, device, os.path.join(root, "tasks"))
        out[task] = phase_task(task, runner, timed, time_kernel_too=(task == "k1_dh_stand"))
        del runner
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["resume"] = phase_resume(device, root, k1_envs)
    out["export"] = phase_export(device, root, out["resume"].pop("runner"))
    out["golden"] = phase_golden(root)
    return out


# --- phase 8: data parallelism -------------------------------------------------


def expected_collectives(runner) -> dict:
    """The all-reduces of one training iteration by name: the command
    curriculum's sums once per step, the GAE moments once, one gradient+KL
    buffer per minibatch, the metrics once."""
    cfg = runner.ppo_cfg
    return {"curriculum": runner.num_steps_per_env, "gae": 1,
            "update": cfg.num_learning_epochs * cfg.num_mini_batches, "metrics": 1}


def phase8_world1(rank, device, num_envs, terrain_rows, steps, kernel_path_on_cpu):
    """Phase 8 (a), the one rank of a world of 1: a ``ShardedRunner``
    iteration against the plain runner's from the same initial carry, bit
    for bit (params, Adam, lr, env state, generators, metrics as float32),
    with its collectives and kernel launches counted."""
    import torch.distributed as dist

    from ti5_isaacgym_tpu_torch.algo.runner import carry_to_dict
    from ti5_isaacgym_tpu_torch.parallel.trainer import ShardedRunner, shard_carry

    runner = make_runner(num_envs, device, terrain_rows, steps, kernel_path_on_cpu)
    dev = runner.device
    carry0 = runner.init_carry()
    local = shard_carry(carry0, 0, 1, runner.seed)       # before carry0's generators move
    c1, m1 = runner._iter_fn(carry0)
    sharded = ShardedRunner(runner)
    _reset_launch_count()
    c2, m2 = sharded.iteration(local)
    _sync(dev)
    launches, counts = _launch_count(dev), dict(sharded.reduce.counts)
    m1 = {k: v.float() for k, v in m1.items()}     # all-reduced metrics are float32
    fields = _bit_equal({"carry": carry_to_dict(c1), "metrics": m1},
                        {"carry": carry_to_dict(c2), "metrics": m2},
                        "world size 1 against the plain runner")
    if counts != expected_collectives(runner) or launches != runner.num_steps_per_env:
        raise AssertionError(f"world size 1: collectives {counts}, kernel launches {launches}; "
                             f"expected {expected_collectives(runner)} and "
                             f"{runner.num_steps_per_env}")
    return {"backend": dist.get_backend(), "device": str(dev), "fields": fields,
            "counts": counts, "launches": launches,
            "all_reduce_ms": time_gradient_all_reduce(sharded)}


def time_gradient_all_reduce(sharded, reps: int = 8) -> float:
    """ms per all-reduce of one update buffer (the network's float32 params
    plus the KL), the mean of ``reps`` after one warm, synchronised and at a
    barrier on every rank before and after; uncounted."""
    import torch

    from ti5_isaacgym_tpu_torch.parallel.trainer import coordination_barrier

    dev = sharded.runner.device
    size = sum(p.numel() for p in sharded.runner.network.parameters()) + 1
    buf = torch.zeros(size, device=dev)
    sharded.reduce.all_reduce_(buf)
    _sync(dev)
    coordination_barrier("all_reduce_timing")
    t0 = time.perf_counter()
    for _ in range(reps):
        sharded.reduce.all_reduce_(buf)
    _sync(dev)
    coordination_barrier("all_reduce_timed")
    return 1e3 * (time.perf_counter() - t0) / reps


def _gap(got, want, atol, rtol, what):
    """The largest |got - want|; raises where it exceeds atol + rtol |want|."""
    err = (got - want).abs()
    if bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{what}: off by {float(err.max()):.3g} (atol {atol}, rtol {rtol})")
    return float(err.max())


def fullbatch_check(runner, group, carry):
    """The full-batch update (1 epoch x 1 minibatch, the samples in order)
    of this rank's half of the trajectory of one rollout from ``carry``
    (the global initial carry), its gradients and KL averaged over
    ``group``, against the single-process update of the whole trajectory
    (rank 0 computes it): the averaged gradients and params atol 1e-5 rtol
    1e-3 (a gradient summed over the ranks, not averaged, is off by itself;
    Adam's first step, about lr x its sign, would not show it), the four
    losses rtol 2e-4 (the surrogate loss also atol 1e-6), lr rtol 1e-6
    (tests/test_parallel.py:77-89); and the ranks' GAE
    moments: returns and normalised advantages against ``compute_gae`` on
    the whole trajectory, atol 1e-5 rtol 1e-5 (:246-248).  Returns the
    largest gaps (rank 0) and the ranks' stats."""
    import dataclasses

    import torch

    from ti5_isaacgym_tpu_torch.algo.ppo import PPO, mean_grads_
    from ti5_isaacgym_tpu_torch.algo.rollout import Transition, compute_gae, flatten_batch

    cfg = dataclasses.replace(runner.ppo_cfg, num_learning_epochs=1, num_mini_batches=1)
    traj, after, _ = runner.rollout(carry)
    last = runner.alg.value(carry.ts.params, after.priv_obs)
    n = last.shape[0] // group.size
    cols = slice(group.rank * n, (group.rank + 1) * n)
    local = Transition(*(x[:, cols] for x in traj))
    ret, adv = compute_gae(local, last[cols], cfg.gamma, cfg.lam, group=group)
    def in_order(t):
        return torch.arange(t.values.numel(), device=last.device)[None]

    def grads(alg, t, r, a):
        _, _, g = alg.loss_and_grads(carry.ts.params, flatten_batch(t), r.reshape(-1),
                                     a.reshape(-1))
        return g

    alg = PPO(cfg, runner.network, group=group)
    g = grads(alg, local, ret, adv)
    mean_grads_(group, list(g.values()), torch.zeros((), device=last.device))
    ts, m = alg.update(carry.ts, local, ret, adv, indices=in_order(local))
    keys = ("value_loss", "surrogate_loss", "estimator_loss", "kl", "lr")
    stats = group.mean_(torch.stack([m[k] for k in keys]), "stats")
    ret1, adv1 = compute_gae(traj, last, cfg.gamma, cfg.lam)
    gaps = {"returns": _gap(ret, ret1[:, cols], 1e-5, 1e-5, "GAE returns"),
            "advantages": _gap(adv, adv1[:, cols], 1e-5, 1e-5, "normalised advantages")}
    if group.rank == 0:
        alg1 = PPO(cfg, runner.network)
        gaps["grads"] = max(_gap(g[k], v, 1e-5, 1e-3, f"full-batch gradient, {k}")
                            for k, v in grads(alg1, traj, ret1, adv1).items())
        ts1, m1 = alg1.update(carry.ts, traj, ret1, adv1, indices=in_order(traj))
        gaps["params"] = max(_gap(ts.params[k], v, 1e-5, 1e-3, f"full-batch update, {k}")
                             for k, v in ts1.params.items())
        for i, k in enumerate(keys):
            # the one step starts at the behaviour policy (ratio 1), so the
            # surrogate loss is minus the mean of the normalised advantages:
            # zero up to the rounding of a mean over the whole batch
            atol = 1e-6 if k == "surrogate_loss" else 0.0
            gaps[k] = _gap(stats[i], m1[k], atol, 1e-6 if k == "lr" else 2e-4,
                           f"full-batch update, {k}")
    return gaps, stats.tolist()


def phase8_world2(rank, device, num_envs, terrain_rows, steps, kernel_path_on_cpu, root):
    """Phase 8 (b), one of 2 ranks of ``num_envs`` global envs: the
    full-batch check; then training, 1 warm + 2 timed + 1 split iteration,
    each with ``steps`` kernel launches on this rank, its collectives
    counted and params, Adam and lr bit-equal across the ranks; the lead-only
    save, loaded back through ``params_only``; the time of an update
    buffer's all-reduce and of one rollout without the curriculum's
    all-reduce."""
    import torch
    import torch.distributed as dist

    from ti5_isaacgym_tpu_torch.parallel.trainer import (ReduceGroup, ShardedRunner, _generator,
                                                         coordination_barrier, shard_carry)

    runner = make_runner(num_envs, device, terrain_rows, steps, kernel_path_on_cpu)
    dev = runner.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # ShardedRunner.init_carry in two steps: the single-process initial
    # carry (the same on every rank), then this rank's part of it, taken
    # before the full-batch check's rollout moves the carry's generators
    t0 = time.perf_counter()
    carry0 = runner.init_carry()
    carry = shard_carry(carry0, dist.get_rank(), dist.get_world_size(), runner.seed)
    _sync(dev)
    init_s = time.perf_counter() - t0
    gaps, stats = fullbatch_check(runner, ReduceGroup(), carry0)
    del carry0
    check_peak = None
    if dev.type == "cuda":
        check_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    sharded = ShardedRunner(runner)
    gen = _generator(carry.env_state.rng)
    draws = torch.rand(8, generator=gen, device=gen.device).tolist()
    params0 = {k: v.clone() for k, v in carry.ts.params.items()}
    want = expected_collectives(runner)
    launches, replicated, iter_ms, borders = [], [], [], []

    def mark(_name):
        _sync(dev)
        borders.append(time.perf_counter())

    for i in range(4):                          # warm, 2 timed, split
        _reset_launch_count()
        sharded.reduce.counts.clear()
        _sync(dev)
        coordination_barrier("phase8_iteration")
        t0 = time.perf_counter()
        carry, metrics = sharded.iteration(carry, mark if i == 3 else None)
        _sync(dev)
        coordination_barrier("phase8_iteration_done")
        iter_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(_launch_count(dev))
        if launches[-1] != runner.num_steps_per_env or dict(sharded.reduce.counts) != want:
            raise AssertionError(f"rank {rank}, iteration {i}: {launches[-1]} kernel launches, "
                                 f"collectives {dict(sharded.reduce.counts)}; expected "
                                 f"{runner.num_steps_per_env} and {want}")
        for k, v in metrics.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"rank {rank}: training metric {k} is not finite: {v}")
        replicated.append(sharded.check_replicated(carry))
        if replicated[-1] != (0, 0.0):
            raise AssertionError(f"rank {rank}, iteration {i}: the train state differs across "
                                 f"ranks in {replicated[-1][0]} values (max {replicated[-1][1]})")
    split = [1e3 * (b - a) for a, b in zip([t0] + borders[:2], borders)]
    moved = max(float((carry.ts.params[k] - params0[k]).abs().max()) for k in params0)
    if not moved > 0:
        raise AssertionError("training did not move the parameters")
    path = sharded.save(carry, path=os.path.join(root, "model_4.pt"), keep_last=0)
    coordination_barrier("phase8_saved")
    written = sorted(os.listdir(root))
    if written != ["model_4.pt"] or (path is None) != (rank != 0):
        raise AssertionError(f"rank {rank}: save returned {path}; {root} holds {written}, "
                             "expected the lead's model_4.pt alone")
    loaded = runner.load(os.path.join(root, "model_4.pt"), carry=carry, params_only=True)
    _bit_equal(loaded.ts.params, carry.ts.params, "params_only load of the lead's checkpoint")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    all_reduce_ms = time_gradient_all_reduce(sharded)
    # one more rollout on both ranks at once with the curriculum's
    # all-reduce off: what that per-step wait on the other rank costs
    runner.env.group = None
    _sync(dev)
    coordination_barrier("phase8_rollout")
    t0 = time.perf_counter()
    runner.rollout(carry)
    _sync(dev)
    coordination_barrier("phase8_rollout_done")
    rollout_alone_ms = 1e3 * (time.perf_counter() - t0)
    runner.env.group = sharded.reduce
    return {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
            "num_envs": sharded.num_envs,
            "init_s": init_s, "iter_ms": iter_ms, "split_ms": split, "launches": launches,
            "counts": want, "replicated": replicated, "gaps": gaps, "stats": stats,
            "draws": draws, "moved": moved, "peak_bytes": peak, "check_peak_bytes": check_peak,
            "all_reduce_ms": all_reduce_ms, "rollout_alone_ms": rollout_alone_ms}


def parallel_configuration(par: dict) -> dict:
    """Phase 8's entry of the kernels line's ``configurations``: T1 over 2
    ranks, the launches of each rank's iterations."""
    ranks = par["ranks"]
    return dict(task="t1_dh_stand", world_size=len(ranks), backend=par["backend"],
                devices=par["devices"], num_envs_per_rank=ranks[0]["num_envs"],
                launches_per_training_iteration=[r["launches"] for r in ranks],
                collectives_per_training_iteration=ranks[0]["counts"],
                ms_per_training_iteration=par["ms_per_iteration"],
                env_steps_per_s=par["env_steps_per_s"],
                update_all_reduce_ms=par["ranks"][0]["all_reduce_ms"])


def phase_parallel(device="cuda", num_envs: int = TRAIN_ENVS, terrain_rows=None, steps=None,
                   kernel_path_on_cpu: bool = False, root: str = PHASE8_ROOT) -> dict:
    """Phase 8: data parallelism through ``parallel.trainer.spawn_local``,
    (a) world size 1 (NCCL on the card, gloo on the CPU) and (b) world size 2
    at ``num_envs`` global envs: NCCL on two cards where there are two, else
    both ranks on the one card (or the CPU) over gloo with the tensors on
    the device.  A rank's failure fails the phase."""
    import shutil

    import torch

    from ti5_isaacgym_tpu_torch.parallel.trainer import spawn_local

    t_start = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cuda = torch.device(device).type == "cuda"
    cut = (num_envs, terrain_rows, steps, kernel_path_on_cpu)
    (one,) = spawn_local(phase8_world1, ["cuda:0" if cuda else "cpu"],
                         "nccl" if cuda else "gloo", cut)
    log(f"parallel (a): world size 1 over {one['backend']} on {one['device']}, T1 at "
        f"{num_envs} envs from seed {SEED}: a ShardedRunner iteration bit-equal to the plain "
        f"runner's in {one['fields']} tensors; collectives per iteration {one['counts']} "
        f"({sum(one['counts'].values())}); kernel launches {one['launches']}; an update "
        f"buffer's all-reduce {one['all_reduce_ms']:.3f} ms")
    if cuda and torch.cuda.device_count() >= 2:
        devices, backend = ["cuda:0", "cuda:1"], "nccl"
    else:
        devices, backend = ["cuda:0" if cuda else "cpu"] * 2, "gloo"
    ranks = spawn_local(phase8_world2, devices, backend, cut + (root,))
    if ranks[0]["draws"] == ranks[1]["draws"]:
        raise AssertionError("the two ranks' env generators give the same first values")
    gaps = ranks[0]["gaps"]
    spr = max(sum(r["iter_ms"][1:3]) / 2 for r in ranks)
    steps_per_iter = (steps or 24) * num_envs
    env_steps_per_s = steps_per_iter / (spr / 1e3)
    log(f"parallel (b): world size 2 over {backend} on {devices}, "
        f"{ranks[0]['num_envs']} envs per rank: full-batch update against the single "
        f"process, max gaps " + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f"; {spr:.1f} ms per iteration ({env_steps_per_s:.1f} global env-steps/s; mean of 2 "
        f"after 1 warm, synchronised and at a barrier on both ranks); an update buffer's "
        f"all-reduce {ranks[0]['all_reduce_ms']:.3f} ms")
    for r in ranks:
        peak = (f"{r['peak_bytes'] / 2**30:.2f} GiB in training, "
                f"{r['check_peak_bytes'] / 2**30:.2f} GiB in the full-batch check"
                if r["peak_bytes"] is not None else "not measured (CPU)")
        log(f"parallel (b) rank {r['rank']} on {r['device']}: iterations "
            + ", ".join(f"{t:.1f}" for t in r["iter_ms"]) + " ms, split rollout "
            f"{r['split_ms'][0]:.1f} / GAE {r['split_ms'][1]:.1f} / update "
            f"{r['split_ms'][2]:.1f} ms (a rollout without the curriculum's all-reduce "
            f"{r['rollout_alone_ms']:.1f} ms), kernel launches {r['launches']}, collectives per "
            f"iteration {r['counts']}, train state bit-equal across ranks after every "
            f"iteration, init {r['init_s']:.1f} s, peak memory {peak}")
    log(f"parallel: only rank 0 wrote model_4.pt, params_only bit-equal to its params; the "
        f"ranks' env generators start {ranks[0]['draws'][:2]} and {ranks[1]['draws'][:2]} "
        f"({time.perf_counter() - t_start:.1f} s)")
    return {"world1": one, "ranks": ranks, "backend": backend, "devices": devices,
            "ms_per_iteration": spr, "env_steps_per_s": env_steps_per_s}


# --- phase 9: sim2sim's policy step, the overlays, play's new flags -----------


def sim2sim_frames(num: int = SIM2SIM_CALLS + SIM2SIM_WARM, seed: int = SEED) -> list:
    """``num`` deployment frames of T1 built by ``sim2sim.deployment_frame``
    from a numpy-seeded sequence of robot states: joints about the default
    pose, joint and body rates, last actions, a base tilted a little and
    turned, the gait phase of a 0.4 m/s walk."""
    import numpy as np

    from ti5_isaacgym_tpu_torch.scripts import sim2sim
    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    cfg = task_registry.get_cfgs("t1_dh_stand")[0]
    rng = np.random.default_rng(seed)
    dt = cfg.control.decimation * cfg.sim.dt
    frames = []
    for step in range(num):
        yaw, tilt = rng.uniform(-np.pi, np.pi), rng.normal(scale=0.05, size=2)
        quat = np.array([np.cos(yaw / 2), tilt[0], tilt[1], np.sin(yaw / 2)])
        frames.append(sim2sim.deployment_frame(
            cfg, (step * dt / cfg.rewards.cycle_time) % 1.0, (0.4, 0.0, 0.0),
            rng.normal(scale=0.1, size=12), rng.normal(scale=1.0, size=12),
            rng.uniform(-1, 1, size=12).astype(np.float32), rng.normal(scale=0.3, size=3),
            quat / np.linalg.norm(quat)))
    return frames


def phase_sim2sim_policy(devices=("cuda", "cpu")) -> dict:
    """Phase 9 (a): sim2sim's per-step policy (``sim2sim.make_policy`` on the
    round-5 policy) fed through ``sim2sim.push_frame``'s 66-deep history, on
    each device: the outputs of every call within 1e-5 of the first device's,
    and the time per call at batch 1 (the mean of SIM2SIM_CALLS calls after
    SIM2SIM_WARM warm ones, host clock; each call copies its result to the
    host, which waits for the device)."""
    import numpy as np

    from ti5_isaacgym_tpu_torch.algo.convert import load_npz
    from ti5_isaacgym_tpu_torch.scripts import sim2sim

    hist = np.zeros((66, 47), np.float32)
    obs = []
    for frame in sim2sim_frames():
        hist = sim2sim.push_frame(hist, frame)
        obs.append(hist.reshape(1, -1))
    out = {}
    for dev in devices:
        policy = sim2sim.make_policy(load_npz(POLICY), dev)
        results = [policy(o) for o in obs[:SIM2SIM_WARM]]
        t0 = time.perf_counter()
        results += [policy(o) for o in obs[SIM2SIM_WARM:]]
        ms = (time.perf_counter() - t0) / SIM2SIM_CALLS * 1e3
        act = np.concatenate([r[0] for r in results])
        est = np.concatenate([r[1] for r in results])
        if act.shape != (len(obs), 12) or est.shape != (len(obs), 3):
            raise AssertionError(f"sim2sim policy shapes {act.shape}, {est.shape}")
        if not (np.isfinite(act).all() and np.isfinite(est).all()):
            raise AssertionError(f"sim2sim policy on {dev}: outputs not finite")
        out[dev] = dict(ms=ms, act=act, est=est)
    ref = out[devices[0]]
    gaps = {dev: max(float(np.abs(o["act"] - ref["act"]).max()),
                     float(np.abs(o["est"] - ref["est"]).max())) for dev, o in out.items()}
    worst = max(gaps.values())
    if worst > 1e-5:
        raise AssertionError(f"sim2sim policy: devices disagree by {gaps} (limit 1e-5)")
    log(f"sim2sim (a): the round-5 policy on {len(obs)} seeded deployment frames, "
        + ", ".join(f"{dev} {o['ms']:.4f} ms per call" for dev, o in out.items())
        + f" (batch 1, mean of {SIM2SIM_CALLS} after {SIM2SIM_WARM} warm, host clock); act_mean"
        f" and est_vel on {devices[-1]} within {worst:.3g} of {devices[0]} (limit 1e-5)")
    return {"ms": {dev: o["ms"] for dev, o in out.items()}, "max_abs_err": worst}


def phase_overlays(env, state, robots=None) -> dict:
    """Phase 9 (b): the live viewer's overlays (``utils.debug_viz``) for two
    robots of ``state`` on the env's device against the same functions on a
    CPU copy of the fields they read: height-scan points and contact-force
    segments within 1e-5."""
    import copy

    import numpy as np

    from ti5_isaacgym_tpu_torch.utils import debug_viz

    robots = robots or (0, env.num_envs - 1)
    cpu_env = copy.copy(env)
    cpu_env.height_points = env.height_points.cpu()
    cpu_state = state.replace(
        phys=state.phys.replace(base_pos=state.phys.base_pos.cpu(),
                                base_quat=state.phys.base_quat.cpu()),
        terrain_height=state.terrain_height.cpu(), contact_forces=state.contact_forces.cpu())
    worst, segments = 0.0, []
    for r in robots:
        got = debug_viz.height_scan_markers(env, state, r)
        want = debug_viz.height_scan_markers(cpu_env, cpu_state, r)
        if got.shape != (env.height_points.shape[0], 3) or not np.isfinite(got).all():
            raise AssertionError(f"height scan of robot {r}: shape {got.shape} or not finite")
        body_pos = np.tile(got.mean(0), (state.contact_forces.shape[1], 1))
        segs = debug_viz.contact_force_segments(env, state, body_pos, r)
        cpu_segs = debug_viz.contact_force_segments(cpu_env, cpu_state, body_pos, r)
        if len(segs) != len(cpu_segs):
            raise AssertionError(f"robot {r}: {len(segs)} contact segments on the device, "
                                 f"{len(cpu_segs)} on the CPU")
        gaps = [float(np.abs(got - want).max())] + [
            max(float(np.abs(a[1] - b[1]).max()), abs(a[2] - b[2]))
            for a, b in zip(segs, cpu_segs)]
        worst = max(worst, *gaps)
        segments.append(len(segs))
    if worst > 1e-5:
        raise AssertionError(f"overlays: device and CPU differ by {worst} (limit 1e-5)")
    log(f"overlays (b): {env.num_envs} envs, robots {robots}: "
        f"{env.height_points.shape[0]} height-scan points each and {segments} contact "
        f"segments on {env.device} within {worst:.3g} of a CPU copy (limit 1e-5)")
    return {"robots": list(robots), "segments": segments, "max_abs_err": worst}


def phase_play(device="cuda", num_envs: int = NUM_ENVS, steps: int = STEPS,
               root: str = PHASE9_ROOT) -> dict:
    """Phase 9 (c): ``scripts/play.main`` with ``--teleop auto`` on a
    headless host (no joystick, stdin not a tty) and the round-5 policy,
    robot 0's trajectory exported: the headless line printed, the kernel
    launched once per step plus once for the reset's zero-action step,
    a finite ``[steps, 19]`` trajectory."""
    import contextlib
    import io

    import numpy as np
    import torch

    from ti5_isaacgym_tpu_torch.scripts import play

    os.makedirs(root, exist_ok=True)
    traj_path = os.path.join(root, "traj.npz")
    if os.path.exists(traj_path):
        os.remove(traj_path)
    dev = torch.device(device)
    buf, stdin = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO()               # no tty: the keyboard source stays off
    try:
        _reset_launch_count()
        with contextlib.redirect_stdout(buf):
            state, stats = play.main(["--device", device, "--teleop", "auto", "--num_envs",
                                      str(num_envs), "--steps", str(steps), "--policy", POLICY,
                                      "--export_traj", traj_path, "--out_dir", root])
        _sync(dev)
        launches = _launch_count(dev)
    finally:
        sys.stdin = stdin
    text = buf.getvalue()
    if "[play] no teleop source available; using the schedule" not in text:
        raise AssertionError(f"play --teleop auto did not degrade to the schedule:\n{text}")
    want = steps + 1 if dev.type == "cuda" else 0
    if launches != want:
        raise AssertionError(f"play launched the decimation kernel {launches} times, "
                             f"expected {want} ({steps} steps and the reset's)")
    with np.load(traj_path) as f:
        traj = f["qpos"]
    if traj.shape != (steps, 19) or not np.isfinite(traj).all():
        raise AssertionError(f"play's trajectory: shape {traj.shape}, finite "
                             f"{bool(np.isfinite(traj).all())}")
    if not bool(torch.isfinite(state.phys.base_pos).all()):
        raise AssertionError("play's final state is not finite")
    log(f"play (c): --teleop auto at {num_envs} envs, {steps} steps, "
        f"{stats['env_steps_per_s']:.1f} env-steps/s (with per-step logging), kernel launches "
        f"{launches} ({steps} steps and the reset's); '[play] no teleop source available' "
        f"printed; trajectory {traj.shape} finite")
    return {"launches": launches, "env_steps_per_s": stats["env_steps_per_s"]}


# --- phase 10: the training lifecycle -----------------------------------------


def _load_json(rel: str):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def _counted_iterations(runner, records: list):
    """Wrap ``runner._iter_fn`` so that each iteration (as ``learn`` runs it)
    has its kernel launches counted from 0, its wall time taken between two
    synchronisations and its metrics checked finite, into ``records``."""
    import torch

    inner, dev = runner._iter_fn, runner.device

    def iteration(carry, mark=None):
        _sync(dev)
        _reset_launch_count()
        t0 = time.perf_counter()
        carry, metrics = inner(carry, mark)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in metrics.items():
            if not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"training metric {k} is not finite: {v}")
        records.append(dict(launches=_launch_count(dev), ms=ms, metrics={
            k: float(v) for k, v in metrics.items() if v.numel() == 1},
            episode_sums_done=metrics["episode_sums_done"].tolist()))
        return carry, metrics

    runner._iter_fn = iteration


def _watch_events(env, rows: list):
    """Wrap ``env.step`` to record, after each step, the common step and the
    envs with a push velocity set, an external force drawn and one applied
    (``del env.step`` unwraps it)."""
    inner = env.step

    def step(state, actions):
        out = inner(state, actions)
        s = out[0]
        rows.append((int(s.common_step), int((s.push_force != 0).any(-1).sum()),
                     int((s.ext_force != 0).any(-1).sum()),
                     int((s.ext_force_apply != 0).any(-1).sum())))
        return out

    env.step = step


def event_durations(cfg, common_step: int):
    """(push duration s, external-force duration s) of the escalation
    schedules at ``common_step``."""
    dr = cfg.domain_rand
    return (dr.push_duration[min(common_step // dr.update_step, len(dr.push_duration) - 1)],
            dr.add_duration[min(common_step // dr.add_update_step, len(dr.add_duration) - 1)])


def lineage_record(iteration: int, rows: int = 100) -> dict:
    """The mean step reward and episode length of the lineage's last
    ``rows`` logged iterations up to ``iteration`` (its checkpoint's; the
    committed tail of its metrics.csv runs on past it)."""
    import csv

    with open(os.path.join(os.path.dirname(LINEAGE), "metrics.csv")) as f:
        tail = [r for r in csv.DictReader(f) if int(r["iteration"]) <= iteration][-rows:]
    return {"iterations": (int(tail[0]["iteration"]), int(tail[-1]["iteration"])),
            "mean_step_reward": sum(float(r["mean_step_reward"]) for r in tail) / len(tail),
            "mean_episode_length": sum(float(r["mean_episode_length"]) for r in tail)
            / len(tail)}


def push_step(runner, carry):
    """One policy step of ``carry`` through a view of the env with pushes on,
    its common step moved to the start of the next push window: the envs
    pushed and the schedule's durations there.  Returns (carry after the
    step, envs pushed, push duration s)."""
    import copy
    import dataclasses

    import torch

    env, state = runner.env, carry.env_state
    cfg = env.cfg
    pushed_env = copy.copy(env)
    pushed_env.cfg = dataclasses.replace(cfg, domain_rand=dataclasses.replace(
        cfg.domain_rand, push_robots=True))
    cs = int(state.common_step)
    start = cs - cs % env.push_interval + env.push_interval + 1
    state = state.replace(common_step=torch.full_like(state.common_step, start))
    with torch.no_grad():
        actions = runner.alg.act(carry.ts.params, carry.obs, carry.priv_obs, carry.rng)[0]
    state, obs, priv, _, _, _ = pushed_env.step(state, actions)
    pushed = int((state.push_force != 0).any(-1).sum())
    return carry._replace(env_state=state, obs=obs, priv_obs=priv), pushed, \
        event_durations(cfg, start)[0]


def phase_lineage(device, root: str, ckpt: str = None, num_envs: int = LINEAGE_ENVS,
                  shares=None) -> dict:
    """Phase 10 (a): ``scripts/resume_migrate`` from the committed lineage
    at its width, with the checks of the module docstring."""
    from ti5_isaacgym_tpu_torch.algo.runner import to_tensor_dict
    from ti5_isaacgym_tpu_torch.scripts import resume_migrate
    from ti5_isaacgym_tpu_torch.utils import checkpoint as ck

    ckpt = ckpt or LINEAGE
    t0 = time.perf_counter()
    args = resume_migrate.get_args(["--ckpt", ckpt, "--num_envs", str(num_envs), "--iters", "3",
                                    "--log_dir", os.path.join(root, "lineage"),
                                    "--log_every", "1", "--device", str(device)])
    runner, carry = resume_migrate.migrate(args)
    saved = ck.load(ckpt)
    fields = _bit_equal({"ts": to_tensor_dict(carry.ts),
                         "env": {k: getattr(carry.env_state, k) for k in ck.KEEP_ENV_FIELDS}},
                        {"ts": saved["ts"], "env": saved["env_state"]},
                        "the grafted carry against the committed file")
    start_it, count0 = runner.iteration_count, int(carry.ts.count)
    if start_it != saved["iteration"]:
        raise AssertionError(f"the grafted run starts at iteration {start_it}")
    cs0 = int(carry.env_state.common_step)
    records, events = [], []
    _counted_iterations(runner, records)
    _watch_events(runner.env, events)
    carry = runner.learn(1, carry=carry, log_every=1)
    del runner.env.step
    carry = runner.learn(2, carry=carry, log_every=1)
    launches = [r["launches"] for r in records]
    steps = runner.num_steps_per_env
    if launches != [steps] * 3:
        raise AssertionError(f"the lineage's iterations launched the kernel {launches} times, "
                             f"expected {steps} each")
    if runner.iteration_count != start_it + 3 or int(carry.ts.count) != count0 + 3 * \
            runner.ppo_cfg.num_learning_epochs * runner.ppo_cfg.num_mini_batches:
        raise AssertionError(f"iteration {runner.iteration_count}, Adam count "
                             f"{int(carry.ts.count)} after 3 iterations from {start_it}, {count0}")
    if not os.path.exists(os.path.join(root, "lineage", f"model_{start_it + 3}.pt")):
        raise AssertionError(f"no model_{start_it + 3}.pt in {os.path.join(root, 'lineage')}")
    push_s, ext_s = event_durations(runner.env.cfg, cs0)
    ext_steps = [r for r in events if r[3] > 0]
    if not ext_steps:
        raise AssertionError(f"no external force applied in the 24 steps from common step {cs0}")
    if max(r[2] for r in events) != num_envs:
        raise AssertionError(f"an external force was drawn for {max(r[2] for r in events)} of "
                             f"{num_envs} envs in its window")
    pushes_on = runner.env.cfg.domain_rand.push_robots
    if not pushes_on and any(r[1] for r in events):
        raise AssertionError("a push fired with push_robots off")
    carry, pushed, push_s_next = push_step(runner, carry)
    if pushed != num_envs:
        raise AssertionError(f"the push step pushed {pushed} of {num_envs} envs")
    worst = compare_after_iteration(runner, carry, shares)
    timed = records[1:]
    iter_ms = sum(r["ms"] for r in timed) / len(timed)
    n = num_envs
    reset_share = sum(r["metrics"]["done_count"] for r in records) / (n * steps * len(records))
    step_reward = sum(r["metrics"]["mean_step_reward"] for r in records) / len(records)
    record = lineage_record(start_it)
    out = dict(launches=launches, iter_ms=iter_ms, env_steps_per_s=n * steps / (iter_ms / 1e3),
               start_iteration=start_it, adam_count=count0, common_step=cs0, fields=fields,
               ext_steps=len(ext_steps), ext_envs_max=max(r[3] for r in ext_steps),
               ext_s=ext_s, push_s=push_s, pushes_on=pushes_on, pushed=pushed,
               push_s_next=push_s_next, worst=worst, reset_share=reset_share,
               mean_step_reward=step_reward, losses=records[-1]["metrics"], lineage=record,
               seconds=time.perf_counter() - t0)
    log(f"lineage (a): {os.path.relpath(ckpt, ROOT)} grafted at {n} envs ({fields} tensors "
        f"bit-equal to the file), iteration {start_it} -> {runner.iteration_count}, Adam count "
        f"{count0}; kernel launches per iteration {launches}; {iter_ms:.1f} ms per iteration "
        f"({out['env_steps_per_s']:.1f} env-steps/s, mean of 2 after 1 warm); common step "
        f"{cs0}: external force {ext_s} s, drawn for all {n} envs, applied in {len(ext_steps)} "
        f"steps to up to "
        f"{out['ext_envs_max']} envs; pushes {'on' if pushes_on else 'off in its config'} "
        f"({push_s} s by the schedule), a step at the next window start with pushes on pushed "
        f"{pushed} envs ({push_s_next} s); reset share {reset_share:.4f}, mean step reward "
        f"{step_reward:.5f} (the lineage's iterations {record['iterations'][0]}-"
        f"{record['iterations'][1]}: mean step reward {record['mean_step_reward']:.5f}, episode "
        f"length {record['mean_episode_length']:.1f}); last losses "
        + ", ".join(f"{k} {v:.4g}" for k, v in records[-1]["metrics"].items()
                    if k in ("value_loss", "surrogate_loss", "estimator_loss")))
    return out


def phase_bootstrap(device, root: str, num_envs: int = LINEAGE_ENVS) -> dict:
    """Phase 10 (b): ``scripts/train_walk``'s phases at ``num_envs`` with
    one iteration each: phase A through ``scripts/train`` with the overlay
    and the shaped scales, the reheat, phase B through
    ``scripts/resume_migrate`` from the reheated file."""
    import torch

    from ti5_isaacgym_tpu_torch.scripts import reheat_std, resume_migrate, train, train_walk
    from ti5_isaacgym_tpu_torch.utils import checkpoint as ck

    t0 = time.perf_counter()
    dev = torch.device(device)
    k = train_walk.knobs(["--device", str(device), "--log_root", os.path.join(root, "walk")],
                         environ={"NUM_ENVS": str(num_envs), "P1_ITERS": "1", "P2_ITERS": "1",
                                  "LOG_EVERY": "1"})
    _reset_launch_count()
    runner_a = train.main(train_walk.phase_a_argv(k))
    _sync(dev)
    launches_a = _launch_count(dev)
    cfg_a = runner_a.env.cfg
    scales = dict(cfg_a.rewards.scales)
    if not cfg_a.env.use_ref_actions or scales["feet_air_time"] != 8.0:
        raise AssertionError("phase A ran without the overlay or the shaped scales")
    ckpt = train_walk.newest_in(runner_a.log_dir)
    del runner_a
    reheated = reheat_std.main([ckpt, train_walk.reheated_path(ckpt), "--std", str(k.std),
                                "--device", str(device)])
    ts = ck.load(reheated)["ts"]
    std = torch.tensor(k.std, dtype=torch.float32)
    if not (bool((ts["params"]["std"] == std).all()) and not bool(ts["mu"]["std"].any())
            and not bool(ts["nu"]["std"].any())):
        raise AssertionError("the reheated file's std is not 0.4 with zero Adam moments")
    log_dir = os.path.join(k.log_root, "walkB")
    runner_b, carry = resume_migrate.migrate(
        resume_migrate.get_args(train_walk.phase_b_argv(k, reheated, log_dir)))
    if not (bool((carry.ts.params["std"] == std.to(dev)).all())
            and not bool(carry.ts.mu["std"].any()) and not bool(carry.ts.nu["std"].any())):
        raise AssertionError("phase B did not start from the reheated std")
    if runner_b.env.cfg.env.use_ref_actions:
        raise AssertionError("phase B runs with the overlay on")
    _reset_launch_count()
    runner_b.learn(k.p2_iters, carry=carry, log_every=1)
    _sync(dev)
    launches_b = _launch_count(dev)
    steps = runner_b.num_steps_per_env
    # phase A's count holds its runner's reset (one zero-action step) too
    if [launches_a, launches_b] != [steps + 1, steps]:
        raise AssertionError(f"the bootstrap's phases launched the kernel {launches_a} and "
                             f"{launches_b} times, expected {steps + 1} (the iteration and "
                             f"the reset's step) and {steps}")
    if not os.path.exists(os.path.join(log_dir, "model_2.pt")):
        raise AssertionError(f"phase B wrote no model_2.pt into {log_dir}")
    out = dict(launches=[launches_a, launches_b], seconds=time.perf_counter() - t0)
    log(f"bootstrap (b): train_walk at {num_envs} envs, phase A (use_ref_actions 1, "
        f"{train_walk.SHAPING}) {launches_a} launches (its iteration and the reset's step), "
        f"std reheated to "
        f"{k.std} exactly with its Adam moments zero, phase B from the reheated file (overlay "
        f"off) {launches_b} launches, model_2.pt written ({out['seconds']:.1f} s)")
    return out


def gait_spread(grf, vx, dt, weight, settle: int, group: int = 4) -> dict:
    """Each statistic of :func:`contact_stats.gait_stats` and the mean vx
    over the groups of ``group`` envs: mean, standard deviation, min, max."""
    import numpy as np

    from ti5_isaacgym_tpu_torch.scripts import contact_stats as cs

    half = vx[len(vx) // 2:]
    per = [dict(cs.gait_stats(grf[:, i:i + group], dt, weight, settle),
                mean_vx=float(half[:, i:i + group].mean()))
           for i in range(0, grf.shape[1], group)]
    return {k: dict(mean=float(np.mean([p[k] for p in per])),
                    std=float(np.std([p[k] for p in per], ddof=1)),
                    min=float(np.min([p[k] for p in per])),
                    max=float(np.max([p[k] for p in per]))) for k in per[0]}


def check_within(got: dict, want: dict, tol: dict, what: str):
    """Raise unless every ``got[k]`` lies within ``tol[k]`` of ``want[k]``."""
    bad = {k: (got[k], want[k], tol[k]) for k in tol if not abs(got[k] - want[k]) <= tol[k]}
    if bad:
        raise AssertionError(f"{what} outside its tolerance (got, JAX engine, tolerance): {bad}")


def phase_oracle(device, steps: int = ORACLE_STEPS, wide_envs: int = LINEAGE_ENVS,
                 drop_steps: int = DROP_STEPS, check: bool = True) -> dict:
    """Phase 10 (c): the oracle's engine half with the round-5 policy: the
    gait statistics at 4 envs and at ``wide_envs`` against the engine column
    of ``eval_round5/contact_stats.json``, the spread of the wide run's
    groups of 4, and the matched drop against ``eval_round5/matched_drop.json``
    (``check`` False: a short CPU rehearsal, nothing held)."""
    import numpy as np
    import torch

    from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv
    from ti5_isaacgym_tpu_torch.scripts import contact_stats as cs
    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    t0 = time.perf_counter()
    dev = torch.device(device)
    env_cfg = task_registry.get_cfgs("t1_dh_stand")[0]
    network = cs.load_policy_network(env_cfg, npz=POLICY)
    ref = _load_json("eval_round5/contact_stats.json")
    want = {k: v["engine"] for k, v in ref["stats"].items()}
    want["mean_vx"] = ref["mean_vx"]["engine"]
    cmd = ref["cmd"]
    _reset_launch_count()
    g4, vx4, weight, dt = cs.run_engine(env_cfg, None, cmd, steps, device=device,
                                        network=network)
    launches4 = _launch_count(dev)
    s4 = dict(cs.gait_stats(g4, dt, weight, min(cs.SETTLE, steps // 2)), mean_vx=vx4)
    env = T1DHStandEnv(cs.engine_cfg(env_cfg, wide_envs), seed=11, device=dev)
    state, obs, _ = env.reset(env.init_state(11))
    _reset_launch_count()
    t1 = time.perf_counter()
    gw, vxw, resets = cs.engine_rollout(env, network.to(dev).eval(), state, obs, cmd, steps)
    wide_s = time.perf_counter() - t1
    launches_w = _launch_count(dev)
    kernel_path = env.use_kernel_path
    del env, state, obs
    settle = min(cs.SETTLE, steps // 2)
    sw = dict(cs.gait_stats(gw, dt, weight, settle), mean_vx=float(np.mean(vxw[len(vxw) // 2:])))
    spread = gait_spread(gw, vxw, dt, weight, settle) if check else {}
    for name, grf in (("4-env", g4), ("wide", gw)):
        if not np.isfinite(grf).all():
            raise AssertionError(f"the oracle's {name} run has non-finite forces")
    mine = _load_json("eval_round5/matched_drop.json")["engine"]
    _reset_launch_count()
    g, z, ddt = cs.drop_engine(env_cfg, steps=drop_steps, device=device)
    launches_drop = _launch_count(dev)
    drop = cs.drop_stats(g, z, ddt)
    # one launch per step; run_engine and drop_engine reset their env inside
    # (one more), and the drop's last step (env 0 done) is launched, not kept
    expected = (steps + 1, steps, len(z) + 1 + (len(z) < drop_steps)) if kernel_path \
        else (0, 0, 0)
    if (launches4, launches_w, launches_drop) != expected:
        raise AssertionError(f"the oracle's runs launched the kernel {launches4}, {launches_w}, "
                             f"{launches_drop} times, expected {expected}")
    if check:
        check_within(s4, want, ORACLE_TOL, f"the gait statistics at 4 envs, {steps} steps")
        check_within(sw, want, ORACLE_TOL, f"the gait statistics at {wide_envs} envs")
        check_within(drop, mine, DROP_TOL, "the matched drop")
    out = dict(stats4=s4, stats_wide=sw, spread=spread, drop=drop, launches4=launches4,
               resets_wide=int(resets.sum()), envs_reset_wide=int((resets > 0).sum()),
               # the envs stand on a square grid, row by row: each quarter of
               # the env indices is a band of distance from the origin along x
               envs_reset_by_quarter=[int((q > 0).sum()) for q in np.array_split(resets, 4)],
               launches_wide=launches_w, launches_drop=launches_drop, drop_steps=len(z),
               wide_s=wide_s, seconds=time.perf_counter() - t0)
    log(f"oracle (c): the round-5 policy at cmd {cmd}, {steps} steps; kernel launches "
        f"{launches4} (4 envs), {launches_w} ({wide_envs} envs, {wide_s:.1f} s; "
        f"{out['envs_reset_wide']} envs fell and restarted, {out['resets_wide']} times in all; "
        f"by quarter of the env index, nearest the origin first: "
        f"{out['envs_reset_by_quarter']}), "
        f"{launches_drop} (drop, {len(z)} steps)")
    for k in want:
        sp = spread.get(k)
        log(f"oracle (c): {k:20s} JAX engine {want[k]:10.4f} | 4 envs {s4[k]:10.4f} | "
            f"{wide_envs} envs {sw[k]:10.4f} | tolerance {ORACLE_TOL[k]:.4g}"
            + (f" | groups of 4: mean {sp['mean']:.4f} std {sp['std']:.4f} min {sp['min']:.4f} "
               f"max {sp['max']:.4f}" if sp else ""))
    log("oracle (c): matched drop " + ", ".join(
        f"{k} {drop[k]:.4f} (JAX {mine[k]:.4f}, tolerance {DROP_TOL[k]:.4g})" for k in drop))
    return out


def phase_lifecycle(device="cuda", root: str = PHASE10_ROOT) -> dict:
    """Phase 10: (a) the lineage, (b) the bootstrap, (c) the oracle's
    engine half."""
    import shutil

    import torch

    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    shares = []
    out = {"lineage": phase_lineage(device, root, shares=shares)}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["bootstrap"] = phase_bootstrap(device, root)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["oracle"] = phase_oracle(device)
    out["bit_equal_share"] = min(shares)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 10: {out['seconds']:.1f} s")
    return out


def lifecycle_configuration(life: dict) -> dict:
    """Phase 10's ``configurations`` entry of the kernels' JSON line."""
    o = life["oracle"]
    return dict(phase=10, task="t1_dh_stand", num_envs=[LINEAGE_ENVS, 4, LINEAGE_ENVS],
                bit_equal_share=life["bit_equal_share"],
                max_abs_err=life["lineage"]["worst"],
                launches_per_training_iteration={
                    "lineage": life["lineage"]["launches"],
                    "bootstrap_phase_b": life["bootstrap"]["launches"][1:]},
                launches_bootstrap_phase_a_with_reset=life["bootstrap"]["launches"][0],
                launches_oracle={"4_envs": o["launches4"], f"{LINEAGE_ENVS}_envs": o["launches_wide"],
                                 "drop": o["launches_drop"]})


# --- phase 11: the asset pipeline, the long training run -----------------------


def spec_gap(a, b, path: str = "spec") -> float:
    """The largest gap between the numbers of two model specs; raises where
    their structure or another leaf differs (the base's ``merged_links``
    aside: a spec's URDF has no fixed joints left to collapse)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {sorted(set(a) ^ set(b))} differ")
        return max((spec_gap(a[k], b[k], f"{path}.{k}") for k in a if k != "merged_links"),
                   default=0.0)
    if isinstance(a, list):
        if len(a) != len(b):
            raise AssertionError(f"{path}: {len(a)} against {len(b)} entries")
        return max((spec_gap(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))),
                   default=0.0)
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return abs(float(a) - float(b))
    if a != b:
        raise AssertionError(f"{path}: {a!r} against {b!r}")
    return 0.0


def compare_specs(env_a, env_b, inputs, flags: bool) -> tuple:
    """The kernel with ``env_b``'s model against the kernel with ``env_a``'s
    on the same decimation inputs, within :data:`TOLERANCES`: (largest gap,
    bit-equal share)."""
    from ti5_isaacgym_tpu_torch.physics.megakernel import run_decimation

    want, got = (run_decimation(**dict(e.decimation_args(), use_coulomb=flags,
                                       use_noise=flags), **inputs) for e in (env_a, env_b))
    return within_tolerances(got, want, f"the round-tripped spec, flags {flags}")[:2]


def phase_assets(device, root: str, k1_envs: int = TRAIN_ENVS, t1_envs: int = NUM_ENVS,
                 terrain_rows=None, settle_steps: int = SETTLE_STEPS, shares=None) -> dict:
    """Phase 11 (a): K1's URDF from ``scripts/make_k1_urdf`` and its spec
    from ``scripts/extract_model`` (byte-equal to the committed spec), K1
    built from that file through the registry at ``k1_envs``, one training
    iteration with its launches counted, then the kernel against its plain
    version on the next step's inputs; T1's spec through
    ``scripts/spec_to_urdf`` and back, T1 at ``t1_envs`` with it and with
    the committed spec on one decimation's inputs, the kernel's outputs of
    the two within phase 3's tolerances, flags off and on."""
    import dataclasses

    import torch

    from ti5_isaacgym_tpu_torch.physics.model import RESOURCES
    from ti5_isaacgym_tpu_torch.scripts import extract_model, make_k1_urdf, spec_to_urdf
    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    t0 = time.perf_counter()
    k1_spec = os.path.join(root, "k1", "k1_model.json")
    extract_model.main([make_k1_urdf.main(["-o", os.path.join(root, "k1", "k1.urdf")]),
                        "-o", k1_spec])
    with open(k1_spec) as f, open(os.path.join(RESOURCES, "k1_model.json")) as g:
        if f.read() != g.read():
            raise AssertionError(f"{k1_spec} differs from the committed k1_model.json")
    cfg, _ = task_registry.get_cfgs("k1_dh_stand")
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, num_envs=k1_envs),
                              asset=dataclasses.replace(cfg.asset, model_spec=k1_spec))
    env, _ = task_registry.make_env("k1_dh_stand", env_cfg=cfg, device=device)
    runner, _ = task_registry.make_alg_runner(env, "k1_dh_stand", log_root=root, device=device)
    dev, steps = runner.device, runner.num_steps_per_env
    carry = runner.init_carry()
    _sync(dev)
    _reset_launch_count()
    carry, metrics = runner._make_iteration()(carry)
    _sync(dev)
    k1_launches = _launch_count(dev)
    if k1_launches != steps:
        raise AssertionError(f"K1 from the extracted spec launched the kernel {k1_launches} "
                             f"times in an iteration, expected {steps}")
    bad = [k for k, v in list(metrics.items()) + list(carry.ts.params.items())
           if not bool(torch.isfinite(v.float()).all())]
    if bad:
        raise AssertionError(f"K1 from the extracted spec: {bad} not finite")
    k1_worst = compare_after_iteration(runner, carry, shares)
    del runner, env, carry
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with open(os.path.join(RESOURCES, "t1_model.json")) as f:
        committed = json.load(f)
    t1_urdf = os.path.join(root, "t1", "t1.urdf")
    os.makedirs(os.path.dirname(t1_urdf), exist_ok=True)
    with open(t1_urdf, "w") as f:
        f.write(spec_to_urdf.spec_to_urdf(committed))
    t1_spec = os.path.join(root, "t1", "t1_model.json")
    gap = spec_gap(committed, extract_model.main([t1_urdf, "-o", t1_spec]))
    if gap > 1e-8:      # tests/test_asset_roundtrip.py's tolerance
        raise AssertionError(f"the round-tripped T1 spec is {gap:.3g} from the committed one")
    env_a, policy, state, obs = make_env(t1_envs, device, terrain_rows, settle_steps)
    env_b = type(env_a)(dataclasses.replace(env_a.cfg, asset=dataclasses.replace(
        env_a.cfg.asset, model_spec=t1_spec)), terrain=env_a.terrain, seed=SEED, device=device)
    inputs = decimation_inputs(env_a, state, obs, policy)
    t1 = [compare_specs(env_a, env_b, inputs, flags) for flags in (False, True)]
    out = dict(k1_envs=k1_envs, k1_launches=k1_launches, k1_worst=k1_worst, t1_envs=t1_envs,
               spec_gap=gap, t1_worst=max(w for w, _ in t1), t1_share=min(s for _, s in t1),
               seconds=time.perf_counter() - t0)
    log(f"assets (a): make_k1_urdf -> extract_model byte-equal to the committed k1_model.json; "
        f"K1 from it at {k1_envs} envs: {k1_launches} launches in one iteration, kernel vs "
        f"plain max gap {k1_worst:.3g}; T1 through spec_to_urdf and extract_model within "
        f"{gap:.3g} of the committed spec, the kernel with it at {t1_envs} envs within "
        f"{out['t1_worst']:.3g} of the committed spec's ({out['t1_share']:.4%} of output "
        f"values bit-equal; flags off and on) ({out['seconds']:.1f} s)")
    return out


def _count_falls(env) -> list:
    """Wrap ``env.step`` to count, on the device, the episodes that end by a
    fall (done, not timed out) into the returned list's one tensor
    (``del env.step`` unwraps it)."""
    import torch

    inner, count = env.step, [torch.zeros((), dtype=torch.int64, device=env.device)]

    def step(state, actions):
        out = inner(state, actions)
        count[0] += (out[4] & ~out[5]["time_outs"]).sum()
        return out

    env.step = step
    return count


def phase_long_run(device, root: str, ckpt: str = None, num_envs: int = LINEAGE_ENVS,
                   iters: int = LONG_ITERS, hold=LONG_HOLD, bounds=LONG_RUN_BOUNDS) -> dict:
    """Phase 11 (b): ``scripts/resume_migrate`` from the committed lineage
    at ``num_envs`` for ``iters`` iterations through ``learn``, every one
    launching the kernel once per step, finite params and metrics, the
    iteration and Adam counts moving on, ``metrics.csv`` with the JAX
    columns; the means over the iterations ``hold`` (after the graft) of
    the step reward, the terrain level, the CSV's episode length and
    air-time term, and the length and air-time term of the episodes that
    ended there, each within ``bounds`` (None: reported only)."""
    import csv

    import torch

    from ti5_isaacgym_tpu_torch.scripts import resume_migrate

    ckpt = ckpt or LINEAGE
    t0 = time.perf_counter()
    log_dir = os.path.join(root, "lineage")
    args = resume_migrate.get_args(["--ckpt", ckpt, "--num_envs", str(num_envs), "--iters",
                                    str(iters), "--log_dir", log_dir, "--log_every", "20",
                                    "--device", str(device)])
    runner, carry = resume_migrate.migrate(args)
    start_it, count0 = runner.iteration_count, int(carry.ts.count)
    records = []
    _counted_iterations(runner, records)
    falls = _count_falls(runner.env)
    carry = runner.learn(iters, carry=carry, log_every=20)
    del runner.env.step
    steps, cfg = runner.num_steps_per_env, runner.ppo_cfg
    launches = [r["launches"] for r in records]
    if launches != [steps] * iters:
        raise AssertionError(f"the long run launched the kernel {sorted(set(launches))} times "
                             f"per iteration, expected {steps} in each of {iters}")
    adam = int(carry.ts.count) - count0
    if runner.iteration_count != start_it + iters or \
            adam != iters * cfg.num_learning_epochs * cfg.num_mini_batches:
        raise AssertionError(f"iteration {runner.iteration_count}, Adam count +{adam} after "
                             f"{iters} iterations from {start_it}")
    bad = [k for k, v in carry.ts.params.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"parameters {bad} are not finite after the long run")
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    with open(os.path.join(os.path.dirname(LINEAGE), "metrics.csv")) as f:
        jax_rows = list(csv.DictReader(f))
    missing = set(jax_rows[0]) - set(rows[0])
    if missing or [int(r["iteration"]) for r in rows] != list(range(start_it + 1,
                                                                    start_it + iters + 1)):
        raise AssertionError(f"metrics.csv lacks the JAX columns {sorted(missing)} or rows")
    held, ended = rows[hold[0] - 1:hold[1]], records[hold[0] - 1:hold[1]]
    air = runner.env.reward_names.index("feet_air_time")
    n_ended = max(sum(r["metrics"]["done_count"] for r in ended), 1.0)
    means = {k: sum(float(r[k]) for r in held) / len(held)
             for k in ("mean_step_reward", "terrain_level", "mean_episode_length",
                       "rew_feet_air_time")}
    means["ended_episode_length"] = sum(r["metrics"]["ep_len_sum"] for r in ended) / n_ended
    means["ended_feet_air_time"] = sum(r["episode_sums_done"][air] for r in ended) / n_ended
    jax = {k: sum(float(r[k]) for r in jax_rows) / len(jax_rows)
           for k in ("mean_step_reward", "terrain_level", "mean_episode_length",
                     "rew_feet_air_time")}
    jax["ended_episode_length"], jax["ended_feet_air_time"] = (jax["mean_episode_length"],
                                                               jax["rew_feet_air_time"])
    timed = records[1:] or records
    iter_ms = sum(r["ms"] for r in timed) / len(timed)
    waves = [int(records[i - 1]["metrics"]["done_count"]) for i in (100, 201) if i <= iters]
    out = dict(launches=launches, start_iteration=start_it, adam_steps=adam, means=means,
               iter_ms=iter_ms, env_steps_per_s=num_envs * steps / (iter_ms / 1e3),
               ended=n_ended, falls=int(falls[0]), waves=waves,
               seconds=time.perf_counter() - t0)
    misses = [k for k, (lo, hi) in (bounds or {}).items() if not lo <= means[k] <= hi]
    log(f"long run (b): {os.path.relpath(ckpt, ROOT)} grafted at {num_envs} envs, iteration "
        f"{start_it} -> {runner.iteration_count}, Adam count +{adam}, {steps} launches in each "
        f"of {iters} iterations; {iter_ms:.1f} ms per iteration ({out['env_steps_per_s']:.1f} "
        f"env-steps/s, mean of {len(timed)} after the first); {n_ended:.0f} episodes ended in "
        f"iterations {hold[0]}-{hold[1]}, {out['falls']} falls in the run, time-out waves of "
        f"{waves} episodes in iterations 100 and 201; means over iterations {hold[0]}-{hold[1]} "
        f"(JAX rows' mean, bound): " + "; ".join(
            f"{k} {means[k]:.6g} ({jax[k]:.6g}, "
            + ("[{:.6g}, {:.6g}])".format(*bounds[k]) if k in (bounds or {}) else "unchecked)")
            for k in means) + f" ({out['seconds']:.1f} s)")
    if misses:
        raise AssertionError(f"the long run's means of {misses} are outside their bounds")
    return out


def phase_assets_long_run(device="cuda", root: str = PHASE11_ROOT) -> dict:
    """Phase 11: (a) the asset pipeline, (b) the long training run."""
    import shutil

    import torch

    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    shares = []
    out = {"assets": phase_assets(device, root, shares=shares)}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["long_run"] = phase_long_run(device, root)
    out["bit_equal_share"] = min(shares)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 11: {out['seconds']:.1f} s")
    return out


def assets_configurations(p11: dict) -> list:
    """Phase 11's ``configurations`` entries of the kernels' JSON line."""
    a, b = p11["assets"], p11["long_run"]
    return [dict(phase=11, task="k1_dh_stand", spec="make_k1_urdf -> extract_model",
                 num_envs=[a["k1_envs"]], bit_equal_share=p11["bit_equal_share"],
                 max_abs_err=a["k1_worst"], launches_per_training_iteration=[a["k1_launches"]]),
            dict(phase=11, task="t1_dh_stand", spec="spec_to_urdf -> extract_model",
                 num_envs=[a["t1_envs"]], spec_gap=a["spec_gap"],
                 max_abs_err_against_the_committed_spec=a["t1_worst"],
                 bit_equal_share_against_the_committed_spec=a["t1_share"]),
            dict(phase=11, task="t1_dh_stand", run="the 71k lineage, long",
                 num_envs=[LINEAGE_ENVS], iterations=len(b["launches"]),
                 launches_per_training_iteration=sorted(set(b["launches"])),
                 iter_ms=b["iter_ms"], means=b["means"])]


def main():
    smi, name = phase_device()
    import torch

    build = phase_build()
    launches, worst, times, stats, shares = rollout_phases()
    runner = make_runner(TRAIN_ENVS, "cuda")
    train = phase_train(runner)
    t9 = time.perf_counter()
    overlays = phase_overlays(runner.env, train.pop("state"))
    t9 = time.perf_counter() - t9
    del runner
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tasks = phase_tasks("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    par = phase_parallel("cuda")
    t0 = time.perf_counter()
    sim2sim = phase_sim2sim_policy()
    viewers = phase_play("cuda")
    t9 += time.perf_counter() - t0
    log(f"phase 9: {t9:.1f} s; sim2sim's policy {sim2sim['ms']['cuda']:.4f} ms per call on "
        f"the card, overlays within {overlays['max_abs_err']:.3g}, play --teleop auto "
        f"{viewers['launches']} launches")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    life = phase_lifecycle("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    p11 = phase_assets_long_run("cuda")
    log(f"done: build {build['seconds']:.1f} s, rollout {stats['env_steps_per_s']:.1f} "
        f"env-steps/s, training {train['env_steps_per_s']:.1f} env-steps/s (T1), "
        f"{tasks['k1_dh_stand']['env_steps_per_s']:.1f} (K1), "
        f"{tasks['t1_flat']['env_steps_per_s']:.1f} (t1_flat), "
        f"{par['env_steps_per_s']:.1f} (T1 over 2 ranks), the lineage at {LINEAGE_ENVS} envs "
        f"{life['lineage']['env_steps_per_s']:.1f} (3 iterations) and "
        f"{p11['long_run']['env_steps_per_s']:.1f} ({LONG_ITERS} iterations) on {smi}")
    configs = [dict(task="t1_dh_stand", num_envs=[NUM_ENVS, TRAIN_ENVS],
                    bit_equal_share=min(shares + [train["bit_equal_share"]]),
                    max_abs_err=max(worst, train["worst"]),
                    launches_per_training_iteration=train["launches"])]
    for task in ("k1_dh_stand", "t1_flat"):
        t = tasks[task]
        configs.append(dict(task=task, num_envs=t["num_envs"],
                            bit_equal_share=t["bit_equal_share"], max_abs_err=t["worst"],
                            launches_per_training_iteration=t["launches"],
                            **{k: v for k, v in t.get("times", {}).items() if k != "host_us"}))
    worst = max(c["max_abs_err"] for c in configs)
    configs.append(parallel_configuration(par))
    configs.append(lifecycle_configuration(life))
    configs += assets_configurations(p11)
    worst = max(worst, life["lineage"]["worst"], p11["assets"]["k1_worst"])
    for line in result_lines(smi, name, torch.cuda.device_count(), launches, worst, times,
                             train["launches"], configs):
        print(line, flush=True)


def rollout_phases():
    """Phases 3-5 at NUM_ENVS; their env is freed on return."""
    env, policy, state, obs = make_env(NUM_ENVS, "cuda")
    shares = []
    worst = phase_compare(env, state, obs, policy, shares)
    state, obs, launches, stats = phase_rollout(env, policy, state, obs)
    if launches != STEPS:
        raise AssertionError(f"main path launched the decimation kernel {launches} times, "
                             f"expected {STEPS}")
    times = phase_times(env, state, obs, policy)
    return launches, worst, times, stats, shares


def result_lines(smi, name, count, launches, worst, times, train_launches, configs=()):
    """The last three lines: the kernels' JSON, the nvidia-smi line, the
    contract's result line.  ``ms`` is at NUM_ENVS envs, ``ms_8192_envs`` at
    twice that; ``launches`` counts the rollout of phase 4,
    ``launches_per_training_iteration`` lists the count of each iteration of
    phase 6; ``max_abs_err`` is the largest gap of the kernel to its plain
    version (phases 3, 6, 7, 10 and 11);
    ``configurations`` has, per task the kernel ran (phases 3-6 for
    ``t1_dh_stand``, phase 7 for ``k1_dh_stand`` and ``t1_flat``), its
    widths, the bit-equal share of its comparisons, their largest gap, its
    launches per training iteration and, for K1, the kernel's times; and
    phase 8's entry (:func:`parallel_configuration`), phase 10's
    (:func:`lifecycle_configuration`) and phase 11's three
    (:func:`assets_configurations`)."""
    kernels = {"kernels": [{
        "name": "run_decimation", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "launches_per_training_iteration": train_launches, "max_abs_err": worst,
        "ms": times["ms"], f"ms_{2 * NUM_ENVS}_envs": times["ms_wide"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": None,
        "configurations": list(configs)}]}
    return [json.dumps(kernels), smi,
            json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})]


if __name__ == "__main__":
    # every failure propagates to a traceback and exit code 1; os._exit skips
    # interpreter teardown (CUDA context, ctypes library) after the last line
    try:
        main()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
