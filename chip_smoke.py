#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, the ``t1_dh_stand`` policy rollout, at the
task's full width: 4096 envs, the 20x20 rough-terrain grid, full domain
randomization, action/dof/IMU lag, the decimation kernel on.  Phases, each
printing one line with its elapsed seconds:

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
   bound.

It then prints the kernels' JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
line.  Imports only the port, torch, numpy and the standard library; needs
no network; writes only under ``build/``.
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


def compare(env, inputs, flags: bool, label: str) -> float:
    """``run_decimation`` on the env's device against ``run_decimation_plain``
    on the same inputs; raises if an output is not finite or out of its
    tolerance, else returns the largest gap."""
    import torch

    from ti5_isaacgym_tpu_torch.physics.megakernel import run_decimation, run_decimation_plain

    args = dict(env.decimation_args(), use_coulomb=flags, use_noise=flags)
    got = run_decimation(**args, **inputs)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    want = run_decimation_plain(**args, **inputs)
    worst, gaps, same, total = 0.0, [], 0, 0
    for name, g, w in zip(OUTPUTS, got, want):
        same += int((g == w).sum())
        total += g.numel()
        atol, rtol = TOLERANCES[name]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"kernel output {name} is not finite ({label}, flags {flags})")
        err = (g - w).abs()
        over = err - (atol + rtol * w.abs())
        gap = float(err.max())
        worst = max(worst, gap)
        gaps.append(f"{name} {gap:.3g}")
        if float(over.max()) > 0:
            raise AssertionError(f"kernel output {name} differs from the plain version by "
                                 f"{gap:.3g} (atol {atol}, rtol {rtol}; {label}, flags {flags})")
    feet = list(env.model.feet_bodies)
    fz = want[2].reshape(env.model.nb, 3, -1)[feet, 2]
    in_contact = float((fz > 5.0).any(dim=0).float().mean())
    log(f"compare {label}, coulomb/noise={'on' if flags else 'off'} ({in_contact:.0%} of envs "
        f"with a foot in contact; {same / total:.4%} of output values bit-equal): "
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


def phase_compare(env, state, obs, policy):
    """The kernel against its plain version in every case of
    :func:`compare_cases`, flags off and on; returns the largest gap."""
    inputs = decimation_inputs(env, state, obs, policy)
    worst = 0.0
    for label, case in compare_cases(env, inputs):
        for flags in (False, True):
            worst = max(worst, compare(env, case, flags, label))
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
    import torch

    from ti5_isaacgym_tpu_torch.physics.megakernel import run_decimation_plain

    inputs = decimation_inputs(env, state, obs, policy)
    args = env.decimation_args()
    ms, host_us, ahead = time_kernel(args, inputs, reps)
    wide = {k: torch.cat([v, v], dim=1).contiguous() for k, v in inputs.items()}
    ms_wide, host_us_wide, ahead_wide = time_kernel(args, wide, reps)
    del wide
    if not (ahead and ahead_wide):
        raise AssertionError("the host fell behind the device while enqueueing the timed "
                             "launches: the times would be the host's")
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    run_decimation_plain(**args, **inputs)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    bound_ms, bound_by, nbytes, ops = kernel_bound(env, inputs)
    n = env.num_envs
    log(f"times: kernel {ms:.4f} ms at {n} envs, {ms_wide:.4f} ms at {2 * n} envs (mean of "
        f"{reps}; host enqueue {host_us:.1f} / {host_us_wide:.1f} us per launch, host ahead), "
        f"plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B, {ops} "
        f"float32 ops; {2 * bound_ms:.5f} ms at {2 * n} envs), library: none")
    return dict(ms=ms, ms_wide=ms_wide, host_us=host_us, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def main():
    smi, name = phase_device()
    import torch

    build = phase_build()
    env, policy, state, obs = make_env(NUM_ENVS, "cuda")
    worst = phase_compare(env, state, obs, policy)
    state, obs, launches, stats = phase_rollout(env, policy, state, obs)
    if launches != STEPS:
        raise AssertionError(f"main path launched the decimation kernel {launches} times, "
                             f"expected {STEPS}")
    times = phase_times(env, state, obs, policy)
    torch.cuda.synchronize()
    log(f"done: build {build['seconds']:.1f} s, {stats['env_steps_per_s']:.1f} env-steps/s "
        f"on {smi}")
    for line in result_lines(smi, name, torch.cuda.device_count(), launches, worst, times):
        print(line, flush=True)


def result_lines(smi, name, count, launches, worst, times):
    """The last three lines: the kernels' JSON, the nvidia-smi line, the
    contract's result line.  ``ms`` is at NUM_ENVS envs, ``ms_8192_envs`` at
    twice that."""
    kernels = {"kernels": [{
        "name": "run_decimation", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst, "ms": times["ms"],
        f"ms_{2 * NUM_ENVS}_envs": times["ms_wide"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"], "library_ms": None}]}
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
