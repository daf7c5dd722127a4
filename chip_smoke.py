#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths at the task's full width (the 20x20
rough-terrain grid, full domain randomization, action/dof/IMU lag, the
decimation kernel on): the ``t1_dh_stand`` policy rollout at 4096 envs and
the DH-PPO training iteration at 8192 envs.  Phases, each printing one line
with its elapsed seconds:

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
   share and the peak memory.

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


def make_runner(num_envs: int, device, terrain_rows=None, steps=None,
                kernel_path_on_cpu: bool = False):
    """The training runner on the full task at ``num_envs`` with
    ``T1TrainCfg``'s defaults; ``terrain_rows``, ``steps`` (per env and
    iteration) and ``kernel_path_on_cpu`` (the kernel path's plain version
    on the CPU) cut a CPU rehearsal down."""
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
    return OnPolicyRunner(env, cfg, tcfg, verbose=False)


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
    worst = compare_after_iteration(runner, c1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    stats = {k: float(metrics[k]) for k in
             ("value_loss", "surrogate_loss", "estimator_loss", "kl", "lr")}
    out = dict(init_s=init_s, warm_s=warm_s, iter_ms=iter_ms,
               env_steps_per_s=n * steps / (iter_ms / 1e3), rollout_ms=rollout_ms,
               gae_ms=gae_ms, update_ms=update_ms, launches=counts, worst=worst, stats=stats,
               reset_share=sum(done) / (n * steps * len(done)), peak_bytes=peak,
               checkpoint_fields=fields, checkpoint_bytes=os.path.getsize(path))
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


def compare_after_iteration(runner, carry) -> float:
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
    return max(compare(env, inputs, flags, label) for flags in (False, True))


def main():
    smi, name = phase_device()
    import torch

    build = phase_build()
    launches, worst, times, stats = rollout_phases()
    runner = make_runner(TRAIN_ENVS, "cuda")
    train = phase_train(runner)
    del runner
    torch.cuda.synchronize()
    log(f"done: build {build['seconds']:.1f} s, rollout {stats['env_steps_per_s']:.1f} "
        f"env-steps/s, training {train['env_steps_per_s']:.1f} env-steps/s on {smi}")
    for line in result_lines(smi, name, torch.cuda.device_count(), launches,
                             max(worst, train["worst"]), times, train["launches"]):
        print(line, flush=True)


def rollout_phases():
    """Phases 3-5 at NUM_ENVS; their env is freed on return."""
    env, policy, state, obs = make_env(NUM_ENVS, "cuda")
    worst = phase_compare(env, state, obs, policy)
    state, obs, launches, stats = phase_rollout(env, policy, state, obs)
    if launches != STEPS:
        raise AssertionError(f"main path launched the decimation kernel {launches} times, "
                             f"expected {STEPS}")
    times = phase_times(env, state, obs, policy)
    return launches, worst, times, stats


def result_lines(smi, name, count, launches, worst, times, train_launches):
    """The last three lines: the kernels' JSON, the nvidia-smi line, the
    contract's result line.  ``ms`` is at NUM_ENVS envs, ``ms_8192_envs`` at
    twice that; ``launches`` counts the rollout of phase 4,
    ``launches_per_training_iteration`` lists the count of each iteration of
    phase 6; ``max_abs_err`` is the largest gap of phases 3 and 6."""
    kernels = {"kernels": [{
        "name": "run_decimation", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "launches_per_training_iteration": train_launches, "max_abs_err": worst,
        "ms": times["ms"], f"ms_{2 * NUM_ENVS}_envs": times["ms_wide"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": None}]}
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
