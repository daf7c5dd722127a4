#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths at the task's full width (the 20x20 rough-terrain
grid, full domain randomization, action/dof/IMU lag, the decimation kernel
on): the ``t1_dh_stand`` policy rollout at 4096 envs, the DH-PPO training
iteration at 8192 envs, every registered task through the task
registry with a CLI resume and the deployment export, and data-parallel
training over two ranks.  Phases, each
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

It then prints the kernels' JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
line.  Imports only the port, torch, numpy and the standard library; needs
no network; writes only under ``build/`` (and phase 8's rendezvous file in a
temporary directory).  The kernels' JSON line lists the one kernel, with a
``configurations`` entry per task it ran on and one for phase 8.
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
    if shares is not None:
        shares.append(same / total)
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


def main():
    smi, name = phase_device()
    import torch

    build = phase_build()
    launches, worst, times, stats, shares = rollout_phases()
    runner = make_runner(TRAIN_ENVS, "cuda")
    train = phase_train(runner)
    del runner
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tasks = phase_tasks("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    par = phase_parallel("cuda")
    log(f"done: build {build['seconds']:.1f} s, rollout {stats['env_steps_per_s']:.1f} "
        f"env-steps/s, training {train['env_steps_per_s']:.1f} env-steps/s (T1), "
        f"{tasks['k1_dh_stand']['env_steps_per_s']:.1f} (K1), "
        f"{tasks['t1_flat']['env_steps_per_s']:.1f} (t1_flat), "
        f"{par['env_steps_per_s']:.1f} (T1 over 2 ranks) on {smi}")
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
    phase 6; ``max_abs_err`` is the largest gap of phases 3, 6 and 7;
    ``configurations`` has, per task the kernel ran (phases 3-6 for
    ``t1_dh_stand``, phase 7 for ``k1_dh_stand`` and ``t1_flat``), its
    widths, the bit-equal share of its comparisons, their largest gap, its
    launches per training iteration and, for K1, the kernel's times; and
    phase 8's entry (:func:`parallel_configuration`)."""
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
