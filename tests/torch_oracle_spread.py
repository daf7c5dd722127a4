"""The spread of the oracle's gait statistics over groups of 4 envs, for the
port's engine or the JAX package's, on the CPU.

    python tests/torch_oracle_spread.py port 64 800 /tmp/port64.json
    JAX_PLATFORMS=cpu python tests/torch_oracle_spread.py jax 1024 800 /tmp/jax1024.json

drives ``<n>`` envs with the oracle's overrides (a plane, the domain
randomization, lags, events and noise off; seed 11) for ``<steps>`` policy
steps of the round-5 walking policy at 0.4 m/s, the gait clock frozen, as
``tools/contact_stats_oracle.py::run_engine`` and
``scripts/contact_stats.run_engine`` do, and writes ``gait_stats`` of all
envs, of each group of 4 envs (the JAX tool's width) with their mean,
standard deviation, min and max, the mean vx of the second half, and how
many envs fell and restarted.  The port runs on the CPU here (about 0.8 s a
step); JAX compiles its step once (about a minute) and then runs 800 steps
of 1024 envs in a few minutes.  ``chip_smoke.ORACLE_TOL`` is 4 standard
deviations of the port's 64-env groups; the JAX run at width is what the
card's 4096-env run of phase 10 compares with.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

NPZ = os.path.join(ROOT, "eval_round5", "final", "exported", "policy_dh.npz")
JAX_CKPT = os.path.join(ROOT, "checkpoints", "t1_dh_stand", "Aug21_19-21-52_probe_s21",
                        "model_71000")
CMD = [0.4, 0.0, 0.0]
WEIGHT_N = 55.746 * 9.81      # the JAX tool's engine weight


def port_rollout(n: int, steps: int):
    """(grf [T, n, 2], vx [T, n], resets [n], dt) of the port's engine."""
    from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv
    from ti5_isaacgym_tpu_torch.scripts import contact_stats as cs
    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    env_cfg = task_registry.get_cfgs("t1_dh_stand")[0]
    env = T1DHStandEnv(cs.engine_cfg(env_cfg, n), seed=11, device="cpu")
    net = cs.load_policy_network(env_cfg, npz=NPZ).eval()
    state, obs, _ = env.reset(env.init_state(11))
    grf, vx, resets = cs.engine_rollout(env, net, state, obs, CMD, steps)
    return grf, vx, resets, env.dt


def jax_rollout(n: int, steps: int):
    """The same with the JAX package's engine (``run_engine``'s loop; the
    reset op by op, the step compiled once)."""
    import jax
    import jax.numpy as jnp

    from ti5_isaacgym_tpu.algo.runner import build_network
    from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
    from ti5_isaacgym_tpu.envs.t1_dh_stand import T1DHStandEnv
    from ti5_isaacgym_tpu.export.policy import restore_policy_params
    from ti5_isaacgym_tpu_torch.scripts import contact_stats as cs

    base = T1EnvCfg()
    over = cs.engine_cfg(base, n)      # the same dataclass fields in both packages
    with jax.disable_jit():
        env = T1DHStandEnv(over, seed=11)
        state, obs, _ = env.reset(env.init_state(jax.random.PRNGKey(11)))
    params, _ = restore_policy_params(JAX_CKPT)
    net = build_network(T1TrainCfg(), over)
    policy = jax.jit(lambda o: net.apply(params, o, method="act_mean"))
    step = jax.jit(env.step)
    feet = list(env.model.feet_bodies)
    fixed = jnp.asarray(CMD, jnp.float32)
    grf, vx, resets = [], [], np.zeros(n, np.int64)
    for _ in range(steps):
        state = state.replace(commands=state.commands.at[:, :3].set(fixed),
                              gait_time=jnp.full_like(state.gait_time, 1 << 30))
        state, obs, _p, _r, done, _ex = step(state, policy(obs))
        grf.append(np.asarray(state.contact_forces[:, feet, 2]))
        vx.append(np.asarray(state.phys.base_vel[:, 3]))
        resets += np.asarray(done)
    return np.stack(grf), np.stack(vx), resets, env.dt


def spread(grf, vx, resets, dt, group: int = 4) -> dict:
    from ti5_isaacgym_tpu_torch.scripts.contact_stats import gait_stats

    half = vx[len(vx) // 2:]
    per = [dict(gait_stats(grf[:, i:i + group], dt, WEIGHT_N),
                mean_vx=float(half[:, i:i + group].mean()))
           for i in range(0, grf.shape[1], group)]
    return {"envs": grf.shape[1], "steps": grf.shape[0],
            "all": dict(gait_stats(grf, dt, WEIGHT_N), mean_vx=float(half.mean())),
            "groups": {k: {"mean": float(np.mean([p[k] for p in per])),
                           "std": float(np.std([p[k] for p in per], ddof=1)),
                           "min": float(np.min([p[k] for p in per])),
                           "max": float(np.max([p[k] for p in per]))} for k in per[0]},
            "envs_reset": int((resets > 0).sum()), "resets": int(resets.sum())}


def main(argv):
    engine, n, steps, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    rollout = {"port": port_rollout, "jax": jax_rollout}[engine]
    result = dict(engine=engine, **spread(*rollout(n, steps)))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main(sys.argv[1:])
