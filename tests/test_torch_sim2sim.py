"""Port parity: scripts/sim2sim.py against the JAX package's sim2sim.

* ``build_model`` with the same ``numpy`` generator gives the same
  randomized MuJoCo model (masses, friction, armature) as JAX's.
* ``run_episode`` of both packages on one MuJoCo model, with the same
  weights (flax's init from ``PRNGKey(0)``, or the exported round-5 walking
  policy) carried into the port through ``flatten_tree`` and
  ``params_from_flat``; JAX's policy is its jitted ``act_inference``, the
  port's ``make_policy`` on the CPU.  A recording wrapper around each policy
  keeps every observation and action mean of 100 policy steps (1000 MuJoCo
  steps).  The first observation is bit-equal; after it the two float32
  forwards round differently and MuJoCo carries the difference on: measured
  at most 3.4e-6 over the 100 steps (obs and actions, both policies, stand
  and walk), so the limit is atol 1e-5 on every step.  Episode stats:
  ``survived_s`` and ``fell`` equal, ``final_z`` and the three tracking
  errors within 1e-6 (measured at most 8e-8).
* The CLI: the single-episode line, a checkpoint and the same weights'
  npz giving the same line, the sweep's table and exit code with a
  two-row ``SWEEP`` (one required) cut to 50 steps, sweep seeds independent of
  ``PYTHONHASHSEED``, K1 refused.
"""
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from ti5_isaacgym_tpu.algo.runner import build_network as jbuild_network  # noqa: E402
from ti5_isaacgym_tpu.scripts import sim2sim as jsim  # noqa: E402
from ti5_isaacgym_tpu.utils.registry import task_registry as jregistry  # noqa: E402
from ti5_isaacgym_tpu_torch.algo.convert import (flatten_tree, nest_flat,  # noqa: E402
                                                 params_from_flat)
from ti5_isaacgym_tpu_torch.algo.runner import build_network  # noqa: E402
from ti5_isaacgym_tpu_torch.scripts import sim2sim  # noqa: E402
from ti5_isaacgym_tpu_torch.utils.registry import task_registry  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ROUND5 = os.path.join(ROOT, "eval_round5", "final", "exported", "policy_dh.npz")
STEPS = 100


@pytest.fixture(scope="module")
def jax_side():
    """(JAX env cfg, jitted act_inference, {policy name: flax params})."""
    cfg, train_cfg = jregistry.get_cfgs("t1_dh_stand")
    net = jbuild_network(train_cfg, cfg)
    init = net.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.env.num_observations)),
                    jnp.zeros((1, cfg.env.num_privileged_obs)))
    with np.load(ROUND5) as f:
        round5 = {"params": nest_flat({k: f[k] for k in f.files})}
    act = jax.jit(lambda p, o: net.apply(p, o, method="act_inference"))
    return cfg, act, {"flax_init": init, "round5": round5}


def _cfgs():
    return task_registry.get_cfgs("t1_dh_stand")


def _port_network(jparams):
    cfg, train_cfg = _cfgs()
    net = build_network(train_cfg, cfg)
    net.load_state_dict(params_from_flat(flatten_tree(jax.tree.map(np.asarray, jparams))))
    return net


def _recording(policy, log):
    def wrapped(obs):
        out = policy(obs)
        log.append((np.array(obs, np.float32), np.array(out[0], np.float32)))
        return out
    return wrapped


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_build_model_matches_jax(seed):
    jcfg = jregistry.get_cfgs("t1_dh_stand")[0]
    rng = (lambda: None) if seed is None else (lambda: np.random.default_rng(seed))
    jm, tm = jsim.build_model(jcfg, rng=rng()), sim2sim.build_model(_cfgs()[0], rng=rng())
    for field in ("body_mass", "geom_friction", "dof_armature", "jnt_range", "body_pos",
                  "body_inertia", "actuator_ctrlrange"):
        np.testing.assert_array_equal(getattr(tm, field), getattr(jm, field), err_msg=field)
    if seed is not None:
        assert not np.array_equal(tm.body_mass, sim2sim.build_model(_cfgs()[0]).body_mass)


@pytest.mark.parametrize("policy", ["flax_init", "round5"])
@pytest.mark.parametrize("cmd", [(0.4, 0.0, 0.0), (0.0, 0.0, 0.0)], ids=["walk", "stand"])
def test_episode_matches_jax(jax_side, policy, cmd):
    jcfg, act, params = jax_side
    model = sim2sim.build_model(_cfgs()[0])
    jlog, tlog = [], []
    jpolicy = _recording(lambda obs: act(params[policy], obs), jlog)
    tpolicy = _recording(sim2sim.make_policy(_port_network(params[policy]), "cpu"), tlog)
    want = jsim.run_episode(jcfg, jpolicy, cmd, STEPS, model, jnp, mujoco, jax)
    got = sim2sim.run_episode(_cfgs()[0], tpolicy, cmd, STEPS, model)
    assert len(tlog) == len(jlog) == STEPS
    np.testing.assert_array_equal(tlog[0][0], jlog[0][0])
    for i, ((tobs, tact), (jobs, jact)) in enumerate(zip(tlog, jlog)):
        assert tobs.shape == (1, 66 * 47) and tact.shape == (1, 12)
        np.testing.assert_allclose(tobs, jobs, atol=1e-5, rtol=0, err_msg=f"obs, step {i}")
        np.testing.assert_allclose(tact, jact, atol=1e-5, rtol=0, err_msg=f"actions, step {i}")
    assert (got["survived_s"], got["horizon_s"], got["fell"]) == \
        (want["survived_s"], want["horizon_s"], want["fell"])
    for k in ("final_z", "vx_err", "vy_err", "wz_err"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)


def test_policy_returns_mean_and_estimate():
    net = build_network(_cfgs()[1], _cfgs()[0])
    policy = sim2sim.make_policy(net, "cpu")
    obs = np.random.default_rng(0).normal(size=(1, 66 * 47)).astype(np.float32)
    act, est = policy(obs)
    want_act, want_est = net.act_inference(torch.from_numpy(obs))
    assert isinstance(act, np.ndarray) and act.shape == (1, 12) and est.shape == (1, 3)
    np.testing.assert_array_equal(act, want_act.detach().numpy())
    np.testing.assert_array_equal(est, want_est.detach().numpy())


def _sim2sim_line(out):
    m = re.search(r"sim2sim: survived ([0-9.]+)s / ([0-9.]+)s, mean \|vx err\| = ([0-9.]+) m/s, "
                  r"final z = ([0-9.]+)", out)
    assert m, out
    return m.group(0), [float(g) for g in m.groups()]


def test_cli_single_episode(capsys):
    assert sim2sim.main(["--random_policy", "--device", "cpu", "--steps", "50"]) == 0
    _, (survived, horizon, vx_err, z) = _sim2sim_line(capsys.readouterr().out)
    assert horizon == 0.5 and 0 < survived <= horizon and np.isfinite(vx_err) and z > 0


def test_cli_checkpoint_equals_npz(tmp_path, capsys):
    """A runner checkpoint found through ``--log_root``/``--load_run``
    drives the same episode as the npz of the same weights."""
    with np.load(ROUND5) as f:
        params = params_from_flat({k: f[k] for k in f.files})
    run = tmp_path / "Oct17_00-00-00_ti5"
    run.mkdir()
    torch.save({"ts": {"params": params}, "iteration": 3}, run / "model_3.pt")
    args = ["--device", "cpu", "--steps", "30", "--command", "0.4", "0", "0"]
    assert sim2sim.main(args + ["--log_root", str(tmp_path), "--load_run", run.name]) == 0
    out = capsys.readouterr().out
    assert f"loading {run / 'model_3.pt'}" in out and "checkpoint iteration 3" in out
    assert sim2sim.main(args + ["--policy", ROUND5]) == 0
    assert _sim2sim_line(out)[0] == _sim2sim_line(capsys.readouterr().out)[0]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        sim2sim.main(args + ["--log_root", str(tmp_path / "empty")])
    with pytest.raises(SystemExit):
        sim2sim.main(args + ["--policy", ROUND5, "--random_policy"])


@pytest.mark.parametrize("thresholds,rc", [((1e9, 1e9, 1e9), 0), ((0.0, 0.0, 0.0), 1)],
                         ids=["required_passes", "required_fails"])
def test_cli_sweep(monkeypatch, capsys, thresholds, rc):
    """The sweep cut to one required row of 50 steps (and a second row that
    fails, not required): its rows, summary and table, and the exit code of
    the required row."""
    monkeypatch.setattr(sim2sim, "SWEEP", [("stand", (0.0, 0.0, 0.0), True, thresholds),
                                           ("turn_0.5", (0.0, 0.0, 0.5), False, (0, 0, 0))])
    monkeypatch.setattr(sim2sim, "MIN_SWEEP_STEPS", 50)
    assert sim2sim.main(["--random_policy", "--device", "cpu", "--steps", "10", "--sweep",
                         "--episodes", "1"]) == rc
    out = capsys.readouterr().out
    assert re.search(r"^sweep stand .* -> (PASS|FAIL) \(required\)$", out, re.M)
    assert ("required gates PASS" in out) == (rc == 0)
    assert "sim2sim: sweep %d/2 commands pass (0s horizon, 1 randomized models each)" % (
        1 - rc) in out
    line = next(ln for ln in out.splitlines() if ln.startswith("sim2sim_table: "))
    table = json.loads(line.split(": ", 1)[1])
    assert [r["name"] for r in table] == ["stand", "turn_0.5"]
    assert [r["passed"] for r in table] == [rc == 0, False]
    assert [r["required"] for r in table] == [True, False]
    assert all(r["survival"] == 1.0 for r in table)


def test_sweep_seeds_do_not_depend_on_the_hash_seed():
    code = ("from ti5_isaacgym_tpu_torch.scripts.sim2sim import SWEEP, sweep_seed; "
            "print([sweep_seed(3, row[0], ep) for row in SWEEP for ep in range(2)])")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stdin=subprocess.DEVNULL,
                              env=dict(os.environ, PYTHONHASHSEED=str(h)))
             for h in (1, 2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1]
    seeds = [sim2sim.sweep_seed(3, row[0], ep) for row in sim2sim.SWEEP for ep in range(2)]
    assert outs[0].strip() == str(seeds) and len(set(seeds)) == len(seeds)


def test_k1_is_refused():
    k1 = task_registry.get_cfgs("k1_dh_stand")[0]
    model = sim2sim.build_model(k1)                 # K1's own body builds
    assert model.nq == 19

    def never(obs):
        raise AssertionError("the policy ran")

    for call in (lambda: sim2sim.run_episode(k1, never, (0.0, 0.0, 0.0), 1, model),
                 lambda: sim2sim.main(["--task", "k1_dh_stand", "--random_policy",
                                       "--device", "cpu"])):
        with pytest.raises(ValueError, match="T1 only.*'k1'.*T1_EFFORT"):
            call()
    sim2sim.check_t1(task_registry.get_cfgs("t1_flat")[0])     # T1's robot: runs


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal only happens without one")
    with pytest.raises(RuntimeError, match="cuda"):
        sim2sim.main(["--random_policy", "--steps", "1"])
