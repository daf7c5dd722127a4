"""The port's data parallelism on the CPU: ranks over gloo (ports of
tests/test_parallel.py and the collectives of the training iteration).

Ranks run in processes that ``parallel.trainer.spawn_local`` starts
(``spawn``; rendezvous in a file store under a fresh temporary directory,
so xdist workers never share one), one thread each, each joined within a
timeout.  The rank functions live at module level here and import no JAX;
the JAX references are computed in the test process only.  One spawn of 2
ranks (the ``two_ranks`` fixture) makes, on the same inputs:

* the full-batch DH-PPO update (1 epoch x 1 minibatch) on
  ``tests/multihost_worker.py::build_inputs()``'s trajectory, split in
  halves: held against JAX's ``reference_update()`` (the limits of
  tests/test_parallel.py:213-229) and against the port's own
  single-process update (the limits of :77-89), the ranks bit-equal;
* the GAE moments, against JAX's ``compute_gae`` on the whole trajectory
  (:246-248);
* the command curriculum on half the envs each, against JAX's on all, in
  a case that widens the range and one that does not;
* the sharded initial carry and the per-rank random streams;
* 2 training iterations: params, Adam and lr bit-equal across ranks, only
  rank 0 writes its CSV and checkpoint.

Also: a world-size-1 iteration equals the plain runner's bit for bit, with
its collectives counted; the CLI with spawned ranks and with two processes
at a coordinator; the CLI's flag checks.
"""
import dataclasses
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu_torch.algo import networks as tnets
from ti5_isaacgym_tpu_torch.algo import ppo as tppo
from ti5_isaacgym_tpu_torch.algo import rollout as troll
from ti5_isaacgym_tpu_torch.algo.runner import OnPolicyRunner, carry_to_dict
from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
from ti5_isaacgym_tpu_torch.envs import legged as tlegged
from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv
from ti5_isaacgym_tpu_torch.export.policy import restore_policy_params
from ti5_isaacgym_tpu_torch.parallel import trainer as par

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT_S = 300.0
GAMMA, LAM = 0.994, 0.9
# the collectives of an iteration of 4 steps per env with T1TrainCfg's 2
# epochs x 4 minibatches: one curriculum sum per step, the GAE moments, one
# gradient+KL buffer per minibatch, the metrics
COUNTS_4_STEPS = {"curriculum": 4, "gae": 1, "update": 8, "metrics": 1}
# replicated env fields (everything else of the env state is per env)
REPLICATED = ("common_step", "cmd_vx_range", "is_first_push", "is_first_add_force",
              "terrain_height")


def small_runner(num_envs=16, log_dir=None):
    """T1 at ``num_envs`` envs, 2x2 terrain, 4 steps per env (as
    tests/test_torch_runner.py cuts it)."""
    cfg = T1EnvCfg()
    cfg = dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, num_envs=num_envs),
        terrain=dataclasses.replace(cfg.terrain, num_rows=2, num_cols=2, border_size=2.0))
    tcfg = T1TrainCfg()
    tcfg = dataclasses.replace(tcfg, runner=dataclasses.replace(tcfg.runner, num_steps_per_env=4))
    return OnPolicyRunner(T1DHStandEnv(cfg, seed=tcfg.seed, device="cpu"), cfg, tcfg,
                          log_dir=log_dir)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _raw(t):
    """A tensor as (dtype, shape, its bytes): picklable, compared bit for bit."""
    return str(t.dtype), tuple(t.shape), t.detach().reshape(-1).contiguous().view(
        torch.uint8).numpy().copy()


def _same(a, b):
    return a[0] == b[0] and a[1] == b[1] and np.array_equal(a[2], b[2])


def _np(tensors):
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _traj(d):
    """A port Transition from numpy arrays (bf16 observations)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    return troll.Transition(
        obs=t["obs"].to(torch.bfloat16), critic_obs=t["priv"].to(torch.bfloat16),
        actions=t["actions"], rewards=t["rewards"], dones=t["dones"], values=t["values"],
        log_probs=t["log_probs"], mu=t["mu"], sigma=t["sigma"])


def _half(traj, rank, world):
    n = traj.values.shape[1] // world
    return troll.Transition(*(x[:, rank * n:(rank + 1) * n] for x in traj))


def fullbatch_update(params, traj, last_values, group=None):
    """(train state, stats, gradients, returns, normalised advantages) of one
    full-batch update of ``traj`` from fresh Adam state; the minibatch is the
    samples in order, and with a ``group`` the stats are averaged over it."""
    cfg = tppo.PPOConfig(num_learning_epochs=1, num_mini_batches=1, learning_rate=1e-3)
    alg = tppo.PPO(cfg, tnets.ActorCriticDH(), group=group)
    ts0 = tppo.init_train_state(cfg, {k: v.clone() for k, v in params.items()})
    ret, adv = troll.compute_gae(traj, last_values, cfg.gamma, cfg.lam, group=group)
    flat = troll.flatten_batch(traj)
    _, _, grads = alg.loss_and_grads(ts0.params, flat, ret.reshape(-1), adv.reshape(-1))
    if group is not None:
        g = list(grads.values())
        tppo.mean_grads_(group, g, torch.zeros(()))
        grads = dict(zip(grads, g))
    ts, m = alg.update(ts0, traj, ret, adv, indices=torch.arange(flat.values.shape[0])[None])
    stats = torch.stack([m[k] for k in ("value_loss", "surrogate_loss", "estimator_loss",
                                        "kl", "lr")])
    if group is not None:
        stats = group.mean_(stats, "stats")
    return ts, stats, grads, ret, adv


def _curriculum_cases():
    """(done, episode tracking sums) of a case that widens the command range
    and one that does not (the 80% threshold is 12 with the arguments of
    :func:`_curriculum`)."""
    rng = np.random.default_rng(4)
    done = rng.uniform(size=16) < 0.5
    done[[0, 8]] = True                       # both halves hold done envs
    return [(done, rng.uniform(14.0, 20.0, size=16).astype(np.float32)),
            (done, rng.uniform(2.0, 8.0, size=16).astype(np.float32))]


def _curriculum(mod, asarray, cfg, done, sums, group=None):
    """``mod.command_curriculum_update`` at step 2000 (a multiple of the
    episode length 1000) on ``asarray``'s arrays."""
    kw = {} if group is None else {"group": group}
    return mod.command_curriculum_update(
        cfg, asarray(done), asarray(np.int32(2000)), asarray(sums),
        asarray(np.float32([-0.5, 1.0])), 1000.0, 0.015, **kw)


def jax_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _stream_draws(carry):
    """The first values the carry's env and run generators give, drawn from
    copies (the carry's own generators do not move)."""
    return [torch.rand(8, generator=par._generator(g)).numpy()
            for g in (carry.env_state.rng, carry.rng)]


def ranks_worker(rank, device, inputs, log_root):
    """Everything ``two_ranks`` checks, on one of 2 ranks."""
    torch.set_num_threads(1)
    group = par.ReduceGroup()
    world = group.size
    out = {}
    traj = _traj(inputs["traj"])
    lv = torch.from_numpy(inputs["last_values"])
    n = lv.shape[0] // world
    params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    ts, stats, grads, ret, adv = fullbatch_update(
        params, _half(traj, rank, world), lv[rank * n:(rank + 1) * n], group)
    out["update"] = dict(params=_np(ts.params), lr=float(ts.lr), stats=stats.numpy(),
                         grads=_np(grads), ret=ret.numpy(), adv=adv.numpy())

    cfg = T1EnvCfg()
    out["curriculum"] = [
        _curriculum(tlegged, torch.as_tensor, cfg, d[rank * 8:(rank + 1) * 8],
                    s[rank * 8:(rank + 1) * 8], group).numpy()
        for d, s in _curriculum_cases()]

    runner = small_runner(log_dir=os.path.join(log_root, f"rank{rank}"))
    sharded = par.ShardedRunner(runner)
    carry = sharded.init_carry()
    out["carry"] = {k: _raw(v) for k, v in _flat(carry_to_dict(carry)).items()}
    out["draws"] = _stream_draws(carry)
    carry = sharded.learn(2, carry=carry, log_every=100)
    out["counts"] = dict(sharded.reduce.counts)
    out["replicated"] = sharded.check_replicated(carry)
    out["trained"] = {k: _raw(v) for k, v in _flat(carry_to_dict(carry)["ts"]).items()}
    out["log_dir"] = runner.log_dir
    # --resume: the lead's learning state on every rank, a fresh env state
    par.coordination_barrier("saved")
    resumed = sharded.load(os.path.join(log_root, "rank0", "model_2.pt"))
    out["resumed"] = {k: _raw(v) for k, v in _flat(carry_to_dict(resumed)["ts"]).items()}
    out["resumed_iteration"] = runner.iteration_count
    out["resumed_env"] = {k: _raw(v) for k, v in
                          _flat(carry_to_dict(resumed)["env_state"]).items()}
    return out


@pytest.fixture(scope="module")
def inputs():
    """build_inputs()'s trajectory and params (JAX, in this process) as numpy."""
    import jax

    import multihost_worker as mw
    from ti5_isaacgym_tpu_torch.algo.convert import flatten_tree, params_from_flat

    jparams, jtraj, jlv = mw.build_inputs()
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), jtraj._asdict())
    host["priv"] = host.pop("critic_obs")
    host["dones"] = np.asarray(jtraj.dones)
    params = params_from_flat(flatten_tree(jax.tree.map(np.asarray, jparams)))
    return {"traj": host, "last_values": np.array(jlv, np.float32),
            "params": {k: v.numpy() for k, v in params.items()}}


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ranks"))
    outs = par.spawn_local(ranks_worker, ["cpu", "cpu"], "gloo", (inputs, root),
                           deadline_s=TIMEOUT_S)
    return outs, root


def test_fullbatch_update_matches_jax(inputs, two_ranks):
    """The 2-rank full-batch update against JAX's single-process one
    (tests/test_parallel.py:213-229: grads atol 2e-3 rtol 2e-2, params atol
    2e-3 rtol 1e-3, stats rtol 1e-3, lr rtol 1e-6); both ranks bit-equal."""
    import multihost_worker as mw
    from ti5_isaacgym_tpu_torch.algo.convert import flatten_tree, params_from_flat

    (r0, r1), _ = two_ranks
    a, b = r0["update"], r1["update"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
        np.testing.assert_array_equal(a["grads"][k], b["grads"][k], err_msg=k)
    np.testing.assert_array_equal(a["stats"], b["stats"])
    assert a["lr"] == b["lr"]
    ts1, m1, g1 = mw.reference_update()
    jparams = params_from_flat(flatten_tree(jax_np(ts1.params)))
    jgrads = params_from_flat(flatten_tree(jax_np(g1)))
    assert set(jparams) == set(a["params"])
    for k, v in jgrads.items():
        np.testing.assert_allclose(a["grads"][k], v.numpy(), atol=2e-3, rtol=2e-2, err_msg=k)
    for k, v in jparams.items():
        np.testing.assert_allclose(a["params"][k], v.numpy(), atol=2e-3, rtol=1e-3, err_msg=k)
    for i, k in enumerate(("value_loss", "surrogate_loss", "estimator_loss", "kl")):
        np.testing.assert_allclose(a["stats"][i], float(m1[k]), rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(a["lr"], float(ts1.lr), rtol=1e-6)


def test_fullbatch_update_matches_single_process(inputs, two_ranks):
    """The 2-rank full-batch update against the port's own single-process
    update on the whole batch (tests/test_parallel.py:77-89: params atol
    1e-5 rtol 1e-3, stats rtol 2e-4, lr rtol 1e-6); the gradients within
    1e-5 of it, not twice it (a gradient summed instead of averaged)."""
    (r0, _), _ = two_ranks
    got = r0["update"]
    ts, stats, grads, _, _ = fullbatch_update(
        {k: torch.from_numpy(v) for k, v in inputs["params"].items()}, _traj(inputs["traj"]),
        torch.from_numpy(inputs["last_values"]))
    for k, v in ts.params.items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), atol=1e-5, rtol=1e-3, err_msg=k)
    for k, v in grads.items():
        np.testing.assert_allclose(got["grads"][k], v.numpy(), atol=1e-5, rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["stats"][:4], stats.numpy()[:4], rtol=2e-4)
    np.testing.assert_allclose(got["lr"], float(ts.lr), rtol=1e-6)


def test_gae_moments_match_jax(inputs, two_ranks):
    """Each rank's returns and normalised advantages against JAX's
    ``compute_gae`` on the whole trajectory (returns atol 1e-6; advantages
    atol 1e-5, rtol 1e-5: tests/test_parallel.py:246-248)."""
    import jax.numpy as jnp

    from ti5_isaacgym_tpu.algo import rollout as jroll

    (r0, r1), _ = two_ranks
    t = inputs["traj"]
    jt = jroll.Transition(obs=None, critic_obs=None, actions=None,
                          rewards=jnp.asarray(t["rewards"]), dones=jnp.asarray(t["dones"]),
                          values=jnp.asarray(t["values"]), log_probs=None, mu=None, sigma=None)
    ret, adv = jroll.compute_gae(jt, jnp.asarray(inputs["last_values"]), GAMMA, LAM)
    ret, adv = np.asarray(ret), np.asarray(adv)
    n = ret.shape[1] // 2
    for rank, r in enumerate((r0, r1)):
        cols = slice(rank * n, (rank + 1) * n)
        np.testing.assert_allclose(r["update"]["ret"], ret[:, cols], atol=1e-6)
        np.testing.assert_allclose(r["update"]["adv"], adv[:, cols], atol=1e-5, rtol=1e-5)


def test_command_curriculum_matches_jax(two_ranks):
    """Half the envs on each rank against JAX's function on all 16: the
    widened range in the first case, the range kept in the second, equal on
    both ranks."""
    import jax.numpy as jnp

    from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg as JEnvCfg
    from ti5_isaacgym_tpu.envs import legged as jlegged

    (r0, r1), _ = two_ranks
    for i, (done, sums) in enumerate(_curriculum_cases()):
        want = np.asarray(_curriculum(jlegged, jnp.asarray, JEnvCfg(), done, sums))
        np.testing.assert_array_equal(r0["curriculum"][i], want)
        np.testing.assert_array_equal(r1["curriculum"][i], want)
    assert r0["curriculum"][0][1] > 1.0 and r0["curriculum"][1][1] == 1.0


def test_sharded_initial_carry_is_the_single_process_carry(two_ranks):
    """The ranks' slices concatenated equal the single-process initial
    carry bit for bit; the train state and the replicated env fields are
    equal on both ranks."""
    (r0, r1), _ = two_ranks
    want = {k: _raw(v) for k, v in _flat(carry_to_dict(small_runner().init_carry())).items()}
    assert set(r0["carry"]) == set(want)
    for k, (dtype, shape, raw) in want.items():
        if k == "rng" or k == "env_state/rng":
            continue
        a, b = r0["carry"][k], r1["carry"][k]
        if k.startswith("ts/") or k.split("/")[-1] in REPLICATED:
            assert _same(a, want[k]) and _same(b, want[k]), k
        else:
            assert a[1][0] * 2 == shape[0] and a[0] == b[0] == dtype, k
            assert np.array_equal(np.concatenate([a[2], b[2]]), raw), k


def test_rank_streams(two_ranks):
    """Rank 0 keeps the single-process env and run generators; rank 1's are
    its own (numpy SeedSequence([seed, 1])), and draw other values."""
    (r0, r1), _ = two_ranks
    carry = small_runner().init_carry()
    assert _same(r0["carry"]["env_state/rng"], _raw(carry.env_state.rng.get_state()))
    assert _same(r0["carry"]["rng"], _raw(carry.rng.get_state()))
    env_seed, run_seed = par.rank_seeds(T1TrainCfg().seed, 1)
    assert _same(r1["carry"]["env_state/rng"],
                 _raw(torch.Generator().manual_seed(env_seed).get_state()))
    assert _same(r1["carry"]["rng"], _raw(torch.Generator().manual_seed(run_seed).get_state()))
    for a, b in zip(r0["draws"], r1["draws"]):
        assert not np.array_equal(a, b)
    np.testing.assert_array_equal(r0["draws"][0], _stream_draws(carry)[0])


def test_two_ranks_train(two_ranks):
    """2 iterations on 2 ranks of 8 envs: the collectives counted per
    iteration, params, Adam and lr bit-equal across ranks (all-reduce check
    and bytes), the params moved, only rank 0 wrote a CSV and a checkpoint,
    which loads through ``params_only`` and the exporter's reader."""
    (r0, r1), _ = two_ranks
    assert r0["counts"] == r1["counts"] == {k: 2 * v for k, v in COUNTS_4_STEPS.items()}
    assert r0["replicated"] == r1["replicated"] == (0, 0.0)
    for k, v in r0["trained"].items():
        assert _same(v, r1["trained"][k]), k
    assert not _same(r0["trained"]["params/std"], r0["carry"]["ts/params/std"])
    files = set(os.listdir(r0["log_dir"]))
    assert {f for f in files if f.endswith(".pt")} == {"model_2.pt"} and "metrics.csv" in files
    with open(os.path.join(r0["log_dir"], "metrics.csv")) as f:
        assert len(f.readlines()) == 3
    assert not os.path.exists(r1["log_dir"])
    sd = torch.load(os.path.join(r0["log_dir"], "model_2.pt"), map_location="cpu",
                    weights_only=True)
    assert set(sd) == {"ts", "iteration"} and sd["iteration"] == 2
    runner = small_runner()
    got = runner.load(os.path.join(r0["log_dir"], "model_2.pt"), params_only=True)
    for k, v in got.ts.params.items():
        assert _same(_raw(v), r0["trained"][f"params/{k}"]), k
    # what scripts/play.py (the load above) and scripts/export_policy.py read
    params, iteration = restore_policy_params(os.path.join(r0["log_dir"], "model_2.pt"))
    assert iteration == 2 and all(_same(_raw(v), r0["trained"][f"params/{k}"])
                                  for k, v in params.items())


def world1_worker(rank, device):
    """One plain iteration and one ShardedRunner iteration (world size 1)
    from the same initial carry: the fields that differ, and the counts."""
    torch.set_num_threads(1)
    runner = small_runner()
    carry0 = runner.init_carry()
    local = par.shard_carry(carry0, 0, 1, runner.seed)      # before carry0's generators move
    c1, m1 = runner._iter_fn(carry0)
    sharded = par.ShardedRunner(runner)
    c2, m2 = sharded.iteration(local)
    a = {k: _raw(v) for k, v in _flat(carry_to_dict(c1)).items()}
    b = {k: _raw(v) for k, v in _flat(carry_to_dict(c2)).items()}
    a.update({f"metrics/{k}": _raw(v.float()) for k, v in m1.items()})
    b.update({f"metrics/{k}": _raw(v) for k, v in m2.items()})
    return {"keys": sorted(a) == sorted(b), "differ": [k for k in a if not _same(a[k], b[k])],
            "counts": dict(sharded.reduce.counts), "fields": len(a)}


def test_world_size_one_equals_the_plain_runner():
    """A ShardedRunner iteration at world size 1 (its collectives run, over
    gloo) equals the plain runner's from the same carry bit for bit: params,
    Adam, lr, env state, generators and metrics (float32, as the
    all-reduced metrics are); the collectives of the iteration counted."""
    (out,) = par.spawn_local(world1_worker, ["cpu"], "gloo", deadline_s=TIMEOUT_S)
    assert out["keys"] and out["differ"] == [] and out["fields"] > 100
    assert out["counts"] == COUNTS_4_STEPS


def slow_worker(rank, device, seconds):
    """Sleeps ``seconds``, then sums the ranks' ones and reports which
    ranks say no (rank 1)."""
    torch.set_num_threads(1)
    time.sleep(seconds)
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return {"sum": float(t), "failing": par.failing_ranks("check", rank != 1)}


def test_spawn_local_outlives_its_timeout():
    """``timeout_s`` bounds the rendezvous and the collectives, not the
    run: ranks that work 3 x timeout_s before their all-reduce return their
    values; ``failing_ranks`` gives every rank the same list."""
    t0 = time.monotonic()
    outs = par.spawn_local(slow_worker, ["cpu", "cpu"], "gloo", (9.0,), timeout_s=3.0,
                           deadline_s=TIMEOUT_S)
    assert time.monotonic() - t0 > 9.0
    assert outs == [{"sum": 2.0, "failing": [1]}] * 2


def test_spawn_local_deadline_stops_the_ranks():
    """A deadline the caller gives stops ranks that have not finished by
    then and raises ``TimeoutError``."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 5.0 s"):
        par.spawn_local(slow_worker, ["cpu", "cpu"], "gloo", (TIMEOUT_S,), deadline_s=5.0)
    assert time.monotonic() - t0 < TIMEOUT_S / 2


def raising_worker(rank, device):
    """Rank 1 raises; rank 0 would sleep for the whole timeout."""
    torch.set_num_threads(1)
    if rank == 1:
        raise ValueError("rank 1 gives up")
    time.sleep(TIMEOUT_S)
    return rank


def test_spawn_local_reraises_a_rank_failure():
    """A rank's exception stops the other rank at once and fails the call
    with its traceback."""
    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="rank 1 gives up"):
        par.spawn_local(raising_worker, ["cpu", "cpu"], "gloo", deadline_s=TIMEOUT_S)
    assert time.monotonic() - t0 < TIMEOUT_S / 2


def _cli(*flags, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dp_cli.py"), "--device", "cpu",
         "--task", "k1_dh_stand", "--num_envs", "16", "--max_iterations", "2",
         "--log_every", "1", *flags],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL)


def _rows(log):
    return re.findall(r"^it\s+\d+ \|.*$", log, re.M)


def _finish(procs):
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{p.args} failed:\n{log[-4000:]}"
    return logs


def _only_checkpoint(root):
    (run,) = os.listdir(root)
    files = set(os.listdir(os.path.join(root, run)))
    assert {"config.json", "metrics.csv", "model_2.pt"} <= files
    assert {f for f in files if f.endswith(".pt")} == {"model_2.pt"}
    sd = torch.load(os.path.join(root, run, "model_2.pt"), map_location="cpu", weights_only=True)
    assert set(sd) == {"ts", "iteration"}


def test_cli_spawns_local_ranks(tmp_path):
    """``scripts.train --device cpu --n_devices 2``: the CLI starts 2 ranks
    of 8 envs; rank 0 alone prints the 2 metric rows and writes the run.
    The ranks' timeout (``train(timeout_s=10)``) bounds their rendezvous
    and collectives, not the run, which lasts longer."""
    t0 = time.monotonic()
    (log,) = _finish([_cli("--n_devices", "2", "--log_root", str(tmp_path / "logs"),
                           env_extra={"TI5_DP_TIMEOUT_S": "10"})])
    assert time.monotonic() - t0 > 10
    assert len(_rows(log)) == 2 and "rank 0 of 2, 8 envs per rank" in log
    _only_checkpoint(tmp_path / "logs")


def test_cli_two_processes_at_a_coordinator(tmp_path):
    """Two OS processes with ``--coordinator``, ``--num_processes 2``,
    ``--process_id 0/1`` and ``--n_devices 2`` (tests/test_parallel.py:
    252-300): rank 0 prints the metric rows and writes model_2.pt into its
    log root; rank 1 prints none and writes nothing.  Then ``--resume``
    under the same two log roots: both ranks continue from the checkpoint
    rank 0 resolved, and rank 0 writes model_3.pt."""
    def run(*flags):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        return _finish([_cli("--n_devices", "2", "--coordinator", f"127.0.0.1:{port}",
                             "--num_processes", "2", "--process_id", str(i),
                             "--log_root", str(tmp_path / f"logs{i}"), *flags)
                        for i in range(2)])

    logs = run()
    assert len(_rows(logs[0])) == 2 and _rows(logs[1]) == []
    _only_checkpoint(tmp_path / "logs0")
    assert not os.path.exists(tmp_path / "logs1")
    # --resume: rank 0 resolves its newest checkpoint and both ranks load it
    # (rank 1's own log root holds none)
    (first,) = os.listdir(tmp_path / "logs0")
    logs = run("--resume", "--max_iterations", "1", "--run_name", "resumed")
    picked = os.path.join(str(tmp_path / "logs0"), first, "model_2.pt")
    assert f"resuming from {picked}" in logs[0] and "resuming" not in logs[1]
    assert [r.split()[1] for r in _rows(logs[0])] == ["3"] and _rows(logs[1]) == []
    (resumed,) = set(os.listdir(tmp_path / "logs0")) - {first}
    sd = torch.load(tmp_path / "logs0" / resumed / "model_3.pt", map_location="cpu",
                    weights_only=True)
    assert set(sd) == {"ts", "iteration"} and sd["iteration"] == 3
    assert not os.path.exists(tmp_path / "logs1")


def test_cli_refuses_more_ranks_than_cards(tmp_path):
    """More local ranks than the host has cards raises, naming both counts
    (here: no card)."""
    from ti5_isaacgym_tpu_torch.scripts import train

    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has 2 cards")
    with pytest.raises(ValueError, match=f"2 ranks on this host, which has "
                                         f"{torch.cuda.device_count()} CUDA device"):
        train.main(["--n_devices", "2", "--num_envs", "16", "--log_root", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [
    ["--num_processes", "2"], ["--process_id", "0"],
    ["--coordinator", "h:1", "--num_processes", "2"],
    ["--coordinator", "h:1", "--num_processes", "2", "--process_id", "2"],
    ["--coordinator", "h:1", "--num_processes", "2", "--process_id", "0", "--n_devices", "3"],
    ["--n_devices", "0"]])
def test_cli_flag_checks(flags):
    """``--num_processes``/``--process_id`` need ``--coordinator``, a
    process id in range, ``--n_devices`` a positive multiple of
    ``--num_processes``; a valid combination parses."""
    from ti5_isaacgym_tpu_torch.utils import helpers

    with pytest.raises(SystemExit):
        helpers.get_args(flags)
    args = helpers.get_args(["--coordinator", "h:1", "--num_processes", "2", "--process_id",
                             "1", "--n_devices", "4"])
    assert (args.n_devices, args.num_processes, args.process_id) == (4, 2, 1)


def test_resume_restores_the_learning_state(two_ranks):
    """Resuming the lead's checkpoint under data parallelism restores its
    params, Adam state and lr on every rank, bit-equal to the trained ones,
    and the iteration count, onto a fresh env state (the sharded initial
    one); a single process resumes it onto its own fresh env state."""
    (r0, r1), _ = two_ranks
    for r in (r0, r1):
        assert r["resumed_iteration"] == 2
        for k, v in r["trained"].items():
            assert _same(r["resumed"][k], v), k
        for k, v in r["resumed_env"].items():
            assert _same(v, r["carry"][f"env_state/{k}"]), k
    runner = small_runner()
    got = runner.load(os.path.join(r0["log_dir"], "model_2.pt"))
    fresh = runner.init_carry()
    assert runner.iteration_count == 2
    for k, v in _flat(carry_to_dict(got)["ts"]).items():
        assert _same(_raw(v), r0["trained"][k]), k
    assert torch.equal(got.env_state.phys.qpos, fresh.env_state.phys.qpos)
