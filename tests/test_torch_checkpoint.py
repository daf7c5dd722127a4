"""Slim checkpoints, the graft, the std reheat and the committed walking
lineage (``utils/checkpoint.py`` and its scripts), against the JAX tools.

The runs are ``t1_dh_stand`` at 8 envs cut to a 2x2 terrain and 4 steps per
env (``tests/torch_cut_cli.py``), on the CPU.  The lineage tests read the
orbax checkpoint ``checkpoints/t1_dh_stand/<run>/model_71000`` with JAX and
orbax (``tests/torch_lineage.py``) and hold the committed
``checkpoints_torch/.../model_71000.pt`` to it bit for bit, and the port's
graft of it to JAX's ``tools/resume_migrate.graft`` of the same checkpoint
(onto a fresh train state of the same network: the learning state does not
depend on the env).
"""
import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu_torch.algo.convert import flat_from_params, flatten_tree
from ti5_isaacgym_tpu_torch.algo.runner import OnPolicyRunner, carry_to_dict
from ti5_isaacgym_tpu_torch.scripts import (contact_stats, eval_report, reheat_std,
                                            resume_migrate, resume_round, seed_probe,
                                            slim_checkpoint, sync_checkpoint, train, train_walk)
from ti5_isaacgym_tpu_torch.utils import checkpoint as ck
from ti5_isaacgym_tpu_torch.utils.registry import TaskRegistry, task_registry

sys.path.insert(0, os.path.dirname(__file__))
import torch_cut_cli  # noqa: E402
import torch_lineage  # noqa: E402

ROOT = torch_lineage.ROOT
N = 8


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread, here and in the processes a test starts: the ops
    are small, and the workers of a parallel test run share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bits(t):
    t = torch.as_tensor(t)
    return t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)


def _assert_bit_equal(a, b, what):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb), f"{what}: {sorted(set(fa) ^ set(fb))}"
    for k in fa:
        x, y = torch.as_tensor(fa[k]), torch.as_tensor(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}: {k}"
        assert torch.equal(_bits(x), _bits(y)), f"{what}: {k} differs"


@pytest.fixture
def cut_registry(monkeypatch):
    """The process's task registry with every task cut (restored after)."""
    torch_cut_cli.patch_registry(monkeypatch)


def _runner(num_envs=N, seed=None, log_dir=None):
    reg = TaskRegistry()
    cls, env_cfg, train_cfg = task_registry._get("t1_dh_stand")
    reg.register("t1_dh_stand", cls, env_cfg, train_cfg)
    torch_cut_cli.cut_tasks(reg)
    cls, env_cfg, train_cfg = reg._get("t1_dh_stand")
    env_cfg = dataclasses.replace(env_cfg, env=dataclasses.replace(env_cfg.env,
                                                                   num_envs=num_envs))
    env = cls(env_cfg, seed=train_cfg.seed, device="cpu")
    return OnPolicyRunner(env, env_cfg, train_cfg, log_dir=log_dir, seed=seed, verbose=False)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A full checkpoint after one iteration at 8 envs: (runner, carry, path)."""
    runner = _runner()
    carry, _ = runner._iter_fn(runner.init_carry())
    runner.iteration_count = 1
    path = runner.save(carry, path=str(tmp_path_factory.mktemp("full") / "model_1.pt"),
                       keep_last=0)
    return runner, carry, path


def test_slim_roundtrip(trained, tmp_path):
    """A port of tests/test_checkpoint_tools.py::test_slim_roundtrip: save,
    slim (the CLI), graft onto a fresh carry of another seed: the learning
    state and the run's generator bit-equal, the curriculum fields survive,
    the big buffers are fresh, and the grafted carry trains on."""
    runner, carry, full = trained
    out = slim_checkpoint.main([full, str(tmp_path / "slim_1.pt"), "--device", "cpu"])
    payload = ck.load(out)
    assert ck.is_slim(payload) and not ck.is_slim(ck.load(full))
    assert set(payload) == {"ts", "iteration", "rng", "env_state"}
    assert set(payload["env_state"]) == set(ck.KEEP_ENV_FIELDS) and payload["iteration"] == 1
    assert os.path.getsize(out) < os.path.getsize(full)
    other = _runner(seed=123)
    fresh = other.init_carry()
    assert not torch.equal(fresh.env_state.env_origin, carry.env_state.env_origin)
    resumed = ck.graft(fresh, payload)
    _assert_bit_equal(carry_to_dict(carry)["ts"], carry_to_dict(resumed)["ts"], "ts")
    assert torch.equal(carry.rng.get_state(), resumed.rng.get_state())
    for k in ck.KEEP_ENV_FIELDS:
        assert torch.equal(getattr(resumed.env_state, k), getattr(carry.env_state, k)), k
    steps = runner.num_steps_per_env
    assert int(resumed.env_state.common_step) == int(fresh.env_state.common_step) + steps
    for k in ("obs_hist", "lag_buffer", "dof_lag_buffer", "episode_length"):
        assert torch.equal(getattr(resumed.env_state, k), getattr(fresh.env_state, k)), k
    assert resumed.obs is resumed.env_state.obs_hist
    assert torch.equal(resumed.cur_reward_sum, fresh.cur_reward_sum)
    nxt, metrics = other._iter_fn(resumed)
    assert all(bool(torch.isfinite(v.float()).all()) for v in metrics.values())
    assert int(nxt.env_state.common_step) == int(resumed.env_state.common_step) + steps


def test_slim_resume_restarts_episodes_on_the_restored_tiles(trained, tmp_path, cut_registry):
    """The cause of the terrain level's jump in the 71k lineage's first
    episodes on the card (PERF.md §6) and its repair.  A slim
    payload (here its levels set to row 0) grafted onto a fresh carry of
    another seed restores the payload's origins but leaves each robot on the
    fresh carry's tile: JAX's terrain curriculum, with every env done, moves
    up exactly the envs whose robot stands on another row (8 m away), and
    the port's update equals it.  ``restart_episodes`` (which
    ``resume_migrate`` runs on a slim file) places the robots at the
    restored origins, the five fields still the payload's: the same update
    moves none up.  ``resume_migrate`` from a slim file starts every robot
    within its tile's spawn square."""
    from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg as JCfg
    from ti5_isaacgym_tpu.envs import legged as jlegged
    from ti5_isaacgym_tpu_torch.envs import legged as tlegged

    runner, _, full = trained
    other = _runner(seed=123)
    env, fresh = other.env, other.init_carry()
    payload = ck.slim(ck.load(full))
    ttype = payload["env_state"]["terrain_type"]
    level = torch.zeros_like(ttype)
    payload["env_state"].update(terrain_level=level,
                                env_origin=tlegged.origin_at(env.terrain_origins, level, ttype))
    jcfg = JCfg()
    jcfg = dataclasses.replace(jcfg, terrain=dataclasses.replace(
        jcfg.terrain, num_rows=env.cfg.terrain.num_rows, num_cols=env.cfg.terrain.num_cols))

    def levels_after_every_episode_ends(carry):
        s = carry.env_state
        args = [s.phys.base_pos[:, :2], s.env_origin, s.commands, s.terrain_level,
                s.terrain_type, env.terrain_origins]
        want, _ = jlegged.terrain_curriculum_update(
            jcfg, jax.random.PRNGKey(0), jnp.ones(N, bool), *(jnp.asarray(a.numpy())
                                                                for a in args))
        got, _ = tlegged.terrain_curriculum_update(env.cfg, torch.Generator(),
                                                   torch.ones(N, dtype=torch.bool), *args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return got

    off_tile = tlegged.origin_at(env.terrain_origins, fresh.env_state.terrain_level,
                                 ttype)[:, 0] != payload["env_state"]["env_origin"][:, 0]
    assert off_tile.any() and not off_tile.all()
    grafted = ck.graft(fresh, payload)
    assert torch.equal(levels_after_every_episode_ends(grafted), off_tile.to(torch.int32))
    restarted = ck.restart_episodes(env, grafted)
    assert not levels_after_every_episode_ends(restarted).any()
    for k in ck.KEEP_ENV_FIELDS:
        assert torch.equal(getattr(restarted.env_state, k), payload["env_state"][k]), k
    assert bool((restarted.env_state.episode_length == 1).all())
    assert restarted.obs is not grafted.obs

    path = str(tmp_path / "model_1.pt")
    ck.save(payload, path)
    migrated, carry = resume_migrate.migrate(resume_migrate.get_args(
        ["--ckpt", path, "--num_envs", str(N), "--seed", "123", "--device", "cpu"]))
    s = carry.env_state
    half = env.cfg.terrain.platform / 3.0
    assert float((s.phys.base_pos[:, :2] - s.env_origin[:, :2]).abs().max()) <= half
    assert torch.equal(s.env_origin, payload["env_state"]["env_origin"])


def test_graft_refuses_another_env_count(trained):
    _, _, full = trained
    payload = ck.slim(ck.load(full))
    fresh = _runner(num_envs=2 * N).init_carry()
    with pytest.raises(ValueError, match=r"env_state/terrain_level is \(8,\) in the checkpoint "
                                         r"but \(16,\) in the fresh carry"):
        ck.graft(fresh, payload)
    # the learning state alone grafts at any env count
    assert torch.equal(ck.graft(fresh, {"ts": payload["ts"]}).ts.params["std"],
                       payload["ts"]["params"]["std"])


def test_reheat_std(trained, tmp_path):
    _, _, full = trained
    before = ck.load(full)
    path = reheat_std.main([full, str(tmp_path / "reheated.pt"), "--std", "0.4",
                            "--device", "cpu"])
    after = ck.load(path)
    ts = after["ts"]
    assert bool((ts["params"]["std"] == torch.tensor(0.4, dtype=torch.float32)).all())
    assert not bool(ts["mu"]["std"].any()) and not bool(ts["nu"]["std"].any())
    assert bool(before["ts"]["mu"]["std"].any())
    for tree in ("params", "mu", "nu"):
        before["ts"][tree].pop("std")
        ts[tree].pop("std")
    _assert_bit_equal(before, after, "every leaf but std")
    payload = ck.load(full)
    ck.reheat_std(payload, 0.4)
    assert not bool((payload["ts"]["params"]["std"] == 0.4).all())   # not modified


@pytest.fixture(scope="module")
def orbax_raw():
    return torch_lineage.restore_orbax()


def test_committed_lineage_equals_the_orbax_checkpoint(orbax_raw):
    """The committed .pt holds the orbax checkpoint's leaves bit for bit:
    params, Adam mu and nu (through the port's names and layouts), the Adam
    count, lr, the iteration and the five env fields; and it is what
    ``from_jax_slim`` makes of it."""
    raw = orbax_raw
    pt = ck.load(torch_lineage.PORT_CKPT)
    assert ck.is_slim(pt) and "rng" not in pt
    _assert_bit_equal(ck.from_jax_slim(raw), pt, "from_jax_slim against the committed file")
    adam = raw["opt_state"][1]
    for name, tree in (("params", raw["params"]), ("mu", adam["mu"]), ("nu", adam["nu"])):
        want = flatten_tree(tree)
        got = flat_from_params(pt["ts"][name])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(
                got[k].view(np.uint8), np.ascontiguousarray(want[k]).view(np.uint8)), (name, k)
    assert sum(v.numel() for v in pt["ts"]["params"].values()) == 856972
    assert pt["ts"]["count"].dtype == torch.int32 and int(pt["ts"]["count"]) == 568000
    assert int(adam["count"]) == 568000
    assert np.array_equal(_bits(pt["ts"]["lr"]).numpy(), np.asarray(raw["lr"]).reshape(-1).view(np.uint8))
    assert pt["iteration"] == int(raw["iteration"]) == 71000
    for k in ck.KEEP_ENV_FIELDS:
        want = np.asarray(raw["env_state"][k])
        got = pt["env_state"][k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
    assert int(pt["env_state"]["common_step"]) == 1704001
    assert pt["env_state"]["cmd_vx_range"].tolist() == [-0.75, 1.5]


def _jax_graft():
    spec = importlib.util.spec_from_file_location(
        "jax_resume_migrate", os.path.join(ROOT, "tools", "resume_migrate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.graft


def test_lineage_graft_equals_jax_graft(orbax_raw):
    """The learning state of the lineage grafted by the port onto a 16-env
    runner's carry equals JAX's graft of the same checkpoint onto a fresh
    JAX train state of the same network, bit for bit (params, mu, nu, the
    Adam count, lr).  The five env fields are held to the raw arrays by
    ``test_committed_lineage_equals_the_orbax_checkpoint``; a 4096-env carry
    to graft them onto takes too long to build on the CPU here (the card
    does it: ``chip_smoke.py`` phase 10)."""
    from ti5_isaacgym_tpu.algo.ppo import PPOConfig, init_train_state
    from ti5_isaacgym_tpu.algo.runner import build_network as jax_network
    from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg, T1TrainCfg

    raw = orbax_raw
    graft = _jax_graft()
    cfg = T1EnvCfg()
    net = jax_network(T1TrainCfg(), cfg)
    with jax.disable_jit():
        params = net.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, cfg.env.num_observations)),
                          jnp.zeros((1, cfg.env.num_privileged_obs)))
        fresh = init_train_state(PPOConfig(), params)
        jts = fresh.replace(params=graft(fresh.params, raw["params"]),
                            opt_state=graft(fresh.opt_state, raw["opt_state"]),
                            lr=graft(fresh.lr, raw["lr"]))
    jts = jax.tree.map(np.asarray, jts)
    adam = jts.opt_state[1]
    runner = _runner(num_envs=16)
    pt = ck.load(torch_lineage.PORT_CKPT)
    ts = ck.graft(runner.init_carry(), {"ts": pt["ts"]}).ts
    for name, tree in (("params", jts.params), ("mu", adam.mu), ("nu", adam.nu)):
        want = flatten_tree(tree)
        got = flat_from_params(getattr(ts, name))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(
                got[k].view(np.uint8), want[k].view(np.uint8)), (name, k)
    assert int(ts.count) == int(adam.count) == 568000 and ts.count.dtype == torch.int32
    assert np.array_equal(_bits(ts.lr).numpy(), np.asarray(jts.lr, np.float32).reshape(-1).view(np.uint8))


def _fake_run(root, task="t1_dh_stand", run="Jan01_00-00-00_walk", full=None):
    run_dir = os.path.join(root, task, run)
    os.makedirs(run_dir)
    if full is not None:
        torch.save(ck.load(full), os.path.join(run_dir, "model_1.pt"))
    for name in ("metrics.csv", "config.json"):
        with open(os.path.join(run_dir, name), "w") as f:
            f.write(name)
    return run_dir


def test_lifecycle_clis(trained, cut_registry, tmp_path):
    """sync_checkpoint slims the newest run's checkpoint into the slim root
    (pruning the older one, copying metrics.csv and config.json);
    resume_round resumes from it in a process of its own; resume_migrate
    --iters 1 continues the iteration count; train --resume on a slim
    checkpoint raises, naming resume_migrate."""
    _, _, full = trained
    logs, slims = str(tmp_path / "logs"), str(tmp_path / "slims")
    old = os.path.join(slims, "t1_dh_stand", "Dec31_00-00-00_old")
    os.makedirs(old)
    torch.save(ck.slim(ck.load(full)), os.path.join(old, "model_0.pt"))
    run_dir = _fake_run(logs, full=full)
    argv = ["t1_dh_stand", "--log_root", logs, "--ckpt_root", slims, "--device", "cpu"]
    dest = sync_checkpoint.main(argv)
    assert dest == os.path.join(slims, "t1_dh_stand", os.path.basename(run_dir), "model_1.pt")
    assert ck.is_slim(ck.load(dest)) and not os.path.exists(old)
    assert sorted(os.listdir(os.path.dirname(dest))) == ["config.json", "metrics.csv",
                                                        "model_1.pt"]
    assert sync_checkpoint.main(argv) == dest                        # already synced

    proc = resume_round.main([str(N), "1", "--log_root", logs, "--ckpt_root", slims,
                              "--device", "cpu"], entry=torch_cut_cli.entry)
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    console = open(os.path.join(logs, "train_cont.console")).read()
    assert rc == 0, console
    assert f"migrated resume from {dest} at iteration 1" in console
    cont = [d for d in os.listdir(os.path.join(logs, "t1_dh_stand")) if d.endswith("_cont")]
    assert len(cont) == 1 and os.path.exists(os.path.join(logs, "t1_dh_stand", cont[0],
                                                          "model_2.pt"))
    assert open(os.path.join(logs, "train_cont.pid")).read() == f"pid: {proc.pid}\n"

    runner = resume_migrate.main(["--ckpt", dest, "--num_envs", str(N), "--iters", "1",
                                  "--log_dir", str(tmp_path / "migrated"), "--log_every", "1",
                                  "--device", "cpu"])
    assert runner.iteration_count == 2
    assert os.path.exists(tmp_path / "migrated" / "model_2.pt")
    with pytest.raises(ValueError, match="slim checkpoint.*resume_migrate"):
        train.main(["--resume", "--num_envs", str(N), "--max_iterations", "1", "--device",
                    "cpu", "--log_root", os.path.dirname(os.path.dirname(dest))])


def test_entry_points_default_to_the_card():
    """Without ``--device cpu`` the new entry points raise where there is no
    card (the card's machine has one)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main, argv in ((slim_checkpoint.main, ["a.pt", "b.pt"]),
                       (reheat_std.main, ["a.pt", "b.pt"]),
                       (resume_migrate.main, ["--ckpt", "a.pt"]),
                       (sync_checkpoint.main, []), (resume_round.main, []),
                       (train_walk.main, []), (seed_probe.main, []),
                       (contact_stats.main, []), (eval_report.main, ["--run", "none"])):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            main(argv)


def test_resume_round_starts_fresh_without_a_slim(cut_registry, tmp_path):
    """No slim checkpoint: a fresh ``train`` run named ``cont``."""
    logs = str(tmp_path / "logs")
    proc = resume_round.main([str(N), "1", "--log_root", logs, "--ckpt_root",
                              str(tmp_path / "none"), "--device", "cpu"],
                             entry=lambda m: [sys.executable, "-c", "import sys; "
                                              "print(sys.argv[1:])", m])
    assert proc.wait(timeout=60) == 0
    console = open(os.path.join(logs, "train_cont.console")).read()
    assert "'train'" in console and "'--run_name', 'cont'" in console
    assert f"'--log_root', '{os.path.join(logs, 't1_dh_stand')}'" in console
