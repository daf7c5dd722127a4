"""The port's training runner on the CPU: 16 envs, 2x2 terrain, 4 steps per
env and iteration, full widths (ports of tests/test_runner.py:41-72, which
are ``slow`` there; here the port's CPU iteration takes seconds).

Also: a resume repeats the original run bit for bit, the CSV has the JAX
runner's columns, and the timeout bootstrap and episode statistics of the
rollout on a hand case with a scripted env.
"""
import csv
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.algo.runner import OnPolicyRunner as JaxRunner
from ti5_isaacgym_tpu_torch.algo import networks as tnets
from ti5_isaacgym_tpu_torch.algo.ppo import init_train_state
from ti5_isaacgym_tpu_torch.algo.runner import (OnPolicyRunner, RunnerCarry, carry_to_dict,
                                                split_seed)
from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv


def small_cfgs(num_envs=16, steps=4, vanilla=False):
    cfg = T1EnvCfg()
    cfg = dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, num_envs=num_envs),
        terrain=dataclasses.replace(cfg.terrain, num_rows=2, num_cols=2, border_size=2.0))
    tcfg = T1TrainCfg()
    over = dict(num_steps_per_env=steps)
    if vanilla:
        over.update(policy_class_name="ActorCritic", algorithm_class_name="PPO")
    return cfg, dataclasses.replace(tcfg, runner=dataclasses.replace(tcfg.runner, **over))


def make_runner(log_dir=None, **kw):
    cfg, tcfg = small_cfgs(**kw)
    return OnPolicyRunner(T1DHStandEnv(cfg, seed=tcfg.seed, device="cpu"), cfg, tcfg,
                          log_dir=log_dir)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def assert_bit_equal(a, b):
    fa, fb = _flat(carry_to_dict(a)), _flat(carry_to_dict(b))
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("run"))
    runner = make_runner(log_dir=log_dir)
    carry0 = runner.init_carry()
    params0 = {k: v.clone() for k, v in carry0.ts.params.items()}
    carry1 = runner.learn(2, carry=carry0, log_every=100)
    return runner, params0, carry1


def test_learn_updates_params(trained):
    runner, params0, carry1 = trained
    assert max(float((carry1.ts.params[k] - v).abs().max()) for k, v in params0.items()) > 0
    assert bool(torch.isfinite(carry1.obs.float()).all())
    assert runner.iteration_count == 2 and int(carry1.ts.update_count) == 16
    lr = float(carry1.ts.lr)
    assert runner.ppo_cfg.min_lr <= lr <= runner.ppo_cfg.max_lr


def test_inference_policy(trained):
    runner, _, carry1 = trained
    policy = runner.get_inference_policy(carry1.ts.params)
    a = policy(carry1.obs)
    assert a.shape == (carry1.obs.shape[0], 12)
    np.testing.assert_array_equal(a.numpy(), policy(carry1.obs).numpy())
    net = tnets.ActorCriticDH()
    net.load_state_dict(carry1.ts.params)
    with torch.no_grad():
        np.testing.assert_array_equal(a.numpy(), net.act_mean(carry1.obs).numpy())


def test_checkpoint_roundtrip(trained):
    """The final checkpoint of ``learn`` restores the whole carry bit for bit
    (params, Adam state, lr, env state, generators), and ``params_only``
    takes the params alone."""
    runner, _, carry1 = trained
    path = os.path.join(runner.log_dir, "model_2.pt")
    assert os.path.exists(path)
    assert_bit_equal(carry1, runner.load(path, carry=carry1))
    assert runner.iteration_count == 2
    sd = torch.load(path, map_location="cpu", weights_only=True)
    assert set(sd) == {"ts", "env_state", "rng", "cur_reward_sum", "cur_ep_len", "iteration"}
    other = make_runner()
    fresh = other.init_carry()
    got = other.load(path, carry=fresh, params_only=True)
    for k, v in carry1.ts.params.items():
        assert torch.equal(got.ts.params[k], v)
    assert torch.equal(got.ts.mu["std"], fresh.ts.mu["std"])
    assert got.env_state is fresh.env_state and other.iteration_count == 2


def test_csv_has_reference_columns(trained):
    """``metrics.csv`` has the columns the JAX runner's ``_log_csv`` writes,
    in its order, and one row per iteration."""
    runner, _, _ = trained
    with open(os.path.join(runner.log_dir, "metrics.csv")) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 3 and [r[0] for r in rows[1:]] == ["1", "2"]
    fake = types.SimpleNamespace(log_dir=os.path.join(runner.log_dir, "jax"),
                                 iteration_count=1, env=runner.env)
    metrics = {k: np.zeros(()) for k in (
        "mean_step_reward", "value_loss", "surrogate_loss", "estimator_loss", "kl", "lr",
        "max_command_x", "terrain_level_mean", "est_target_norm", "est_pred_norm",
        "done_count", "walked_distance_sum")}
    metrics["episode_sums_done"] = np.zeros(len(runner.env.reward_names))
    JaxRunner._log_csv(fake, metrics, 0.0, 0.0, 1.0)
    with open(os.path.join(fake.log_dir, "metrics.csv")) as f:
        assert rows[0] == next(csv.reader(f))


def test_resume_is_bit_exact(trained, tmp_path):
    """``learn(1)`` + ``save`` + ``load`` + ``learn(1)`` equals ``learn(2)``
    bit for bit; the runner asks cuDNN for deterministic algorithms, which
    a bit-exact resume on the card needs."""
    _, _, carry2 = trained
    runner = make_runner()
    assert torch.backends.cudnn.deterministic
    carry = runner.learn(1, carry=runner.init_carry(), log_every=100)
    path = runner.save(carry, path=str(tmp_path / "model_1.pt"))
    resumed = runner.learn(1, carry=runner.load(path), log_every=100)
    assert runner.iteration_count == 2
    assert_bit_equal(carry2, resumed)


def test_vanilla_runner():
    runner = make_runner(vanilla=True)
    assert isinstance(runner.network, tnets.ActorCritic) and not runner.alg.dh
    carry = runner.learn(1, log_every=100)
    assert all(bool(torch.isfinite(v).all()) for v in carry.ts.params.values())
    assert float(carry.ts.params["actor.layers.0.weight"].abs().max()) > 0


def test_split_seed_is_fixed():
    """The documented rule: numpy's SeedSequence(seed).generate_state(3)."""
    assert split_seed(5) == tuple(int(s) for s in np.random.SeedSequence(5).generate_state(3))
    assert len(set(split_seed(5))) == 3 and split_seed(5) != split_seed(6)


class ScriptedEnv:
    """Rewards, dones and timeouts from a script; constant observations."""

    def __init__(self, rew, done, tout, priv):
        self.rew, self.done, self.tout = rew, done, tout
        self.device = torch.device("cpu")
        self.num_envs = rew.shape[1]
        self.obs = torch.zeros(self.num_envs, 3102, dtype=torch.bfloat16)
        self.priv = priv

    def step(self, t, action):
        assert action.shape == (self.num_envs, 12)
        extras = {"time_outs": self.tout[t], "episode_sums_done": torch.zeros(2),
                  "walked_distance_sum": torch.tensor(float(self.done[t].sum())),
                  "max_command_x": torch.tensor(0.5)}
        return t + 1, self.obs, self.priv, self.rew[t], self.done[t], extras


def test_timeout_bootstrap_and_episode_stats_hand_case():
    """Stored rewards are ``rew + gamma * V(priv) * time_out`` (atol 1e-6);
    done episodes' returns and lengths are summed and the running sums
    restart at a done, by hand for 3 envs over 4 steps."""
    rew = torch.tensor([[1.0, 2.0, 3.0], [1.0, 1.0, 1.0], [2.0, 0.0, 1.0], [1.0, 1.0, 1.0]])
    done = torch.tensor([[0, 0, 1], [1, 0, 0], [0, 0, 1], [0, 1, 0]], dtype=torch.bool)
    tout = torch.tensor([[0, 0, 1], [0, 0, 0], [0, 0, 0], [0, 1, 0]], dtype=torch.bool)
    priv = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 219)).astype(
        np.float32)).to(torch.bfloat16)
    cfg, tcfg = small_cfgs(num_envs=3, steps=4)
    runner = OnPolicyRunner(ScriptedEnv(rew, done, tout, priv), cfg, tcfg)
    tnets.init_like_flax_(runner.network, torch.Generator().manual_seed(0))
    params = {k: v.clone() for k, v in runner.network.named_parameters()}
    gen = torch.Generator()
    gen.manual_seed(1)
    carry = RunnerCarry(env_state=0, obs=runner.env.obs, priv_obs=priv,
                        ts=init_train_state(runner.ppo_cfg, params), rng=gen,
                        cur_reward_sum=torch.zeros(3), cur_ep_len=torch.zeros(3))
    traj, after, stats = runner.rollout(carry)
    value = tnets.apply(runner.network, params, "evaluate", priv)
    gamma = runner.ppo_cfg.gamma
    np.testing.assert_allclose(traj.rewards.numpy(),
                               (rew + gamma * value * tout.float()).numpy(), atol=1e-6)
    assert float(value.abs().min()) > 1e-3          # the bootstrap is visible
    np.testing.assert_array_equal(traj.dones.numpy(), done.numpy())
    np.testing.assert_allclose(traj.values.numpy(), value.expand(4, 3).numpy(), atol=1e-6)
    assert float(stats["ep_reward_sum"]) == 3 + 2 + 2 + 4
    assert float(stats["ep_len_sum"]) == 1 + 2 + 2 + 4
    assert int(stats["done_count"]) == 4 and float(stats["walked_distance_sum"]) == 4
    np.testing.assert_array_equal(after.cur_reward_sum.numpy(), [3.0, 0.0, 1.0])
    np.testing.assert_array_equal(after.cur_ep_len.numpy(), [2.0, 0.0, 1.0])
    assert after.env_state == 4 and after.ts is carry.ts
