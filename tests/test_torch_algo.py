"""Port parity of the learner: networks, the Gaussian head, GAE, the PPO loss
and update, and the flax-style init, against ``ti5_isaacgym_tpu/algo``.

Inputs are made with numpy from a seed and fed to both packages; parameters
are drawn by flax and carried into the port with ``params_from_flat`` (a
whole train state with ``train_state_from_jax``).  The JAX side runs eagerly
(``jax.disable_jit()``), except the whole update, which is jitted once for
its two calls.  Each test states its tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ti5_isaacgym_tpu.algo import networks as jnets
from ti5_isaacgym_tpu.algo import ppo as jppo
from ti5_isaacgym_tpu.algo import rollout as jroll
from ti5_isaacgym_tpu_torch.algo import networks as tnets
from ti5_isaacgym_tpu_torch.algo import ppo as tppo
from ti5_isaacgym_tpu_torch.algo import rollout as troll
from ti5_isaacgym_tpu_torch.algo.convert import (flatten_tree, params_from_flat,
                                                 train_state_from_jax)

T, N, NA = 8, 16, 12


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_params(net, key=0, obs_dim=3102):
    return net.init(jax.random.PRNGKey(key), jnp.zeros((1, obs_dim)), jnp.zeros((1, 219)))


def _torch_params(jparams):
    return params_from_flat(flatten_tree(jax.tree.map(np.asarray, jparams)))


def _batch(seed=0):
    """A seeded [T, N] trajectory: obs and critic obs in bf16 as the env
    stores them, actions, rewards, dones."""
    rng = np.random.default_rng(seed)
    obs = (rng.normal(size=(T, N, 3102)) * 0.3).astype(np.float32)
    priv = (rng.normal(size=(T, N, 219)) * 0.3).astype(np.float32)
    # round to bf16 once so both packages see the same values
    obs = torch.from_numpy(obs).to(torch.bfloat16).float().numpy()
    priv = torch.from_numpy(priv).to(torch.bfloat16).float().numpy()
    return dict(obs=obs, priv=priv,
                actions=(rng.normal(size=(T, N, NA)) * 0.3).astype(np.float32),
                rewards=(rng.normal(size=(T, N)) * 0.1).astype(np.float32),
                dones=rng.uniform(size=(T, N)) < 0.1)


def _trajs(jnet, jparams, b):
    """The same trajectory for both packages, with the behaviour policy's
    mean, std and log prob from the JAX network."""
    jobs = jnp.asarray(b["obs"]).astype(jnp.bfloat16)
    jpriv = jnp.asarray(b["priv"]).astype(jnp.bfloat16)
    mean, std = jnet.apply(jparams, jobs.reshape(T * N, -1), method="distribution")
    lp = jnets.log_prob(mean, std, jnp.asarray(b["actions"]).reshape(T * N, NA))
    vals = jnet.apply(jparams, jpriv, method="evaluate")
    jt = jroll.Transition(obs=jobs, critic_obs=jpriv, actions=jnp.asarray(b["actions"]),
                          rewards=jnp.asarray(b["rewards"]), dones=jnp.asarray(b["dones"]),
                          values=vals, log_probs=lp.reshape(T, N), mu=mean.reshape(T, N, NA),
                          sigma=std.reshape(T, N, NA))
    tt = troll.Transition(
        obs=_t(b["obs"]).to(torch.bfloat16), critic_obs=_t(b["priv"]).to(torch.bfloat16),
        actions=_t(b["actions"]), rewards=_t(b["rewards"]), dones=torch.from_numpy(b["dones"]),
        values=_t(vals), log_probs=_t(lp).reshape(T, N), mu=_t(mean).reshape(T, N, NA),
        sigma=_t(std).reshape(T, N, NA))
    return jt, tt


# --- ports of tests/test_algo.py ------------------------------------------


def test_gaussian_head():
    """The reference's hand values (tests/test_algo.py:14), then the helpers
    against JAX's on seeded inputs: rtol 1e-5, atol 1e-6."""
    mean, std, a = torch.zeros(4, 3), torch.ones(4, 3), torch.zeros(4, 3)
    np.testing.assert_allclose(tnets.log_prob(mean, std, a).numpy(),
                               3 * (-0.5 * np.log(2 * np.pi)), rtol=1e-5)
    np.testing.assert_allclose(float(tnets.entropy(std[0])), 3 * 0.5 * (1 + np.log(2 * np.pi)),
                               rtol=1e-5)
    np.testing.assert_allclose(tnets.gaussian_kl(mean, std, mean, std).numpy(), 3e-5, atol=1e-4)
    rng = np.random.default_rng(1)
    m0, m1, a = (rng.normal(size=(64, 12)).astype(np.float32) for _ in range(3))
    s0, s1 = (rng.uniform(0.2, 1.5, size=(64, 12)).astype(np.float32) for _ in range(2))
    pairs = [(tnets.log_prob(_t(m0), _t(s0), _t(a)), jnets.log_prob(m0, s0, a)),
             (tnets.entropy(_t(s0)), jnets.entropy(s0)),
             (tnets.gaussian_kl(_t(m0), _t(s0), _t(m1), _t(s1)),
              jnets.gaussian_kl(m0, s0, m1, s1))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    noise = rng.normal(size=(64, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        tnets.sample_action(_t(m0), _t(s0), noise=_t(noise)).numpy(),
        _t(m0).numpy() + _t(s0).numpy() * noise)


def _traj(rewards, dones, values):
    return troll.Transition(obs=None, critic_obs=None, actions=None, rewards=rewards,
                            dones=dones, values=values, log_probs=None, mu=None, sigma=None)


def test_gae_hand_case():
    """T=3, N=1, gamma 0.5, lam 1: the discounted sums (atol 1e-6)."""
    traj = _traj(torch.ones(3, 1), torch.zeros(3, 1, dtype=torch.bool), torch.zeros(3, 1))
    returns, _ = troll.compute_gae(traj, torch.zeros(1), gamma=0.5, lam=1.0)
    np.testing.assert_allclose(returns[:, 0].numpy(), [1.75, 1.5, 1.0], atol=1e-6)


def test_gae_respects_dones():
    """No bootstrap across a done; the last step bootstraps on last_values
    (atol 1e-6)."""
    traj = _traj(torch.ones(3, 1), torch.tensor([[False], [True], [False]]), torch.zeros(3, 1))
    returns, _ = troll.compute_gae(traj, torch.ones(1) * 10.0, gamma=0.9, lam=1.0)
    np.testing.assert_allclose(float(returns[0, 0]), 1.0 + 0.9 * 1.0, atol=1e-6)
    np.testing.assert_allclose(float(returns[2, 0]), 1.0 + 0.9 * 10.0, atol=1e-6)


def test_minibatch_indices_cover_all():
    gen = torch.Generator()
    gen.manual_seed(0)
    idx = troll.minibatch_indices(gen, 64, 4)
    assert idx.shape == (4, 16)
    assert set(idx.reshape(-1).tolist()) == set(range(64))


def test_dh_network_shapes():
    net = tnets.init_like_flax_(tnets.ActorCriticDH(), torch.Generator().manual_seed(0))
    obs, priv = torch.zeros(5, 66 * 47), torch.zeros(5, 219)
    mean, std = net.distribution(obs)
    assert mean.shape == (5, 12) and std.shape == (5, 12)
    assert net.evaluate(priv).shape == (5,)
    assert net.estimate_velocity(obs).shape == (5, 3)
    a, e = net.act_inference(obs)
    assert a.shape == (5, 12) and e.shape == (5, 3)
    assert net.actor.layers[0].weight.shape[1] == 302      # 235 + 3 + 64
    np.testing.assert_allclose(net.std.detach().numpy(), 1.0)


def test_cnn_output_dims():
    cnn = tnets.LongHistoryCNN()
    assert cnn(torch.zeros(3, 66 * 47)).shape == (3, 64)
    # 47 -(k6,s3)-> 14 -(k4,s2)-> 6; 6*16 = 96 into Dense(128)
    assert cnn.fc.layers[0].weight.shape[1] == 96


def test_estimator_loss_targets_linvel_slice():
    """DH-PPO regresses critic_obs[..., 199:202] (rtol 1e-5)."""
    cfg = tppo.PPOConfig()
    net = tnets.init_like_flax_(tnets.ActorCriticDH(), torch.Generator().manual_seed(0))
    params = dict(net.named_parameters())
    obs = torch.zeros(4, 66 * 47)
    priv = torch.zeros(4, 219)
    priv[:, 199:202] = torch.tensor([1.0, 2.0, 3.0])
    mb = troll.Transition(obs=obs, critic_obs=priv, actions=torch.zeros(4, 12), rewards=None,
                          dones=None, values=torch.zeros(4), log_probs=torch.zeros(4),
                          mu=torch.zeros(4, 12), sigma=torch.ones(4, 12))
    _, (_, _, est_loss, _, _) = tppo.PPO(cfg, net)._loss(params, mb, torch.zeros(4),
                                                        torch.zeros(4))
    with torch.no_grad():
        want = float(torch.mean(torch.square(net.estimate_velocity(obs) - priv[:, 199:202])))
    np.testing.assert_allclose(float(est_loss.detach()), want, rtol=1e-5)


def test_update_dataflow_matches_reference_semantics():
    """The packed-gather update equals a direct transcription of the
    reference generator's semantics (one permutation, [M, B] chunks in
    order, reused across epochs), written here with the port's own loss,
    clip and Adam: params atol 2e-5 + rtol 1e-4 and lr rtol 1e-6, as
    tests/test_algo.py:141 holds the JAX package."""
    cfg = tppo.PPOConfig(learning_rate=1e-5)
    jnet = jnets.ActorCriticDH()
    jparams = _jax_params(jnet, key=8)
    _, traj = _trajs(jnet, jparams, _batch(7))
    net = tnets.ActorCriticDH()
    alg = tppo.PPO(cfg, net)
    returns, adv = troll.compute_gae(traj, torch.zeros(N), cfg.gamma, cfg.lam)
    ts0 = tppo.init_train_state(cfg, _torch_params(jparams))
    gen = torch.Generator()
    gen.manual_seed(9)
    idx = troll.minibatch_indices(gen, T * N, cfg.num_mini_batches)

    flat = troll.flatten_batch(traj)._replace(rewards=None, dones=None)
    flat_ret, flat_adv = returns.reshape(-1), adv.reshape(-1)
    ts = ts0
    for _ in range(cfg.num_learning_epochs):
        for b in range(cfg.num_mini_batches):
            bidx = idx[b]
            mb = troll.Transition(*(None if x is None else x[bidx] for x in flat))
            _, aux, grads = alg.loss_and_grads(ts.params, mb, flat_ret[bidx], flat_adv[bidx])
            kl = torch.mean(tnets.gaussian_kl(mb.mu, mb.sigma, aux[3], aux[4]))
            lr = ts.lr
            lr = torch.where(kl > cfg.desired_kl * 2.0, torch.clamp_min(lr / 1.5, cfg.min_lr), lr)
            lr = torch.where((kl < cfg.desired_kl / 2.0) & (kl > 0.0),
                             torch.clamp_max(lr * 1.5, cfg.max_lr), lr)
            names = list(ts.params)
            g = tppo.clip_by_global_norm([grads[k] for k in names], cfg.max_grad_norm)
            u, mu, nu, count = tppo.adam_direction(g, [ts.mu[k] for k in names],
                                                   [ts.nu[k] for k in names], ts.count)
            ts = tppo.TrainState(
                params={k: ts.params[k] - lr * uk for k, uk in zip(names, u)},
                mu=dict(zip(names, mu)), nu=dict(zip(names, nu)), count=count, lr=lr,
                update_count=ts.update_count + 1)
    ts_new, _ = alg.update(ts0, traj, returns, adv, indices=idx)
    for k in ts.params:
        np.testing.assert_allclose(ts_new.params[k].numpy(), ts.params[k].numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(ts_new.lr), float(ts.lr), rtol=1e-6)
    assert int(ts_new.update_count) == 8 and int(ts_new.count) == 8


# --- against the JAX functions --------------------------------------------


def test_compute_gae_matches_jax():
    """Returns and normalised advantages on a seeded [T, N] case with dones:
    atol 1e-5."""
    rng = np.random.default_rng(3)
    rewards = rng.normal(size=(24, 64)).astype(np.float32)
    values = rng.normal(size=(24, 64)).astype(np.float32)
    dones = rng.uniform(size=(24, 64)) < 0.05
    last = rng.normal(size=64).astype(np.float32)
    jt = jroll.Transition(obs=None, critic_obs=None, actions=None, rewards=jnp.asarray(rewards),
                          dones=jnp.asarray(dones), values=jnp.asarray(values), log_probs=None,
                          mu=None, sigma=None)
    jret, jadv = jroll.compute_gae(jt, jnp.asarray(last), 0.994, 0.9)
    tret, tadv = troll.compute_gae(_traj(_t(rewards), torch.from_numpy(dones), _t(values)),
                                   _t(last), 0.994, 0.9)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-5)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=1e-5)


def test_loss_and_grads_match_jax():
    """``_loss`` and its gradients on one minibatch from the same params as
    ``jax.value_and_grad``: loss rtol 1e-5, each gradient leaf within 1e-4
    of that leaf's largest magnitude."""
    cfg = tppo.PPOConfig()
    jnet = jnets.ActorCriticDH()
    jparams = _jax_params(jnet, key=2)
    jt, tt = _trajs(jnet, jparams, _batch(4))
    jflat, tflat = jroll.flatten_batch(jt), troll.flatten_batch(tt)
    rng = np.random.default_rng(5)
    ret = rng.normal(size=T * N).astype(np.float32)
    adv = rng.normal(size=T * N).astype(np.float32)
    # perturb the params so the ratio, the clips and the KL are not trivial
    jparams = jax.tree.map(
        lambda p: p + 0.05 * jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), jparams)
    jalg = jppo.PPO(jppo.PPOConfig(), jnet)
    with jax.disable_jit():
        (jloss, jaux), jgrads = jax.value_and_grad(jalg._loss, has_aux=True)(
            jparams, jflat, jnp.asarray(ret), jnp.asarray(adv))
    talg = tppo.PPO(cfg, tnets.ActorCriticDH())
    tloss, taux, tgrads = talg.loss_and_grads(_torch_params(jparams), tflat, _t(ret), _t(adv))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for got, want in zip(taux[:3], jaux[:3]):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)
    want = _torch_params(jgrads)
    assert set(want) == set(tgrads)
    for k, g in tgrads.items():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=k)


def test_update_matches_jax():
    """A whole ``PPO.update`` against JAX's from one train state, carried
    across with ``train_state_from_jax`` after one JAX update (so the Adam
    moments are not zero), with the JAX permutation fed in: the five stats
    rtol 1e-4 (``lr`` among them is the mean of the 8 steps' rates), the
    carried ``lr`` after the update equal; the parameter deltas, leaf by
    leaf, within 1% of the step size (the summed lr of the update's 8 steps)
    on every entry of ``std`` and of each bias and on at least 99.9% of each
    weight's entries, and within 2 x the step size on all."""
    cfg = jppo.PPOConfig(learning_rate=1e-4)
    jnet = jnets.ActorCriticDH()
    jparams = _jax_params(jnet, key=11)
    jt, tt = _trajs(jnet, jparams, _batch(12))
    jalg = jppo.PPO(cfg, jnet)
    # one compile serves both updates (eagerly they take twice as long)
    update = jax.jit(jalg.update)
    jret, jadv = jroll.compute_gae(jt, jnp.zeros(N), cfg.gamma, cfg.lam)
    ts1, _ = update(jppo.init_train_state(cfg, jparams), jt, jret, jadv, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    ts2, jstats = update(ts1, jt, jret, jadv, key)
    idx = jroll.minibatch_indices(key, T * N, cfg.num_mini_batches)
    host = jax.tree.map(np.asarray, ts1)
    ts = train_state_from_jax(host.params, host.opt_state, host.lr, host.update_count)
    assert int(ts.count) == 8 and float(ts.nu["critic.layers.0.weight"].abs().max()) > 0
    talg = tppo.PPO(tppo.PPOConfig(learning_rate=1e-4), tnets.ActorCriticDH())
    tret, tadv = troll.compute_gae(tt, torch.zeros(N), cfg.gamma, cfg.lam)
    ts_new, tstats = talg.update(ts, tt, tret, tadv, indices=torch.from_numpy(np.asarray(idx)))
    for k in ("value_loss", "surrogate_loss", "estimator_loss", "kl", "lr"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-4, err_msg=k)
    assert float(ts_new.lr) == float(np.float32(ts2.lr))
    step = float(tstats["lr"]) * 8
    before, after = ts.params, _torch_params(ts2.params)
    for k in before:
        gaps = ((ts_new.params[k] - before[k]) - (after[k] - before[k])).abs().reshape(-1)
        within = float((gaps <= 0.01 * step).float().mean())
        if k == "std" or k.endswith(".bias"):
            assert within == 1.0, (k, float(gaps.max()) / step)
        else:
            assert within >= 0.999, (k, within)
        assert float(gaps.max()) <= 2 * step, k
    assert int(ts_new.update_count) == int(ts2.update_count) == 16


def test_clip_matches_optax():
    """``clip_by_global_norm`` against optax's at a global norm above and one
    below ``max_norm``: rtol 1e-6 (below: equal)."""
    rng = np.random.default_rng(6)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((7, 5), (5,), (3, 2, 4))]
    norm = math.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in leaves))
    for max_norm in (0.5 * norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(max_norm).update(leaves, optax.EmptyState())
        got = tppo.clip_by_global_norm([_t(x) for x in leaves], max_norm)
        for g, w, x in zip(got, want, leaves):
            if max_norm > norm:
                np.testing.assert_array_equal(g.numpy(), x)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_flax_style_init_statistics():
    """``init_like_flax_`` against flax's own init: on a 768x512 Dense and on
    the DH network's first conv kernel, the weight std within 2% of
    1/sqrt(fan_in), |w| <= 2 sigma (sigma = 1/sqrt(fan_in) / 0.8796),
    biases exactly 0, ``std == init_noise_std``; the same statistics from
    flax's ``nn.Dense(...).init`` and ``nn.Conv(...).init``."""
    gen = torch.Generator()
    gen.manual_seed(0)
    dense = tnets.init_like_flax_(tnets.MLP(768, (), 512), gen).layers[0]
    net = tnets.init_like_flax_(tnets.ActorCriticDH(init_noise_std=0.7), gen)
    conv = net.long_history.convs[0]
    jd = fnn.Dense(512).init(jax.random.PRNGKey(0), jnp.zeros((1, 768)))["params"]
    jc = fnn.Conv(32, (6,), strides=(3,), padding="VALID").init(
        jax.random.PRNGKey(1), jnp.zeros((1, 47, 66)))["params"]
    cases = [(dense.weight, dense.bias, 768), (conv.weight, conv.bias, 6 * 66),
             (_t(jd["kernel"]), _t(jd["bias"]), 768), (_t(jc["kernel"]), _t(jc["bias"]), 6 * 66)]
    for w, b, fan_in in cases:
        w = w.detach().double()
        target = 1.0 / math.sqrt(fan_in)
        assert abs(float(w.std()) / target - 1.0) < 0.02
        assert float(w.abs().max()) <= 2.0 * target / 0.87962566103423978
        assert float(b.detach().abs().max()) == 0.0
    for mod in net.modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv1d)):
            assert float(mod.bias.detach().abs().max()) == 0.0
    np.testing.assert_array_equal(net.std.detach().numpy(), np.float32(0.7))
    a = tnets.init_like_flax_(tnets.ActorCriticDH(), torch.Generator().manual_seed(3))
    b = tnets.init_like_flax_(tnets.ActorCriticDH(), torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_vanilla_actor_critic_matches_jax():
    """``params_from_flat`` fills ``ActorCritic`` from flax's keys, and its
    mean, value and loss forward equal JAX's on seeded bf16 observations:
    atol 1e-4 + rtol 1e-4 (float32 MLPs accumulated in another order)."""
    jnet = jnets.ActorCritic()
    jparams = _jax_params(jnet, key=4)
    net = tnets.ActorCritic()
    sd = _torch_params(jparams)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    b = _batch(2)
    obs, priv = b["obs"][0], b["priv"][0]
    jobs, jpriv = jnp.asarray(obs).astype(jnp.bfloat16), jnp.asarray(priv).astype(jnp.bfloat16)
    tobs, tpriv = _t(obs).to(torch.bfloat16), _t(priv).to(torch.bfloat16)
    got = tnets.apply(net, sd, "loss_forward", tobs, tpriv)
    want = jnet.apply(jparams, jobs, jpriv, method="loss_forward")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_dh_loss_forward_and_estimator_match_jax():
    """``loss_forward`` and ``estimate_velocity`` of the DH network through
    ``apply`` against JAX's: atol 1e-4 + rtol 1e-4."""
    jnet = jnets.ActorCriticDH()
    jparams = _jax_params(jnet, key=5)
    b = _batch(3)
    jobs = jnp.asarray(b["obs"][0]).astype(jnp.bfloat16)
    jpriv = jnp.asarray(b["priv"][0]).astype(jnp.bfloat16)
    sd = _torch_params(jparams)
    net = tnets.ActorCriticDH()
    tobs, tpriv = _t(b["obs"][0]).to(torch.bfloat16), _t(b["priv"][0]).to(torch.bfloat16)
    got = tnets.apply(net, sd, "loss_forward", tobs, tpriv)
    want = jnet.apply(jparams, jobs, jpriv, method="loss_forward")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        tnets.apply(net, sd, "estimate_velocity", tobs).detach().numpy(),
        np.asarray(jnet.apply(jparams, jobs, method="estimate_velocity")), atol=1e-4, rtol=1e-4)
    with pytest.raises(RuntimeError):          # every parameter must be given
        tnets.apply(net, {k: v for k, v in sd.items() if k != "std"}, "act_mean", tobs)
