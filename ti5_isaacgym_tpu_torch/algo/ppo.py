"""PPO / DH-PPO update rules (port of ``ti5_isaacgym_tpu/algo/ppo.py``).

One implementation serves both variants: DH-PPO adds the supervised
state-estimator MSE term (regressing the base linear velocity out of the
privileged observation at ``lin_vel_idx``) to the PPO loss, one Adam step
over the combined loss (reference ``dh_ppo.py:120-189``).

The optimiser is the JAX package's ``optax.chain(clip_by_global_norm,
scale_by_adam)`` written out on the parameter tensors: the clip scales by
``max_norm / norm`` only when ``norm >= max_norm`` (``torch.nn.utils.
clip_grad_norm_`` would scale every clipped step by ``max_norm / (norm +
1e-6)``), then Adam's direction with the bias correction of the incremented
count, applied as ``-lr * u`` with the carried adaptive-KL learning rate.
The learning-rate decision stays on the device (``torch.where``): the host
never waits for a minibatch.

Data parallelism: a learner with a ``group`` (a
:class:`~..parallel.trainer.ReduceGroup`) averages each minibatch's
gradients and KL over the group's ranks before the learning-rate rule and
the clip (the JAX package's two ``pmean`` over ``axis_name``), in one
all-reduce of one flat buffer per minibatch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from . import networks as nets
from .rollout import Transition, flatten_batch, minibatch_indices

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class PPOConfig:
    clip_param: float = 0.2
    num_learning_epochs: int = 2
    num_mini_batches: int = 4
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.001
    gamma: float = 0.994
    lam: float = 0.9
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    learning_rate: float = 1e-5
    min_lr: float = 1e-5
    max_lr: float = 1e-2
    use_clipped_value_loss: bool = True
    schedule: str = "adaptive"
    # DH extras
    estimator_loss: bool = True
    lin_vel_idx: int = 199


@dataclass
class TrainState:
    """The learner's state: parameters and Adam moments as ``{name: tensor}``
    (the names of the network's ``named_parameters``), Adam's step count,
    the adaptive-KL learning rate and the number of updates, all on the
    device."""

    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor          # int32 scalar
    lr: torch.Tensor             # float32 scalar
    update_count: torch.Tensor   # int32 scalar

    def replace(self, **kw) -> "TrainState":
        return replace(self, **kw)


def init_train_state(cfg: PPOConfig, params: Dict[str, torch.Tensor]) -> TrainState:
    dev = next(iter(params.values())).device
    return TrainState(
        params=params,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev),
        lr=torch.tensor(cfg.learning_rate, dtype=torch.float32, device=dev),
        update_count=torch.zeros((), dtype=torch.int32, device=dev))


def clip_by_global_norm(grads, max_norm: float):
    """optax's ``clip_by_global_norm``: ``g`` where the global norm is below
    ``max_norm``, else ``g / norm * max_norm`` (both exact: where the norm is
    below, the division and product are by 1)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    out = torch._foreach_div(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(out, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return out


def adam_direction(grads, mu, nu, count):
    """optax's ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0):
    returns (direction, new mu, new nu, new count)."""
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - ADAM_B1),
                            torch._foreach_mul(mu, ADAM_B1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - ADAM_B2)
    nu = torch._foreach_add(sq, torch._foreach_mul(nu, ADAM_B2))
    count = torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32, device=c.device), c)
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, ADAM_EPS)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    return u, mu, nu, count


def mean_grads_(group, grads, kl_mean):
    """Average ``grads`` (written back in place) and ``kl_mean`` (returned)
    over ``group``'s ranks: one all-reduce of the flattened gradients and the
    KL in one float32 buffer.  In place, so that the clip's norm reads the
    tensors it reads without a group (a view into the buffer may be aligned
    otherwise, and the card's fused norm sums aligned tensors in another
    order)."""
    flat = group.mean_(torch.cat([x.reshape(-1) for x in grads] + [kl_mean.reshape(1)]),
                       "update")
    torch._foreach_copy_(grads, [c.view_as(x) for c, x in
                                 zip(flat[:-1].split([x.numel() for x in grads]), grads)])
    return flat[-1]


class PPO:
    """Update rule bound to a network module (vanilla or DH).  The module is
    only the function: the parameters live in the :class:`TrainState` and
    are passed in (:func:`.networks.apply`)."""

    def __init__(self, cfg: PPOConfig, network, *, dh: bool = True, group=None):
        self.cfg = cfg
        self.network = network
        self.dh = dh and cfg.estimator_loss
        self.group = group

    # --- acting -------------------------------------------------------

    @torch.no_grad()
    def act(self, params, obs, critic_obs, generator: Optional[torch.Generator] = None,
            noise=None):
        """(action, log prob, mean, std, value), the action drawn from
        ``generator`` (or ``mean + std * noise``)."""
        mean, std = nets.apply(self.network, params, "distribution", obs)
        action = nets.sample_action(mean, std, generator, noise)
        logp = nets.log_prob(mean, std, action)
        value = nets.apply(self.network, params, "evaluate", critic_obs)
        return action, logp, mean, std, value

    @torch.no_grad()
    def value(self, params, critic_obs):
        return nets.apply(self.network, params, "evaluate", critic_obs)

    # --- loss ---------------------------------------------------------

    def _loss(self, params, mb: Transition, mb_returns, mb_adv):
        cfg = self.cfg
        mean, std, value, est_vel = nets.apply(self.network, params, "loss_forward",
                                               mb.obs, mb.critic_obs)
        logp = nets.log_prob(mean, std, mb.actions)
        ent = nets.entropy(std)

        ratio = torch.exp(logp - mb.log_probs)
        surr = -mb_adv * ratio
        surr_clipped = -mb_adv * torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
        surrogate_loss = torch.mean(torch.maximum(surr, surr_clipped))

        if cfg.use_clipped_value_loss:
            v_clipped = mb.values + torch.clamp(value - mb.values, -cfg.clip_param,
                                                cfg.clip_param)
            v_loss = torch.maximum(torch.square(value - mb_returns),
                                   torch.square(v_clipped - mb_returns)).mean()
        else:
            v_loss = torch.square(mb_returns - value).mean()

        loss = surrogate_loss + cfg.value_loss_coef * v_loss - cfg.entropy_coef * ent.mean()
        est_loss = torch.zeros((), device=loss.device)
        if self.dh:
            # the privileged obs is bf16; promoted to float32 as JAX promotes it
            ref_vel = mb.critic_obs[..., cfg.lin_vel_idx:cfg.lin_vel_idx + 3].to(torch.float32)
            est_loss = torch.mean(torch.square(est_vel - ref_vel))
            loss = loss + est_loss
        return loss, (surrogate_loss, v_loss, est_loss, mean, std)

    def loss_and_grads(self, params, mb: Transition, mb_returns, mb_adv):
        """(loss, aux, {name: gradient}) of :meth:`_loss` by autograd."""
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, aux = self._loss(p, mb, mb_returns, mb_adv)
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), tuple(a.detach() for a in aux), dict(zip(p, grads))

    # --- update -------------------------------------------------------

    def update(self, ts: TrainState, traj: Transition, returns, advantages,
               generator: Optional[torch.Generator] = None,
               indices: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict]:
        """Epochs x minibatches over one permutation of the flattened batch
        (``indices`` [M, B], or drawn from ``generator``), the dataflow of the
        JAX package: the 7 small per-sample tensors packed into one
        ``[T*N, 3*na+4]`` gather, obs and critic obs gathered per minibatch;
        per minibatch the loss and its gradients, the adaptive-KL rate
        measured on this minibatch with the current params and applied to
        this same step, the clip, then Adam."""
        cfg = self.cfg
        M = cfg.num_mini_batches
        flat = flatten_batch(traj)
        total = flat.values.shape[0]
        B = total // M
        if indices is None:
            indices = minibatch_indices(generator, total, M)
        fidx = indices.reshape(-1)
        na = flat.actions.shape[-1]
        packed = torch.cat([
            flat.actions, flat.mu, flat.sigma, flat.values[:, None], flat.log_probs[:, None],
            returns.reshape(-1, 1), advantages.reshape(-1, 1)], dim=1)
        g_small = packed[fidx]

        stats = []
        for _ in range(cfg.num_learning_epochs):
            for b in range(M):
                sm = g_small[b * B:(b + 1) * B]
                bidx = fidx[b * B:(b + 1) * B]
                mb = Transition(
                    obs=flat.obs[bidx], critic_obs=flat.critic_obs[bidx],
                    actions=sm[:, :na], mu=sm[:, na:2 * na], sigma=sm[:, 2 * na:3 * na],
                    values=sm[:, 3 * na], log_probs=sm[:, 3 * na + 1], rewards=None,
                    dones=None)
                ts, st = self._step(ts, mb, sm[:, 3 * na + 2], sm[:, 3 * na + 3])
                stats.append(st)
        m = torch.stack(stats).mean(dim=0)
        return ts, {"value_loss": m[0], "surrogate_loss": m[1], "estimator_loss": m[2],
                    "kl": m[3], "lr": m[4]}

    def _step(self, ts: TrainState, mb: Transition, mb_ret, mb_adv):
        cfg = self.cfg
        _, aux, grads = self.loss_and_grads(ts.params, mb, mb_ret, mb_adv)
        surrogate_loss, v_loss, est_loss, mu_new, sigma_new = aux

        names = list(ts.params)
        g = [grads[k] for k in names]
        # adaptive-KL learning rate (reference dh_ppo.py:139-151), measured
        # with the current params and applied to this step
        lr = ts.lr
        adaptive = cfg.desired_kl is not None and cfg.schedule == "adaptive"
        if adaptive:
            kl_mean = torch.mean(nets.gaussian_kl(mb.mu, mb.sigma, mu_new, sigma_new))
        else:
            kl_mean = torch.zeros((), device=lr.device)
        if self.group is not None:
            kl_mean = mean_grads_(self.group, g, kl_mean)
        if adaptive:
            lr = torch.where(kl_mean > cfg.desired_kl * 2.0,
                             torch.clamp_min(lr / 1.5, cfg.min_lr), lr)
            lr = torch.where((kl_mean < cfg.desired_kl / 2.0) & (kl_mean > 0.0),
                             torch.clamp_max(lr * 1.5, cfg.max_lr), lr)

        g = clip_by_global_norm(g, cfg.max_grad_norm)
        u, mu, nu, count = adam_direction(g, [ts.mu[k] for k in names],
                                          [ts.nu[k] for k in names], ts.count)
        torch._foreach_mul_(u, -lr)
        params = torch._foreach_add([ts.params[k] for k in names], u)
        ts = TrainState(params=dict(zip(names, params)), mu=dict(zip(names, mu)),
                        nu=dict(zip(names, nu)), count=count, lr=lr,
                        update_count=ts.update_count + 1)
        return ts, torch.stack([v_loss, surrogate_loss, est_loss, kl_mean, lr])
