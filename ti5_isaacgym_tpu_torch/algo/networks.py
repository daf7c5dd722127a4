"""Policy/value networks (port of ``ti5_isaacgym_tpu/algo/networks.py``).

``ActorCritic``: an MLP actor on the full observation and an MLP critic on
the privileged one, with a learned per-action std.

``ActorCriticDH``: an actor on [short history (235) | estimated lin vel (3) |
CNN embedding (64)], a critic on the 219-dim privileged stack, a
state-estimator MLP (235 -> 3), and a Conv1d long-history encoder over the
66-frame stack (66 channels x 47 length -> k6s3 -> k4s2 -> flatten 96 ->
128 -> 64).  Parameter shapes follow ``torch.nn``; :mod:`.convert` maps the
flax layout onto them.

Both networks are also called functionally, as flax modules are: ``apply(net,
params, "loss_forward", obs, critic_obs)`` runs a method with the parameters
of a ``{name: tensor}`` dict (the learner's train state) in place of the
module's own.  :func:`init_like_flax_` draws the parameters as flax's
defaults do.

The long-history CNN is a float32 ``conv1d``, which cuDNN would run in TF32
by default; TF32 keeps about three decimal digits and breaks parity with the
reference, so importing this module turns TF32 off for convolutions and
matrix products (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``).  The training runner, which
owns the bit-exact resume, also asks cuDNN for deterministic algorithms.

The feature-major loss forward of the JAX package (``loss_forward_T``,
``_mlp_T``, ``_cnn_T``) is a TPU layout variant that the reference keeps as
measured and rejected; it is not on the training path and is not ported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# 0.5 * log(2 pi) in float32, as the reference computes it
_HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2.0 * np.pi)))
# std of a standard normal truncated to (-2, 2) (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


class MLP(nn.Module):
    """Dense layers with ELU between them (flax ``MLP``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int):
        super().__init__()
        dims = [in_dim] + list(hidden) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.elu(x)
        return x


class LongHistoryCNN(nn.Module):
    """Conv1d encoder over the 66-frame proprioceptive history."""

    def __init__(self, filters=(32, 16), kernels=(6, 4), strides=(3, 2), out_dim: int = 64,
                 frame_stack: int = 66, frame_dim: int = 47):
        super().__init__()
        self.frame_stack, self.frame_dim = frame_stack, frame_dim
        chans = [frame_stack] + list(filters)
        self.convs = nn.ModuleList(nn.Conv1d(a, b, k, stride=s) for a, b, k, s in
                                   zip(chans[:-1], chans[1:], kernels, strides))
        length = frame_dim
        for k, s in zip(kernels, strides):
            length = (length - k) // s + 1
        self.fc = MLP(length * filters[-1], (128,), out_dim)

    def forward(self, obs_flat):
        # [N, 66*47] -> frames as channels, per-frame features as length
        x = obs_flat.reshape(obs_flat.shape[:-1] + (self.frame_stack, self.frame_dim))
        for conv in self.convs:
            x = F.relu(conv(x))
        # flatten position-major ([N, L, C] -> [N, L*C]) as the flax model does
        x = torch.flatten(x.transpose(-1, -2), start_dim=-2)
        return self.fc(x)


class _Policy(nn.Module):
    """What both actor-critics share: the Gaussian head and the dispatch of
    :func:`apply`."""

    def forward(self, *inputs, method: str = "act_mean"):
        return getattr(self, method)(*inputs)

    def distribution(self, obs):
        mean = self.act_mean(obs)
        return mean, self.std.expand_as(mean)

    def evaluate(self, critic_obs):
        return self.critic(critic_obs.to(torch.float32))[..., 0]


class ActorCritic(_Policy):
    """Vanilla MLP actor-critic."""

    def __init__(self, num_actions: int = 12, num_obs: int = 3102, num_critic_obs: int = 219,
                 actor_hidden=(512, 256, 128), critic_hidden=(768, 256, 128),
                 init_noise_std: float = 1.0):
        super().__init__()
        self.actor = MLP(num_obs, actor_hidden, num_actions)
        self.critic = MLP(num_critic_obs, critic_hidden, 1)
        self.init_noise_std = float(init_noise_std)
        self.std = nn.Parameter(torch.full((num_actions,), self.init_noise_std))

    def act_mean(self, obs):
        return self.actor(obs.to(torch.float32))

    def loss_forward(self, obs, critic_obs):
        """One forward for the PPO loss: (mean, std, value, est_vel), the
        last zero (no estimator)."""
        mean, std = self.distribution(obs)
        return mean, std, self.evaluate(critic_obs), mean.new_zeros(mean.shape[:-1] + (3,))


class ActorCriticDH(_Policy):
    """DH asymmetric actor-critic."""

    def __init__(self, num_actions: int = 12, num_short_obs: int = 235,
                 num_single_obs: int = 47, frame_stack: int = 66, num_critic_obs: int = 219,
                 actor_hidden=(512, 256, 128), critic_hidden=(768, 256, 128),
                 estimator_hidden=(256, 128, 64), filters=(32, 16), kernels=(6, 4),
                 strides=(3, 2), lh_output_dim: int = 64, init_noise_std: float = 1.0):
        super().__init__()
        self.num_short_obs = num_short_obs
        self.actor = MLP(num_short_obs + 3 + lh_output_dim, actor_hidden, num_actions)
        self.critic = MLP(num_critic_obs, critic_hidden, 1)
        self.state_estimator = MLP(num_short_obs, estimator_hidden, 3)
        self.long_history = LongHistoryCNN(filters, kernels, strides, lh_output_dim,
                                           frame_stack, num_single_obs)
        self.init_noise_std = float(init_noise_std)
        self.std = nn.Parameter(torch.full((num_actions,), self.init_noise_std))

    def _actor_input(self, obs):
        obs = obs.to(torch.float32)
        short = obs[..., -self.num_short_obs:]
        est_vel = self.state_estimator(short)
        emb = self.long_history(obs)
        return torch.cat([short, est_vel, emb], dim=-1), est_vel

    def act_inference(self, obs):
        """Deployment forward: (action mean, estimated lin vel)."""
        a_in, est = self._actor_input(obs)
        return self.actor(a_in), est

    def act_mean(self, obs):
        return self.act_inference(obs)[0]

    def estimate_velocity(self, obs):
        return self.state_estimator(obs[..., -self.num_short_obs:].to(torch.float32))

    def loss_forward(self, obs, critic_obs):
        """One forward for the PPO loss: (mean, std, value, est_vel).  The
        estimator runs once and feeds both the actor input and the
        supervised MSE term."""
        a_in, est = self._actor_input(obs)
        mean = self.actor(a_in)
        return mean, self.std.expand_as(mean), self.evaluate(critic_obs), est


def apply(net: nn.Module, params: Dict[str, torch.Tensor], method: str, *inputs):
    """``net.<method>(*inputs)`` computed with ``params`` ({name: tensor},
    the names of ``net.named_parameters()``) in place of the module's own."""
    return torch.func.functional_call(net, params, inputs, {"method": method}, strict=True)


def init_like_flax_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``net``'s parameters as flax's defaults do, in place: every Dense
    and Conv weight lecun-normal (a normal truncated at +-2 sigma, sigma
    divided by the truncated normal's std so that the variance is 1/fan_in;
    a conv kernel's fan_in is kernel size x input channels), every bias zero,
    an actor-critic's ``std`` at its ``init_noise_std``.  The draws are made
    on the CPU from ``generator`` in the order of ``net.modules()``, so a seed
    gives the same weights on every device."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                w = mod.weight
                fan_in = w[0].numel()
                draw = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
                w.copy_(draw * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
                mod.bias.zero_()
        if isinstance(net, _Policy):
            net.std.fill_(net.init_noise_std)
    return net


# --- Gaussian head utilities (shared by PPO variants) ---


def sample_action(mean, std, generator: Optional[torch.Generator] = None, noise=None):
    """``mean + std * noise``; the standard normal ``noise`` is drawn from
    ``generator`` unless it is given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return mean + std * noise


def log_prob(mean, std, action):
    z = (action - mean) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - _HALF_LOG_2PI, dim=-1)


def entropy(std):
    return torch.sum(0.5 + _HALF_LOG_2PI + torch.log(std), dim=-1)


def gaussian_kl(mu_old, sigma_old, mu_new, sigma_new):
    """The reference's KL formula (``dh_ppo.py:141-143``), per sample."""
    return torch.sum(
        torch.log(sigma_new / sigma_old + 1e-5)
        + (torch.square(sigma_old) + torch.square(mu_old - mu_new))
        / (2.0 * torch.square(sigma_new))
        - 0.5,
        dim=-1,
    )
