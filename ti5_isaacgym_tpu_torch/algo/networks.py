"""Policy/value networks (port of ``ti5_isaacgym_tpu/algo/networks.py``).

``ActorCriticDH``: an actor on [short history (235) | estimated lin vel (3) |
CNN embedding (64)], a critic on the 219-dim privileged stack, a
state-estimator MLP (235 -> 3), and a Conv1d long-history encoder over the
66-frame stack (66 channels x 47 length -> k6s3 -> k4s2 -> flatten 96 ->
128 -> 64).  Parameter shapes follow ``torch.nn``; :mod:`.convert` maps the
flax layout onto them.

The long-history CNN is a float32 ``conv1d``, which cuDNN would run in TF32
by default; TF32 keeps about three decimal digits and breaks parity with the
reference, so importing this module turns TF32 off for convolutions and
matrix products (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


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


class ActorCriticDH(nn.Module):
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
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))

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

    def distribution(self, obs):
        mean = self.act_mean(obs)
        return mean, self.std.expand_as(mean)

    def evaluate(self, critic_obs):
        return self.critic(critic_obs.to(torch.float32))[..., 0]

