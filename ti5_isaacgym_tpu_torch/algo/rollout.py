"""Rollout storage, GAE and minibatching (port of ``ti5_isaacgym_tpu/algo/rollout.py``).

Trajectories are ``[T, N, ...]`` tensors on the env's device, written step
by step into preallocated buffers by the runner.  Returns and advantages
come from a reverse recursion over T, and the minibatches are one random
permutation of the flattened ``T*N`` samples, reused across learning epochs
(the reference generator's semantics, ``rollout_storage.py:129-173``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Transition(NamedTuple):
    """Experience of all envs: ``[T, N, ...]`` in a trajectory, ``[B, ...]``
    in a minibatch."""

    obs: Optional[torch.Tensor]
    critic_obs: Optional[torch.Tensor]
    actions: Optional[torch.Tensor]
    rewards: Optional[torch.Tensor]
    dones: Optional[torch.Tensor]
    values: Optional[torch.Tensor]
    log_probs: Optional[torch.Tensor]
    mu: Optional[torch.Tensor]
    sigma: Optional[torch.Tensor]


def compute_gae(traj: Transition, last_values: torch.Tensor, gamma: float,
                lam: float, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE by the reverse recursion (reference ``compute_returns``,
    ``rollout_storage.py:97-119``).  Returns (returns, advantages normalised
    by their mean and their two-moment std ``sqrt(max(E[a^2] - E[a]^2, 0))``,
    as the JAX package computes it).  With a ``group``
    (:class:`~..parallel.trainer.ReduceGroup`) both moments are averaged
    over its ranks in one all-reduce (the JAX package's ``pmean``); the
    ranks hold equal numbers of samples, so these are the global moments."""
    rewards, dones, values = traj.rewards, traj.dones, traj.values
    advantages = torch.empty_like(values)
    next_adv, next_val = torch.zeros_like(last_values), last_values
    for t in reversed(range(values.shape[0])):
        not_done = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * next_val * not_done - values[t]
        next_adv = delta + gamma * lam * not_done * next_adv
        advantages[t] = next_adv
        next_val = values[t]
    returns = advantages + values
    mean = torch.mean(advantages)
    sq = torch.mean(torch.square(advantages))
    if group is not None:
        both = group.mean_(torch.stack([mean, sq]), "gae")
        mean, sq = both[0], both[1]
    std = torch.sqrt(torch.clamp_min(sq - torch.square(mean), 0.0))
    return returns, (advantages - mean) / (std + 1e-8)


def flatten_batch(traj: Transition) -> Transition:
    """[T, N, ...] -> [T*N, ...] for minibatch SGD."""
    return Transition(*(None if x is None else x.reshape((-1,) + tuple(x.shape[2:]))
                        for x in traj))


def minibatch_indices(generator: torch.Generator, total: int,
                      num_minibatches: int) -> torch.Tensor:
    """One permutation split into minibatches ([M, B]); the same split is
    reused across epochs, as the reference generator does."""
    batch = total // num_minibatches
    perm = torch.randperm(total, generator=generator, device=generator.device)
    return perm[: batch * num_minibatches].reshape(num_minibatches, batch)
