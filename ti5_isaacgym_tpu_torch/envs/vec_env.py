"""Stateful VecEnv facade (port of ``ti5_isaacgym_tpu/envs/vec_env.py``).

Carries the env state and exposes the reference's 5-tuple contract:
``step(actions) -> (obs, privileged_obs, rewards, resets, extras)``.
"""
from __future__ import annotations

import torch


class VecEnv:
    def __init__(self, env, seed: int = 0):
        self.env = env
        self.num_envs = env.num_envs
        self.num_obs = env.cfg.env.num_observations
        self.num_privileged_obs = env.cfg.env.num_privileged_obs
        self.num_actions = env.cfg.env.num_actions
        self.max_episode_length = env.max_episode_length
        self.state = env.init_state(seed)
        self._obs = None
        self._priv = None
        self.extras = {}

    def reset(self):
        self.state, self._obs, self._priv = self.env.reset(self.state)
        return self._obs, self._priv

    def step(self, actions: torch.Tensor):
        self.state, self._obs, self._priv, rew, reset, extras = self.env.step(self.state, actions)
        self.extras = extras
        return self._obs, self._priv, rew, reset, extras

    def get_observations(self):
        return self._obs

    def get_privileged_observations(self):
        return self._priv
