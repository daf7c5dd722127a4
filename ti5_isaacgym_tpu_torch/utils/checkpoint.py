"""Slim checkpoints, the graft that resumes from them, the exploration-std
reheat, and JAX checkpoints carried across (port of ``tools/slim_checkpoint.py``,
``tools/resume_migrate.py::graft`` and ``tools/reheat_std.py``).

A full checkpoint (:meth:`~..algo.runner.OnPolicyRunner.save`) holds the
whole carry: ~100 MB at 4096 envs, mostly observation histories and lag
rings.  Its slim form (:func:`slim`) keeps what a later run needs to go on
learning: the train state (params, Adam moments and count, the adaptive-KL
learning rate), the iteration, the run's generator and the five curriculum
fields of :data:`KEEP_ENV_FIELDS` (terrain levels, types and origins, the
widened command range, and the common step counter that drives the push and
external-force escalation schedules).  :func:`graft` puts it back onto a
fresh carry; everything else starts fresh, at the cost of restarting the
current episodes.

Slim payloads are what ``checkpoints_torch/<task>/<run>/model_<it>.pt``
holds (``scripts/sync_checkpoint.py``); ``train --resume`` refuses them
(:func:`refuse_slim`), ``scripts/resume_migrate.py`` grafts them and
restarts the episodes on the restored terrain tiles
(:func:`restart_episodes`).
"""
from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch

KEEP_ENV_FIELDS = ("terrain_level", "terrain_type", "env_origin", "cmd_vx_range", "common_step")


def is_slim(payload: Dict[str, Any]) -> bool:
    """True for a :func:`slim` payload: an env state of curriculum fields
    only.  A full checkpoint has the whole env state, a learning-state
    checkpoint of data parallelism none."""
    env = payload.get("env_state")
    return env is not None and set(env) <= set(KEEP_ENV_FIELDS)


def refuse_slim(payload: Dict[str, Any], path: str):
    """Raise if ``payload`` (read from ``path``) is slim: a full-carry
    restore cannot take it."""
    if is_slim(payload):
        raise ValueError(
            f"{path} is a slim checkpoint (learning state and curriculum only): a full-carry "
            "resume cannot load it; graft it onto a fresh carry with "
            "python -m ti5_isaacgym_tpu_torch.scripts.resume_migrate --ckpt " + path)


def slim(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A full :meth:`~..algo.runner.OnPolicyRunner.save` payload -> its slim
    form: ``ts``, ``iteration``, the run's generator state (``rng``, when
    the payload has one) and the fields of :data:`KEEP_ENV_FIELDS` that its
    env state has."""
    env = payload.get("env_state") or {}
    out = {"ts": payload["ts"], "iteration": payload["iteration"],
           "env_state": {k: env[k] for k in KEEP_ENV_FIELDS if k in env}}
    if "rng" in payload:
        out["rng"] = payload["rng"]
    return out


def _overlay(fresh, saved, path: str):
    """``fresh`` with every leaf that ``saved`` holds put in its place;
    leaves ``saved`` lacks keep their fresh values.  A tensor's shape must
    match (it is cast to the fresh dtype and device); a generator takes the
    saved state."""
    if dataclasses.is_dataclass(fresh):
        return dataclasses.replace(fresh, **{
            f.name: _overlay(getattr(fresh, f.name), saved[f.name], f"{path}/{f.name}")
            for f in dataclasses.fields(fresh) if f.name in saved})
    if isinstance(fresh, dict):
        return {k: _overlay(v, saved[k], f"{path}/{k}") if k in saved else v
                for k, v in fresh.items()}
    if isinstance(fresh, torch.Generator):
        gen = torch.Generator(device=fresh.device)
        gen.set_state(saved)
        return gen
    saved = torch.as_tensor(saved)
    if tuple(saved.shape) != tuple(fresh.shape):
        raise ValueError(f"graft: {path.lstrip('/')} is {tuple(saved.shape)} in the checkpoint "
                         f"but {tuple(fresh.shape)} in the fresh carry (another --num_envs or "
                         "network?)")
    return saved.to(device=fresh.device, dtype=fresh.dtype)


def graft(carry, saved: Dict[str, Any]):
    """A fresh :class:`~..algo.runner.RunnerCarry` (``init_carry()``) with
    every field of ``saved`` (a slim or full payload, or a part of one)
    overlaid: ``ts``, the env state's fields, the run's generator
    (``rng``) and the episode sums.  The observations are the grafted env
    state's histories.  A field whose shape differs from the fresh one
    raises, naming the field and both shapes (JAX's graft takes a saved
    array of any shape).  A payload carried across from JAX
    (:func:`from_jax_slim`) has no generator state: the run's generator
    keeps the fresh one, seeded from the runner's seed."""
    env_state = _overlay(carry.env_state, saved.get("env_state", {}), "env_state")
    return carry._replace(
        ts=_overlay(carry.ts, saved["ts"], "ts") if "ts" in saved else carry.ts,
        env_state=env_state, obs=env_state.obs_hist, priv_obs=env_state.critic_hist,
        rng=_overlay(carry.rng, saved["rng"], "rng") if "rng" in saved else carry.rng,
        **{k: _overlay(getattr(carry, k), saved[k], k)
           for k in ("cur_reward_sum", "cur_ep_len") if k in saved})


def restart_episodes(env, carry):
    """Restart every episode of a carry that a slim payload was grafted onto
    (:func:`graft`) at the curriculum fields the payload restored.

    The fresh carry's reset put each robot on the fresh carry's terrain tile
    and drew its commands from the fresh command range; the graft restores
    the payload's levels, types, origins and range but leaves the robots
    where they stand.  The first terrain update would then measure each
    walk from another tile's origin, and most envs would move up a level at
    once, as they do after JAX's ``tools/resume_migrate.py`` (without this
    reset, the 71k lineage grafted at 4096 envs read a mean level of 5.875
    over its iterations 141-240 against the file's 5.155, on an NVIDIA
    H100).  This reset (all envs, no curriculum step) places the robots at
    the restored origins with commands from the restored range; the common
    step stays the payload's, since the reset's zero-action step is no step
    of the run."""
    state, obs, priv = env.reset(carry.env_state)
    state = state.replace(common_step=carry.env_state.common_step)
    return carry._replace(env_state=state, obs=obs, priv_obs=priv)


def reheat_std(payload: Dict[str, Any], std: float) -> Dict[str, Any]:
    """``payload`` with the policy's exploration std set to ``std`` and that
    leaf's Adam moments zeroed, so that the optimizer does not pull it
    straight back down (the round-3 escape from the two-foot shuffle).
    Every other leaf is the payload's own; the payload is not modified."""
    ts = dict(payload["ts"])
    for key, value in (("params", lambda v: torch.full_like(v, std)),
                       ("mu", torch.zeros_like), ("nu", torch.zeros_like)):
        tree = dict(ts[key])
        tree["std"] = value(tree["std"])
        ts[key] = tree
    return dict(payload, ts=ts)


def from_jax_slim(raw: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX slim checkpoint, as the nested numpy dict that orbax's
    ``PyTreeCheckpointer().restore(path, restore_args=<RestoreArgs(
    restore_type=np.ndarray) per leaf>)`` returns, -> the port's slim
    payload.  The train state goes through
    :func:`~..algo.convert.train_state_from_jax` (params, Adam ``mu``,
    ``nu`` and count, lr; the update count, which JAX does not save, is 0
    as in JAX's own graft), the curriculum fields are copied.  JAX's
    threefry key has no Philox counterpart: the payload carries no
    generator state, so :func:`graft` seeds the run from the runner's
    seed.  Reads nothing itself: the caller restores the orbax
    checkpoint."""
    from ..algo.convert import train_state_from_jax
    from ..algo.runner import to_tensor_dict

    adam = next(s for s in raw["opt_state"] if isinstance(s, dict) and {"mu", "nu"} <= set(s))
    ts = train_state_from_jax(raw["params"], [SimpleNamespace(**adam)], raw["lr"],
                              update_count=0)
    env = raw.get("env_state") or {}
    return {"ts": to_tensor_dict(ts), "iteration": int(np.asarray(raw["iteration"])),
            "env_state": {k: torch.from_numpy(np.array(env[k])) for k in KEEP_ENV_FIELDS
                          if k in env}}


def load(path: str) -> Dict[str, Any]:
    """A checkpoint payload, read on the CPU with ``weights_only=True``."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save(payload: Dict[str, Any], path: str) -> str:
    """Write ``payload`` to ``path`` through a temporary file (a reader
    never sees half a checkpoint)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path
