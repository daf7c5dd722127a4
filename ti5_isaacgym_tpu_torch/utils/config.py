"""Config helpers (port of ``ti5_isaacgym_tpu/utils/config.py``): plain
nested dataclasses with dict and CLI overlays.

Configs are static values; anything an env randomizes per environment lives
in the env state, not here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


def to_dict(cfg: Any) -> Any:
    """Recursively convert a (nested) dataclass to plain dicts/lists."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def update_from_dict(cfg: Any, d: Dict[str, Any]) -> Any:
    """Return a copy of dataclass ``cfg`` with (nested) overrides from ``d``."""
    if not dataclasses.is_dataclass(cfg):
        return d
    kw = {}
    for f in dataclasses.fields(cfg):
        if f.name in d:
            v = getattr(cfg, f.name)
            if dataclasses.is_dataclass(v) and isinstance(d[f.name], dict):
                kw[f.name] = update_from_dict(v, d[f.name])
            else:
                kw[f.name] = d[f.name]
    return dataclasses.replace(cfg, **kw)


def update_cfg_from_args(env_cfg, train_cfg, args) -> tuple:
    """The CLI overlay with the reference's knobs: num_envs, reward-scale and
    reference-action overrides on the env config; seed, max_iterations,
    resume, experiment/run names, load_run and checkpoint on the train
    config."""
    if env_cfg is not None and args is not None:
        if getattr(args, "num_envs", None) is not None:
            env_cfg = dataclasses.replace(
                env_cfg, env=dataclasses.replace(env_cfg.env, num_envs=args.num_envs))
        if getattr(args, "reward_scales", None):
            over = {}
            for kv in args.reward_scales.split(","):
                k, v = kv.split("=")
                over[k.strip()] = float(v)
            names = {n for n, _ in env_cfg.rewards.scales}
            unknown = set(over) - names
            if unknown:
                raise ValueError(f"unknown reward terms: {sorted(unknown)}")
            new_scales = tuple((n, over.get(n, s)) for n, s in env_cfg.rewards.scales)
            env_cfg = dataclasses.replace(
                env_cfg, rewards=dataclasses.replace(env_cfg.rewards, scales=new_scales))
        if getattr(args, "use_ref_actions", None) is not None:
            env_cfg = dataclasses.replace(
                env_cfg, env=dataclasses.replace(
                    env_cfg.env, use_ref_actions=bool(args.use_ref_actions)))
    if train_cfg is not None and args is not None:
        if getattr(args, "seed", None) is not None:
            train_cfg = dataclasses.replace(train_cfg, seed=args.seed)
        runner_updates = {}
        for name in ("max_iterations", "resume", "experiment_name", "run_name",
                     "load_run", "checkpoint"):
            v = getattr(args, name, None)
            if v is not None:
                runner_updates[name] = v
        if runner_updates:
            train_cfg = dataclasses.replace(
                train_cfg, runner=dataclasses.replace(train_cfg.runner, **runner_updates))
    return env_cfg, train_cfg
