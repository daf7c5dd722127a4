"""Policy export for deployment (port of ``ti5_isaacgym_tpu/export/policy.py``).

* :func:`export_npz`: the flat numpy weight archive in flax's key names and
  layouts, and its manifest (``ti5-npz-v1``), the input of the native
  runtime (``native/ti5_infer.cc``) and of :func:`..algo.convert.load_npz`;
* :func:`export_controller_yaml`: the robot-side controller YAML, written by
  a small emitter whose bytes equal PyYAML's ``safe_dump(..., sort_keys=False)``
  of the same tree (the card's machine has no PyYAML);
* :func:`restore_policy_params`: the params of a runner checkpoint.

The JAX package also writes a StableHLO artifact (``export_stablehlo``); it
has no counterpart here, and nothing stands in for it.  The exported forward
contract: stacked 3102-dim obs in -> (12 action means, 3 estimated base
velocities) out.
"""
from __future__ import annotations

import json
import math
import os
import re

import numpy as np
import torch

from ..algo.convert import flat_from_params


def restore_policy_params(path: str):
    """(params, iteration) of a runner checkpoint (``OnPolicyRunner.save``):
    the params only, so a checkpoint of any env count will do.  Read with
    ``weights_only=True``, on the CPU."""
    d = torch.load(path, map_location="cpu", weights_only=True)
    params = d.get("ts", {}).get("params")
    if params is None:
        raise KeyError(f"checkpoint {path} has no ts/params (keys: {sorted(d)})")
    return params, int(d.get("iteration", -1))


def export_npz(network, params, out_dir: str, name: str = "policy_dh") -> str:
    """Weights (flat flax keys and layouts) and the manifest JSON."""
    os.makedirs(out_dir, exist_ok=True)
    flat = flat_from_params(params)
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez(path, **flat)
    manifest = {
        "format": "ti5-npz-v1",
        "network": type(network).__name__,
        "inputs": {"obs": [66 * 47]},
        "outputs": {"action_mean": [12], "est_lin_vel": [3]},
        "tensors": {k: list(v.shape) for k, v in flat.items()},
    }
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


# --- YAML: block mappings of scalars, spelled as PyYAML's safe_dump spells them

_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")
_RESERVED = {"yes", "no", "true", "false", "on", "off", "null"}   # resolved as non-strings


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float) and math.isfinite(v):
        s = repr(v).lower()
        # 1e-05 is no YAML float: PyYAML writes 1.0e-05
        return s.replace("e", ".0e", 1) if "." not in s and "e" in s else s
    if isinstance(v, str) and _PLAIN.match(v) and v.lower() not in _RESERVED:
        return v
    raise TypeError(f"the controller YAML emitter writes no {type(v).__name__} {v!r}")


def yaml_dump(tree: dict, indent: int = 0) -> str:
    """Nested non-empty dicts of bools, ints, finite floats and plain
    identifiers as YAML block mappings, in insertion order."""
    out = []
    for k, v in tree.items():
        key = " " * indent + _yaml_scalar(k)
        if isinstance(v, dict) and v:
            out.append(f"{key}:\n" + yaml_dump(v, indent + 2))
        else:
            out.append(f"{key}: {_yaml_scalar(v)}\n")
    return "".join(out)


def export_controller_yaml(env_cfg, out_dir: str, name: str = "policy_config",
                           dof_names=None) -> str:
    """Robot-side controller parameters in the reference controller's YAML
    schema: the ``LeggedRobotCfg`` tree with per-joint gain and angle dicts
    (``leg_{l,r}N_joint``), ``clip_scales``/``obs_scales``, ``size``, and the
    controller-side ``mode``/``filter`` sections, then ``extras``."""
    os.makedirs(out_dir, exist_ok=True)
    c = env_cfg
    if dof_names is None:
        dof_names = tuple(f"leg_{s}{i}_joint" for s in ("l", "r") for i in range(1, 7))

    def per_joint(vals):
        return {n: float(v) for n, v in zip(dof_names, vals)}

    os_ = c.normalization.obs_scales
    policy_rate = 1.0 / (c.sim.dt * c.control.decimation)
    data = {
        "LeggedRobotCfg": {
            "init_state": {
                "default_joint_angle": per_joint(c.init_state.default_joint_angles),
            },
            "control": {
                "stiffness": per_joint(c.control.stiffness),
                "damping": per_joint(c.control.damping),
                "action_scale": c.control.action_scale,
                "decimation": c.control.decimation,
                "cycle_time": c.rewards.cycle_time,
            },
            "normalization": {
                "clip_scales": {
                    "clip_observations": c.normalization.clip_observations,
                    "clip_actions": c.normalization.clip_actions,
                },
                "obs_scales": {
                    "lin_vel": os_.lin_vel, "ang_vel": os_.ang_vel,
                    "dof_pos": os_.dof_pos, "dof_vel": os_.dof_vel,
                    "quat": os_.quat,
                    "height_measurements": getattr(os_, "height_measurements", 5.0),
                },
            },
            "size": {
                "actions_size": c.env.num_actions,
                "observations_size": c.env.num_single_obs,
                "num_hist": c.env.frame_stack,
            },
            # controller-side run modes and filters; cmd_threshold and
            # sample_rate derive from the trained config
            "mode": {
                "sw_mode": bool(c.commands.sw_switch),
                "cmd_threshold": c.commands.stand_com_threshold,
                "ang_vel_threshold": 100000,
                "angle_threshold": 0.1,
            },
            "filter": {
                "filt_action": True,
                "sample_rate": int(round(policy_rate)),
                "cutoff_freq": 3.0,
            },
        },
        # deployment extras beyond the reference schema (additive keys only)
        "extras": {
            "short_frame_stack": c.env.short_frame_stack,
            "num_commands": c.env.num_commands,
            "sim_dt": c.sim.dt,
            "torque_limit": c.safety.torque_limit,
        },
    }
    path = os.path.join(out_dir, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(yaml_dump(data))
    return path
