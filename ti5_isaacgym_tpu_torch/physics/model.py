"""Robot model description (port of ``ti5_isaacgym_tpu/physics/model.py``).

A :class:`RobotModel` holds the fixed-topology kinematic tree of one robot:
a floating base (body 0) plus single-DoF revolute joints.  It is read from
the JSON model spec in ``resources/`` (this package keeps its own copy).
Arrays are host numpy float32; :meth:`RobotModel.tensors` gives device
copies for the batched code.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch


@dataclass(frozen=True)
class RobotModel:
    """Static robot description; body 0 is the floating base and joint
    ``i >= 1`` (dof ``i - 1``) connects ``parent[i]`` to body ``i``."""

    parent: np.ndarray        # (nb,) int, parent[0] = -1
    joint_pos: np.ndarray     # (nb, 3) joint origin in parent frame
    joint_rot: np.ndarray     # (nb, 3, 3) joint frame rotation in parent frame
    joint_axis: np.ndarray    # (nb, 3) revolute axis in child frame
    mass: np.ndarray          # (nb,)
    com: np.ndarray           # (nb, 3)
    inertia: np.ndarray       # (nb, 3, 3) about CoM
    dof_lower: np.ndarray     # (nd,)
    dof_upper: np.ndarray
    dof_effort: np.ndarray
    dof_velocity: np.ndarray
    cp_body: np.ndarray       # (ncp,) int body of each collision point
    cp_pos: np.ndarray        # (ncp, 3) point in body frame
    nb: int
    num_dof: int
    body_names: tuple
    dof_names: tuple
    base_body: int
    feet_bodies: tuple
    knee_bodies: tuple
    termination_bodies: tuple
    penalized_bodies: tuple

    @property
    def ncp(self) -> int:
        return int(self.cp_pos.shape[0])

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """Float32 device copies of the array fields."""
        names = ("joint_pos", "joint_rot", "joint_axis", "mass", "com", "inertia",
                 "dof_lower", "dof_upper", "dof_effort", "dof_velocity", "cp_pos")
        return {n: torch.as_tensor(getattr(self, n), device=device) for n in names}


def from_spec(spec: Dict[str, Any]) -> RobotModel:
    bodies: List[Dict[str, Any]] = spec["bodies"]
    nb = len(bodies)
    parent = np.array([b["parent"] for b in bodies], dtype=np.int64)
    joint_pos = np.zeros((nb, 3), np.float32)
    joint_rot = np.tile(np.eye(3, dtype=np.float32), (nb, 1, 1))
    joint_axis = np.zeros((nb, 3), np.float32)
    mass = np.zeros((nb,), np.float32)
    com = np.zeros((nb, 3), np.float32)
    inertia = np.zeros((nb, 3, 3), np.float32)
    dof_lower, dof_upper, dof_effort, dof_velocity, dof_names = [], [], [], [], []
    body_names = []
    for i, b in enumerate(bodies):
        body_names.append(b["name"])
        mass[i] = b["mass"]
        com[i] = b["com"]
        inertia[i] = b["inertia"]
        j = b.get("joint")
        if j is not None:
            joint_pos[i] = j["origin_pos"]
            joint_rot[i] = j["origin_rot"]
            joint_axis[i] = j["axis"]
            dof_lower.append(j["lower"])
            dof_upper.append(j["upper"])
            dof_effort.append(j["effort"])
            dof_velocity.append(j["velocity"])
            dof_names.append(j["name"])
    cps = spec.get("collision_points", [])
    cp_body = np.array([c["body"] for c in cps], dtype=np.int64)
    cp_pos = np.array([c["pos"] for c in cps], dtype=np.float32).reshape(-1, 3)

    def _idx_of(names, match):
        return tuple(i for i, n in enumerate(names) if match in n)

    f32 = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    return RobotModel(
        parent=parent, joint_pos=joint_pos, joint_rot=joint_rot,
        joint_axis=joint_axis, mass=mass, com=com, inertia=inertia,
        dof_lower=f32(dof_lower), dof_upper=f32(dof_upper),
        dof_effort=f32(dof_effort), dof_velocity=f32(dof_velocity),
        cp_body=cp_body, cp_pos=cp_pos, nb=nb, num_dof=nb - 1,
        body_names=tuple(body_names), dof_names=tuple(dof_names),
        base_body=int(spec.get("base_body", 0)),
        feet_bodies=tuple(spec.get("feet_bodies", _idx_of(body_names, "6_link"))),
        knee_bodies=tuple(spec.get("knee_bodies", _idx_of(body_names, "4_link"))),
        termination_bodies=tuple(spec.get("termination_bodies", (0,))),
        penalized_bodies=tuple(spec.get("penalized_bodies", (0,))),
    )


def load(path: str) -> RobotModel:
    with open(path) as f:
        return from_spec(json.load(f))


RESOURCES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "resources")


def load_t1() -> RobotModel:
    """The T1 humanoid shipped with this package (13 bodies, 12 dof,
    32 collision points)."""
    return load(os.path.join(RESOURCES, "t1_model.json"))
