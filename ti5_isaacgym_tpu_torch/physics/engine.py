"""Physics state, solver options and the contact-mass probe.

Port of the parts of ``ti5_isaacgym_tpu/physics/engine.py`` that the rollout
uses.  The batched substep itself lives in :mod:`.engine_core`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from . import dynamics as dyn
from . import spatial as sp
from .model import RobotModel


@dataclass
class PhysicsState:
    """Generalized state of a batch of robots (leading dims [N])."""

    base_pos: torch.Tensor   # (N, 3)
    base_quat: torch.Tensor  # (N, 4) wxyz
    base_vel: torch.Tensor   # (N, 6) spatial [w, v] in base frame
    qpos: torch.Tensor       # (N, nd)
    qvel: torch.Tensor       # (N, nd)
    cp_anchor: torch.Tensor  # (N, ncp, 3) friction anchors (world)

    def replace(self, **kw) -> "PhysicsState":
        return replace(self, **kw)


@dataclass(frozen=True)
class SolverOpts:
    dt: float = 0.001
    gravity: float = -9.81
    limit_kp: float = 500.0
    limit_kd: float = 10.0
    max_qvel: float = 50.0


def root_world_vel(state: PhysicsState) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-frame (linvel, angvel) of the base."""
    v = sp.quat_rotate(state.base_quat, state.base_vel[..., 3:])
    w = sp.quat_rotate(state.base_quat, state.base_vel[..., :3])
    return v, w


def set_root_world_vel(state: PhysicsState, linvel_w, angvel_w) -> PhysicsState:
    """Inverse of :func:`root_world_vel` (the push event sets velocities)."""
    v = sp.quat_rotate_inverse(state.base_quat, linvel_w)
    w = sp.quat_rotate_inverse(state.base_quat, angvel_w)
    return state.replace(base_vel=torch.cat([w, v], dim=-1))


def probe_contact_masses(model: RobotModel, params: dyn.DynamicsParams,
                         state: PhysicsState,
                         directions=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
                         ) -> np.ndarray:
    """Apparent (articulated) mass of each collision point, (ncp, 2).

    For each point and probe direction, applies a unit test force, runs the
    articulated-body dynamics and measures the point's acceleration; the
    apparent mass is its reciprocal.  Column 0 is the mass along the last
    direction (the contact normal, +z), column 1 the minimum over the other
    (tangential) ones.  ``state`` and ``params`` describe ONE env (no batch
    dims); all probes run as one batch.  Called once at env construction.
    """
    dev = state.base_pos.device
    ncp, nb = model.ncp, model.nb
    dirs = torch.tensor(directions, dtype=torch.float32, device=dev)   # (ndir, 3)
    ndir = dirs.shape[0]
    cp_body = torch.as_tensor(model.cp_body, device=dev)
    cp_pos = torch.as_tensor(model.cp_pos, device=dev)
    zero_tau = torch.zeros(model.num_dof, device=dev)

    frames = dyn.fk(model, state.base_pos, state.base_quat, state.base_vel,
                    state.qpos, state.qvel)
    p_w, pv0 = dyn.point_world(frames, cp_body, cp_pos)
    arm = p_w - frames.pos[cp_body]                                   # (ncp, 3)
    a0_0, qdd_0 = dyn.aba(model, params, frames, state.qvel, zero_tau,
                          None, gravity=0.0)

    # one batch entry per (point, direction): f_ext [ncp, ndir, nb, 6]
    torque = sp.cross(arm[:, None, :], dirs[None, :, :])              # (ncp, ndir, 3)
    wrench = torch.cat([torque, dirs[None].expand(ncp, ndir, 3)], dim=-1)
    onehot = (cp_body[:, None] == torch.arange(nb, device=dev)[None]).float()
    f_ext = onehot[:, None, :, None] * wrench[:, :, None, :]
    a0_f, qdd_f = dyn.aba(model, params, frames, state.qvel, zero_tau, f_ext,
                          gravity=0.0)
    fr2 = dyn.fk(model, state.base_pos, state.base_quat,
                 state.base_vel + (a0_f - a0_0), state.qpos,
                 state.qvel + (qdd_f - qdd_0))
    pv2 = dyn.point_world(fr2, cp_body, cp_pos)[1]                    # (ncp, ndir, ncp, 3)
    idx = torch.arange(ncp, device=dev)
    pv2 = pv2[idx, :, idx, :]                                         # (ncp, ndir, 3)
    inv_m = torch.sum((pv2 - pv0[:, None, :]) * dirs[None], dim=-1)
    inv_m = torch.clamp_min(inv_m, 1e-6)
    m_all = 1.0 / inv_m
    m = torch.stack([m_all[:, ndir - 1], torch.min(m_all[:, :ndir - 1], dim=1).values], -1)
    # points sharing a body also share its apparent mass
    counts = torch.bincount(cp_body, minlength=nb)
    return (m / counts[cp_body].to(m.dtype)[:, None]).cpu().numpy()
