"""Physics state, solver options, the per-point substep and the contact-mass
probe (port of ``ti5_isaacgym_tpu/physics/engine.py``).

:func:`substep` is the engine's reference form, on batched ``[N, ...]``
tensors: FK -> per-point heightfield contact (:mod:`.contact`) -> joint
limits -> ABA -> semi-implicit Euler.  The rollout runs the component form
against frozen cells instead (:mod:`.engine_core`, and the CUDA kernel).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from . import contact as ct
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


def init_state(model: RobotModel, base_pos, base_quat, qpos, base_vel=None,
               qvel=None, device="cpu") -> PhysicsState:
    """A state from poses with leading batch dims ``[N]`` (or none); the
    velocities default to zero and the friction anchors start at zero."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    base_pos, base_quat, qpos = f32(base_pos), f32(base_quat), f32(qpos)
    batch = qpos.shape[:-1]
    return PhysicsState(
        base_pos=base_pos, base_quat=base_quat,
        base_vel=torch.zeros(batch + (6,), device=device) if base_vel is None else f32(base_vel),
        qpos=qpos,
        qvel=torch.zeros_like(qpos) if qvel is None else f32(qvel),
        cp_anchor=torch.zeros(batch + (model.ncp, 3), device=device))


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


def _limit_torque(model: RobotModel, opts: SolverOpts, qpos, qvel):
    """Joint-limit penalty torque: a stiff spring past each limit, damped
    while in violation."""
    lower = torch.as_tensor(model.dof_lower, dtype=qpos.dtype, device=qpos.device)
    upper = torch.as_tensor(model.dof_upper, dtype=qpos.dtype, device=qpos.device)
    over = torch.clamp_min(qpos - upper, 0.0)
    under = torch.clamp_min(lower - qpos, 0.0)
    tau = -opts.limit_kp * over + opts.limit_kp * under
    in_violation = (over > 0) | (under > 0)
    return tau - torch.where(in_violation, opts.limit_kd * qvel, 0.0)


def substep(model: RobotModel, params: dyn.DynamicsParams, terrain: ct.HeightField,
            copts: ct.ContactOpts, sopts: SolverOpts, state: PhysicsState,
            tau: torch.Tensor, friction: torch.Tensor, cp_meff=None,
            base_force_w: Optional[torch.Tensor] = None,
            base_torque_w: Optional[torch.Tensor] = None,
            restitution: Optional[torch.Tensor] = None,
            ) -> Tuple[PhysicsState, torch.Tensor]:
    """Advance a batch of envs by one physics substep.

    tau: (N, nd) actuation torques; friction and restitution: (N,) per env;
    cp_meff: (ncp, 2) apparent normal/tangential mass per contact point
    (:func:`probe_contact_masses`; by default the body's mass);
    base_force_w / base_torque_w: optional (N, 3) external wrench on the base
    in world coordinates.  Returns the next state and the per-body net
    contact force (N, nb, 3) in world coordinates.
    """
    dev, nb = state.qpos.device, model.nb
    t = model.tensors(dev)
    cp_body, cp_pos = torch.as_tensor(model.cp_body, device=dev), t["cp_pos"]
    frames = dyn.fk(model, state.base_pos, state.base_quat, state.base_vel,
                    state.qpos, state.qvel)
    if cp_meff is None:
        cp_meff = torch.stack([t["mass"][cp_body]] * 2, dim=-1)
    p_w, v_w = dyn.point_world(frames, cp_body, cp_pos)
    f_pts, _, new_anchor = ct.point_contact_forces(
        terrain, copts, p_w, v_w, state.cp_anchor, friction[..., None], cp_meff,
        restitution=None if restitution is None else restitution[..., None])
    arm = p_w - frames.pos[..., cp_body, :]
    tq_pts = sp.cross(arm, f_pts)
    # per-body sums in point order (no atomics: the sums are deterministic)
    zero = torch.zeros_like(f_pts[..., 0, :])
    body_f, body_tq = [], []
    for b in range(nb):
        idx = [k for k, cb in enumerate(model.cp_body) if cb == b]
        body_f.append(f_pts[..., idx, :].sum(-2) if idx else zero)
        body_tq.append(tq_pts[..., idx, :].sum(-2) if idx else zero)
    body_f = torch.stack(body_f, dim=-2)
    f_ext = torch.cat([torch.stack(body_tq, dim=-2), body_f], dim=-1)   # (N, nb, 6) world
    if base_force_w is not None:
        wrench = torch.cat([base_torque_w, base_force_w], dim=-1)
        f_ext = torch.cat([f_ext[..., :1, :] + wrench[..., None, :], f_ext[..., 1:, :]], dim=-2)

    # actuator torques never exceed the effort limits
    effort = t["dof_effort"]
    tau = torch.clamp(tau, -effort, effort)
    tau_total = tau + _limit_torque(model, sopts, state.qpos, state.qvel)
    a0, qdd = dyn.aba(model, params, frames, state.qvel, tau_total, f_ext,
                      gravity=sopts.gravity)
    bp, bq, bv, qp, qv = dyn.integrate(state.base_pos, state.base_quat, state.base_vel,
                                       state.qpos, state.qvel, a0, qdd, sopts.dt)
    qv = torch.clamp(qv, -sopts.max_qvel, sopts.max_qvel)
    bv = torch.clamp(bv, -sopts.max_qvel, sopts.max_qvel)
    # hard joint stops: project onto the limits, kill limit-ward velocity
    lower, upper = t["dof_lower"], t["dof_upper"]
    hit_up, hit_lo = qp > upper, qp < lower
    qv = torch.where(hit_up, torch.clamp_max(qv, 0.0),
                     torch.where(hit_lo, torch.clamp_min(qv, 0.0), qv))
    qp = torch.minimum(torch.maximum(qp, lower), upper)
    return PhysicsState(base_pos=bp, base_quat=bq, base_vel=bv, qpos=qp, qvel=qv,
                        cp_anchor=new_anchor), body_f


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
