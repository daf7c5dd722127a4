"""Articulated rigid-body dynamics (Featherstone ABA), block form.

Port of ``ti5_isaacgym_tpu/physics/dynamics.py``.  The JAX functions act on
one env and are vmapped; these take any leading batch shape directly.  The
rollout's hot loop uses the component-form core (:mod:`.engine_core`); this
module is the array-form oracle and serves the env constructor's
contact-mass probe (:func:`.engine.probe_contact_masses`).

State convention: base quaternion ``(w, x, y, z)``; base spatial velocity
``[omega_body(3), v_origin_body(3)]`` in the base frame.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import torch

from . import spatial as sp
from .model import RobotModel


@dataclass
class DynamicsParams:
    """Per-environment physical parameters (leading batch dims allowed)."""

    mass: torch.Tensor      # (..., nb)
    com: torch.Tensor       # (..., nb, 3)
    inertia: torch.Tensor   # (..., nb, 3, 3) about CoM
    armature: torch.Tensor  # (..., num_dof)

    def replace(self, **kw) -> "DynamicsParams":
        return replace(self, **kw)


def nominal_params(model: RobotModel, device="cpu") -> DynamicsParams:
    t = model.tensors(device)
    return DynamicsParams(mass=t["mass"], com=t["com"], inertia=t["inertia"],
                          armature=torch.zeros(model.num_dof, device=device))


class BodyFrames(NamedTuple):
    """World pose and body-frame spatial velocity of every body."""

    pos: torch.Tensor      # (..., nb, 3) world position of the body origin
    rot: torch.Tensor      # (..., nb, 3, 3) world_from_body rotation
    vel_ang: torch.Tensor  # (..., nb, 3) angular velocity, body frame
    vel_lin: torch.Tensor  # (..., nb, 3) origin velocity, body frame


def _rel_transforms(model: RobotModel, qpos: torch.Tensor):
    """Pose of each body frame in its parent's frame: (R_pc, p_pc)."""
    t = model.tensors(qpos.device)
    ang = torch.cat([torch.zeros(qpos.shape[:-1] + (1,), dtype=qpos.dtype,
                                 device=qpos.device), qpos], dim=-1)
    Rj = sp.quat_to_mat(sp.quat_from_axis_angle(t["joint_axis"], ang))
    return sp.mm(t["joint_rot"], Rj), t["joint_pos"]


def fk(model: RobotModel, base_pos, base_quat, base_vel, qpos, qvel) -> BodyFrames:
    """Forward kinematics and velocity propagation."""
    axis = model.tensors(qpos.device)["joint_axis"]
    R_pc, p_pc = _rel_transforms(model, qpos)
    pos = [base_pos]
    rot = [sp.quat_to_mat(base_quat)]
    w = [base_vel[..., :3]]
    v = [base_vel[..., 3:]]
    for i in range(1, model.nb):
        p = int(model.parent[i])
        rot.append(sp.mm(rot[p], R_pc[..., i, :, :]))
        pos.append(pos[p] + sp.mv(rot[p], p_pc[i]))
        w.append(sp.mtv(R_pc[..., i, :, :], w[p]) + axis[i] * qvel[..., i - 1:i])
        v.append(sp.mtv(R_pc[..., i, :, :], v[p] + sp.cross(w[p], p_pc[i])))
    return BodyFrames(pos=torch.stack(pos, -2), rot=torch.stack(rot, -3),
                      vel_ang=torch.stack(w, -2), vel_lin=torch.stack(v, -2))


def point_world(frames: BodyFrames, body, p_local: torch.Tensor):
    """World position and velocity of body-fixed points (np,) / (np, 3)."""
    R = frames.rot[..., body, :, :]
    pw = frames.pos[..., body, :] + sp.mv(R, p_local)
    v_local = frames.vel_lin[..., body, :] + sp.cross(frames.vel_ang[..., body, :], p_local)
    return pw, sp.mv(R, v_local)


def aba(model: RobotModel, params: DynamicsParams, frames: BodyFrames,
        qvel: torch.Tensor, tau: torch.Tensor,
        f_ext_world: Optional[torch.Tensor] = None,
        gravity: float = -9.81) -> Tuple[torch.Tensor, torch.Tensor]:
    """Articulated-body forward dynamics (block form).

    ``f_ext_world``: optional (..., nb, 6) external spatial force per body
    about its origin, world coordinates ``[torque, force]``.  Returns the
    base spatial acceleration (..., 6) in the base frame and qdd (..., nd).
    """
    nb = model.nb
    dev, dtype = frames.pos.device, frames.pos.dtype
    S = model.tensors(dev)["joint_axis"]
    g = torch.tensor([0.0, 0.0, gravity], dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    m_b = params.mass
    c_sk = sp.skew(params.com)
    IA_A = [params.inertia[..., i, :, :] + m_b[..., i, None, None]
            * sp.mm(c_sk[..., i, :, :], sp.transpose(c_sk[..., i, :, :])) for i in range(nb)]
    IA_B = [m_b[..., i, None, None] * c_sk[..., i, :, :] for i in range(nb)]
    IA_D = [m_b[..., i, None, None] * eye3 for i in range(nb)]

    rot = [frames.rot[..., i, :, :] for i in range(nb)]
    R_pc, p_pc = [None] * nb, [None] * nb
    for i in range(1, nb):
        p = int(model.parent[i])
        R_pc[i] = sp.mm(sp.transpose(rot[p]), rot[i])
        p_pc[i] = sp.mtv(rot[p], frames.pos[..., i, :] - frames.pos[..., p, :])

    # pass 1 (outward): velocity-product bias forces and external forces
    cb_a, cb_l = [None] * nb, [None] * nb
    pA_a, pA_l = [None] * nb, [None] * nb
    for i in range(nb):
        w, v = frames.vel_ang[..., i, :], frames.vel_lin[..., i, :]
        if i == 0:
            cb_a[i] = torch.zeros_like(w)
            cb_l[i] = torch.zeros_like(w)
        else:
            sj = S[i] * qvel[..., i - 1:i]
            cb_a[i] = sp.cross(w, sj)
            cb_l[i] = sp.cross(v, sj)
        n_ = sp.mv(IA_A[i], w) + sp.mv(IA_B[i], v)
        f_ = sp.mtv(IA_B[i], w) + m_b[..., i:i + 1] * v
        pA_a[i] = sp.cross(w, n_) + sp.cross(v, f_)
        pA_l[i] = sp.cross(w, f_)
        if f_ext_world is not None:
            pA_a[i] = pA_a[i] - sp.mtv(rot[i], f_ext_world[..., i, :3])
            pA_l[i] = pA_l[i] - sp.mtv(rot[i], f_ext_world[..., i, 3:])

    # pass 2 (inward): articulated inertias
    U_a, U_l, d_, u_ = [None] * nb, [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, 0, -1):
        p = int(model.parent[i])
        s = S[i]
        U_a[i] = sp.mv(IA_A[i], s)
        U_l[i] = sp.mtv(IA_B[i], s)
        d_[i] = torch.sum(s * U_a[i], dim=-1) + params.armature[..., i - 1]
        u_[i] = tau[..., i - 1] - torch.sum(s * pA_a[i], dim=-1)
        inv_d_s = 1.0 / d_[i]
        inv_d = inv_d_s[..., None, None]
        Ia_A = IA_A[i] - inv_d * U_a[i][..., :, None] * U_a[i][..., None, :]
        Ia_B = IA_B[i] - inv_d * U_a[i][..., :, None] * U_l[i][..., None, :]
        Ia_D = IA_D[i] - inv_d * U_l[i][..., :, None] * U_l[i][..., None, :]
        ud = (u_[i] * inv_d_s)[..., None]
        pa_a = pA_a[i] + sp.mv(Ia_A, cb_a[i]) + sp.mv(Ia_B, cb_l[i]) + U_a[i] * ud
        pa_l = pA_l[i] + sp.mtv(Ia_B, cb_a[i]) + sp.mv(Ia_D, cb_l[i]) + U_l[i] * ud
        R, pp = R_pc[i], p_pc[i]
        f_par = sp.mv(R, pa_l)
        pA_a[p] = pA_a[p] + sp.mv(R, pa_a) + sp.cross(pp, f_par)
        pA_l[p] = pA_l[p] + f_par
        psk = sp.skew(pp)
        RA = sp.mm(R, sp.mm(Ia_A, sp.transpose(R)))
        RB = sp.mm(R, sp.mm(Ia_B, sp.transpose(R)))
        RD = sp.mm(R, sp.mm(Ia_D, sp.transpose(R)))
        pRD = sp.mm(psk, RD)
        Y_B = RB + pRD
        Y_A = RA - sp.mm(RB, psk) + sp.mm(psk, sp.transpose(RB)) - sp.mm(pRD, psk)
        IA_A[p] = IA_A[p] + Y_A
        IA_B[p] = IA_B[p] + Y_B
        IA_D[p] = IA_D[p] + RD

    # base 6x6 solve
    top = torch.cat([IA_A[0], IA_B[0]], dim=-1)
    bot = torch.cat([sp.transpose(IA_B[0]), IA_D[0]], dim=-1)
    M = torch.cat([top, bot], dim=-2) + 1e-9 * torch.eye(6, dtype=dtype, device=dev)
    rhs = -torch.cat([pA_a[0], pA_l[0]], dim=-1)
    a0 = sp.cho_solve_psd(M, rhs)

    # pass 3 (outward): joint accelerations relative to free fall
    a_a, a_l = [None] * nb, [None] * nb
    a_a[0], a_l[0] = a0[..., :3], a0[..., 3:]
    qdd = [None] * (nb - 1)
    for i in range(1, nb):
        p = int(model.parent[i])
        R, pp = R_pc[i], p_pc[i]
        ai_a = sp.mtv(R, a_a[p]) + cb_a[i]
        ai_l = sp.mtv(R, a_l[p] + sp.cross(a_a[p], pp)) + cb_l[i]
        qdd[i - 1] = (u_[i] - torch.sum(U_a[i] * ai_a + U_l[i] * ai_l, dim=-1)) / d_[i]
        a_a[i] = ai_a + S[i] * qdd[i - 1][..., None]
        a_l[i] = ai_l

    a_base = torch.cat([a_a[0], a_l[0] + sp.mtv(rot[0], g)], dim=-1)
    return a_base, torch.stack(qdd, dim=-1)


def integrate(base_pos, base_quat, base_vel, qpos, qvel, a_base, qdd, dt: float):
    """Semi-implicit Euler: velocities first, then the configuration; the
    base orientation by the body-frame exponential map."""
    base_vel_n = base_vel + dt * a_base
    qvel_n = qvel + dt * qdd
    w_b = base_vel_n[..., :3]
    ang = torch.linalg.vector_norm(w_b, dim=-1) + 1e-12
    dq = sp.quat_from_axis_angle(w_b / ang[..., None], ang * dt)
    base_quat_n = sp.quat_normalize(sp.quat_mul(base_quat, dq))
    base_pos_n = base_pos + dt * sp.quat_rotate(base_quat_n, base_vel_n[..., 3:])
    qpos_n = qpos + dt * qvel_n
    return base_pos_n, base_quat_n, base_vel_n, qpos_n, qvel_n
