"""Component-form physics substep over batched tensors.

Port of ``ti5_isaacgym_tpu/physics/engine_core.py``: one 1 kHz substep
(FK -> contact -> joint limits -> ABA -> semi-implicit Euler) written over
per-component ``[N]`` tensors, with the model geometry as Python constants.
It is the CPU path of the env's decimation loop and the plain version that
the CUDA decimation kernel (``csrc/decimation.cu``) is held against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import spatial3 as s3
from .contact import CellCache, ContactOpts
from .engine import PhysicsState, SolverOpts
from .model import RobotModel


def _const_v3(arr) -> tuple:
    a = np.asarray(arr, dtype=np.float32)
    return (float(a[0]), float(a[1]), float(a[2]))


def _const_m33(arr) -> tuple:
    a = np.asarray(arr, dtype=np.float32)
    return tuple(tuple(float(a[i, j]) for j in range(3)) for i in range(3))


class ModelConsts(NamedTuple):
    """Constants of the kinematic tree as Python floats and ints."""

    nb: int
    nd: int
    ncp: int
    parent: list
    axis_c: list
    jpos_c: list
    jrot_c: list
    jrot_identity: list
    cp_body: list
    cp_pos_c: list
    dof_lower: list
    dof_upper: list
    dof_effort: list


def model_consts(model: RobotModel) -> ModelConsts:
    nb, ncp = model.nb, model.ncp
    return ModelConsts(
        nb=nb, nd=model.num_dof, ncp=ncp,
        parent=[int(p) for p in model.parent],
        axis_c=[_const_v3(model.joint_axis[i]) for i in range(nb)],
        jpos_c=[_const_v3(model.joint_pos[i]) for i in range(nb)],
        jrot_c=[_const_m33(model.joint_rot[i]) for i in range(nb)],
        jrot_identity=[bool(np.allclose(model.joint_rot[i], np.eye(3))) for i in range(nb)],
        cp_body=[int(b) for b in model.cp_body],
        cp_pos_c=[_const_v3(model.cp_pos[k]) for k in range(ncp)],
        dof_lower=[float(x) for x in model.dof_lower],
        dof_upper=[float(x) for x in model.dof_upper],
        dof_effort=[float(x) for x in model.dof_effort],
    )


def substep_batched(model: RobotModel, params, copts: ContactOpts, sopts: SolverOpts,
                    hscale: float, state: PhysicsState, tau: torch.Tensor,
                    friction: torch.Tensor, cp_meff, cell_cache: CellCache,
                    base_force_w: Optional[torch.Tensor] = None,
                    base_torque_w: Optional[torch.Tensor] = None,
                    restitution: Optional[torch.Tensor] = None,
                    ) -> Tuple[PhysicsState, torch.Tensor]:
    """One substep of a [N] batch in array form: unpacks to components, runs
    :func:`substep_stacked` against the frozen cells, repacks.  Returns the
    next state and the per-body contact forces [N, nb, 3]."""
    nb, nd = model.nb, model.num_dof
    comps = dict(
        bp=s3.v3_unstack(state.base_pos),
        bq=s3.q_unstack(state.base_quat),
        bw=s3.v3_unstack(state.base_vel[..., :3]),
        bv=s3.v3_unstack(state.base_vel[..., 3:]),
        qpos=[state.qpos[..., j] for j in range(nd)],
        qvel=[state.qvel[..., j] for j in range(nd)],
        tau=[tau[..., j] for j in range(nd)],
        mass=[params.mass[..., i] for i in range(nb)],
        com=[s3.v3_unstack(params.com[..., i, :]) for i in range(nb)],
        inert=[s3.m33_unstack(params.inertia[..., i, :, :]) for i in range(nb)],
        arma=[params.armature[..., j] for j in range(nd)],
        friction=friction,
        ax=torch.movedim(state.cp_anchor[..., 0], -1, 0),   # [ncp, N]
        ay=torch.movedim(state.cp_anchor[..., 1], -1, 0),
        az=torch.movedim(state.cp_anchor[..., 2], -1, 0),
        bf=s3.v3_unstack(base_force_w) if base_force_w is not None else None,
        bt=s3.v3_unstack(base_torque_w) if base_torque_w is not None else None,
    )
    if restitution is not None:
        comps["restitution"] = restitution
    out = substep_stacked(model_consts(model), hscale, copts, sopts, comps,
                          cells=cell_cache, cp_meff=np.asarray(cp_meff))
    new_anchor = torch.stack([torch.movedim(out["nax"], 0, -1),
                              torch.movedim(out["nay"], 0, -1),
                              torch.movedim(out["naz"], 0, -1)], dim=-1)
    new_state = PhysicsState(
        base_pos=s3.v3_stack(out["bp"]), base_quat=s3.q_stack(out["bq"]),
        base_vel=torch.cat([s3.v3_stack(out["bw"]), s3.v3_stack(out["bv"])], dim=-1),
        qpos=torch.stack(out["qpos"], dim=-1), qvel=torch.stack(out["qvel"], dim=-1),
        cp_anchor=new_anchor)
    body_forces = torch.stack([s3.v3_stack(f) for f in out["f_body"]], dim=-2)
    return new_state, body_forces


def _div(x, c: float):
    """``x / c`` as one IEEE float division on every device.  PyTorch's CUDA
    kernels turn a division by a Python scalar into a multiplication by the
    scalar's reciprocal (one rounding more); the CUDA decimation kernel and
    the CPU divide, and the kernel is held to this version bit for bit."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _over(c: float, x):
    """``c / x`` as one IEEE float division on every device.  PyTorch computes
    a Python scalar over a tensor as ``x.reciprocal() * c`` (one rounding
    more) on the CPU and the card alike; the kernel divides."""
    return torch.tensor(c, dtype=x.dtype, device=x.device) / x


def fk_components(mc: ModelConsts, bp, bq, bw, bv, qpos, qvel):
    """Component-form forward kinematics: (pos, rot, w, v, R_pc) per body —
    world position, world rotation, body-frame angular and linear velocity,
    and the parent-to-child joint rotation."""
    pos, rot, w, v = [bp], [s3.q_to_m33(bq)], [bw], [bv]
    R_pc = [None] * mc.nb
    for i in range(1, mc.nb):
        p, j = mc.parent[i], i - 1
        Rj = s3.q_to_m33(s3.q_from_axis_angle(mc.axis_c[i], qpos[j]))
        Rpc = Rj if mc.jrot_identity[i] else s3.m33_mm(mc.jrot_c[i], Rj)
        R_pc[i] = Rpc
        rot.append(s3.m33_mm(rot[p], Rpc))
        pos.append(s3.v3_add(pos[p], s3.m33_mv(rot[p], mc.jpos_c[i])))
        w.append(s3.v3_add(s3.m33_tmv(Rpc, w[p]), s3.v3_scale(mc.axis_c[i], qvel[j])))
        v.append(s3.m33_tmv(Rpc, s3.v3_add(v[p], s3.v3_cross(w[p], mc.jpos_c[i]))))
    return pos, rot, w, v, R_pc


def ctx_row_layout(nf: int, nk: int) -> dict:
    """Row offsets of the ctx kinematics block for ``nf`` feet and ``nk``
    knees: the one contract between :func:`ctx_stack_rows`, the kernel's ctx
    output and the env's ``_make_ctx``."""
    return {
        "pos": 0,                       # 3 rows per foot (xyz)
        "rot": 3 * nf,                  # 5 rows per foot (R00,R10,R20,R21,R22)
        "angvel": 8 * nf,               # 2 rows per foot (wx, wy)
        "knee": 10 * nf,                # 2 rows per knee (xy)
        "total": 10 * nf + 2 * nk,
    }


def ctx_stack_rows(mc: ModelConsts, feet: list, knees: list, bp, bq, bw, bv, qpos, qvel):
    """Post-step reward/termination kinematics as a flat row list in the
    :func:`ctx_row_layout` order (24 rows for T1)."""
    pos, rot, w, _, _ = fk_components(mc, bp, bq, bw, bv, qpos, qvel)
    rows = []
    for b in feet:
        rows += [pos[b][0], pos[b][1], pos[b][2]]
    for b in feet:
        R = rot[b]
        rows += [R[0][0], R[1][0], R[2][0], R[2][1], R[2][2]]
    for b in feet:
        ww = s3.m33_mv(rot[b], w[b])
        rows += [ww[0], ww[1]]
    for b in knees:
        rows += [pos[b][0], pos[b][1]]
    return rows


def substep_stacked(mc: ModelConsts, hscale: float, copts: ContactOpts,
                    sopts: SolverOpts, comps: dict, cells: CellCache,
                    cp_meff=None) -> dict:
    """The substep math over pure components.

    comps keys: bp/bq/bw/bv (tuples), qpos/qvel/tau/arma (length-nd lists),
    mass (length-nb list), com (list of V3), inert (list of M33), friction,
    ax/ay/az ([ncp, N]), bf/bt (V3 or None), optional restitution and
    mn/mt ([ncp, N] apparent masses; else taken from ``cp_meff``).
    Returns dict: bp/bq/bw/bv, qpos/qvel, nax/nay/naz, f_body (list of V3).
    """
    nb, nd, ncp = mc.nb, mc.nd, mc.ncp
    parent, axis_c, jpos_c = mc.parent, mc.axis_c, mc.jpos_c
    cp_body, cp_pos_c = mc.cp_body, mc.cp_pos_c
    dof_lower, dof_upper, dof_effort = mc.dof_lower, mc.dof_upper, mc.dof_effort

    bp, bq, bw, bv = comps["bp"], comps["bq"], comps["bw"], comps["bv"]
    qpos, qvel, tauj = comps["qpos"], comps["qvel"], comps["tau"]
    mass, com, inert, arma = comps["mass"], comps["com"], comps["inert"], comps["arma"]
    friction = comps["friction"]
    ax_, ay_, az_ = comps["ax"], comps["ay"], comps["az"]
    bf, bt = comps.get("bf"), comps.get("bt")

    # --- FK ---
    pos, rot, w, v, R_pc = fk_components(mc, bp, bq, bw, bv, qpos, qvel)

    # --- contact: world kinematics of every point ---
    pw, vw = [], []
    for k in range(ncp):
        b, pl = cp_body[k], cp_pos_c[k]
        pw.append(s3.v3_add(pos[b], s3.m33_mv(rot[b], pl)))
        vloc = s3.v3_add(v[b], s3.v3_cross(w[b], pl))
        vw.append(s3.m33_mv(rot[b], vloc))
    px = torch.stack([p[0] for p in pw])    # [ncp, N]
    py = torch.stack([p[1] for p in pw])
    pz = torch.stack([p[2] for p in pw])

    # frozen-cell analytic bilinear height and gradient (fu/fv unclipped: the
    # surface extrapolates continuously if a point drifts off its cell)
    fu = _div(px - cells.x0, hscale)
    fv = _div(py - cells.y0, hscale)
    c00, c10, c01, c11 = cells.h00, cells.h10, cells.h01, cells.h11
    gu = 1.0 - fu
    gv = 1.0 - fv
    h = c00 * gu * gv + c10 * fu * gv + c01 * gu * fv + c11 * fu * fv
    dhdx = _div((c10 - c00) * gv + (c11 - c01) * fv, hscale)
    dhdy = _div((c01 - c00) * gu + (c11 - c10) * fu, hscale)
    n_norm = torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    nx, ny, nz = -dhdx / n_norm, -dhdy / n_norm, 1.0 / n_norm

    gap = h - pz
    depth = torch.clamp(gap * nz, 0.0, copts.max_depth)
    active = gap > 0.0

    vx = torch.stack([vv[0] for vv in vw])
    vy = torch.stack([vv[1] for vv in vw])
    vz = torch.stack([vv[2] for vv in vw])
    if "mn" in comps:
        mn, mt = comps["mn"], comps["mt"]
    else:
        cm = torch.as_tensor(np.asarray(cp_meff, np.float32), device=px.device)
        shape = (ncp,) + (1,) * (px.ndim - 1)
        mn, mt = cm[:, 0].reshape(shape), cm[:, 1].reshape(shape)
    # per-env restitution e scales the normal damping: kd_eff = kd * (1 - e)
    rest = comps.get("restitution")
    if rest is not None:
        k_v = copts.kp * copts.dt + copts.kd * (1.0 - rest)
    else:
        k_v = copts.kp * copts.dt + copts.kd
    kt_v = copts.kt * copts.dt + copts.kdt
    v_n = nx * vx + ny * vy + nz * vz
    denom = 1.0 + copts.dt * k_v / mn
    f_n = torch.clamp((copts.kp * depth - k_v * v_n) / denom, 0.0, copts.max_force) * active
    # depenetration-velocity cap: stop the approach, impart at most
    # max_depen_vel of outward velocity
    f_cap = torch.clamp_min(_div(mn * (copts.max_depen_vel - v_n), copts.dt), 0.0)
    f_n = torch.minimum(f_n, f_cap)
    vtx, vty, vtz = vx - v_n * nx, vy - v_n * ny, vz - v_n * nz
    dtx, dty, dtz = px - ax_, py - ay_, pz - az_
    d_n = dtx * nx + dty * ny + dtz * nz
    dtx, dty, dtz = dtx - d_n * nx, dty - d_n * ny, dtz - d_n * nz
    denom_t = 1.0 + _over(copts.dt * kt_v, mt)
    ftx = -(copts.kt * dtx + kt_v * vtx) / denom_t
    fty = -(copts.kt * dty + kt_v * vty) / denom_t
    ftz = -(copts.kt * dtz + kt_v * vtz) / denom_t
    ft_mag = torch.sqrt(ftx * ftx + fty * fty + ftz * ftz)
    cone = friction * f_n
    scale = torch.where(ft_mag > cone, cone / (ft_mag + 1e-8), 1.0) * active
    ftx, fty, ftz = ftx * scale, fty * scale, ftz * scale
    fX = nx * f_n + ftx
    fY = ny * f_n + fty
    fZ = nz * f_n + ftz
    sliding = (ft_mag > cone) & active
    sx = px + _div(ftx * denom_t, copts.kt)
    sy = py + _div(fty * denom_t, copts.kt)
    sz = pz + _div(ftz * denom_t, copts.kt)
    nax = torch.where(active, torch.where(sliding, sx, ax_), px)
    nay = torch.where(active, torch.where(sliding, sy, ay_), py)
    naz = torch.where(active, torch.where(sliding, sz, az_), pz)
    f_pts = [(fX[k], fY[k], fZ[k]) for k in range(ncp)]

    # per-body contact force/torque (world)
    f_body = [s3.v3_zero_like(bp) for _ in range(nb)]
    t_body = [s3.v3_zero_like(bp) for _ in range(nb)]
    for k in range(ncp):
        b = cp_body[k]
        f_body[b] = s3.v3_add(f_body[b], f_pts[k])
        arm = s3.v3_sub(pw[k], pos[b])
        t_body[b] = s3.v3_add(t_body[b], s3.v3_cross(arm, f_pts[k]))

    # the applied external wrench enters the dynamics but not the reported
    # contact forces
    fx_body, tx_body = list(f_body), list(t_body)
    if bf is not None:
        fx_body[0] = s3.v3_add(fx_body[0], bf)
    if bt is not None:
        tx_body[0] = s3.v3_add(tx_body[0], bt)

    # --- joint-limit penalty + effort clamp ---
    tau_t = []
    for j in range(nd):
        over = torch.clamp_min(qpos[j] - dof_upper[j], 0.0)
        under = torch.clamp_min(dof_lower[j] - qpos[j], 0.0)
        t_lim = -sopts.limit_kp * over + sopts.limit_kp * under
        in_vio = (over > 0) | (under > 0)
        t_lim = t_lim - torch.where(in_vio, sopts.limit_kd * qvel[j], 0.0)
        tau_t.append(torch.clamp(tauj[j], -dof_effort[j], dof_effort[j]) + t_lim)

    # --- ABA (block form, free-fall relative; A and D blocks symmetric) ---
    IA_A, IA_B, IA_D = [None] * nb, [None] * nb, [None] * nb
    for i in range(nb):
        c = com[i]
        cc = s3.v3_dot(c, c)
        sk = s3.sym_sub(s3.sym_identity_scaled(cc), s3.sym_outer(c))
        IA_A[i] = s3.sym_add(s3.sym_from_m33(inert[i]), s3.sym_scale(sk, mass[i]))
        IA_B[i] = s3.m33_scale(s3.m33_skew(c), mass[i])
        IA_D[i] = s3.sym_identity_scaled(mass[i])

    cb_a, cb_l = [None] * nb, [None] * nb
    pA_a, pA_l = [None] * nb, [None] * nb
    for i in range(nb):
        wi, vi = w[i], v[i]
        if i == 0:
            cb_a[i] = s3.v3_zero_like(wi)
            cb_l[i] = s3.v3_zero_like(wi)
        else:
            sj = s3.v3_scale(axis_c[i], qvel[i - 1])
            cb_a[i] = s3.v3_cross(wi, sj)
            cb_l[i] = s3.v3_cross(vi, sj)
        n_ = s3.v3_add(s3.sym_mv(IA_A[i], wi), s3.m33_mv(IA_B[i], vi))
        f_ = s3.v3_add(s3.m33_tmv(IA_B[i], wi), s3.v3_scale(vi, mass[i]))
        pA_a[i] = s3.v3_add(s3.v3_cross(wi, n_), s3.v3_cross(vi, f_))
        pA_l[i] = s3.v3_cross(wi, f_)
        pA_a[i] = s3.v3_sub(pA_a[i], s3.m33_tmv(rot[i], tx_body[i]))
        pA_l[i] = s3.v3_sub(pA_l[i], s3.m33_tmv(rot[i], fx_body[i]))

    U_a, U_l, d_, u_ = [None] * nb, [None] * nb, [None] * nb, [None] * nb
    for i in range(nb - 1, 0, -1):
        p = parent[i]
        s = axis_c[i]
        U_a[i] = s3.sym_mv(IA_A[i], s)
        U_l[i] = s3.m33_tmv(IA_B[i], s)
        d_[i] = s3.v3_dot(s, U_a[i]) + arma[i - 1]
        u_[i] = tau_t[i - 1] - s3.v3_dot(s, pA_a[i])
        inv_d = 1.0 / d_[i]
        Ia_A = s3.sym_sub(IA_A[i], s3.sym_outer(U_a[i], inv_d))
        Ia_B = s3.m33_sub(IA_B[i], s3.m33_outer(U_a[i], U_l[i], inv_d))
        Ia_D = s3.sym_sub(IA_D[i], s3.sym_outer(U_l[i], inv_d))
        ud = u_[i] * inv_d
        pa_a = s3.v3_add(s3.v3_add(pA_a[i], s3.sym_mv(Ia_A, cb_a[i])),
                         s3.v3_add(s3.m33_mv(Ia_B, cb_l[i]), s3.v3_scale(U_a[i], ud)))
        pa_l = s3.v3_add(s3.v3_add(pA_l[i], s3.m33_tmv(Ia_B, cb_a[i])),
                         s3.v3_add(s3.sym_mv(Ia_D, cb_l[i]), s3.v3_scale(U_l[i], ud)))
        R = R_pc[i]
        pp = jpos_c[i]
        f_par = s3.m33_mv(R, pa_l)
        pA_a[p] = s3.v3_add(pA_a[p], s3.v3_add(s3.m33_mv(R, pa_a), s3.v3_cross(pp, f_par)))
        pA_l[p] = s3.v3_add(pA_l[p], f_par)
        psk = s3.m33_skew(pp)
        RA = s3.sym_congruence(R, Ia_A)                      # R Ia_A R^T
        RB = s3.m33_mm(R, s3.m33_mmt(Ia_B, R))               # R Ia_B R^T
        RD = s3.sym_congruence(R, Ia_D)                      # R Ia_D R^T
        # Y_A = RA - (RB p~ + (RB p~)^T) - p~ RD p~ ;  Y_B = RB + p~ RD
        M = s3.m33_mm(RB, psk)
        Y_A = s3.sym_sub(s3.sym_sub(RA, s3.sym2_of(M)), s3.sym_skew_congruence(pp, RD))
        Y_B = s3.m33_add(RB, s3.m33_mm(psk, s3.sym_to_m33(RD)))
        IA_A[p] = s3.sym_add(IA_A[p], Y_A)
        IA_B[p] = s3.m33_add(IA_B[p], Y_B)
        IA_D[p] = s3.sym_add(IA_D[p], RD)

    # base 6x6 SPD solve
    A_full = s3.sym_to_m33(IA_A[0])
    D_full = s3.sym_to_m33(IA_D[0])
    A6 = [[None] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            A6[i][j] = A_full[i][j]
            A6[i][3 + j] = IA_B[0][i][j]
            A6[3 + i][j] = IA_B[0][j][i]
            A6[3 + i][3 + j] = D_full[i][j]
    for i in range(6):
        A6[i][i] = A6[i][i] + 1e-9
    rhs = [-pA_a[0][0], -pA_a[0][1], -pA_a[0][2], -pA_l[0][0], -pA_l[0][1], -pA_l[0][2]]
    a0 = s3.chol6_solve(A6, rhs)
    a_a, a_l = [None] * nb, [None] * nb
    a_a[0] = (a0[0], a0[1], a0[2])
    a_l[0] = (a0[3], a0[4], a0[5])

    qdd = [None] * nd
    for i in range(1, nb):
        p = parent[i]
        R = R_pc[i]
        pp = jpos_c[i]
        ai_a = s3.v3_add(s3.m33_tmv(R, a_a[p]), cb_a[i])
        ai_l = s3.v3_add(s3.m33_tmv(R, s3.v3_add(a_l[p], s3.v3_cross(a_a[p], pp))), cb_l[i])
        qdd[i - 1] = (u_[i] - s3.v3_dot(U_a[i], ai_a) - s3.v3_dot(U_l[i], ai_l)) / d_[i]
        a_a[i] = s3.v3_add(ai_a, s3.v3_scale(axis_c[i], qdd[i - 1]))
        a_l[i] = ai_l

    # gravity back in (base only)
    zero = torch.zeros_like(bp[0])
    g_body = s3.m33_tmv(rot[0], (zero, zero, torch.full_like(bp[0], sopts.gravity)))
    a_base_lin = s3.v3_add(a_l[0], g_body)

    # --- semi-implicit Euler with velocity caps and hard joint stops ---
    dt, vmax = sopts.dt, sopts.max_qvel
    bw_n = s3.v3_add(bw, s3.v3_scale(a_a[0], dt))
    bv_n = s3.v3_add(bv, s3.v3_scale(a_base_lin, dt))
    bw_n = tuple(torch.clamp(c, -vmax, vmax) for c in bw_n)
    bv_n = tuple(torch.clamp(c, -vmax, vmax) for c in bv_n)
    qvel_n = [torch.clamp(qvel[j] + dt * qdd[j], -vmax, vmax) for j in range(nd)]
    qpos_n = [qpos[j] + dt * qvel_n[j] for j in range(nd)]
    for j in range(nd):
        hit_up = qpos_n[j] > dof_upper[j]
        hit_lo = qpos_n[j] < dof_lower[j]
        qvel_n[j] = torch.where(hit_up, torch.clamp_max(qvel_n[j], 0.0),
                                torch.where(hit_lo, torch.clamp_min(qvel_n[j], 0.0),
                                            qvel_n[j]))
        qpos_n[j] = torch.clamp(qpos_n[j], dof_lower[j], dof_upper[j])
    ang = s3.v3_norm(bw_n) + 1e-12
    axis = s3.v3_scale(bw_n, 1.0 / ang)
    dq = s3.q_from_axis_angle(axis, ang * dt)
    bq_n = s3.q_normalize(s3.q_mul(bq, dq))
    bp_n = s3.v3_add(bp, s3.v3_scale(s3.q_rotate(bq_n, bv_n), dt))

    return dict(bp=bp_n, bq=bq_n, bw=bw_n, bv=bv_n, qpos=qpos_n, qvel=qvel_n,
                nax=nax, nay=nay, naz=naz, f_body=f_body)


def ctx_kinematics(model: RobotModel, state: PhysicsState) -> dict:
    """Post-step kinematics for the task layer: feet world pose (position and
    RPY), feet world angular velocity xy, knee world xy, and base world
    velocities."""
    mc = model_consts(model)
    nd = model.num_dof
    bp = s3.v3_unstack(state.base_pos)
    bq = s3.q_unstack(state.base_quat)
    bw = s3.v3_unstack(state.base_vel[..., :3])
    bv = s3.v3_unstack(state.base_vel[..., 3:])
    qpos = [state.qpos[..., j] for j in range(nd)]
    qvel = [state.qvel[..., j] for j in range(nd)]
    pos, rot, w, _, _ = fk_components(mc, bp, bq, bw, bv, qpos, qvel)

    def euler_xyz(R):
        roll = torch.atan2(R[2][1], R[2][2])
        pitch = torch.asin(torch.clamp(-R[2][0], -1.0, 1.0))
        yaw = torch.atan2(R[1][0], R[0][0])
        return roll, pitch, yaw

    feet, knees = list(model.feet_bodies), list(model.knee_bodies)
    feet_pos = torch.stack([torch.stack(pos[b], -1) for b in feet], -2)
    feet_euler = torch.stack([torch.stack(euler_xyz(rot[b]), -1) for b in feet], -2)
    feet_angvel_xy = torch.stack(
        [torch.stack(s3.m33_mv(rot[b], w[b])[:2], -1) for b in feet], -2)
    knee_xy = torch.stack([torch.stack([pos[b][0], pos[b][1]], -1) for b in knees], -2)
    return {
        "feet_pos": feet_pos, "feet_euler": feet_euler,
        "feet_angvel_xy": feet_angvel_xy, "knee_xy": knee_xy,
        "root_lin_w": torch.stack(s3.m33_mv(rot[0], bv), -1),
        "root_ang_w": torch.stack(s3.m33_mv(rot[0], bw), -1),
    }


def contact_point_xy(model: RobotModel, state: PhysicsState):
    """World xy of every collision point, ([ncp, N], [ncp, N]): positions-only
    FK, used once per policy step to pick each point's frozen cell."""
    mc = model_consts(model)
    bp = s3.v3_unstack(state.base_pos)
    bq = s3.q_unstack(state.base_quat)
    qpos = [state.qpos[..., j] for j in range(model.num_dof)]
    pos, rot = [bp], [s3.q_to_m33(bq)]
    for i in range(1, mc.nb):
        p = mc.parent[i]
        Rj = s3.q_to_m33(s3.q_from_axis_angle(mc.axis_c[i], qpos[i - 1]))
        Rpc = Rj if mc.jrot_identity[i] else s3.m33_mm(mc.jrot_c[i], Rj)
        rot.append(s3.m33_mm(rot[p], Rpc))
        pos.append(s3.v3_add(pos[p], s3.m33_mv(rot[p], mc.jpos_c[i])))
    px, py = [], []
    for k in range(mc.ncp):
        b = mc.cp_body[k]
        pw = s3.v3_add(pos[b], s3.m33_mv(rot[b], mc.cp_pos_c[k]))
        px.append(pw[0])
        py.append(pw[1])
    return torch.stack(px), torch.stack(py)
