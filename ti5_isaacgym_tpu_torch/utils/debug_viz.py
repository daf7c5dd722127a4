"""Live-viewer debug overlays (port of ``ti5_isaacgym_tpu/utils/debug_viz.py``;
reference ``_draw_debug_vis`` parity).

The reference draws the 187-point height scan as small spheres on the live
sim (``legged_robot.py:1521-1533``) and Isaac Gym's viewer draws contact
forces.  This module computes the same primitives from the port's
``EnvState`` tensors, on whatever device they live, and returns numpy; and
injects them into a MuJoCo passive viewer's ``user_scn`` (``scripts/play.py
--live`` replays robot 0's kinematics into MuJoCo).

:func:`height_scan_markers` and :func:`contact_force_segments` are pure and
headless; only :func:`update_overlay` touches viewer objects (and imports
``mujoco``).
"""
from __future__ import annotations

import numpy as np

from ..physics import spatial as sp


def height_scan_markers(env, state, robot: int = 0) -> np.ndarray:
    """World ``[P, 3]`` positions of the yaw-rotated height-scan grid with
    z = the sampled terrain height (reference ``_get_heights`` points,
    ``legged_robot.py:1551-1587``)."""
    n, npts = state.phys.base_quat.shape[0], env.height_points.shape[0]
    pts = sp.quat_apply_yaw(state.phys.base_quat[:, None, :].expand(n, npts, 4),
                            env.height_points[None].expand(n, npts, 3))
    pts = pts + state.phys.base_pos[:, None, :]
    h = env.measured_heights(state)
    out = pts[robot].double().cpu().numpy()
    out[:, 2] = h[robot].double().cpu().numpy()
    return out


def contact_force_segments(env, state, body_pos: np.ndarray, robot: int = 0,
                           scale: float = 1.0 / 500.0,
                           min_force: float = 1.0) -> list:
    """``[(from_xyz, to_xyz, magnitude_N), ...]`` for bodies with contact
    force above ``min_force``; ``body_pos`` is the ``[nb, 3]`` world body
    positions (the viewer's MuJoCo ``data.xpos`` rows for the same bodies,
    which share the replayed kinematics)."""
    f = state.contact_forces[robot].double().cpu().numpy()
    segs = []
    for b in range(f.shape[0]):
        mag = float(np.linalg.norm(f[b]))
        if mag >= min_force and b < len(body_pos):
            p0 = np.asarray(body_pos[b], dtype=np.float64)
            segs.append((p0, p0 + f[b] * scale, mag))
    return segs


def update_overlay(viewer, mj_model, mj_data, env, state, robot: int = 0,
                   spec_body_names=None) -> int:
    """Fill ``viewer.user_scn`` with height-scan spheres + contact-force
    arrows; returns the number of geoms drawn."""
    import mujoco

    scn = viewer.user_scn
    i = 0

    def add_sphere(pos, radius, rgba):
        nonlocal i
        if i >= scn.maxgeom:
            return
        mujoco.mjv_initGeom(scn.geoms[i], mujoco.mjtGeom.mjGEOM_SPHERE,
                            np.array([radius, 0, 0], np.float64),
                            np.asarray(pos, np.float64),
                            np.eye(3).ravel(), np.asarray(rgba, np.float32))
        i += 1

    def add_arrow(p0, p1, rgba, width=0.01):
        nonlocal i
        if i >= scn.maxgeom:
            return
        mujoco.mjv_initGeom(scn.geoms[i], mujoco.mjtGeom.mjGEOM_ARROW,
                            np.zeros(3), np.zeros(3), np.eye(3).ravel(),
                            np.asarray(rgba, np.float32))
        mujoco.mjv_connector(scn.geoms[i], mujoco.mjtGeom.mjGEOM_ARROW,
                             width, np.asarray(p0, np.float64),
                             np.asarray(p1, np.float64))
        i += 1

    for p in height_scan_markers(env, state, robot):
        add_sphere(p, 0.02, (1.0, 0.9, 0.1, 0.9))

    # engine body index -> viewer body position, matched by spec body name
    if spec_body_names:
        ids = [mujoco.mj_name2id(mj_model, mujoco.mjtObj.mjOBJ_BODY, n)
               for n in spec_body_names]
        body_pos = np.array([mj_data.xpos[b] if b >= 0 else np.zeros(3)
                             for b in ids])
    else:
        body_pos = np.asarray(mj_data.xpos[1:])
    for p0, p1, mag in contact_force_segments(env, state, body_pos, robot):
        add_arrow(p0, p1, (0.9, 0.2, 0.2, 0.9))

    scn.ngeom = i
    return i
