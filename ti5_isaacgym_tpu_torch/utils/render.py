"""Offscreen MuJoCo rendering of evaluation trajectories (port of
``ti5_isaacgym_tpu/utils/render.py``).

The reference records mp4s from the Isaac Gym camera during ``play``
(reference ``scripts/play.py:147-207``).  Here robot 0's trajectory (base
pose and joint positions per policy step, the layout of ``scripts.play
--export_traj``) is replayed through the MJCF generated from the played
task's own model spec, purely for visualisation, and encoded to mp4.

Needs ``mujoco`` and ``cv2`` and an offscreen GL (EGL by default);
:func:`video_modules` imports both, so that ``play --video`` can fail before
its rollout on a machine that lacks them.
"""
from __future__ import annotations

import os

import numpy as np

from ..export.mjcf import spec_file_to_mjcf


def video_modules():
    """``(mujoco, cv2)``; raises ImportError where either is missing.

    Selects headless GL (EGL, surfaceless) unless ``MUJOCO_GL`` is set: it
    must be chosen before the first ``mujoco`` import creates a context."""
    os.environ.setdefault("MUJOCO_GL", "egl")
    os.environ.setdefault("EGL_PLATFORM", "surfaceless")
    os.environ.setdefault("LIBGL_ALWAYS_SOFTWARE", "1")
    import cv2
    import mujoco

    return mujoco, cv2


def render_trajectory(qpos_traj: np.ndarray, dt: float, out_path: str, spec_path: str,
                      width: int = 640, height: int = 480, fps: int | None = None,
                      camera_distance: float = 3.0) -> str:
    """Render a ``[T, nq]`` trajectory (base pos 3, base quat wxyz 4, joint
    angles) of the robot of ``spec_path`` to mp4; returns ``out_path``."""
    mujoco, cv2 = video_modules()
    model = mujoco.MjModel.from_xml_string(spec_file_to_mjcf(spec_path))
    data = mujoco.MjData(model)

    fps = fps or max(int(round(1.0 / dt)), 1)
    # subsample to <= 50 fps so the file stays small and encoders are happy
    stride = max(int(round(fps / 50.0)), 1)
    out_fps = fps / stride

    qpos_traj = np.asarray(qpos_traj, np.float64)
    if qpos_traj.ndim != 2 or qpos_traj.shape[1] != model.nq:
        raise ValueError(f"trajectory is {qpos_traj.shape}, model expects [T, nq={model.nq}]")

    renderer = mujoco.Renderer(model, height=height, width=width)
    cam = mujoco.MjvCamera()
    mujoco.mjv_defaultFreeCamera(model, cam)
    cam.distance = camera_distance
    cam.elevation = -15.0

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             out_fps, (width, height))
    try:
        for t in range(0, qpos_traj.shape[0], stride):
            data.qpos[:] = qpos_traj[t]
            mujoco.mj_forward(model, data)
            cam.lookat[:] = data.qpos[:3]
            renderer.update_scene(data, camera=cam)
            # renderer yields RGB; VideoWriter wants BGR
            writer.write(cv2.cvtColor(renderer.render(), cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
        renderer.close()
    return out_path
