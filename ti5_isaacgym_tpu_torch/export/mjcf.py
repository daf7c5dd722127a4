"""Model spec -> MJCF (port of ``ti5_isaacgym_tpu/export/mjcf.py``).

A numpy copy: its XML is byte-equal to the JAX package's for the same spec
and flags.  Two users:

* the MuJoCo oracle of the port's dynamics (FK and forward dynamics on
  random states, ``tests/test_torch_mjcf.py``);
* sim2sim and the viewers (``scripts/sim2sim.py``, ``utils/render.py``,
  ``scripts/play.py --live``), which replay a policy or a trajectory in
  MuJoCo on the spec-generated model.

The generated model uses primitive box collision geoms recovered from the
spec's collision points, so it is standalone (no meshes needed).  Pure
numpy: MuJoCo is imported by the callers that load the XML.
"""
from __future__ import annotations

import json
from typing import Dict
from xml.sax.saxutils import quoteattr

import numpy as np


def _fmt(v) -> str:
    return " ".join(f"{float(x):.9g}" for x in np.atleast_1d(v))


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z — MuJoCo order),
    Shepperd's method (numerically stable for all rotations)."""
    R = np.asarray(R, dtype=float)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2.0
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def spec_to_mjcf(
    spec: Dict,
    with_geoms: bool = True,
    timestep: float = 0.001,
    armature: float = 0.0,
    limited: bool = True,
) -> str:
    bodies = spec["bodies"]
    nb = len(bodies)
    children = [[] for _ in range(nb)]
    for i, b in enumerate(bodies):
        if b["parent"] >= 0:
            children[b["parent"]].append(i)

    cps_by_body = [[] for _ in range(nb)]
    for c in spec.get("collision_points", []):
        cps_by_body[c["body"]].append(c["pos"])

    lines = []

    def geom_xml(i, indent):
        if not with_geoms or not cps_by_body[i]:
            return
        pts = np.asarray(cps_by_body[i], dtype=float)
        lo, hi = pts.min(0), pts.max(0)
        half = np.maximum((hi - lo) / 2.0, 0.01)
        center = (hi + lo) / 2.0
        # contype=1/conaffinity=0: collide with the floor (contype&affinity
        # 1&1 from the floor side) but NEVER with other robot geoms — the
        # bounding boxes of adjacent links overlap and their contacts exert
        # phantom joint torques (measured -120 N*m on an airborne knee,
        # which pinned the PD at a straight-leg pose).  Isaac Gym's T1 asset
        # likewise runs with self-collisions off (collapse_fixed_joints +
        # self_collision bitmask, reference t1_dh_stand_config.py asset
        # section).
        lines.append(
            f'{indent}<geom type="box" size="{_fmt(half)}" pos="{_fmt(center)}" '
            f'contype="1" conaffinity="0" rgba="0.6 0.6 0.7 1"/>'
        )

    def link_viz_xml(i, indent):
        # visual-only capsules from this body's frame to each child joint
        # origin (contype/conaffinity 0 ⇒ zero effect on the physics oracle)
        for c in children[i]:
            j = bodies[c].get("joint")
            if not j:
                continue
            tip = np.asarray(j["origin_pos"], dtype=float)
            if np.linalg.norm(tip) < 0.02:
                continue
            lines.append(
                f'{indent}<geom type="capsule" size="0.02" fromto="0 0 0 {_fmt(tip)}" '
                f'contype="0" conaffinity="0" group="1" rgba="0.75 0.55 0.3 1" mass="0"/>'
            )

    def body_xml(i, indent):
        b = bodies[i]
        j = b.get("joint")
        pos = j["origin_pos"] if j else [0, 0, 0]
        # URDF semantics: the child body frame = parent frame * joint origin
        # (pos + rot); MJCF bodies take the same transform as pos + quat.
        # T1's frames are all axis-aligned (origin_rot = I, no quat emitted);
        # rotated frames (other robots) emit the equivalent quaternion.
        quat_attr = ""
        if j:
            R = np.asarray(j["origin_rot"])
            if not np.allclose(R, np.eye(3), atol=1e-9):
                quat_attr = f' quat="{_fmt(_mat_to_quat(R))}"'
        lines.append(f'{indent}<body name={quoteattr(b["name"])} '
                     f'pos="{_fmt(pos)}"{quat_attr}>')
        if j:
            lines.append(
                f'{indent}  <joint name={quoteattr(j["name"])} type="hinge" '
                f'axis="{_fmt(j["axis"])}" pos="0 0 0" '
                f'range="{j["lower"]:.9g} {j["upper"]:.9g}" '
                f'armature="{armature:.9g}" damping="0" frictionloss="0" '
                f'limited="{"true" if limited else "false"}"/>'
            )
        else:
            lines.append(f'{indent}  <freejoint name="root"/>')
        I = np.asarray(b["inertia"])
        full = [I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2]]
        lines.append(
            f'{indent}  <inertial pos="{_fmt(b["com"])}" mass="{b["mass"]:.9g}" '
            f'fullinertia="{_fmt(full)}"/>'
        )
        geom_xml(i, indent + "  ")
        link_viz_xml(i, indent + "  ")
        for c in children[i]:
            body_xml(c, indent + "  ")
        lines.append(f"{indent}</body>")

    header = f"""<mujoco model={quoteattr(spec.get('name', 'robot'))}>
  <compiler angle="radian"/>
  <option timestep="{timestep}" gravity="0 0 -9.81"/>
  <visual>
    <headlight ambient="0.4 0.4 0.4" diffuse="0.7 0.7 0.7" specular="0.2 0.2 0.2"/>
    <rgba haze="0.85 0.9 0.95 1"/>
  </visual>
  <asset>
    <texture type="skybox" builtin="gradient" rgb1="0.5 0.7 0.95" rgb2="0.9 0.95 1" width="64" height="64"/>
    <texture name="grid" type="2d" builtin="checker" rgb1="0.30 0.35 0.40" rgb2="0.45 0.50 0.55" width="256" height="256"/>
    <material name="grid" texture="grid" texrepeat="16 16" reflectance="0.1"/>
  </asset>
  <worldbody>
    <light pos="0 0 4" dir="0 0 -1" directional="true" diffuse="0.8 0.8 0.8"/>
    <geom name="floor" type="plane" size="50 50 1" material="grid" friction="0.6 0.005 0.0001"/>
"""
    body_xml(0, "    ")
    body = "\n".join(lines)
    actuators = "\n".join(
        f'    <motor joint={quoteattr(b["joint"]["name"])} '
        f'ctrlrange="-{b["joint"]["effort"]:.9g} {b["joint"]["effort"]:.9g}" gear="1"/>'
        for b in bodies
        if b.get("joint")
    )
    return header + body + "\n  </worldbody>\n  <actuator>\n" + actuators + "\n  </actuator>\n</mujoco>\n"


def spec_file_to_mjcf(path: str, **kw) -> str:
    with open(path) as f:
        return spec_to_mjcf(json.load(f), **kw)
