"""Model-spec JSON -> URDF inverse emitter (port of ``tools/spec_to_urdf.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.spec_to_urdf \
        ti5_isaacgym_tpu_torch/resources/t1_model.json \
        -o ti5_isaacgym_tpu_torch/resources/t1/t1.urdf

The port's canonical robot description is the model-spec JSON
(``resources/t1_model.json``, ``resources/k1_model.json``).  This tool emits
a standalone URDF equivalent to a spec: one link per (collapsed) body,
inertials with the full rotational inertia, every collision point as a
small sphere geom, and the actuated revolute joints with their limits, so
the asset pipeline round-trips in the package:

    spec --[this tool]--> URDF --[scripts/extract_model.py]--> spec'

(``spec'`` equals ``spec`` up to float formatting:
``tests/test_torch_assets.py``).  The committed ``resources/t1/t1.urdf`` is
this tool's output for ``resources/t1_model.json``.  The URDF loads in
third-party tooling (MuJoCo's URDF importer, pinocchio, RViz-style
viewers): its collision geometry is primitive spheres, no meshes.  Role in
the reference: ``resources/robots/t1/urdf/t1.urdf`` consumed by
``gym.load_asset`` (reference ``humanoid/envs/base/legged_robot.py:1304``).
Host-side numpy and the standard library only.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _fmt(v) -> str:
    return " ".join(f"{float(x):.9g}" for x in np.atleast_1d(v))


def _mat_to_rpy(R: np.ndarray) -> np.ndarray:
    """Inverse of ``extract_model._rpy_to_mat`` (R = Rz(y) @ Ry(p) @ Rx(r))."""
    R = np.asarray(R, dtype=float)
    p = float(np.arcsin(np.clip(-R[2, 0], -1.0, 1.0)))
    if abs(R[2, 0]) < 1.0 - 1e-9:
        r = float(np.arctan2(R[2, 1], R[2, 2]))
        y = float(np.arctan2(R[1, 0], R[0, 0]))
    else:  # gimbal lock: fold yaw into roll
        r = float(np.arctan2(-R[1, 2], R[1, 1]))
        y = 0.0
    return np.array([r, p, y])


def spec_to_urdf(spec: dict, contact_radius: float = 0.005) -> str:
    bodies = spec["bodies"]
    cps_by_body: list[list] = [[] for _ in bodies]
    for c in spec.get("collision_points", []):
        cps_by_body[c["body"]].append(c["pos"])

    out = [f'<?xml version="1.0"?>', f'<robot name="{spec.get("name", "robot")}">']
    for i, b in enumerate(bodies):
        out.append(f'  <link name="{b["name"]}">')
        I = np.asarray(b["inertia"], dtype=float)
        out.append("    <inertial>")
        out.append(f'      <origin xyz="{_fmt(b["com"])}" rpy="0 0 0"/>')
        out.append(f'      <mass value="{float(b["mass"]):.9g}"/>')
        out.append(
            f'      <inertia ixx="{I[0,0]:.9g}" ixy="{I[0,1]:.9g}" '
            f'ixz="{I[0,2]:.9g}" iyy="{I[1,1]:.9g}" iyz="{I[1,2]:.9g}" '
            f'izz="{I[2,2]:.9g}"/>')
        out.append("    </inertial>")
        for p in cps_by_body[i]:
            out.append("    <collision>")
            out.append(f'      <origin xyz="{_fmt(p)}" rpy="0 0 0"/>')
            out.append("      <geometry>")
            out.append(f'        <sphere radius="{contact_radius:.9g}"/>')
            out.append("      </geometry>")
            out.append("    </collision>")
        out.append("  </link>")
        j = b.get("joint")
        if j is not None:
            rpy = _mat_to_rpy(np.asarray(j["origin_rot"]))
            out.append(f'  <joint name="{j["name"]}" type="revolute">')
            out.append(f'    <origin xyz="{_fmt(j["origin_pos"])}" rpy="{_fmt(rpy)}"/>')
            out.append(f'    <parent link="{bodies[b["parent"]]["name"]}"/>')
            out.append(f'    <child link="{b["name"]}"/>')
            out.append(f'    <axis xyz="{_fmt(j["axis"])}"/>')
            out.append(
                f'    <limit lower="{j["lower"]:.9g}" upper="{j["upper"]:.9g}" '
                f'effort="{j["effort"]:.9g}" velocity="{j["velocity"]:.9g}"/>')
            out.append("  </joint>")
    out.append("</robot>")
    return "\n".join(out) + "\n"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser("ti5 torch spec_to_urdf")
    ap.add_argument("spec")
    ap.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    urdf = spec_to_urdf(spec)
    with open(args.out, "w") as f:
        f.write(urdf)
    nj = sum(1 for b in spec["bodies"] if b.get("joint"))
    print(f"wrote {args.out}: {len(spec['bodies'])} links, {nj} revolute joints, "
          f"{len(spec.get('collision_points', []))} contact spheres")
    return urdf


if __name__ == "__main__":
    main()
