"""Generate the K1 humanoid URDF, the second robot asset (port of
``tools/make_k1_urdf.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.make_k1_urdf \
        [-o ti5_isaacgym_tpu_torch/resources/k1/k1.urdf]

K1 is a taller, lighter 12-DoF biped (the T1's hip-yaw/roll/pitch + knee +
ankle-pitch/roll topology, so the gait reference machinery applies
unchanged) with other link lengths, masses, limits and efforts.  It proves
the asset pipeline end to end on a robot that is not the reference's:
URDF -> ``scripts/extract_model.py`` -> model-spec JSON
(``resources/k1_model.json``, byte for byte) -> the engine -> the registered
task ``k1_dh_stand``.

The file is generated rather than hand-typed so geometry and (rod/box)
inertias stay consistent by construction.  The standard library only.
"""
from __future__ import annotations

import argparse
import os

# segment lengths [m] — deliberately longer-limbed than T1
HIP_YAW_DROP = 0.06      # base -> hip yaw joint, downwards
HIP_SPACING = 0.11       # half hip width
HIP_ROLL_DROP = 0.07
HIP_PITCH_DROP = 0.045
THIGH_LEN = 0.40
SHANK_LEN = 0.42
ANKLE_DROP = 0.045
FOOT_BOX = (0.21, 0.10, 0.035)   # sole x, y, thickness
FOOT_FWD = 0.04                  # foot box center forward offset
TORSO_BOX = (0.22, 0.30, 0.42)
TORSO_MASS = 15.5
HEAD_MASS = 1.2
DEFAULT_OUT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                            "resources", "k1", "k1.urdf"))


def rod_inertia(m, L):
    """Slender rod about its center, axis along z, with a realistic floor:
    actuator housings dominate the inertia of short links, so values below
    ~1.5e-3 kg m^2 (cf. the T1's smallest link inertias) are clamped — they
    would also make the 1 kHz explicit integration marginally stable."""
    i = max(m * L * L / 12.0, 1.5e-3)
    return (i, i, max(m * 0.0008, 1.5e-3))


def box_inertia(m, x, y, z):
    return (m * (y * y + z * z) / 12.0,
            m * (x * x + z * z) / 12.0,
            m * (x * x + y * y) / 12.0)


def link_xml(name, mass, com, inertia, geom=""):
    ixx, iyy, izz = inertia
    return f"""  <link name="{name}">
    <inertial>
      <origin xyz="{com[0]} {com[1]} {com[2]}" rpy="0 0 0"/>
      <mass value="{mass}"/>
      <inertia ixx="{ixx:.6f}" ixy="0" ixz="0" iyy="{iyy:.6f}" iyz="0" izz="{izz:.6f}"/>
    </inertial>
{geom}  </link>
"""


def joint_xml(name, jtype, parent, child, origin, axis=None, limit=None):
    ax = f'    <axis xyz="{axis}"/>\n' if axis else ""
    lim = ""
    if limit:
        lo, hi, eff, vel = limit
        lim = f'    <limit lower="{lo}" upper="{hi}" effort="{eff}" velocity="{vel}"/>\n'
    return (f'  <joint name="{name}" type="{jtype}">\n'
            f'    <origin xyz="{origin[0]} {origin[1]} {origin[2]}" rpy="0 0 0"/>\n'
            f'    <parent link="{parent}"/>\n    <child link="{child}"/>\n'
            f"{ax}{lim}  </joint>\n")


def leg(side: str, sign: int) -> str:
    s = side
    out = []
    # 1: hip yaw
    out.append(joint_xml(f"leg_{s}1_joint", "revolute", "base_link", f"leg_{s}1_link",
                         (0.0, sign * HIP_SPACING, -HIP_YAW_DROP), "0 0 1",
                         (-0.6, 0.6, 60, 12)))
    out.append(link_xml(f"leg_{s}1_link", 1.1, (0, 0, -HIP_ROLL_DROP / 2),
                        rod_inertia(1.1, HIP_ROLL_DROP)))
    # 2: hip roll
    out.append(joint_xml(f"leg_{s}2_joint", "revolute", f"leg_{s}1_link", f"leg_{s}2_link",
                         (0.0, 0.0, -HIP_ROLL_DROP), "1 0 0",
                         (-0.35, 0.35, 90, 12)))
    out.append(link_xml(f"leg_{s}2_link", 1.4, (0, 0, -HIP_PITCH_DROP / 2),
                        rod_inertia(1.4, HIP_PITCH_DROP)))
    # 3: hip pitch -> thigh
    out.append(joint_xml(f"leg_{s}3_joint", "revolute", f"leg_{s}2_link", f"leg_{s}3_link",
                         (0.0, 0.0, -HIP_PITCH_DROP), "0 1 0",
                         (-1.2, 1.2, 160, 14)))
    out.append(link_xml(f"leg_{s}3_link", 2.6, (0, 0, -THIGH_LEN / 2),
                        rod_inertia(2.6, THIGH_LEN)))
    # 4: knee -> shank
    out.append(joint_xml(f"leg_{s}4_joint", "revolute", f"leg_{s}3_link", f"leg_{s}4_link",
                         (0.0, 0.0, -THIGH_LEN), "0 1 0",
                         (0.0, 2.2, 160, 16)))
    out.append(link_xml(f"leg_{s}4_link", 1.6, (0, 0, -SHANK_LEN / 2),
                        rod_inertia(1.6, SHANK_LEN)))
    # 5: ankle pitch
    out.append(joint_xml(f"leg_{s}5_joint", "revolute", f"leg_{s}4_link", f"leg_{s}5_link",
                         (0.0, 0.0, -SHANK_LEN), "0 1 0",
                         (-1.1, 1.1, 55, 14)))
    out.append(link_xml(f"leg_{s}5_link", 0.4, (0, 0, -ANKLE_DROP / 2),
                        rod_inertia(0.4, ANKLE_DROP)))
    # 6: ankle roll -> foot (box collision: the extractor turns it into
    # corner contact points)
    fx, fy, fz = FOOT_BOX
    geom = (f'    <collision>\n'
            f'      <origin xyz="{FOOT_FWD} 0 {-fz / 2}" rpy="0 0 0"/>\n'
            f'      <geometry><box size="{fx} {fy} {fz}"/></geometry>\n'
            f'    </collision>\n')
    out.append(joint_xml(f"leg_{s}6_joint", "revolute", f"leg_{s}5_link", f"leg_{s}6_link",
                         (0.0, 0.0, -ANKLE_DROP), "1 0 0",
                         (-0.6, 0.6, 30, 14)))
    out.append(link_xml(f"leg_{s}6_link", 0.55, (FOOT_FWD, 0, -fz / 2),
                        box_inertia(0.55, *FOOT_BOX), geom))
    return "".join(out)


def build() -> str:
    tb = TORSO_BOX
    parts = ['<?xml version="1.0"?>\n<robot name="k1">\n']
    # torso CoM slightly forward so the whole-robot CoM sits over the foot
    # centers (feet boxes are centered FOOT_FWD ahead of the ankle)
    parts.append(link_xml("base_link", TORSO_MASS, (0.045, 0.0, 0.16),
                          box_inertia(TORSO_MASS, *tb)))
    # fixed head exercises the fixed-joint collapse path of the extractor
    parts.append(joint_xml("head_joint", "fixed", "base_link", "head_link",
                           (0.0, 0.0, 0.45)))
    parts.append(link_xml("head_link", HEAD_MASS, (0, 0, 0.06),
                          box_inertia(HEAD_MASS, 0.14, 0.14, 0.16)))
    parts.append(leg("l", +1))
    parts.append(leg("r", -1))
    parts.append("</robot>\n")
    return "".join(parts)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser("ti5 torch make_k1_urdf")
    ap.add_argument("-o", "--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(build())
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
