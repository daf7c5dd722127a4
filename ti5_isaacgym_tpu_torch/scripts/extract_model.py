"""URDF -> model-spec JSON extractor (port of ``tools/extract_model.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.extract_model <robot.urdf> \
        -o ti5_isaacgym_tpu_torch/resources/k1_model.json [--mesh-dir DIR]

The asset-ingestion tool: the role the Isaac Gym asset loader plays in the
reference (``gym.load_asset`` + ``collapse_fixed_joints`` + asset property
queries, reference ``humanoid/envs/base/legged_robot.py:1304-1320``), run
offline, emitting the compact JSON spec that :mod:`..physics.model` loads.

What it does:
  * parses links/joints from a URDF (xml.etree, no external deps),
  * collapses fixed-joint subtrees into their movable parent, merging masses,
    CoMs and rotational inertias (parallel-axis theorem),
  * converts box collision geoms into corner contact points; mesh collision
    geoms are approximated by their STL bounding box (bottom face corners for
    feet: the sole rectangle is what touches the ground); a mesh is looked up
    by its base name in ``--mesh-dir`` (default ``<urdf dir>/../meshes``) and
    skipped when it is not there,
  * records actuated-joint limits/efforts/velocities in document order (the
    same DoF ordering the PD controller and observations use).

The JSON is written with ``json.dump(spec, f, indent=1)``, so
``resources/k1/k1.urdf`` extracts to ``resources/k1_model.json`` byte for
byte.  Host-side numpy and the standard library only.
"""
from __future__ import annotations

import argparse
import json
import os
import struct as _struct
import xml.etree.ElementTree as ET

import numpy as np


def _vec(s, default="0 0 0"):
    return np.array([float(x) for x in (s or default).split()], dtype=np.float64)


def _rpy_to_mat(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _stl_bbox(path):
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        import re

        with open(path, errors="ignore") as f:
            txt = f.read()
        vs = np.array(re.findall(r"vertex\s+(\S+)\s+(\S+)\s+(\S+)", txt), dtype=float)
        if len(vs):
            return vs.min(0), vs.max(0)
    with open(path, "rb") as f:
        data = f.read()
    n = _struct.unpack("<I", data[80:84])[0]
    arr = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84).reshape(n, 50)
    v = np.frombuffer(arr[:, 12:48].tobytes(), dtype="<f4").reshape(n, 3, 3).reshape(-1, 3)
    return v.min(0).astype(float), v.max(0).astype(float)


def _parse_inertial(link):
    ine = link.find("inertial")
    if ine is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    o = ine.find("origin")
    com = _vec(o.get("xyz") if o is not None else None)
    R = _rpy_to_mat(_vec(o.get("rpy") if o is not None else None))
    m = float(ine.find("mass").get("value"))
    it = ine.find("inertia")
    I = np.array(
        [
            [float(it.get("ixx")), float(it.get("ixy")), float(it.get("ixz"))],
            [float(it.get("ixy")), float(it.get("iyy")), float(it.get("iyz"))],
            [float(it.get("ixz")), float(it.get("iyz")), float(it.get("izz"))],
        ]
    )
    return m, com, R @ I @ R.T


def _merge_inertials(items):
    """items: list of (mass, com, I_com) all in one common frame."""
    M = sum(m for m, _, _ in items)
    if M <= 0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = sum(m * c for m, c, _ in items) / M
    I = np.zeros((3, 3))
    for m, c, Ic in items:
        d = c - com
        I += Ic + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return M, com, I


def _box_corners(size, pos, R):
    sx, sy, sz = size / 2.0
    pts = []
    for dx in (-sx, sx):
        for dy in (-sy, sy):
            for dz in (-sz, sz):
                pts.append(pos + R @ np.array([dx, dy, dz]))
    return pts


def extract(urdf_path: str, mesh_dir: str | None = None) -> dict:
    tree = ET.parse(urdf_path)
    root = tree.getroot()
    links = {l.get("name"): l for l in root.findall("link")}
    joints = list(root.findall("joint"))
    children = {}  # parent link name -> [(joint, child name)]
    has_parent = set()
    for j in joints:
        pl = j.find("parent").get("link")
        cl = j.find("child").get("link")
        children.setdefault(pl, []).append((j, cl))
        has_parent.add(cl)
    root_link = next(n for n in links if n not in has_parent)

    if mesh_dir is None:
        mesh_dir = os.path.join(os.path.dirname(os.path.abspath(urdf_path)), "..", "meshes")

    # Collect collision geoms of a single link, in that link's frame.
    def link_geoms(name):
        out = []
        for col in links[name].findall("collision"):
            o = col.find("origin")
            pos = _vec(o.get("xyz") if o is not None else None)
            R = _rpy_to_mat(_vec(o.get("rpy") if o is not None else None))
            g = col.find("geometry")
            box = g.find("box")
            mesh = g.find("mesh")
            sphere = g.find("sphere")
            if box is not None:
                out.append(("box", _vec(box.get("size")), pos, R))
            elif sphere is not None:
                out.append(("sphere", float(sphere.get("radius")), pos, R))
            elif mesh is not None:
                fn = os.path.basename(mesh.get("filename"))
                p = os.path.join(mesh_dir, fn)
                if os.path.exists(p):
                    lo, hi = _stl_bbox(p)
                    out.append(("meshbox", (lo, hi), pos, R))
        return out

    # Recursively fold fixed-joint subtrees into their movable root.
    def collect_fixed(name, X_pos, X_rot, inertials, geoms, merged_names):
        m, c, I = _parse_inertial(links[name])
        inertials.append((m, X_pos + X_rot @ c, X_rot @ I @ X_rot.T))
        merged_names.append(name)
        for g in link_geoms(name):
            kind, data, pos, R = g
            geoms.append((kind, data, X_pos + X_rot @ pos, X_rot @ R, name))
        for j, cl in children.get(name, []):
            if j.get("type") != "fixed":
                continue
            o = j.find("origin")
            jp = _vec(o.get("xyz") if o is not None else None)
            jR = _rpy_to_mat(_vec(o.get("rpy") if o is not None else None))
            collect_fixed(cl, X_pos + X_rot @ jp, X_rot @ jR, inertials, geoms, merged_names)

    bodies = []  # spec dicts
    body_index = {}

    def add_body(link_name, parent_idx, joint_el):
        inertials, geoms, merged = [], [], []
        collect_fixed(link_name, np.zeros(3), np.eye(3), inertials, geoms, merged)
        m, c, I = _merge_inertials(inertials)
        b = {
            "name": link_name,
            "parent": parent_idx,
            "mass": round(float(m), 9),
            "com": [round(float(x), 9) for x in c],
            "inertia": [[round(float(x), 9) for x in row] for row in I],
            "merged_links": merged,
            "_geoms": geoms,
        }
        if joint_el is not None:
            o = joint_el.find("origin")
            lim = joint_el.find("limit")
            b["joint"] = {
                "name": joint_el.get("name"),
                "origin_pos": [float(x) for x in _vec(o.get("xyz") if o is not None else None)],
                "origin_rot": [[float(x) for x in row] for row in _rpy_to_mat(_vec(o.get("rpy") if o is not None else None))],
                "axis": [float(x) for x in _vec(joint_el.find("axis").get("xyz") if joint_el.find("axis") is not None else "1 0 0")],
                "lower": float(lim.get("lower") or 0.0),
                "upper": float(lim.get("upper") or 0.0),
                "effort": float(lim.get("effort") or 0.0),
                "velocity": float(lim.get("velocity") or 0.0),
            }
        idx = len(bodies)
        bodies.append(b)
        body_index[link_name] = idx
        # recurse into movable children of every merged link
        for ln in merged:
            for j, cl in children.get(ln, []):
                if j.get("type") == "fixed":
                    continue
                # child joint origin must be expressed relative to the movable
                # root frame if the merged link is offset — for the T1 all
                # movable joints hang off un-merged links directly, but handle
                # the general case by composing transforms.
                if ln != link_name:
                    raise NotImplementedError(
                        "movable joint on a collapsed fixed link is not supported yet"
                    )
                add_body(cl, idx, j)

    add_body(root_link, -1, None)

    # collision points from geoms
    cps = []
    for idx, b in enumerate(bodies):
        for kind, data, pos, R, src in b.pop("_geoms"):
            if kind == "box":
                for p in _box_corners(np.asarray(data, dtype=float), pos, R):
                    cps.append({"body": idx, "pos": [round(float(x), 6) for x in p], "src": src})
            elif kind == "sphere":
                cps.append({"body": idx, "pos": [round(float(x), 6) for x in pos], "src": src})
            elif kind == "meshbox":
                lo, hi = data
                # feet: the sole (bottom face) is the contact surface
                zs = [lo[2]] if "ANKLE" in src or "6_link" in bodies[idx]["name"] else [lo[2], hi[2]]
                for dx in (lo[0], hi[0]):
                    for dy in (lo[1], hi[1]):
                        for dz in zs:
                            p = pos + R @ np.array([dx, dy, dz])
                            cps.append({"body": idx, "pos": [round(float(x), 6) for x in p], "src": src})

    names = [b["name"] for b in bodies]
    spec = {
        "name": root.get("name"),
        "bodies": bodies,
        "collision_points": cps,
        "base_body": 0,
        "feet_bodies": [i for i, n in enumerate(names) if n.endswith("6_link")],
        "knee_bodies": [i for i, n in enumerate(names) if n.endswith("4_link")],
        "termination_bodies": [0],
        "penalized_bodies": [0],
    }
    return spec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("ti5 torch extract_model")
    ap.add_argument("urdf")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--mesh-dir", default=None)
    args = ap.parse_args(argv)
    spec = extract(args.urdf, args.mesh_dir)
    with open(args.out, "w") as f:
        json.dump(spec, f, indent=1)
    nb = len(spec["bodies"])
    print(f"wrote {args.out}: {nb} bodies, {nb-1} dofs, {len(spec['collision_points'])} contact points")
    return spec


if __name__ == "__main__":
    main()
