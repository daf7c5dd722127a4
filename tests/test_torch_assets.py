"""The port's asset pipeline and the two checkpoint wrappers, on the CPU.

``scripts/extract_model``, ``scripts/spec_to_urdf`` and
``scripts/make_k1_urdf`` against the ``tools/`` originals (loaded from
their files; numpy only, no JAX) on the committed URDFs and specs, a
rotated joint frame and a mesh collision geom over STL files written here;
the committed URDFs of the port byte-equal to the JAX package's and the
root's; the five checks of ``tests/test_asset_roundtrip.py`` on the port's
specs and tools; each CLI; ``scripts/restore_checkpoint`` on a full
checkpoint, the committed slim lineage and a missing task;
``scripts/final_eval`` with ``eval_report`` stood in for.
"""
import importlib.util
import json
import os
import struct

import numpy as np
import pytest

from ti5_isaacgym_tpu_torch.scripts import (extract_model, final_eval, make_k1_urdf,
                                            restore_checkpoint, spec_to_urdf)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT_RES = os.path.join(ROOT, "ti5_isaacgym_tpu_torch", "resources")
JAX_T1_URDF = os.path.join(ROOT, "ti5_isaacgym_tpu", "resources", "t1", "t1.urdf")
ROOT_K1_URDF = os.path.join(ROOT, "resources", "k1", "k1.urdf")
LINEAGE_DIR = os.path.join(ROOT, "checkpoints_torch", "t1_dh_stand")


def _tool(name: str):
    """``tools/<name>.py``, loaded from its file under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"tools_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL_EXTRACT, TOOL_EMIT, TOOL_K1 = (_tool(n) for n in ("extract_model", "spec_to_urdf",
                                                       "make_k1_urdf"))


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _spec(name: str) -> dict:
    return json.loads(_read(os.path.join(PORT_RES, name)))


R90X = [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]
ROTATED = {
    "name": "rotbot",
    "bodies": [
        {"name": "base", "parent": -1, "mass": 2.0, "com": [0.0, 0.0, 0.1],
         "inertia": [[0.02, 0.0, 0.0], [0.0, 0.02, 0.0], [0.0, 0.0, 0.02]],
         "merged_links": ["base"]},
        {"name": "arm", "parent": 0, "mass": 0.5, "com": [0.0, 0.0, -0.1],
         "inertia": [[0.01, 0.0, 0.0], [0.0, 0.01, 0.0], [0.0, 0.0, 0.01]],
         "merged_links": ["arm"],
         "joint": {"name": "j1", "origin_pos": [0.0, 0.2, 0.0], "origin_rot": R90X,
                   "axis": [0.0, 0.0, 1.0], "lower": -1.0, "upper": 1.0, "effort": 10.0,
                   "velocity": 5.0}},
    ],
    "collision_points": [{"body": 1, "pos": [0.0, 0.0, -0.2], "src": "arm"}],
    "base_body": 0, "feet_bodies": [1], "knee_bodies": [],
    "termination_bodies": [0], "penalized_bodies": [0],
}


def _write_stls(mesh_dir: str):
    """A binary STL (two triangles) and an ASCII one (one triangle)."""
    os.makedirs(mesh_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    tris = rng.uniform(-0.1, 0.1, size=(2, 3, 3)).astype("<f4")
    rec = np.zeros(2, dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
    rec["v"] = tris
    with open(os.path.join(mesh_dir, "foot.STL"), "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", 2) + rec.tobytes())
    with open(os.path.join(mesh_dir, "shin.stl"), "w") as f:
        f.write("solid shin\n facet normal 0 0 1\n  outer loop\n   vertex 0.01 -0.02 0.0\n"
                "   vertex 0.03 0.02 -0.25\n   vertex -0.01 0.0 -0.3\n  endloop\n"
                " endfacet\nendsolid shin\n")


MESH_URDF = """<?xml version="1.0"?>
<robot name="meshbot">
  <link name="base_link">
    <inertial><origin xyz="0 0 0.1" rpy="0 0 0"/><mass value="3"/>
      <inertia ixx="0.03" ixy="0" ixz="0" iyy="0.03" iyz="0" izz="0.02"/></inertial>
  </link>
  <joint name="leg_l4_joint" type="revolute">
    <origin xyz="0 0.1 -0.05" rpy="0 0 0"/><parent link="base_link"/>
    <child link="leg_l4_link"/><axis xyz="0 1 0"/>
    <limit lower="0" upper="2" effort="100" velocity="10"/>
  </joint>
  <link name="leg_l4_link">
    <inertial><origin xyz="0 0 -0.15" rpy="0.1 0 0"/><mass value="1.5"/>
      <inertia ixx="0.01" ixy="0.001" ixz="0" iyy="0.012" iyz="0" izz="0.002"/></inertial>
    <collision><origin xyz="0 0 0" rpy="0 0 0.2"/>
      <geometry><mesh filename="package://meshbot/meshes/shin.stl"/></geometry></collision>
  </link>
  <joint name="leg_l6_joint" type="revolute">
    <origin xyz="0 0 -0.3" rpy="0 0 0"/><parent link="leg_l4_link"/>
    <child link="leg_l6_link"/><axis xyz="1 0 0"/>
    <limit lower="-0.5" upper="0.5" effort="30" velocity="12"/>
  </joint>
  <link name="leg_l6_link">
    <inertial><origin xyz="0.02 0 -0.03" rpy="0 0 0"/><mass value="0.6"/>
      <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.003" iyz="0" izz="0.003"/></inertial>
    <collision><origin xyz="0.02 0 -0.04" rpy="0 0.1 0"/>
      <geometry><mesh filename="package://meshbot/meshes/foot.STL"/></geometry></collision>
  </link>
  <joint name="toe_joint" type="fixed">
    <origin xyz="0.1 0 -0.05" rpy="0 0 0"/><parent link="leg_l6_link"/>
    <child link="toe_link"/>
  </joint>
  <link name="toe_link">
    <inertial><origin xyz="0 0 0" rpy="0 0 0"/><mass value="0.1"/>
      <inertia ixx="0.0001" ixy="0" ixz="0" iyy="0.0001" iyz="0" izz="0.0001"/></inertial>
    <collision><geometry><sphere radius="0.01"/></geometry></collision>
  </link>
</robot>
"""


def _urdf_case(case: str, tmp_path) -> tuple:
    """(urdf path, mesh dir or None) of an extraction case."""
    if case == "t1":
        return JAX_T1_URDF, None
    if case == "k1":
        return ROOT_K1_URDF, None
    path = str(tmp_path / f"{case}.urdf")
    with open(path, "w") as f:
        f.write(TOOL_EMIT.spec_to_urdf(ROTATED) if case == "rotated" else MESH_URDF)
    if case == "rotated":
        return path, None
    mesh_dir = str(tmp_path / "stl")
    _write_stls(mesh_dir)
    return path, mesh_dir


@pytest.mark.parametrize("case", ["t1", "k1", "rotated", "mesh"])
def test_extract_matches_the_tool(case, tmp_path):
    urdf, mesh_dir = _urdf_case(case, tmp_path)
    got = extract_model.extract(urdf, mesh_dir)
    assert json.dumps(got, indent=1) == json.dumps(TOOL_EXTRACT.extract(urdf, mesh_dir),
                                                    indent=1)
    if case == "mesh":
        # the shin's mesh box gives 8 corners, the foot's sole 4, the toe's
        # sphere (merged into the foot) 1
        assert [c["src"] for c in got["collision_points"]] == \
            ["leg_l4_link"] * 8 + ["leg_l6_link"] * 4 + ["toe_link"]
        assert got["bodies"][2]["merged_links"] == ["leg_l6_link", "toe_link"]
        assert got["feet_bodies"] == [2] and got["knee_bodies"] == [1]


@pytest.mark.parametrize("name", ["t1_model.json", "k1_model.json", "rotated"])
def test_spec_to_urdf_matches_the_tool(name):
    spec = ROTATED if name == "rotated" else _spec(name)
    assert spec_to_urdf.spec_to_urdf(spec) == TOOL_EMIT.spec_to_urdf(spec)


def test_k1_build_matches_the_tool():
    assert make_k1_urdf.build() == TOOL_K1.build()


@pytest.mark.parametrize("port, reference", [
    (os.path.join(PORT_RES, "t1", "t1.urdf"), JAX_T1_URDF),
    (os.path.join(PORT_RES, "k1", "k1.urdf"), ROOT_K1_URDF)], ids=["t1", "k1"])
def test_committed_urdfs_are_the_reference_copies(port, reference):
    with open(port, "rb") as f, open(reference, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("case", ["k1_spec", "t1_urdf"])
def test_pipeline_reproduces_the_committed_files(case, tmp_path):
    """K1's generator and extractor give the committed spec, the emitter on
    the committed T1 spec gives the committed URDF, byte for byte."""
    if case == "k1_spec":
        path = str(tmp_path / "k1.urdf")
        with open(path, "w") as f:
            f.write(make_k1_urdf.build())
        assert json.dumps(extract_model.extract(path), indent=1) == \
            _read(os.path.join(PORT_RES, "k1_model.json"))
    else:
        assert spec_to_urdf.spec_to_urdf(_spec("t1_model.json")) == \
            _read(os.path.join(PORT_RES, "t1", "t1.urdf"))


def _roundtrip(spec: dict, tmp_path) -> dict:
    path = str(tmp_path / "roundtrip.urdf")
    with open(path, "w") as f:
        f.write(spec_to_urdf.spec_to_urdf(spec))
    return extract_model.extract(path)


def _collision_points(spec: dict) -> list:
    return sorted((c["body"], *np.round(c["pos"], 6)) for c in spec["collision_points"])


@pytest.mark.parametrize("name", ["t1_model.json", "k1_model.json"])
def test_spec_urdf_roundtrip(name, tmp_path):
    """``tests/test_asset_roundtrip.py``'s T1 and K1 round trips on the
    port's specs and tools, at its tolerances."""
    spec0 = _spec(name)
    spec1 = _roundtrip(spec0, tmp_path)
    assert len(spec0["bodies"]) == len(spec1["bodies"]) == 13
    for b0, b1 in zip(spec0["bodies"], spec1["bodies"]):
        assert (b0["name"], b0["parent"]) == (b1["name"], b1["parent"])
        np.testing.assert_allclose(b0["mass"], b1["mass"], atol=1e-9)
        np.testing.assert_allclose(b0["com"], b1["com"], atol=1e-8)
        np.testing.assert_allclose(b0["inertia"], b1["inertia"], atol=1e-8)
        j0, j1 = b0.get("joint"), b1.get("joint")
        assert (j0 is None) == (j1 is None)
        if j0:
            assert j0["name"] == j1["name"]
            for k in ("lower", "upper", "effort", "velocity"):
                assert j0[k] == j1[k], (j0["name"], k)
            np.testing.assert_allclose(j0["origin_pos"], j1["origin_pos"], atol=1e-9)
            np.testing.assert_allclose(j0["axis"], j1["axis"], atol=1e-9)
            np.testing.assert_allclose(j0["origin_rot"], j1["origin_rot"], atol=1e-8)
    assert _collision_points(spec0) == _collision_points(spec1)
    for k in ("base_body", "feet_bodies", "knee_bodies", "termination_bodies",
              "penalized_bodies"):
        assert spec0[k] == spec1[k], k


def test_shipped_urdf_matches_spec():
    assert _read(os.path.join(PORT_RES, "t1", "t1.urdf")) == \
        spec_to_urdf.spec_to_urdf(_spec("t1_model.json"))


def test_t1_urdf_loads_in_mujoco():
    mujoco = pytest.importorskip("mujoco")
    model = mujoco.MjModel.from_xml_path(os.path.join(PORT_RES, "t1", "t1.urdf"))
    assert model.njnt == 12
    # MuJoCo's URDF importer welds the root link into the world body
    moving = sum(b["mass"] for b in _spec("t1_model.json")["bodies"] if b["parent"] >= 0)
    np.testing.assert_allclose(model.body_mass.sum(), moving, rtol=1e-6)


def test_rotated_joint_frame_spec(tmp_path):
    """A rotated joint frame survives the round trip, and the port's MJCF
    emitter maps the child's z hinge onto the parent's -y."""
    spec1 = _roundtrip(ROTATED, tmp_path)
    np.testing.assert_allclose(spec1["bodies"][1]["joint"]["origin_rot"], R90X, atol=1e-8)
    mujoco = pytest.importorskip("mujoco")
    from ti5_isaacgym_tpu_torch.export.mjcf import spec_to_mjcf

    model = mujoco.MjModel.from_xml_string(spec_to_mjcf(ROTATED))
    data = mujoco.MjData(model)
    mujoco.mj_forward(model, data)
    jid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_JOINT, "j1")
    np.testing.assert_allclose(data.xaxis[jid], [0.0, -1.0, 0.0], atol=1e-9)


@pytest.mark.parametrize("cli", ["extract_model", "spec_to_urdf", "make_k1_urdf"])
def test_cli_writes_its_file_and_line(cli, tmp_path, capsys):
    out = str(tmp_path / ("out.json" if cli == "extract_model" else "out.urdf"))
    if cli == "extract_model":
        extract_model.main([ROOT_K1_URDF, "-o", out])
        want = _read(os.path.join(PORT_RES, "k1_model.json"))
        line = f"wrote {out}: 13 bodies, 12 dofs, 16 contact points"
    elif cli == "spec_to_urdf":
        spec_to_urdf.main([os.path.join(PORT_RES, "t1_model.json"), "-o", out])
        want = _read(os.path.join(PORT_RES, "t1", "t1.urdf"))
        n_cp = len(_spec("t1_model.json")["collision_points"])
        line = f"wrote {out}: 13 links, 12 revolute joints, {n_cp} contact spheres"
    else:
        out = str(tmp_path / "sub" / "k1.urdf")
        make_k1_urdf.main(["-o", out])
        want, line = _read(ROOT_K1_URDF), f"wrote {out}"
    assert _read(out) == want
    assert capsys.readouterr().out.strip() == line


def test_make_k1_urdf_defaults_to_the_port_resources():
    assert make_k1_urdf.DEFAULT_OUT == os.path.join(PORT_RES, "k1", "k1.urdf")


@pytest.fixture(scope="module")
def full_checkpoint(tmp_path_factory):
    """A full ``OnPolicyRunner.save`` payload of a fresh carry at 4 envs of
    the task on a 2x2 terrain."""
    import dataclasses

    import torch

    from ti5_isaacgym_tpu_torch.algo.runner import OnPolicyRunner
    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    cls, env_cfg, train_cfg = task_registry._get("t1_dh_stand")
    cfg = dataclasses.replace(
        env_cfg, env=dataclasses.replace(env_cfg.env, num_envs=4),
        terrain=dataclasses.replace(env_cfg.terrain, num_rows=2, num_cols=2, border_size=2.0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runner = OnPolicyRunner(cls(cfg, seed=0, device="cpu"), cfg, train_cfg, verbose=False)
        path = str(tmp_path_factory.mktemp("full") / "model_7.pt")
        runner.save(runner.init_carry(), path)
    finally:
        torch.set_num_threads(threads)
    return path


@pytest.mark.parametrize("case", ["full", "slim", "missing"])
def test_restore_checkpoint(case, tmp_path, full_checkpoint, capsys):
    """A full checkpoint is copied under the log root without overwriting
    what is there; the committed slim lineage is refused; a task with no
    committed directory fails."""
    import shutil

    logs = str(tmp_path / "logs")
    if case == "slim":
        rc = restore_checkpoint.main(["--log_root", logs])
        assert rc == 1 and "SLIM" in capsys.readouterr().err
        assert not os.path.exists(logs)
        assert os.path.isdir(LINEAGE_DIR)
        return
    ckpts = str(tmp_path / "ckpts")
    if case == "missing":
        rc = restore_checkpoint.main(["t1_flat", "--ckpt_root", ckpts, "--log_root", logs])
        assert rc == 1 and "no committed checkpoints for t1_flat" in capsys.readouterr().err
        return
    run = os.path.join(ckpts, "t1_dh_stand", "Jan01_00-00-00_x")
    os.makedirs(run)
    shutil.copy(full_checkpoint, os.path.join(run, "model_7.pt"))
    with open(os.path.join(run, "metrics.csv"), "w") as f:
        f.write("iteration\n7\n")
    kept = os.path.join(logs, "t1_dh_stand", "Jan01_00-00-00_x", "metrics.csv")
    os.makedirs(os.path.dirname(kept))
    with open(kept, "w") as f:
        f.write("mine\n")
    rc = restore_checkpoint.main(["--ckpt_root", ckpts, "--log_root", logs])
    restored = os.path.join(os.path.dirname(kept), "model_7.pt")
    assert rc == 0 and _read(kept) == "mine\n"
    with open(restored, "rb") as f, open(full_checkpoint, "rb") as g:
        assert f.read() == g.read()
    assert capsys.readouterr().out.split() == ["restored:", restored]


@pytest.mark.parametrize("rc", [0, 1])
def test_final_eval(rc, tmp_path, monkeypatch, capsys):
    """``final_eval`` hands the newest run, the steps, ``--out`` and
    ``--device`` to ``eval_report`` and returns its exit code."""
    logs = tmp_path / "logs"
    old, new = (logs / "t1_dh_stand" / name for name in ("Jan01_00-00-00_a", "Jan02_00-00-00_b"))
    for i, d in enumerate((old, new)):
        d.mkdir(parents=True)
        os.utime(d, (1e9 + i, 1e9 + i))
    calls = []

    def report(argv):
        calls.append(argv)
        os.makedirs(argv[3], exist_ok=True)
        with open(os.path.join(argv[3], "EVAL.md"), "w") as f:
            f.write("# report\n")
        if rc:
            raise SystemExit(rc)

    monkeypatch.setattr(final_eval.eval_report, "main", report)
    out = str(tmp_path / "out")
    assert final_eval.main(["--log_root", str(logs), "--out", out, "--device", "cpu"]) == rc
    assert calls == [["--run", str(new), "--out", out, "--steps", "600", "--device", "cpu"]]
    printed = capsys.readouterr().out
    assert f"evaluating {new} (600 steps)" in printed and f"eval_report rc={rc}" in printed
    assert "EVAL.md" in printed
    assert final_eval.main([str(old), "50", "--log_root", str(logs), "--out", out,
                            "--device", "cpu"]) == rc
    assert calls[-1][:2] == ["--run", str(old)] and calls[-1][5] == "50"
    assert not final_eval.get_args([]).out.startswith("eval_round")
