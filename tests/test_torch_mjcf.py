"""Port parity: export/mjcf.py against the JAX package, and MuJoCo as the
oracle of the port's dynamics.

* The XML of ``spec_to_mjcf`` / ``spec_file_to_mjcf`` is byte-equal to the
  JAX package's for T1's and K1's specs (the port's own copies under
  ``ti5_isaacgym_tpu_torch/resources``) in every combination of
  ``with_geoms``, ``limited`` and ``armature``, and for a spec with rotated
  joint frames (neither robot has one), whose quaternions come from
  ``_mat_to_quat``.
* The checks of ``tests/test_mjcf.py`` on the port's model: radian joint
  ranges, an airborne PD reaching its target pose, no self-collision.
* The port's torch ``fk`` and ``aba`` (float32) against MuJoCo's on random
  states of both robots, with ``tests/test_dynamics.py:52-117``'s
  tolerances: positions and rotations atol 1e-5, accelerations rtol and atol
  2e-3.
"""
import copy
import itertools
import json
import os

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from ti5_isaacgym_tpu.export import mjcf as jmjcf  # noqa: E402
from ti5_isaacgym_tpu_torch.export import mjcf as tmjcf  # noqa: E402
from ti5_isaacgym_tpu_torch.physics import dynamics as tdyn  # noqa: E402
from ti5_isaacgym_tpu_torch.physics import model as tmodel  # noqa: E402
from ti5_isaacgym_tpu_torch.physics import spatial as tsp  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ROBOTS = ("t1", "k1")
FLAGS = list(itertools.product((True, False), (True, False), (0.0, 0.1)))


def _spec_path(robot, package="ti5_isaacgym_tpu_torch"):
    return os.path.join(ROOT, package, "resources", f"{robot}_model.json")


def _spec(robot, package="ti5_isaacgym_tpu_torch"):
    with open(_spec_path(robot, package)) as f:
        return json.load(f)


@pytest.mark.parametrize("robot", ROBOTS)
@pytest.mark.parametrize("with_geoms,limited,armature", FLAGS)
def test_xml_byte_equal_to_jax(robot, with_geoms, limited, armature):
    kw = dict(with_geoms=with_geoms, limited=limited, armature=armature)
    want = jmjcf.spec_to_mjcf(_spec(robot, "ti5_isaacgym_tpu"), **kw)
    got = tmjcf.spec_file_to_mjcf(_spec_path(robot), **kw)
    assert got.encode() == want.encode()
    assert tmjcf.spec_to_mjcf(_spec(robot), **kw) == want


def test_rotated_frames_byte_equal_to_jax():
    """Joint frames rotated by seeded rotations (all four branches of
    Shepperd's method among them) emit the same quaternions as JAX's."""
    rng = np.random.default_rng(0)
    rots = [np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
            np.diag([-1.0, -1.0, 1.0])]
    for _ in range(9):
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        rots.append(np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]))
    for R in rots:
        np.testing.assert_array_equal(tmjcf._mat_to_quat(R), jmjcf._mat_to_quat(R))
    spec = copy.deepcopy(_spec("t1"))
    joints = [b for b in spec["bodies"] if b.get("joint")]
    for b, R in zip(joints, rots):
        b["joint"]["origin_rot"] = R.tolist()
    xml = tmjcf.spec_to_mjcf(spec)
    assert xml.count(' quat="') == len(joints)
    assert xml == jmjcf.spec_to_mjcf(spec)
    mujoco.MjModel.from_xml_string(xml)


def _model(robot="t1", **kw):
    kw = {"with_geoms": True, "limited": True, **kw}
    return mujoco.MjModel.from_xml_string(tmjcf.spec_to_mjcf(_spec(robot), **kw))


def test_joint_ranges_are_radians():
    m = _model()
    knee = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, "leg_l4_joint")
    np.testing.assert_allclose(m.jnt_range[knee], [0.0, 2.09], atol=1e-6)
    hip_yaw = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, "leg_l1_joint")
    assert m.jnt_range[hip_yaw][1] > 0.5   # 0.523 rad, not 0.009 (= 0.523 deg)


def test_airborne_pd_reaches_target_pose():
    m = _model()
    d = mujoco.MjData(m)
    default_q = np.array([0.0, 0.0, -0.3, 0.6, -0.3, 0.0] * 2)
    kp = np.array([50, 70, 90, 120, 50, 30] * 2, float)
    kd = np.array([5, 7, 9, 12, 5, 3] * 2, float)
    d.qpos[:3] = [0, 0, 2.0]
    d.qpos[3:7] = [1, 0, 0, 0]
    d.qpos[7:] = default_q
    for _ in range(300):   # 0.3 s: settles the PD but stays airborne
        d.ctrl[:] = np.clip(kp * (default_q - d.qpos[7:]) - kd * d.qvel[6:], -200, 200)
        mujoco.mj_step(m, d)
    assert d.qpos[2] > 1.0, "fell to the floor; shorten the horizon"
    np.testing.assert_allclose(d.qpos[7:], default_q, atol=0.02)


def test_no_self_collision_contacts():
    m = _model()
    d = mujoco.MjData(m)
    d.qpos[:3] = [0, 0, 2.0]      # airborne: floor contact impossible
    d.qpos[3:7] = [1, 0, 0, 0]
    d.qpos[7:] = np.array([0.0, 0.0, -0.9, 2.0, -0.9, 0.0] * 2)  # legs folded
    mujoco.mj_forward(m, d)
    assert d.ncon == 0


# --- MuJoCo as the oracle of the port's dynamics ------------------------------


def _states(seed, n):
    """``n`` random states as tests/test_dynamics.py draws them (numpy)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    return dict(
        base_pos=(rng.normal(size=(n, 3)) * 0.5 + [0, 0, 1.0]).astype(np.float32),
        base_quat=(q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32),
        base_vel=(rng.normal(size=(n, 6)) * 0.5).astype(np.float32),
        qpos=rng.uniform(-0.5, 0.5, size=(n, 12)).astype(np.float32),
        qvel=(rng.normal(size=(n, 12)) * 0.5).astype(np.float32),
        tau=(rng.normal(size=(n, 12)) * 20.0).astype(np.float32))


def _oracle(robot):
    m = _model(robot, with_geoms=False, limited=False)
    return tmodel.load(_spec_path(robot)), m, mujoco.MjData(m)


def _set_mj_state(m, d, x, i):
    d.qpos[:3] = x["base_pos"][i]
    d.qpos[3:7] = x["base_quat"][i]     # MuJoCo is wxyz too
    d.qpos[7:] = x["qpos"][i]
    # MuJoCo's free joint: linear velocity in the world, angular in the body
    R = tsp.quat_to_mat(torch.from_numpy(x["base_quat"][i])).double().numpy()
    d.qvel[:3] = R @ x["base_vel"][i, 3:]
    d.qvel[3:6] = x["base_vel"][i, :3]
    d.qvel[6:] = x["qvel"][i]


def _frames(tm, x):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return t, tdyn.fk(tm, t["base_pos"], t["base_quat"], t["base_vel"], t["qpos"], t["qvel"])


@pytest.mark.parametrize("robot", ROBOTS)
def test_fk_matches_mujoco(robot):
    tm, m, d = _oracle(robot)
    x = _states(0, 3)
    _, fr = _frames(tm, x)
    for i in range(3):
        _set_mj_state(m, d, x, i)
        mujoco.mj_forward(m, d)
        for b, name in enumerate(tm.body_names):
            bid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, name)
            np.testing.assert_allclose(fr.pos[i, b].numpy(), d.xpos[bid], atol=1e-5,
                                       err_msg=f"body {name} position (state {i})")
            np.testing.assert_allclose(fr.rot[i, b].numpy(), d.xmat[bid].reshape(3, 3),
                                       atol=1e-5, err_msg=f"body {name} rotation (state {i})")


@pytest.mark.parametrize("robot", ROBOTS)
def test_aba_matches_mujoco(robot):
    tm, m, d = _oracle(robot)
    x = _states(100, 5)
    t, fr = _frames(tm, x)
    a0, qdd = tdyn.aba(tm, tdyn.nominal_params(tm), fr, t["qvel"], t["tau"])
    a0, qdd = a0.double().numpy(), qdd.double().numpy()
    for i in range(5):
        _set_mj_state(m, d, x, i)
        d.ctrl[:] = 0.0
        d.qfrc_applied[:] = 0.0
        d.qfrc_applied[6:] = x["tau"][i]
        mujoco.mj_forward(m, d)
        np.testing.assert_allclose(qdd[i], d.qacc[6:], rtol=2e-3, atol=2e-3,
                                   err_msg=f"joint accelerations (state {i})")
        # MuJoCo's qacc[:3] is the world linear acceleration of the free
        # joint's frame, qacc[3:6] the body-frame angular one; from the
        # body-frame spatial acceleration: d/dt (R v_b) = R (a_lin + w_b x v_b)
        R = tsp.quat_to_mat(t["base_quat"][i]).double().numpy()
        w_b, v_b = x["base_vel"][i, :3], x["base_vel"][i, 3:]
        np.testing.assert_allclose(R @ (a0[i, 3:] + np.cross(w_b, v_b)), d.qacc[:3],
                                   rtol=2e-3, atol=2e-3, err_msg=f"base linear (state {i})")
        np.testing.assert_allclose(a0[i, :3], d.qacc[3:6], rtol=2e-3, atol=2e-3,
                                   err_msg=f"base angular (state {i})")
