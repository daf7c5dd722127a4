"""Port parity: the viewers' modules (utils/debug_viz.py, utils/teleop.py,
utils/gait_design.py, utils/render.py) and play's ``--teleop``, ``--live``
and ``--video`` on the CPU.

* The overlay geometry against the JAX package's on one state of 4 envs,
  on a plane and on rough terrain (2x2 grid): the port env's initial state
  with every robot's base placed and turned from a numpy seed and contact
  forces drawn from it (some below the 1 N threshold); the JAX functions
  read the same base poses, terrain heights and forces, with the JAX env's
  height-scan grid and heightfield (equal to the port's).  Height-scan points
  within 1e-5 (float32 trigonometry in two libraries), the contact segments'
  bodies equal and their ends within 1e-6.  ``update_overlay`` fills a
  stand-in viewer whose ``user_scn`` is a real ``mujoco.MjvScene`` (no GL)
  with the same geoms as JAX's: count, types, sizes, positions, frames and
  colours, also when the scene has fewer slots than markers.
* Teleop's key mapping and headless degrade (``tests/test_env_surface.py:
  200-235``, and with ``pygame`` missing, as on the card's machine); the
  gait-design numbers equal to JAX's; ``render_trajectory``'s shape check.
* ``play`` on the CPU at 4 envs: ``--teleop auto`` on a headless host
  follows the schedule and says so; a teleop source's command reaches every
  env with the gait clock frozen, and its quit ends the loop; ``--live``
  replays robot 0 into a stand-in passive viewer with the overlay.
The GL halves (MuJoCo's window and offscreen renderer) do not run here.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg as JCfg  # noqa: E402
from ti5_isaacgym_tpu.envs.t1_dh_stand import T1DHStandEnv as JEnv  # noqa: E402
from ti5_isaacgym_tpu.utils import debug_viz as jviz  # noqa: E402
from ti5_isaacgym_tpu.utils import gait_design as jgait  # noqa: E402
from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg as TCfg  # noqa: E402
from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv as TEnv  # noqa: E402
from ti5_isaacgym_tpu_torch.export.mjcf import spec_file_to_mjcf  # noqa: E402
from ti5_isaacgym_tpu_torch.physics.model import RESOURCES  # noqa: E402
from ti5_isaacgym_tpu_torch.scripts import play  # noqa: E402
from ti5_isaacgym_tpu_torch.utils import debug_viz as tviz  # noqa: E402
from ti5_isaacgym_tpu_torch.utils import gait_design as tgait  # noqa: E402
from ti5_isaacgym_tpu_torch.utils import render, teleop  # noqa: E402

N = 4
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
T1_SPEC = os.path.join(RESOURCES, "t1_model.json")


def _cfg(cls, terrain):
    cfg = cls()
    t = (dict(mesh_type="plane", curriculum=False) if terrain == "plane"
         else dict(num_rows=2, num_cols=2, border_size=2.0))
    return dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, num_envs=N),
                               terrain=dataclasses.replace(cfg.terrain, **t))


def _jax_env(cfg):
    """The JAX env without its contact-mass probe (10 s of compiling on the
    CPU; the overlays read no contact mass)."""
    import ti5_isaacgym_tpu.envs.t1_dh_stand as jmod

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "probe_contact_masses",
                   lambda model, *_: np.ones((model.cp_pos.shape[0], 2), np.float32))
        return JEnv(cfg, seed=0)


@pytest.fixture(scope="module", params=["plane", "rough"])
def envs_and_state(request):
    """(JAX env, the fields of the state the JAX overlays read, port env,
    port state): the port env's initial state with each robot placed,
    turned and pushed from a numpy seed; the JAX side reads the same
    arrays."""
    jenv = _jax_env(_cfg(JCfg, request.param))
    tenv = TEnv(_cfg(TCfg, request.param), seed=0, device="cpu")
    np.testing.assert_array_equal(tenv.heightfield.height.numpy(),
                                  np.asarray(jenv.heightfield.height))
    ts = tenv.init_state(0)
    rng = np.random.default_rng(3)
    yaw, tilt = rng.uniform(-np.pi, np.pi, N), rng.normal(scale=0.1, size=(N, 2))
    quat = np.stack([np.cos(yaw / 2), tilt[:, 0], tilt[:, 1], np.sin(yaw / 2)], -1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    # anywhere over the height map but its outer metre (a plane's map is
    # one cell: anywhere in a 6 m square)
    hf = tenv.heightfield
    lo = 1.0 - hf.offset
    hi = (np.array(hf.height.shape) - 1) * hf.hscale - hf.offset - 1.0
    xy = rng.uniform(lo, np.maximum(hi, lo + 6.0), size=(N, 2))
    pos = np.concatenate([xy, np.full((N, 1), 0.9)], -1)
    forces = rng.normal(scale=200.0, size=tuple(ts.contact_forces.shape))
    forces[:, ::3] *= 1e-3                      # below the 1 N threshold
    ts = ts.replace(phys=ts.phys.replace(base_pos=torch.tensor(pos, dtype=torch.float32),
                                         base_quat=torch.tensor(quat, dtype=torch.float32)),
                    contact_forces=torch.tensor(forces, dtype=torch.float32))
    js = SimpleNamespace(
        phys=SimpleNamespace(base_pos=jnp.asarray(ts.phys.base_pos.numpy()),
                             base_quat=jnp.asarray(ts.phys.base_quat.numpy())),
        terrain_height=jnp.asarray(ts.terrain_height.numpy()),
        contact_forces=jnp.asarray(ts.contact_forces.numpy()))
    return request.param, jenv, js, tenv, ts


def test_height_scan_markers_match_jax(envs_and_state):
    terrain, jenv, js, tenv, ts = envs_and_state
    heights = []
    for robot in range(N):
        want = jviz.height_scan_markers(jenv, js, robot)
        got = tviz.height_scan_markers(tenv, ts, robot)
        assert got.shape == (187, 3) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"robot {robot}")
        heights.append(got[:, 2])
    assert (np.ptp(heights) > 0.005) == (terrain == "rough")


def test_contact_force_segments_match_jax(envs_and_state):
    _, jenv, js, tenv, ts = envs_and_state
    body_pos = np.random.default_rng(5).normal(size=(13, 3))
    for robot in range(N):
        want = jviz.contact_force_segments(jenv, js, body_pos, robot)
        got = tviz.contact_force_segments(tenv, ts, body_pos, robot)
        assert 0 < len(got) == len(want) < 13
        for (p0, p1, mag), (q0, q1, nag) in zip(got, want):
            np.testing.assert_array_equal(p0, q0)
            np.testing.assert_allclose(p1, q1, atol=1e-6, rtol=0)
            np.testing.assert_allclose(mag, nag, rtol=1e-6)


class StandInViewer:
    """What ``update_overlay`` and play's live loop use of MuJoCo's passive
    viewer, with a real scene and no window."""

    def __init__(self, model, maxgeom=300, frames=None):
        self.user_scn = mujoco.MjvScene(model, maxgeom=maxgeom)
        self.frames, self.synced, self.closed = frames, 0, False

    def is_running(self):
        return self.frames is None or self.synced < self.frames

    def sync(self):
        self.synced += 1

    def close(self):
        self.closed = True


def _geoms(scn):
    return [(g.type, g.size.copy(), g.pos.copy(), g.mat.copy(), g.rgba.copy())
            for g in scn.geoms[:scn.ngeom]]


@pytest.mark.parametrize("maxgeom", [300, 100])
def test_update_overlay_draws_what_jax_draws(envs_and_state, maxgeom):
    _, jenv, js, tenv, ts = envs_and_state
    model = mujoco.MjModel.from_xml_string(spec_file_to_mjcf(T1_SPEC))
    data = mujoco.MjData(model)
    data.qpos[:] = torch.cat([ts.phys.base_pos[0], ts.phys.base_quat[0],
                              ts.phys.qpos[0]]).double().numpy()
    mujoco.mj_forward(model, data)
    with open(T1_SPEC) as f:
        names = [b["name"] for b in json.load(f)["bodies"]]
    jview, tview = StandInViewer(model, maxgeom), StandInViewer(model, maxgeom)
    n_want = jviz.update_overlay(jview, model, data, jenv, js, 0, spec_body_names=names)
    n_got = tviz.update_overlay(tview, model, data, tenv, ts, 0, spec_body_names=names)
    assert n_got == n_want == tview.user_scn.ngeom == min(maxgeom, n_want)
    assert n_want > 187 if maxgeom == 300 else n_want == 100
    for i, (got, want) in enumerate(zip(_geoms(tview.user_scn), _geoms(jview.user_scn))):
        assert got[0] == want[0], f"geom {i} type"
        for k, (a, b) in enumerate(zip(got[1:], want[1:])):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=f"geom {i} field {k}")


def test_keyboard_teleop_key_mapping():
    kb = teleop.KeyboardTeleop.__new__(teleop.KeyboardTeleop)
    kb._lock = threading.Lock()
    kb._cmd = [0.0, 0.0, 0.0]
    kb._exit = False
    for ch in "wwwaq":
        kb.apply_key(ch)
    np.testing.assert_allclose(kb.get(), (0.3, 0.1, 0.1), atol=1e-9)
    for ch in "sde":
        kb.apply_key(ch)
    np.testing.assert_allclose(kb.get(), (0.2, 0.0, 0.0), atol=1e-9)
    kb.apply_key(" ")
    assert kb.get() == (0.0, 0.0, 0.0)
    kb.apply_key("x")
    assert kb.exited


def test_teleop_headless_degrade(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    assert not teleop.JoystickTeleop().ok            # no controller here
    assert not teleop.KeyboardTeleop().ok            # stdin is not a tty
    assert teleop.make_teleop("auto") is None
    assert teleop.make_teleop("keyboard") is None
    monkeypatch.setitem(sys.modules, "pygame", None)   # the card's machine
    assert teleop.make_teleop("joystick") is None
    assert "joystick unavailable" in capsys.readouterr().out


def test_gait_design_matches_jax(tmp_path):
    for args in ((0.0, 0.0, 0.0, 0.0, 0.08, 0.4), (0.01, 0.02, 0.1, -0.2, 0.12, 0.35)):
        c = tgait.quintic_swing_coefficients(*args)
        np.testing.assert_array_equal(c, jgait.quintic_swing_coefficients(*args))
        t = np.linspace(0, args[-1], 50)
        for a, b in zip(tgait.quintic_eval(c, t), jgait.quintic_eval(c, t)):
            np.testing.assert_array_equal(a, b)
        h = tgait.quintic_eval(c, np.array([0.0, args[-1] / 2]))[0]
        np.testing.assert_allclose(h, [args[0], args[4]], atol=1e-12)
    phi = np.linspace(0, 1, 101)
    np.testing.assert_array_equal(tgait.c_des(phi), jgait.c_des(phi))
    np.testing.assert_array_equal(tgait.c_des(phi, 0.6, 0.05), jgait.c_des(phi, 0.6, 0.05))
    x = np.linspace(-3, 3, 61)
    np.testing.assert_array_equal(tgait.gaussian_kernel(x, 1, 0.6),
                                  jgait.gaussian_kernel(x, 1, 0.6))
    for beta in (1, 20):
        np.testing.assert_array_equal(tgait.cauchy_kernel(x, 1, beta, 0.6),
                                      jgait.cauchy_kernel(x, 1, beta, 0.6))
    assert tgait.plot_design(str(tmp_path)) == str(tmp_path)
    assert sorted(os.listdir(tmp_path)) == ["gait_cdes.png", "gait_kernels.png",
                                            "gait_quintic.png"]


def test_render_trajectory_checks_the_shape(tmp_path):
    for robot in ("t1", "k1"):
        spec = os.path.join(RESOURCES, f"{robot}_model.json")
        for bad in (np.zeros((5, 18)), np.zeros(19)):
            with pytest.raises(ValueError, match="nq=19"):
                render.render_trajectory(bad, 0.01, str(tmp_path / "x.mp4"), spec)
    assert not (tmp_path / "x.mp4").exists()


RENDER = r"""
import sys
import numpy as np
from ti5_isaacgym_tpu_torch.utils import render
mujoco, cv2 = render.video_modules()
try:
    mujoco.Renderer(mujoco.MjModel.from_xml_string("<mujoco/>"), 8, 8).close()
except Exception as e:
    print("no offscreen GL context:", e)
    sys.exit(0)
traj = np.load(sys.argv[1])
for out, spec in zip(sys.argv[2::2], sys.argv[3::2]):
    assert render.render_trajectory(traj, 0.01, out, spec, width=160, height=120) == out
    cap, frames = cv2.VideoCapture(out), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    np.save(out + ".npy", np.stack(frames))
print("rendered")
"""


def test_render_trajectory_writes_the_played_robot(tmp_path):
    """``render_trajectory`` in a fresh process (MuJoCo chooses its GL
    backend when imported): 10 policy steps at 100 Hz give 5 frames at 50
    fps of the robot of the spec it is given (T1's and K1's images differ
    for one trajectory).  Skips where no offscreen GL context can be made."""
    default = np.array([0.0, 0.0, -0.2, 0.4, -0.25, 0.0] * 2)
    traj = np.tile(np.concatenate([[0.0, 0.0, 0.9, 1.0, 0.0, 0.0, 0.0], default]), (10, 1))
    traj[:, 0] = np.linspace(0.0, 0.3, 10)
    np.save(tmp_path / "traj.npy", traj)
    args = [tmp_path / "traj.npy"]
    for robot in ("t1", "k1"):
        args += [tmp_path / f"{robot}.mp4", os.path.join(RESOURCES, f"{robot}_model.json")]
    res = subprocess.run([sys.executable, "-c", RENDER, *map(str, args)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, stdin=subprocess.DEVNULL)
    assert res.returncode == 0, res.stderr
    if "no offscreen GL context" in res.stdout:
        pytest.skip(res.stdout.strip()[-300:])
    frames = {r: np.load(tmp_path / f"{r}.mp4.npy") for r in ("t1", "k1")}
    for f in frames.values():
        assert f.shape == (5, 120, 160, 3)
        assert f.std() > 10          # an image, not a blank frame
    assert np.abs(frames["t1"].astype(int) - frames["k1"]).mean() > 1.0


def _play_args(tmp_path, *flags):
    return ["--device", "cpu", "--random_policy", "--num_envs", str(N), "--out_dir",
            str(tmp_path), "--export_traj", str(tmp_path / "traj.npz"), *flags]


def test_play_teleop_headless_follows_the_schedule(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    state, stats = play.main(_play_args(tmp_path, "--teleop", "auto", "--steps", "2"))
    out = capsys.readouterr().out
    assert "[play] no teleop source available; using the schedule" in out
    assert "2 steps x 4 envs of t1_dh_stand on cpu" in out
    with np.load(tmp_path / "traj.npz") as f:
        assert f["qpos"].shape == (2, 19) and np.isfinite(f["qpos"]).all()
    assert not bool((state.gait_time == 1 << 30).any())     # the schedule's clock runs


class FakeTeleop:
    """A teleop source that quits after ``frames`` reads of its command."""

    def __init__(self, cmd, frames):
        self.cmd, self.frames, self.reads, self.stopped = cmd, frames, 0, False

    @property
    def exited(self):
        return self.reads >= self.frames

    def get(self):
        self.reads += 1
        return self.cmd

    def stop(self):
        self.stopped = True


def test_play_teleop_and_live_replay(tmp_path, monkeypatch):
    """A teleop command reaches every env as ``--fix_command``'s does and its
    quit ends the loop; ``--live`` replays robot 0 into the (stand-in)
    passive viewer with the overlay each step, and closes it."""
    import mujoco.viewer

    source = FakeTeleop((0.3, -0.1, 0.2), frames=2)
    monkeypatch.setattr(teleop, "make_teleop", lambda kind: source)
    viewers = []

    def launch_passive(model, data):
        viewers.append(StandInViewer(model))
        return viewers[-1]

    monkeypatch.setattr(mujoco.viewer, "launch_passive", launch_passive)
    state, _ = play.main(_play_args(tmp_path, "--teleop", "keyboard", "--live",
                                    "--steps", "5"))
    assert source.stopped and source.reads == 2
    np.testing.assert_allclose(state.commands[:, :3].numpy(),
                               np.tile([0.3, -0.1, 0.2], (N, 1)), atol=1e-7)
    assert bool((state.gait_time == 1 << 30).all())
    (viewer,) = viewers
    assert viewer.synced == 2 and viewer.closed
    assert viewer.user_scn.ngeom >= 187
    with np.load(tmp_path / "traj.npz") as f:
        assert f["qpos"].shape == (2, 19)
        last = f["qpos"][-1]
    spheres = [g for g in viewer.user_scn.geoms[:viewer.user_scn.ngeom]
               if g.type == mujoco.mjtGeom.mjGEOM_SPHERE]
    assert len(spheres) == 187
    # the scan is centred on the replayed robot 0
    np.testing.assert_allclose(np.mean([g.pos[:2] for g in spheres], 0), last[:2], atol=0.3)


def test_play_video_and_live_show_the_played_robot(tmp_path, monkeypatch):
    """``--video`` and ``--live`` of a K1 task get K1's spec (the JAX
    package's always build T1's), and the video gets robot 0's trajectory."""
    import mujoco.viewer

    calls, models = [], []
    monkeypatch.setattr(render, "render_trajectory",
                        lambda traj, dt, out, spec: calls.append((traj, dt, out, spec)))
    monkeypatch.setattr(mujoco.viewer, "launch_passive",
                        lambda model, data: models.append(model) or StandInViewer(model))
    play.main(["--device", "cpu", "--random_policy", "--task", "k1_dh_stand", "--num_envs",
               str(N), "--steps", "2", "--out_dir", str(tmp_path), "--live",
               "--video", str(tmp_path / "k1.mp4")])
    k1 = os.path.join(RESOURCES, "k1_model.json")
    ((traj, dt, out, spec),) = calls
    assert (spec, out, dt, traj.shape) == (k1, str(tmp_path / "k1.mp4"), 0.01, (2, 19))
    want = mujoco.MjModel.from_xml_string(spec_file_to_mjcf(k1))
    t1 = mujoco.MjModel.from_xml_string(spec_file_to_mjcf(T1_SPEC))
    np.testing.assert_array_equal(models[0].body_mass, want.body_mass)
    assert not np.array_equal(want.body_mass, t1.body_mass)
