"""The port imports neither ``jax`` nor anything of ``ti5_isaacgym_tpu``.

Every module of ``ti5_isaacgym_tpu_torch`` and ``chip_smoke.py`` is imported
in a fresh interpreter where ``jax``, ``jaxlib``, ``flax``, ``optax``,
``orbax``, ``yaml``, ``mujoco``, ``cv2``, ``pygame`` (the card's machine has
none of the last four) and ``ti5_isaacgym_tpu`` are blocked in
``sys.modules`` (an import of any of them raises).  Also: the port's entry
points refuse ``cuda`` where no card is present instead of falling back to
the CPU.
"""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "mujoco", "cv2", "pygame",
           "ti5_isaacgym_tpu")
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, ROOT)
import ti5_isaacgym_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not bad, bad
for m in ("parallel.trainer", "export.mjcf", "scripts.sim2sim", "utils.debug_viz",
          "utils.teleop", "utils.render", "utils.gait_design", "utils.checkpoint",
          "scripts.slim_checkpoint", "scripts.reheat_std", "scripts.resume_migrate",
          "scripts.sync_checkpoint", "scripts.resume_round", "scripts.train_walk",
          "scripts.seed_probe", "scripts.contact_stats", "scripts.eval_report",
          "scripts.extract_model", "scripts.spec_to_urdf", "scripts.make_k1_urdf",
          "scripts.restore_checkpoint", "scripts.final_eval"):
    assert "ti5_isaacgym_tpu_torch." + m in mods, mods
print(len(mods))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT.replace("ROOT", repr(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
                         stdin=subprocess.DEVNULL)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 40


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal only happens without one")
    from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg
    from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv
    from ti5_isaacgym_tpu_torch.scripts import play

    with pytest.raises(RuntimeError, match="cuda"):
        T1DHStandEnv(T1EnvCfg(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        play.make_policy(T1EnvCfg(), None, device="cuda")


def test_chip_smoke_fails_without_a_card():
    """Run as the check runs it, chip_smoke.py must fail here (no card) and
    print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         stdin=subprocess.DEVNULL)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
