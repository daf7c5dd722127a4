"""Port parity: the decimation kernel's plain version against the JAX scan
path's math, and the wrapper's CPU contract.

The JAX side runs the scan path over the 10 substeps of one policy step:
``legged.compute_torques`` (action-lag ring push and read, PD law,
Coulomb/viscous friction) and ``engine_core.substep_stacked`` (through
``substep_batched``), which tests/test_megakernel.py:33 holds equal to the
Pallas kernel.  The port's side resolves the action lag ahead
(``legged.resolve_action_lag``) and runs ``run_decimation`` on CPU tensors,
i.e. ``run_decimation_plain``.  Both get the same torque-noise rows.
Tolerances are the reference's (tests/test_megakernel.py:52-67): state and
kinematics atol 2e-4, contact forces atol 2 N + rtol 2e-3, action ring 1e-6;
torques follow from the state through gains <= 144 Nm/rad: atol 0.05 Nm.
"""
import dataclasses
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg as JCfg
from ti5_isaacgym_tpu.envs import legged as jlegged
from ti5_isaacgym_tpu.physics import contact as jct
from ti5_isaacgym_tpu.physics import dynamics as jdyn
from ti5_isaacgym_tpu.physics import engine as jeng
from ti5_isaacgym_tpu.physics import engine_core as jec
from ti5_isaacgym_tpu.physics import model as jmodel
from ti5_isaacgym_tpu_torch.envs import legged as tlegged
from ti5_isaacgym_tpu_torch.physics import engine_core as tec
from ti5_isaacgym_tpu_torch.physics import megakernel as mk
from ti5_isaacgym_tpu_torch.physics import model as tmodel
from ti5_isaacgym_tpu_torch.physics.contact import ContactOpts
from ti5_isaacgym_tpu_torch.physics.engine import SolverOpts
from torch_port_cases import HSCALE, N, STATE, make_case

DEC, L = 10, 31
TL = (tmodel.load_t1().dof_effort * 0.85).astype(np.float32)


def _extra(seed):
    rng = np.random.default_rng(100 + seed)
    return dict(
        actions=rng.uniform(-1, 1, size=(N, 12)).astype(np.float32),
        lag_buffer=rng.normal(scale=0.3, size=(N, 12, L)).astype(np.float32),
        lag_steps=rng.integers(0, L, size=N).astype(np.int32),
        p=rng.uniform(40, 144, size=(N, 12)).astype(np.float32),
        d=rng.uniform(2, 14, size=(N, 12)).astype(np.float32),
        offs=rng.uniform(-0.035, 0.035, size=(N, 12)).astype(np.float32),
        coul=rng.uniform(0.1, 1.0, size=(N, 12)).astype(np.float32),
        visc=rng.uniform(0.1, 0.9, size=(N, 12)).astype(np.float32),
        noise=rng.uniform(0.8, 1.2, size=(DEC, N, 12)).astype(np.float32),
    )


DEFAULT_Q = np.array([0, 0, -0.3, 0.6, -0.3, 0] * 2, np.float32)


def run_jax_scan(c, x, flags):
    """The JAX scan path over one policy step, with fed torque noise."""
    jm = jmodel.load_t1()
    cfg = JCfg()
    cfg = dataclasses.replace(cfg, domain_rand=dataclasses.replace(
        cfg.domain_rand, add_lag=True, randomize_lag_timesteps_perstep=False,
        randomize_coulomb_friction=flags, randomize_torque=False))
    params = SimpleNamespace(p_gains=jnp.asarray(x["p"]), d_gains=jnp.asarray(x["d"]),
                             motor_offsets=jnp.asarray(x["offs"]),
                             joint_coulomb=jnp.asarray(x["coul"]),
                             joint_viscous=jnp.asarray(x["visc"]),
                             lag_steps=jnp.asarray(x["lag_steps"]))
    dyn = jdyn.DynamicsParams(mass=jnp.asarray(c["mass"]), com=jnp.asarray(c["com"]),
                              inertia=jnp.asarray(c["inertia"]), armature=jnp.asarray(c["armature"]))
    cells = jct.CellCache(**{k: jnp.asarray(v) for k, v in c["cells"].items()})
    hf = jct.HeightField(height=jnp.zeros((2, 2)), hscale=HSCALE, offset=0.0)
    phys = jeng.PhysicsState(**{k: jnp.asarray(c[k]) for k in STATE})
    lagb, key = jnp.asarray(x["lag_buffer"]), jax.random.PRNGKey(0)
    ds, imu = [], []
    for k in range(DEC):
        # limits +inf inside compute_torques, then the noise multiplier and
        # the real clip: clip(t * mult, -tl, tl), as with randomize_torque
        tq, lagb, _ = jlegged.compute_torques(cfg, params, jnp.full(12, jnp.inf),
                                              jnp.asarray(DEFAULT_Q), lagb,
                                              jnp.asarray(x["actions"]), phys.qpos, phys.qvel, key)
        if flags:
            tq = tq * jnp.asarray(x["noise"][k])
        tq = jnp.clip(tq, -TL, TL)
        on = 1.0 if k == 0 else 0.0
        phys, cf = jec.substep_batched(jm, dyn, hf, jct.ContactOpts(), jeng.SolverOpts(), phys,
                                       tq, jnp.asarray(c["friction"]), c["cp_meff"],
                                       jnp.asarray(c["ext_f"]) * on, jnp.asarray(c["ext_t"]) * on,
                                       cell_cache=cells, restitution=jnp.asarray(c["restitution"]))
        ds.append(np.concatenate([np.asarray(phys.qpos), np.asarray(phys.qvel)], -1).T)
        imu.append(np.concatenate([np.asarray(phys.base_vel[:, :3]),
                                   np.asarray(phys.base_quat)], -1).T)
    s3 = jec.s3
    ctx = jec.ctx_stack_rows(jec.model_consts(jm), [6, 12], [4, 10],
                             s3.v3_unstack(phys.base_pos), s3.q_unstack(phys.base_quat),
                             s3.v3_unstack(phys.base_vel[:, :3]), s3.v3_unstack(phys.base_vel[:, 3:]),
                             [phys.qpos[:, j] for j in range(12)], [phys.qvel[:, j] for j in range(12)])
    st = np.concatenate([np.asarray(phys.base_pos), np.asarray(phys.base_quat),
                         np.asarray(phys.base_vel), np.asarray(phys.qpos),
                         np.asarray(phys.qvel)], -1).T
    an = np.transpose(np.asarray(phys.cp_anchor), (2, 1, 0)).reshape(96, N)
    return dict(state=st, anchors=an, forces=np.asarray(cf).reshape(N, 39).T,
                torques=np.asarray(tq).T, dof_snapshots=np.concatenate(ds, 0),
                imu_snapshots=np.concatenate(imu, 0),
                ctx=np.stack([np.asarray(r) for r in ctx]), ring=np.asarray(lagb))


def torch_inputs(c, x):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    rows = lambda *xs: torch.cat([t(a) for a in xs], -1).T.contiguous()  # noqa: E731
    lagged, ring = tlegged.resolve_action_lag(t(x["actions"]) * 0.5, t(x["lag_buffer"]),
                                              torch.from_numpy(x["lag_steps"]), DEC)
    cl = c["cells"]
    inputs = dict(
        state_rows=rows(c["base_pos"], c["base_quat"], c["base_vel"], c["qpos"], c["qvel"]),
        anchor_rows=t(np.transpose(c["cp_anchor"], (2, 1, 0)).reshape(96, N)),
        cell_rows=t(np.concatenate([cl[k] for k in ("x0", "y0", "h00", "h10", "h01", "h11")])),
        dyn_rows=rows(c["mass"], c["com"].reshape(N, 39), c["inertia"].reshape(N, 117),
                      c["armature"], c["friction"][:, None], c["restitution"][:, None]),
        ctrl_rows=rows(x["p"], x["d"], x["offs"], x["coul"], x["visc"]),
        lagged_rows=lagged,
        noise_rows=t(np.transpose(x["noise"], (0, 2, 1)).reshape(DEC * 12, N)),
        extw_rows=rows(c["ext_f"], c["ext_t"]),
    )
    return inputs, ring


OUTPUTS = ("state", "anchors", "forces", "torques", "dof_snapshots", "imu_snapshots", "ctx")
TOL = {"state": (2e-4, 0), "anchors": (2e-4, 0), "forces": (2.0, 2e-3), "torques": (5e-2, 0),
       "dof_snapshots": (2e-4, 0), "imu_snapshots": (2e-4, 0), "ctx": (2e-4, 0)}


@pytest.mark.parametrize("flags", [False, True], ids=["coulomb_noise_off", "coulomb_noise_on"])
def test_plain_decimation_matches_jax_scan_path(flags):
    c, x = make_case(2), _extra(2)
    want = run_jax_scan(c, x, flags)
    inputs, ring = torch_inputs(c, x)
    tm = tmodel.load_t1()
    before = mk.launches
    got = mk.run_decimation(tec.model_consts(tm), HSCALE, ContactOpts(), SolverOpts(), DEC,
                            DEFAULT_Q, TL, c["cp_meff"], flags, flags, **inputs,
                            feet_bodies=[6, 12], knee_bodies=[4, 10])
    assert mk.launches == before, "the plain version must not count as a kernel launch"
    assert [tuple(g.shape) for g in got] == [(37, N), (96, N), (39, N), (12, N), (240, N),
                                             (70, N), (24, N)]
    # the case runs contact: most envs end the step on a loaded foot
    assert (want["forces"][[20, 38]] > 5.0).any(axis=0).mean() >= 0.75
    for name, g in zip(OUTPUTS, got):
        atol, rtol = TOL[name]
        np.testing.assert_allclose(g.numpy(), want[name], atol=atol, rtol=rtol, err_msg=name)
    np.testing.assert_allclose(ring.numpy(), want["ring"], atol=1e-6)


def test_consts_layout_matches_cuda_source():
    """The wrapper's constant block has the layout of ``DecimConsts`` in
    csrc/decimation.cu (same array limits, 4-byte fields, no padding)."""
    src = open(mk.SOURCE).read()
    limits = {k: int(v) for k, v in re.findall(r"#define (MAX[BDPK]) (\d+)", src)}
    assert limits == {"MAXB": mk.MAXB, "MAXD": mk.MAXD, "MAXP": mk.MAXP, "MAXK": mk.MAXK}
    body = src[src.index("struct DecimConsts {"):src.index("};", src.index("struct DecimConsts {"))]
    n_ints = n_floats = 0
    for typ, decl in re.findall(r"\b(int|float) ([^;]+);", body):
        size = 0
        for name in decl.split(","):
            dims = [int(eval(d, {}, limits)) for d in re.findall(r"\[([^\]]+)\]", name)]
            size += int(np.prod(dims)) if dims else 1
        if typ == "int":
            n_ints += size
        else:
            n_floats += size
    tm = tmodel.load_t1()
    blob = mk.consts_bytes(tec.model_consts(tm), HSCALE, ContactOpts(), SolverOpts(), DEC,
                           DEFAULT_Q, TL, [6, 12], [4, 10])
    assert len(blob) == 4 * (n_ints + n_floats)
    ints = np.frombuffer(blob[:4 * n_ints], np.int32)
    assert list(ints[:6]) == [13, 12, 32, DEC, 2, 2]


def test_find_nvcc_raises_without_toolkit(monkeypatch):
    monkeypatch.setattr(mk.shutil, "which", lambda _: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    real_isfile = os.path.isfile
    monkeypatch.setattr(mk.os.path, "isfile",
                        lambda p: False if str(p).endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mk.find_nvcc()


def test_build_runs_nvcc_once_per_source(monkeypatch, tmp_path, capsys):
    """The build calls nvcc with the sm_90a target and rebuilds only when the
    source bytes change (a stand-in nvcc records its calls)."""
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift; done\n"
                    "echo 'ptxas info    : Used 71 registers' >&2\n")
    fake.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(mk, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(mk, "SOURCE", str(src))
    monkeypatch.setattr(mk, "BUILD_DIR", str(tmp_path / "build"))
    first = mk.build()
    assert os.path.exists(first) and "Used 71 registers" in capsys.readouterr().err
    assert mk.build() == first and log.read_text().count("\n") == 1
    args = log.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args and "-v" in args
    src.write_text("// v2\n")
    assert mk.build() != first and log.read_text().count("\n") == 2
