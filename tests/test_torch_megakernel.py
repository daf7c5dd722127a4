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


def _struct_fields(src):
    """[(type, name, count)] of ``struct DecimConsts`` in the CUDA source, in
    declaration order, comments stripped."""
    limits = {k: int(v) for k, v in re.findall(r"#define (MAX[BDPK]) (\d+)", src)}
    start = src.index("struct DecimConsts {")
    body = re.sub(r"//[^\n]*", "", src[start:src.index("};", start)])
    fields = []
    for typ, decl in re.findall(r"\b(int|float) ([^;]+);", body):
        for name in decl.split(","):
            dims = [int(eval(d, {}, limits)) for d in re.findall(r"\[([^\]]+)\]", name)]
            fields.append((typ, name.split("[")[0].strip(), int(np.prod(dims)) if dims else 1))
    return limits, fields


def test_consts_layout_matches_cuda_source():
    """The wrapper's constant block has the layout of ``DecimConsts`` in
    csrc/decimation.cu (same array limits, 4-byte fields, no padding, the int
    block first), and each field decoded at its offset in the source holds
    what the wrapper means to put there, the schedule tables included."""
    src = open(mk.SOURCE).read()
    limits, fields = _struct_fields(src)
    assert limits == {"MAXB": mk.MAXB, "MAXD": mk.MAXD, "MAXP": mk.MAXP, "MAXK": mk.MAXK}
    types = [t for t, _, _ in fields]
    assert types == sorted(types, key=lambda t: t != "int"), "int block must come first"
    n_ints = sum(c for t, _, c in fields if t == "int")
    n_floats = sum(c for t, _, c in fields if t == "float")
    tm = tmodel.load_t1()
    mc = tec.model_consts(tm)
    blob = mk.consts_bytes(mc, HSCALE, ContactOpts(), SolverOpts(), DEC,
                           DEFAULT_Q, TL, [6, 12], [4, 10])
    assert len(blob) == 4 * (n_ints + n_floats)
    ints = np.frombuffer(blob[:4 * n_ints], np.int32)
    floats = np.frombuffer(blob[4 * n_ints:], np.float32)
    at, off = {}, {"int": 0, "float": 0}
    for typ, name, count in fields:
        arr = ints if typ == "int" else floats
        at[name] = arr[off[typ]:off[typ] + count]
        off[typ] += count
    assert [int(at[k][0]) for k in ("nb", "nd", "ncp", "dec", "nfeet", "nknees", "nlev")] == \
        [13, 12, 32, DEC, 2, 2, 7]
    assert list(at["parent"][:13]) == list(mc.parent)
    assert list(at["cp_body"][:32]) == list(mc.cp_body)
    assert list(at["feet"][:2]) == [6, 12] and list(at["knees"][:2]) == [4, 10]
    sch = mk.schedule(mc)
    for name in ("lev_start", "lev_body", "ch_start", "ch_list", "cp_start", "cp_order"):
        assert list(at[name][:len(sch[name])]) == sch[name], name
    np.testing.assert_array_equal(at["cp_pos"][:96], np.asarray(mc.cp_pos_c, np.float32).ravel())
    np.testing.assert_array_equal(at["torque_limit"][:12], TL)
    assert at["hscale"][0] == np.float32(HSCALE)
    assert at["max_qvel"][0] == np.float32(SolverOpts().max_qvel)


K1_SPEC = os.path.join(os.path.dirname(__file__), "..", "ti5_isaacgym_tpu", "resources",
                       "k1_model.json")
MODELS = {"t1": tmodel.load_t1, "k1": lambda: tmodel.load(K1_SPEC)}


@pytest.fixture(params=sorted(MODELS))
def model_consts(request):
    return tec.model_consts(MODELS[request.param]())


def test_schedule_levels_follow_the_tree(model_consts):
    """Every body sits on exactly one level, and its parent on an earlier one."""
    mc, sch = model_consts, mk.schedule(model_consts)
    starts, bodies = sch["lev_start"], sch["lev_body"]
    assert starts[0] == 0 and starts[-1] == mc.nb and len(starts) == sch["nlev"] + 1
    assert sorted(bodies) == list(range(mc.nb)) and bodies[0] == 0
    level = {}
    for lv in range(sch["nlev"]):
        members = bodies[starts[lv]:starts[lv + 1]]
        assert members == sorted(members) and members
        for i in members:
            level[i] = lv
    for i in range(1, mc.nb):
        assert level[mc.parent[i]] == level[i] - 1


def test_schedule_children_in_fold_order(model_consts):
    """Each parent's children are its own, in descending index (the plain
    version's inward loop ``for i in range(nb - 1, 0, -1)``)."""
    mc, sch = model_consts, mk.schedule(model_consts)
    st, ch = sch["ch_start"], sch["ch_list"]
    assert len(st) == mc.nb + 1 and st[-1] == mc.nb - 1
    for p in range(mc.nb):
        kids = ch[st[p]:st[p + 1]]
        assert kids == sorted(kids, reverse=True)
        assert kids == [i for i in range(mc.nb - 1, 0, -1) if mc.parent[i] == p]


def test_schedule_points_in_sum_order(model_consts):
    """Each body's contact points are its own, in ascending index, and every
    point belongs to exactly one body."""
    mc, sch = model_consts, mk.schedule(model_consts)
    st, order = sch["cp_start"], sch["cp_order"]
    assert sorted(order) == list(range(mc.ncp)) and st[-1] == mc.ncp
    for b in range(mc.nb):
        pts = order[st[b]:st[b + 1]]
        assert pts == sorted(pts) and all(mc.cp_body[c] == b for c in pts)


def test_schedule_fits_the_kernel_limits(model_consts):
    mc, sch = model_consts, mk.schedule(model_consts)
    assert mc.nb <= mk.MAXB and mc.nd <= mk.MAXD and mc.ncp <= mk.MAXP
    assert len(sch["lev_start"]) <= mk.MAXB + 1 and len(sch["lev_body"]) <= mk.MAXB
    assert len(sch["ch_start"]) <= mk.MAXB + 1 and len(sch["ch_list"]) <= mk.MAXB
    assert len(sch["cp_start"]) <= mk.MAXB + 1 and len(sch["cp_order"]) <= mk.MAXP
    blob = mk.consts_bytes(mc, HSCALE, ContactOpts(), SolverOpts(), DEC, DEFAULT_Q, TL,
                           [6, 12], [4, 10])
    _, fields = _struct_fields(open(mk.SOURCE).read())
    assert len(blob) == 4 * sum(c for _, _, c in fields)


def test_schedule_folds_like_the_serial_loop(model_consts):
    """Level by level, each parent folding its children in the table's order,
    gives the serial inward loop's float32 sums bit for bit (the kernel's
    ABA pass 2 and the plain version's), with each body's contribution a
    function of its already-folded value."""
    mc, sch = model_consts, mk.schedule(model_consts)
    rng = np.random.default_rng(7)
    own = rng.normal(size=(mc.nb, 6)).astype(np.float32) * np.float32(1e3)
    contrib = lambda v: (v * np.float32(0.37) + np.float32(1.1)).astype(np.float32)  # noqa: E731
    serial = own.copy()
    for i in range(mc.nb - 1, 0, -1):
        serial[mc.parent[i]] = serial[mc.parent[i]] + contrib(serial[i])
    level = own.copy()
    st, bodies = sch["lev_start"], sch["lev_body"]
    for lv in range(sch["nlev"] - 1, 0, -1):
        out = {i: contrib(level[i]) for i in bodies[st[lv]:st[lv + 1]]}
        for p in bodies[st[lv - 1]:st[lv]]:
            for c in sch["ch_list"][sch["ch_start"][p]:sch["ch_start"][p + 1]]:
                level[p] = level[p] + out[c]
    np.testing.assert_array_equal(level, serial)


def test_schedule_rejects_a_parent_after_its_child():
    mc = tec.model_consts(tmodel.load_t1())
    parent = list(mc.parent)
    parent[3] = 5
    with pytest.raises(ValueError, match="parent"):
        mk.schedule(mc._replace(parent=parent))


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


def test_wrapper_builds_static_inputs_once():
    """The constant block and the default apparent-mass rows are made once
    per set of static arguments, not on every launch (a fresh pageable copy
    of the masses would stall the stream each step)."""
    mc = tec.model_consts(tmodel.load_t1())
    args = (mc, HSCALE, ContactOpts(), SolverOpts(), DEC, DEFAULT_Q, TL, [6, 12], [4, 10])
    first = mk._cached_consts(*args)
    assert mk._cached_consts(*args) is first
    assert first == mk.consts_bytes(*args)
    assert mk._cached_consts(*args[:-2], None, None) != first
    meff = np.random.default_rng(0).uniform(0.05, 0.5, size=(32, 2)).astype(np.float32)
    rows = mk._default_meff(meff, 16, "cpu")
    assert mk._default_meff(meff.copy(), 16, "cpu") is rows
    assert tuple(rows.shape) == (64, 16) and rows.is_contiguous()
    np.testing.assert_array_equal(rows[:, 3].numpy(), meff.T.reshape(-1))
    assert mk._default_meff(meff, 15, "cpu") is not rows
