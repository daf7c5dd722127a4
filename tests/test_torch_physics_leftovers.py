"""Port parity: the per-point physics path (``engine.substep`` through
``contact.point_contact_forces``) and the per-point cell gather
(``contact.gather_contact_cells``) against the JAX package.

* ``substep`` on a batch of 16 seeded states on a rough heightfield (about
  half the points in contact) equals JAX's vmapped ``substep`` over 5
  substeps: state atol 2e-4, per-body contact forces atol 2 N + rtol 2e-3
  (the tolerances of tests/test_megakernel.py:52-67);
* the checks of tests/test_engine.py on the port's substep: the statue
  stands with stiff gains, the feet carry the weight, nothing sinks or
  skates, the state stays finite and two runs are equal;
* ``gather_contact_cells`` equals JAX's exactly, and the port's supercell
  gather equals the port's ``gather_contact_cells`` for every point inside
  the margin, as tests/test_terrain.py:132-160 requires of JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.physics import contact as jct
from ti5_isaacgym_tpu.physics import dynamics as jdyn
from ti5_isaacgym_tpu.physics import engine as jeng
from ti5_isaacgym_tpu.physics.model import load_t1 as jload_t1
from ti5_isaacgym_tpu_torch.physics import contact as tct
from ti5_isaacgym_tpu_torch.physics import dynamics as tdyn
from ti5_isaacgym_tpu_torch.physics import engine as teng
from ti5_isaacgym_tpu_torch.physics import model as tmodel

from torch_port_cases import STATE, make_case

N, SUBSTEPS = 16, 5
HSCALE, OFFSET = 0.1, 1.0
TM = tmodel.load_t1()
ARMATURE = np.array([0.15, 0.15, 2.7, 2.7, 0.08, 0.021] * 2, np.float32)
DEFAULT_QPOS = np.array([0, 0, -0.3, 0.6, -0.3, 0] * 2, np.float32)
KP = np.array([50, 70, 90, 120, 50, 30] * 2, np.float32)
KD = np.array([5, 7, 9, 12, 5, 3] * 2, np.float32)


def _rough(seed=0, rows=50, cols=50):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.01, 0.01, size=(rows, cols)).astype(np.float32)


def test_substep_matches_jax():
    c = make_case(0)
    height = _rough()
    jhf = jct.HeightField(height=jnp.asarray(height), hscale=HSCALE, offset=OFFSET)
    thf = tct.HeightField(height=torch.from_numpy(height), hscale=HSCALE, offset=OFFSET)
    jm = jload_t1()
    jparams = jdyn.DynamicsParams(mass=jnp.asarray(c["mass"]), com=jnp.asarray(c["com"]),
                                  inertia=jnp.asarray(c["inertia"]),
                                  armature=jnp.asarray(c["armature"]))
    tparams = tdyn.DynamicsParams(mass=torch.from_numpy(c["mass"]),
                                  com=torch.from_numpy(c["com"]),
                                  inertia=torch.from_numpy(c["inertia"].copy()),
                                  armature=torch.from_numpy(c["armature"]))
    copts_j, sopts_j = jct.ContactOpts(), jeng.SolverOpts()
    copts_t, sopts_t = tct.ContactOpts(), teng.SolverOpts()
    js = jeng.PhysicsState(**{k: jnp.asarray(c[k]) for k in STATE})
    ts = teng.PhysicsState(**{k: torch.from_numpy(c[k]) for k in STATE})
    step = jax.vmap(lambda s, p, tau, f, bf, bt, r: jeng.substep(
        jm, p, jhf, copts_j, sopts_j, s, tau, f, jnp.asarray(c["cp_meff"]), bf, bt, r))
    args = [c[k] for k in ("tau", "friction", "ext_f", "ext_t", "restitution")]
    in_contact = 0.0
    for i in range(SUBSTEPS):
        js, jf = step(js, jparams, *map(jnp.asarray, args))
        ts, tf = teng.substep(TM, tparams, thf, copts_t, sopts_t, ts,
                              *map(torch.from_numpy, args[:2]), c["cp_meff"],
                              *map(torch.from_numpy, args[2:4]),
                              restitution=torch.from_numpy(args[4]))
        for k in STATE:
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                       atol=2e-4, err_msg=f"substep {i} {k}")
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2.0, rtol=2e-3,
                                   err_msg=f"substep {i} contact forces")
        in_contact = max(in_contact, float((np.abs(np.asarray(jf)).sum(-1) > 1.0).mean()))
    assert in_contact > 0.1


def test_point_contact_forces_matches_jax():
    """The force law alone, with and without restitution, on points around
    the surface (some above it, some below, some sliding)."""
    rng = np.random.default_rng(4)
    height = _rough(1)
    jhf = jct.HeightField(height=jnp.asarray(height), hscale=HSCALE, offset=OFFSET)
    thf = tct.HeightField(height=torch.from_numpy(height), hscale=HSCALE, offset=OFFSET)
    k = 64
    p = np.stack([rng.uniform(0.5, 3.5, k), rng.uniform(0.5, 3.5, k),
                  rng.uniform(-0.03, 0.01, k)], -1).astype(np.float32)
    v = rng.normal(scale=0.3, size=(k, 3)).astype(np.float32)
    anchor = (p + rng.normal(scale=0.01, size=(k, 3))).astype(np.float32)
    meff = rng.uniform(0.05, 0.5, size=(k, 2)).astype(np.float32)
    for rest in (None, 0.3):
        want = jct.point_contact_forces(jhf, jct.ContactOpts(), jnp.asarray(p), jnp.asarray(v),
                                        jnp.asarray(anchor), 0.7, jnp.asarray(meff),
                                        restitution=rest)
        got = tct.point_contact_forces(thf, tct.ContactOpts(), torch.from_numpy(p),
                                       torch.from_numpy(v), torch.from_numpy(anchor), 0.7,
                                       torch.from_numpy(meff),
                                       restitution=None if rest is None else torch.tensor(rest))
        for name, g, w, atol in zip(("force", "depth", "anchor"), got, want, (2e-2, 1e-6, 1e-6)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-5,
                                       err_msg=f"{name}, restitution {rest}")
    xy = torch.from_numpy(p[:, :2])
    np.testing.assert_allclose(tct.sample_height(thf, xy).numpy(),
                               np.asarray(jct.sample_height(jhf, jnp.asarray(p[:, :2]))),
                               atol=1e-7)
    np.testing.assert_allclose(tct.surface_normal(thf, xy).numpy(),
                               np.asarray(jct.surface_normal(jhf, jnp.asarray(p[:, :2]))),
                               atol=1e-6)


def _pd_rollout(n_sub, gain_scale=1.0, n=1):
    """The PD law of tests/test_engine.py on flat ground from its drop pose."""
    params = tdyn.nominal_params(TM).replace(armature=torch.from_numpy(ARMATURE))
    state0 = teng.init_state(TM, [0.0, 0.0, 0.945], [1.0, 0.0, 0.0, 0.0], DEFAULT_QPOS)
    meff = teng.probe_contact_masses(TM, params, state0)
    state = teng.init_state(TM, [[0.0, 0.0, 0.945]] * n, [[1.0, 0.0, 0.0, 0.0]] * n,
                            [DEFAULT_QPOS] * n)
    kp = torch.from_numpy(KP * gain_scale)
    kd = torch.from_numpy(KD * np.sqrt(gain_scale))
    lim = torch.from_numpy(TM.dof_effort * 0.85 * gain_scale)
    q0, fric = torch.from_numpy(DEFAULT_QPOS), torch.full((n,), 0.8)
    terrain, copts, sopts = tct.flat_terrain(), tct.ContactOpts(), teng.SolverOpts()
    cf = torch.zeros(n, TM.nb, 3)
    for _ in range(n_sub):
        tau = torch.clamp(kp * (q0 - state.qpos) - kd * state.qvel, -lim, lim)
        state, cf = teng.substep(TM, params, terrain, copts, sopts, state, tau, fric, meff)
    return state, cf, params


def test_statue_stands_and_carries_its_weight():
    """tests/test_engine.py::test_statue_stands and test_penetration_is_small
    on the port: with stiff joints the robot stands, upright and in place,
    the feet carry its weight, and no point sinks 2 cm."""
    state, cf, params = _pd_rollout(2000, gain_scale=50.0)
    e = tdyn.sp.quat_to_euler_xyz(state.base_quat)[0]
    assert abs(float(e[0])) < 0.05 and abs(float(e[1])) < 0.05, e
    assert 0.9 < float(state.base_pos[0, 2]) < 0.96
    assert float(torch.linalg.vector_norm(state.base_pos[0, :2])) < 0.05
    feet = list(TM.feet_bodies)
    weight = float(params.mass.sum()) * 9.81
    total_up = float(cf[0, feet, 2].sum())
    assert abs(total_up - weight) / weight < 0.05, (total_up, weight)
    frames = tdyn.fk(TM, state.base_pos, state.base_quat, state.base_vel, state.qpos,
                     state.qvel)
    p_w, _ = tdyn.point_world(frames, torch.as_tensor(TM.cp_body), torch.as_tensor(TM.cp_pos))
    assert float(torch.max(-p_w[..., 2])) < 0.02


def test_substep_finite_and_deterministic():
    """tests/test_engine.py::test_determinism and test_vmap_batch: a batch of
    8 stays finite, has the batch's shapes, and two runs are equal."""
    s1, cf1, _ = _pd_rollout(100, n=8)
    s2, cf2, _ = _pd_rollout(100, n=8)
    assert s1.base_pos.shape == (8, 3) and cf1.shape == (8, TM.nb, 3)
    for k in STATE:
        assert bool(torch.isfinite(getattr(s1, k)).all())
        assert torch.equal(getattr(s1, k), getattr(s2, k)), k
    assert torch.equal(cf1, cf2)


def test_gather_contact_cells_matches_jax():
    rng = np.random.default_rng(3)
    height = rng.random((57, 49)).astype(np.float32)
    jhf = jct.HeightField(height=jnp.asarray(height), hscale=0.1, offset=0.5)
    thf = tct.HeightField(height=torch.from_numpy(height), hscale=0.1, offset=0.5)
    np.testing.assert_array_equal(tct.packed_cell_corners(thf.height).numpy(),
                                  np.asarray(jct.packed_cell_corners(jhf.height)))
    # points inside and beyond the map on every side (the clip)
    px = rng.uniform(-1.5, 6.5, size=(7, 96)).astype(np.float32)
    py = rng.uniform(-1.5, 5.8, size=(7, 96)).astype(np.float32)
    want = jct.gather_contact_cells(jhf, jct.packed_cell_corners(jhf.height),
                                    jnp.asarray(px), jnp.asarray(py))
    got = tct.gather_contact_cells(thf, tct.packed_cell_corners(thf.height),
                                   torch.from_numpy(px), torch.from_numpy(py))
    for f in ("x0", "y0", "h00", "h10", "h01", "h11"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("seed", [3, 4])
def test_supercell_matches_gather_contact_cells(seed):
    """As tests/test_terrain.py:132-160 on the port: every point within the
    margin of its base gets the same cell from the supercell gather as from
    ``gather_contact_cells``, and the same corner heights as the bf16-stored
    map (within a bf16 ulp of the float32 map)."""
    rng = np.random.RandomState(seed)
    height = rng.rand(57, 49).astype(np.float32)
    hf = tct.HeightField(height=torch.from_numpy(height), hscale=0.1, offset=0.5)
    stb = tct.build_supertable(height, 0.1, 0.5, supercell=8, margin_m=0.7)
    k, n = 7, 96
    bx = torch.from_numpy(rng.uniform(0.0, 4.5, size=n).astype(np.float32))
    by = torch.from_numpy(rng.uniform(0.0, 4.0, size=n).astype(np.float32))
    off = rng.uniform(-0.68, 0.68, size=(2, k, n)).astype(np.float32)
    px, py = bx[None] + torch.from_numpy(off[0]), by[None] + torch.from_numpy(off[1])
    got = tct.gather_cells_supercell(stb, bx, by, px, py)
    want = tct.gather_contact_cells(hf, tct.packed_cell_corners(hf.height), px, py)
    hf16 = hf.replace(height=hf.height.to(torch.bfloat16).float())
    want16 = tct.gather_contact_cells(hf16, tct.packed_cell_corners(hf16.height), px, py)
    for f in ("x0", "y0"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("h00", "h10", "h01", "h11"):
        assert torch.equal(getattr(got, f), getattr(want16, f)), f
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                   rtol=0, atol=2.0 ** -8, err_msg=f)
