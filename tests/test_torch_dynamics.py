"""Port parity: physics/dynamics.py (fk, aba) and engine.probe_contact_masses
on the T1 model against the JAX package.

The JAX functions act on one env (vmapped here); the port's take a batch.
Tolerances: kinematics are short float32 chains (atol 1e-5); the ABA
accelerations accumulate over 13 bodies in another operation order
(rtol/atol 1e-3 relative to accelerations of O(1-100)); the apparent masses
finite-difference two ABA solves (rtol 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ti5_isaacgym_tpu.physics import dynamics as jdyn
from ti5_isaacgym_tpu.physics import engine as jeng
from ti5_isaacgym_tpu.physics import model as jmodel
from ti5_isaacgym_tpu_torch.physics import dynamics as tdyn
from ti5_isaacgym_tpu_torch.physics import engine as teng
from ti5_isaacgym_tpu_torch.physics import model as tmodel

N = 8


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(
        base_pos=rng.normal(size=(N, 3)).astype(np.float32),
        base_quat=q,
        base_vel=rng.normal(size=(N, 6)).astype(np.float32),
        qpos=rng.uniform(-0.5, 0.5, size=(N, 12)).astype(np.float32),
        qvel=rng.normal(size=(N, 12)).astype(np.float32),
        tau=rng.normal(scale=20.0, size=(N, 12)).astype(np.float32),
        f_ext=rng.normal(scale=50.0, size=(N, 13, 6)).astype(np.float32),
        armature=rng.uniform(0.01, 0.5, size=(N, 12)).astype(np.float32),
    )


def test_model_matches_jax():
    jm, tm = jmodel.load_t1(), tmodel.load_t1()
    assert (tm.nb, tm.num_dof, tm.ncp) == (13, 12, 32)
    assert tm.feet_bodies == jm.feet_bodies and tm.knee_bodies == jm.knee_bodies
    for f in ("joint_pos", "joint_rot", "joint_axis", "mass", "com", "inertia", "dof_lower",
              "dof_upper", "dof_effort", "dof_velocity", "cp_body", "cp_pos", "parent"):
        np.testing.assert_array_equal(getattr(tm, f), np.asarray(getattr(jm, f)), err_msg=f)


def test_fk_and_aba_match_jax():
    jm, tm = jmodel.load_t1(), tmodel.load_t1()
    x = _inputs(1)
    jp = jdyn.DynamicsParams(mass=jm.mass, com=jm.com, inertia=jm.inertia,
                             armature=jnp.asarray(x["armature"]))

    def jax_one(bp, bq, bv, qp, qv, tau, fe, arm):
        fr = jdyn.fk(jm, bp, bq, bv, qp, qv)
        a0, qdd = jdyn.aba(jm, jp.replace(armature=arm), fr, qv, tau, fe)
        return fr, a0, qdd

    jfr, ja0, jqdd = jax.vmap(jax_one)(*(jnp.asarray(x[k]) for k in (
        "base_pos", "base_quat", "base_vel", "qpos", "qvel", "tau", "f_ext", "armature")))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    tfr = tdyn.fk(tm, t["base_pos"], t["base_quat"], t["base_vel"], t["qpos"], t["qvel"])
    tp = tdyn.nominal_params(tm).replace(armature=t["armature"])
    ta0, tqdd = tdyn.aba(tm, tp, tfr, t["qvel"], t["tau"], t["f_ext"])
    for name in ("pos", "rot", "vel_ang", "vel_lin"):
        np.testing.assert_allclose(getattr(tfr, name).numpy(), np.asarray(getattr(jfr, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(ta0.numpy(), np.asarray(ja0), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(tqdd.numpy(), np.asarray(jqdd), atol=1e-3, rtol=1e-3)

    # point_world on the collision points
    jpw, jvw = jax.vmap(lambda fr: jdyn.point_world(fr, jm.cp_body, jm.cp_pos))(jfr)
    tpw, tvw = tdyn.point_world(tfr, torch.as_tensor(tm.cp_body), torch.as_tensor(tm.cp_pos))
    np.testing.assert_allclose(tpw.numpy(), np.asarray(jpw), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tvw.numpy(), np.asarray(jvw), atol=1e-4, rtol=1e-5)


def test_probe_contact_masses_matches_jax():
    jm, tm = jmodel.load_t1(), tmodel.load_t1()
    arm = np.linspace(0.05, 2.0, 12).astype(np.float32)
    q0 = np.array([0, 0, -0.3, 0.6, -0.3, 0] * 2, np.float32)
    js = jeng.PhysicsState(base_pos=np.array([0, 0, 0.95], np.float32),
                           base_quat=np.array([1, 0, 0, 0], np.float32),
                           base_vel=np.zeros(6, np.float32), qpos=q0,
                           qvel=np.zeros(12, np.float32), cp_anchor=np.zeros((32, 3), np.float32))
    want = np.asarray(jeng.probe_contact_masses(
        jm, jdyn.nominal_params(jm).replace(armature=jnp.asarray(arm)), js))
    ts = teng.PhysicsState(**{k: torch.from_numpy(getattr(js, k)) for k in (
        "base_pos", "base_quat", "base_vel", "qpos", "qvel", "cp_anchor")})
    got = teng.probe_contact_masses(tm, tdyn.nominal_params(tm).replace(
        armature=torch.from_numpy(arm)), ts)
    assert got.shape == (32, 2)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
