"""Port parity: one physics substep (engine_core.substep_stacked through
substep_batched) and the component-form kinematics against the JAX package.

16 envs on rough cells, random joint states, torques, external wrench and
dynamics parameters; the bases are lowered until feet penetrate the terrain,
and the friction anchors of the points are set off the points, so the
normal, friction-cone and anchor branches all run.  Tolerances are the
reference's own (tests/test_megakernel.py:52-67): state atol 2e-4, contact
forces atol 2 N + rtol 2e-3; kinematics atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import torch

from ti5_isaacgym_tpu.physics import contact as jct
from ti5_isaacgym_tpu.physics import dynamics as jdyn
from ti5_isaacgym_tpu.physics import engine as jeng
from ti5_isaacgym_tpu.physics import engine_core as jec
from ti5_isaacgym_tpu.physics import model as jmodel
from ti5_isaacgym_tpu_torch.physics import contact as tct
from ti5_isaacgym_tpu_torch.physics import dynamics as tdyn
from ti5_isaacgym_tpu_torch.physics import engine as teng
from ti5_isaacgym_tpu_torch.physics import engine_core as tec
from ti5_isaacgym_tpu_torch.physics import model as tmodel
from torch_port_cases import HSCALE, STATE, make_case


def run_jax(c):
    jm = jmodel.load_t1()
    st = jeng.PhysicsState(**{k: jnp.asarray(c[k]) for k in STATE})
    pr = jdyn.DynamicsParams(mass=jnp.asarray(c["mass"]), com=jnp.asarray(c["com"]),
                             inertia=jnp.asarray(c["inertia"]),
                             armature=jnp.asarray(c["armature"]))
    cells = jct.CellCache(**{k: jnp.asarray(v) for k, v in c["cells"].items()})
    hf = jct.HeightField(height=jnp.zeros((2, 2)), hscale=HSCALE, offset=0.0)
    out, f = jec.substep_batched(jm, pr, hf, jct.ContactOpts(), jeng.SolverOpts(), st,
                                 jnp.asarray(c["tau"]), jnp.asarray(c["friction"]), c["cp_meff"],
                                 jnp.asarray(c["ext_f"]), jnp.asarray(c["ext_t"]),
                                 cell_cache=cells, restitution=jnp.asarray(c["restitution"]))
    return {k: np.asarray(getattr(out, k)) for k in STATE}, np.asarray(f)


def run_torch(c):
    tm = tmodel.load_t1()
    t = lambda k: torch.from_numpy(np.ascontiguousarray(c[k]))  # noqa: E731
    st = teng.PhysicsState(**{k: t(k) for k in STATE})
    pr = tdyn.DynamicsParams(mass=t("mass"), com=t("com"), inertia=t("inertia"),
                             armature=t("armature"))
    cells = tct.CellCache(**{k: torch.from_numpy(v) for k, v in c["cells"].items()})
    out, f = tec.substep_batched(tm, pr, tct.ContactOpts(), teng.SolverOpts(), HSCALE, st,
                                 t("tau"), t("friction"), c["cp_meff"], cells, t("ext_f"),
                                 t("ext_t"), restitution=t("restitution"))
    return {k: getattr(out, k).numpy() for k in STATE}, f.numpy()


def test_substep_matches_jax_with_active_contacts():
    c = make_case(0)
    js, jf = run_jax(c)
    ts, tf = run_torch(c)
    # the case really exercises contact: most envs stand on a loaded foot,
    # and some anchors move (slip or lift-off)
    feet_fz = jf[:, [6, 12], 2]
    assert (feet_fz > 5.0).any(axis=1).mean() >= 0.75, feet_fz
    assert np.any(np.abs(js["cp_anchor"] - c["cp_anchor"]) > 1e-4)
    for k in STATE:
        np.testing.assert_allclose(ts[k], js[k], atol=2e-4, err_msg=k)
    np.testing.assert_allclose(tf, jf, atol=2.0, rtol=2e-3)


def test_kinematics_match_jax():
    c = make_case(1)
    jm, tm = jmodel.load_t1(), tmodel.load_t1()
    jst = jeng.PhysicsState(**{k: jnp.asarray(c[k]) for k in STATE})
    tst = teng.PhysicsState(**{k: torch.from_numpy(np.ascontiguousarray(c[k])) for k in STATE})
    jx, jy = jec.contact_point_xy(jm, jst)
    tx, ty = tec.contact_point_xy(tm, tst)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    jk, tk = jec.ctx_kinematics(jm, jst), tec.ctx_kinematics(tm, tst)
    for k in jk:
        np.testing.assert_allclose(tk[k].numpy(), np.asarray(jk[k]), atol=1e-5, err_msg=k)
    assert tec.ctx_row_layout(2, 2) == jec.ctx_row_layout(2, 2)
    s3j = jec.s3
    comps = lambda m, st: (m.v3_unstack(st.base_pos), m.q_unstack(st.base_quat),  # noqa: E731
                           m.v3_unstack(st.base_vel[..., :3]), m.v3_unstack(st.base_vel[..., 3:]),
                           [st.qpos[..., j] for j in range(12)], [st.qvel[..., j] for j in range(12)])
    jr = jec.ctx_stack_rows(jec.model_consts(jm), [6, 12], [4, 10], *comps(s3j, jst))
    tr = tec.ctx_stack_rows(tec.model_consts(tm), [6, 12], [4, 10], *comps(tec.s3, tst))
    assert len(tr) == 24
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_scalar_divisions_round_once():
    """``_div(x, c)`` and ``_over(c, x)`` equal numpy's float32 ``x / c`` and
    ``c / x`` bit for bit, as the CUDA kernel divides, on 65,536 seeded
    values; PyTorch's own ``c / x`` (``x.reciprocal() * c``, one rounding
    more) differs on some of them.  ``tests/test_torch_gpu.py`` checks the
    same on the card."""
    x = np.random.default_rng(0).uniform(0.05, 50.0, size=1 << 16).astype(np.float32)
    t = torch.from_numpy(x)
    for c in (22.0, 0.1, 3.0):
        np.testing.assert_array_equal(tec._over(c, t).numpy(), np.float32(c) / x)
        np.testing.assert_array_equal(tec._div(t, c).numpy(), x / np.float32(c))
    assert bool(((22.0 / t).numpy() != np.float32(22.0) / x).any())
