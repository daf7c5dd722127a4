"""Port parity: physics/spatial3.py and physics/spatial.py against the JAX package.

Inputs come from numpy (seeded) and go through both packages.  Tolerance:
float32 rounding of short elementwise chains, atol/rtol 1e-5, unless noted.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.physics import spatial as jsp
from ti5_isaacgym_tpu.physics import spatial3 as js3
from ti5_isaacgym_tpu_torch.physics import spatial as tsp
from ti5_isaacgym_tpu_torch.physics import spatial3 as ts3

N = 64


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quat(rng, n=N):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _spd(rng, n, k):
    a = rng.normal(size=(n, k, k)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + k * np.eye(k, dtype=np.float32)).astype(np.float32)


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


ARRAY_FNS = {
    "quat_rotate": lambda m, q, v, a, M, B: m.quat_rotate(q, v),
    "quat_rotate_inverse": lambda m, q, v, a, M, B: m.quat_rotate_inverse(q, v),
    "quat_to_mat": lambda m, q, v, a, M, B: m.quat_to_mat(q),
    "quat_to_euler_xyz": lambda m, q, v, a, M, B: m.quat_to_euler_xyz(q),
    "quat_apply_yaw": lambda m, q, v, a, M, B: m.quat_apply_yaw(q, v),
    "quat_from_axis_angle": lambda m, q, v, a, M, B: m.quat_from_axis_angle(v, a),
    "wrap_to_pi": lambda m, q, v, a, M, B: m.wrap_to_pi(a * 7.0),
    "skew": lambda m, q, v, a, M, B: m.skew(v),
    "mm": lambda m, q, v, a, M, B: m.mm(M, B),
    "mv": lambda m, q, v, a, M, B: m.mv(M, v),
    "mtv": lambda m, q, v, a, M, B: m.mtv(M, v),
}


@pytest.mark.parametrize("name", sorted(ARRAY_FNS))
def test_spatial_matches_jax(name):
    rng = _rng(1)
    q, v = _quat(rng), rng.normal(size=(N, 3)).astype(np.float32)
    a = rng.uniform(-3, 3, size=(N,)).astype(np.float32)
    M, B = rng.normal(size=(N, 3, 3)).astype(np.float32), rng.normal(size=(N, 3, 3)).astype(np.float32)
    fn = ARRAY_FNS[name]
    want = fn(jsp, *map(jnp.asarray, (q, v, a, M, B)))
    got = fn(tsp, *map(torch.from_numpy, (q, v, a, M, B)))
    # angle extraction near the +-pi wrap: compare on the circle
    if name in ("quat_to_euler_xyz", "wrap_to_pi"):
        d = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(want))))
        assert np.max(np.abs(d)) < 1e-5
    else:
        _close(got, want)


def test_cho_solve_psd_matches_jax():
    rng = _rng(2)
    A, b = _spd(rng, N, 6), rng.normal(size=(N, 6)).astype(np.float32)
    # well-conditioned SPD 6x6 (eigenvalues >= 6): float32 solve to 1e-4
    _close(tsp.cho_solve_psd(torch.from_numpy(A), torch.from_numpy(b)),
           jsp.cho_solve_psd(jnp.asarray(A), jnp.asarray(b)), atol=1e-4, rtol=1e-4)


def _comp(mod, arrs):
    """Component-form inputs for spatial3 from [N, ...] arrays."""
    q, v, w, M, S = arrs
    return (mod.q_unstack(q), mod.v3_unstack(v), mod.v3_unstack(w), mod.m33_unstack(M),
            mod.sym_from_m33(mod.m33_unstack(S)))


S3_FNS = {
    "q_mul": lambda m, q, v, w, M, S: m.q_mul(q, m.q_normalize(q[::-1])),
    "q_normalize": lambda m, q, v, w, M, S: m.q_normalize(tuple(c * 3.0 for c in q)),
    "q_to_m33": lambda m, q, v, w, M, S: m.q_to_m33(q),
    "q_rotate": lambda m, q, v, w, M, S: m.q_rotate(q, v),
    "q_from_axis_angle": lambda m, q, v, w, M, S: m.q_from_axis_angle(v, w[0]),
    "v3_cross": lambda m, q, v, w, M, S: m.v3_cross(v, w),
    "v3_norm": lambda m, q, v, w, M, S: (m.v3_norm(v),),
    "m33_mm": lambda m, q, v, w, M, S: m.m33_mm(M, m.m33_t(M)),
    "m33_mmt": lambda m, q, v, w, M, S: m.m33_mmt(M, m.q_to_m33(q)),
    "m33_tmv": lambda m, q, v, w, M, S: m.m33_tmv(M, v),
    "m33_outer": lambda m, q, v, w, M, S: m.m33_outer(v, w, w[2]),
    "m33_skew": lambda m, q, v, w, M, S: m.m33_skew(v),
    "sym_mv": lambda m, q, v, w, M, S: m.sym_mv(S, v),
    "sym_outer": lambda m, q, v, w, M, S: m.sym_outer(v, w[1]),
    "sym_congruence": lambda m, q, v, w, M, S: m.sym_congruence(m.q_to_m33(q), S),
    "sym_skew_congruence": lambda m, q, v, w, M, S: m.sym_skew_congruence(v, S),
    "sym_skew_congruence_const": lambda m, q, v, w, M, S: m.sym_skew_congruence(
        (0.1, -0.2, 0.05), S),
    "sym2_of": lambda m, q, v, w, M, S: m.sym2_of(M),
}


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for e in x for y in _flat(e)]
    return [np.asarray(x, np.float32)]


@pytest.mark.parametrize("name", sorted(S3_FNS))
def test_spatial3_matches_jax(name):
    rng = _rng(3)
    arrs = (_quat(rng), rng.normal(size=(N, 3)).astype(np.float32),
            rng.normal(size=(N, 3)).astype(np.float32),
            rng.normal(size=(N, 3, 3)).astype(np.float32), _spd(rng, N, 3))
    want = S3_FNS[name](js3, *_comp(js3, tuple(map(jnp.asarray, arrs))))
    got = S3_FNS[name](ts3, *_comp(ts3, tuple(map(torch.from_numpy, arrs))))
    for g, w in zip(_flat(got), _flat(want)):
        _close(np.broadcast_to(g, w.shape), w, atol=1e-5, rtol=1e-5)


def test_chol6_solve_matches_jax():
    rng = _rng(4)
    A, b = _spd(rng, N, 6), rng.normal(size=(N, 6)).astype(np.float32)
    j = js3.chol6_solve([[jnp.asarray(A[:, i, k]) for k in range(6)] for i in range(6)],
                        [jnp.asarray(b[:, i]) for i in range(6)])
    t = ts3.chol6_solve([[torch.from_numpy(A[:, i, k].copy()) for k in range(6)] for i in range(6)],
                        [torch.from_numpy(b[:, i].copy()) for i in range(6)])
    for g, w in zip(t, j):
        _close(g, w, atol=1e-4, rtol=1e-4)
