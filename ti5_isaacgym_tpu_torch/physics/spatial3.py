"""Component-form 3-D algebra over batched tensors.

Port of ``ti5_isaacgym_tpu/physics/spatial3.py``.  Every vector or matrix
component is its own tensor (any batch shape), so the substep math is a chain
of elementwise ops that reads the same as the CUDA kernel's per-thread code.

Types (by convention, not classes):
  * ``V3``  = tuple ``(x, y, z)`` of same-shaped tensors
  * ``M33`` = tuple of 3 rows, each a ``V3``
  * ``Q``   = tuple ``(w, x, y, z)``
  * ``Sym`` = symmetric 3x3 as ``(s00, s01, s02, s11, s12, s22)``
"""
from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# V3
# ---------------------------------------------------------------------------


def v3_zero_like(a):
    z = torch.zeros_like(a[0])
    return (z, z, z)


def v3_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def v3_norm(a):
    return torch.sqrt(v3_dot(a, a))


def v3_stack(a, dim=-1):
    """V3 -> tensor [..., 3]."""
    return torch.stack(a, dim=dim)


def v3_unstack(t, dim=-1):
    """tensor [..., 3] -> V3."""
    c = torch.movedim(t, dim, 0)
    return (c[0], c[1], c[2])


# ---------------------------------------------------------------------------
# M33 (rows of V3)
# ---------------------------------------------------------------------------


def m33_t(m):
    return (
        (m[0][0], m[1][0], m[2][0]),
        (m[0][1], m[1][1], m[2][1]),
        (m[0][2], m[1][2], m[2][2]),
    )


def m33_mv(m, v):
    return (v3_dot(m[0], v), v3_dot(m[1], v), v3_dot(m[2], v))


def m33_tmv(m, v):
    """m^T v without materializing the transpose."""
    return (
        m[0][0] * v[0] + m[1][0] * v[1] + m[2][0] * v[2],
        m[0][1] * v[0] + m[1][1] * v[1] + m[2][1] * v[2],
        m[0][2] * v[0] + m[1][2] * v[1] + m[2][2] * v[2],
    )


def m33_mm(a, b):
    bt = m33_t(b)
    return tuple(tuple(v3_dot(a[i], bt[j]) for j in range(3)) for i in range(3))


def m33_mmt(a, b):
    """a @ b^T."""
    return tuple(tuple(v3_dot(a[i], b[j]) for j in range(3)) for i in range(3))


def m33_add(a, b):
    return tuple(tuple(a[i][j] + b[i][j] for j in range(3)) for i in range(3))


def m33_sub(a, b):
    return tuple(tuple(a[i][j] - b[i][j] for j in range(3)) for i in range(3))


def m33_scale(a, s):
    return tuple(tuple(a[i][j] * s for j in range(3)) for i in range(3))


def m33_outer(a, b, s=None):
    """a b^T (optionally scaled by s)."""
    if s is None:
        return tuple(tuple(a[i] * b[j] for j in range(3)) for i in range(3))
    return tuple(tuple(a[i] * b[j] * s for j in range(3)) for i in range(3))


def m33_skew(v):
    z = torch.zeros_like(v[0]) if torch.is_tensor(v[0]) else 0.0
    return (
        (z, -v[2], v[1]),
        (v[2], z, -v[0]),
        (-v[1], v[0], z),
    )


def m33_unstack(t):
    """tensor [..., 3, 3] -> M33."""
    return tuple(tuple(t[..., i, j] for j in range(3)) for i in range(3))


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def q_unstack(t, dim=-1):
    c = torch.movedim(t, dim, 0)
    return (c[0], c[1], c[2], c[3])


def q_stack(q, dim=-1):
    return torch.stack(q, dim=dim)


def q_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def q_normalize(q):
    n = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12
    return (q[0] / n, q[1] / n, q[2] / n, q[3] / n)


def q_to_m33(q):
    w, x, y, z = q
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def q_rotate(q, v):
    """R(q) v via the two-cross formula."""
    w = q[0]
    u = (q[1], q[2], q[3])
    uv = v3_cross(u, v)
    t = v3_add(v3_scale(uv, w), v3_cross(u, uv))
    return v3_add(v, v3_scale(t, 2.0))


def q_from_axis_angle(axis, angle):
    half = 0.5 * angle
    s = torch.sin(half)
    return (torch.cos(half), axis[0] * s, axis[1] * s, axis[2] * s)


# ---------------------------------------------------------------------------
# 6x6 SPD solve in component form (unrolled Cholesky over scalars)
# ---------------------------------------------------------------------------


def chol6_solve(A, b):
    """Solve the SPD 6x6 system given as a 6x6 grid of tensors and rhs as 6
    tensors."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


# ---------------------------------------------------------------------------
# Symmetric 3x3 matrices as 6-tuples (s00, s01, s02, s11, s12, s22)
# ---------------------------------------------------------------------------


def sym_from_m33(m):
    return (m[0][0], m[0][1], m[0][2], m[1][1], m[1][2], m[2][2])


def sym_to_m33(s):
    return ((s[0], s[1], s[2]), (s[1], s[3], s[4]), (s[2], s[4], s[5]))


def sym_add(a, b):
    return tuple(a[i] + b[i] for i in range(6))


def sym_sub(a, b):
    return tuple(a[i] - b[i] for i in range(6))


def sym_scale(a, s):
    return tuple(a[i] * s for i in range(6))


def sym_identity_scaled(s):
    z = torch.zeros_like(s)
    return (s, z, z, s, z, s)


def sym_mv(s, v):
    return (
        s[0] * v[0] + s[1] * v[1] + s[2] * v[2],
        s[1] * v[0] + s[3] * v[1] + s[4] * v[2],
        s[2] * v[0] + s[4] * v[1] + s[5] * v[2],
    )


def sym_outer(a, scale=None):
    """a a^T as a sym (optionally scaled)."""
    if scale is None:
        return (a[0] * a[0], a[0] * a[1], a[0] * a[2],
                a[1] * a[1], a[1] * a[2], a[2] * a[2])
    return (a[0] * a[0] * scale, a[0] * a[1] * scale, a[0] * a[2] * scale,
            a[1] * a[1] * scale, a[1] * a[2] * scale, a[2] * a[2] * scale)


def sym_congruence(R, s):
    """R S R^T as a sym (R a full M33, S a sym)."""
    S = sym_to_m33(s)
    T = m33_mm(R, S)
    return (
        v3_dot(T[0], R[0]), v3_dot(T[0], R[1]), v3_dot(T[0], R[2]),
        v3_dot(T[1], R[1]), v3_dot(T[1], R[2]),
        v3_dot(T[2], R[2]),
    )


def sym_skew_congruence(p, s):
    """p~ S p~ as a sym (p a V3, S a sym)."""
    P = m33_skew(p)
    S = sym_to_m33(s)
    T = m33_mm(P, S)
    TP = m33_mm(T, P)
    return sym_from_m33(TP)


def sym2_of(m):
    """M + M^T as a sym."""
    return (2 * m[0][0], m[0][1] + m[1][0], m[0][2] + m[2][0],
            2 * m[1][1], m[1][2] + m[2][1], 2 * m[2][2])
