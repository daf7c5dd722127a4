"""Rotation utilities and small-matrix algebra over batched tensors.

Port of the parts of ``ti5_isaacgym_tpu/physics/spatial.py`` that the
rollout uses.  Quaternions are ``(w, x, y, z)``; spatial vectors are
``[angular(3), linear(3)]``.  Small products are written as broadcast
multiply-sums so they stay exact float32 on every device.
"""
from __future__ import annotations

import math

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) for small static k, as a multiply-sum."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k)."""
    return torch.sum(a * v[..., None, :], dim=-1)


def mtv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., k, m)^T @ (..., k) without materializing a^T."""
    return torch.sum(a * v[..., :, None], dim=-2)


def transpose(a: torch.Tensor) -> torch.Tensor:
    return torch.swapaxes(a, -1, -2)


def cho_solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a small SPD A (..., n, n) via an unrolled Cholesky."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both (...,4) wxyz."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v (...,3) by q (...,4): R(q) @ v."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q: R(q)^T @ v."""
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(...,4) wxyz -> (...,3,3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """axis (...,3) unit, angle (...) -> quat (...,4)."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic x-y-z (roll, pitch, yaw) -> quaternion wxyz."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp_ = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        cr * cp * cy + sr * sp_ * sy,
        sr * cp * cy - cr * sp_ * sy,
        cr * sp_ * cy + sr * cp * sy,
        cr * cp * sy - sr * sp_ * cy,
    ], dim=-1)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (wxyz) -> (roll, pitch, yaw), each wrapped to (-pi, pi]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = w * w - x * x - y * y + z * z
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = w * w + x * x - y * y - z * z
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    e = torch.stack([roll, pitch, yaw], dim=-1)
    # mod to [0, 2pi) then wrap > pi down (the reference's chain)
    e = torch.remainder(e, 2.0 * math.pi)
    return torch.where(e > math.pi, e - 2.0 * math.pi, e)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q."""
    yaw = quat_to_euler_xyz(q)[..., 2]
    zero = torch.zeros_like(yaw)
    qy = quat_from_euler_xyz(zero, zero, yaw)
    return quat_rotate(qy, v)


def wrap_to_pi(a: torch.Tensor) -> torch.Tensor:
    a = torch.remainder(a + math.pi, 2.0 * math.pi)
    return torch.where(a < 0, a + 2.0 * math.pi, a) - math.pi


def skew(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))
