"""Seeded inputs shared by the port's parity tests (tests/test_torch_*.py)."""
import numpy as np
import torch

from ti5_isaacgym_tpu_torch.physics import dynamics as tdyn
from ti5_isaacgym_tpu_torch.physics import model as tmodel

N, NCP, HSCALE = 16, 32, 0.1


def make_case(seed=0):
    """Seeded numpy inputs of one substep with active contacts."""
    rng = np.random.default_rng(seed)
    tm = tmodel.load_t1()
    q0 = np.array([0, 0, -0.3, 0.6, -0.3, 0] * 2, np.float32)
    qpos = (q0 + rng.uniform(-0.15, 0.15, size=(N, 12))).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, size=N)
    quat = np.stack([np.cos(yaw / 2), 0.02 * rng.normal(size=N), 0.02 * rng.normal(size=N),
                     np.sin(yaw / 2)], -1).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    base_pos = np.stack([rng.uniform(1, 3, N), rng.uniform(1, 3, N), np.full(N, 1.0)],
                        -1).astype(np.float32)
    # rough cells: corner heights of +-1 cm around z = 0
    h = rng.uniform(-0.01, 0.01, size=(4, NCP, N)).astype(np.float32)
    # lower each base so its lowest point sits 12 mm below z = 0
    fr = tdyn.fk(tm, torch.from_numpy(base_pos), torch.from_numpy(quat), torch.zeros(N, 6),
                 torch.from_numpy(qpos), torch.zeros(N, 12))
    pw, _ = tdyn.point_world(fr, torch.as_tensor(tm.cp_body), torch.as_tensor(tm.cp_pos))
    base_pos[:, 2] -= pw[..., 2].min(dim=1).values.numpy() + 0.012
    pw = pw.numpy()
    pw[..., 2] -= (pw[..., 2].min(axis=1, keepdims=True) + 0.012)
    x0 = (np.floor(pw[..., 0] / HSCALE) * HSCALE).T.astype(np.float32)   # [ncp, N]
    y0 = (np.floor(pw[..., 1] / HSCALE) * HSCALE).T.astype(np.float32)
    anchor = (pw + rng.normal(scale=0.003, size=pw.shape)).astype(np.float32)
    return dict(
        base_pos=base_pos, base_quat=quat,
        base_vel=rng.normal(scale=0.3, size=(N, 6)).astype(np.float32),
        qpos=qpos, qvel=rng.normal(scale=1.0, size=(N, 12)).astype(np.float32),
        cp_anchor=anchor,
        tau=rng.normal(scale=30.0, size=(N, 12)).astype(np.float32),
        friction=rng.uniform(0.2, 1.3, size=N).astype(np.float32),
        restitution=rng.uniform(0.0, 0.4, size=N).astype(np.float32),
        mass=(tm.mass * rng.uniform(0.9, 1.1, size=(N, 13))).astype(np.float32),
        com=(tm.com + rng.uniform(-0.02, 0.02, size=(N, 13, 3))).astype(np.float32),
        inertia=np.broadcast_to(tm.inertia, (N, 13, 3, 3)).astype(np.float32),
        armature=rng.uniform(0.02, 3.0, size=(N, 12)).astype(np.float32),
        ext_f=rng.normal(scale=40.0, size=(N, 3)).astype(np.float32),
        ext_t=rng.normal(scale=2.0, size=(N, 3)).astype(np.float32),
        cells=dict(x0=x0, y0=y0, h00=h[0], h10=h[1], h01=h[2], h11=h[3]),
        cp_meff=rng.uniform(0.05, 0.5, size=(NCP, 2)).astype(np.float32),
    )


STATE = ("base_pos", "base_quat", "base_vel", "qpos", "qvel", "cp_anchor")
