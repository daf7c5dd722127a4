"""Point-vs-heightfield contact: terrain tables and the frozen-cell cache.

Port of ``ti5_isaacgym_tpu/physics/contact.py``.  The rollout's contact
force law is evaluated inside the substep (:func:`.engine_core.substep_stacked`
and the CUDA kernel); this module picks each contact point's bilinear
terrain cell once per policy step (:func:`gather_cells_supercell`).

The TPU version extracts the four cell corners from a gathered supercell
patch with one-hot contractions (an XLA einsum).  Here the corners are read
with one direct gather from the same bf16 patch table, which returns the
same stored values.

The per-point path (:func:`sample_height`, :func:`surface_normal`,
:func:`point_contact_forces`, used by :func:`.engine.substep`) and the
per-point cell gather (:func:`gather_contact_cells`, the reference the
supercell gather must equal inside its margin) complete the module.
Every division by the cell size or by ``dt`` goes through
:func:`.engine_core._div` or :func:`.engine_core._over`: PyTorch's CUDA
kernels multiply by a reciprocal instead, which can pick another cell (or
height-scan texel) at a cell edge than the reference's one division.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def _div(x, c: float):
    # engine_core imports this module: import its helpers at the call
    from .engine_core import _div as div

    return div(x, c)


def _over(c: float, x):
    from .engine_core import _over as over

    return over(c, x)


@dataclass
class HeightField:
    """Terrain height map: ``height[i, j]`` is the height at world
    ``x = i * hscale - offset, y = j * hscale - offset``."""

    height: torch.Tensor   # (rows, cols) float32 meters
    hscale: float
    offset: float

    def replace(self, **kw) -> "HeightField":
        return HeightField(**{**self.__dict__, **kw})


def flat_terrain(device="cpu") -> HeightField:
    return HeightField(height=torch.zeros((2, 2), device=device), hscale=1.0, offset=1.0)


def sample_height(hf: HeightField, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear height sample at world xy (..., 2) -> (...)."""
    u = _div(xy[..., 0] + hf.offset, hf.hscale)
    v = _div(xy[..., 1] + hf.offset, hf.hscale)
    rows, cols = hf.height.shape
    i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, rows - 2)
    j0 = torch.clamp(torch.floor(v).to(torch.int64), 0, cols - 2)
    fu = torch.clamp(u - i0, 0.0, 1.0)
    fv = torch.clamp(v - j0, 0.0, 1.0)
    h = hf.height
    return (h[i0, j0] * (1 - fu) * (1 - fv) + h[i0 + 1, j0] * fu * (1 - fv)
            + h[i0, j0 + 1] * (1 - fu) * fv + h[i0 + 1, j0 + 1] * fu * fv)


def surface_normal(hf: HeightField, xy: torch.Tensor) -> torch.Tensor:
    """Unit surface normal from the height gradient, (..., 2) -> (..., 3)."""
    eps = hf.hscale * 0.5
    zero = torch.zeros_like(xy[..., 0])
    ex = torch.stack([torch.full_like(zero, eps), zero], dim=-1)
    ey = torch.stack([zero, torch.full_like(zero, eps)], dim=-1)
    dhdx = _div(sample_height(hf, xy + ex) - sample_height(hf, xy - ex), 2 * eps)
    dhdy = _div(sample_height(hf, xy + ey) - sample_height(hf, xy - ey), 2 * eps)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def sample_height_min3(hf: HeightField, xy: torch.Tensor) -> torch.Tensor:
    """Min-of-3-texels sample used for height-scan observations."""
    u = _div(xy[..., 0] + hf.offset, hf.hscale)
    v = _div(xy[..., 1] + hf.offset, hf.hscale)
    rows, cols = hf.height.shape
    i0 = torch.clamp(u.to(torch.int64), 0, rows - 2)
    j0 = torch.clamp(v.to(torch.int64), 0, cols - 2)
    h = hf.height
    return torch.minimum(torch.minimum(h[i0, j0], h[i0 + 1, j0]), h[i0, j0 + 1])


@dataclass
class CellCache:
    """Frozen bilinear cell per contact point, all fields [ncp, N] float32:
    the world xy of the cell's (i0, j0) corner and its four corner heights."""

    x0: torch.Tensor
    y0: torch.Tensor
    h00: torch.Tensor
    h10: torch.Tensor
    h01: torch.Tensor
    h11: torch.Tensor


def packed_cell_corners(height: torch.Tensor) -> torch.Tensor:
    """[rows, cols] height map -> [rows*cols, 4] per-cell corner table: entry
    ``i*cols + j`` holds ``(h[i,j], h[i+1,j], h[i,j+1], h[i+1,j+1])`` (edge
    rows and columns replicate)."""
    h00 = height
    h10 = torch.cat([height[1:], height[-1:]], dim=0)
    h01 = torch.cat([height[:, 1:], height[:, -1:]], dim=1)
    h11 = torch.cat([h10[:, 1:], h10[:, -1:]], dim=1)
    return torch.stack([h00, h10, h01, h11], dim=-1).reshape(-1, 4)


def gather_contact_cells(hf: HeightField, packed: torch.Tensor,
                         px: torch.Tensor, py: torch.Tensor) -> CellCache:
    """Every contact point's bilinear cell, one gather per point: the
    reference of :func:`gather_cells_supercell`.

    packed: ``packed_cell_corners(hf.height)``; px, py: [ncp, N] world xy of
    the contact points.
    """
    rows, cols = hf.height.shape
    u = _div(px + hf.offset, hf.hscale)
    v = _div(py + hf.offset, hf.hscale)
    i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, rows - 2)
    j0 = torch.clamp(torch.floor(v).to(torch.int64), 0, cols - 2)
    corners = packed[torch.clamp(i0 * cols + j0, 0, packed.shape[0] - 1)]   # [..., 4]
    return CellCache(
        x0=i0.to(torch.float32) * hf.hscale - hf.offset,
        y0=j0.to(torch.float32) * hf.hscale - hf.offset,
        h00=corners[..., 0], h10=corners[..., 1], h01=corners[..., 2], h11=corners[..., 3])


def flat_cell_cache(px: torch.Tensor, py: torch.Tensor) -> CellCache:
    """All-zero cell cache for plane terrain."""
    z = torch.zeros_like(px)
    return CellCache(x0=torch.floor(px), y0=torch.floor(py), h00=z, h10=z, h01=z, h11=z)


@dataclass
class SuperTable:
    """Per-supercell terrain patches: row ``si * nsj + sj`` holds the
    ``PG x PG`` corner grid that covers every contact point of an env whose
    base lies in supercell ``(si, sj)``.  Heights are stored in bf16."""

    table: torch.Tensor   # [nsi*nsj, PG*PG] bf16
    S: int                # supercell side [cells]
    M: int                # margin [cells]
    PG: int               # corner-grid side
    nsi: int
    nsj: int
    rows: int             # heightfield rows
    cols: int
    hscale: float
    offset: float


def build_supertable(height, hscale: float, offset: float, supercell: int = 16,
                     margin_m: float = 1.3, device="cpu") -> SuperTable:
    """Precompute the supercell patch table from a (numpy) heightfield."""
    H = np.asarray(height, np.float32)
    R, C = H.shape
    S = int(supercell)
    M = int(np.ceil(margin_m / hscale))
    PG = S + 2 * M + 1
    nsi = (R + S - 1) // S
    nsj = (C + S - 1) // S
    # edge-replicate pad so every patch is in range (matches a clipped lookup)
    Hp = np.pad(H, ((M, nsi * S - R + M + PG), (M, nsj * S - C + M + PG)), mode="edge")
    sw = np.lib.stride_tricks.sliding_window_view(Hp, (PG, PG))[::S, ::S]
    st = np.ascontiguousarray(sw[:nsi, :nsj]).reshape(nsi * nsj, PG * PG)
    # bf16 storage, rounded to nearest even exactly as the JAX table is
    # (contact.py:212-218 there); keeping f32 here would move rough-terrain
    # contact by up to ~4 mm against the reference
    table = torch.from_numpy(st).to(device=device, dtype=torch.bfloat16)
    return SuperTable(table=table, S=S, M=M, PG=PG, nsi=nsi, nsj=nsj, rows=R,
                      cols=C, hscale=float(hscale), offset=float(offset))


def gather_cells_supercell(stb: SuperTable, base_x, base_y,
                           px: torch.Tensor, py: torch.Tensor) -> CellCache:
    """CellCache from each env's supercell patch.

    base_x, base_y: [N] world xy of each env's base (patch anchor);
    px, py: [K, N] world xy of the contact points.  Points beyond the table
    margin clamp to the patch edge.
    """
    pu = _div(px + stb.offset, stb.hscale)
    pv = _div(py + stb.offset, stb.hscale)
    bu = _div(base_x + stb.offset, stb.hscale)
    bv = _div(base_y + stb.offset, stb.hscale)
    si = torch.clamp(_div(bu, stb.S).to(torch.int64), 0, stb.nsi - 1)
    sj = torch.clamp(_div(bv, stb.S).to(torch.int64), 0, stb.nsj - 1)
    ou = si * stb.S - stb.M                                   # patch origin
    ov = sj * stb.S - stb.M
    i0 = torch.clamp(torch.floor(pu).to(torch.int64), 0, stb.rows - 2)
    j0 = torch.clamp(torch.floor(pv).to(torch.int64), 0, stb.cols - 2)
    iu = torch.clamp(i0 - ou[None], 0, stb.PG - 2)            # [K, N]
    iv = torch.clamp(j0 - ov[None], 0, stb.PG - 2)
    flat = stb.table.reshape(-1)
    base = ((si * stb.nsj + sj) * (stb.PG * stb.PG))[None] + iu * stb.PG + iv
    h00 = flat[base].float()
    h01 = flat[base + 1].float()
    h10 = flat[base + stb.PG].float()
    h11 = flat[base + stb.PG + 1].float()
    x0 = (ou[None] + iu).to(torch.float32) * stb.hscale - stb.offset
    y0 = (ov[None] + iv).to(torch.float32) * stb.hscale - stb.offset
    return CellCache(x0=x0, y0=y0, h00=h00, h10=h10, h01=h01, h11=h11)


@dataclass(frozen=True)
class ContactOpts:
    """Compliant contact coefficients: implicit-rate normal spring-damper and
    an anchor-spring friction model projected on the Coulomb cone."""

    kp: float = 2.0e6          # normal stiffness [N/m]
    kd: float = 2.0e4          # normal damping [N s/m]
    kt: float = 2.0e6          # tangential stiffness [N/m]
    kdt: float = 2.0e4         # tangential damping [N s/m]
    max_depth: float = 0.05
    max_force: float = 2.0e4
    dt: float = 0.001
    max_depen_vel: float = 1.0


def point_contact_forces(hf: HeightField, opts: ContactOpts, p_w: torch.Tensor,
                         v_w: torch.Tensor, anchor: torch.Tensor, friction,
                         m_eff: torch.Tensor, restitution=None,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contact force at each collision point against the heightfield.

    p_w, v_w: (..., np, 3) world positions and velocities; anchor: (..., np,
    3) friction anchors (state carried by the caller); friction and
    restitution broadcast against (..., np); m_eff: (np, 2) apparent mass
    along the normal and the weakest tangential direction.  Returns (forces
    (..., np, 3) world, penetration depth (..., np), updated anchors).
    """
    m_eff = torch.as_tensor(m_eff, dtype=p_w.dtype, device=p_w.device)
    m_n, m_t = m_eff[..., 0], m_eff[..., 1]
    xy = p_w[..., :2]
    h = sample_height(hf, xy)
    n = surface_normal(hf, xy)
    gap = h - p_w[..., 2]
    depth = torch.clamp(gap * n[..., 2], 0.0, opts.max_depth)
    active = gap > 0.0
    v_n = torch.sum(v_w * n, dim=-1)
    # implicit-rate spring-damper; restitution e scales the damping by (1 - e)
    if restitution is not None:
        k_v = opts.kp * opts.dt + opts.kd * (1.0 - restitution)
    else:
        k_v = opts.kp * opts.dt + opts.kd
    denom = 1.0 + (opts.dt * k_v / m_n if torch.is_tensor(k_v) else _over(opts.dt * k_v, m_n))
    f_n = torch.clamp((opts.kp * depth - k_v * v_n) / denom, 0.0, opts.max_force) * active
    # depenetration-velocity cap (PhysX maxDepenetrationVelocity)
    f_cap = torch.clamp_min(_div(m_n * (opts.max_depen_vel - v_n), opts.dt), 0.0)
    f_n = torch.minimum(f_n, f_cap)

    # tangential anchor spring, implicit-rate, projected on the friction cone
    v_t = v_w - v_n[..., None] * n
    d_t = p_w - anchor
    d_t = d_t - torch.sum(d_t * n, dim=-1, keepdim=True) * n
    kt_v = opts.kt * opts.dt + opts.kdt
    denom_t = 1.0 + _over(opts.dt * kt_v, m_t)
    f_t_raw = -(opts.kt * d_t + kt_v * v_t) / denom_t[..., None]
    f_t_mag = torch.linalg.vector_norm(f_t_raw, dim=-1)
    cone = friction * f_n
    scale = torch.where(f_t_mag > cone, cone / (f_t_mag + 1e-8), 1.0)
    f_t = f_t_raw * (scale * active)[..., None]

    # anchor: stick -> keep; slide -> drag so the spring matches the cone;
    # separated -> reset to the current point
    sliding = (f_t_mag > cone) & active
    anchor_slide = p_w + _div(f_t, opts.kt) * denom_t[..., None]
    new_anchor = torch.where(active[..., None],
                             torch.where(sliding[..., None], anchor_slide, anchor), p_w)
    return n * f_n[..., None] + f_t, depth, new_anchor
