"""Point-vs-heightfield contact: terrain tables and the frozen-cell cache.

Port of the parts of ``ti5_isaacgym_tpu/physics/contact.py`` that the
rollout uses.  The contact force law itself is evaluated inside the substep
(:func:`.engine_core.substep_stacked` and the CUDA kernel); this module picks
each contact point's bilinear terrain cell once per policy step.

The TPU version extracts the four cell corners from a gathered supercell
patch with one-hot contractions (an XLA einsum).  Here the corners are read
with one direct gather from the same bf16 patch table, which returns the
same stored values.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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


def sample_height_min3(hf: HeightField, xy: torch.Tensor) -> torch.Tensor:
    """Min-of-3-texels sample used for height-scan observations."""
    u = (xy[..., 0] + hf.offset) / hf.hscale
    v = (xy[..., 1] + hf.offset) / hf.hscale
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
    pu = (px + stb.offset) / stb.hscale
    pv = (py + stb.offset) / stb.hscale
    bu = (base_x + stb.offset) / stb.hscale
    bv = (base_y + stb.offset) / stb.hscale
    si = torch.clamp((bu / stb.S).to(torch.int64), 0, stb.nsi - 1)
    sj = torch.clamp((bv / stb.S).to(torch.int64), 0, stb.nsj - 1)
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
