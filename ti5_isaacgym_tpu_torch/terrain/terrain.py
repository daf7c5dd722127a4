"""Terrain grid builder: curriculum layout, env origins, heightfield.

Port of ``ti5_isaacgym_tpu/terrain/terrain.py``: a ``num_rows x num_cols``
grid of sub-terrains (row = difficulty level, column = terrain type through
cumulative proportions) inside a flat border.  The int16 grid becomes a
float32 :class:`~ti5_isaacgym_tpu_torch.physics.contact.HeightField` tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..physics.contact import HeightField
from . import generators as G


@dataclass
class TerrainCfg:
    """Mirrors the reference terrain config surface
    (``legged_robot_config.py`` terrain + ``t1_dh_stand_config.py:56-100``)."""

    mesh_type: str = "heightfield"          # 'plane' | 'heightfield' | 'trimesh'
    horizontal_scale: float = 0.1           # [m/px]
    vertical_scale: float = 0.005           # [m/unit]
    border_size: float = 25.0               # [m]
    curriculum: bool = True
    static_friction: float = 0.6
    dynamic_friction: float = 0.6
    restitution: float = 0.0
    measure_heights: bool = False
    measured_points_x: tuple = tuple(np.round(np.arange(-0.8, 0.9, 0.1), 3))   # 17
    measured_points_y: tuple = tuple(np.round(np.arange(-0.5, 0.6, 0.1), 3))   # 11
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 20                      # difficulty levels
    num_cols: int = 20                      # terrain types
    max_init_terrain_level: int = 5
    platform: float = 3.0
    terrain_proportions: tuple = (0.5, 0.3, 0.1, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    rough_flat_range: tuple = (0.005, 0.01)
    slope_range: tuple = (0.0, 0.1)
    rough_slope_range: tuple = (0.005, 0.02)
    stair_width_range: tuple = (0.25, 0.25)
    stair_height_range: tuple = (0.01, 0.1)
    discrete_height_range: tuple = (0.0, 0.01)
    selected: bool = False
    terrain_kwargs: Optional[Dict] = None

    @property
    def num_height_points(self) -> int:
        return len(self.measured_points_x) * len(self.measured_points_y)


class Terrain:
    """Builds the full height map + per-(level, type) spawn origins."""

    def __init__(self, cfg: TerrainCfg, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.env_length = cfg.terrain_length
        self.env_width = cfg.terrain_width
        props = np.array(cfg.terrain_proportions, dtype=float)
        props = props / props.sum()
        self.proportions = np.cumsum(props)
        self.env_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
        self.terrain_type_grid = np.zeros((cfg.num_rows, cfg.num_cols), dtype=int)
        self.max_difficulty = (cfg.num_rows - 1) / cfg.num_rows

        self.width_px = int(self.env_width / cfg.horizontal_scale)
        self.length_px = int(self.env_length / cfg.horizontal_scale)
        self.border_px = int(cfg.border_size / cfg.horizontal_scale)
        self.tot_rows = cfg.num_rows * self.length_px + 2 * self.border_px
        self.tot_cols = cfg.num_cols * self.width_px + 2 * self.border_px
        self.height_field_raw = np.zeros((self.tot_rows, self.tot_cols), dtype=np.int16)

        if cfg.mesh_type in ("none", "plane"):
            return
        if cfg.curriculum:
            for j in range(cfg.num_cols):
                for i in range(cfg.num_rows):
                    difficulty = i / cfg.num_rows
                    choice = j / cfg.num_cols + 0.001
                    self._add(self._make(choice, difficulty), i, j)
        elif cfg.selected and cfg.terrain_kwargs:
            kw = dict(cfg.terrain_kwargs)
            name = kw.pop("type")
            for k in range(cfg.num_rows * cfg.num_cols):
                i, j = np.unravel_index(k, (cfg.num_rows, cfg.num_cols))
                t = G.SubTerrain(self.width_px, self.width_px, cfg.vertical_scale, cfg.horizontal_scale)
                getattr(G, name)(t, **kw)
                self._add(t, i, j)
        else:
            for k in range(cfg.num_rows * cfg.num_cols):
                i, j = np.unravel_index(k, (cfg.num_rows, cfg.num_cols))
                choice = self.rng.uniform(0, 1)
                difficulty = self.rng.choice([0.5, 0.75, 0.9])
                self._add(self._make(choice, difficulty), i, j)

    # --- sub-terrain synthesis (reference utils/terrain.py:86-171) ---
    def _make(self, choice: float, difficulty: float) -> G.SubTerrain:
        cfg = self.cfg
        t = G.SubTerrain(self.width_px, self.width_px, cfg.vertical_scale, cfg.horizontal_scale)

        def rng_range(r):
            return r[0] + difficulty * (r[1] - r[0]) / self.max_difficulty

        rough_flat = rng_range(cfg.rough_flat_range)
        slope = rng_range(cfg.slope_range)
        rough_slope = rng_range(cfg.rough_slope_range)
        stair_w = rng_range(cfg.stair_width_range)
        stair_h = rng_range(cfg.stair_height_range)
        disc_h = rng_range(cfg.discrete_height_range)
        gap_size = 1.0 * difficulty
        pit_depth = 1.0 * difficulty
        amplitude = 0.2 + 0.333 * difficulty
        P = self.proportions
        if choice < P[0]:
            idx = 1  # flat
        elif choice < P[1]:
            idx = 2
            G.random_uniform(t, -rough_flat, rough_flat, step=0.005, downsampled_scale=0.2, rng=self.rng)
        elif choice < P[3]:
            idx = 4
            if choice < P[2]:
                idx = 3
                slope *= -1
            G.pyramid_sloped(t, slope=slope, platform_size=self.cfg.platform)
            G.random_uniform(t, -rough_slope, rough_slope, step=0.005, downsampled_scale=0.2, rng=self.rng)
        elif choice < P[5]:
            idx = 6
            if choice < P[4]:
                idx = 5
                slope *= -1
            G.pyramid_sloped(t, slope=slope, platform_size=self.cfg.platform)
        elif choice < P[7]:
            idx = 8
            if choice < P[6]:
                idx = 7
                stair_h *= -1
            G.pyramid_stairs(t, step_width=stair_w, step_height=stair_h, platform_size=self.cfg.platform)
        elif choice < P[8]:
            idx = 9
            G.discrete_obstacles(t, disc_h, 1.0, 2.0, 20, platform_size=self.cfg.platform, rng=self.rng)
        elif choice < P[9]:
            idx = 10
            G.wave(t, num_waves=3, amplitude=amplitude)
        elif len(P) > 10 and choice < P[10]:
            idx = 11
            G.gap(t, gap_size=gap_size, platform_size=self.cfg.platform)
        else:
            idx = 12
            G.pit(t, depth=pit_depth, platform_size=self.cfg.platform)
        self._last_idx = idx
        return t

    def _add(self, t: G.SubTerrain, i: int, j: int):
        cfg = self.cfg
        sx = self.border_px + i * self.length_px
        sy = self.border_px + j * self.width_px
        self.height_field_raw[sx:sx + self.length_px, sy:sy + self.width_px] = t.height_field_raw

        ox = (i + 0.5) * self.env_length
        oy = (j + 0.5) * self.env_width
        # spawn z = max height in the central 2x2 m patch
        x1 = int((self.env_length / 2.0 - 1) / cfg.horizontal_scale)
        x2 = int((self.env_length / 2.0 + 1) / cfg.horizontal_scale)
        y1 = int((self.env_width / 2.0 - 1) / cfg.horizontal_scale)
        y2 = int((self.env_width / 2.0 + 1) / cfg.horizontal_scale)
        oz = np.max(t.height_field_raw[x1:x2, y1:y2]) * cfg.vertical_scale
        self.env_origins[i, j] = [ox, oy, oz]
        self.terrain_type_grid[i, j] = getattr(self, "_last_idx", 1)

    # --- device exports ---
    def heightfield(self, device="cpu") -> HeightField:
        return HeightField(
            height=torch.from_numpy(
                self.height_field_raw.astype(np.float32) * self.cfg.vertical_scale).to(device),
            hscale=self.cfg.horizontal_scale,
            offset=self.cfg.border_size,
        )

    def origins_device(self, device="cpu") -> torch.Tensor:
        return torch.as_tensor(self.env_origins, dtype=torch.float32, device=device)


def flat_heightfield(device="cpu") -> HeightField:
    from ..physics.contact import flat_terrain

    return flat_terrain(device)
