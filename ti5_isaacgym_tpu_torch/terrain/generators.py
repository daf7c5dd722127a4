"""Procedural sub-terrain generators (numpy, startup time).

This package's own copy of ``ti5_isaacgym_tpu/terrain/generators.py``: each
generator mutates an int16 height grid with the ``horizontal_scale`` /
``vertical_scale`` quantization of the reference terrain builder, so the same
seed gives the same heightfield in both packages.
"""
from __future__ import annotations

import numpy as np


class SubTerrain:
    """An int16 height grid patch (heights in units of ``vertical_scale``)."""

    def __init__(self, width: int, length: int, vertical_scale: float, horizontal_scale: float):
        self.width = width          # pixels along x
        self.length = length        # pixels along y
        self.vertical_scale = vertical_scale
        self.horizontal_scale = horizontal_scale
        self.height_field_raw = np.zeros((width, length), dtype=np.int16)


def random_uniform(terrain: SubTerrain, min_height: float, max_height: float,
                   step: float = 0.005, downsampled_scale: float = 0.2,
                   rng: np.random.Generator | None = None) -> SubTerrain:
    """Bumpy ground: random heights on a coarse grid, bilinearly upsampled."""
    rng = rng or np.random.default_rng()
    lo = int(min_height / terrain.vertical_scale)
    hi = int(max_height / terrain.vertical_scale)
    n_steps = max(int((max_height - min_height) / step), 1)
    heights_range = np.linspace(lo, hi, n_steps + 1)
    ds = max(int(downsampled_scale / terrain.horizontal_scale), 1)
    coarse_w = terrain.width // ds + 1
    coarse_l = terrain.length // ds + 1
    coarse = rng.choice(heights_range, (coarse_w, coarse_l))
    # bilinear upsample to the full grid
    xi = np.linspace(0, coarse_w - 1, terrain.width)
    yi = np.linspace(0, coarse_l - 1, terrain.length)
    x0 = np.clip(xi.astype(int), 0, coarse_w - 2)
    y0 = np.clip(yi.astype(int), 0, coarse_l - 2)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    up = (coarse[x0][:, y0] * (1 - fx) * (1 - fy)
          + coarse[x0 + 1][:, y0] * fx * (1 - fy)
          + coarse[x0][:, y0 + 1] * (1 - fx) * fy
          + coarse[x0 + 1][:, y0 + 1] * fx * fy)
    terrain.height_field_raw += up.astype(np.int16)
    return terrain


def pyramid_sloped(terrain: SubTerrain, slope: float, platform_size: float = 1.0) -> SubTerrain:
    """Pyramid rising (slope>0) or sinking (slope<0) toward the center, with a
    flat central platform."""
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = terrain.width // 2, terrain.length // 2
    # normalized distance-to-edge profile: 0 at border, 1 at center
    px = 1.0 - np.abs(x - cx) / max(cx, 1)
    py = 1.0 - np.abs(y - cy) / max(cy, 1)
    prof = np.minimum(px[:, None], py[None, :])
    max_h = slope * (terrain.width // 2) * terrain.horizontal_scale
    hf = (max_h * prof / terrain.vertical_scale)
    # flat platform in the middle: clamp heights beyond the platform edge value
    plat_px = int(platform_size / terrain.horizontal_scale / 2)
    edge = 1.0 - plat_px / max(cx, 1)
    cap = max_h * edge / terrain.vertical_scale
    hf = np.clip(hf, min(0, cap), max(0, cap)) if slope != 0 else hf
    terrain.height_field_raw += hf.astype(np.int16)
    return terrain


def pyramid_stairs(terrain: SubTerrain, step_width: float, step_height: float,
                   platform_size: float = 1.0) -> SubTerrain:
    """Concentric rectangular steps descending (step_height<0) or ascending
    toward the center platform."""
    sw = max(int(step_width / terrain.horizontal_scale), 1)
    sh = int(step_height / terrain.vertical_scale)
    plat = int(platform_size / terrain.horizontal_scale)
    h = 0
    x0, x1 = 0, terrain.width
    y0, y1 = 0, terrain.length
    while (x1 - x0) > plat and (y1 - y0) > plat:
        x0 += sw; x1 -= sw; y0 += sw; y1 -= sw
        h += sh
        terrain.height_field_raw[x0:x1, y0:y1] = h
    return terrain


def discrete_obstacles(terrain: SubTerrain, max_height: float, min_size: float,
                       max_size: float, num_rects: int, platform_size: float = 1.0,
                       rng: np.random.Generator | None = None) -> SubTerrain:
    """Random raised/sunken rectangles, keeping a flat central platform."""
    rng = rng or np.random.default_rng()
    mh = int(max_height / terrain.vertical_scale)
    heights = [-mh, -mh // 2, mh // 2, mh]
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / terrain.horizontal_scale)
        l = int(rng.uniform(min_size, max_size) / terrain.horizontal_scale)
        sx = int(rng.integers(0, max(terrain.width - w, 1)))
        sy = int(rng.integers(0, max(terrain.length - l, 1)))
        terrain.height_field_raw[sx:sx + w, sy:sy + l] = int(rng.choice(heights))
    cx, cy = terrain.width // 2, terrain.length // 2
    half = int(platform_size / terrain.horizontal_scale / 2)
    terrain.height_field_raw[cx - half:cx + half, cy - half:cy + half] = 0
    return terrain


def wave(terrain: SubTerrain, num_waves: int = 1, amplitude: float = 1.0) -> SubTerrain:
    amp = amplitude / (2.0 * terrain.vertical_scale)
    if num_waves <= 0:
        return terrain
    div = terrain.length / (num_waves * 2.0 * np.pi)
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    terrain.height_field_raw += (
        amp * np.cos(y[None, :] / div) + amp * np.sin(x[:, None] / div)
    ).astype(np.int16)
    return terrain


def gap(terrain: SubTerrain, gap_size: float, platform_size: float = 1.0) -> SubTerrain:
    """Deep rectangular moat around the central platform (reference
    ``utils/terrain.py:193-205``)."""
    gpx = int(gap_size / terrain.horizontal_scale)
    plat = int(platform_size / terrain.horizontal_scale)
    cx, cy = terrain.width // 2, terrain.length // 2
    x1 = (terrain.width - plat) // 2
    x2 = x1 + gpx
    y1 = (terrain.length - plat) // 2
    y2 = y1 + gpx
    terrain.height_field_raw[cx - x2:cx + x2, cy - y2:cy + y2] = -1000
    terrain.height_field_raw[cx - x1:cx + x1, cy - y1:cy + y1] = 0
    return terrain


def pit(terrain: SubTerrain, depth: float, platform_size: float = 1.0) -> SubTerrain:
    """Central platform sunk below ground level (reference ``:207-214``)."""
    d = int(depth / terrain.vertical_scale)
    half = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = terrain.width // 2 - half, terrain.width // 2 + half
    y1, y2 = terrain.length // 2 - half, terrain.length // 2 + half
    terrain.height_field_raw[x1:x2, y1:y2] = -d
    return terrain
