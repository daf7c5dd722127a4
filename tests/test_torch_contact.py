"""Port parity: physics/contact.py supertable (bf16 heights) and the supercell
cell gather against the JAX package on a seeded rough heightfield.

The port reads the four corners with a direct gather where the JAX package
uses one-hot contractions; both return the stored bf16 values unchanged, so
the comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.physics import contact as jct
from ti5_isaacgym_tpu_torch.physics import contact as tct

HSCALE, OFFSET = 0.1, 2.0


def _heightfield(seed):
    rng = np.random.default_rng(seed)
    # rough terrain with a slope: heights up to ~2 m, where bf16 rounding
    # (2^-8 relative) is visible
    h = rng.uniform(-0.05, 0.05, size=(120, 140)) + np.linspace(0, 2.0, 140)[None]
    return h.astype(np.float32)


def test_build_supertable_matches_jax_bf16():
    h = _heightfield(0)
    j = jct.build_supertable(h, HSCALE, OFFSET, supercell=16, margin_m=1.3)
    t = tct.build_supertable(h, HSCALE, OFFSET, supercell=16, margin_m=1.3)
    assert (t.S, t.M, t.PG, t.nsi, t.nsj, t.rows, t.cols) == \
        (j.S, j.M, j.PG, j.nsi, j.nsj, j.rows, j.cols)
    assert t.table.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.table.float().numpy(),
                                  np.asarray(j.table.astype(jnp.float32)))
    # the rounding is real: bf16 storage moves these heights by up to ~4 mm
    moved = np.abs(torch.from_numpy(h).to(torch.bfloat16).float().numpy() - h)
    assert 1e-3 < moved.max() < 1e-2


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gather_cells_supercell_matches_jax(seed):
    h = _heightfield(seed)
    rng = np.random.default_rng(seed)
    n, k = 24, 32
    # bases inside the field, points within the margin around them
    bx = rng.uniform(0.5, 9.0, size=n).astype(np.float32)
    by = rng.uniform(0.5, 11.0, size=n).astype(np.float32)
    px = (bx[None] + rng.uniform(-1.2, 1.2, size=(k, n))).astype(np.float32)
    py = (by[None] + rng.uniform(-1.2, 1.2, size=(k, n))).astype(np.float32)
    jst = jct.build_supertable(h, HSCALE, OFFSET, supercell=16, margin_m=1.3)
    tst = tct.build_supertable(h, HSCALE, OFFSET, supercell=16, margin_m=1.3)
    jc = jct.gather_cells_supercell(jst, jnp.asarray(bx), jnp.asarray(by),
                                    jnp.asarray(px), jnp.asarray(py))
    tc = tct.gather_cells_supercell(tst, torch.from_numpy(bx), torch.from_numpy(by),
                                    torch.from_numpy(px), torch.from_numpy(py))
    for f in ("x0", "y0", "h00", "h10", "h01", "h11"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)


def test_flat_cell_cache_matches_jax():
    rng = np.random.default_rng(4)
    px = rng.normal(size=(32, 8)).astype(np.float32)
    py = rng.normal(size=(32, 8)).astype(np.float32)
    jc = jct.flat_cell_cache(jnp.asarray(px), jnp.asarray(py))
    tc = tct.flat_cell_cache(torch.from_numpy(px), torch.from_numpy(py))
    for f in ("x0", "y0", "h00", "h10", "h01", "h11"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
