"""The port's shift primitives and stencil operators against the JAX
package's, on random float64 padded fields.

Both sides evaluate the same differences, means and metric scalings in
float64, so they agree to 1e-14 absolute on fields of order 1 (a few
roundings of order 1e-16 each)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.operators import operators as jops
from oceananigans_tpu.operators.shifts import shift as jshift
from oceananigans_tpu.operators.shifts import shift_zbc as jshift_zbc
from oceananigans_tpu_torch.grids import RectilinearGrid as TGrid
from oceananigans_tpu_torch.operators import operators as tops
from oceananigans_tpu_torch.operators.shifts import shift as tshift
from oceananigans_tpu_torch.operators.shifts import shift_zbc as tshift_zbc

torch.set_num_threads(1)

TOL = 1e-14
GRID = dict(size=(6, 5, 8), extent=(1.0, 2.0, 0.5), halo=(3, 3, 3))


def _pair(rng, shape):
    a = rng.standard_normal(shape)
    return jnp.asarray(a), torch.as_tensor(a)


def _close(j, t):
    return np.max(np.abs(np.asarray(j) - t.numpy())) <= TOL


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("s", [-3, -2, -1, 1, 2, 3])
def test_shift(axis, s):
    ja, ta = _pair(np.random.default_rng(1), (7, 6, 9))
    assert _close(jshift(ja, s, axis), tshift(ta, s, axis))


@pytest.mark.parametrize("kind", ["even", "odd_face"])
@pytest.mark.parametrize("s", [-3, -2, -1, 1, 2, 3])
def test_shift_zbc(kind, s):
    ja, ta = _pair(np.random.default_rng(2), (4, 3, 10))
    assert _close(jshift_zbc(ja, s, 2, kind), tshift_zbc(ta, s, 2, kind))


LOCS = [("f", "c", "c"), ("c", "f", "c"), ("c", "c", "f"), ("c", "c", "c")]


@pytest.mark.parametrize("loc", LOCS)
def test_derivatives(loc):
    j, t = JGrid(dtype=np.float64, **GRID), TGrid(dtype=torch.float64, device="cpu", **GRID)
    ja, ta = _pair(np.random.default_rng(3), j.padded_shape)
    for name in ("ddx", "ddy", "ddz"):
        assert _close(getattr(jops, name)(j, ja, loc),
                      getattr(tops, name)(t, ta, loc)), name


def test_div_ccc():
    j, t = JGrid(dtype=np.float64, **GRID), TGrid(dtype=torch.float64, device="cpu", **GRID)
    rng = np.random.default_rng(4)
    (ju, tu), (jv, tv), (jw, tw) = (_pair(rng, j.padded_shape) for _ in range(3))
    assert _close(jops.div_ccc(j, ju, jv, jw), tops.div_ccc(t, tu, tv, tw))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_differences_and_interpolations(axis):
    j, t = JGrid(dtype=np.float64, **GRID), TGrid(dtype=torch.float64, device="cpu", **GRID)
    ja, ta = _pair(np.random.default_rng(5), j.padded_shape)
    for out in ("c", "f"):
        assert _close(jops.delta(j, ja, axis, out), tops.delta(t, ta, axis, out))
        assert _close(jops.interp(j, ja, axis, out),
                      tops.interp(t, ta, axis, out))


@pytest.mark.parametrize("to_loc", [("f", "c", "c"), ("c", "c", "f"),
                                    ("f", "f", "c"), ("c", "f", "f")])
def test_interpolations(to_loc):
    """``interp_to`` from cell centers, and the one-axis ``ix/iy/iz_f``."""
    j, t = JGrid(dtype=np.float64, **GRID), TGrid(dtype=torch.float64,
                                                  device="cpu", **GRID)
    ja, ta = _pair(np.random.default_rng(9), j.padded_shape)
    ccc = ("c", "c", "c")
    assert _close(jops.interp_to(j, ja, ccc, to_loc),
                  tops.interp_to(t, ta, ccc, to_loc))
    for name in ("ix_f", "iy_f", "iz_f"):
        assert _close(getattr(jops, name)(j, ja), getattr(tops, name)(t, ta))


def test_div_xy_ccc():
    j, t = JGrid(dtype=np.float64, **GRID), TGrid(dtype=torch.float64,
                                                  device="cpu", **GRID)
    rng = np.random.default_rng(6)
    (ju, tu), (jv, tv) = (_pair(rng, j.padded_shape) for _ in range(2))
    assert _close(jops.div_xy_ccc(j, ju, jv), tops.div_xy_ccc(t, tu, tv))


def test_zeta3_ffc():
    j, t = JGrid(dtype=np.float64, **GRID), TGrid(dtype=torch.float64,
                                                  device="cpu", **GRID)
    rng = np.random.default_rng(7)
    (ju, tu), (jv, tv) = (_pair(rng, j.padded_shape) for _ in range(2))
    assert jops.LOC_FFC == tops.LOC_FFC
    assert _close(jops.zeta3_ffc(j, ju, jv), tops.zeta3_ffc(t, tu, tv))
