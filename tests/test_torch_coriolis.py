"""The port's Coriolis forces against the JAX package's, on random float64
padded fields at (6, 5, 8) with H = 3.

Both sides form the same 4-point means and products in float64, so they
agree to 1e-14 absolute on fields of order 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu import coriolis as jcor
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu_torch import coriolis as tcor
from oceananigans_tpu_torch.grids import RectilinearGrid as TGrid

torch.set_num_threads(1)

TOL = 1e-14
GRID = dict(size=(6, 5, 8), extent=(1.0, 2.0, 0.5), halo=(3, 3, 3))

CASES = {
    "fplane": dict(f=0.3),
    "fplane_latitude": dict(latitude=45.0),
    "cartesian": dict(fx=0.1, fy=-0.2, fz=0.3),
    "cartesian_axis": dict(f=1e-4, rotation_axis=(0.0, 1.0, 1.0)),
    "beta": dict(f0=0.3, beta=0.1),
    "beta_latitude": dict(latitude=30.0),
    "nontraditional": dict(fz0=0.3, beta=0.1, fy0=0.2, gamma=-0.05,
                           radius=2.0),
    "nontraditional_latitude": dict(latitude=45.0),
}
CLASSES = {"fplane": "FPlane", "fplane_latitude": "FPlane",
           "cartesian": "ConstantCartesianCoriolis",
           "cartesian_axis": "ConstantCartesianCoriolis",
           "beta": "BetaPlane", "beta_latitude": "BetaPlane",
           "nontraditional": "NonTraditionalBetaPlane",
           "nontraditional_latitude": "NonTraditionalBetaPlane"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f_cross_U(case):
    cls, kw = CLASSES[case], CASES[case]
    jc, tc = getattr(jcor, cls)(**kw), getattr(tcor, cls)(**kw)
    assert jc._fp() == tc._fp()
    jg = JGrid(dtype=np.float64, **GRID)
    tg = TGrid(dtype=torch.float64, device="cpu", **GRID)
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal(jg.padded_shape) for _ in range(3)]
    ju, jv, jw = (jnp.asarray(a) for a in arrays)
    tu, tv, tw = (torch.as_tensor(a) for a in arrays)
    for name in ("x_f_cross_U", "y_f_cross_U", "z_f_cross_U"):
        want = np.asarray(getattr(jc, name)(jg, ju, jv, jw))
        got = getattr(tc, name)(tg, tu, tv, tw).numpy()
        assert np.max(np.abs(got - want)) <= TOL, (case, name)


def test_constant_f():
    assert tcor.constant_f(None) == 0.0
    assert tcor.constant_f(tcor.FPlane(f=0.3)) == 0.3
    assert tcor.constant_f(tcor.ConstantCartesianCoriolis(
        fx=0.1, fy=0.2, fz=0.4)) == 0.4
    assert tcor.constant_f(tcor.BetaPlane(f0=0.3, beta=0.1)) is None


@pytest.mark.parametrize("cls", ["NonTraditionalBetaPlane",
                                 "HydrostaticSphericalCoriolis"])
def test_hydrostatic_coriolis_raises(cls):
    """The fused hydrostatic tendency covers the non-traditional β-plane,
    as the JAX kernel does (fused_tendencies=True builds), and raises,
    naming item 13, for it on a grid it does not cover (a stretched x);
    the spherical Coriolis refuses a scheme it does not have, as the JAX
    one does."""
    if cls == "HydrostaticSphericalCoriolis":
        with pytest.raises(ValueError):
            tcor.HydrostaticSphericalCoriolis(scheme="active_weighted")
        return
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels.fused_vector_invariant import \
        vi_config
    grid = TGrid(dtype=torch.float64, device="cpu", **GRID)
    kw = dict(free_surface=ot.SplitExplicitFreeSurface(substeps=5),
              coriolis=getattr(tcor, cls)(latitude=45.0),
              fused_tendencies=True)
    m = ot.HydrostaticFreeSurfaceModel(grid, **kw)
    vi_config(m.grid, m.momentum_advection, m.tracer_advection, 0,
              m.coriolis)
    stretched_x = TGrid(size=(6, 5, 8), x=tuple(np.linspace(0, 1, 7) ** 2),
                        y=(0.0, 2.0), z=(-0.5, 0.0), halo=(3, 3, 3),
                        dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        ot.HydrostaticFreeSurfaceModel(stretched_x, **kw)


@pytest.mark.parametrize("scheme", ["energy_conserving",
                                    "enstrophy_conserving"])
def test_hydrostatic_spherical_coriolis(scheme):
    """HydrostaticSphericalCoriolis on a lat-lon grid, f at the (f, f)
    nodes, in both Sadourny forms: 1e-14 relative to max|f×U|."""
    from oceananigans_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from oceananigans_tpu_torch.grids import LatitudeLongitudeGrid as TLL
    cfg = dict(size=(10, 8, 4), longitude=(0, 60), latitude=(15, 75),
               z=(-100.0, 0.0), halo=(3, 3, 3))
    jg = JLL(dtype=np.float64, **cfg)
    tg = TLL(dtype=torch.float64, device="cpu", **cfg)
    jc = jcor.HydrostaticSphericalCoriolis(scheme=scheme)
    tc = tcor.HydrostaticSphericalCoriolis(scheme=scheme)
    assert jc._fp() == tc._fp()
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal(jg.padded_shape) for _ in range(3)]
    for name in ("x_f_cross_U", "y_f_cross_U", "z_f_cross_U"):
        want = np.asarray(getattr(jc, name)(jg, *map(jnp.asarray, arrays)))
        got = getattr(tc, name)(tg, *map(torch.as_tensor, arrays)).numpy()
        scale = max(np.abs(want).max(), 1e-300)
        assert np.max(np.abs(got - want)) / scale <= TOL, (scheme, name)
