"""``examples/near_global_ocean.py``'s model on the port against the JAX
package's, on the CPU in float64: the reduced construction (24×12×6 and
36×18×6; CATKE, horizontal ν and triad GM/Redi in a ClosureTuple on an
immersed lat-lon grid, the split-explicit free surface, the wind stress,
drag and buoyancy restoring as callable flux conditions) over 3 steps at
1e-10 of each field's scale (e, with the port's one known CATKE
difference, at 2e-9). The port's side is ``chip_smoke.
near_global_model``, the construction of ``chip_smoke.py``'s row F; the JAX
side is the example's ``build_model`` with float64 WENO smoothness (JAX's
float32 default rounds differently under jit than op by op).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from oceananigans_tpu import (FieldBoundaryConditions, GridFittedBottom,
                              ImmersedBoundaryGrid, LatitudeLongitudeGrid)
from oceananigans_tpu.advection import WENO
from oceananigans_tpu.advection.vector_invariant import WENOVectorInvariant
from oceananigans_tpu.boundary_conditions import FluxBoundaryCondition
from oceananigans_tpu.buoyancy import BuoyancyTracer
from oceananigans_tpu.closures import (CATKEVerticalDiffusivity, ClosureTuple,
                                       ScalarDiffusivity,
                                       TriadIsopycnalSkewSymmetricDiffusivity)
from oceananigans_tpu.coriolis import HydrostaticSphericalCoriolis
from oceananigans_tpu.models.free_surfaces import SplitExplicitFreeSurface
from oceananigans_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from oceananigans_tpu_torch.models.hydrostatic import state_from_jax
from test_torch_hydrostatic_options import compare, np_state

torch.set_num_threads(1)


def jax_near_global(nx, ny, nz):
    """The example's build_model (its bottom, conditions, closures and
    initial b), float64 smoothness, and u = 0.02·N(0, 1) from
    np.random.default_rng(0) as chip_smoke's row F sets it."""
    H0 = 3000.0
    grid = LatitudeLongitudeGrid(size=(nx, ny, nz), longitude=(-180, 180),
                                 latitude=(-75, 75), z=(-H0, 0.0),
                                 dtype=np.float64)
    ibg = ImmersedBoundaryGrid(grid, GridFittedBottom(
        chip_smoke.near_global_bottom))

    def tau_x(lam, phi, t):
        phi_r = np.deg2rad(phi)
        return -1.2e-4 * (-np.cos(3.0 * phi_r)) * np.cos(phi_r) ** 2

    dz_top = H0 / nz

    def b_flux(lam, phi, t, b):
        b_star = 6.0e-2 * np.cos(np.deg2rad(phi)) ** 2
        return (1.0 / (86400.0 * 30)) * dz_top * (b - b_star)

    u_bcs = FieldBoundaryConditions(
        top=FluxBoundaryCondition(tau_x),
        bottom=FluxBoundaryCondition(
            lambda lam, phi, t, u: -3e-3 * u * abs(u),
            field_dependencies="u"))
    b_bcs = FieldBoundaryConditions(
        top=FluxBoundaryCondition(b_flux, field_dependencies="b"))
    model = HydrostaticFreeSurfaceModel(
        grid=ibg, tracers=("b",),
        momentum_advection=WENOVectorInvariant(
            order=5, smoothness_dtype=jnp.float64),
        tracer_advection=WENO(5, smoothness_dtype=jnp.float64),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer(),
        closure=ClosureTuple(
            CATKEVerticalDiffusivity(buoyancy=BuoyancyTracer()),
            ScalarDiffusivity(nu=1.0e5, formulation="horizontal"),
            TriadIsopycnalSkewSymmetricDiffusivity(
                kappa_skew=1000.0, kappa_symmetric=1000.0,
                buoyancy=BuoyancyTracer())),
        free_surface=SplitExplicitFreeSurface(substeps=30),
        boundary_conditions={"u": u_bcs, "b": b_bcs})
    rng = np.random.default_rng(0)
    model.set(b=lambda lam, phi, z: 6.0e-2 * np.cos(np.deg2rad(phi)) ** 2
              * np.exp(z / 800.0),
              u=0.02 * rng.standard_normal((nx, ny, nz)))
    return model


@pytest.mark.parametrize("size", [(24, 12, 6), (36, 18, 6)],
                         ids=["24x12x6", "36x18x6"])
def test_near_global_against_jax(size):
    jm = jax_near_global(*size)
    tm = chip_smoke.near_global_model(size, torch.float64, "cpu",
                                      smoothness=torch.float64)
    assert tm._immersed and not tm.uses_kernel
    assert tm.closure.substepped_tke
    # the port's set() draws the same u: its state equals the JAX one's
    for name in ("u", "b"):
        a = np.asarray(jm.field(name).interior)
        assert np.abs(tm.field(name).interior.numpy() - a).max() \
            <= 1e-15 * np.abs(a).max(), name
    state_from_jax(np_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(chip_smoke.NEAR_GLOBAL_DT)
        tm.time_step(chip_smoke.NEAR_GLOBAL_DT)
    compare(jm, tm, ("u", "v", "b", "eta", "w"))
    # e carries the port's known TKE difference, 8e-10 here (the TKE
    # substep's N² reads the AB2-updated tracers' halos in JAX: ROADMAP.md
    # queue 3)
    compare(jm, tm, ("e",), tol=2e-9)
