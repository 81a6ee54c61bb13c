"""The hydrostatic model's remaining options against the JAX package's, on
the CPU in float64, 3 steps at 1e-10 of each field's scale (interiors):

- per-tracer advection schemes (a dict ``tracer_advection``);
- flux-form momentum advection (``momentum_advection=WENO(5)``) in
  ``examples/internal_tide.py``'s construction at 32×1×16 (a PartialCellBottom
  hill, flat y, the M2 body force), and a flux-form Centered(2) on a lat-lon
  grid with a ridge;
- ``PrescribedVelocityFields`` (constant and callable u, v, w) under
  quasi-AB2 and the split RK3, at 1e-12;
- the kernel route's refusals: under ``fused_tendencies="auto"`` every
  configuration that JAX's explicit fused path refuses takes the plain
  tendency, and under ``True`` it raises as JAX raises.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoy
from oceananigans_tpu.closures import \
    IsopycnalSkewSymmetricDiffusivity as JIso
from oceananigans_tpu.forcings import ContinuousForcing as JCF
from oceananigans_tpu.immersed import (GridFittedBottom as JGFB,
                                       ImmersedBoundaryGrid as JIBG,
                                       PartialCellBottom as JPCB)
from oceananigans_tpu.models.free_surfaces import \
    SplitExplicitFreeSurface as JSplit
from oceananigans_tpu.models.hydrostatic import (
    HydrostaticFreeSurfaceModel as JModel,
    PrescribedVelocityFields as JPVF)
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.forcings import ContinuousForcing as TCF
from oceananigans_tpu_torch.models.hydrostatic import (
    HydrostaticFreeSurfaceModel, state_from_jax)

torch.set_num_threads(1)

F64 = torch.float64


def weno(lib, order=5):
    """WENO with float64 smoothness on both sides (JAX's float32 default
    rounds differently under jit than op by op)."""
    return lib.WENO(order, smoothness_dtype=jnp.float64 if lib is jo
                    else F64)


HOUR, KM = 3600.0, 1e3


def np_state(state):
    return {k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


def compare(jm, tm, names, tol=1e-10):
    for name in names:
        a = np.asarray(jm.field(name).interior)
        b = tm.field(name).interior.numpy()
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert err <= tol, (name, err)


def run_pair(jm, tm, dts, names, tol=1e-10):
    state_from_jax(np_state(jm.state), tm)
    for dt in dts:
        jm.time_step(dt)
        tm.time_step(dt)
    assert tm.iteration == len(dts)
    compare(jm, tm, names, tol)


# -- examples/internal_tide.py's construction ------------------------------------

def internal_tide(J, nx=32, nz=16, vertical_coordinate="z", **kw):
    """``examples/internal_tide.py`` ``main``'s model on either package at
    nx × 1 × nz (float64; the port's on the CPU)."""
    lib = jo if J else ot
    H, L = 2 * KM, 1000 * KM
    gkw = dict(size=(nx, 1, nz), x=(-L, L), y=(0, 1.0), z=(-H, 0.0),
               topology=("periodic", "flat", "bounded"))
    if J:
        under = jo.RectilinearGrid(dtype=np.float64, **gkw)
    else:
        under = ot.RectilinearGrid(dtype=F64, device="cpu", **gkw)
    h0, width = 250.0, 20 * KM
    grid = (JIBG if J else ot.ImmersedBoundaryGrid)(under, (
        JPCB if J else ot.PartialCellBottom)(
            lambda x, y: -H + h0 * np.exp(-x ** 2 / (2 * width ** 2))))
    coriolis = lib.FPlane(latitude=-45.0)
    omega2 = 2 * np.pi / (12.421 * HOUR)
    U2 = 0.1 * omega2 * width
    A2 = U2 * (omega2 ** 2 - coriolis.f ** 2) / omega2
    if J:
        forcing = JCF(lambda x, y, z, t: A2 * jnp.sin(omega2 * t),
                      loc=("f", "c", "c"))
    else:
        forcing = TCF(lambda x, y, z, t: A2 * math.sin(omega2 * t),
                      loc=("f", "c", "c"))
    args = dict(coriolis=coriolis, buoyancy=JBuoy() if J else
                ot.BuoyancyTracer(), tracers=("b",),
                momentum_advection=weno(lib), tracer_advection=weno(lib),
                forcing={"u": forcing},
                vertical_coordinate=vertical_coordinate)
    args.update(kw)
    model = (JModel if J else HydrostaticFreeSurfaceModel)(grid, **args)
    if J:
        model.set(u=U2, b=lambda x, y, z: 1e-4 * z)
    return model


def test_internal_tide_flux_form_against_jax():
    """WENO(5) flux-form momentum over the PartialCellBottom hill (the
    masks and the near-bottom WENO cascade as for tracers), the default
    free surface (split-explicit with cfl=0.7: the grid is immersed)."""
    jm, tm = internal_tide(True), internal_tide(False)
    assert isinstance(tm.free_surface, ot.SplitExplicitFreeSurface)
    assert not tm.uses_kernel
    run_pair(jm, tm, (300.0,) * 3, ("u", "v", "b", "eta", "w"))


def test_flux_form_latlon_ridge_against_jax():
    """Flux-form Centered(2) and WENO(5) momentum on a lat-lon grid with a
    ridge, spherical Coriolis and a split-explicit free surface."""
    def ridge(lam, phi):
        return np.where(np.abs(lam - 30.0) < 8.0, -600.0, -1800.0) + 0 * phi

    def make(J, scheme):
        kw = dict(size=(12, 10, 6), longitude=(0, 60), latitude=(15, 75),
                  z=(-1800.0, 0.0))
        g = (jo.LatitudeLongitudeGrid(dtype=np.float64, **kw) if J else
             ot.LatitudeLongitudeGrid(dtype=F64, device="cpu", **kw))
        g = (JIBG if J else ot.ImmersedBoundaryGrid)(
            g, (JGFB if J else ot.GridFittedBottom)(ridge))
        lib = jo if J else ot
        m = (JModel if J else HydrostaticFreeSurfaceModel)(
            g, momentum_advection=scheme(lib),
            tracer_advection=weno(lib), buoyancy=JBuoy() if J else
            ot.BuoyancyTracer(), tracers=("b",),
            coriolis=lib.HydrostaticSphericalCoriolis(),
            free_surface=(JSplit if J else ot.SplitExplicitFreeSurface)(
                substeps=10))
        if J:
            rng = np.random.default_rng(1)
            m.set(u=0.05 * rng.standard_normal(kw["size"]),
                  v=0.05 * rng.standard_normal(kw["size"]),
                  b=lambda lam, phi, z: 1e-5 * z)
        return m

    for scheme in (lambda lib: lib.Centered(2), weno):
        run_pair(make(True, scheme), make(False, scheme), (600.0,) * 3,
                 ("u", "v", "b", "eta", "w"))


# -- per-tracer schemes ---------------------------------------------------------------

@pytest.mark.parametrize("stepper", ["QuasiAdamsBashforth2",
                                     "SplitRungeKutta3"])
def test_per_tracer_schemes_against_jax(stepper):
    """Two tracers with different schemes (WENO(5), Centered(4)) and a
    third taking the dict's default (UpwindBiased(3)), 3 steps at 1e-12."""
    def make(J):
        lib = jo if J else ot
        kw = dict(size=(12, 10, 6), longitude=(0, 60), latitude=(15, 75),
                  z=(-1800.0, 0.0))
        g = (jo.LatitudeLongitudeGrid(dtype=np.float64, **kw) if J else
             ot.LatitudeLongitudeGrid(dtype=F64, device="cpu", **kw))
        m = (JModel if J else HydrostaticFreeSurfaceModel)(
            g, momentum_advection=lib.VectorInvariant(),
            tracer_advection={"T": weno(lib), "S": lib.Centered(4),
                              "default": lib.UpwindBiased(3)},
            tracers=("T", "S", "c"), timestepper=stepper,
            free_surface=(JSplit if J else ot.SplitExplicitFreeSurface)(
                substeps=10))
        if J:
            rng = np.random.default_rng(3)
            m.set(u=0.1 * rng.standard_normal(kw["size"]),
                  v=0.1 * rng.standard_normal(kw["size"]),
                  T=rng.standard_normal(kw["size"]),
                  S=rng.standard_normal(kw["size"]),
                  c=rng.standard_normal(kw["size"]))
        return m

    jm, tm = make(True), make(False)
    assert tm.tracer_scheme("c") == ot.UpwindBiased(3)
    assert tm.grid.H[0] >= 3 and not tm.uses_kernel
    run_pair(jm, tm, (600.0,) * 3, ("T", "S", "c"), tol=1e-12)
    compare(jm, tm, ("u", "v", "eta"), tol=1e-10)


# -- prescribed velocities ---------------------------------------------------------------

PRESCRIBED = {
    "constant": lambda J: (JPVF if J else ot.PrescribedVelocityFields)(
        u=0.1, v=-0.05, w=0.0),
    "callable": lambda J: (JPVF if J else ot.PrescribedVelocityFields)(
        u=lambda x, y, z, t: 0.1 * (1 + z / 1000.0) + 0 * x,
        v=lambda x, y, z, t: 0.05 * (x / 1e5) + 1e-6 * t + 0 * y,
        w=lambda x, y, z, t: 1e-5 * (x / 1e5) * (z + 1000.0) / 1000.0
        * (-z) / 1000.0 + 0 * y),
}


@pytest.mark.parametrize("stepper", ["QuasiAdamsBashforth2",
                                     "SplitRungeKutta3"])
@pytest.mark.parametrize("kind", sorted(PRESCRIBED))
def test_prescribed_velocities_against_jax(kind, stepper):
    """The tracer-only steps over prescribed u, v, w (constant and callable
    of x, y, z, t) with WENO(5) tracers and a vertically implicit
    diffusivity: 3 steps at 1e-12; velocities are not prognostic."""
    def make(J):
        lib = jo if J else ot
        kw = dict(size=(16, 8, 8), x=(0, 1e5), y=(0, 5e4), z=(-1000.0, 0.0),
                  topology=("periodic", "bounded", "bounded"))
        g = (jo.RectilinearGrid(dtype=np.float64, **kw) if J else
             ot.RectilinearGrid(dtype=F64, device="cpu", **kw))
        clo = lib.VerticalScalarDiffusivity(
            lib.VerticallyImplicitTimeDiscretization(), kappa=1e-3)
        m = (JModel if J else HydrostaticFreeSurfaceModel)(
            g, velocities=PRESCRIBED[kind](J), tracers=("c", "d"),
            tracer_advection=weno(lib), closure=clo, timestepper=stepper)
        if J:
            rng = np.random.default_rng(5)
            m.set(c=rng.standard_normal(kw["size"]),
                  d=lambda x, y, z: np.sin(2 * np.pi * x / 1e5) * z)
        return m

    jm, tm = make(True), make(False)
    assert tm.prognostic_3d == ("c", "d") and "u" not in tm.state["fields"]
    run_pair(jm, tm, (900.0,) * 3, ("c", "d"), tol=1e-12)
    w_j = np.asarray(jm.state["w"])
    w_t = tm.state["w"].numpy()
    assert np.abs(w_t - w_j[tuple(slice((a - b) // 2, (a - b) // 2 + b)
                                  for a, b in zip(w_j.shape, w_t.shape))]
                  ).max() <= 1e-12 * max(np.abs(w_j).max(), 1e-300)


# -- the kernel route's refusals ---------------------------------------------------------

def _grid():
    return ot.LatitudeLongitudeGrid(size=(8, 8, 4), longitude=(0, 60),
                                    latitude=(15, 75), z=(-1000.0, 0.0),
                                    dtype=F64, device="cpu")


REFUSED = {
    "prescribed_velocities": dict(velocities=ot.PrescribedVelocityFields()),
    "zstar": dict(vertical_coordinate="zstar"),
    "eddy_velocities": dict(closure=(ot.IsopycnalSkewSymmetricDiffusivity(
        kappa_gm=100.0, skew_flux_formulation="advective"),),
        buoyancy=ot.BuoyancyTracer()),
    "eddy_velocities_in_tuple": dict(closure=(
        ot.HorizontalScalarDiffusivity(kappa=10.0),
        ot.IsopycnalSkewSymmetricDiffusivity(
            kappa_gm=100.0, skew_flux_formulation="advective")),
        buoyancy=ot.BuoyancyTracer()),
    "flux_form_momentum": dict(momentum_advection=ot.WENO(5)),
    "per_tracer_schemes": dict(tracer_advection={"T": ot.WENO(5)}),
}
JAX_MESSAGES = {
    "prescribed_velocities": "prescribed velocities",
    "zstar": "z\\* moving coordinate",
    "eddy_velocities": "eddy-velocity",
    "eddy_velocities_in_tuple": "eddy-velocity",
    "flux_form_momentum": "non-vector-invariant",
    "per_tracer_schemes": "per-tracer",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_kernel_route_refusals(case):
    """"auto" takes the plain tendency; True and "packed" raise as JAX's
    explicit fused path raises (a ValueError naming the configuration)."""
    kw = dict(REFUSED[case], tracers=("T",) if "buoyancy" not in
              REFUSED[case] else ("b", "T"))
    m = HydrostaticFreeSurfaceModel(_grid(), fused_tendencies="auto", **kw)
    assert not m.uses_kernel
    for opt in (True, "packed"):
        with pytest.raises(ValueError, match=JAX_MESSAGES[case]):
            HydrostaticFreeSurfaceModel(_grid(), fused_tendencies=opt, **kw)
