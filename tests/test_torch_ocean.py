"""The ocean physics of the port's hydrostatic model against the JAX
package's, on the CPU in float64.

Each module on the same seeded inputs (padded fields with random halos) on
both sides:
- ``FixedTimeStepSize``: Δτ, the substep count and the weights, and
  ``cfl=`` with ``fixed_dt=`` (exact: the same float64 host arithmetic);
- callable and field-dependent Flux conditions through ``apply_flux_bcs``
  on bounded and periodic x of a lat-lon grid, and the immersed Flux, Value
  and Gradient conditions: 1e-12;
- CATKE at (12, 10, 8) with H = 3: the diffusivities (every padded slot),
  the implicit diffusivities and damping, ``step_turbulence`` with M = 1
  and M = 3, and the surface fluxes the model derives: 1e-12;
- the convective-adjustment, Ri-based and two-dimensional Leith closures,
  and k-ε (its step_turbulence with M = 1 and M = 3): 1e-12;
- the immersed masks, effective spacings and column geometry of
  GridFittedBottom, PartialCellBottom and GridFittedBoundary (exact) and
  the WENO advection cascade next to a ridge (1e-12);
- ``HydrostaticFreeSurfaceModel`` over 3 steps at 1e-10 relative to
  max|JAX| in every field (u, v, the tracers, η, w): the CATKE ocean row
  (``chip_smoke.ocean_model``, ``cfl=0.7``) with a flat bottom (the
  golden's VectorInvariant(), which JAX compiles faster) and with the
  ridge; a vertically implicit ScalarDiffusivity in a tuple with forcing,
  a function flux and ``cfl=0.7`` across two Δt (two substep counts); the
  Ri-based and
  convective-adjustment closures in a tuple under TEOS-10 with
  field-dependent flux conditions; the implicit free surface by
  preconditioned conjugate gradients (a RectilinearGrid, and a lat-lon
  grid with a ridge) and the explicit one on a periodic lat-lon grid; k-ε
  in horizontally uniform columns under quasi-AB2 (M = 2) and under the
  split RK3;
- the ``ocean_catke_windstress`` golden at 1e-9 (its own bound);
- a float32 step of the ocean row with the ridge, every tensor float32;
- CATKE in the NonhydrostaticModel (an ordinary tracer closure), 1e-10.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import oceananigans_tpu as jo
import oceananigans_tpu.buoyancy as jb
import oceananigans_tpu.forcings as jf
from oceananigans_tpu.advection import Centered as ja_Centered
from oceananigans_tpu.advection import WENO as JWENO, div_Uc as j_div_Uc
from oceananigans_tpu.advection.vector_invariant import (
    VectorInvariant as JVI, WENOVectorInvariant as JWVI)
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFBC, FluxBoundaryCondition as JFlux,
    GradientBoundaryCondition as JGrad, ValueBoundaryCondition as JValue,
    regularize_field_boundary_conditions as j_reg)
from oceananigans_tpu.boundary_conditions.boundary_condition import \
    ImmersedBoundaryCondition as JIBC
from oceananigans_tpu.boundary_conditions.fill_halos import (
    apply_flux_bcs as j_apply_flux_bcs,
    apply_immersed_flux_bcs as j_apply_immersed)
import oceananigans_tpu.closures.tke_dissipation as jk
from oceananigans_tpu.closures.catke import CATKEVerticalDiffusivity as JCATKE
from oceananigans_tpu.closures.scalar_diffusivity import (
    HorizontalScalarDiffusivity as JHSD, VerticalScalarDiffusivity as JVSD,
    VerticallyImplicitTimeDiscretization as JVITD)
from oceananigans_tpu.closures.vertical_diffusivities import (
    ConvectiveAdjustmentVerticalDiffusivity as JCA,
    RiBasedVerticalDiffusivity as JRi, TwoDimensionalLeith as JLeith)
from oceananigans_tpu.coriolis import HydrostaticSphericalCoriolis as JHSC
from oceananigans_tpu.immersed import (
    GridFittedBottom as JGFB, GridFittedBoundary as JGFBd,
    ImmersedBoundaryGrid as JIBG, PartialCellBottom as JPCB)
from oceananigans_tpu.models.free_surfaces import (
    ExplicitFreeSurface as JExplicit, ImplicitFreeSurface as JImplicit,
    SplitExplicitFreeSurface as JSplit)
from oceananigans_tpu.models.hydrostatic import (
    HydrostaticFreeSurfaceModel as JModel,
    immersed_column_geometry as j_geometry)
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.closures.tke_dissipation as tk
import oceananigans_tpu_torch.forcings as tf
from oceananigans_tpu_torch.advection.fluxes import div_Uc as t_div_Uc
from oceananigans_tpu_torch.boundary_conditions import (
    apply_flux_bcs as t_apply_flux_bcs_interior, apply_flux_bcs_padded,
    regularize_field_boundary_conditions as t_reg)
from oceananigans_tpu_torch.boundary_conditions.boundary_condition import \
    ImmersedBoundaryCondition as TIBC
from oceananigans_tpu_torch.boundary_conditions.fill_halos import \
    apply_immersed_flux_bcs as t_apply_immersed
from oceananigans_tpu_torch.closures import (
    CATKEVerticalDiffusivity as TCATKE,
    ConvectiveAdjustmentVerticalDiffusivity as TCA,
    RiBasedVerticalDiffusivity as TRi, TwoDimensionalLeith as TLeith)
from oceananigans_tpu_torch.immersed import (
    GridFittedBottom as TGFB, GridFittedBoundary as TGFBd,
    ImmersedBoundaryGrid as TIBG, PartialCellBottom as TPCB)
from oceananigans_tpu_torch.models.free_surfaces import (
    MINIMUM_SUBSTEPS, ExplicitFreeSurface, FixedSubstepNumber,
    FixedTimeStepSize, ImplicitFreeSurface)
from oceananigans_tpu_torch.models.hydrostatic import (
    HydrostaticFreeSurfaceModel, immersed_column_geometry)

torch.set_num_threads(1)

F64 = torch.float64
N = (12, 10, 8)
H = (3, 3, 3)
LAT = (15, 75)
Z = (-1800.0, 0.0)
BOUNDED_X = (0.0, 60.0)
PERIODIC_X = (0.0, 360.0)
TIME = 3600.0
TOL = 1e-12
LOCS = {"u": ("f", "c", "c"), "v": ("c", "f", "c"), "w": ("c", "c", "f"),
        "T": ("c", "c", "c"), "S": ("c", "c", "c"), "e": ("c", "c", "c"),
        "b": ("c", "c", "c")}
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _grids(lon=BOUNDED_X, size=N, halo=H):
    jg = jo.LatitudeLongitudeGrid(size=size, longitude=lon, latitude=LAT,
                                  z=Z, halo=halo, dtype=np.float64)
    tg = ot.LatitudeLongitudeGrid(size=size, longitude=lon, latitude=LAT,
                                  z=Z, halo=halo, dtype=F64, device="cpu")
    return jg, tg


def _padded_fields(shape, seed=5, names=("u", "v", "w", "T", "S", "e")):
    """Seeded padded arrays (halos random too): T stratified with noise so
    N² takes both signs, S near 35, e positive and small."""
    rng = np.random.default_rng(seed)
    z = np.linspace(-1, 0, shape[2]).reshape(1, 1, -1)
    out = {}
    for n in names:
        a = rng.standard_normal(shape)
        if n == "T":
            a = 12 + 4 * z + 0.5 * a
        elif n == "S":
            a = 35 + 0.1 * a
        elif n == "e":
            a = 1e-5 * np.abs(a) + 1e-7
        elif n == "b":
            a = 1e-3 * z + 2e-4 * a
        else:
            a = 0.05 * a
        out[n] = a
    return out


def _both(arrays):
    return ({n: jnp.asarray(a) for n, a in arrays.items()},
            {n: torch.as_tensor(a.copy()) for n, a in arrays.items()})


def _embed(a, shape):
    """``a`` centred in a zero array of the (wider) ``shape``."""
    out = np.zeros(shape)
    out[tuple(slice((n - m) // 2, (n - m) // 2 + m)
              for n, m in zip(shape, a.shape))] = a
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _close(t, j, tol=TOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape or np.ndim(t) == 0 or np.ndim(j) == 0
    assert _rel(t, j) <= tol, _rel(t, j)


# -- FixedTimeStepSize -----------------------------------------------------------

@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X])
def test_fixed_time_step_size(lon):
    """Δτ = cfl·Δs/√(g·Lz), the substep count ceil(2Δt/Δτ) (at least 5)
    and the weights for several Δt, and cfl= with fixed_dt= and grid=
    turning into the same fixed count: exact."""
    jg, tg = _grids(lon)
    jfs, tfs = JSplit(cfl=0.7), ot.SplitExplicitFreeSurface(cfl=0.7)
    assert isinstance(tfs.substepping, FixedTimeStepSize)
    with pytest.raises(RuntimeError, match="materialize"):
        tfs.settings(120.0)
    jfs.materialize(jg)
    tfs.materialize(tg)
    assert tfs.substepping.dt_barotropic == jfs.substepping.dt_barotropic
    counts = set()
    for dt in (1.0, 120.0, 1200.0, 2400.0, 3600.7, 36000.0, 86400.0):
        jfrac, jw = jfs.settings(dt)
        tfrac, tw = tfs.settings(dt)
        assert tfrac == jfrac and np.array_equal(tw, jw)
        counts.add(round(2.0 / tfrac))
    assert min(counts) == MINIMUM_SUBSTEPS and len(counts) > 2
    for fixed_dt in (600.0, 3600.0):
        jf_ = JSplit(cfl=0.7, fixed_dt=fixed_dt, grid=jg)
        tf_ = ot.SplitExplicitFreeSurface(cfl=0.7, fixed_dt=fixed_dt,
                                          grid=tg)
        assert isinstance(tf_.substepping, FixedSubstepNumber)
        assert tf_.substeps == jf_.substeps
        assert np.array_equal(tf_.weights, jf_.weights)


# -- flux conditions ----------------------------------------------------------------

def _flux_conditions(lib):
    """Callable and field-dependent conditions on u and T (arithmetic only,
    so that numpy, jax and torch arrays all take them)."""
    FBC, Flux = lib
    drag = chip_smoke.ocean_drag
    return {
        "u": FBC(top=Flux(lambda x, y, t: -1e-4 * (1 + 0.01 * y) * (1 + t
                                                                  / 1e5)),
                 bottom=Flux(drag, field_dependencies=("u", "v"))),
        "v": FBC(top=Flux(2e-5), bottom=Flux(
            lambda x, y, t, u, v: -1e-3 * v * (u * u + v * v) ** 0.5,
            field_dependencies=("u", "v"))),
        "T": FBC(top=Flux(lambda x, y, t, T, S: 1e-6 * (T - 10) * (S - 34),
                          field_dependencies=("T", "S")),
                 bottom=Flux(lambda x, y, t: 1e-7 * x)),
    }


@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X])
def test_flux_conditions(lon):
    """Callable and field-dependent Flux conditions on the z sides (each
    dependency interpolated to the field's location and cut at the boundary
    cell) against the JAX apply_flux_bcs: the padded and the interior-shaped
    forms, 1e-12."""
    jg, tg = _grids(lon)
    arrays = _padded_fields(jg.padded_shape, seed=11)
    jfields, tfields = _both(arrays)
    jb_ = _flux_conditions((JFBC, JFlux))
    tb_ = _flux_conditions((ot.FieldBoundaryConditions,
                            ot.FluxBoundaryCondition))
    rng = np.random.default_rng(12)
    for name in ("u", "v", "T"):
        loc = LOCS[name]
        G = rng.standard_normal(jg.padded_shape)
        want = j_apply_flux_bcs(jnp.asarray(G), jg, loc,
                                j_reg(jb_[name], jg, loc), TIME,
                                fields=jfields, locs=LOCS)
        tbcs = t_reg(tb_[name], tg, loc)
        got = apply_flux_bcs_padded(torch.as_tensor(G.copy()), tg, loc,
                                    tbcs, TIME, fields=tfields, locs=LOCS)
        _close(got, want)
        Gi = torch.as_tensor(G[tg.interior_slices].copy())
        got_i = t_apply_flux_bcs_interior(Gi, tg, loc, tbcs, TIME,
                                          fields=tfields, locs=LOCS)
        _close(got_i, np.asarray(want)[tg.interior_slices])


def test_flux_conditions_refused():
    """Since item 3 a callable Value condition, a callable Flux condition
    on an x side and a scalar Flux condition with (unused) field
    dependencies build, and fill or enter the tendency as JAX's do (the
    fill of T at 1e-14, the flux on u at 1e-12); a FieldTimeSeries
    condition on an x side still raises, as JAX's cannot take it either
    (it pads its snapshots as z planes)."""
    from oceananigans_tpu.boundary_conditions import (
        fill_halo_regions as j_fill)
    from oceananigans_tpu_torch.boundary_conditions import (
        fill_halo_regions as t_fill)
    from oceananigans_tpu_torch.boundary_conditions.boundary_condition \
        import FieldTimeSeriesBoundaryCondition
    jg, tg = _grids()
    rng = np.random.default_rng(13)
    a = rng.standard_normal(jg.padded_shape)
    jf = lambda x, y, t: 1e-3 * jnp.cos(x) * y + 0 * t
    tf_ = lambda x, y, t: 1e-3 * torch.cos(x) * y + 0 * t
    want = j_fill(jnp.asarray(a), jg, LOCS["T"],
                  j_reg(JFBC(top=JValue(jf)), jg, LOCS["T"]), TIME)
    got = t_fill(torch.as_tensor(a.copy()), tg, LOCS["T"],
                 t_reg(ot.FieldBoundaryConditions(
                     top=ot.ValueBoundaryCondition(tf_)), tg, LOCS["T"]),
                 TIME)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-14
    arrays = _padded_fields(jg.padded_shape, seed=14)
    jfields, tfields = _both(arrays)
    for jb_, tb_ in (
            (JFBC(west=JFlux(jf), east=JFlux(1e-4, field_dependencies=("u",))),
             ot.FieldBoundaryConditions(
                 west=ot.FluxBoundaryCondition(tf_),
                 east=ot.FluxBoundaryCondition(
                     1e-4, field_dependencies=("u",)))),):
        G = rng.standard_normal(jg.padded_shape)
        want = j_apply_flux_bcs(jnp.asarray(G), jg, LOCS["T"],
                                j_reg(jb_, jg, LOCS["T"]), TIME,
                                fields=jfields, locs=LOCS)
        got = apply_flux_bcs_padded(torch.as_tensor(G.copy()), tg,
                                    LOCS["T"], t_reg(tb_, tg, LOCS["T"]),
                                    TIME, fields=tfields, locs=LOCS)
        _close(got, want)
    with pytest.raises(NotImplementedError, match="z-normal"):
        t_reg(ot.FieldBoundaryConditions(
            west=FieldTimeSeriesBoundaryCondition(None)), tg, LOCS["T"])


# -- CATKE ----------------------------------------------------------------------------

def _jb_callable(x, y, t):
    return 2e-8 * (1 + 0.01 * y) + 0 * x


@pytest.mark.parametrize("Jb", ["none", "scalar", "callable"])
def test_catke_diffusivities(Jb):
    """compute_diffusivities on every padded slot, the implicit
    diffusivities, the damping and the clip, with no surface buoyancy flux,
    a destabilizing scalar one and a callable one: 1e-12."""
    jg, tg = _grids()
    flux = {"none": None, "scalar": 3e-8, "callable": _jb_callable}[Jb]
    jbuoy = jb.SeawaterBuoyancy(equation_of_state=jb.LinearEquationOfState())
    tbuoy = ot.SeawaterBuoyancy(equation_of_state=ot.LinearEquationOfState())
    jc = JCATKE(buoyancy=jbuoy, surface_buoyancy_flux=flux)
    tc = TCATKE(buoyancy=tbuoy, surface_buoyancy_flux=flux)
    jfields, tfields = _both(_padded_fields(jg.padded_shape))
    ja = jc.compute_diffusivities(jg, jfields, TIME)
    ta = tc.compute_diffusivities(tg, tfields, TIME)
    assert set(ta) == set(ja)
    for key in ja:
        assert ta[key].dtype == F64
        _close(ta[key], ja[key])
    prog = ("u", "v", "T", "S", "e")
    jk = jc.vertical_implicit_kappas(jg, {n: jfields[n] for n in prog}, ja)
    tk = tc.vertical_implicit_kappas(tg, {n: tfields[n] for n in prog}, ta)
    assert set(tk) == set(jk)
    for key in jk:
        _close(tk[key], jk[key])
    _close(tc.vertical_implicit_damping(tg, tfields, ta)["e"],
           jc.vertical_implicit_damping(jg, jfields, ja)["e"])
    _close(tc.tracer_tendency(tg, "e", tfields, ta),
           jc.tracer_tendency(jg, "e", jfields, ja))
    neg = {"e": tfields["e"] - 2e-5}
    _close(tc.clip_fields(neg)["e"],
           jc.clip_fields({"e": jfields["e"] - 2e-5})["e"])


@pytest.mark.parametrize("M", [1, 3])
def test_catke_step_turbulence(M):
    """step_turbulence over one step of 600 s in M substeps (an AB2 step,
    and for M = 1 an Euler one too) from seeded old and new states with
    random halos: e and the stored tendency on every slot, 1e-12."""
    jg, tg = _grids()
    flux = _jb_callable
    jbuoy = jb.SeawaterBuoyancy(equation_of_state=jb.LinearEquationOfState())
    tbuoy = ot.SeawaterBuoyancy(equation_of_state=ot.LinearEquationOfState())
    ts = None if M == 1 else 200.0
    jc = JCATKE(buoyancy=jbuoy, surface_buoyancy_flux=flux, tke_time_step=ts)
    tc = TCATKE(buoyancy=tbuoy, surface_buoyancy_flux=flux, tke_time_step=ts)
    assert tc.substeps_for(600.0) == jc.substeps_for(600.0) == M
    j_old, t_old = _both(_padded_fields(jg.padded_shape, seed=1))
    j_new, t_new = _both(_padded_fields(jg.padded_shape, seed=2))
    rng = np.random.default_rng(3)
    slow, prev = (1e-8 * rng.standard_normal(jg.padded_shape)
                  for _ in range(2))
    for euler in ((False, True) if M == 1 else (False,)):
        je, jG = jc.step_turbulence(jg, j_old, j_new,
                                    {"e": jnp.asarray(slow)},
                                    {"e": jnp.asarray(prev)}, 600.0, 0.1,
                                    euler, M, TIME)
        te, tG = tc.step_turbulence(tg, t_old, t_new,
                                    {"e": torch.as_tensor(slow)},
                                    {"e": torch.as_tensor(prev)}, 600.0, 0.1,
                                    euler, M, TIME)
        _close(te["e"], je["e"])
        _close(tG["e"], jG["e"])


def _surface_models(eos):
    """A JAX and a port model whose conditions CATKE's surface coupling
    reads: a callable T top flux, a scalar S one, a field-dependent u top
    stress and a scalar v one (not stepped)."""
    built = []
    for J in (True, False):
        lib = jo if J else ot
        g = lib.LatitudeLongitudeGrid(size=(8, 6, 4), longitude=BOUNDED_X,
                                      latitude=LAT, z=Z,
                                      **(dict(dtype=np.float64) if J else
                                         dict(dtype=F64, device="cpu")))
        FBC, Flux = ((JFBC, JFlux) if J else
                     (ot.FieldBoundaryConditions, ot.FluxBoundaryCondition))
        bcs = {"T": FBC(top=Flux(lambda x, y, t: 1e-5 * (1 + 0.01 * y))),
               "S": FBC(top=Flux(2e-6)),
               "u": FBC(top=Flux(lambda x, y, t, u, v: -1e-4 + 1e-3 * u * v,
                                 field_dependencies=("u", "v"))),
               "v": FBC(top=Flux(3e-5))}
        e = (jb if J else ot).__dict__[eos]()
        buoy = (jb.SeawaterBuoyancy if J else ot.SeawaterBuoyancy)(
            equation_of_state=e)
        M = JModel if J else HydrostaticFreeSurfaceModel
        built.append(M(g, free_surface=(JSplit if J else
                                        ot.SplitExplicitFreeSurface)(
                                            substeps=5),
                       buoyancy=buoy, closure=(JCATKE if J else TCATKE)(),
                       tracers=("T", "S"), boundary_conditions=bcs))
    return built


@pytest.mark.parametrize("eos", ["LinearEquationOfState",
                                 "TEOS10EquationOfState"])
def test_catke_surface_fluxes(eos):
    """The surface couplings the model installs: Jᵇ = g(αJᵀ − βJˢ) under a
    linear equation of state (none under a nonlinear one, as in JAX) and
    e's top flux from u★ and Jᵇ, evaluated through the flux conditions on
    the same state: 1e-12."""
    jm, tm = _surface_models(eos)
    jc, tc = jm.closure, tm.closure
    if eos != "LinearEquationOfState":
        assert jc.surface_buoyancy_flux is None
        assert tc.surface_buoyancy_flux is None
    # the JAX model rounds Hy up to 8: its arrays hold the port's, centred
    arrays = _padded_fields(tm.grid.padded_shape, seed=21)
    _, tfields = _both(arrays)
    jshape = jm.grid.padded_shape
    jfields = {n: jnp.asarray(_embed(a, jshape)) for n, a in arrays.items()}
    ints = tm.grid.interior_slices
    jints = jm.grid.interior_slices
    tJb = torch.as_tensor(tc._Jb(tm.grid, TIME, tfields), dtype=F64).numpy()
    jJb = np.asarray(jc._Jb(jm.grid, TIME, jfields))
    if tJb.ndim:
        def cut(a, sl):
            return a[tuple(s if a.shape[k] > 1 else slice(None)
                           for k, s in enumerate(sl[:2]))]
        tJb, jJb = cut(tJb, ints), cut(jJb, jints)
    _close(tJb, jJb)
    loc = LOCS["e"]
    want = j_apply_flux_bcs(jnp.zeros(jshape), jm.grid, loc, jm.bcs["e"],
                            TIME, fields=jfields, locs=LOCS)
    got = apply_flux_bcs_padded(torch.zeros(tm.grid.padded_shape,
                                            dtype=F64),
                                tm.grid, loc, tm.bcs["e"], TIME,
                                fields=tfields, locs=LOCS)
    assert np.abs(np.asarray(want)).max() > 0
    _close(got[ints], np.asarray(want)[jints])


# -- the other vertical closures --------------------------------------------------------

def _closure_pair(name):
    jbuoy = jb.SeawaterBuoyancy(equation_of_state=jb.LinearEquationOfState())
    tbuoy = ot.SeawaterBuoyancy(equation_of_state=ot.LinearEquationOfState())
    if name == "convective_adjustment":
        kw = dict(convective_kappa_z=0.8, convective_nu_z=0.3,
                  background_kappa_z=1e-5, background_nu_z=1e-4)
        return JCA(buoyancy=jbuoy, **kw), TCA(buoyancy=tbuoy, **kw)
    if name == "ri_based":
        return JRi(buoyancy=jbuoy), TRi(buoyancy=tbuoy)
    if name == "ri_based_entraining":
        return (JRi(buoyancy=jbuoy, surface_buoyancy_flux=_jb_callable),
                TRi(buoyancy=tbuoy, surface_buoyancy_flux=_jb_callable))
    return JLeith(C=0.25, C_redi=0.7), TLeith(C=0.25, C_redi=0.7)


@pytest.mark.parametrize("name", ["convective_adjustment", "ri_based",
                                  "ri_based_entraining", "leith"])
def test_vertical_closures(name):
    """Each closure's diffusivities on every padded slot, its implicit
    diffusivities and its momentum and tracer tendencies on the interior:
    1e-12."""
    jg, tg = _grids()
    jc, tc = _closure_pair(name)
    jfields, tfields = _both(_padded_fields(jg.padded_shape, seed=9))
    ja = jc.compute_diffusivities(jg, jfields, TIME)
    ta = tc.compute_diffusivities(tg, tfields, TIME)
    assert set(ta) == set(ja)
    for key in ja:
        _close(ta[key], ja[key])
    prog = ("u", "v", "T", "S")
    jk = jc.vertical_implicit_kappas(jg, {n: jfields[n] for n in prog}, ja)
    tk = tc.vertical_implicit_kappas(tg, {n: tfields[n] for n in prog}, ta)
    assert set(tk) == set(jk)
    for key in jk:
        _close(tk[key], jk[key])
    ints = tg.interior_slices
    jm = jc.momentum_tendencies(jg, jfields, ja)
    tm = tc.momentum_tendencies(tg, tfields, ta)
    for c in "uv":
        _close(tm[c][ints], np.asarray(jm[c])[ints])
    _close(tc.tracer_tendency(tg, "T", tfields, ta)[ints],
           np.asarray(jc.tracer_tendency(jg, "T", jfields, ja))[ints])


@pytest.mark.parametrize("stability", ["variable", "constant"])
def test_keps_closure(stability):
    """k-ε on seeded states with random halos: the diffusivities on every
    padded slot, the implicit diffusivities and dampings, the e and ε
    tendencies and the clip, under either stability functions; with the
    variable ones, step_turbulence with M = 1 (an Euler step) and M = 3
    with a friction velocity: 1e-12."""
    jg, tg = _grids()
    jbuoy = jb.SeawaterBuoyancy(equation_of_state=jb.LinearEquationOfState())
    tbuoy = ot.SeawaterBuoyancy(equation_of_state=ot.LinearEquationOfState())
    sf = {"variable": (jk.VariableStabilityFunctions,
                       tk.VariableStabilityFunctions),
          "constant": (jk.ConstantStabilityFunctions,
                       tk.ConstantStabilityFunctions)}[stability]
    kw = dict(friction_velocity=lambda x, y, t: 0.01 + 1e-4 * y)
    jc = jk.TKEDissipationVerticalDiffusivity(
        stability_functions=sf[0](), buoyancy=jbuoy, **kw)
    tc_ = tk.TKEDissipationVerticalDiffusivity(
        stability_functions=sf[1](), buoyancy=tbuoy, **kw)
    arrays = _padded_fields(jg.padded_shape)
    arrays["eps"] = 1e-8 * np.abs(np.random.default_rng(8).standard_normal(
        jg.padded_shape)) + 1e-10
    jfields, tfields = _both(arrays)
    ja = jc.compute_diffusivities(jg, jfields, TIME)
    ta = tc_.compute_diffusivities(tg, tfields, TIME)
    assert set(ta) == set(ja)
    for key in ja:
        _close(ta[key], ja[key])
    prog = ("u", "v", "T", "S", "e", "eps")
    jk_ = jc.vertical_implicit_kappas(jg, {n: jfields[n] for n in prog}, ja)
    tk_ = tc_.vertical_implicit_kappas(tg, {n: tfields[n] for n in prog}, ta)
    assert set(tk_) == set(jk_)
    for key in jk_:
        _close(tk_[key], jk_[key])
    jd = jc.vertical_implicit_damping(jg, jfields, ja)
    td = tc_.vertical_implicit_damping(tg, tfields, ta)
    for name in ("e", "eps"):
        _close(td[name], jd[name])
        _close(tc_.tracer_tendency(tg, name, tfields, ta),
               jc.tracer_tendency(jg, name, jfields, ja))
        _close(tc_.clip_fields(tfields)[name], jc.clip_fields(jfields)[name])
    if stability == "constant":
        return
    j_new, t_new = _both(_padded_fields(jg.padded_shape, seed=2))
    for n in ("e", "eps"):
        j_new[n], t_new[n] = jfields[n], tfields[n]
    rng = np.random.default_rng(3)
    slow = {n: 1e-9 * rng.standard_normal(jg.padded_shape)
            for n in ("e", "eps")}
    prev = {n: 1e-9 * rng.standard_normal(jg.padded_shape)
            for n in ("e", "eps")}
    for M, euler in ((1, True), (3, False)):
        want = jc.step_turbulence(
            jg, jfields, j_new, {k: jnp.asarray(v) for k, v in slow.items()},
            {k: jnp.asarray(v) for k, v in prev.items()}, 600.0, 0.1, euler,
            M, TIME)
        got = tc_.step_turbulence(
            tg, tfields, t_new,
            {k: torch.as_tensor(v) for k, v in slow.items()},
            {k: torch.as_tensor(v) for k, v in prev.items()}, 600.0, 0.1,
            euler, M, TIME)
        for part in range(2):
            for name in ("e", "eps"):
                _close(got[part][name], want[part][name])


def test_keps_friction_velocity():
    """The friction velocity the model derives for k-ε from the u and v top
    fluxes (a scalar, and a callable): as the JAX model's, 1e-12."""
    for tau_x in (-1e-4, lambda x, y, t: -1e-4 * (1 + 0.01 * y)):
        built = []
        for J in (True, False):
            lib = jo if J else ot
            g = lib.LatitudeLongitudeGrid(
                size=(8, 6, 4), longitude=BOUNDED_X, latitude=LAT, z=Z,
                **(dict(dtype=np.float64) if J else
                   dict(dtype=F64, device="cpu")))
            FBC, Flux = ((JFBC, JFlux) if J else
                         (ot.FieldBoundaryConditions,
                          ot.FluxBoundaryCondition))
            M = JModel if J else HydrostaticFreeSurfaceModel
            built.append(M(
                g, free_surface=(JSplit if J else
                                 ot.SplitExplicitFreeSurface)(substeps=5),
                buoyancy=(jb if J else ot).BuoyancyTracer(),
                closure=(jk if J else tk).TKEDissipationVerticalDiffusivity(),
                boundary_conditions={"u": FBC(top=Flux(tau_x)),
                                     "v": FBC(top=Flux(3e-5))}))
        jm, tm = built
        ju, tu = jm.closure.friction_velocity, tm.closure.friction_velocity
        if callable(tu):
            x = np.linspace(0, 60, 5).reshape(-1, 1, 1)
            y = np.linspace(15, 75, 4).reshape(1, -1, 1)
            ju = ju(x, y, TIME)
            tu = tu(torch.as_tensor(x), torch.as_tensor(y), TIME)
        _close(torch.as_tensor(tu, dtype=F64), ju)


# -- immersed boundaries ----------------------------------------------------------------

def _ridge(lam, phi):
    return -1800.0 + 1300.0 * np.exp(-((lam - 30.0) / 20.0) ** 2) \
        + 0 * phi


def _seamount(x, y, z):
    return (x - 20.0) ** 2 + (y - 40.0) ** 2 < 150.0 + z / 20.0


def _boundaries(kind):
    if kind == "grid_fitted_bottom":
        return JGFB(_ridge), TGFB(_ridge)
    if kind == "partial_cell_bottom":
        return JPCB(_ridge, 0.3), TPCB(_ridge, 0.3)
    return JGFBd(_seamount), TGFBd(_seamount)


ALL_LOCS = [(a, b, c) for a in "cf" for b in "cf" for c in "cf"]


@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X])
@pytest.mark.parametrize("kind", ["grid_fitted_bottom", "partial_cell_bottom",
                                  "grid_fitted_boundary"])
def test_immersed_geometry(kind, lon):
    """The solid masks at the four locations, the fluid masks at all eight,
    the effective Δz, Ax, Ay and V (partial cells), the column geometry of
    the barotropic mode and mask_immersed: exact."""
    jg0, tg0 = _grids(lon)
    jib, tib = _boundaries(kind)
    jg, tg = JIBG(jg0, jib), TIBG(tg0, tib)
    for attr in ("solid_ccc", "solid_fcc", "solid_cfc", "solid_ccf"):
        assert np.array_equal(getattr(tg, attr), getattr(jg, attr)), attr
    assert tg.solid_ccc.any() and not tg.solid_ccc.all()
    for loc in ALL_LOCS:
        assert np.array_equal(tg.fluid_mask_at(loc).numpy(),
                              np.asarray(jg.fluid_mask_at(loc, np.float64)))
        for metric in ("dz", "Ax", "Ay", "V"):
            t = getattr(tg, metric)(loc)
            j = getattr(jg, metric)(loc)
            t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            assert np.array_equal(np.broadcast_to(t, tg.padded_shape),
                                  np.broadcast_to(j, tg.padded_shape)), \
                (metric, loc)
    jgeo = j_geometry(jg, jnp.float64)
    tgeo = immersed_column_geometry(tg)
    for a, b in zip(tgeo[:2] + tgeo[3:], jgeo[:2] + jgeo[3:]):
        assert np.array_equal(a, np.asarray(b))
    for loc in tgeo[2]:
        assert np.array_equal(tgeo[2][loc], np.asarray(jgeo[2][loc]))
    a = np.random.default_rng(4).standard_normal(tg.padded_shape)
    for loc in (LOCS["u"], LOCS["v"], LOCS["T"], LOCS["w"]):
        assert np.array_equal(
            tg.mask_immersed(torch.as_tensor(a), loc).numpy(),
            np.asarray(jg.mask_immersed(jnp.asarray(a), loc)))


@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X])
def test_immersed_advection_cascade(lon):
    """WENO(5) tracer advection next to a ridge: within the
    scheme's buffer of a solid cell the reconstruction drops to the buffer
    scheme, as in JAX: 1e-12 on the interior."""
    jg0, tg0 = _grids(lon, halo=(5, 5, 5))
    jg, tg = JIBG(jg0, JGFB(_ridge)), TIBG(tg0, TGFB(_ridge))
    jfields, tfields = _both(_padded_fields(jg.padded_shape, seed=13))
    ints = tg.interior_slices
    for order in (5,):
        want = j_div_Uc(jg, JWENO(order, smoothness_dtype=jnp.float64),
                        *(jfields[n] for n in ("u", "v", "w", "T")))
        got = t_div_Uc(tg, ot.WENO(order, smoothness_dtype=F64),
                       *(tfields[n] for n in ("u", "v", "w", "T")))
        _close(got[ints], np.asarray(want)[ints])
        plain = t_div_Uc(tg0, ot.WENO(order, smoothness_dtype=F64),
                         *(tfields[n] for n in ("u", "v", "w", "T")))
        assert _rel(got[ints], plain[ints]) > 1e-6   # the cascade acts


def test_immersed_flux_conditions():
    """Immersed Flux, Value and Gradient conditions on every side (one
    condition for all sides, and per side) against the JAX
    apply_immersed_flux_bcs: 1e-12."""
    jg0, tg0 = _grids()
    jg, tg = JIBG(jg0, JGFBd(_seamount)), TIBG(tg0, TGFBd(_seamount))
    arrays = _padded_fields(jg.padded_shape, seed=17)
    c = arrays["T"]
    G = np.random.default_rng(18).standard_normal(jg.padded_shape)
    cases = [
        (JFlux(1e-5), ot.FluxBoundaryCondition(1e-5)),
        (JIBC(west=JValue(11.0), bottom=JGrad(1e-3), top=JFlux(-2e-6),
              north=JValue(13.0)),
         TIBC(west=ot.ValueBoundaryCondition(11.0),
              bottom=ot.GradientBoundaryCondition(1e-3),
              top=ot.FluxBoundaryCondition(-2e-6),
              north=ot.ValueBoundaryCondition(13.0))),
    ]
    for jibc, tibc in cases:
        want = j_apply_immersed(jnp.asarray(G), jg, LOCS["T"], jibc, TIME,
                                c=jnp.asarray(c), kappa=0.7)
        got = t_apply_immersed(torch.as_tensor(G.copy()), tg, LOCS["T"],
                               tibc, TIME, c=torch.as_tensor(c), kappa=0.7)
        _close(got, want)


# -- the model --------------------------------------------------------------------------

NM = (12, 10, 6)
CFL_CASE = "implicit_tuple_forcing"
# WENOVectorInvariant's halo of 6 needs Nz > 6
NM_OCEAN = (12, 10, 8)


def _jax_ocean(immersed, tke_time_step=None, size=NM_OCEAN):
    """chip_smoke.ocean_model on the JAX side (its flat-bottom variant with
    the golden's VectorInvariant(), which JAX compiles faster)."""
    g = jo.LatitudeLongitudeGrid(size=size, longitude=(0, 60),
                                 latitude=(15, 75), z=(-1800.0, 0.0),
                                 dtype=np.float64)
    if immersed:
        g = JIBG(g, JGFB(chip_smoke.ocean_ridge))
    buoy = jb.SeawaterBuoyancy(equation_of_state=jb.LinearEquationOfState())
    m = JModel(g, momentum_advection=(JWVI(smoothness_dtype=jnp.float64)
                                      if immersed else JVI()),
               tracer_advection=JWENO(5, smoothness_dtype=jnp.float64),
               coriolis=JHSC(), free_surface=JSplit(cfl=0.7), buoyancy=buoy,
               closure=JCATKE(tke_time_step=tke_time_step),
               tracers=("T", "S"),
               boundary_conditions={"u": JFBC(
                   top=JFlux(-1e-4), bottom=JFlux(
                       chip_smoke.ocean_drag,
                       field_dependencies=("u", "v")))})
    rng = np.random.default_rng(0)
    m.set(T=lambda lam, phi, z: 12 + 8e-3 * z + 2 * np.cos(np.radians(phi)),
          S=35.0, u=0.05 * rng.standard_normal(size))
    return m


def _port_ocean(immersed, tke_time_step=None, dtype=F64):
    m = chip_smoke.ocean_model(
        NM_OCEAN, dtype, "cpu", immersed=immersed, smoothness=dtype,
        momentum_advection=None if immersed else ot.VectorInvariant())
    m.closure.tke_time_step = tke_time_step
    return m


def _simple_model(case, J):
    """The closure and forcing cases: 12x10x6 lat-lon, VectorInvariant(),
    spherical Coriolis, 10 substeps."""
    lib = jo if J else ot
    g = lib.LatitudeLongitudeGrid(size=NM, longitude=(0, 60),
                                  latitude=(15, 75), z=(-1800.0, 0.0),
                                  **(dict(dtype=np.float64) if J else
                                     dict(dtype=F64, device="cpu")))
    FBC, Flux = ((JFBC, JFlux) if J else
                 (ot.FieldBoundaryConditions, ot.FluxBoundaryCondition))
    split = JSplit if J else ot.SplitExplicitFreeSurface
    base = dict(coriolis=(JHSC if J else ot.HydrostaticSphericalCoriolis)(),
                free_surface=(split(cfl=0.7) if case in (
                        CFL_CASE, "split_rk3_keps_columns")
                        else split(substeps=10)))
    if case == "implicit_tuple_forcing":
        VITD = JVITD() if J else ot.VerticallyImplicitTimeDiscretization()
        VSD = JVSD if J else ot.VerticalScalarDiffusivity
        HSD = JHSD if J else ot.HorizontalScalarDiffusivity
        F = jf if J else tf
        extra = dict(
            tracers=("T",),
            closure=(VSD(VITD, nu=2e-2, kappa={"T": 5e-3}),
                     HSD(nu=50.0, kappa=20.0)),
            forcing={"u": F.ContinuousForcing(
                lambda x, y, z, t, T: 1e-7 * (T - 10) * (1 + t / 1e4),
                field_dependencies="T"),
                "T": F.Relaxation(1e-5, target=F.LinearTarget(
                    gradient=8e-3, intercept=12.0))},
            boundary_conditions={"T": FBC(top=Flux(
                lambda x, y, t: 1e-4 * (1 + 0.02 * y)))})
        ic = dict(T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi)
    elif case == "ri_based_convective_adjustment_teos10":
        buoy = (jb if J else ot).SeawaterBuoyancy(
            equation_of_state=(jb if J else ot).TEOS10EquationOfState())
        extra = dict(
            buoyancy=buoy, tracers=("T", "S"),
            closure=((JRi if J else TRi)(),
                     (JCA if J else TCA)(convective_kappa_z=0.5,
                                         background_kappa_z=1e-5)),
            boundary_conditions={
                "T": FBC(top=Flux(lambda x, y, t, T: 1e-5 * (T - 8),
                                  field_dependencies="T")),
                "u": FBC(bottom=Flux(chip_smoke.ocean_drag,
                                     field_dependencies=("u", "v")))})
        ic = dict(T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi,
                  S=lambda lam, phi, z: 35 - 1e-4 * z)
    elif case in ("keps_columns", "split_rk3_keps_columns"):
        # horizontally uniform columns, at rest, cooled from the top: k-ε
        # convection (the tendencies' halo ring is zero on both sides, so
        # JAX's reading of the unfilled tracer halos does not show)
        K = jk if J else tk
        extra = dict(
            buoyancy=(jb if J else ot).SeawaterBuoyancy(),
            tracers=("T", "S"),
            closure=K.TKEDissipationVerticalDiffusivity(
                tke_dissipation_time_step=300.0),
            timestepper=("SplitRungeKutta3" if case.startswith("split")
                         else "QuasiAdamsBashforth2"),
            boundary_conditions={"T": FBC(top=Flux(1e-4))})
        ic = dict(T=lambda lam, phi, z: 12 + 2e-3 * z + 0 * lam, S=35.0,
                  e=1e-5, eps=1e-9)
        M = JModel if J else HydrostaticFreeSurfaceModel
        m = M(g, **base, **extra)
        m.set(**ic)
        return m
    elif case in ("implicit_pcg_ridge", "explicit_periodic_x"):
        if case == "implicit_pcg_ridge":
            g = (JIBG if J else TIBG)(g, (JGFB if J else TGFB)(_ridge))
            base["free_surface"] = (JImplicit if J else
                                    ImplicitFreeSurface)()
        else:
            g = lib.LatitudeLongitudeGrid(
                size=NM, longitude=PERIODIC_X, latitude=(15, 75),
                z=(-1800.0, 0.0), **(dict(dtype=np.float64) if J else
                                     dict(dtype=F64, device="cpu")))
            base["free_surface"] = (JExplicit if J else
                                    ExplicitFreeSurface)()
        extra = dict(tracers=("T",))
        ic = dict(T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi,
                  eta=0.1 * np.random.default_rng(6).standard_normal(NM[:2]))
    elif case == "implicit_pcg_rectilinear":
        g = lib.RectilinearGrid(size=NM, extent=(1e6, 8e5, 1000.0),
                                topology=("periodic", "bounded", "bounded"),
                                **(dict(dtype=np.float64) if J else
                                   dict(dtype=F64, device="cpu")))
        base = dict(coriolis=lib.FPlane(f=1e-4),
                    free_surface=(JImplicit if J else ImplicitFreeSurface)(
                        solver_method="PreconditionedConjugateGradient"))
        extra = dict(tracers=("T",))
        ic = dict(T=lambda x, y, z: 12 + 8e-3 * z + 1e-6 * y,
                  eta=0.1 * np.random.default_rng(6).standard_normal(NM[:2]))
    M = JModel if J else HydrostaticFreeSurfaceModel
    m = M(g, **base, **extra)
    rng = np.random.default_rng(1)
    m.set(u=0.05 * rng.standard_normal(NM), v=0.05 * rng.standard_normal(NM),
          **ic)
    return m


MODEL_CASES = {
    "ocean_flat": (lambda: (_jax_ocean(False), _port_ocean(False)),
                   (1200.0, 1200.0, 1200.0)),
    "ocean_ridge": (lambda: (_jax_ocean(True), _port_ocean(True)),
                    (1200.0, 1200.0, 1200.0)),
}
for _case in ("implicit_tuple_forcing",
              "ri_based_convective_adjustment_teos10", "keps_columns",
              "split_rk3_keps_columns", "implicit_pcg_ridge",
              "implicit_pcg_rectilinear", "explicit_periodic_x"):
    MODEL_CASES[_case] = ((lambda c: lambda: (_simple_model(c, True),
                                              _simple_model(c, False)))(
        _case), (600.0, 600.0, 600.0))
# this case's free surface is cfl=0.7 across Δt 1200, 1200, 2400: 5
# substeps, then 6 (two JAX compiled steps, two host-side counts)
MODEL_CASES[CFL_CASE] = (MODEL_CASES[CFL_CASE][0], (1200.0, 1200.0, 2400.0))


def _compare(jm, tm, tol):
    for name in tuple(tm.prognostic_names) + ("w",):
        a = np.asarray(jm.field(name).interior)
        b = tm.field(name).interior.numpy()
        assert a.shape == b.shape, name
        assert _rel(b, a) <= tol, (name, _rel(b, a))


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_against_jax(case):
    """3 quasi-AB2 steps against the JAX model (its XLA path): u, v, the
    tracers, η and w within 1e-10 relative to max|JAX|."""
    make, dts = MODEL_CASES[case]
    jm, tm = make()
    assert not tm.uses_kernel
    for dt in dts:
        jm.time_step(dt)
        tm.time_step(dt)
    assert tm.iteration == 3
    if case in ("implicit_pcg_ridge", "implicit_pcg_rectilinear"):
        assert tm._ifs_method == "PreconditionedConjugateGradient"
    if case == CFL_CASE:
        assert [round(2 / tm.free_surface.settings(dt)[0]) for dt in dts] \
            == [5, 5, 6]
    if case == "ocean_ridge":
        solid = torch.as_tensor(tm.grid.solid_ccc)
        for name in ("T", "S", "e"):
            assert (tm.state["fields"][name][solid] == 0).all()
    _compare(jm, tm, 1e-10)


def test_ocean_catke_windstress_golden():
    """tests/test_regression.py's ocean_catke_windstress golden in the port
    (chip_smoke.ocean_catke_windstress_model) at 1e-9 relative to
    max|golden|."""
    model, dt, steps = chip_smoke.ocean_catke_windstress_model(F64, "cpu")
    for _ in range(steps):
        model.time_step(dt)
    path = os.path.join(DATA, "regression_ocean_catke_windstress.npz")
    with np.load(path) as ref:
        for name in ref.files:
            got = model.field(name).interior.numpy()
            assert got.shape == ref[name].shape, name
            assert _rel(got, ref[name]) < 1e-9, name


def test_float32_step_stays_float32():
    """One float32 step of the ocean row with the ridge: the depths, masks
    and column geometry are held in float32, so every diffusivity, tendency,
    field and the barotropic state stay float32 and finite."""
    m = _port_ocean(True, 600.0, dtype=torch.float32)
    fields = m._fill_all(dict(m.state["fields"]))
    w = m._w_from_continuity(fields["u"], fields["v"])
    G, aux = m._compute_tendencies(fields, w, 0.0)
    for key, t in list(G.items()) + list(aux.items()):
        assert t.dtype == torch.float32, key
    for dt in (1200.0, 1200.0):
        m.time_step(dt)
    state = m.state
    tensors = (list(state["fields"].items()) + list(state["Gm"].items())
               + list(state["barotropic"].items()) + [("w", state["w"])])
    for key, t in tensors:
        assert t.dtype == torch.float32, key
        assert torch.isfinite(t).all(), key


def test_nonhydrostatic_catke_against_jax():
    """The NonhydrostaticModel runs CATKE as an ordinary tracer closure, as
    JAX does (its implicit damping of e and the clip in the implicit
    solve): 3 quasi-AB2 steps at 8³ within 1e-10 of the JAX model."""
    from oceananigans_tpu.models import NonhydrostaticModel as JNH
    n = (8, 8, 8)
    built = []
    for J in (True, False):
        lib = jo if J else ot
        g = lib.RectilinearGrid(size=n, extent=(100.0, 100.0, 50.0),
                                **(dict(dtype=np.float64) if J else
                                   dict(dtype=F64, device="cpu")))
        m = (JNH if J else ot.NonhydrostaticModel)(
            g, advection=lib.Centered(2), buoyancy=lib.BuoyancyTracer(),
            closure=(JCATKE if J else TCATKE)(),
            timestepper="QuasiAdamsBashforth2")
        m.set(b=lambda x, y, z: 1e-4 * z + 0 * x,
              u=0.01 * np.random.default_rng(0).standard_normal(n), e=1e-5)
        built.append(m)
    jm, tm = built
    for _ in range(3):
        jm.time_step(1.0)
        tm.time_step(1.0)
    for name in ("u", "v", "w", "b", "e"):
        assert _rel(tm.field(name).interior.numpy(),
                    np.asarray(jm.field(name).interior)) <= 1e-10, name


def test_nonhydrostatic_immersed_raises():
    """The NonhydrostaticModel on an ImmersedBoundaryGrid (since item 11c)
    takes the immersed conjugate-gradient solver and steps as JAX's model
    does (3 steps at their default solver tolerance: 1e-6 of the velocity
    scale); the hydrostatic model's fused tendency still raises when asked
    for on one."""
    from oceananigans_tpu.models import NonhydrostaticModel as JNH
    spec = dict(size=(8, 8, 8), extent=(1.0, 1.0, 1.0), halo=(3, 8, 3))
    g = ot.RectilinearGrid(dtype=F64, device="cpu", **spec)
    ig = TIBG(g, TGFB(-0.8))
    tm = ot.NonhydrostaticModel(ig, advection=ot.Centered(2))
    jm = JNH(grid=JIBG(jo.RectilinearGrid(dtype=np.float64, **spec),
                       JGFB(-0.8)), advection=ja_Centered(2))
    u = 0.1 * np.random.default_rng(15).standard_normal((8, 8, 8))
    jm.set(u=u)
    tm.set(u=u)
    for _ in range(3):
        jm.time_step(1e-2)
        tm.time_step(1e-2)
    scale = np.abs(np.asarray(jm.field("u").interior)).max()
    for name in "uvw":
        assert np.abs(tm.field(name).interior.numpy() - np.asarray(
            jm.field(name).interior)).max() <= 1e-6 * scale, name
    lg = TIBG(_grids()[1], TGFB(_ridge))
    with pytest.raises(NotImplementedError, match="ImmersedBoundaryGrid"):
        HydrostaticFreeSurfaceModel(
            lg, free_surface=ot.SplitExplicitFreeSurface(substeps=5),
            tracers=("T",), fused_tendencies=True)
    assert not HydrostaticFreeSurfaceModel(
        lg, free_surface=ot.SplitExplicitFreeSurface(substeps=5),
        tracers=("T",)).uses_kernel
