"""The global ocean in the port against the JAX package, on the CPU in
float64: shell and tripolar grids, stretched coordinates, the tripolar fold
and the polar caps in the fill, and the hydrostatic model on them.

The JAX grids take no dtype here (``TripolarGrid`` has none), so a fixture
sets and restores ``defaults.FloatType = jnp.float64``; the port's grids
take ``dtype=torch.float64, device="cpu"``. Inputs come from numpy seeds.

- Grids: every metric at every staggering and ``nodes2d_padded`` at every
  horizontal staggering, 1e-12 relative to the metric's largest value, for
  an ``OrthogonalSphericalShellGrid`` from lat-lon corners, a
  ``RotatedLatitudeLongitudeGrid``, ``TripolarGrid((24, 12, 4))`` (stretched
  z) and ``TripolarGrid((8, 4))`` (the seam column); the faces of the four
  stretchings, 1e-14; ``rotation_angle_ccc`` equal on the interior and
  wrapped across the periodic seam where JAX extends the edge.
- Stretched advection: the nonuniform ENO coefficients and optimal weights,
  and one WENO(5) tracer tendency on a stretched-z lat-lon grid, 1e-12.
- Fills, bit for bit against JAX ``fill_halo_regions`` and
  ``fill_halo_axes``: the fold at every location with H = 1 to 4 (3-D, and
  the 2-D η, U and V); the polar caps at every location (given the same
  zonal means: JAX reduces in XLA, whose summation order differs, so the
  means alone agree to 1e-15 relative). The kernel's evaluator
  (``tests/test_torch_halo_fill.py``) equals ``fill_halos_plain`` bit for
  bit on the same cases.
- ``HydrostaticFreeSurfaceModel`` over 3 steps, 1e-10 relative to each
  field's max|JAX| (u, v, the tracers, η, w): (a) the tripolar model of
  ``tests/test_tripolar.py``; (b) the global row's physics
  (``chip_smoke.global_model``) at 24x12x6: an immersed tripolar grid with
  an array bottom and stretched z, WENO vector-invariant momentum, WENO(5)
  T and S, CATKE, spherical Coriolis, cfl = 0.7; (c) the pole-to-pole model
  of ``tests/test_polar_bc.py``; (d) the rotated-pole model of
  ``tests/test_ossg_time_stepping.py``; (e) a stretched-z lat-lon grid with
  WENO(5) tracers and CATKE; and a JAX checkpoint of (b) restored into the
  port and continued.
- ``set(u=1.0, v=0.0)`` on a tripolar grid: the extrinsic velocities
  rotated, filled with the −1 fold and interpolated, as in JAX.
- What the port does differently, pinned: callables of the horizontal
  coordinates (``set``, ``GridFittedBottom``) see the true 2-D nodes where
  JAX passes the centre lines.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
import oceananigans_tpu as jo
import oceananigans_tpu.buoyancy as jb
from oceananigans_tpu.advection import WENO as JWENO, div_Uc as j_div_Uc
from oceananigans_tpu.advection import reconstruction as jrec
from oceananigans_tpu.advection.vector_invariant import (
    VectorInvariant as JVI, WENOVectorInvariant as JWVI)
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFBC, FluxBoundaryCondition as JFlux,
    fill_halo_regions as j_fill, regularize_field_boundary_conditions as j_reg)
from oceananigans_tpu.boundary_conditions import fill_halos as jfh
from oceananigans_tpu.closures import ScalarDiffusivity as JSD
from oceananigans_tpu.closures.catke import CATKEVerticalDiffusivity as JCATKE
from oceananigans_tpu.coriolis import HydrostaticSphericalCoriolis as JHSC
from oceananigans_tpu.defaults import defaults as jdefaults
from oceananigans_tpu.grids import (
    OrthogonalSphericalShellGrid as JOSSG,
    RotatedLatitudeLongitudeGrid as JRotated, TripolarGrid as JTripolar)
from oceananigans_tpu.grids import orthogonal_spherical_shell as jossg
from oceananigans_tpu.grids import stretching as jst
from oceananigans_tpu.immersed import (GridFittedBottom as JGFB,
                                       ImmersedBoundaryGrid as JIBG)
from oceananigans_tpu.models.free_surfaces import (
    SplitExplicitFreeSurface as JSplit)
from oceananigans_tpu.models.hydrostatic import (
    HydrostaticFreeSurfaceModel as JModel)
from oceananigans_tpu.simulation import checkpointer as jcp
from oceananigans_tpu.simulation.simulation import Simulation as JSimulation
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.advection import reconstruction as trec
from oceananigans_tpu_torch.advection.fluxes import div_Uc as t_div_Uc
from oceananigans_tpu_torch.boundary_conditions import (
    fill_all_halo_regions, fill_surface_halo_regions,
    regularize_field_boundary_conditions as t_reg)
from oceananigans_tpu_torch.closures import CATKEVerticalDiffusivity
from oceananigans_tpu_torch.grids import (
    OrthogonalSphericalShellGrid, RotatedLatitudeLongitudeGrid, TripolarGrid)
from oceananigans_tpu_torch.grids import orthogonal_spherical_shell as tossg
from oceananigans_tpu_torch.grids import stretching as tst
from oceananigans_tpu_torch.immersed import (GridFittedBottom,
                                             ImmersedBoundaryGrid)
from oceananigans_tpu_torch.kernels import halo_fill as hf
from oceananigans_tpu_torch.simulation import checkpointer as tcp
from test_torch_halo_fill import evaluate

torch.set_num_threads(1)

F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
R = 6.371e6
LOCS = {"ccc": ("c", "c", "c"), "fcc": ("f", "c", "c"),
        "cfc": ("c", "f", "c"), "ccf": ("c", "c", "f")}
ALL_LOCS = [(a, b, c) for a in "cf" for b in "cf" for c in "cf"]
METRICS = ("dx", "dy", "dz", "Ax", "Ay", "Az", "V")
MODEL_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def jax_float64():
    """The JAX grids' default float type: TripolarGrid takes no dtype."""
    saved = jdefaults.FloatType
    jdefaults.FloatType = jnp.float64
    yield
    jdefaults.FloatType = saved


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _numpy(m):
    return m.numpy() if isinstance(m, torch.Tensor) else np.asarray(m)


# -- grids ---------------------------------------------------------------------------

def _corners():
    L, P = np.meshgrid(np.linspace(0, 40, 9), np.linspace(-20, 20, 9),
                       indexing="ij")
    return L, P


def _grid_pair(name):
    if name == "ossg":
        L, P = _corners()
        return JOSSG(L, P, radius=R), OrthogonalSphericalShellGrid(
            L, P, radius=R, **CPU)
    if name == "rotated":
        kw = dict(size=(16, 16, 4), longitude=(-10, 10), latitude=(-10, 10),
                  z=(-100, 0), north_pole=(0.0, 0.0))
        return JRotated(**kw), RotatedLatitudeLongitudeGrid(**kw, **CPU)
    if name == "tripolar":
        return (JTripolar((24, 12, 4),
                          z=jst.ExponentialDiscretization(4, -1000, 0)),
                TripolarGrid((24, 12, 4),
                             z=tst.ExponentialDiscretization(4, -1000, 0),
                             **CPU))
    return JTripolar((8, 4)), TripolarGrid((8, 4), **CPU)


GRIDS = ("ossg", "rotated", "tripolar", "seam")


@pytest.mark.parametrize("metric", METRICS + ("nodes",))
@pytest.mark.parametrize("name", GRIDS)
def test_grid_metrics(name, metric):
    """Every metric at the eight staggerings, and the true (λ, φ) nodes at
    the four horizontal ones, against JAX: 1e-12 relative."""
    jg, tg = _grid_pair(name)
    assert tg.padded_shape == jg.padded_shape and tg.H == jg.H
    if metric == "nodes":
        for loc in [("c", "c"), ("f", "c"), ("c", "f"), ("f", "f")]:
            for a, b in zip(jg.nodes2d_padded(loc), tg.nodes2d_padded(loc)):
                assert _rel(b, a) <= 1e-12, loc
            for a, b in zip(jg.nodes2d(loc), tg.nodes2d(loc)):
                assert np.array_equal(a, b), loc
        return
    for loc in ALL_LOCS:
        want = np.broadcast_to(np.asarray(getattr(jg, metric)(loc)),
                               jg.padded_shape)
        got = np.broadcast_to(_numpy(getattr(tg, metric)(loc)),
                              tg.padded_shape)
        assert _rel(got, want) <= 1e-12, loc


STRETCHINGS = {
    "exponential_right": lambda m: m.ExponentialDiscretization(
        16, -4000.0, 0.0, scale=1000.0),
    "exponential_left": lambda m: m.ExponentialDiscretization(
        12, 0.0, 1.0, scale=0.3, bias="left"),
    "power_law": lambda m: m.ReferenceToStretchedDiscretization(
        extent=1000.0, constant_spacing=10.0, constant_spacing_extent=50.0,
        stretching=m.PowerLawStretching(1.1)),
    "linear": lambda m: m.ReferenceToStretchedDiscretization(
        extent=500.0, bias="left", constant_spacing=5.0,
        stretching=m.LinearStretching(0.05), maximum_spacing=40.0),
}


@pytest.mark.parametrize("name", sorted(STRETCHINGS))
def test_stretching_faces(name):
    """The four stretchings' faces against JAX: 1e-14 relative; a grid
    built on them keeps those faces."""
    want = STRETCHINGS[name](jst)
    got = STRETCHINGS[name](tst)
    assert len(got) == len(want)
    assert _rel(got.faces, want.faces) <= 1e-14
    g = ot.RectilinearGrid(size=(4, 4, len(got)), x=(0, 1), y=(0, 1),
                           z=got, **CPU)
    assert np.array_equal(g.znodes("f"), got.faces)
    assert g.stretched_axes == (2,) and not g.all_regular


def test_rotation_angle_wraps_the_seam():
    """rotation_angle_ccc on a tripolar grid: the interior equals JAX's
    (1e-14); across the periodic seam the port wraps the x halo columns,
    where JAX extends the edge column, so the two differ there."""
    jg, tg = _grid_pair("tripolar")
    h, n = tg.H[0], tg.N[0]
    for want, got in zip(jossg.rotation_angle_ccc(jg),
                         tossg.rotation_angle_ccc(tg)):
        ints = tg.interior_slices[:2]
        assert _rel(got[ints], want[ints]) <= 1e-14
        assert np.array_equal(got[:h], got[n:n + h])
        assert np.array_equal(got[h + n:], got[h:2 * h])
        assert np.array_equal(want[:h], np.repeat(want[h:h + 1], h, 0))
        assert not np.array_equal(got[:h], want[:h])


# -- stretched advection -------------------------------------------------------------

@pytest.mark.parametrize("beta", [0, 1])
def test_nonuniform_coefficients(beta):
    """The per-slot ENO coefficients of every WENO(5) stencil and the
    optimal weights on a stretched axis against JAX: 1e-12."""
    faces = tst.ExponentialDiscretization(10, -1000.0, 0.0, scale=300.0)
    xF = np.concatenate([faces.faces[0] - np.arange(3, 0, -1) * 10.0,
                         faces.faces, faces.faces[-1] + np.arange(1, 5)])
    npad = len(xF) - 1
    for s in range(3):
        want = jrec.eno_coefficients_nonuniform(xF, 3, s, beta, npad)
        got = trec.eno_coefficients_nonuniform(xF, 3, s, beta, npad)
        for a, b in zip(want, got):
            assert _rel(b, a) <= 1e-12, s
    for a, b in zip(jrec.optimal_weights_nonuniform(xF, 3, beta, npad),
                    trec.optimal_weights_nonuniform(xF, 3, beta, npad)):
        assert _rel(b, a) <= 1e-12


def test_stretched_weno_tracer_tendency():
    """∇·(𝐯T) with WENO(5) on a lat-lon grid with an exponentially stretched
    z (the nonuniform coefficients along z, both biases) against JAX, on
    seeded padded fields: 1e-12 on the interior."""
    kw = dict(size=(10, 8, 8), longitude=(0, 60), latitude=(15, 75),
              halo=(3, 3, 3))
    jg = jo.LatitudeLongitudeGrid(
        z=jst.ExponentialDiscretization(8, -1800.0, 0.0, scale=500.0),
        dtype=np.float64, **kw)
    tg = ot.LatitudeLongitudeGrid(
        z=tst.ExponentialDiscretization(8, -1800.0, 0.0, scale=500.0),
        **CPU, **kw)
    assert tg.stretched_axes == (2,)
    rng = np.random.default_rng(11)
    u, v, w = (0.1 * rng.standard_normal(tg.padded_shape) for _ in range(3))
    T = 10 + rng.standard_normal(tg.padded_shape)
    want = np.asarray(j_div_Uc(jg, JWENO(5, smoothness_dtype=jnp.float64),
                               *(jnp.asarray(a) for a in (u, v, w, T))))
    got = t_div_Uc(tg, ot.WENO(5, smoothness_dtype=F64),
                   *(torch.as_tensor(a) for a in (u, v, w, T))).numpy()
    ints = tg.interior_slices
    assert _rel(got[ints], want[ints]) <= 1e-12
    # the stretched coefficients act: the uniform ones give another answer
    uniform = ot.LatitudeLongitudeGrid(z=(-1800.0, 0.0), **CPU, **kw)
    other = t_div_Uc(uniform, ot.WENO(5, smoothness_dtype=F64),
                     *(torch.as_tensor(a) for a in (u, v, w, T))).numpy()
    assert _rel(other[ints], want[ints]) > 1e-6


# -- fills ---------------------------------------------------------------------------

def _tripolar_pair(H, Nz=6):
    kw = dict(size=(16, 10, Nz), z=(-100.0, 0.0), halo=(H, H, H))
    return JTripolar(**kw), TripolarGrid(**kw, **CPU)


@pytest.mark.parametrize("loc", list(LOCS))
@pytest.mark.parametrize("H", [1, 2, 3, 4])
def test_fold_against_jax(H, loc):
    """The tripolar fold with the grid's own conditions (sign −1 for u and
    v, +1 otherwise), every axis, against JAX fill_halo_regions bit for
    bit; the evaluator of the kernel's maps equals the plain fill bit for
    bit."""
    jg, tg = _tripolar_pair(H)
    lc = LOCS[loc]
    jb_, tb = j_reg(None, jg, lc), t_reg(None, tg, lc)
    assert tb.north.classification == "zipper"
    assert tb.north.condition == (-1.0 if "f" in lc[:2] else 1.0)
    a = np.random.default_rng(H).standard_normal(tg.padded_shape)
    want = np.asarray(j_fill(jnp.asarray(a), jg, lc, jb_))
    got = fill_all_halo_regions([torch.as_tensor(a.copy())], tg,
                                [(lc, tb)])[0]
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(evaluate(tg, torch.as_tensor(a), lc, tb), got)


@pytest.mark.parametrize("H", [1, 2, 3, 4])
def test_fold_surfaces_against_jax(H):
    """η, U and V (2-D, x and y only, with the model's conditions) against
    JAX fill_halo_axes(..., (0, 1)) bit for bit; the evaluator equals the
    plain fill bit for bit."""
    jg, tg = _tripolar_pair(H)
    rng = np.random.default_rng(10 + H)
    for lc in (LOCS["ccc"], LOCS["fcc"], LOCS["cfc"]):
        a = rng.standard_normal(tg.padded_shape[:2] + (1,))
        want = np.asarray(jfh.fill_halo_axes(
            jnp.asarray(a), jg, lc, j_reg(None, jg, lc), 0.0, (0, 1)))
        tb = t_reg(None, tg, lc)
        got = fill_surface_halo_regions([torch.as_tensor(a.copy())], tg,
                                        [(lc, tb)])[0]
        assert np.array_equal(got.numpy(), want), lc
        assert torch.equal(evaluate(tg, torch.as_tensor(a), lc, tb, z=False),
                           got), lc


def _jax_row_mean(grid, a, is_left):
    """The JAX fill's zonal mean of the boundary row, as a tensor."""
    Hx, Nx = grid.H[0], grid.N[0]
    row = grid.H[1] if is_left else grid.H[1] + grid.N[1] - 1
    m = jnp.mean(jnp.asarray(a.numpy())[:, row:row + 1][Hx:Hx + Nx], axis=0,
                 keepdims=True)
    return torch.as_tensor(np.array(m))


@pytest.mark.parametrize("loc", list(LOCS))
def test_polar_caps_against_jax(loc, monkeypatch):
    """A pole-to-pole lat-lon grid: centre fields take Value and v the
    pinned Open cap with the zonal mean of the boundary row. Given JAX's
    means the fill equals JAX fill_halo_regions bit for bit; the port's
    means agree with JAX's to 1e-15 relative; the evaluator equals the plain
    fill bit for bit."""
    kw = dict(size=(16, 8, 6), longitude=(0, 360), latitude=(-90, 90),
              z=(-100.0, 0.0))
    jg = jo.LatitudeLongitudeGrid(dtype=np.float64, **kw)
    tg = ot.LatitudeLongitudeGrid(**kw, **CPU)
    assert tg.polar_south and tg.polar_north
    lc = LOCS[loc]
    tb = t_reg(None, tg, lc)
    assert tb.south.classification == ("open" if lc[1] == "f" else "value")
    a = np.random.default_rng(5).standard_normal(tg.padded_shape)
    ta = torch.as_tensor(a)
    for side in (True, False):
        assert _rel(hf.polar_row_mean(tg, ta, side),
                    _jax_row_mean(tg, ta, side)) <= 1e-15
    plain = fill_all_halo_regions([ta.clone()], tg, [(lc, tb)])[0]
    assert torch.equal(evaluate(tg, ta, lc, tb), plain)
    monkeypatch.setattr(hf, "polar_row_mean", _jax_row_mean)
    want = np.asarray(j_fill(jnp.asarray(a), jg, lc, j_reg(None, jg, lc)))
    got = fill_all_halo_regions([ta.clone()], tg, [(lc, tb)])[0].numpy()
    assert np.array_equal(got, want)


# -- the hydrostatic model -----------------------------------------------------------

POLE_FACE_TOL = 1e-6


def _compare(jm, tm, tol=MODEL_TOL):
    """Every field within ``tol`` of JAX relative to its max|JAX|. On a
    pole-touching grid the south pole face of v (its first interior row)
    carries no transport (its Ay is zero to roundoff) and its vorticity
    divides by a polar-cap area some 1e-13 of a normal cell's, which
    amplifies the two packages' 1e-16 roundoff differences: that row is
    held to ``POLE_FACE_TOL``."""
    for name in tuple(tm.prognostic_names) + ("w",):
        want = np.asarray(jm.field(name).interior)
        got = tm.field(name).interior.numpy()
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        if name == "v" and getattr(tm.grid, "polar_south", False):
            scale = np.abs(want).max()
            assert np.abs(got[:, 0] - want[:, 0]).max() \
                <= POLE_FACE_TOL * scale
            got, want = got[:, 1:], want[:, 1:]
        assert _rel(got, want) <= tol, (name, _rel(got, want))


def _tripolar_models():
    """(a) tests/test_tripolar.py's model; η as an array of the true centre
    longitudes (a callable of λ sees the centre lines in JAX)."""
    kw = dict(size=(24, 12, 4), z=(-1000.0, 0.0))
    jg, tg = JTripolar(**kw), TripolarGrid(**kw, **CPU)
    jm = JModel(grid=jg, free_surface=JSplit(substeps=20),
                buoyancy=jb.BuoyancyTracer())
    tm = ot.HydrostaticFreeSurfaceModel(
        tg, free_surface=ot.SplitExplicitFreeSurface(substeps=20),
        buoyancy=ot.BuoyancyTracer())
    lam, _ = tg.nodes2d(("c", "c"))
    eta = 0.01 * np.sin(np.deg2rad(lam))[:, :, None]
    jm.set(b=lambda lam, phi, z: 1e-6 * z, eta=jnp.asarray(eta))
    tm.set(b=lambda lam, phi, z: 1e-6 * z, eta=eta)
    return jm, tm, 120.0


def _jax_global(N=(24, 12, 6)):
    """chip_smoke.global_model on the JAX side."""
    g = JTripolar(N, southernmost_latitude=-80.0, north_poles_latitude=55.0,
                  first_pole_longitude=70.0,
                  z=jst.ExponentialDiscretization(N[2], -4000.0, 0.0,
                                                  scale=1000.0))
    lam, phi = g.nodes2d(("c", "c"))
    m = JModel(
        JIBG(g, JGFB(chip_smoke.global_bottom(lam, phi))),
        momentum_advection=JWVI(smoothness_dtype=jnp.float64),
        tracer_advection=JWENO(5, smoothness_dtype=jnp.float64),
        coriolis=JHSC(), free_surface=JSplit(cfl=0.7),
        buoyancy=jb.SeawaterBuoyancy(
            equation_of_state=jb.LinearEquationOfState()),
        closure=JCATKE(), tracers=("T", "S"),
        boundary_conditions={"u": JFBC(
            top=JFlux(chip_smoke.global_wind_stress),
            bottom=JFlux(chip_smoke.ocean_drag,
                         field_dependencies=("u", "v")))})
    T, u, v = chip_smoke.global_initial_state(lam, phi, g.znodes("c"), 0)
    m.set(T=T, S=35.0, u=u, v=v)
    return m


def _port_global(N=(24, 12, 6)):
    return chip_smoke.global_model(N, F64, "cpu", smoothness=F64)


def _polar_models():
    """(c) tests/test_polar_bc.py's pole-to-pole model."""
    kw = dict(size=(16, 8, 3), longitude=(0, 360), latitude=(-90, 90),
              z=(-100.0, 0.0))
    jm = JModel(grid=jo.LatitudeLongitudeGrid(dtype=np.float64, **kw),
                coriolis=JHSC(), tracers=("T",))
    tm = ot.HydrostaticFreeSurfaceModel(ot.LatitudeLongitudeGrid(**kw, **CPU),
                                        coriolis=ot.HydrostaticSphericalCoriolis(),
                                        tracers=("T",))
    u = 0.01 * np.random.default_rng(42).standard_normal((16, 8, 3))
    for m in (jm, tm):
        m.set(u=u, T=lambda lam, phi, z: 10 + 0.01 * np.cos(np.deg2rad(phi)))
    assert not tm.uses_kernel
    return jm, tm, 60.0


def _rotated_models():
    """(d) tests/test_ossg_time_stepping.py's rotated-pole model, with its
    intrinsic Gaussian bump and noise."""
    n = 24
    kw = dict(size=(n, n, 2), longitude=(-60, 60), latitude=(-60, 60),
              z=(-1000.0, 0.0), north_pole=(90.0, 45.0))
    jm = JModel(grid=JRotated(**kw), free_surface=JSplit(substeps=20),
                momentum_advection=JVI(), closure=JSD(nu=2e-4, kappa=2e-4))
    tm = ot.HydrostaticFreeSurfaceModel(
        RotatedLatitudeLongitudeGrid(**kw, **CPU),
        free_surface=ot.SplitExplicitFreeSurface(substeps=20),
        momentum_advection=ot.VectorInvariant(),
        closure=ot.ScalarDiffusivity(nu=2e-4, kappa=2e-4))
    i = np.arange(n) - (n - 1) / 2
    X, Y = np.meshgrid(i, i, indexing="ij")
    eta = np.exp(-(X ** 2 + Y ** 2) / (2 * (n / 8) ** 2))[:, :, None]
    rng = np.random.default_rng(123)
    u, v = (1e-6 * rng.standard_normal((n, n, 2)) for _ in range(2))
    jm.set(eta=jnp.asarray(eta), u=jnp.asarray(u), v=jnp.asarray(v),
           intrinsic_velocities=True)
    tm.set(eta=eta, u=u, v=v, intrinsic_velocities=True)
    return jm, tm, 180.0


def _stretched_models():
    """(e) a lat-lon strip with an exponentially stretched z, WENO(5)
    tracers, CATKE, linear SeawaterBuoyancy, cfl = 0.7, the top stress and
    the quadratic drag."""
    kw = dict(size=(12, 10, 8), longitude=(0, 60), latitude=(15, 75))

    def z(m):
        return m.ExponentialDiscretization(8, -1800.0, 0.0, scale=600.0)

    u = 0.05 * np.random.default_rng(0).standard_normal(kw["size"])
    T = lambda lam, phi, z: 12 + 8e-3 * z + 2 * np.cos(np.radians(phi))  # noqa: E731
    jm = JModel(jo.LatitudeLongitudeGrid(z=z(jst), dtype=np.float64, **kw),
                momentum_advection=JVI(),
                tracer_advection=JWENO(5, smoothness_dtype=jnp.float64),
                coriolis=JHSC(), free_surface=JSplit(cfl=0.7),
                buoyancy=jb.SeawaterBuoyancy(
                    equation_of_state=jb.LinearEquationOfState()),
                closure=JCATKE(), tracers=("T", "S"),
                boundary_conditions={"u": JFBC(
                    top=JFlux(-1e-4), bottom=JFlux(
                        chip_smoke.ocean_drag,
                        field_dependencies=("u", "v")))})
    tm = ot.HydrostaticFreeSurfaceModel(
        ot.LatitudeLongitudeGrid(z=z(tst), **CPU, **kw),
        momentum_advection=ot.VectorInvariant(),
        tracer_advection=ot.WENO(5, smoothness_dtype=F64),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=ot.SplitExplicitFreeSurface(cfl=0.7),
        buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=ot.LinearEquationOfState()),
        closure=CATKEVerticalDiffusivity(), tracers=("T", "S"),
        boundary_conditions={"u": ot.FieldBoundaryConditions(
            top=ot.FluxBoundaryCondition(-1e-4),
            bottom=ot.FluxBoundaryCondition(
                chip_smoke.ocean_drag, field_dependencies=("u", "v")))})
    for m in (jm, tm):
        m.set(T=T, S=35.0, u=u)
    return jm, tm, 600.0


MODELS = {"a_tripolar": _tripolar_models, "b_global_row": None,
          "c_pole_to_pole": _polar_models, "d_rotated_pole": _rotated_models,
          "e_stretched_catke": _stretched_models}


@pytest.fixture(scope="module")
def global_jax_run(tmp_path_factory):
    """Model (b) on the JAX side: a checkpoint at iteration 2 and the
    fields after 3 and 5 steps, shared by the tests of (b)."""
    jm = _jax_global()
    dt = chip_smoke.GLOBAL_DT
    out = {}
    for _ in range(2):
        jm.time_step(dt)
    cp = jcp.Checkpointer(jm, dir=str(tmp_path_factory.mktemp("jax_cp")))
    cp.write(JSimulation(jm, dt=dt))
    out["checkpoint"] = cp.path(2)
    for it in (3, 4, 5):
        jm.time_step(dt)
        out[it] = {name: np.asarray(jm.field(name).interior)
                   for name in ("u", "v", "T", "S", "e", "eta", "w")}
    out["time"] = jm.time
    return out


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_against_jax(case, request):
    """3 quasi-AB2 steps against the JAX model: every field within 1e-10
    relative to its max|JAX|. The port takes the plain tendency (the fused
    kernel covers neither shell grids nor polar caps nor stretched axes)."""
    if case == "b_global_row":
        run = request.getfixturevalue("global_jax_run")
        tm = _port_global()
        for _ in range(3):
            tm.time_step(chip_smoke.GLOBAL_DT)
        assert isinstance(tm.grid.underlying_grid, TripolarGrid)
        assert tm.grid.stretched_axes == tuple(range(3))
        assert not tm.uses_kernel
        for name, want in run[3].items():
            got = tm.field(name).interior.numpy()
            assert np.isfinite(got).all(), name
            assert _rel(got, want) <= MODEL_TOL, (name, _rel(got, want))
        return
    jm, tm, dt = MODELS[case]()
    for _ in range(3):
        jm.time_step(dt)
        tm.time_step(dt)
    assert tm.iteration == 3
    _compare(jm, tm)


def test_global_checkpoint_from_jax(global_jax_run):
    """A checkpoint the JAX model (b) wrote at iteration 2 (its y halo
    rounded up to 8) restores into the port, which then takes the JAX
    model's steps 3 to 5: 1e-10 relative; the clocks agree."""
    tm = _port_global()
    tcp.restore(tm, global_jax_run["checkpoint"])
    assert tm.iteration == 2
    for _ in range(3):
        tm.time_step(chip_smoke.GLOBAL_DT)
    assert abs(tm.time - global_jax_run["time"]) <= 1e-14 * tm.time
    for name, want in global_jax_run[5].items():
        got = tm.field(name).interior.numpy()
        assert _rel(got, want) <= MODEL_TOL, (name, _rel(got, want))


def test_extrinsic_set_on_tripolar():
    """set(u=1.0, v=0.0) on tests/test_tripolar.py's grid: geographic
    east/north at the centres, rotated, filled with the −1 fold and
    interpolated to the faces, against JAX (1e-14 relative, halos
    included); a uniform eastward flow stays near (1, 0) away from the
    poles."""
    kw = dict(size=(24, 12, 2), z=(-500.0, 0.0))
    jm = JModel(grid=JTripolar(**kw), free_surface=JSplit(substeps=8))
    tm = ot.HydrostaticFreeSurfaceModel(
        TripolarGrid(**kw, **CPU),
        free_surface=ot.SplitExplicitFreeSurface(substeps=8))
    jm.set(u=1.0, v=0.0)
    tm.set(u=1.0, v=0.0)
    for name in ("u", "v"):
        want = np.asarray(jm.state["fields"][name])
        got = tm.state["fields"][name].numpy()
        extra = (want.shape[1] - got.shape[1]) // 2     # JAX's Hy is 8
        want = want[:, extra:extra + got.shape[1]]
        assert got.shape == want.shape, name
        assert _rel(got, want) <= 1e-14, name
    from oceananigans_tpu_torch.operators.operators import ix_c, iy_c
    g = tm.grid
    ue, vn = tossg.rotate_to_geographic(g, ix_c(g, tm.state["fields"]["u"]),
                                        iy_c(g, tm.state["fields"]["v"]))
    (sx, sy) = g.interior_slices[:2]
    ii = (slice(sx.start + 1, sx.stop - 1), slice(sy.start, sy.stop - 1))
    _, phi = g.nodes2d(("c", "c"))
    mask = torch.as_tensor(phi[1:g.N[0] - 1, :g.N[1] - 1] < 45.0)[..., None]
    assert (ue[ii] - 1.0).abs()[mask.expand_as(ue[ii])].max() < 5e-2
    assert vn[ii].abs()[mask.expand_as(vn[ii])].max() < 5e-2


def test_callables_see_true_nodes():
    """The port evaluates callables of (λ, φ) on a shell grid at the true
    2-D nodes: set() and GridFittedBottom (the JAX package passes the
    centre lines there, so its fields and masks differ)."""
    kw = dict(size=(24, 12, 4), z=(-1000.0, 0.0))
    jg, tg = JTripolar(**kw), TripolarGrid(**kw, **CPU)
    lam, phi = tg.nodes2d(("c", "c"))
    ints = tg.interior_slices
    tm = ot.HydrostaticFreeSurfaceModel(
        tg, free_surface=ot.SplitExplicitFreeSurface(substeps=4),
        tracers=("T",))
    tm.set(T=lambda lam, phi, z: phi + 0 * z)
    got = tm.state["fields"]["T"][ints].numpy()
    assert _rel(got, np.broadcast_to(phi[:, :, None], got.shape)) <= 1e-14
    jm = JModel(grid=jg, free_surface=JSplit(substeps=4), tracers=("T",))
    jm.set(T=lambda lam, phi, z: phi + 0 * z)
    jT = np.asarray(jm.state["fields"]["T"])[ints]
    assert _rel(jT, got) > 1e-3

    def bottom(lam, phi):
        return np.where(np.asarray(phi) > 60.0, 0.0, -1000.0)

    port = ImmersedBoundaryGrid(tg, GridFittedBottom(bottom))
    ref = JIBG(jg, JGFB(bottom))
    want = np.broadcast_to((phi > 60.0)[:, :, None], (24, 12, 4))
    assert np.array_equal(port.solid_ccc[ints], want)
    assert not np.array_equal(np.asarray(ref.solid_ccc)[ints], want)


def test_nonhydrostatic_refuses_stretched():
    """The nonhydrostatic model on an ExponentialDiscretization z, which it
    refused until item 11b: it takes the Fourier-tridiagonal pressure solve
    along z, as the JAX model does, and matches the JAX model over 3 RK3
    steps from the same state (1e-10 relative, float64)."""
    from oceananigans_tpu.models import NonhydrostaticModel as JNH
    from oceananigans_tpu_torch.models import state_from_jax
    from oceananigans_tpu_torch.solvers import FourierTridiagonalPoissonSolver
    size = (8, 8, 8)
    jg = jo.RectilinearGrid(size=size, x=(0, 1), y=(0, 1),
                            z=jst.ExponentialDiscretization(8, -1.0, 0.0),
                            dtype=np.float64)
    g = ot.RectilinearGrid(size=size, x=(0, 1), y=(0, 1),
                           z=tst.ExponentialDiscretization(8, -1.0, 0.0),
                           **CPU)
    jm = JNH(grid=jg, advection=JWENO(5, smoothness_dtype=jnp.float64),
             tracers=("c",))
    rng = np.random.default_rng(5)
    jm.set(u=0.1 * rng.standard_normal(size), v=0.1 * rng.standard_normal(size),
           c=rng.standard_normal(size))
    start = {k: ({n: np.asarray(a) for n, a in v.items()}
                 if isinstance(v, dict) else np.asarray(v))
             for k, v in jm.state.items()}
    tm = ot.NonhydrostaticModel(g, advection=ot.WENO(
        5, smoothness_dtype=F64), tracers=("c",))
    assert isinstance(tm.pressure_solver, FourierTridiagonalPoissonSolver)
    assert tm.pressure_solver.s == 2
    state_from_jax(start, tm)
    for _ in range(3):
        jm.time_step(1e-2)
        tm.time_step(1e-2)
    for name in ("u", "v", "w", "c", "p"):
        want = np.asarray(jm.field(name).interior)
        got = tm.field(name).interior.numpy()
        assert _rel(got, want) <= MODEL_TOL, name


def test_writers_carry_2d_coordinates(tmp_path):
    """On a tripolar grid the NetCDF writer and the FieldWriter carry the
    2-D λ and φ of each output's staggering (the true nodes, degrees); x
    and y carry indices."""
    from scipy.io import netcdf_file
    g = TripolarGrid((16, 10, 4), z=(-100.0, 0.0), **CPU)
    m = ot.HydrostaticFreeSurfaceModel(
        g, free_surface=ot.SplitExplicitFreeSurface(substeps=4),
        tracers=("T",))
    m.set(T=lambda lam, phi, z: phi + 0 * z)
    sim = ot.Simulation(m, dt=60.0, stop_iteration=1)
    sim.add_output_writer(ot.FieldWriter(m, {"T": "T"}, str(tmp_path / "fw"),
                                         schedule=ot.IterationInterval(1)))
    sim.add_output_writer(ot.NetCDFWriter(m, {"u": "u", "v": "v", "T": "T"},
                                          str(tmp_path / "a.nc"),
                                          schedule=ot.IterationInterval(1)))
    sim.run()
    h = g.H[:2]
    with np.load(tmp_path / "fw" / "grid_nodes.npz") as z:
        for lx, ly, ny in (("c", "c", 10), ("f", "c", 10), ("c", "f", 11)):
            lam, phi = m.grid.nodes2d_padded((lx, ly))
            sl = (slice(h[0], h[0] + 16), slice(h[1], h[1] + ny))
            assert np.array_equal(z[f"lambda_{lx}{ly}"], lam[sl])
            assert np.array_equal(z[f"phi_{lx}{ly}"], phi[sl])
    f = netcdf_file(str(tmp_path / "a.nc"), "r", mmap=False)
    try:
        v = f.variables
        assert v["phi_cc"].dimensions == v["T"].dimensions[1:3]
        assert v["lambda_cf"].data.shape == (16, 11)
        assert np.array_equal(v["x_c16"].data, np.arange(16.0))
        assert _rel(v["T"].data[-1][..., 0], v["phi_cc"].data) <= 1e-6
    finally:
        f.close()
