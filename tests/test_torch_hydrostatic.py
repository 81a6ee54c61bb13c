"""The port's hydrostatic path against the JAX package's, in float64 on the
CPU: bounded x/y halo fills, the vector-invariant terms, the split-explicit
substep loop, the fused tendency's plain version against the JAX Pallas
kernel in interpret mode (unpacked and packed), the model over 3 steps
against the JAX XLA path and over 2 against the JAX fused packed path, the
``hydrostatic_turbulence`` golden and ``state_from_jax``.

Inputs come from ``np.random.default_rng`` and go to both sides as numpy.
Bounds, relative to max|reference| unless stated:
- fills: exact (both sides copy, or form the same extrapolation in the same
  order);
- each vector-invariant term, the tendency and the substep loop: 1e-13
  (the same float64 stencils; a few sums associate differently);
- the model over 2-3 steps and ``state_from_jax``: 1e-10 (roundoff through
  three steps and 30 substeps; z is scanned by a cumsum where JAX contracts
  with a triangular matrix);
- the golden: 1e-9, its own bound.
Every WENO takes float64 smoothness on both sides.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
from oceananigans_tpu.advection import Centered as JCentered
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.advection.vector_invariant import \
    VectorInvariant as JVI
from oceananigans_tpu.advection.vector_invariant import \
    WENOVectorInvariant as JWVI
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFBC, FluxBoundaryCondition as JFlux,
    GradientBoundaryCondition as JGrad, ValueBoundaryCondition as JValue,
    apply_flux_bcs as j_apply_flux_bcs, fill_halo_regions as j_fill,
    regularize_field_boundary_conditions as j_reg)
from oceananigans_tpu.boundary_conditions.fill_halos import \
    fill_halo_axes as j_fill_axes
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoyancy
from oceananigans_tpu.coriolis import HydrostaticSphericalCoriolis as JHSC
from oceananigans_tpu.fields import set_on_padded as j_set
from oceananigans_tpu.kernels.fused_vector_invariant import (
    build_fused_hydrostatic_tendency, build_fused_hydrostatic_tendency_packed)
from oceananigans_tpu.models.free_surfaces import \
    SplitExplicitFreeSurface as JSplit
from oceananigans_tpu.models.hydrostatic import \
    HydrostaticFreeSurfaceModel as JModel
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.biogeochemistry  # noqa: F401
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.boundary_conditions import (
    apply_flux_bcs_padded, fill_halo_regions, fill_surface_halo_regions,
    regularize_field_boundary_conditions)
from oceananigans_tpu_torch.fields import set_on_padded
from oceananigans_tpu_torch.kernels.fused_vector_invariant import (
    TABLE_SIZE, coefficient_table, fused_vi_tendency_plain, kept_slices,
    vi_config)
from oceananigans_tpu_torch.models.hydrostatic import (
    HydrostaticFreeSurfaceModel, state_from_jax)

torch.set_num_threads(1)

F64 = torch.float64
N = (16, 12, 8)
LAT = (15, 75)
Z = (-1800.0, 0.0)
BOUNDED_X = (0.0, 60.0)
PERIODIC_X = (0.0, 360.0)
# a stretched longitude, which the fused VI kernel refuses as JAX's does
STRETCHED_X = tuple(60.0 * np.linspace(0, 1, N[0] + 1) ** 1.1)
LOCS = {"u": ("f", "c", "c"), "v": ("c", "f", "c"), "w": ("c", "c", "f"),
        "T": ("c", "c", "c"), "ph": ("c", "c", "c")}
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _grids(lon=BOUNDED_X, jhalo=(6, 8, 6), thalo=(6, 6, 6), size=N):
    """The same lat-lon grid on both sides; the JAX halo may be wider (its
    model rounds Hy to 8)."""
    jg = jo.LatitudeLongitudeGrid(size=size, longitude=lon, latitude=LAT,
                                  z=Z, halo=jhalo, dtype=np.float64)
    tg = ot.LatitudeLongitudeGrid(size=size, longitude=lon, latitude=LAT,
                                  z=Z, halo=thalo, dtype=F64, device="cpu")
    return jg, tg


def _crop(arr, shape):
    """A JAX padded array cut to a port padded shape (centered)."""
    arr = np.asarray(arr)
    sl = tuple(slice((a - b) // 2, (a - b) // 2 + b)
               for a, b in zip(arr.shape, shape))
    return arr[sl]


def _fields(jg, tg, seed, names=LOCS):
    """Random interiors set and halo-filled on both sides."""
    rng = np.random.default_rng(seed)
    J, T = {}, {}
    for n in names:
        loc = LOCS[n]
        shape = [N[a] + (1 if loc[a] == "f" and jg.topology[a] == "bounded"
                         else 0) for a in range(3)]
        arr = rng.standard_normal(shape) * (0.1 if n in "uvw" else 1.0)
        J[n] = j_fill(j_set(jg, loc, jnp.asarray(arr)), jg, loc,
                      j_reg(None, jg, loc))
        T[n] = fill_halo_regions(set_on_padded(tg, loc, arr), tg, loc,
                                 regularize_field_boundary_conditions(
                                     None, tg, loc))
    return J, T


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300)


# -- bounded x/y fills ---------------------------------------------------------

def _bcs(kind, J, grid):
    """Conditions of one kind on every bounded side (x sides only on a
    bounded x)."""
    mk = {"value": (JValue, ot.ValueBoundaryCondition),
          "gradient": (JGrad, ot.GradientBoundaryCondition),
          "flux": (JFlux, ot.FluxBoundaryCondition)}
    if kind == "default":
        return None
    bc = mk[kind][0 if J else 1]
    sides = dict(south=bc(0.1), north=bc(0.5), bottom=bc(-0.4), top=bc(0.25))
    if grid.topology[0] == "bounded":
        sides.update(west=bc(0.3), east=bc(-0.2))
    return (JFBC if J else ot.FieldBoundaryConditions)(**sides)


FILL_CASES = [("T", k) for k in ("default", "value", "gradient", "flux")] \
    + [(n, k) for n in ("u", "v") for k in ("default", "value")]


@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X],
                         ids=["bounded_x", "periodic_x"])
@pytest.mark.parametrize("name,kind", FILL_CASES,
                         ids=[f"{n}-{k}" for n, k in FILL_CASES])
def test_fills(name, kind, lon):
    """Center and wall-normal face fields under default, Value, Gradient and
    Flux conditions, x → y → z, against JAX fill_halo_regions: exact."""
    jg, tg = _grids(lon, jhalo=(3, 3, 3), thalo=(3, 3, 3))
    loc = LOCS[name]
    rng = np.random.default_rng(11)
    a = rng.standard_normal(tg.padded_shape)
    jb = j_reg(_bcs(kind, True, tg), jg, loc)
    tb = regularize_field_boundary_conditions(_bcs(kind, False, tg), tg, loc)
    want = np.asarray(j_fill(jnp.asarray(a), jg, loc, jb))
    got = fill_halo_regions(torch.as_tensor(a.copy()), tg, loc, tb).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X],
                         ids=["bounded_x", "periodic_x"])
def test_surface_fills(lon):
    """2-D (Nx + 2Hx, Ny + 2Hy, 1) fills of η, U and V along x and y only,
    against JAX fill_halo_axes(..., (0, 1)): exact."""
    jg, tg = _grids(lon, jhalo=(3, 3, 3), thalo=(3, 3, 3))
    rng = np.random.default_rng(12)
    for loc in (LOCS["T"], LOCS["u"], LOCS["v"]):
        a = rng.standard_normal(tg.padded_shape[:2] + (1,))
        want = np.asarray(j_fill_axes(jnp.asarray(a), jg, loc,
                                      j_reg(None, jg, loc), 0.0, (0, 1)))
        got = fill_surface_halo_regions(
            [torch.as_tensor(a.copy())], tg,
            [(loc, regularize_field_boundary_conditions(None, tg, loc))])[0]
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrap_kernel_axis_flags():
    """The wrap's plain version wraps only the periodic axes: on a
    periodic-x, bounded-y grid the y halos of the interior x are left as
    they were, and the x halos copy the wrapped columns over the full y."""
    _, tg = _grids(PERIODIC_X, thalo=(3, 3, 3))
    a = torch.randn(tg.padded_shape, dtype=F64)
    b = a.clone()
    K.periodic_halo_fill_plain(tg, [b])
    assert torch.equal(b[3:-3, :3], a[3:-3, :3])
    assert torch.equal(b[3:-3, -3:], a[3:-3, -3:])
    assert torch.equal(b[:3], a[16:19]) and torch.equal(b[-3:], a[3:6])


def test_flux_bcs_padded():
    """Scalar Flux conditions on every bounded side of a padded tendency,
    against the JAX apply_flux_bcs: 1e-14 relative."""
    jg, tg = _grids(BOUNDED_X, jhalo=(3, 3, 3), thalo=(3, 3, 3))
    for name in ("T", "u"):
        loc = LOCS[name]
        G = np.random.default_rng(13).standard_normal(tg.padded_shape)
        want = j_apply_flux_bcs(jnp.asarray(G), jg, loc,
                                j_reg(_bcs("flux", True, tg), jg, loc))
        got = apply_flux_bcs_padded(
            torch.as_tensor(G.copy()), tg, loc,
            regularize_field_boundary_conditions(_bcs("flux", False, tg), tg,
                                                 loc))
        assert _rel(got.numpy(), want) < 1e-14


# -- vector-invariant terms ------------------------------------------------------

VIS = {
    "weno_vi": (lambda: JWVI(smoothness_dtype=jnp.float64),
                lambda: ot.WENOVectorInvariant(smoothness_dtype=F64)),
    "vector_invariant": (JVI, ot.VectorInvariant),
}


@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X],
                         ids=["bounded_x", "periodic_x"])
@pytest.mark.parametrize("vi", sorted(VIS))
def test_vector_invariant_terms(vi, lon):
    """The vorticity flux, the Bernoulli head, the vertical term and their
    sum of WENOVectorInvariant() and VectorInvariant(): 1e-13."""
    jg, tg = _grids(lon, jhalo=(6, 6, 6))
    J, T = _fields(jg, tg, 5, ("u", "v", "w"))
    jv, tv = VIS[vi][0](), VIS[vi][1]()
    su, sv, _ = kept_slices(tg)
    for term, args in (("_horizontal", ("u", "v")),
                       ("_bernoulli", ("u", "v")),
                       ("_vertical", ("u", "v", "w")),
                       ("momentum_tendencies", ("u", "v", "w"))):
        ja = getattr(jv, term)(jg, *[J[a] for a in args])
        ta = getattr(tv, term)(tg, *[T[a] for a in args])
        for j, t, sl in zip(ja, ta, (su, sv)):
            assert _rel(t.numpy()[sl], np.asarray(j)[sl]) < 1e-13, term


# -- the fused tendency ------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_plain_against_pallas(packed):
    """The plain version against the JAX Pallas kernel in interpret mode:
    the hydro_row configuration (WENOVectorInvariant, spherical Coriolis,
    WENO(5) tracer) with ph on the bounded-x grid (unpacked), WENO-5 VI with
    Centered(2) on the periodic-x grid (packed); 1e-10."""
    lon = PERIODIC_X if packed else BOUNDED_X
    jg, tg = _grids(lon)
    J, T = _fields(jg, tg, 3)
    if packed:
        jv = JWVI(order=5, smoothness_dtype=jnp.float64)
        tv = ot.WENOVectorInvariant(order=5, smoothness_dtype=F64)
        js, ts = JCentered(2), ot.Centered(2)
    else:
        jv, tv = VIS["weno_vi"][0](), VIS["weno_vi"][1]()
        js = JWENO(5, smoothness_dtype=jnp.float64)
        ts = ot.WENO(5, smoothness_dtype=F64)
    build = (build_fused_hydrostatic_tendency_packed if packed
             else build_fused_hydrostatic_tendency)
    fn = build(jg, jv, js, ("T",), coriolis=JHSC(), with_ph=True)
    jGu, jGv, jGc = fn(J["u"], J["v"], J["w"], {"T": J["T"]}, J["ph"])
    Gu, Gv, Gc = fused_vi_tendency_plain(
        tg, tv, ts, ("T",), ot.HydrostaticSphericalCoriolis(), T["u"], T["v"],
        T["w"], {"T": T["T"]}, T["ph"])
    for j, t, sl in zip((jGu, jGv, jGc["T"]), (Gu, Gv, Gc["T"]),
                        kept_slices(tg)):
        assert _rel(t.numpy()[sl], _crop(j, tg.padded_shape)[sl]) < 1e-10


def test_wrapper_on_cpu_is_plain():
    """On CPU tensors the wrapper is its plain version (no launch), and the
    kept regions are the only nonzero slots."""
    _, tg = _grids(BOUNDED_X, thalo=(6, 6, 6))
    _, T = _fields(_grids()[0], tg, 4)
    args = (tg, ot.VectorInvariant(), ot.Centered(2), ("T",),
            ot.HydrostaticSphericalCoriolis(), T["u"], T["v"], T["w"],
            {"T": T["T"]}, T["ph"])
    before = K.fused_vi_tendency.launches
    got = K.fused_vi_tendency(*args)
    want = fused_vi_tendency_plain(*args)
    assert K.fused_vi_tendency.launches == before
    for g, w, sl in zip((got[0], got[1], got[2]["T"]),
                        (want[0], want[1], want[2]["T"]), kept_slices(tg)):
        assert torch.equal(g, w)
        outside = g.clone()
        outside[sl] = 0
        assert not outside.any()
    # the boundary-face rows of u (bounded x) and v (bounded y) are written
    assert got[0][6 + 16].abs().max() > 0 and got[1][:, 6 + 12].abs().max() > 0


def test_eligibility():
    """vi_config takes the configurations the JAX kernel takes on this grid
    (any scheme, tracer count, upwinding and Coriolis) and raises, naming
    the ROADMAP item, for what stays uncovered: an immersed grid, a shell
    grid, a stretched x, and WENO schemes that differ in smoothness dtype
    (the kernel is built for one)."""
    from oceananigans_tpu_torch.immersed import (GridFittedBottom,
                                                 ImmersedBoundaryGrid)
    _, tg = _grids()
    sd = dict(smoothness_dtype=F64)
    hsc = ot.HydrostaticSphericalCoriolis()
    assert vi_config(tg, ot.WENOVectorInvariant(), ot.Centered(2), 1,
                     hsc)["cor"] == 2
    assert vi_config(tg, ot.WENOVectorInvariant(order=5, **sd),
                     ot.WENO(5, **sd), 8,
                     ot.FPlane(f=1e-4))["sites"]["vort_y"] == (2, 3)
    assert vi_config(tg, ot.VectorInvariant(), ot.Centered(2), 0,
                     None)["vort"] == 0
    covered = [
        (ot.VectorInvariant(), ot.Centered(4), 1, hsc),
        (ot.VectorInvariant(), ot.Centered(2), 9, hsc),
        (ot.WENOVectorInvariant(upwinding="cross_and_self"), ot.Centered(2),
         1, hsc),
        (ot.VectorInvariant(), ot.Centered(2), 1,
         ot.BetaPlane(f0=1e-4, beta=1e-11)),
    ]
    for args in covered:
        vi_config(tg, *args)
    uncovered = [
        (ImmersedBoundaryGrid(tg, GridFittedBottom(
            lambda lam, phi: -1000.0 + 0 * lam)), ot.VectorInvariant(),
         ot.Centered(2), 1, hsc),
        (ot.TripolarGrid((24, 12, 4), z=(-100.0, 0.0), dtype=F64,
                         device="cpu"), ot.VectorInvariant(), ot.Centered(2),
         1, hsc),
        (ot.LatitudeLongitudeGrid(size=N, longitude=np.linspace(0, 60, 17)
                                  ** 1.05, latitude=LAT, z=Z, dtype=F64,
                                  device="cpu"), ot.VectorInvariant(),
         ot.Centered(2), 1, hsc),
        (tg, ot.WENOVectorInvariant(), ot.WENO(5, **sd), 1, hsc),
    ]
    for args in uncovered:
        with pytest.raises(NotImplementedError, match="item 13"):
            vi_config(*args)
    # the multi-dimensional stencil builds, and the kernel takes it
    md = vi_config(tg, ot.WENOVectorInvariant(multi_dimensional_stencil=True,
                                              **sd), ot.Centered(2), 1, hsc)
    assert md["md"] == 1
    table = coefficient_table()
    assert table.shape == (TABLE_SIZE,) and table[-2:].tolist() == [1e-8,
                                                                    1e12]


# -- the split-explicit substep loop ------------------------------------------------

@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X],
                         ids=["bounded_x", "periodic_x"])
def test_split_explicit_substep(lon):
    """SplitExplicitFreeSurface.substep with its fill of η, U and V every
    substep (a bounded y; one call for the three) against JAX: 1e-13."""
    jg, tg = _grids(lon, jhalo=(4, 4, 4), thalo=(4, 4, 4))
    rng = np.random.default_rng(21)
    shape = tg.padded_shape[:2] + (1,)
    eta, U, V, GU, GV = (rng.standard_normal(shape) * s
                         for s in (0.1, 10.0, 10.0, 1e-3, 1e-3))
    jfs, tfs = JSplit(substeps=12), ot.SplitExplicitFreeSurface(substeps=12)

    def jfill(loc):
        return lambda a: j_fill_axes(a, jg, loc, j_reg(None, jg, loc), 0.0,
                                     (0, 1))

    tlocs_bcs = [(LOCS[n], regularize_field_boundary_conditions(
        None, tg, LOCS[n])) for n in ("T", "u", "v")]

    def tfill(eta, U, V):
        return tuple(fill_surface_halo_regions([eta, U, V], tg, tlocs_bcs))

    want = jfs.substep(jg, 1800.0, 1800.0, *(jnp.asarray(a) for a in
                                             (eta, U, V, GU, GV)),
                       jnp.asarray(120.0), jfill(LOCS["T"]),
                       jfill(LOCS["u"]), jfill(LOCS["v"]))
    got = tfs.substep(tg, 1800.0, 1800.0, *(torch.as_tensor(a.copy()) for a
                                            in (eta, U, V, GU, GV)),
                      120.0, tfill)
    ints = (slice(4, 4 + N[0]), slice(4, 4 + N[1]))
    for j, t in zip(want, got):
        assert _rel(t.numpy()[ints], np.asarray(j)[ints]) < 1e-13


# -- the model ---------------------------------------------------------------------

def _models(case, fused_tendencies="auto"):
    """hydro_row at 16x12x8 (WENOVectorInvariant, spherical Coriolis, 30
    substeps, T), periodic-x with BuoyancyTracer (WENO-5 VI), and
    VectorInvariant(); the same initial state on both sides."""
    lon = PERIODIC_X if case == "periodic_buoyancy" else BOUNDED_X
    built = []
    for J in (True, False):
        kw = (dict(dtype=np.float64) if J
              else dict(dtype=F64, device="cpu"))
        g = (jo if J else ot).LatitudeLongitudeGrid(
            size=N, longitude=lon, latitude=LAT, z=Z, **kw)
        sd = dict(smoothness_dtype=jnp.float64 if J else F64)
        split = JSplit if J else ot.SplitExplicitFreeSurface
        hsc = (JHSC if J else ot.HydrostaticSphericalCoriolis)()
        M = JModel if J else HydrostaticFreeSurfaceModel
        extra = {} if J else dict(fused_tendencies=fused_tendencies)
        if case == "hydro_row":
            m = M(g, momentum_advection=(JWVI if J else
                                         ot.WENOVectorInvariant)(**sd),
                  coriolis=hsc, free_surface=split(substeps=30),
                  tracers=("T",), **extra)
        elif case == "periodic_buoyancy":
            m = M(g, momentum_advection=(JWVI if J else
                                         ot.WENOVectorInvariant)(order=5,
                                                                 **sd),
                  coriolis=hsc, free_surface=split(substeps=10),
                  buoyancy=(JBuoyancy if J else ot.BuoyancyTracer)(),
                  **extra)
        else:
            m = M(g, momentum_advection=(JVI if J else ot.VectorInvariant)(),
                  coriolis=hsc, free_surface=split(substeps=10),
                  tracers=("T",), **extra)
        built.append(m)
    rng = np.random.default_rng(0)
    u0, v0 = (0.05 * rng.standard_normal(N) for _ in range(2))
    if case == "periodic_buoyancy":
        ic = dict(b=lambda lam, phi, z: 1e-3 * z
                  + 1e-2 * np.cos(np.deg2rad(lam)) * (phi - 45))
    else:
        ic = dict(T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi)
    for m in built:
        m.set(u=u0, v=v0, **ic)
    return built


def _compare(jm, tm, tol):
    for name in tuple(tm.prognostic_names) + ("w",):
        a = np.asarray(jm.field(name).interior)
        b = tm.field(name).interior.numpy()
        assert a.shape == b.shape, name
        assert _rel(b, a) <= tol, name


@pytest.mark.parametrize("case", ["hydro_row", "periodic_buoyancy",
                                  "vector_invariant"])
def test_model_against_jax(case):
    """3 quasi-AB2 steps of Δt = 120 s (an Euler step, then AB2) against the
    JAX model's XLA path (fused_tendencies=False): u, v, tracers, η, w within
    1e-10."""
    jm, tm = _models(case)
    assert not tm.uses_kernel
    for _ in range(3):
        jm.time_step(120.0)
        tm.time_step(120.0)
    assert tm.iteration == 3
    _compare(jm, tm, 1e-10)


def test_model_against_jax_fused_packed():
    """2 steps against the JAX model on its fused path
    (fused_tendencies="packed": the Pallas kernel in interpret mode), for
    VectorInvariant(), the cheapest configuration to interpret: 1e-10."""
    jm, tm = _models("vector_invariant")
    jfused = JModel(jm.grid, momentum_advection=JVI(), coriolis=JHSC(),
                    free_surface=JSplit(substeps=10), tracers=("T",),
                    fused_tendencies="packed")
    assert jfused._fused_vi is not None
    jfused.state = jm.state
    for _ in range(2):
        jfused.time_step(120.0)
        tm.time_step(120.0)
    _compare(jfused, tm, 1e-10)


def test_state_from_jax():
    """A JAX state after one step, loaded into a fresh port model, steps on
    as the JAX model does (the AB2 memory Gm, the barotropic U/V and the
    boundary faces come along), also across a change of Δt (the Euler
    restart): 1e-10."""
    jm, _ = _models("vector_invariant")
    jm.time_step(120.0)
    _, fresh = _models("vector_invariant")
    state = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else np.asarray(v))
             for k, v in jm.state.items()}
    state_from_jax(state, fresh)
    _compare(jm, fresh, 0.0)
    for dt in (120.0, 60.0):
        jm.time_step(dt)
        fresh.time_step(dt)
    assert fresh.iteration == 3
    _compare(jm, fresh, 1e-10)


def hydrostatic_turbulence_model(device="cpu", fused_tendencies="auto"):
    """tests/test_regression.py's hydrostatic_turbulence golden in the port:
    a 16x12x4 lat-lon strip, VectorInvariant(), spherical Coriolis,
    SplitExplicitFreeSurface(substeps=8), T; Δt = 600 s, 10 steps."""
    grid = ot.LatitudeLongitudeGrid(size=(16, 12, 4), longitude=(0, 60),
                                    latitude=(15, 75), z=(-90.0, 0.0),
                                    dtype=F64, device=device)
    model = HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.VectorInvariant(),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=ot.SplitExplicitFreeSurface(substeps=8), tracers=("T",),
        fused_tendencies=fused_tendencies)
    rng = np.random.default_rng(7)
    model.set(u=0.1 * rng.standard_normal((16, 12, 4)),
              v=0.1 * rng.standard_normal((16, 12, 4)),
              T=lambda lam, phi, z: 10 + 5e-3 * z)
    return model, 600.0, 10


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_hydrostatic_turbulence_golden(fused):
    """The golden at 1e-9 relative to max|golden|, through the plain path
    and through the fused path's (CPU) plain version."""
    model, dt, steps = hydrostatic_turbulence_model(fused_tendencies=fused)
    for _ in range(steps):
        model.time_step(dt)
    with np.load(os.path.join(DATA,
                              "regression_hydrostatic_turbulence.npz")) as ref:
        for name in ref.files:
            got = model.field(name).interior.numpy()
            assert got.shape == ref[name].shape, name
            assert _rel(got, ref[name]) < 1e-9, name


# -- what is not ported ---------------------------------------------------------

UNPORTED = {
    # a closure that is not one of the port's
    "closure": (dict(closure=object()), "not one of the closures"),
    # taken since item 15 (tests/test_torch_long_tail.py holds them against
    # JAX): the model carries them and steps
    "biogeochemistry": (dict(
        biogeochemistry=ot.biogeochemistry.SimpleBiogeochemistry(
            tracers=("P",))), None),
    "auxiliary_fields": (dict(auxiliary_fields={"a": None}), None),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_options_raise(case):
    _, tg = _grids()
    kw, match = UNPORTED[case]
    if callable(kw):
        # an option whose object raises when it is built
        with pytest.raises(NotImplementedError, match=match):
            HydrostaticFreeSurfaceModel(tg, **kw())
        return
    kw = dict(kw)
    kw.setdefault("free_surface", ot.SplitExplicitFreeSurface(substeps=5))
    if kw["free_surface"] is None:
        del kw["free_surface"]
    if match is None:
        if case == "auxiliary_fields":
            kw["auxiliary_fields"] = {"a": ot.CenterField(tg).set(1.0)}
        m = HydrostaticFreeSurfaceModel(tg, **kw)
        m.time_step(60.0)
        assert case != "biogeochemistry" or "P" in m.tracer_names
        assert case != "auxiliary_fields" or m.field("a") is \
            kw["auxiliary_fields"]["a"]
        return
    with pytest.raises(NotImplementedError, match=match):
        HydrostaticFreeSurfaceModel(tg, **kw)


def test_unported_free_surfaces_and_grids_raise():
    """The polar and stretched lat-lon grids build (polar caps, stretched
    coordinates); the fused VI kernel refuses the polar caps and a stretched
    longitude, as JAX's does, so "auto" takes the plain tendency there, and
    takes stretched latitudes and levels; ImplicitFreeSurface and
    FixedTimeStepSize (the cfl= substepping) build."""
    from oceananigans_tpu_torch.models.free_surfaces import (
        FixedTimeStepSize, ImplicitFreeSurface)
    assert ImplicitFreeSurface().solver_method == "Default"
    assert FixedTimeStepSize(0.7).dt_barotropic is None
    fs = ot.SplitExplicitFreeSurface(cfl=0.7)
    assert isinstance(fs.substepping, FixedTimeStepSize)
    polar = ot.LatitudeLongitudeGrid(size=(8, 8, 4), longitude=(0, 60),
                                     latitude=(-90, 90), z=Z, device="cpu")
    assert polar.polar_south and polar.polar_north
    stretched = ot.LatitudeLongitudeGrid(size=(8, 8, 4), longitude=(0, 60),
                                         latitude=LAT,
                                         z=np.linspace(-100, 0, 5) ** 3
                                         / 1e4, device="cpu")
    assert stretched.stretched_axes == (2,)
    stretched_x = ot.LatitudeLongitudeGrid(
        size=(8, 8, 4), longitude=np.linspace(0, 60, 9) ** 1.05,
        latitude=LAT, z=Z, device="cpu")
    assert stretched_x.stretched_axes == (0,)
    for grid, why in ((polar, "polar"), (stretched_x, "stretched x")):
        with pytest.raises(NotImplementedError, match=why):
            vi_config(grid, ot.VectorInvariant(), ot.Centered(2), 1, None)
        m = ot.HydrostaticFreeSurfaceModel(grid, tracers=("T",))
        assert not m.uses_kernel
    assert vi_config(stretched, ot.VectorInvariant(), ot.Centered(2), 1,
                     None)["zs"]
    m = ot.HydrostaticFreeSurfaceModel(stretched, tracers=("T",))
    assert not m.uses_kernel      # "auto" on a CPU grid: the plain version


def test_fused_tendencies_switch():
    """True and "packed" take the fused tendency and raise for a
    configuration the kernel does not cover (a stretched longitude), on any
    device; "auto" (the default) never raises for coverage and, on a CPU
    grid, takes the plain version, as the JAX "auto" takes its XLA path;
    uses_kernel reports the choice (False on a CPU grid); False is the plain
    path."""
    _, tg = _grids()
    sx = ot.LatitudeLongitudeGrid(size=N, longitude=STRETCHED_X,
                                  latitude=LAT, z=Z, halo=(6, 6, 6),
                                  dtype=F64, device="cpu")
    fs = ot.SplitExplicitFreeSurface(substeps=5)
    for value in ("auto", True, "packed", False):
        m = HydrostaticFreeSurfaceModel(tg, free_surface=fs, tracers=("T",),
                                        tracer_advection=ot.Centered(4),
                                        fused_tendencies=value)
        assert not m.uses_kernel
    for value in (True, "packed"):
        with pytest.raises(NotImplementedError, match="fused VI kernel"):
            HydrostaticFreeSurfaceModel(sx, free_surface=fs, tracers=("T",),
                                        tracer_advection=ot.Centered(4),
                                        fused_tendencies=value)
    for value in ("auto", False):
        m = HydrostaticFreeSurfaceModel(sx, free_surface=fs, tracers=("T",),
                                        tracer_advection=ot.Centered(4),
                                        fused_tendencies=value)
        assert not m.uses_kernel
        m.set(T=lambda lam, phi, z: 12 + 2e-2 * phi)
        m.time_step(120.0)
        assert torch.isfinite(m.field("T").interior).all()


def test_auto_uncovered_against_jax():
    """A configuration the kernel does not cover (a stretched longitude,
    with Centered(4) tracer advection) under the default "auto" on both
    sides: 2 quasi-AB2 steps equal the JAX model's within 1e-10."""
    built = []
    for J in (True, False):
        kw = (dict(dtype=np.float64) if J
              else dict(dtype=F64, device="cpu"))
        g = (jo if J else ot).LatitudeLongitudeGrid(
            size=N, longitude=STRETCHED_X, latitude=LAT, z=Z, **kw)
        M = JModel if J else HydrostaticFreeSurfaceModel
        m = M(g, momentum_advection=(JVI if J else ot.VectorInvariant)(),
              tracer_advection=(JCentered if J else ot.Centered)(4),
              coriolis=(JHSC if J else ot.HydrostaticSphericalCoriolis)(),
              free_surface=(JSplit if J else ot.SplitExplicitFreeSurface)(
                  substeps=10), tracers=("T",))
        built.append(m)
    jm, tm = built
    assert not tm.uses_kernel
    with pytest.raises(NotImplementedError, match="stretched x"):
        vi_config(tm.grid, tm.momentum_advection, tm.tracer_advection, 1,
                  tm.coriolis)
    rng = np.random.default_rng(3)
    u0, v0 = (0.05 * rng.standard_normal(N) for _ in range(2))
    for m in built:
        m.set(u=u0, v=v0, T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi)
    for _ in range(2):
        jm.time_step(120.0)
        tm.time_step(120.0)
    _compare(jm, tm, 1e-10)


def test_default_free_surface_follows_jax():
    """With no free_surface the model takes the JAX default:
    SplitExplicitFreeSurface(cfl=0.7) on a lat-lon grid, ImplicitFreeSurface
    (by FFT) on a regular RectilinearGrid; 3 steps (Δt 120, 120 and 60 s:
    an Euler restart) equal the JAX model's within 1e-10 on each."""
    for grid in ("latlon", "rectilinear"):
        _default_free_surface_against_jax(grid)


def _default_free_surface_against_jax(grid):
    from oceananigans_tpu_torch.models.free_surfaces import (
        FixedTimeStepSize, ImplicitFreeSurface)
    built = []
    for J in (True, False):
        kw = (dict(dtype=np.float64) if J
              else dict(dtype=F64, device="cpu"))
        lib = jo if J else ot
        if grid == "latlon":
            g = lib.LatitudeLongitudeGrid(size=N, longitude=BOUNDED_X,
                                          latitude=LAT, z=Z, **kw)
            cor = (JHSC if J else ot.HydrostaticSphericalCoriolis)()
        else:
            g = lib.RectilinearGrid(size=N, extent=(1e6, 8e5, 1000.0),
                                    topology=("periodic", "bounded",
                                              "bounded"), **kw)
            cor = lib.FPlane(f=1e-4)
        M = JModel if J else HydrostaticFreeSurfaceModel
        built.append(M(g, coriolis=cor, tracers=("T",)))
    jm, tm = built
    if grid == "latlon":
        assert isinstance(tm.free_surface.substepping, FixedTimeStepSize)
        assert tm.free_surface.substepping.cfl == 0.7
    else:
        assert isinstance(tm.free_surface, ImplicitFreeSurface)
        assert tm._ifs_method == "FastFourierTransform"
    rng = np.random.default_rng(5)
    u0, v0 = (0.05 * rng.standard_normal(N) for _ in range(2))
    for m in built:
        m.set(u=u0, v=v0, T=lambda x, y, z: 12 + 8e-3 * z + 1e-6 * y)
    for dt in (120.0, 120.0, 60.0):
        jm.time_step(dt)
        tm.time_step(dt)
    _compare(jm, tm, 1e-10)
