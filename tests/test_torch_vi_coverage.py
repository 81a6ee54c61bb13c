"""The coverage of the fused hydrostatic tendency (#10) against the JAX
package, in float64 on the CPU: the port's plain vector-invariant tendency
(``fused_vi_tendency_plain``, which the CUDA kernel is held to on the card)
against the JAX Pallas kernel in interpret mode for each configuration class
the port's kernel took on with its coverage (stretched y and z, every
vector-invariant and tracer scheme, cross-upwinding, more tracers, every
Coriolis), the port's model with ``fused_tendencies=True`` on JAX's
stretched-z test grid against the JAX model's fused path, and the gate
(``vi_config``) and the launch plans of the new configurations.

Inputs come from ``np.random.default_rng`` and go to both sides as numpy.
The JAX grids take a y halo of 8 (the Mosaic alignment rule its kernel
keeps). Bounds, relative to max|JAX|: the tendency 1e-10 (the same float64
stencils; the kernel's phases sum in another order), the model over 3 steps
1e-10 (roundoff through three steps and the substeps). Every WENO takes
float64 smoothness on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
from oceananigans_tpu import coriolis as jcor
from oceananigans_tpu.advection import schemes as jsch
from oceananigans_tpu.advection import vector_invariant as jvi
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions as j_reg)
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoyancy
from oceananigans_tpu.fields import set_on_padded as j_set
from oceananigans_tpu.kernels.fused_vector_invariant import \
    build_fused_hydrostatic_tendency
from oceananigans_tpu.models.free_surfaces import \
    SplitExplicitFreeSurface as JSplit
from oceananigans_tpu.models.hydrostatic import \
    HydrostaticFreeSurfaceModel as JModel
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.advection.schemes import FluxFormAdvection
from oceananigans_tpu_torch.boundary_conditions import (
    fill_halo_regions, regularize_field_boundary_conditions)
from oceananigans_tpu_torch.fields import set_on_padded
from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
from oceananigans_tpu_torch.kernels.fused_advection import MAX_SMEM
from oceananigans_tpu_torch.models.hydrostatic import \
    HydrostaticFreeSurfaceModel

torch.set_num_threads(1)

F64 = torch.float64
N = (16, 12, 8)
LOCS = {"u": ("f", "c", "c"), "v": ("c", "f", "c"), "w": ("c", "c", "f"),
        "ph": ("c", "c", "c")}
# JAX's stretched-z test grid (tests/test_fused_vector_invariant.py:111)
JAX_Z = -500.0 * np.linspace(1, 0, 9) ** 1.5
LATITUDES = 15 + 60 * np.linspace(0, 1, N[1] + 1) ** 1.3
Y_FACES = 2.4e5 * np.linspace(0, 1, N[1] + 1) ** 1.4


def _pair(J, name, *args, **kw):
    """The JAX (J) or port object ``name`` of the scheme and Coriolis
    modules."""
    if J:
        for mod in (jsch, jvi, jcor):
            if hasattr(mod, name):
                return getattr(mod, name)(*args, **kw)
        raise AttributeError(name)
    return getattr(ot, name, None)(*args, **kw) if hasattr(ot, name) \
        else FluxFormAdvection(*args, **kw)


def _grid(J, kind, halo):
    """A float64 grid of size N on one side: ``kind`` names its stretched
    axes."""
    kw = dict(dtype=np.float64) if J else dict(dtype=F64, device="cpu")
    mod = jo if J else ot
    if kind.startswith("rect"):
        return mod.RectilinearGrid(
            size=N, x=(0.0, 4e5), y=tuple(Y_FACES), z=(-1800.0, 0.0),
            halo=halo, topology=("periodic", "bounded", "bounded"), **kw)
    z = {"latlon": (-1800.0, 0.0), "z": tuple(JAX_Z),
         "exp_z": mod.ExponentialDiscretization(N[2], -1800.0, 0.0,
                                                scale=450.0),
         "lat": (-1800.0, 0.0)}[kind]
    lat = tuple(LATITUDES) if kind == "lat" else (15, 75)
    return mod.LatitudeLongitudeGrid(size=N, longitude=(0.0, 60.0),
                                     latitude=lat, z=z, halo=halo, **kw)


def _fields(jg, tg, names, seed):
    """Random interiors set and halo-filled on both sides."""
    rng = np.random.default_rng(seed)
    J, T = {}, {}
    locs = dict(LOCS, **{n: ("c", "c", "c") for n in names})
    for n, loc in locs.items():
        shape = [N[a] + (1 if loc[a] == "f" and jg.topology[a] == "bounded"
                         else 0) for a in range(3)]
        arr = rng.standard_normal(shape) * (0.1 if n in "uvw" else 1.0)
        J[n] = j_fill(j_set(jg, loc, jnp.asarray(arr)), jg, loc,
                      j_reg(None, jg, loc))
        T[n] = fill_halo_regions(set_on_padded(tg, loc, arr), tg, loc,
                                 regularize_field_boundary_conditions(
                                     None, tg, loc))
    return J, T


def _crop(arr, shape):
    """A JAX padded array cut to a port padded shape (centered)."""
    arr = np.asarray(arr)
    sl = tuple(slice((a - b) // 2, (a - b) // 2 + b)
               for a, b in zip(arr.shape, shape))
    return arr[sl]


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300)


def _weno(J, order):
    return _pair(J, "WENO", order,
                 smoothness_dtype=jnp.float64 if J else F64)


def _wvi(J, **kw):
    return _pair(J, "WENOVectorInvariant",
                 smoothness_dtype=jnp.float64 if J else F64, **kw)


# each case: (grid kind, VI, tracer scheme, tracer count, Coriolis, with ph);
# the VI, scheme and Coriolis are made for a side J
CASES = {
    "stretched_z_weno_vi": (
        "z", lambda J: _wvi(J), lambda J: _weno(J, 5), 1,
        lambda J: _pair(J, "HydrostaticSphericalCoriolis"), True),
    "exponential_z_weno3_default_stencil_nontraditional": (
        "exp_z", lambda J: _wvi(J, order=3, vorticity_stencil="default"),
        lambda J: _weno(J, 7), 1,
        lambda J: _pair(J, "NonTraditionalBetaPlane", fz0=1e-4, beta=1e-11,
                        fy0=5e-5, gamma=-1e-11), False),
    "stretched_latitude_weno7_cross_and_self": (
        "lat", lambda J: _wvi(J, order=7, upwinding="cross_and_self"),
        lambda J: _pair(J, "UpwindBiased", 3), 2,
        lambda J: _pair(J, "HydrostaticSphericalCoriolis",
                        scheme="enstrophy_conserving"), True),
    "rectilinear_stretched_y_upwind_vi_beta_plane": (
        "rect", lambda J: _pair(J, "VectorInvariant",
                                vorticity_scheme=_pair(J, "UpwindBiased", 5),
                                vertical_advection_scheme=_pair(
                                    J, "UpwindBiased", 3)),
        lambda J: _pair(J, "Centered", 4), 1,
        lambda J: _pair(J, "BetaPlane", f0=1e-4, beta=1e-11), True),
    "mixed_schemes_cartesian_9_tracers": (
        "latlon", lambda J: _pair(
            J, "VectorInvariant", vorticity_scheme=_weno(J, 7),
            vertical_advection_scheme=_weno(J, 3),
            divergence_scheme=_pair(J, "UpwindBiased", 5),
            kinetic_energy_gradient_scheme=_weno(J, 9)),
        lambda J: _pair(J, "Centered", 2), 9,
        lambda J: _pair(J, "ConstantCartesianCoriolis", fx=1e-5, fy=2e-5,
                        fz=1e-4), False),
    "weno11_vi_weno9_tracers_fplane": (
        "latlon", lambda J: _wvi(J, order=11), lambda J: _weno(J, 9), 1,
        lambda J: _pair(J, "FPlane", f=1e-4), True),
    "stretched_z_weno11_tracers": (
        "z", lambda J: _wvi(J, order=5), lambda J: _weno(J, 11), 1,
        lambda J: None, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_against_pallas(case):
    """The port's plain tendency against the JAX Pallas kernel in interpret
    mode, each configuration class of the kernel's coverage: 1e-10."""
    kind, make_vi, make_ts, ntr, make_cor, with_ph = CASES[case]
    jg = _grid(True, kind, (7, 8, 7))
    tg = _grid(False, kind, (7, 7, 7))
    names = ("T",) if ntr == 1 else tuple(f"c{i}" for i in range(ntr))
    J, T = _fields(jg, tg, names, seed=len(case))
    cfg = fvi.vi_config(tg, make_vi(False), make_ts(False), ntr,
                        make_cor(False))
    assert cfg["ys"] == (kind in ("lat", "rect"))
    assert cfg["zs"] == (kind in ("z", "exp_z"))
    fn = build_fused_hydrostatic_tendency(jg, make_vi(True), make_ts(True),
                                          names, coriolis=make_cor(True),
                                          with_ph=with_ph)
    jG = fn(J["u"], J["v"], J["w"], {n: J[n] for n in names},
            J["ph"] if with_ph else None)
    tG = fvi.fused_vi_tendency_plain(
        tg, make_vi(False), make_ts(False), names, make_cor(False), T["u"],
        T["v"], T["w"], {n: T[n] for n in names},
        T["ph"] if with_ph else None)
    su, sv, sc = fvi.kept_slices(tg)
    pairs = [(jG[0], tG[0], su), (jG[1], tG[1], sv)] + \
        [(jG[2][n], tG[2][n], sc) for n in names]
    for j, t, sl in pairs:
        assert _rel(t.numpy()[sl], _crop(j, tg.padded_shape)[sl]) < 1e-10


def test_stretched_z_model_fused_against_jax():
    """JAX's stretched-z lat-lon test model (tests/test_fused_vector_
    invariant.py:109-120: WENOVectorInvariant(order=5), spherical Coriolis,
    BuoyancyTracer, SplitExplicitFreeSurface(substeps=6)) with
    fused_tendencies=True on both sides (the port's plain version on the
    CPU, the JAX Pallas kernel in interpret mode), 3 steps of Δt = 30 s:
    u, v, b, η and w within 1e-10."""
    built = []
    for J in (True, False):
        kw = dict(dtype=np.float64) if J else dict(dtype=F64, device="cpu")
        mod = jo if J else ot
        g = mod.LatitudeLongitudeGrid(size=(16, 8, 8), longitude=(0, 20),
                                      latitude=(-30, 10), z=JAX_Z, **kw)
        m = (JModel if J else HydrostaticFreeSurfaceModel)(
            g, momentum_advection=_wvi(J, order=5),
            coriolis=_pair(J, "HydrostaticSphericalCoriolis"),
            buoyancy=(JBuoyancy if J else ot.BuoyancyTracer)(),
            free_surface=(JSplit if J else ot.SplitExplicitFreeSurface)(
                substeps=6),
            fused_tendencies=True)
        built.append(m)
    jm, tm = built
    assert jm._fused_vi is not None
    assert tm.grid.stretched_axes == (2,)
    fvi.vi_config(tm.grid, tm.momentum_advection, tm.tracer_advection,
                  len(tm.tracer_names), tm.coriolis)
    rng = np.random.default_rng(7)
    u0, v0 = (0.05 * rng.standard_normal((16, 8, 8)) for _ in range(2))
    for m in built:
        m.set(u=u0, v=v0, b=lambda lam, phi, z: 1e-3 * z
              + 1e-2 * np.cos(np.deg2rad(lam)) * (phi + 10))
    for _ in range(3):
        jm.time_step(30.0)
        tm.time_step(30.0)
    for name in tuple(tm.prognostic_names) + ("w",):
        a = np.asarray(jm.field(name).interior)
        b = tm.field(name).interior.numpy()
        assert a.shape == b.shape, name
        assert _rel(b, a) <= 1e-10, name


# -- the gate ---------------------------------------------------------------------

COVERED = {
    "stretched z": ("z", lambda: ot.WENOVectorInvariant(), ot.WENO(5)),
    "stretched latitude": ("lat", ot.VectorInvariant, ot.Centered(2)),
    "rectilinear stretched y": ("rect", ot.VectorInvariant, ot.Centered(2)),
    "WENOVectorInvariant(order=11)": (
        "latlon", lambda: ot.WENOVectorInvariant(order=11), ot.WENO(11)),
    "cross_and_self": ("latlon", lambda: ot.WENOVectorInvariant(
        upwinding="cross_and_self"), ot.UpwindBiased(1)),
    "default stencil": ("latlon", lambda: ot.WENOVectorInvariant(
        vorticity_stencil="default"), ot.Centered(12)),
    "mixed": ("latlon", lambda: ot.VectorInvariant(
        vorticity_scheme=ot.Centered(4),
        vertical_advection_scheme=ot.UpwindBiased(7),
        kinetic_energy_gradient_scheme=ot.WENO(3)),
        FluxFormAdvection(ot.WENO(5), ot.UpwindBiased(3), ot.Centered(4))),
    "bf16 smoothness": ("latlon", lambda: ot.WENOVectorInvariant(
        smoothness_dtype=torch.bfloat16),
        ot.WENO(5, smoothness_dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(COVERED))
def test_gate_covers(case):
    """vi_config takes every configuration of the JAX kernel's coverage on
    a lat-lon or rectilinear grid, any tracer count and every Coriolis."""
    kind, make_vi, ts = COVERED[case]
    dtype = torch.float32 if case == "bf16 smoothness" else F64
    grid = _grid(False, kind, (7, 7, 7)).to(dtype=dtype)
    planar = kind == "rect"
    for cor in (None, ot.FPlane(f=1e-4), ot.BetaPlane(f0=1e-4, beta=1e-11),
                ot.ConstantCartesianCoriolis(fz=1e-4),
                ot.NonTraditionalBetaPlane(latitude=45.0),
                ot.HydrostaticSphericalCoriolis(),
                ot.HydrostaticSphericalCoriolis(
                    scheme="enstrophy_conserving")):
        for ntr in (0, 1, 17, 40):
            cfg = fvi.vi_config(grid, make_vi(), ts, ntr, cor)
            assert cfg["R"] >= 4 and cfg["KM"] >= 3
    if planar:
        assert fvi.vi_config(grid, make_vi(), ts, 1, None)["ys"]


def test_gate_refuses_what_jax_refuses():
    """vi_config refuses, naming ROADMAP item 13, exactly what JAX's
    eligible_hydrostatic refuses on the grids it takes (an immersed grid,
    a shell grid, a stretched x, polar caps, the z-compact layout) and the
    multi-dimensional stencil, which the plain VI refuses when built."""
    from oceananigans_tpu_torch.immersed import (GridFittedBottom,
                                                 ImmersedBoundaryGrid)
    vi, ts = ot.VectorInvariant(), ot.Centered(2)
    grid = _grid(False, "latlon", (7, 7, 7))
    refused = {
        "immersed": ImmersedBoundaryGrid(grid, GridFittedBottom(
            lambda lam, phi: -1000.0 + 0 * lam)),
        "shell": ot.TripolarGrid((24, 12, 4), z=(-100.0, 0.0), dtype=F64,
                                 device="cpu"),
        "stretched x": ot.RectilinearGrid(
            size=(8, 8, 4), x=tuple(np.linspace(0, 1, 9) ** 2), y=(0, 1),
            z=(-1, 0), dtype=F64, device="cpu"),
        "polar": ot.LatitudeLongitudeGrid(size=(8, 8, 4), longitude=(0, 60),
                                          latitude=(-90, 90), z=(-1, 0),
                                          dtype=F64, device="cpu"),
        "z-compact": ot.RectilinearGrid(size=(8, 8, 4), extent=(1, 1, 1),
                                        halo=(3, 3, 0), dtype=F64,
                                        device="cpu"),
    }
    for label, g in refused.items():
        with pytest.raises(NotImplementedError, match="item 13"):
            fvi.vi_config(g, vi, ts, 1, None)
    # the multi-dimensional stencil builds, and the kernel takes it
    g = ot.LatitudeLongitudeGrid(size=(8, 8, 4), longitude=(0, 60),
                                 latitude=(10, 50), z=(-1, 0), dtype=F64,
                                 device="cpu")
    assert fvi.vi_config(g, ot.VectorInvariant(
        vorticity_scheme=ot.WENO(5, smoothness_dtype=F64),
        multi_dimensional_stencil=True), ts, 1, None)["md"] == 1
    # a model on a refused grid takes the plain tendency under "auto"
    m = HydrostaticFreeSurfaceModel(refused["polar"], tracers=("T",))
    assert not m.uses_kernel


# -- the launch plans ---------------------------------------------------------------

PLAN_CASES = {
    "hydro_row": (lambda: ot.WENOVectorInvariant(), ot.Centered(2), 1,
                  (6, 2, 3, 3)),
    "weno9_everywhere": (lambda: ot.WENOVectorInvariant(order=9),
                         ot.WENO(9), 1, (6, 4, 5, 5)),
    "weno11_everywhere": (lambda: ot.WENOVectorInvariant(order=11),
                          ot.WENO(11), 3, (7, 5, 6, 6)),
    "energy_centered12": (ot.VectorInvariant, ot.Centered(12), 40,
                          (4, 2, 6, 6)),
    "upwind_vi": (lambda: ot.VectorInvariant(
        vorticity_scheme=ot.UpwindBiased(11),
        vertical_advection_scheme=ot.UpwindBiased(9)), ot.UpwindBiased(1), 2,
        (7, 4, 5, 3)),
}


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["latlon", "z", "rect"])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_launch_plan(case, kind, dtype):
    """#10's launch plan by configuration: the reaches (R, Rw, Rz, Rc)
    follow the sites' buffers, the shared memory stays within 232,448 B and
    lets two float32 blocks (one float64 block) share an SM, the staged rows
    count the stretched axes' coefficients, and the tiles cover every
    output cell once."""
    make_vi, ts, ntr, reach = PLAN_CASES[case]
    grid = _grid(False, kind, (7, 7, 7)).to(dtype=dtype)
    cfg = fvi.vi_config(grid, make_vi(), ts, ntr,
                        ot.FPlane(f=1e-4) if kind == "rect"
                        else ot.HydrostaticSphericalCoriolis())
    plan = fvi.launch_plan(grid, cfg, dtype)
    assert plan["reach"] == reach
    assert plan["smem"] <= MAX_SMEM
    per_sm = fvi.TILE_BLOCKS_PER_SM[torch.empty((), dtype=dtype)
                                    .element_size()]
    assert fvi.SM_SMEM // (plan["smem"] + fvi.SMEM_RESERVED) >= per_sm
    ny, nz = plan["rows"]
    assert (ny > fvi.N_ROWS) == (kind == "rect")
    assert (nz > fvi.N_ZCOLS) == (kind == "z")
    # every output cell once: Nx + bx by Ny + by by Nz
    TX, TY, TZ = plan["tile"]
    bx = int(grid.topology[0] == "bounded")
    by = int(grid.topology[1] == "bounded")
    out = (N[0] + bx, N[1] + by, N[2])
    cover = np.zeros(out, int)
    for n in range(plan["blocks"]):
        tz = n % plan["tiles"][2]
        ty = (n // plan["tiles"][2]) % plan["tiles"][1]
        tx = n // plan["tiles"][2] // plan["tiles"][1]
        cover[TX * tx:TX * (tx + 1), TY * ty:TY * (ty + 1),
              TZ * tz:TZ * (tz + 1)] += 1
    assert (cover == 1).all()
    assert fvi.variant_name(cfg).startswith(f"k{cfg['KM']}")


def test_coefficient_rows_match_plain():
    """The per-slot rows of a stretched axis hold the plain version's own
    coefficients (advection/schemes.py _nonuniform_eno_np) in the kernel's
    order: the right-biased rows are derived on their own, not mirrored."""
    from oceananigans_tpu_torch.advection.schemes import (_nonuniform_eno_np,
                                                          _padded_faces)
    grid = _grid(False, "z", (7, 7, 7))
    cfg = fvi.vi_config(grid, ot.WENOVectorInvariant(order=7),
                        ot.UpwindBiased(5), 1, None)
    bases, ye, ze = fvi.site_bases(cfg)
    assert ye == () and dict(ze) == {(fvi.WENO_FAMILY, 0): 4,
                                     (fvi.UPWIND, 0): 3}
    rows = fvi.coefficient_rows(grid, dict(ze), 2)
    base, _ = fvi.entry_firsts(dict(ze))
    faces = _padded_faces(grid, 2)
    npad = grid.padded_shape[2]
    w0 = base[(fvi.WENO_FAMILY, 0)]
    k, s = 4, 1
    for side in (0, 1):
        want = _nonuniform_eno_np(faces.tobytes(), faces.size, 0, k, s,
                                  bool(side), npad)
        for j in range(k):
            got = rows[w0 + fvi.weno_off(k, side) + s * k + j]
            np.testing.assert_array_equal(got, want[j])
    left = rows[w0 + fvi.weno_off(k, 0): w0 + fvi.weno_off(k, 1)]
    right = rows[w0 + fvi.weno_off(k, 1): w0 + fvi.weno_off(k + 1, 0)]
    interior = slice(grid.H[2], grid.H[2] + N[2])
    assert not np.allclose(np.asarray(left)[:, interior],
                           np.asarray(right)[::-1][:, interior])
    u0 = base[(fvi.UPWIND, 0)]
    want = _nonuniform_eno_np(faces.tobytes(), faces.size, 0, 5, 2, True,
                              npad)
    for j in range(5):
        np.testing.assert_array_equal(rows[u0 + fvi.ub_off(3, 1) + j],
                                      want[j])
