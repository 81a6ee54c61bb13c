"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)

Float64 fields with float64 WENO smoothness at (16, 16, 32) (every scheme
of the advection kernels, #1, #6 and #8, at (19, 13, 30) and 45 x 61, and
on a z column of 2K + 1 cells; the fused hydrostatic tendency at 16x12x8
lat-lon, bounded and periodic x, with and without ph, for
WENOVectorInvariant(), WENOVectorInvariant(order=5) and VectorInvariant();
every Coriolis branch; three tracers; a bounded RectilinearGrid); bound 1e-12
relative to max|plain|: the kernels evaluate the same stencils with FMA
contraction and in another association order, which is roundoff. The halo
fill (one launch for every axis of a batch of fields) copies, reflects or
pins, so it must agree exactly, except on the slots a Value/Gradient
condition extrapolates: 1e-13 relative in float64 and 1e-6 in float32 (FMA
contraction, and PyTorch multiplies by the reciprocal of a scalar divisor on
the card). The mesh halo
exchange copies (exact); the sharded stages on a 2x2 mesh of the card equal
the serial kernels exactly (the same kernel on the same operands per cell)
and match their plain routes to 1e-12."""

import numpy as np
import pytest
import torch

import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.boundary_conditions import (
    BoundaryCondition, FieldBoundaryConditions,
    regularize_field_boundary_conditions)
from oceananigans_tpu_torch.boundary_conditions import boundary_condition as bcm
from oceananigans_tpu_torch.kernels import halo_fill as hf

torch.set_num_threads(1)

TOL = 1e-12
N = (16, 16, 32)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=(4, 4, 0),
                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    u, v, w, p = (0.1 * torch.randn(grid.padded_shape, generator=gen,
                                    dtype=torch.float64, device="cuda")
                  for _ in range(4))
    K.periodic_halo_fill(grid, [u, v, w, p])
    Gm = [torch.randn(N, generator=gen, dtype=torch.float64, device="cuda")
          for _ in range(3)]
    return grid, u, v, w, p, Gm


def _close(got, want):
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL * b.abs().max().item()


@pytest.mark.parametrize("with_gm", [False, True])
@pytest.mark.parametrize("with_corr", [False, True])
def test_fused_advection_update(inputs, with_gm, with_corr):
    grid, u, v, w, p, Gm = inputs
    scheme = ot.WENO(5, smoothness_dtype=torch.float64)
    args = (grid, scheme, u, v, w, Gm if with_gm else None, 0.1, -0.05,
            p if with_corr else None, 0.07 if with_corr else None)
    Gk, nk = K.fused_advection_update(*args)
    Gp, np_ = K.fused_advection_update_plain(*args)
    _close(Gk + list(nk.values()), Gp + list(np_.values()))


def test_fused_divergence(inputs):
    grid, u, v, w, _, _ = inputs
    _close([K.fused_divergence(grid, u, v, w, 2.0)],
           [K.fused_divergence_plain(grid, u, v, w, 2.0)])


def test_fused_correct(inputs):
    grid, u, v, w, p, _ = inputs
    _close(K.fused_correct(grid, p, u, v, w, 0.3),
           K.fused_correct_plain(grid, p, u, v, w, 0.3))


def test_periodic_halo_fill(inputs):
    grid = inputs[0]
    a = torch.randn(grid.padded_shape, dtype=torch.float64, device="cuda")
    b = a.clone()
    K.periodic_halo_fill(grid, [a])
    K.periodic_halo_fill_plain(grid, [b])
    assert torch.equal(a, b)


# -- the convection path's kernels (padded layout, H = (3, 3, 3)) -------------

@pytest.fixture(scope="module")
def zinputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=(3, 3, 3),
                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    fields = [0.1 * torch.randn(grid.padded_shape, generator=gen,
                                dtype=torch.float64, device="cuda")
              for _ in range(4)]
    return grid, fields


@pytest.mark.parametrize("scheme", ["weno5", "centered2"])
def test_fused_advection_tendency(zinputs, scheme):
    grid, fields = zinputs
    s = (ot.WENO(5, smoothness_dtype=torch.float64) if scheme == "weno5"
         else ot.Centered(2))
    _close(list(K.fused_advection_tendency(grid, s, fields)),
           list(K.fused_advection_tendency_plain(grid, s, fields)))


ZCASES = [K.ZFill(face, bottom, top) for face in (False, True)
          for bottom, top in (((0, 0.0), (0, 0.0)), ((2, 0.5), (2, -0.5)),
                              ((3, -0.25), (1, 0.0)))]


ZCLASSES = (bcm.FLUX, bcm.OPEN, bcm.VALUE, bcm.GRADIENT)


def zfill_locs_bcs(spec):
    """(location, conditions) of a field whose z fill is ``spec``."""
    def side(cls_value):
        return BoundaryCondition(ZCLASSES[cls_value[0]], cls_value[1])

    return (("c", "c", "f" if spec.face else "c"),
            FieldBoundaryConditions(bottom=side(spec.bottom),
                                    top=side(spec.top)))


def check_fill(grid, fields, locs_bcs, z=True):
    """The fill kernel against its plain version on copies of ``fields``:
    bit for bit, the slots an extrapolation forms too; one launch per 32
    fields, none where no axis is filled."""
    a = [f.clone() for f in fields]
    b = [f.clone() for f in fields]
    codes = hf.fill_codes(grid, a[0].shape, locs_bcs, len(a), z)
    fills = any(c[0] != hf.KEEP for f in codes for c in f)
    before = K.fill_halos.launches
    K.fill_halos(grid, a, locs_bcs, z=z)
    assert K.fill_halos.launches == before + fills * ((len(a) + 31) // 32)
    K.fill_halos_plain(grid, b, locs_bcs, z=z)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("spec", ZCASES, ids=str)
def test_bounded_z_fill(zinputs, spec):
    """The fill kernel on a periodic-x/y, bounded-z grid, each z location
    and (bottom, top) pair: the wrap and the bounded z in one launch."""
    grid, fields = zinputs
    check_fill(grid, fields[:1], [zfill_locs_bcs(spec)])


def test_periodic_halo_fill_z_halos(zinputs):
    grid, fields = zinputs
    a = [f.clone() for f in fields]
    b = [f.clone() for f in fields]
    K.periodic_halo_fill(grid, a)
    K.periodic_halo_fill_plain(grid, b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- the shallow-water stage (2D, z flat, H = (4, 4, 0)) -------------------------

SW_N = (24, 20)


@pytest.fixture(scope="module")
def sw_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=SW_N, extent=(10.0, 8.0), halo=(4, 4, 0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(shape, scale, offset=0.0):
        return offset + scale * torch.randn(shape, generator=gen,
                                            dtype=torch.float64, device="cuda")

    shape = grid.padded_shape
    fields = dict(uh=randn(shape, 0.1), vh=randn(shape, 0.1),
                  h=randn(shape, 0.05, 1.0), c=randn(shape, 1.0))
    hB = randn(shape, 0.05)
    K.periodic_halo_fill(grid, list(fields.values()) + [hB])
    Gm = randn((4,) + tuple(grid.N), 1.0)
    return grid, fields, hB, Gm


@pytest.mark.parametrize("with_gm", [False, True])
@pytest.mark.parametrize("scheme", ["weno5", "centered2"])
def test_fused_sw_update(sw_inputs, scheme, with_gm):
    grid, fields, hB, Gm = sw_inputs
    s = (ot.WENO(5, smoothness_dtype=torch.float64) if scheme == "weno5"
         else ot.Centered(2))
    args = (grid, s, 9.81, 0.3, hB, ("uh", "vh", "h", "c"), fields,
            Gm if with_gm else None, 2e-3, -1e-3)
    Gk, nk = K.fused_sw_update(*args)
    Gp, np_ = K.fused_sw_update_plain(*args)
    ints = grid.interior_slices
    _close(list(Gk) + [nk[n][ints] for n in nk],
           list(Gp) + [np_[n][ints] for n in np_])


def test_fused_sw_update_other_scheme_raises(sw_inputs):
    """A scheme the kernels do not take (a per-axis FluxFormAdvection)
    raises on the card, naming its ROADMAP item."""
    from oceananigans_tpu_torch.advection import FluxFormAdvection
    grid, fields, hB, _ = sw_inputs
    s = FluxFormAdvection(ot.WENO(5), ot.WENO(3), ot.WENO(5))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.fused_sw_update(grid, s, 9.81, 0.0, hB, ("uh", "vh", "h", "c"),
                          fields, None, 1e-3, 0.0)


# -- every scheme (Centered 2-12, UpwindBiased 1-11, WENO 3-11) --------------
# #1, #6 and #8 against their plain versions in float64 (float64 smoothness)
# on interiors no tile divides, with a z of 30 cells (every level of each
# cascade), and a z-wall case per family on a column of 2K + 1 cells.

ALL_SCHEMES = {
    **{f"Centered({o})": (lambda o=o: ot.Centered(o))
       for o in range(2, 13, 2)},
    **{f"UpwindBiased({o})": (lambda o=o: ot.UpwindBiased(o))
       for o in range(1, 12, 2)},
    **{f"WENO({o})": (lambda o=o: ot.WENO(o, smoothness_dtype=torch.float64))
       for o in range(3, 12, 2)},
}


def _scheme_fields(N, halo, nf, seed):
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 2.0, 1.5), halo=halo,
                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = [0.1 * torch.randn(grid.padded_shape, generator=gen,
                           dtype=torch.float64, device="cuda")
         for _ in range(nf)]
    K.periodic_halo_fill(grid, f)
    return grid, gen, f


def _update_close(scheme, N, seed):
    H = scheme.required_halo + 1
    grid, gen, f = _scheme_fields(N, (H, H, 0), 6, seed)
    u, v, w, p, c0, c1 = f
    w[..., 0] = 0
    tracers = {"c0": c0, "c1": c1}
    Gm = [torch.randn(N, generator=gen, dtype=torch.float64, device="cuda")
          for _ in range(5)]
    for gm in (None, Gm):
        for pp in (None, p):
            args = (grid, scheme, u, v, w, gm, 0.1, -0.05, pp,
                    0.07 if pp is not None else None)
            Gk, nk = K.fused_advection_update(*args, tracers=tracers)
            Gp, np_ = K.fused_advection_update_plain(*args, tracers=tracers)
            _close(Gk + list(nk.values()), Gp + list(np_.values()))


def _tendency_close(scheme, N, layout, seed):
    H = scheme.required_halo
    halo = (H, H, 0) if layout == "compact" else (H, H, H)
    grid, _, f = _scheme_fields(N, halo, 5, seed)
    if layout == "compact":
        f[2][..., 0] = 0
    _close(list(K.fused_advection_tendency(grid, scheme, f)),
           list(K.fused_advection_tendency_plain(grid, scheme, f)))


@pytest.mark.parametrize("name", list(ALL_SCHEMES))
def test_every_scheme_update(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _update_close(ALL_SCHEMES[name](), (19, 13, 30), 40)


@pytest.mark.parametrize("layout", ["compact", "padded"])
@pytest.mark.parametrize("name", list(ALL_SCHEMES))
def test_every_scheme_tendency(name, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _tendency_close(ALL_SCHEMES[name](), (19, 13, 30), layout, 41)


@pytest.mark.parametrize("name", list(ALL_SCHEMES))
def test_every_scheme_sw(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = ALL_SCHEMES[name]()
    H = s.required_halo + 1
    grid = ot.RectilinearGrid(size=(45, 61), extent=(10.0, 8.0),
                              halo=(H, H, 0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(42)

    def randn(shape, scale, offset=0.0):
        return offset + scale * torch.randn(shape, generator=gen,
                                            dtype=torch.float64, device="cuda")

    shape = grid.padded_shape
    fields = dict(uh=randn(shape, 0.1), vh=randn(shape, 0.1),
                  h=randn(shape, 0.05, 1.0), c=randn(shape, 1.0))
    hB = randn(shape, 0.05)
    K.periodic_halo_fill(grid, list(fields.values()) + [hB])
    Gm = randn((4,) + tuple(grid.N), 1.0)
    for gm in (None, Gm):
        args = (grid, s, 9.81, 0.3, hB, ("uh", "vh", "h", "c"), fields, gm,
                2e-3, -1e-3)
        Gk, nk = K.fused_sw_update(*args)
        Gp, np_ = K.fused_sw_update_plain(*args)
        ints = grid.interior_slices
        _close(list(Gk) + [nk[n][ints] for n in nk],
               list(Gp) + [np_[n][ints] for n in np_])


@pytest.mark.parametrize("name", ["WENO(11)", "UpwindBiased(11)",
                                  "Centered(12)"])
def test_cascade_at_the_walls(name):
    """A column of 2K + 1 cells: every cell within the reach of a wall,
    each level of the cascade on a few of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = ALL_SCHEMES[name]()
    N = (9, 8, 2 * s.required_halo + 1)
    _update_close(s, N, 43)
    _tendency_close(s, N, "compact", 44)
    _tendency_close(s, N, "padded", 45)


# -- the fused hydrostatic tendency -------------------------------------------------

VI_N = (16, 12, 8)


def _latlon(lon):
    return ot.LatitudeLongitudeGrid(size=VI_N, longitude=lon,
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    halo=(6, 6, 6), dtype=torch.float64,
                                    device="cuda")


def _vi_inputs(lon, grid=None, tracers=("T",)):
    """Random u, v, w, ph and ``tracers`` on ``grid`` (default: the 16x12x8
    lat-lon grid over ``lon``), halos filled with the default conditions."""
    from oceananigans_tpu_torch.boundary_conditions import (
        fill_halo_regions, regularize_field_boundary_conditions)
    grid = _latlon(lon) if grid is None else grid
    gen = torch.Generator(device="cuda").manual_seed(3)
    locs = {"u": ("f", "c", "c"), "v": ("c", "f", "c"),
            "w": ("c", "c", "f"), "ph": ("c", "c", "c")}
    locs.update({n: ("c", "c", "c") for n in tracers})
    fields = {}
    for name, loc in locs.items():
        a = torch.randn(grid.padded_shape, generator=gen, dtype=torch.float64,
                        device="cuda") * (0.1 if name in "uvw" else 1.0)
        fields[name] = fill_halo_regions(
            a, grid, loc, regularize_field_boundary_conditions(None, grid,
                                                               loc))
    return grid, fields


def _vi_compare(grid, f, vi, ts, names, coriolis, with_ph):
    args = (grid, vi, ts, names, coriolis, f["u"], f["v"], f["w"],
            {n: f[n] for n in names}, f["ph"] if with_ph else None)
    Gu, Gv, Gc = K.fused_vi_tendency(*args)
    Pu, Pv, Pc = K.fused_vi_tendency_plain(*args)
    torch.cuda.synchronize()
    _close([Gu, Gv] + [Gc[n] for n in names],
           [Pu, Pv] + [Pc[n] for n in names])


VI_CONFIGS = {
    "weno_vi": lambda: (ot.WENOVectorInvariant(
        smoothness_dtype=torch.float64), ot.WENO(
        5, smoothness_dtype=torch.float64)),
    "weno5_vi": lambda: (ot.WENOVectorInvariant(
        order=5, smoothness_dtype=torch.float64), ot.Centered(2)),
    "vector_invariant": lambda: (ot.VectorInvariant(), ot.Centered(2)),
}


@pytest.mark.parametrize("with_ph", [False, True], ids=["no_ph", "ph"])
@pytest.mark.parametrize("lon", [(0.0, 60.0), (0.0, 360.0)],
                         ids=["bounded_x", "periodic_x"])
@pytest.mark.parametrize("config", sorted(VI_CONFIGS))
def test_fused_vi_tendency(config, lon, with_ph):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid, f = _vi_inputs(lon)
    vi, ts = VI_CONFIGS[config]()
    _vi_compare(grid, f, vi, ts, ("T",), ot.HydrostaticSphericalCoriolis(),
                with_ph)


VI_CORIOLIS = {
    "none": lambda: None,
    "fplane": lambda: ot.FPlane(f=1e-4),
    "spherical_enstrophy": lambda: ot.HydrostaticSphericalCoriolis(
        scheme="enstrophy_conserving"),
}


@pytest.mark.parametrize("coriolis", sorted(VI_CORIOLIS))
@pytest.mark.parametrize("config", ["weno_vi", "vector_invariant"])
def test_fused_vi_tendency_coriolis(config, coriolis):
    """The Coriolis branches the energy-conserving spherical default does
    not take, on the bounded-x grid with ph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid, f = _vi_inputs((0.0, 60.0))
    vi, ts = VI_CONFIGS[config]()
    _vi_compare(grid, f, vi, ts, ("T",), VI_CORIOLIS[coriolis](), True)


@pytest.mark.parametrize("config", ["weno_vi", "weno5_vi"])
def test_fused_vi_tendency_three_tracers(config):
    """Three tracers (WENO(5) and Centered(2) tracer schemes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names = ("T", "S", "c")
    grid, f = _vi_inputs((0.0, 60.0), tracers=names)
    vi, ts = VI_CONFIGS[config]()
    _vi_compare(grid, f, vi, ts, names, ot.HydrostaticSphericalCoriolis(),
                False)


@pytest.mark.parametrize("topology", [("bounded", "bounded", "bounded"),
                                      ("periodic", "bounded", "bounded")],
                         ids=["bounded_xy", "periodic_x"])
@pytest.mark.parametrize("config", sorted(VI_CONFIGS))
def test_fused_vi_tendency_rectilinear(config, topology):
    """A regular RectilinearGrid (its metric rows are constants), f-plane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=VI_N, extent=(4e5, 2.4e5, 1800.0),
                              halo=(6, 6, 6), topology=topology,
                              dtype=torch.float64, device="cuda")
    grid, f = _vi_inputs(None, grid=grid)
    vi, ts = VI_CONFIGS[config]()
    _vi_compare(grid, f, vi, ts, ("T",), ot.FPlane(f=1e-4), True)


def _f64_weno(order):
    return ot.WENO(order, smoothness_dtype=torch.float64)


# the configurations #10 took on with its coverage: (grid z or latitude,
# VI, tracer scheme, tracers, Coriolis)
VI_COVERAGE = {
    "stretched_z": ("z", lambda: ot.WENOVectorInvariant(
        smoothness_dtype=torch.float64), lambda: _f64_weno(5), 1,
        ot.HydrostaticSphericalCoriolis),
    "stretched_latitude_weno7_cross": ("lat", lambda: ot.WENOVectorInvariant(
        order=7, upwinding="cross_and_self", smoothness_dtype=torch.float64),
        lambda: ot.UpwindBiased(3), 2, ot.HydrostaticSphericalCoriolis),
    "weno11_default_stencil": ("flat", lambda: ot.WENOVectorInvariant(
        order=11, vorticity_stencil="default",
        smoothness_dtype=torch.float64), lambda: _f64_weno(11), 1,
        lambda: ot.BetaPlane(f0=1e-4, beta=1e-11)),
    "upwind_vi_centered12_17_tracers": ("z", lambda: ot.VectorInvariant(
        vorticity_scheme=ot.UpwindBiased(9),
        vertical_advection_scheme=ot.UpwindBiased(5)),
        lambda: ot.Centered(12), 17,
        lambda: ot.ConstantCartesianCoriolis(fx=1e-5, fy=2e-5, fz=1e-4)),
    "weno3_nontraditional_40_tracers": ("lat", lambda: ot.WENOVectorInvariant(
        order=3, smoothness_dtype=torch.float64), lambda: _f64_weno(7), 40,
        lambda: ot.NonTraditionalBetaPlane(latitude=45.0)),
}


@pytest.mark.parametrize("with_ph", [False, True], ids=["no_ph", "ph"])
@pytest.mark.parametrize("case", sorted(VI_COVERAGE))
def test_fused_vi_tendency_coverage(case, with_ph):
    """#10 on the configurations its coverage added (stretched z and
    latitude, every scheme order, cross-upwinding, 17 and 40 tracers, the
    planar and non-traditional Coriolis) against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kind, make_vi, make_ts, ntr, make_cor = VI_COVERAGE[case]
    z = tuple(-500.0 * np.linspace(1, 0, VI_N[2] + 1) ** 1.5)
    lat = tuple(15 + 60 * np.linspace(0, 1, VI_N[1] + 1) ** 1.3)
    grid = ot.LatitudeLongitudeGrid(
        size=VI_N, longitude=(0.0, 60.0),
        latitude=lat if kind == "lat" else (15, 75),
        z=z if kind == "z" else (-1800.0, 0.0), halo=(7, 7, 7),
        dtype=torch.float64, device="cuda")
    names = tuple(f"c{i}" for i in range(ntr))
    grid, f = _vi_inputs(None, grid=grid, tracers=names)
    _vi_compare(grid, f, make_vi(), make_ts(), names, make_cor(), with_ph)


# the multi-dimensional stencil: (grid z or latitude, x range, halo, VI,
# tracer scheme, tracers, Coriolis)
VI_MD = {
    "weno9_bounded_x": ("flat", (0.0, 60.0), 8, lambda: ot.WENOVectorInvariant(
        smoothness_dtype=torch.float64, multi_dimensional_stencil=True),
        lambda: _f64_weno(5), 1, ot.HydrostaticSphericalCoriolis),
    "weno9_periodic_x_3_tracers": ("flat", (0.0, 360.0), 8,
                                   lambda: ot.WENOVectorInvariant(
                                       smoothness_dtype=torch.float64,
                                       multi_dimensional_stencil=True),
                                   lambda: ot.Centered(2), 3,
                                   ot.HydrostaticSphericalCoriolis),
    "weno5_cross_stretched_z": ("z", (0.0, 60.0), 6,
                                lambda: ot.WENOVectorInvariant(
                                    order=5, upwinding="cross_and_self",
                                    smoothness_dtype=torch.float64,
                                    multi_dimensional_stencil=True),
                                lambda: _f64_weno(5), 2,
                                lambda: ot.FPlane(f=1e-4)),
    "weno7_stretched_latitude_34_tracers": (
        "lat", (0.0, 60.0), 7, lambda: ot.WENOVectorInvariant(
            order=7, smoothness_dtype=torch.float64,
            multi_dimensional_stencil=True),
        lambda: ot.UpwindBiased(3), 34, ot.HydrostaticSphericalCoriolis),
}


@pytest.mark.parametrize("with_ph", [False, True], ids=["no_ph", "ph"])
@pytest.mark.parametrize("case", sorted(VI_MD))
def test_fused_vi_tendency_multi_dimensional(case, with_ph):
    """#10 with the multi-dimensional stencil against its plain version on
    interiors its tiles do not divide (19 x 13 x 9), bounded and periodic x,
    both upwindings, stretched z and latitude, 34 tracers (two launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kind, lon, H, make_vi, make_ts, ntr, make_cor = VI_MD[case]
    n = (19, 13, 9)
    z = tuple(-500.0 * np.linspace(1, 0, n[2] + 1) ** 1.5)
    lat = tuple(15 + 60 * np.linspace(0, 1, n[1] + 1) ** 1.3)
    grid = ot.LatitudeLongitudeGrid(
        size=n, longitude=lon, latitude=lat if kind == "lat" else (15, 75),
        z=z if kind == "z" else (-1800.0, 0.0), halo=(H, H, H),
        dtype=torch.float64, device="cuda")
    names = tuple(f"c{i}" for i in range(ntr))
    grid, f = _vi_inputs(None, grid=grid, tracers=names)
    _vi_compare(grid, f, make_vi(), make_ts(), names, make_cor(), with_ph)


@pytest.mark.parametrize("with_ph", [False, True], ids=["no_ph", "ph"])
@pytest.mark.parametrize("lon", [(0.0, 60.0), (0.0, 360.0)],
                         ids=["bounded_x", "periodic_x"])
def test_fused_vi_tendency_multi_dimensional_bf16(lon, with_ph):
    """The stencil's family with bfloat16 smoothness on float32 fields (the
    ``k5_bf16_md`` variant, 19 x 13 x 9, H = 8) against its plain version:
    2e-5 of each output's max|plain| (#10's float32 bound), at most a tenth
    of the plain version's bf16-vs-float32 difference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = dict(size=(19, 13, 9), longitude=lon, latitude=(15, 75),
              z=(-1800.0, 0.0), halo=(8, 8, 8), device="cuda")
    grid = ot.LatitudeLongitudeGrid(dtype=torch.float32, **kw)
    names = ("T", "S")
    _, f = _vi_inputs(None, grid=ot.LatitudeLongitudeGrid(
        dtype=torch.float64, **kw), tracers=names)
    f = {k: a.float() for k, a in f.items()}
    hsc = ot.HydrostaticSphericalCoriolis()

    def run(fn, sdt):
        vi = ot.WENOVectorInvariant(smoothness_dtype=sdt,
                                    multi_dimensional_stencil=True)
        Gu, Gv, Gc = fn(grid, vi, ot.WENO(5, smoothness_dtype=sdt), names,
                        hsc, f["u"], f["v"], f["w"], {n: f[n] for n in names},
                        f["ph"] if with_ph else None)
        return [Gu, Gv] + [Gc[n] for n in names]

    before = K.counters()[0].get("fused_vi_tendency_k5_bf16_md", 0)
    got = run(K.fused_vi_tendency, torch.bfloat16)
    assert K.counters()[0]["fused_vi_tendency_k5_bf16_md"] == before + 1
    _bf16_close(got, run(K.fused_vi_tendency_plain, torch.bfloat16),
                run(K.fused_vi_tendency_plain, torch.float32), range(4),
                rel=2e-5)


@pytest.mark.parametrize("surface", [False, True], ids=["3d", "surface"])
@pytest.mark.parametrize("grid_kind", ["periodic_x_latlon",
                                       "periodic_y_rectilinear"])
def test_periodic_halo_fill_one_axis(grid_kind, surface):
    """The wrap with one periodic axis (wrap_x xor wrap_y) leaves the other
    axis's halos alone, as its plain version does: exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if grid_kind == "periodic_x_latlon":
        grid = _latlon((0.0, 360.0))
    else:
        grid = ot.RectilinearGrid(size=VI_N, extent=(1.0, 1.0, 1.0),
                                  halo=(6, 6, 6),
                                  topology=("bounded", "periodic", "bounded"),
                                  dtype=torch.float64, device="cuda")
    shape = grid.padded_shape[:2] + (1,) if surface else grid.padded_shape
    a = torch.randn(shape, dtype=torch.float64, device="cuda")
    b = a.clone()
    K.periodic_halo_fill(grid, [a])
    K.periodic_halo_fill_plain(grid, [b])
    assert torch.equal(a, b)


def test_fused_vi_tendency_uncovered_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid, f = _vi_inputs((0.0, 60.0))
    # WENO schemes of two smoothness dtypes: the kernel is built for one
    with pytest.raises(NotImplementedError, match="fused VI kernel"):
        K.fused_vi_tendency(grid, ot.WENOVectorInvariant(
            smoothness_dtype=torch.float32),
            ot.WENO(5, smoothness_dtype=torch.float64), ("T",), None,
            f["u"], f["v"], f["w"], {"T": f["T"]}, None)


# -- the mesh halo exchange and the sharded stages --------------------------------
#
# "card": a 2x2 mesh naming cuda:0 four times (the exchange kernel moves every
# strip); "cards": the shards spread over the visible cards (peer copies move
# the strips between cards), which needs two or more.

def _card_mesh(x=2, y=2, spread="card"):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count() if spread == "cards" else 1
    if spread == "cards" and n < 2:
        pytest.skip("the peer-copy route needs two or more cards")
    return ot.Distributed(ot.Partition(x, y), devices=[
        torch.device("cuda", k % n) for k in range(x * y)])


def _on(t, dev):
    return t.to(dev).contiguous()


@pytest.mark.parametrize("spread", ["card", "cards"])
@pytest.mark.parametrize("shape,halo,z", [((2, 2), (4, 4, 0), 1),
                                          ((2, 2), (3, 3, 3), 14),
                                          ((1, 2), (2, 3, 0), 5)])
def test_mesh_halo_exchange(shape, halo, z, spread):
    """The CUDA routes against the plain version on blocks of two fields:
    exact (they copy); on one card two launches, one per axis."""
    from oceananigans_tpu_torch.parallel import (halo_exchange_local,
                                                 halo_exchange_plain)
    arch = _card_mesh(*shape, spread=spread)
    devs = arch.mesh.devices
    nl = (8, 6)
    gen = torch.Generator(device="cuda").manual_seed(7)
    blocks = [[[_on(torch.randn((nl[0] + 2 * halo[0], nl[1] + 2 * halo[1], z),
                                generator=gen, dtype=torch.float64,
                                device="cuda"), devs[i, j])
                for _ in range(2)] for j in range(shape[1])]
              for i in range(shape[0])]
    copies = [[[_on(a, "cuda:0") for a in b] for b in row] for row in blocks]
    before = K.mesh_halo_exchange.launches
    halo_exchange_local(blocks, arch.mesh, halo, nl)
    if spread == "card":
        assert K.mesh_halo_exchange.launches == before + 2
    halo_exchange_plain(copies, ot.Distributed(
        ot.Partition(*shape), devices=["cuda:0"] * len(devs.ravel())).mesh,
        halo, nl)
    for row, crow in zip(blocks, copies):
        for b, c in zip(row, crow):
            for a, a2 in zip(b, c):
                assert torch.equal(_on(a, "cuda:0"), a2)


def _stitch(parts, S, halo=None):
    """One tensor on cuda:0 from per-shard tensors in rank order (their
    interiors when ``halo`` (Hx, Hy) is given), along the last three axes
    of (nf, nlx, nly, nz) tendencies or the first two of padded blocks."""
    if halo is not None:
        parts = [p[halo[0]:p.shape[0] - halo[0], halo[1]:p.shape[1] - halo[1]]
                 for p in parts]
        ax = (0, 1)
    else:
        ax = (1, 2)
    parts = [_on(p, "cuda:0") for p in parts]
    return torch.cat([torch.cat(parts[i * S[1]:(i + 1) * S[1]], dim=ax[1])
                      for i in range(S[0])], dim=ax[0])


@pytest.mark.parametrize("spread", ["card", "cards"])
def test_sharded_sw_stage(sw_inputs, spread):
    """The sharded stage on the resident blocks of a 2x2 mesh equals the
    serial stage on the same inputs (hB's halos wrapped, as the exchange
    gives them), and its kernel route matches its plain route."""
    grid, fields, hB, Gm = sw_inputs
    arch = _card_mesh(spread=spread)
    devs = arch.mesh.devices.ravel()
    names = ("uh", "vh", "h", "c")
    s = ot.WENO(5, smoothness_dtype=torch.float64)
    args = (grid, s, 9.81, 0.3, hB, names)
    stage = K.build_sharded_fused_sw_update(*args, arch.mesh)
    plain = K.build_sharded_fused_sw_update_plain(*args, arch.mesh)
    G0, new0 = K.fused_sw_update(*args, fields, None, 2e-3, -1e-3)
    launches = K.fused_sw_update.launches
    sharded = K.build_sharded_fused_sw_update.launches
    G1, new1 = stage(arch.scatter(fields, grid.H), None, 2e-3, -1e-3)
    assert K.fused_sw_update.launches == launches + 4
    assert K.build_sharded_fused_sw_update.launches == sharded + 4
    assert [g.device for g in G1] == list(devs)
    ints = grid.interior_slices
    assert torch.equal(_stitch(G1, (2, 2)), G0)
    for n in names:
        assert torch.equal(_stitch([b[n] for b in new1], (2, 2), grid.H),
                           new0[n][ints])
    nlx, nly = grid.N[0] // 2, grid.N[1] // 2
    Gs = [_on(Gm[:, :nlx, :nly], d) for d in devs]
    Gk, nk = stage(arch.scatter(fields, grid.H), Gs, 2e-3, -1e-3)
    Gp, np_ = plain(arch.scatter(fields, grid.H), Gs, 2e-3, -1e-3)
    _close([_stitch(Gk, (2, 2))] + [_stitch([b[n] for b in nk], (2, 2),
                                            grid.H) for n in names],
           [_stitch(Gp, (2, 2))] + [_stitch([b[n] for b in np_], (2, 2),
                                            grid.H) for n in names])


@pytest.mark.parametrize("spread", ["card", "cards"])
def test_sharded_advection_stage(zinputs, spread):
    """The sharded tendency stage on resident blocks equals the serial
    kernel and matches its plain route."""
    grid, fields = zinputs
    arch = _card_mesh(spread=spread)
    fields = K.periodic_halo_fill(grid, [f.clone() for f in fields])
    s = ot.WENO(5, smoothness_dtype=torch.float64)
    stage = K.build_sharded_fused_advection(grid, s, arch.mesh)
    plain = K.build_sharded_fused_advection_plain(grid, s, arch.mesh)
    launches = K.fused_advection_tendency.launches
    G = stage(arch.scatter(fields, grid.H))
    assert K.fused_advection_tendency.launches == launches + 4
    G = _stitch(G, (2, 2))
    assert torch.equal(G, K.fused_advection_tendency(grid, s, fields))
    _close([G], [_stitch(plain(arch.scatter(fields, grid.H)), (2, 2))])


@pytest.mark.parametrize("topology", [("periodic",) * 3,
                                      ("periodic", "periodic", "bounded")],
                         ids=["ppp", "ppb"])
def test_resident_nh_model(topology):
    """The NH model on the resident blocks of a 2x2 mesh of cuda:0 (#7 per
    shard, the exchange kernel, the pencil solver) against the same model
    on a 2x2 CPU mesh (the plain versions): 1e-12 after 2 steps in
    float64; #7 launches once per shard and stage."""
    arch = _card_mesh()
    n = (32, 32, 16)

    def model(device, mesh):
        grid = ot.RectilinearGrid(size=n, extent=(1.0, 1.0, 1.0),
                                  topology=topology, dtype=torch.float64,
                                  device=device)
        m = ot.NonhydrostaticModel(
            grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
            buoyancy=ot.BuoyancyTracer(), tracers=("b",), architecture=mesh)
        m.set(u=lambda x, y, z: 0.1 * np.sin(2 * np.pi * y),
              v=lambda x, y, z: 0.1 * np.cos(2 * np.pi * x),
              b=lambda x, y, z: 0.01 * np.sin(2 * np.pi * (x + y)))
        return m

    card = model("cuda", arch)
    cpu = model("cpu", ot.Distributed(ot.Partition(2, 2),
                                      devices=["cpu"] * 4))
    before = K.build_sharded_fused_advection.launches
    for _ in range(2):
        card.time_step(1e-3)
        cpu.time_step(1e-3)
    assert K.build_sharded_fused_advection.launches == before + 2 * 3 * 4
    for name in ("u", "v", "w", "b"):
        a = card.field(name).interior.cpu()
        b = cpu.field(name).interior
        assert (a - b).abs().max() <= 1e-12 * b.abs().max(), name


def test_resident_sw_model():
    """The fused shallow-water model on the resident blocks of a 2x2 mesh
    of cuda:0 (#9 per shard) equals the serial model on the card bit for
    bit (no bathymetry), 3 steps; #9 launches once per shard and stage."""
    arch = _card_mesh()

    def model(mesh):
        grid = ot.RectilinearGrid(size=(64, 48), extent=(10.0, 8.0),
                                  topology=("periodic", "periodic", "flat"),
                                  dtype=torch.float64, device="cuda")
        m = ot.ShallowWaterModel(
            grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
            coriolis=ot.FPlane(f=0.3), tracers=("c",), architecture=mesh)
        rng = np.random.default_rng(0)
        m.set(h=1.0 + 0.05 * rng.standard_normal((64, 48)),
              uh=0.1 * rng.standard_normal((64, 48)),
              vh=0.1 * rng.standard_normal((64, 48)),
              c=rng.random((64, 48)))
        return m

    sharded, serial = model(arch), model(None)
    before = K.build_sharded_fused_sw_update.launches
    for _ in range(3):
        sharded.time_step(1e-3)
        serial.time_step(1e-3)
    assert K.build_sharded_fused_sw_update.launches == before + 3 * 3 * 4
    for name in ("uh", "vh", "h", "c"):
        assert torch.equal(sharded.field(name).interior,
                           serial.field(name).interior), name


@pytest.mark.parametrize("z", ["dct", "stretched"])
def test_pencil_on_the_card(z):
    """The pencil solver on 4 slabs of cuda:0 against the serial solver on
    the card: 1e-12 of max|φ| in float64 (means removed on the stretched
    z, whose singular modes the two pin differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from oceananigans_tpu_torch.parallel import DistributedFFTPoissonSolver
    from oceananigans_tpu_torch.solvers.fft_poisson import FFTPoissonSolver
    from oceananigans_tpu_torch.solvers.fourier_tridiagonal import \
        FourierTridiagonalPoissonSolver
    kw = (dict(extent=(1.0, 2.0, 1.0)) if z == "dct" else
          dict(x=(0, 1), y=(0, 2), z=-1.0 + np.linspace(0, 1, 33) ** 1.5))
    grid = ot.RectilinearGrid(size=(64, 32, 32), dtype=torch.float64,
                              device="cuda", **kw)
    gen = torch.Generator(device="cuda").manual_seed(11)
    b = torch.randn(grid.N, generator=gen, dtype=torch.float64,
                    device="cuda")
    b -= b.mean()
    serial = (FFTPoissonSolver(grid) if z == "dct" else
              FourierTridiagonalPoissonSolver(grid, 2)).solve(b)
    got = DistributedFFTPoissonSolver(grid, ["cuda:0"] * 4).solve(b)
    if z == "stretched":
        got, serial = got - got.mean(), serial - serial.mean()
    assert (got - serial).abs().max() <= 1e-12 * serial.abs().max()


# -- tracers on the z-compact layout, and no caps on field counts ------------------
#
# 12 tracers (#1, #6 in both layouts, #7, #8) and a fill of 20 fields: each
# against its plain version; a launch over 12 tracers equals 12 one-tracer
# launches bit for bit (every component's result depends only on its own
# field and u, v, w, p).

NT = 12
SCHEMES = {"weno5": lambda: ot.WENO(5, smoothness_dtype=torch.float64),
           "centered2": lambda: ot.Centered(2)}


@pytest.fixture(scope="module")
def tracer_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=(4, 4, 0),
                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    fields = [0.1 * torch.randn(grid.padded_shape, generator=gen,
                                dtype=torch.float64, device="cuda")
              for _ in range(4)]
    fields[2][..., 0] = 0
    tracers = {f"c{i}": torch.rand(grid.padded_shape, generator=gen,
                                   dtype=torch.float64, device="cuda")
               for i in range(NT)}
    K.periodic_halo_fill(grid, fields + list(tracers.values()))
    Gm = [torch.randn(N, generator=gen, dtype=torch.float64, device="cuda")
          for _ in range(3 + NT)]
    return grid, fields, tracers, Gm


@pytest.mark.parametrize("with_gm", [False, True])
@pytest.mark.parametrize("with_corr", [False, True])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_fused_advection_update_tracers(tracer_inputs, scheme, with_corr,
                                        with_gm):
    grid, (u, v, w, p), tracers, Gm = tracer_inputs
    args = (grid, SCHEMES[scheme](), u, v, w, Gm if with_gm else None, 0.1,
            -0.05, p if with_corr else None, 0.07 if with_corr else None)
    Gk, nk = K.fused_advection_update(*args, tracers=tracers)
    Gp, np_ = K.fused_advection_update_plain(*args, tracers=tracers)
    assert list(nk) == ["u", "v", "w"] + list(tracers)
    _close(Gk + list(nk.values()), Gp + list(np_.values()))
    # the 12-tracer launch against one launch per tracer
    for k, (name, c) in enumerate(tracers.items()):
        gm1 = None if not with_gm else Gm[:3] + [Gm[3 + k]]
        G1, n1 = K.fused_advection_update(*args[:5], gm1, *args[6:],
                                          tracers={name: c})
        assert torch.equal(G1[3], Gk[3 + k]) and torch.equal(n1[name],
                                                             nk[name])


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_fused_advection_tendency_compact_tracers(tracer_inputs, scheme):
    grid, (u, v, w, _), tracers, _ = tracer_inputs
    fields = [u, v, w] + list(tracers.values())
    s = SCHEMES[scheme]()
    Gk = K.fused_advection_tendency(grid, s, fields)
    _close(list(Gk), list(K.fused_advection_tendency_plain(grid, s, fields)))
    for k, c in enumerate(fields[3:]):
        assert torch.equal(K.fused_advection_tendency(grid, s, [u, v, w, c])[3],
                           Gk[3 + k])


def test_fused_advection_tendency_padded_tracers(zinputs):
    grid, fields = zinputs
    gen = torch.Generator(device="cuda").manual_seed(9)
    fields = fields[:3] + [torch.rand(grid.padded_shape, generator=gen,
                                      dtype=torch.float64, device="cuda")
                           for _ in range(NT)]
    s = ot.WENO(5, smoothness_dtype=torch.float64)
    _close(list(K.fused_advection_tendency(grid, s, fields)),
           list(K.fused_advection_tendency_plain(grid, s, fields)))


@pytest.mark.parametrize("spread", ["card", "cards"])
def test_sharded_advection_stage_compact(tracer_inputs, spread):
    """#7 on z-compact blocks with 12 tracers: equals the serial z-compact
    #6 exactly and matches its plain route."""
    grid, (u, v, w, _), tracers, _ = tracer_inputs
    arch = _card_mesh(spread=spread)
    fields = [u, v, w] + list(tracers.values())
    s = ot.WENO(5, smoothness_dtype=torch.float64)
    G = _stitch(K.build_sharded_fused_advection(grid, s, arch.mesh)(
        arch.scatter(fields, grid.H)), (2, 2))
    assert torch.equal(G, K.fused_advection_tendency(grid, s, fields))
    _close([G], [_stitch(K.build_sharded_fused_advection_plain(
        grid, s, arch.mesh)(arch.scatter(fields, grid.H)), (2, 2))])


def test_fused_sw_update_tracers(sw_inputs):
    grid, fields, hB, _ = sw_inputs
    gen = torch.Generator(device="cuda").manual_seed(10)
    fields = dict(fields)
    names = ("uh", "vh", "h") + tuple(f"c{i}" for i in range(NT))
    for n in names[3:]:
        fields[n] = torch.rand(grid.padded_shape, generator=gen,
                               dtype=torch.float64, device="cuda")
    K.periodic_halo_fill(grid, [fields[n] for n in names])
    Gm = torch.randn((len(names),) + tuple(grid.N), generator=gen,
                     dtype=torch.float64, device="cuda")
    s = ot.WENO(5, smoothness_dtype=torch.float64)
    for gm in (None, Gm):
        args = (grid, s, 9.81, 0.3, hB, names, fields, gm, 2e-3, -1e-3)
        Gk, nk = K.fused_sw_update(*args)
        Gp, np_ = K.fused_sw_update_plain(*args)
        ints = grid.interior_slices
        _close(list(Gk) + [nk[n][ints] for n in names],
               list(Gp) + [np_[n][ints] for n in names])


def test_fill_batches(zinputs):
    """The wrap alone and the wrap with the bounded-z fill of 20 fields
    (one launch takes 32 at most; the batch of 20 in one launch, 40 in
    two)."""
    grid = zinputs[0]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for n in (20, 40):
        a = [torch.randn(grid.padded_shape, generator=gen,
                         dtype=torch.float64, device="cuda") for _ in range(n)]
        b = [x.clone() for x in a]
        before = K.fill_halos.launches
        K.periodic_halo_fill(grid, a)
        assert K.fill_halos.launches == before + (1 if n <= 32 else 2)
        K.periodic_halo_fill_plain(grid, b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        check_fill(grid, a, [zfill_locs_bcs(ZCASES[k % len(ZCASES)])
                             for k in range(n)])


FILL_LOCS = (("c", "c", "c"), ("f", "c", "c"), ("c", "f", "c"),
             ("c", "c", "f"))
FILL_SIDES = ("west", "east", "south", "north", "bottom", "top")


def rotated_locs_bcs(n):
    """``n`` (location, conditions): the four locations, each under four
    rotations of Flux, Open, Value and Gradient over the six sides, with
    nonzero values."""
    out = []
    for k in range(n):
        loc, r = FILL_LOCS[k % 4], (k // 4) % 4
        out.append((loc, FieldBoundaryConditions(**{
            side: BoundaryCondition(ZCLASSES[(s + r) % 4],
                                    0.1 * (s + 1) * (-1) ** s)
            for s, side in enumerate(FILL_SIDES)})))
    return out


def fill_grid(kind, topo, size, halo, dtype):
    if kind == "latlon":
        lon = (0.0, 360.0) if topo[0] == "P" else (0.0, 60.0)
        return ot.LatitudeLongitudeGrid(size=size, longitude=lon,
                                        latitude=(15, 75), z=(-1800.0, 0.0),
                                        halo=halo, dtype=dtype, device="cuda")
    return ot.RectilinearGrid(
        size=size, x=(0.0, 2.0), y=(-1.0, 1.0), z=(-3.0, 0.0), halo=halo,
        topology=tuple("periodic" if t == "P" else "bounded" for t in topo)
        + ("bounded",), dtype=dtype, device="cuda")


FILL_GRIDS = [("rect", t) for t in ("PP", "PB", "BP", "BB")] \
    + [("latlon", t) for t in ("PB", "BB")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("zkind", ["z_halo", "z_compact", "surface"])
@pytest.mark.parametrize("size", [(4, 3, 4), (9, 7, 6)], ids=str)
@pytest.mark.parametrize("kind,topo", FILL_GRIDS,
                         ids=[f"{k}-{t}" for k, t in FILL_GRIDS])
def test_fill_halos(kind, topo, size, zkind, dtype):
    """The fill kernel against its plain version at small shapes (N = H + 1
    and larger): every location under Flux, Open, Value and Gradient on
    every side, a batch of 40 fields (two launches), every axis, x/y only,
    and the periodic axes alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    halo = (3, 2, 3 if zkind == "z_halo" else 0)
    grid = fill_grid(kind, topo, size, halo, dtype)
    shape = grid.padded_shape[:2] + ((1,) if zkind == "surface"
                                     else grid.padded_shape[2:])
    gen = torch.Generator(device="cuda").manual_seed(13)
    locs_bcs = rotated_locs_bcs(40)
    fields = [torch.randn(shape, generator=gen, dtype=dtype, device="cuda")
              for _ in locs_bcs]
    check_fill(grid, fields, locs_bcs)
    check_fill(grid, fields[:16], locs_bcs[:16], z=False)
    check_fill(grid, fields[:16], None)


BENCH_FILLS = {
    # (grid, fields)
    "flagship_264x264x256": lambda: (ot.RectilinearGrid(
        size=(256, 256, 256), extent=(1.0, 1.0, 1.0), halo=(4, 4, 0),
        dtype=torch.float32, device="cuda"), 4),
    "convection_262^3": lambda: (ot.RectilinearGrid(
        size=(256, 256, 256), extent=(1.0, 1.0, 1.0), halo=(3, 3, 3),
        dtype=torch.float64, device="cuda"), 16),
    "hydrostatic_524x268x44": lambda: (ot.LatitudeLongitudeGrid(
        size=(512, 256, 32), longitude=(0, 60), latitude=(15, 75),
        z=(-1800.0, 0.0), halo=(6, 6, 6), dtype=torch.float64,
        device="cuda"), 16),
    "shallow_water_3x16392^2": lambda: (ot.RectilinearGrid(
        size=(16384, 16384), extent=(1.0, 1.0), halo=(4, 4, 0),
        topology=("periodic", "periodic", "flat"), dtype=torch.float32,
        device="cuda"), 3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("Nx", [16, 15])
@pytest.mark.parametrize("H", [1, 2, 3, 4, 6])
def test_fill_halos_fold(H, Nx, dtype):
    """The tripolar fold (FOLD, FOLD_FACE) against the plain fill, bit for
    bit: every location with the grid's conditions (an odd Nx without the
    x-face fields, whose substituted row would swap two columns), 3-D and
    the 2-D surfaces, one batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.TripolarGrid((Nx, 12, 8), z=(-100.0, 0.0), halo=(H, H, H),
                           dtype=dtype, device="cuda")
    locs = [loc for loc in (("c", "c", "c"), ("f", "c", "c"),
                            ("c", "f", "c"), ("c", "c", "f"))
            if Nx % 2 == 0 or loc[0] != "f"]
    lbs = [(loc, regularize_field_boundary_conditions(None, grid, loc))
           for loc in locs]
    gen = torch.Generator(device="cuda").manual_seed(H)
    for shape, z in ((grid.padded_shape, True),
                     (grid.padded_shape[:2] + (1,), False)):
        fields = [torch.randn(shape, generator=gen, dtype=dtype,
                              device="cuda") for _ in lbs]
        check_fill(grid, fields, lbs, z=z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_fill_halos_polar(dtype):
    """The polar caps (POLAR_VALUE, POLAR_PINNED) against the plain fill:
    copies exact, the extrapolations within check_fill's bound; every
    location, 3-D and the 2-D surfaces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.LatitudeLongitudeGrid(size=(24, 12, 8), longitude=(0, 360),
                                    latitude=(-90, 90), z=(-100.0, 0.0),
                                    dtype=dtype, device="cuda")
    locs = (("c", "c", "c"), ("f", "c", "c"), ("c", "f", "c"),
            ("c", "c", "f"))
    lbs = [(loc, regularize_field_boundary_conditions(None, grid, loc))
           for loc in locs]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, z in ((grid.padded_shape, True),
                     (grid.padded_shape[:2] + (1,), False)):
        fields = [torch.randn(shape, generator=gen, dtype=dtype,
                              device="cuda") for _ in lbs]
        check_fill(grid, fields, lbs, z=z)


@pytest.mark.parametrize("size", [(4, 3, 3), (2, 2, 2), (9, 1, 5)], ids=str)
def test_fill_halos_narrow(size):
    """Bounded axes narrower than their halos need: the narrow slots keep
    their value in the kernel as in the plain fill; every location under
    the rotated conditions, float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                              topology=("bounded",) * 3, halo=(3, 2, 3),
                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    locs_bcs = rotated_locs_bcs(16)
    fields = [torch.randn(grid.padded_shape, generator=gen,
                          dtype=torch.float64, device="cuda")
              for _ in locs_bcs]
    check_fill(grid, fields, locs_bcs)


@pytest.mark.parametrize("case", list(BENCH_FILLS))
def test_fill_halos_bench_shapes(case):
    """The fill kernel against its plain version at the main paths' shapes:
    every location under the rotated conditions (the wrap alone where the
    grid has no bounded halo), and the hydrostatic surfaces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid, n = BENCH_FILLS[case]()
    gen = torch.Generator(device="cuda").manual_seed(14)
    fields = [torch.randn(grid.padded_shape, generator=gen, dtype=grid.dtype,
                          device="cuda") for _ in range(n)]
    bounded = any(t == "bounded" and h > 0
                  for t, h in zip(grid.topology, grid.H))
    check_fill(grid, fields, rotated_locs_bcs(n) if bounded else None)
    if case.startswith("hydrostatic"):
        del fields
        surfaces = [torch.randn(grid.padded_shape[:2] + (1,), generator=gen,
                                dtype=grid.dtype, device="cuda")
                    for _ in range(3)]
        locs = (("c", "c", "c"), ("f", "c", "c"), ("c", "f", "c"))
        check_fill(grid, surfaces, [
            (loc, regularize_field_boundary_conditions(None, grid, loc))
            for loc in locs])


@pytest.mark.parametrize("case", ["z_compact", "closure"])
def test_twelve_tracer_model_steps(case):
    """A 12-tracer model steps on the card through the kernels and matches
    its plain route: the z-compact fused update (no closure) and the padded
    tendency route (a closure); 2 steps, bound 1e-12 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import contextlib
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    import oceananigans_tpu_torch.models.nonhydrostatic as nh
    names = tuple(f"c{i}" for i in range(NT))
    n = (16, 16, 16)

    def run(plain):
        grid = ot.RectilinearGrid(size=n, extent=(1.0, 1.0, 1.0),
                                  dtype=torch.float64, device="cuda")
        kw = dict(closure=ot.ScalarDiffusivity(nu=1e-3, kappa=1e-3)) \
            if case == "closure" else {}
        m = ot.NonhydrostaticModel(
            grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
            tracers=names, **kw)
        gen = torch.Generator().manual_seed(12)
        m.set(u=0.1 * torch.randn(n, generator=gen, dtype=torch.float64),
              v=0.1 * torch.randn(n, generator=gen, dtype=torch.float64),
              **{c: torch.rand(n, generator=gen, dtype=torch.float64)
                 for c in names})
        with contextlib.ExitStack() as stack:
            if plain:
                for mod, name, fn in (
                        (nh, "fused_advection_update",
                         K.fused_advection_update_plain),
                        (nh, "fused_advection_tendency",
                         K.fused_advection_tendency_plain),
                        (nh, "fused_divergence", K.fused_divergence_plain),
                        (nh, "fused_correct", K.fused_correct_plain),
                        (nh, "periodic_halo_fill", K.periodic_halo_fill_plain),
                        (hf, "fill_halos", K.fill_halos_plain)):
                    stack.enter_context(_patched(mod, name, fn))
            for _ in range(2):
                m.time_step(1e-3)
        return m

    K.reset_counters()
    kern = run(False)
    launches = K.counters()[0]
    key = ("fused_advection_update" if case == "z_compact"
           else "fused_advection_tendency")
    assert launches[key] > 0
    plain = run(True)
    for name in ("u", "v", "w") + names:
        _close([kern.field(name).interior], [plain.field(name).interior])


def _patched(mod, name, fn):
    import contextlib

    @contextlib.contextmanager
    def swap():
        saved = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, saved)
    return swap()


# -- bfloat16 WENO smoothness in #1, #6 and #8 ---------------------------------------
#
# Float32 fields with bfloat16 smoothness, each kernel against its plain
# version on the same inputs. The smoothness arithmetic rounds each
# operation to bfloat16 in both (the same operands, so the same bits); what
# differs is the float32 stencil and flux arithmetic (FMA contraction, another
# association order): bound 1e-5 relative to max|plain| per tensor. The
# check must tell bfloat16 from float32 smoothness, so for each tendency
# that a WENO reconstruction enters (not h's, and not the updated fields,
# where Δt scales the difference down) the bound is also held to at most a
# tenth of the plain version's bf16-vs-float32 difference on the same
# inputs. The deferred correction is checked with p = 0 and with a random
# p: with bfloat16 smoothness the kernel rounds the correction's product
# and difference apart, as the plain version does, so the corrected
# velocities are the same bits and the same bound holds.

BF16_REL = 1e-5


def _bf16_close(got, want, want_f32, separated, rel=BF16_REL):
    """``separated``: the indices of the tendencies a WENO reconstruction
    enters."""
    for n, (a, b, c) in enumerate(zip(got, want, want_f32)):
        bound = rel * b.abs().max().item()
        if n in separated:
            assert bound <= 0.1 * (b - c).abs().max().item(), ("loose", n)
        assert (a - b).abs().max().item() <= bound, n


@pytest.fixture(scope="module")
def bf16_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for layout, halo in (("compact", (4, 4, 0)), ("padded", (3, 3, 3))):
        grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo,
                                  dtype=torch.float32, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(9)
        f = [0.1 * torch.randn(grid.padded_shape, generator=gen,
                               device="cuda") for _ in range(3)]
        f += [torch.rand(grid.padded_shape, generator=gen, device="cuda")
              for _ in range(2)]
        if layout == "compact":
            f[2][..., 0] = 0
        K.periodic_halo_fill(grid, f)
        Gm = [torch.randn(N, generator=gen, device="cuda") for _ in range(5)]
        out[layout] = (grid, f, Gm)
        if layout == "compact":
            p = torch.randn(grid.padded_shape, generator=gen, device="cuda")
            K.periodic_halo_fill(grid, [p])
            out["p"] = p
    return out


def _smooth(dtype):
    return ot.WENO(5, smoothness_dtype=dtype)


@pytest.mark.parametrize("with_gm", [False, True])
@pytest.mark.parametrize("corr", [None, "p=0", "p"])
def test_fused_advection_update_bf16(bf16_inputs, with_gm, corr):
    grid, f, Gm = bf16_inputs["compact"]
    tracers = {"c0": f[3], "c1": f[4]}
    p = {None: None, "p=0": torch.zeros_like(f[0]),
         "p": bf16_inputs["p"]}[corr]

    def run(fn, dtype):
        G, new = fn(grid, _smooth(dtype), *f[:3], Gm if with_gm else None,
                    1e-3, -5e-4, p, None if p is None else 7e-4,
                    tracers=tracers)
        return list(G) + list(new.values())

    _bf16_close(run(K.fused_advection_update, torch.bfloat16),
                run(K.fused_advection_update_plain, torch.bfloat16),
                run(K.fused_advection_update_plain, torch.float32), range(5))


@pytest.mark.parametrize("layout", ["compact", "padded"])
def test_fused_advection_tendency_bf16(bf16_inputs, layout):
    grid, f, _ = bf16_inputs[layout]
    _bf16_close(
        list(K.fused_advection_tendency(grid, _smooth(torch.bfloat16), f)),
        list(K.fused_advection_tendency_plain(grid, _smooth(torch.bfloat16),
                                              f)),
        list(K.fused_advection_tendency_plain(grid, _smooth(torch.float32),
                                              f)), range(5))


def test_fused_sw_update_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=SW_N, extent=(10.0, 8.0), halo=(4, 4, 0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(10)
    shape = grid.padded_shape
    # a nearly flat h: the advection, not the head gradient, sets the size
    # of the momentum tendencies
    fields = {n: o + s * torch.randn(shape, generator=gen, device="cuda")
              for n, s, o in (("uh", 0.1, 0.0), ("vh", 0.1, 0.0),
                              ("h", 1e-4, 1.0), ("c", 1.0, 0.0))}
    hB = 1e-4 * torch.randn(shape, generator=gen, device="cuda")
    K.periodic_halo_fill(grid, list(fields.values()) + [hB])
    ints = grid.interior_slices

    def run(fn, dtype):
        G, new = fn(grid, _smooth(dtype), 9.81, 0.3, hB, tuple(fields),
                    fields, None, 2e-3, 0.0)
        return list(G) + [new[n][ints] for n in new]

    _bf16_close(run(K.fused_sw_update, torch.bfloat16),
                run(K.fused_sw_update_plain, torch.bfloat16),
                run(K.fused_sw_update_plain, torch.float32), (0, 1, 3))


def test_bf16_smoothness_float64_fields_raises(inputs):
    grid, u, v, w, _, _ = inputs
    with pytest.raises(TypeError, match="float32 fields"):
        K.fused_advection_update(grid, _smooth(torch.bfloat16), u, v, w,
                                 None, 0.1, 0.0)


# -- the vector-unit probes (#12) ------------------------------------------------------
#
# Each probe kernel against its plain version on numpy's default_rng(0)
# normals, with the fold-back factor 1.0 and 3 passes (the timed runs'
# 1e-20 leaves the slab equal to its input); the FMA chain on 0.01 times the
# slab, where its powers of the slab stay finite over the passes. Bound 1e-5 relative to
# max|plain|: float32 roundoff of FMA contraction, and the approximate
# reciprocal's ~1 ulp in the weights (its plain version divides exactly).
# The repro's bfloat16 smoothness rounds as its plain version does, so the
# same bound holds, at most a tenth of its bf16-vs-float32 difference.

PROBE_REL = 1e-5


def _probe_slab(shape, scale=1.0):
    import numpy as np
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    return torch.as_tensor(scale * x).cuda()


def _probe_close(got, want):
    assert torch.isfinite(want).all()
    assert (got - want).abs().max().item() <= PROBE_REL * want.abs().max().item()


@pytest.mark.parametrize("k", [8, 16, 32])
def test_weno_microbench(k):
    x = _probe_slab((64, 64))
    _probe_close(K.weno_microbench(x, k, reps=3, fold=1.0),
                 K.weno_microbench_plain(x, k, reps=3, fold=1.0))


@pytest.mark.parametrize("body", ["fma_chain", "weno_nodiv", "weno_true",
                                  "weno_recip", "weno_approx_recip"])
def test_vpu_mix(body):
    x = _probe_slab((64, 64), 0.01 if body == "fma_chain" else 1.0)
    _probe_close(K.vpu_mix(x, body, reps=3, fold=1.0),
                 K.vpu_mix_plain(x, body, reps=3, fold=1.0))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_smoothness_probe(dtype):
    x = _probe_slab((256, 256))
    want = K.bf16_smoothness_plain(x, getattr(torch, dtype))
    _probe_close(K.bf16_smoothness(x, getattr(torch, dtype)), want)
    if dtype == "bfloat16":
        diff = (want - K.bf16_smoothness_plain(x, torch.float32)).abs().max()
        assert PROBE_REL * want.abs().max().item() <= 0.1 * diff.item()


# -- the block-tiled #1 and #8 at the tile edges -------------------------------------
#
# Interiors that the kernels' tiles (#1: 8x8x16 at float32, 8x8x8 at
# float64; #8: 32x32 at float32, 16x32 at float64) do not divide, an Nz so
# small that the WENO-5, WENO-3 and upwind cascade fills the column, and
# component counts on both sides of a launch's batch of 32: each kernel
# against its plain version at the bounds above (float64: 1e-12 relative;
# bfloat16 smoothness with float32 fields: 1e-5 relative, held to a tenth of
# the bf16-vs-float32 difference for the tendencies a reconstruction
# enters). #1 always advects u, v and w, so its component counts are 3 plus
# 0, 1, 12 and 37 tracers.

TILE_N = [(37, 29, 19), (12, 10, 5)]
TILE_TRACERS = [0, 1, 12, 37]


def _tile_adv_inputs(N, dtype, ntr, seed):
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=(4, 4, 0),
                              dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = [0.1 * torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                           device="cuda") for _ in range(4)]
    f[2][..., 0] = 0
    tracers = {f"c{i}": torch.rand(grid.padded_shape, generator=gen,
                                   dtype=dtype, device="cuda")
               for i in range(ntr)}
    K.periodic_halo_fill(grid, f + list(tracers.values()))
    Gm = [torch.randn(N, generator=gen, dtype=dtype, device="cuda")
          for _ in range(3 + ntr)]
    return grid, f, tracers, Gm


@pytest.mark.parametrize("with_gm", [False, True], ids=["no_gm", "gm"])
@pytest.mark.parametrize("with_corr", [False, True], ids=["stage1", "corr"])
@pytest.mark.parametrize("ntr", TILE_TRACERS)
@pytest.mark.parametrize("n", TILE_N, ids=str)
@pytest.mark.parametrize("smooth", ["float64", "bf16"])
def test_fused_advection_update_tile_edges(smooth, n, ntr, with_corr,
                                           with_gm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dtype = torch.float64 if smooth == "float64" else torch.float32
    grid, (u, v, w, p), tracers, Gm = _tile_adv_inputs(n, dtype, ntr, 21)

    def run(fn, sdt):
        G, new = fn(grid, ot.WENO(5, smoothness_dtype=sdt), u, v, w,
                    Gm if with_gm else None, 1e-3, -5e-4,
                    p if with_corr else None, 7e-4 if with_corr else None,
                    tracers=tracers)
        return list(G) + list(new.values())

    launches = K.fused_advection_update.launches
    got = run(K.fused_advection_update, torch.float64 if smooth == "float64"
              else torch.bfloat16)
    assert K.fused_advection_update.launches == launches + len(
        K.build.batches(3 + ntr))
    if smooth == "float64":
        _close(got, run(K.fused_advection_update_plain, torch.float64))
    else:
        _bf16_close(got, run(K.fused_advection_update_plain, torch.bfloat16),
                    run(K.fused_advection_update_plain, torch.float32),
                    range(3 + ntr))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_fused_advection_update_tile_edges_centered2(scheme):
    """Both schemes on the ragged float64 grid with 12 tracers, corrected
    with G⁻ (Centered(2) takes a ring of 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid, (u, v, w, p), tracers, Gm = _tile_adv_inputs(TILE_N[0],
                                                       torch.float64, 12, 22)
    args = (grid, SCHEMES[scheme](), u, v, w, Gm, 0.1, -0.05, p, 0.07)
    Gk, nk = K.fused_advection_update(*args, tracers=tracers)
    Gp, np_ = K.fused_advection_update_plain(*args, tracers=tracers)
    _close(Gk + list(nk.values()), Gp + list(np_.values()))


SW_TILE_N = [(45, 61), (9, 130)]


def _tile_sw_inputs(n, dtype, ntr, seed, extent=(10.0, 8.0)):
    grid = ot.RectilinearGrid(size=n, extent=extent, halo=(4, 4, 0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = grid.padded_shape
    # a nearly flat h: the advection, not the head gradient, sets the size
    # of the momentum tendencies (so the bf16 check can see the smoothness)
    fields = {n_: o + s * torch.randn(shape, generator=gen, dtype=dtype,
                                      device="cuda")
              for n_, s, o in (("uh", 0.1, 0.0), ("vh", 0.1, 0.0),
                               ("h", 1e-4, 1.0))}
    for i in range(ntr):
        fields[f"c{i}"] = torch.rand(shape, generator=gen, dtype=dtype,
                                     device="cuda")
    hB = 1e-4 * torch.randn(shape, generator=gen, dtype=dtype, device="cuda")
    K.periodic_halo_fill(grid, list(fields.values()) + [hB])
    Gm = torch.randn((len(fields),) + tuple(grid.N), generator=gen,
                     dtype=dtype, device="cuda")
    return grid, fields, hB, Gm


@pytest.mark.parametrize("with_gm", [False, True], ids=["no_gm", "gm"])
@pytest.mark.parametrize("f", [0.0, 0.3])
@pytest.mark.parametrize("ntr", [0, 1, 33])
@pytest.mark.parametrize("n", SW_TILE_N, ids=str)
@pytest.mark.parametrize("smooth", ["float64", "bf16"])
def test_fused_sw_update_tile_edges(smooth, n, ntr, f, with_gm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dtype = torch.float64 if smooth == "float64" else torch.float32
    grid, fields, hB, Gm = _tile_sw_inputs(n, dtype, ntr, 23)
    names = tuple(fields)
    ints = grid.interior_slices

    def run(fn, sdt):
        G, new = fn(grid, ot.WENO(5, smoothness_dtype=sdt), 9.81, f, hB,
                    names, fields, Gm if with_gm else None, 2e-3, -1e-3)
        return list(G) + [new[n_][ints] for n_ in names]

    launches = K.fused_sw_update.launches
    got = run(K.fused_sw_update, torch.float64 if smooth == "float64"
              else torch.bfloat16)
    assert K.fused_sw_update.launches == launches + len(
        K.build.batches(len(names)))
    if smooth == "float64":
        _close(got, run(K.fused_sw_update_plain, torch.float64))
    else:
        _bf16_close(got, run(K.fused_sw_update_plain, torch.bfloat16),
                    run(K.fused_sw_update_plain, torch.float32),
                    (0, 1) + tuple(range(3, 3 + ntr)))


def test_sharded_sw_stage_tile_grid():
    """#9 on a 90x122 grid over 2x2 blocks of 45x61: the blocks' 16x32
    float64 tiles fall differently from the serial grid's, and every face
    flux takes one code path wherever it lies in a tile, so the sharded
    stage equals the serial stage bit for bit."""
    arch = _card_mesh()
    grid, fields, hB, Gm = _tile_sw_inputs((90, 122), torch.float64, 2, 24,
                                           extent=(20.0, 16.0))
    names = tuple(fields)
    s = ot.WENO(5, smoothness_dtype=torch.float64)
    args = (grid, s, 9.81, 0.3, hB, names)
    stage = K.build_sharded_fused_sw_update(*args, arch.mesh)
    G0, new0 = K.fused_sw_update(*args, fields, None, 2e-3, -1e-3)
    G1, new1 = stage(arch.scatter(fields, grid.H), None, 2e-3, -1e-3)
    nlx, nly = 45, 61
    ints = grid.interior_slices
    assert torch.equal(_stitch(G1, (2, 2)), G0)
    for n_ in names:
        assert torch.equal(_stitch([b[n_] for b in new1], (2, 2), grid.H),
                           new0[n_][ints])
    Gs = [_on(Gm[:, i * nlx:(i + 1) * nlx, j * nly:(j + 1) * nly], "cuda:0")
          for i in range(2) for j in range(2)]
    Gm_full = _stitch(Gs, (2, 2))
    G2, new2 = stage(arch.scatter(fields, grid.H), Gs, 2e-3, -1e-3)
    G3, new3 = K.fused_sw_update(*args, fields, Gm_full, 2e-3, -1e-3)
    assert torch.equal(_stitch(G2, (2, 2)), G3)
    for n_ in names:
        assert torch.equal(_stitch([b[n_] for b in new2], (2, 2), grid.H),
                           new3[n_][ints])


# -- the block-tiled #6 and #10 at the tile edges ------------------------------------
#
# #6 shares #1's tiles (8x8x8 at float64, 16x8x8 at float32): in both
# layouts on the interiors above, across 4 and 40 components (40 in two
# launches), in float64 (1e-12 relative) and with bfloat16 smoothness (held
# to a tenth of the bf16-vs-float32 difference); the sharded tendency on a
# grid whose blocks' tiles fall unlike the serial grid's, bit for bit. #10
# (8x8x8 at float64 over the interior plus the boundary-face rows) on
# ragged tiles with bounded x and y, 3 and 8 tracers (1e-12), and in float32
# (2e-5 relative, the bound chip_smoke.py holds the path's float32 kernel to:
# a one-ulp change of a float32 smoothness ratio, squared, moves a nonlinear
# weight by a few ulp).

def _tile_tendency_inputs(n, dtype, ntr, layout, seed):
    halo = (4, 4, 0) if layout == "compact" else (3, 3, 3)
    grid = ot.RectilinearGrid(size=n, extent=(1.0, 1.0, 1.0), halo=halo,
                              dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = [0.1 * torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                           device="cuda") for _ in range(3)]
    f += [torch.rand(grid.padded_shape, generator=gen, dtype=dtype,
                     device="cuda") for _ in range(ntr)]
    K.periodic_halo_fill(grid, f)
    if layout == "compact":
        f[2][..., 0] = 0
    else:
        specs = [K.ZFill(False, (0, 0.0), (0, 0.0))] * 2 + [
            K.ZFill(True, (1, 0.0), (1, 0.0))] + [
            K.ZFill(False, (2, 0.5), (2, -0.5))] * ntr
        K.bounded_z_fill_plain(grid, f, specs)
    return grid, f


@pytest.mark.parametrize("ntr", [1, 37])
@pytest.mark.parametrize("n", TILE_N, ids=str)
@pytest.mark.parametrize("layout", ["compact", "padded"])
@pytest.mark.parametrize("smooth", ["float64", "bf16"])
def test_fused_advection_tendency_tile_edges(smooth, layout, n, ntr):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dtype = torch.float64 if smooth == "float64" else torch.float32
    grid, f = _tile_tendency_inputs(n, dtype, ntr, layout, 25)

    def run(fn, sdt):
        return list(fn(grid, ot.WENO(5, smoothness_dtype=sdt), f))

    launches = K.fused_advection_tendency.launches
    got = run(K.fused_advection_tendency, torch.float64
              if smooth == "float64" else torch.bfloat16)
    assert K.fused_advection_tendency.launches == launches + len(
        K.build.batches(3 + ntr))
    if smooth == "float64":
        _close(got, run(K.fused_advection_tendency_plain, torch.float64))
    else:
        _bf16_close(got, run(K.fused_advection_tendency_plain,
                             torch.bfloat16),
                    run(K.fused_advection_tendency_plain, torch.float32),
                    range(3 + ntr))


@pytest.mark.parametrize("layout", ["compact", "padded"])
def test_fused_advection_tendency_tile_edges_centered2(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid, f = _tile_tendency_inputs(TILE_N[0], torch.float64, 12, layout, 26)
    s = ot.Centered(2)
    _close(list(K.fused_advection_tendency(grid, s, f)),
           list(K.fused_advection_tendency_plain(grid, s, f)))


@pytest.mark.parametrize("layout", ["compact", "padded"])
def test_sharded_tendency_tile_grid(layout):
    """#7 on a 74x58x19 grid over 2x2 blocks of 37x29: the blocks' 8x8x8
    float64 tiles fall differently from the serial grid's, and every face
    flux takes one code path wherever it lies in a tile, so the sharded
    tendency equals the serial one bit for bit."""
    arch = _card_mesh()
    grid, f = _tile_tendency_inputs((74, 58, 19), torch.float64, 2, layout,
                                    27)
    s = ot.WENO(5, smoothness_dtype=torch.float64)
    G = _stitch(K.build_sharded_fused_advection(grid, s, arch.mesh)(
        arch.scatter(f, grid.H)), (2, 2))
    assert torch.equal(G, K.fused_advection_tendency(grid, s, f))


VI_TILE_N = [(19, 13, 11), (9, 7, 7)]


@pytest.mark.parametrize("ntr", [3, 8])
@pytest.mark.parametrize("topology", [("bounded", "bounded", "bounded"),
                                      ("periodic", "bounded", "bounded")],
                         ids=["bounded_xy", "periodic_x"])
@pytest.mark.parametrize("n", VI_TILE_N, ids=str)
@pytest.mark.parametrize("config", sorted(VI_CONFIGS))
def test_fused_vi_tendency_tile_edges(config, n, topology, ntr):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=n, extent=(4e5, 2.4e5, 1800.0),
                              halo=(6, 6, 6), topology=topology,
                              dtype=torch.float64, device="cuda")
    names = tuple(f"c{i}" for i in range(ntr))
    grid, f = _vi_inputs(None, grid=grid, tracers=names)
    vi, ts = VI_CONFIGS[config]()
    launches = K.fused_vi_tendency.launches
    _vi_compare(grid, f, vi, ts, names, ot.FPlane(f=1e-4), True)
    assert K.fused_vi_tendency.launches == launches + 1


def test_fused_vi_tendency_tile_edges_float32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.LatitudeLongitudeGrid(size=(37, 21, 13), longitude=(0, 60),
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    halo=(6, 6, 6), dtype=torch.float32,
                                    device="cuda")
    grid64, f = _vi_inputs(None, grid=_latlon_like(grid), tracers=("T",))
    f = {k: a.float() for k, a in f.items()}
    vi = ot.WENOVectorInvariant()
    args = (grid, vi, ot.Centered(2), ("T",),
            ot.HydrostaticSphericalCoriolis(), f["u"], f["v"], f["w"],
            {"T": f["T"]}, None)
    Gu, Gv, Gc = K.fused_vi_tendency(*args)
    Pu, Pv, Pc = K.fused_vi_tendency_plain(*args)
    for a, b in ((Gu, Pu), (Gv, Pv), (Gc["T"], Pc["T"])):
        assert (a - b).abs().max().item() <= 2e-5 * b.abs().max().item()


def _latlon_like(grid):
    return ot.LatitudeLongitudeGrid(size=grid.N, longitude=(0, 60),
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    halo=grid.H, dtype=torch.float64,
                                    device="cuda")


# -- #6 on a flat and a periodic z, and the periodic-z fill -------------------

Z_MODE_SCHEMES = {
    "WENO(5)": lambda: ot.WENO(5, smoothness_dtype=torch.float64),
    "WENO(9)": lambda: ot.WENO(9, smoothness_dtype=torch.float64),
    "UpwindBiased(5)": lambda: ot.UpwindBiased(5),
    "Centered(2)": lambda: ot.Centered(2),
}
Z_MODE_GRIDS = {
    # interiors no flat tile (32 x 32 x 1) or periodic tile (8 x 8 x 8)
    # divides
    "flat": (("periodic", "periodic", "flat"), (45, 37, 1)),
    "periodic": (("periodic", "periodic", "periodic"), (19, 13, 30)),
}


def z_mode_inputs(zmode, scheme, ntr, dtype=torch.float64, seed=5):
    """u, v, w and ``ntr`` tracers on a grid of the z mode, halos filled
    (the fill kernel: x, y and, on a periodic z, z wrap)."""
    topo, N = Z_MODE_GRIDS[zmode]
    r = scheme.required_halo
    flat = zmode == "flat"
    grid = ot.RectilinearGrid(
        size=N[:2] if flat else N, topology=topo,
        extent=(1.0, 2.0) if flat else (1.0, 2.0, 0.5),
        halo=(r, r) if flat else (r, r, r), dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = [0.1 * torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                           device="cuda") for _ in range(3 + ntr)]
    K.fill_halos(grid, f)
    return grid, f


@pytest.mark.parametrize("ntr", [1, 37])
@pytest.mark.parametrize("scheme", sorted(Z_MODE_SCHEMES))
@pytest.mark.parametrize("zmode", sorted(Z_MODE_GRIDS))
def test_fused_advection_tendency_z_modes(zmode, scheme, ntr):
    """#6 on a flat z (no z flux, one-level tiles) and on a periodic z (the
    padded layout with wrapped z halos, no cascade) against its plain
    version in float64 at 1e-12, on interiors the tiles do not divide, 4
    and 40 components (two launches); each launch counted in its z
    variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from oceananigans_tpu_torch.kernels import fused_advection as fa
    s = Z_MODE_SCHEMES[scheme]()
    grid, f = z_mode_inputs(zmode, s, ntr)
    K.reset_counters()
    got = K.fused_advection_tendency(grid, s, f)
    want = K.fused_advection_tendency_plain(grid, s, f)
    for g, w in zip(got, want):
        scale = max(w.abs().max().item(), 1e-300)
        assert (g - w).abs().max().item() / scale <= TOL
    variant = fa.variant_name(s) + "_z" + zmode
    assert fa.fused_advection_tendency.variant_launches[variant] == \
        len(fa.launch_plan(grid, s, torch.float64, 3 + ntr)["launches"])


def test_fused_advection_tendency_flat_tile():
    """A flat z takes a one-level tile whose cells fill a block (32 x 32 x 1
    at float32 and float64), with no z reach in its shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from oceananigans_tpu_torch.kernels import fused_advection as fa
    grid, _ = z_mode_inputs("flat", ot.WENO(5), 0, torch.float32)
    plan = fa.launch_plan(grid, ot.WENO(5), torch.float32, 3)
    assert plan["tile"] == (32, 32, 1)
    assert plan["launches"][0][2] == fa.smem_bytes((32, 32, 1), 3, 4, False,
                                                   flat=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("topology", [
    ("periodic", "periodic", "periodic"), ("periodic", "flat", "periodic"),
    ("bounded", "bounded", "periodic"), ("periodic", "flat", "bounded"),
    ("flat", "flat", "bounded"), ("bounded", "periodic", "bounded")],
    ids="-".join)
def test_fill_halos_periodic_z_and_flat(topology, dtype):
    """The fill kernel on a periodic z (the z wrap in the same launch as x
    and y, corners included) and with flat axes, against
    fill_halos_plain bit for bit: every location under four rotations of
    the conditions on the bounded sides, and the wrap alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    classes = (bcm.FLUX, bcm.OPEN, bcm.VALUE, bcm.GRADIENT)
    sides = ("west", "east", "south", "north", "bottom", "top")
    N = tuple(1 if t == "flat" else n for t, n in zip(topology, (13, 9, 11)))
    keep = [ax for ax in range(3) if topology[ax] != "flat"]
    grid = ot.RectilinearGrid(
        size=tuple(N[ax] for ax in keep), topology=topology,
        extent=tuple((1.0, 2.0, 0.5)[ax] for ax in keep),
        halo=tuple((3, 2, 4)[ax] for ax in keep), dtype=dtype,
        device="cuda")
    lbs = []
    for r in range(4):
        for loc in (("c", "c", "c"), ("f", "c", "c"), ("c", "f", "c"),
                    ("c", "c", "f")):
            kw = {}
            for s, side in enumerate(sides):
                topo = topology[s // 2]
                if topo == "bounded":
                    kw[side] = BoundaryCondition(classes[(s + r) % 4],
                                                 0.1 * (s + 1) * (-1) ** s)
                elif topo == "periodic":
                    kw[side] = bcm.PeriodicBoundaryCondition()
            lbs.append((loc, FieldBoundaryConditions(**kw)))
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = [torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                     device="cuda") for _ in lbs]
    got = K.fill_halos(grid, [x.clone() for x in a], lbs)
    want = K.fill_halos_plain(grid, [x.clone() for x in a], lbs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = K.fill_halos(grid, [x.clone() for x in a[:3]])
    want = K.periodic_halo_fill_plain(grid, [x.clone() for x in a[:3]])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("topology", [
    ("periodic", "periodic", "periodic"), ("periodic", "periodic", "flat")],
    ids="-".join)
def test_model_z_modes_card_against_cpu(topology):
    """The NonhydrostaticModel on a triply periodic and a flat-z grid (#6
    in its z variant, the fill kernel, the FFT solve on the card) over 3
    steps in float64 against the same model on the CPU (the plain route):
    1e-10 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flat = topology[2] == "flat"
    size = (16, 16) if flat else (16, 16, 16)
    extent = (1.0, 1.0) if flat else (1.0, 1.0, 1.0)
    rng = np.random.default_rng(3)
    N = (16, 16, 1) if flat else (16, 16, 16)
    u0, v0 = 0.1 * rng.standard_normal(N), 0.1 * rng.standard_normal(N)
    models = []
    for device in ("cuda", "cpu"):
        grid = ot.RectilinearGrid(size=size, extent=extent, topology=topology,
                                  dtype=torch.float64, device=device)
        m = ot.NonhydrostaticModel(grid, advection=ot.WENO(
            5, smoothness_dtype=torch.float64), tracers=("c",))
        m.set(u=u0, v=v0, c=u0)
        for _ in range(3):
            m.time_step(1e-2)
        models.append(m)
    for name in ("u", "v", "w", "c", "p"):
        a = models[0].field(name).interior.cpu()
        b = models[1].field(name).interior
        scale = max(b.abs().max().item(), 1e-12)
        assert (a - b).abs().max().item() / scale <= 1e-10, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_fill_halos_cubed_sphere(dtype):
    """The z fill of the cubed sphere's concatenated panels (x and y are
    FULLY_CONNECTED: kept; the x extent holds every panel's halos) against
    the plain fill, bit for bit: u, v, w and a tracer with the default z
    conditions and a tracer with a Value bottom and a Gradient top, one
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from oceananigans_tpu_torch.grids.cubed_sphere import concat_panels_grid
    cs = ot.ConformalCubedSphereGrid((6, 6, 4), z=(-100.0, 0.0), dtype=dtype,
                                     device="cuda")
    grid = concat_panels_grid(cs.panel_grids)
    assert grid.padded_shape[0] == 6 * cs.panel_grids[0].padded_shape[0]
    locs = (("f", "c", "c"), ("c", "f", "c"), ("c", "c", "f"),
            ("c", "c", "c"), ("c", "c", "c"))
    user = FieldBoundaryConditions(
        bottom=ot.ValueBoundaryCondition(0.5),
        top=ot.GradientBoundaryCondition(-0.1))
    lbs = [(loc, regularize_field_boundary_conditions(
        user if k == 4 else None, grid, loc)) for k, loc in enumerate(locs)]
    codes = hf.fill_codes(grid, grid.padded_shape, lbs, len(lbs))
    assert all(c[0][0] == hf.KEEP and c[1][0] == hf.KEEP for c in codes)
    gen = torch.Generator(device="cuda").manual_seed(20)
    fields = [torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                          device="cuda") for _ in lbs]
    check_fill(grid, fields, lbs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_fill_halos_bickley(dtype):
    """The shallow-water fields of the Bickley jet (periodic x, bounded y,
    flat z): uh, vh, h and a tracer with the default conditions, and with
    Value, Gradient and Flux on the bounded sides, against the plain fill
    (the wrap and the bounded y in one launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=(32, 24), x=(0, 2 * np.pi), y=(-10, 10),
                              topology=("periodic", "bounded", "flat"),
                              halo=(4, 4), dtype=dtype, device="cuda")
    locs = (("f", "c", "c"), ("c", "f", "c"), ("c", "c", "c"),
            ("c", "c", "c"), ("c", "c", "c"), ("f", "c", "c"))
    users = {3: FieldBoundaryConditions(
        south=ot.ValueBoundaryCondition(0.5),
        north=ot.GradientBoundaryCondition(0.1)),
        4: FieldBoundaryConditions(north=ot.FluxBoundaryCondition(1e-3)),
        5: FieldBoundaryConditions(north=ot.ValueBoundaryCondition(0.2))}
    lbs = [(loc, regularize_field_boundary_conditions(users.get(k), grid,
                                                      loc))
           for k, loc in enumerate(locs)]
    gen = torch.Generator(device="cuda").manual_seed(21)
    fields = [torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                          device="cuda") for _ in lbs]
    a = [f.clone() for f in fields]
    b = [f.clone() for f in fields]
    K.fill_halos(grid, a, lbs)
    K.fill_halos_plain(grid, b, lbs)
    masks = hf.extrapolated_slots(grid, grid.padded_shape, lbs)
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    for x, y, m in zip(a, b, masks):
        m = m.to(x.device)
        assert torch.equal(x[~m], y[~m])
        if m.any():
            assert (x[m] - y[m]).abs().max().item() <= \
                tol * max(y.abs().max().item(), 1.0)


def test_cubed_sphere_models_card_against_cpu():
    """The cubed-sphere hydrostatic model (split-explicit, the fill kernel
    on its z halos) and shallow-water model, 3 steps in float64 on the card
    against the same models on the CPU: 1e-10 of each field's scale; no
    plain fill ran on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    results = {}
    plain0 = K.fill_halos_plain.cuda_calls
    for device in ("cuda", "cpu"):
        g = ot.ConformalCubedSphereGrid((6, 6, 4), z=(-1000.0, 0.0),
                                        radius=6.371e6, dtype=torch.float64,
                                        device=device)
        m = ot.CubedSphereHydrostaticModel(
            g, tracers=("b",), rotation_rate=7.292e-5,
            free_surface="split_explicit", substeps=10)
        m.set(b=lambda lam, phi, z: 2e-5 * z
              + 1e-4 * np.exp(-(lam ** 2 + phi ** 2) / 0.2))
        m.set_geographic(u_east=lambda lam, phi: 2.0 * np.cos(phi))
        sw = ot.CubedSphereShallowWaterModel(
            ot.ConformalCubedSphereGrid((6, 6), radius=6.371e6,
                                        dtype=torch.float64, device=device),
            gravity=9.81, rotation_rate=7.292e-5)
        sw.set_geographic(h=lambda lam, phi: 1000.0 + 10 * np.sin(phi),
                          u_east=lambda lam, phi: 5.0 * np.cos(phi))
        for _ in range(3):
            m.time_step(300.0)
            sw.time_step(100.0)
        results[device] = {n: f.interior.cpu() for n, f in
                           {**m.fields, **{"sw_" + k: sw.field(k) for k in
                                           ("h", "u", "v")}}.items()}
    assert K.fill_halos_plain.cuda_calls == plain0
    for name, b in results["cpu"].items():
        a = results["cuda"][name]
        scale = max(b.abs().max().item(), 1e-12)
        assert (a - b).abs().max().item() / scale <= 1e-10, name


# -- the bounded #6 and the ensemble --------------------------------------------
# The padded tendency with the bounds-preserving limiter
# (csrc/bounded_limiter.cuh) against its plain version: u, v, w and two
# step-function tracers on interiors no tile divides, a bounded z (the
# cascade), a periodic and a flat z, WENO(5) and WENO(9); float64 with
# float64 smoothness at 1e-12 of max|plain|, and float32 fields, or float64
# fields with WENO's default float32 smoothness, at 1e-5 of each
# component's max|plain| (the smoothness arithmetic rounds in float32; the
# kernels build with -fmad=false and divide exactly). An EnsembleModel's
# member equals its solo run bit for bit.

BOUNDED_SHAPE = (19, 13, 21)


def _bounded_inputs(topology, dtype, seed=5):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 2 if topology[2] == "flat" else 3
    grid = ot.RectilinearGrid(size=BOUNDED_SHAPE[:n],
                              extent=(1.0, 2.0, 1.5)[:n], halo=(6,) * n,
                              topology=topology, dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fields = [0.1 * torch.randn(grid.padded_shape, generator=gen,
                                dtype=dtype, device="cuda")
              for _ in range(3)]
    fields += [(torch.rand(grid.padded_shape, generator=gen, dtype=dtype,
                           device="cuda") > 0.5).to(dtype)
               for _ in range(2)]
    locs = ((("f", "c", "c")), ("c", "f", "c"), ("c", "c", "f"),
            ("c", "c", "c"), ("c", "c", "c"))
    from oceananigans_tpu_torch.boundary_conditions import \
        fill_all_halo_regions
    fill_all_halo_regions(fields, grid, [
        (loc, regularize_field_boundary_conditions(None, grid, loc))
        for loc in locs])
    return grid, fields


@pytest.mark.parametrize("order", [5, 9])
@pytest.mark.parametrize("dtypes", [(torch.float64, torch.float64),
                                    (torch.float32, torch.float32),
                                    (torch.float64, torch.float32)],
                         ids=["float64", "float32", "float64_f32smooth"])
@pytest.mark.parametrize("topology", [("periodic", "periodic", "bounded"),
                                      ("periodic", "periodic", "periodic"),
                                      ("periodic", "periodic", "flat")],
                         ids=["bounded_z", "periodic_z", "flat_z"])
def test_bounded_tendency(topology, dtypes, order):
    dtype, smooth = dtypes
    grid, fields = _bounded_inputs(topology, dtype)
    scheme = ot.WENO(order, smoothness_dtype=smooth, bounds=(0.0, 1.0))
    K.reset_counters()
    Gk = K.fused_advection_tendency(grid, scheme, fields)
    launches, _ = K.counters()
    Gp = K.fused_advection_tendency_plain(grid, scheme, fields)
    bound = TOL if smooth == torch.float64 else 1e-5
    for k in range(len(fields)):
        err = (Gk[k] - Gp[k]).abs().max().item()
        assert err <= bound * Gp[k].abs().max().item(), (k, err)
    name = f"fused_advection_tendency_weno{order}_bounded" + {
        "bounded": "", "periodic": "_zperiodic", "flat": "_zflat"}[
            topology[2]]
    assert launches[name] == 1


def test_bounded_tendency_refusals():
    """What the bounded #6 is not built for raises on the card, in the
    wrapper and in the model (float32 fields with float64 or bfloat16
    smoothness), and #1 refuses the limiter with JAX's message."""
    grid, fields = _bounded_inputs(("periodic", "periodic", "bounded"),
                                   torch.float32)
    for smooth in (torch.float64, torch.bfloat16):
        scheme = ot.WENO(5, smoothness_dtype=smooth, bounds=(0.0, 1.0))
        with pytest.raises(NotImplementedError, match="smoothness"):
            K.fused_advection_tendency(grid, scheme, fields)
        with pytest.raises(NotImplementedError, match="smoothness"):
            ot.NonhydrostaticModel(grid, advection=scheme, tracers=("c",))
    with pytest.raises(NotImplementedError, match="z-compact"):
        K.fused_advection_update(grid, ot.WENO(5, bounds=(0.0, 1.0)),
                                 *fields[:3], None, 0.1, 0.0)


def test_bounded_model_takes_the_kernel():
    """The NH model with WENO's default smoothness on float64 fields and on
    a flat z launches the bounded #6 on the card, as JAX's model takes its
    kernel there."""
    for topology, dtype in ((("periodic", "periodic", "bounded"),
                             torch.float64),
                            (("periodic", "periodic", "flat"),
                             torch.float32)):
        grid, _ = _bounded_inputs(topology, dtype)
        model = ot.NonhydrostaticModel(
            grid, advection=ot.WENO(5, bounds=(0.0, 1.0)), tracers=("c",))
        assert model._kernel_tendency and not model._z_compact
        model.set(u=0.1, c=0.5)
        K.reset_counters()
        model.time_step(1e-3)
        launches, plain = K.counters()
        assert launches["fused_advection_tendency"] == 3, launches
        assert plain["fused_advection_tendency_plain"] == 0


def test_ensemble_member_is_its_solo_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from oceananigans_tpu_torch.models.ensemble import EnsembleModel
    grid = ot.LatitudeLongitudeGrid(size=(32, 24, 8), longitude=(0, 60),
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    dtype=torch.float32, device="cuda")

    def make(shift):
        m = ot.HydrostaticFreeSurfaceModel(
            grid, momentum_advection=ot.WENOVectorInvariant(),
            coriolis=ot.HydrostaticSphericalCoriolis(),
            free_surface=ot.SplitExplicitFreeSurface(substeps=10),
            tracers=("T",))
        m.set(T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi + shift,
              u=lambda lam, phi, z: 0.05 * np.sin(np.radians(4 * lam)))
        return m

    ens = EnsembleModel(make(0.0), 3)
    ens.set_all(lambda m: dict(
        T=lambda lam, phi, z, m=m: 12 + 8e-3 * z + 2e-2 * phi + 0.1 * m))
    solo = make(0.2)
    for _ in range(4):
        ens.time_step(120.0)
        solo.time_step(120.0)
    for name, a in ens.member_state(2)["fields"].items():
        assert torch.equal(a, solo.state["fields"][name]), name
    assert not torch.equal(ens.member_state(0)["fields"]["T"],
                           ens.member_state(2)["fields"]["T"])
