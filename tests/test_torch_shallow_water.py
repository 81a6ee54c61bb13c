"""The port's ShallowWaterModel and its fused stage against the JAX package's.

Float64 fields, the same numpy inputs on both sides. Bounds, relative to
max|reference| unless stated:
- WENO(5) with float64 smoothness, Centered(2), the vector-invariant
  formulation and BetaPlane: 1e-12. Both sides evaluate the same stencils in
  float64; only the association of a few sums differs, which is roundoff
  (about 1e-16 per step).
- WENO(5) with the default float32 smoothness: 1e-7. The indicators are
  rounded to float32 on both sides, so float64 roundoff upstream can flip
  one float32 rounding and move a nonlinear weight by a few 2⁻²⁴.

Both models leave the bathymetry's halos as ``set_on_padded`` makes them
(zero for an array); the model tests give both the same interior array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import Centered as JCentered
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.coriolis import BetaPlane as JBeta
from oceananigans_tpu.coriolis import \
    ConstantCartesianCoriolis as JCartesian
from oceananigans_tpu.coriolis import FPlane as JFPlane
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.kernels.fused_shallow_water import build_fused_sw_update
from oceananigans_tpu.models.shallow_water import ShallowWaterModel as JModel
from oceananigans_tpu.models.shallow_water import \
    conservative_tendencies as j_conservative_tendencies
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.closures import ScalarDiffusivity
from oceananigans_tpu_torch.advection.shallow_water import \
    conservative_tendencies
from oceananigans_tpu_torch.kernels.fused_shallow_water import sw_eligible
from oceananigans_tpu_torch.models.shallow_water import (
    VECTOR_INVARIANT, ShallowWaterModel, state_from_jax)

torch.set_num_threads(1)

TOPO = ("periodic", "periodic", "flat")
EXTENT = (10.0, 10.0)
G_ACC = 9.81
DT = 1e-3

SCHEMES = {
    "weno5_f64": (lambda: JWENO(5, smoothness_dtype=jnp.float64),
                  lambda: ot.WENO(5, smoothness_dtype=torch.float64), 1e-12),
    "weno5_f32": (lambda: JWENO(5), lambda: ot.WENO(5), 1e-7),
    "centered2": (lambda: JCentered(2), lambda: ot.Centered(2), 1e-12),
}


def _jgrid(N, halo=None):
    return JGrid(size=N, extent=EXTENT, topology=TOPO, halo=halo,
                 dtype=np.float64)


def _tgrid(N, halo=None):
    return ot.RectilinearGrid(size=N, extent=EXTENT, topology=TOPO, halo=halo,
                              dtype=torch.float64, device="cpu")


def _initial(N, seed=0):
    """Bathymetry and initial h, uh, vh, c (interiors)."""
    rng = np.random.default_rng(seed)
    hB = 0.05 * rng.standard_normal(N)
    init = dict(h=1.0 + 0.05 * rng.standard_normal(N),
                uh=0.1 * rng.standard_normal(N),
                vh=0.1 * rng.standard_normal(N), c=rng.random(N))
    return hB, init


def _wrap(a, H):
    """An interior (Nx, Ny) array periodically padded to (NXp, NYp, 1)."""
    return np.pad(a, ((H[0], H[0]), (H[1], H[1])), mode="wrap")[..., None]


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# -- the tendencies and the fused stage ---------------------------------------

@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_conservative_tendencies(scheme):
    """At 16² with FPlane, bathymetry and one tracer, on the same padded
    inputs (H = (4, 4, 0), halos wrapped)."""
    N, H = (16, 16), (4, 4, 0)
    jg, tg = _jgrid(N, H), _tgrid(N, H)
    hB, init = _initial(N, seed=1)
    jmake, tmake, tol = SCHEMES[scheme]
    jf = {n: jnp.asarray(_wrap(a, H)) for n, a in init.items()}
    tf = {n: torch.as_tensor(_wrap(a, H)) for n, a in init.items()}
    jG = j_conservative_tendencies(jg, jmake(), G_ACC, JFPlane(f=0.3),
                                   jnp.asarray(_wrap(hB, H)), ("c",), jf)
    tG = conservative_tendencies(tg, tmake(), G_ACC, ot.FPlane(f=0.3),
                                 torch.as_tensor(_wrap(hB, H)), ("c",), tf)
    ints = tg.interior_slices
    for name in ("uh", "vh", "h", "c"):
        assert _rel(tG[name][ints].numpy(),
                    np.asarray(jG[name])[ints]) <= tol, name


@pytest.mark.parametrize("with_gm", [False, True])
def test_fused_sw_update_plain(with_gm):
    """The plain version against the JAX Pallas kernel in interpret mode at
    16², WENO(5) with float64 smoothness, FPlane, bathymetry and a tracer.
    The JAX kernel needs Hx % 8 == 0 (H = (8, 8, 0)); the port's H is
    (4, 4, 0). Interiors of G and of the new fields are compared."""
    N, JH, TH = (16, 16), (8, 8, 0), (4, 4, 0)
    jg, tg = _jgrid(N, JH), _tgrid(N, TH)
    hB, init = _initial(N, seed=2)
    names = ("uh", "vh", "h", "c")
    rng = np.random.default_rng(3)
    gm = [rng.standard_normal(N) for _ in names]
    gdt, zdt = 2e-3, -1e-3
    jfn = build_fused_sw_update(jg, JWENO(5, smoothness_dtype=jnp.float64),
                                G_ACC, JFPlane(f=0.3),
                                jnp.asarray(_wrap(hB, JH)), ("c",))
    jf = {n: jnp.asarray(_wrap(init[n], JH)) for n in names}
    jgm = None
    if with_gm:
        ypad = -(-(N[1] + 2 * JH[1]) // 128) * 128
        jgm = [jnp.asarray(np.pad(g, ((0, 0), (JH[1], ypad - N[1] - JH[1]))))
               for g in gm]
    jG, jnew = jfn(jf, jgm, gdt, zdt)
    tf = {n: torch.as_tensor(_wrap(init[n], TH)) for n in names}
    tgm = torch.as_tensor(np.stack(gm)[..., None]) if with_gm else None
    tG, tnew = K.fused_sw_update(tg, ot.WENO(5, smoothness_dtype=torch.float64),
                                 G_ACC, 0.3, torch.as_tensor(_wrap(hB, TH)),
                                 names, tf, tgm, gdt, zdt)
    assert tuple(tG.shape) == (4,) + tg.N
    sy = slice(JH[1], JH[1] + N[1])
    jints = (slice(JH[0], JH[0] + N[0]), sy)
    tints = tg.interior_slices
    for k, name in enumerate(names):
        assert _rel(tG[k, ..., 0].numpy(), np.asarray(jG[k])[:, sy]) <= 1e-12
        assert _rel(tnew[name][tints].numpy(),
                    np.asarray(jnew[name])[jints]) <= 1e-12, name


# -- the model ----------------------------------------------------------------

def _jax_model(N, scheme, coriolis, hB, fused, **kw):
    return JModel(grid=_jgrid(N), advection=scheme(), coriolis=coriolis,
                  bathymetry=hB, tracers=("c",),
                  gravitational_acceleration=G_ACC, fused=fused, **kw)


def _port_model(N, scheme, coriolis, hB, **kw):
    return ShallowWaterModel(_tgrid(N), advection=scheme(), coriolis=coriolis,
                             bathymetry=hB, tracers=("c",),
                             gravitational_acceleration=G_ACC, **kw)


def _run(model, init, steps=3):
    model.set(**init)
    for _ in range(steps):
        model.time_step(DT)
    return model


def _compare(jm, tm, tol, names=("uh", "vh", "h", "c")):
    for name in names:
        want = np.asarray(jm.field(name).interior)
        got = tm.field(name).interior.numpy()
        assert _rel(got, want) <= tol, name
    assert tm.iteration == jm.iteration
    assert abs(tm.time - jm.time) <= 1e-15


@pytest.mark.parametrize("jax_fused", [True, False])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_model_matches_jax(scheme, jax_fused):
    """3 steps at 32² in the configuration of tests/test_fused_shallow_water.py
    (FPlane(0.3), bathymetry, tracer c), against both JAX paths; the port
    takes its fused stage (the plain version on the CPU)."""
    N = (32, 32)
    jmake, tmake, tol = SCHEMES[scheme]
    hB, init = _initial(N)
    jm = _run(_jax_model(N, jmake, JFPlane(f=0.3), hB, jax_fused), init)
    tm = _run(_port_model(N, tmake, ot.FPlane(f=0.3), hB), init)
    assert tm.fused and (jm._fused_update is not None) == jax_fused
    _compare(jm, tm, tol)


def test_fused_and_plain_paths_agree():
    """The port's fused stage and its plain tendencies (fused=False), with
    ConstantCartesianCoriolis (its x and y rows reduce to fz's when w = 0)."""
    N = (16, 16)
    hB, init = _initial(N, seed=4)
    cor = ot.ConstantCartesianCoriolis(fx=0.1, fy=-0.2, fz=0.3)
    scheme = lambda: ot.WENO(5, smoothness_dtype=torch.float64)  # noqa: E731
    a = _run(_port_model(N, scheme, cor, hB), init)
    b = _run(_port_model(N, scheme, cor, hB, fused=False), init)
    assert a.fused and not b.fused
    for name in ("uh", "vh", "h", "c"):
        assert _rel(a.field(name).interior.numpy(),
                    b.field(name).interior.numpy()) <= 1e-12, name
    jm = _run(_jax_model(N, lambda: JWENO(5, smoothness_dtype=jnp.float64),
                         JCartesian(fx=0.1, fy=-0.2, fz=0.3), hB, False),
              init)
    _compare(jm, a, 1e-12)


def test_beta_plane_matches_jax():
    """BetaPlane runs the plain path, as JAX fused=False; 3 steps at 16²."""
    N = (16, 16)
    hB, init = _initial(N, seed=5)
    jm = _run(_jax_model(N, lambda: JWENO(5, smoothness_dtype=jnp.float64),
                         JBeta(f0=0.3, beta=0.1), hB, False), init)
    tm = _run(_port_model(N, lambda: ot.WENO(5, smoothness_dtype=torch.float64),
                          ot.BetaPlane(f0=0.3, beta=0.1), hB), init)
    assert not tm.fused
    _compare(jm, tm, 1e-12)
    with pytest.raises(ValueError, match="not eligible"):
        _port_model(N, ot.Centered, ot.BetaPlane(f0=0.3, beta=0.1), hB,
                    fused=True)


def test_jax_fused_beta_plane_defect():
    """The JAX fused kernel takes BetaPlane and fails on its first step: its
    tile grid has no y coordinates (ROADMAP.md queue 3). The port routes
    BetaPlane to the plain path instead (test_beta_plane_matches_jax)."""
    jm = JModel(grid=_jgrid((16, 16)), advection=JWENO(5),
                coriolis=JBeta(f0=0.3, beta=0.1), fused=True)
    jm.set(h=1.0)
    with pytest.raises(AttributeError, match="coord_padded"):
        jm.time_step(DT)


@pytest.mark.parametrize("coriolis", ["none", "fplane"])
def test_vector_invariant_matches_jax(coriolis):
    """The vector-invariant formulation (u, v, h; the conserving
    VectorInvariant()), Centered(2) tracer advection, 3 steps at 16²."""
    N = (16, 16)
    hB, init = _initial(N, seed=6)
    init = dict(h=init["h"], u=init["uh"], v=init["vh"], c=init["c"])
    jc = JFPlane(f=0.3) if coriolis == "fplane" else None
    tc = ot.FPlane(f=0.3) if coriolis == "fplane" else None
    jm = _run(_jax_model(N, JCentered, jc, hB, "auto",
                         formulation="vector_invariant"), init)
    tm = _run(_port_model(N, ot.Centered, tc, hB,
                          formulation=VECTOR_INVARIANT), init)
    assert not tm.fused and tm.prognostic_names == ("u", "v", "h", "c")
    _compare(jm, tm, 1e-12, names=("u", "v", "h", "c"))


def test_bathymetry_halos():
    """Both models keep the bathymetry's halos as set_on_padded makes them:
    zero for an interior array (so ∂x hB at the first interior face reads a
    zero slot, ROADMAP.md queue 3), the function's values at the halo
    coordinates for a callable. The port's bathymetry is the JAX model's cut
    to the port's narrower halos, and one step agrees within 1e-12."""
    N = (16, 16)
    hB, init = _initial(N, seed=7)
    bump = lambda x, y, z: 0.2 * np.exp(-((x - 5) ** 2 + (y - 5) ** 2))  # noqa: E731
    for value in (hB, bump):
        tm = _port_model(N, ot.Centered, None, value)
        jm = _jax_model(N, JCentered, None, value, "auto")
        H, JH = tm.grid.H, jm.grid.H
        jb = np.asarray(jm.bathymetry)[JH[0] - H[0]:JH[0] + N[0] + H[0],
                                       JH[1] - H[1]:JH[1] + N[1] + H[1]]
        assert np.array_equal(tm.bathymetry.numpy(), jb)
        if value is hB:
            assert np.all(tm.bathymetry[:H[0]].numpy() == 0.0)
        _compare(_run(jm, init, steps=1), _run(tm, init, steps=1), 1e-12)


def test_lake_at_rest():
    """A flat free surface over bathymetry stays at rest (well balanced):
    10 steps at 16² with the default Centered(2), |uh| below 1e-10."""
    g = _tgrid((16, 16))
    bump = lambda x, y, z: 0.2 * np.exp(-((x - 5) ** 2 + (y - 5) ** 2))  # noqa: E731
    model = ShallowWaterModel(g, gravitational_acceleration=G_ACC,
                              bathymetry=bump)
    model.set(h=lambda x, y, z: 1.0 - bump(x, y, z))
    for _ in range(10):
        model.time_step(DT)
    assert model.field("uh").interior.abs().max().item() < 1e-10
    assert model.field("vh").interior.abs().max().item() < 1e-10


def test_mass_conservation():
    """Σh is conserved to roundoff over 10 steps of WENO(5) with FPlane at
    32² (bound 1e-12 relative, as tests/test_shallow_water.py)."""
    model = ShallowWaterModel(_tgrid((32, 32)), advection=ot.WENO(5),
                              gravitational_acceleration=G_ACC,
                              coriolis=ot.FPlane(f=1.0))
    rng = np.random.default_rng(0)
    model.set(h=1.0 + 0.1 * rng.random((32, 32)),
              uh=0.1 * rng.standard_normal((32, 32)),
              vh=0.1 * rng.standard_normal((32, 32)))
    m0 = model.field("h").interior.sum().item()
    for _ in range(10):
        model.time_step(DT)
    m1 = model.field("h").interior.sum().item()
    assert abs(m1 - m0) <= 1e-12 * abs(m0)
    assert torch.isfinite(model.field("uh").data).all()


def test_state_from_jax():
    """Two JAX steps, loaded into the port (the JAX halos are (8, 48, 0) at
    32²), then one more step on each side; bound 1e-12."""
    N = (32, 32)
    hB, init = _initial(N, seed=8)
    jmake, tmake, _ = SCHEMES["weno5_f64"]
    jm = _run(_jax_model(N, jmake, JFPlane(f=0.3), hB, True), init, steps=2)
    assert jm.grid.H[1] != 4
    tm = _port_model(N, tmake, ot.FPlane(f=0.3), np.zeros(N))
    state = dict(fields={n: np.asarray(a)
                         for n, a in jm.state["fields"].items()},
                 clock={k: np.asarray(v)
                        for k, v in jm.state["clock"].items()})
    state_from_jax(state, tm, bathymetry=np.asarray(jm.bathymetry))
    assert tm.iteration == 2
    jm.time_step(DT)
    tm.time_step(DT)
    _compare(jm, tm, 1e-12)


# -- eligibility and what is not ported ---------------------------------------

def test_eligibility():
    g = _tgrid((8, 8))
    assert sw_eligible(g)
    assert sw_eligible(g, "conservative", ot.FPlane(f=1.0))
    assert sw_eligible(g, "conservative",
                       ot.ConstantCartesianCoriolis(fx=1.0, fz=2.0))
    assert not sw_eligible(g, "conservative", ot.BetaPlane(f0=1.0, beta=0.1))
    assert not sw_eligible(g, VECTOR_INVARIANT)
    assert not sw_eligible(ot.RectilinearGrid(
        size=(8, 8, 8), extent=(1, 1, 1), device="cpu"))
    # no TPU tile gate: an odd Nx is eligible
    assert ShallowWaterModel(_tgrid((30, 32)), advection=ot.WENO(5),
                             fused=True).fused


# -- bounded axes, closures, forcing, conditions (ROADMAP item 17) ------------

BICKLEY = dict(size=(16, 24), x=(0, 2 * np.pi), y=(-10, 10),
               topology=("periodic", "bounded", "flat"))


def _bickley_init(N=(16, 24), seed=11):
    """The example's balanced Bickley jet (U = H/10 = f = g = 1) with seeded
    noise, as interiors (x, y centres of BICKLEY)."""
    rng = np.random.default_rng(seed)
    yc = -10 + (np.arange(N[1]) + 0.5) * 20.0 / N[1]
    Y = np.broadcast_to(yc, N)
    hbar = 10.0 - np.tanh(Y)
    ubar = 1.0 / np.cosh(Y) ** 2
    return dict(uh=(ubar + 1e-2 * rng.standard_normal(N)) * hbar, h=hbar,
                vh=1e-2 * rng.standard_normal(N), c=rng.random(N))


def _bickley_models(jkw=None, tkw=None, grid=BICKLEY, steps=3, dt=1e-2):
    """The JAX and port models of the Bickley jet (WENO(5), FPlane(1),
    g = 1, tracer c) with extra keywords, 3 steps."""
    jg = JGrid(dtype=np.float64, **grid)
    tg = ot.RectilinearGrid(dtype=torch.float64, device="cpu", **grid)
    common = dict(coriolis=None, gravitational_acceleration=1.0,
                  tracers=("c",))
    jm = JModel(grid=jg, advection=JWENO(5, smoothness_dtype=jnp.float64),
                **{**common, "coriolis": JFPlane(f=1.0), **(jkw or {})})
    tm = ShallowWaterModel(tg, advection=ot.WENO(
        5, smoothness_dtype=torch.float64),
        **{**common, "coriolis": ot.FPlane(f=1.0), **(tkw or {})})
    init = _bickley_init(grid["size"])
    if jm.formulation == "vector_invariant":
        init = dict(u=init["uh"] / init["h"], v=init["vh"] / init["h"],
                    h=init["h"], c=init["c"])
    for m in (jm, tm):
        m.set(**init)
        for _ in range(steps):
            m.time_step(dt)
    return jm, tm


def _bickley_compare(jm, tm, tol=1e-12):
    names = tm.prognostic_names
    assert not tm.fused
    _compare(jm, tm, tol, names=names)


def test_bickley_jet_matches_jax():
    """examples/shallow_water_bickley_jet.py's configuration (periodic x,
    bounded y, flat z; WENO(5)) at 16×24 over 3 steps at 1e-12: neither
    package takes its fused stage on the bounded y."""
    jm, tm = _bickley_models()
    assert jm._fused_update is None
    _bickley_compare(jm, tm)


def _j_closure():
    from oceananigans_tpu.closures import ScalarDiffusivity as JScalar
    return JScalar(nu=2e-2, kappa=1e-2)


def _forcings(jax_side):
    from oceananigans_tpu.forcings.forcings import (ContinuousForcing as JCF,
                                                    DiscreteForcing as JDF)
    cf = JCF if jax_side else ot.ContinuousForcing
    df = JDF if jax_side else ot.DiscreteForcing
    sin = np.sin if jax_side else torch.sin
    return {"uh": cf(lambda x, y, z, t: 1e-2 * sin(x) * (1.0 + t)),
            "c": df(lambda grid, fields, t: -0.1 * fields["c"]),
            "h": cf(lambda x, y, z, t, uh: 1e-3 * uh,
                    field_dependencies=("uh",))}


def _conditions(jax_side):
    import oceananigans_tpu.boundary_conditions as jbc
    m = jbc if jax_side else ot
    return {"c": m.FieldBoundaryConditions(
                south=m.ValueBoundaryCondition(0.5),
                north=m.GradientBoundaryCondition(0.1)),
            "h": m.FieldBoundaryConditions(
                north=m.FluxBoundaryCondition(1e-3),
                south=m.FluxBoundaryCondition(
                    (lambda x, z, t: 1e-3 * np.cos(x)) if jax_side
                    else (lambda x, z, t: 1e-3 * torch.cos(x)))),
            "uh": m.FieldBoundaryConditions(
                north=m.ValueBoundaryCondition(0.2))}


@pytest.mark.parametrize("kw", ["closure", "forcing", "boundary_conditions"])
def test_not_ported_raises(kw):
    """The closure, forcing and boundary conditions the port once refused,
    now held against JAX on the Bickley jet at 1e-12 over 3 steps: a
    ScalarDiffusivity (ν, κ); a continuous forcing of uh (x and t), a
    discrete one of c and a continuous one of h with a field dependency;
    Value, Gradient and Flux (scalar and callable) conditions on the bounded
    sides of c, h and uh. Each turns the fused stage off in both packages,
    also on a periodic grid."""
    if kw == "closure":
        jkw, tkw = dict(closure=_j_closure()), dict(
            closure=ScalarDiffusivity(nu=2e-2, kappa=1e-2))
    elif kw == "forcing":
        jkw, tkw = dict(forcing=_forcings(True)), dict(
            forcing=_forcings(False))
    else:
        jkw, tkw = dict(boundary_conditions=_conditions(True)), dict(
            boundary_conditions=_conditions(False))
    jm, tm = _bickley_models(jkw, tkw)
    _bickley_compare(jm, tm)
    periodic = dict(BICKLEY, topology=("periodic", "periodic", "flat"))
    if kw != "boundary_conditions":
        jm, tm = _bickley_models(jkw, tkw, grid=periodic, steps=1)
        assert jm._fused_update is None
        _bickley_compare(jm, tm)


def test_grids_refused():
    """A z that is not flat is refused; a bounded x and y (the fill by each
    field's conditions, here on a closed basin with a closure) is held
    against JAX at 1e-12."""
    with pytest.raises(ValueError, match="z-Flat"):
        ShallowWaterModel(ot.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1),
                                             device="cpu"))
    basin = dict(size=(12, 10), x=(0, 5), y=(0, 4),
                 topology=("bounded", "bounded", "flat"))
    jm, tm = _bickley_models(dict(closure=_j_closure()), dict(
        closure=ScalarDiffusivity(nu=2e-2, kappa=1e-2)), grid=basin)
    _bickley_compare(jm, tm)


@pytest.mark.parametrize("momentum", ["default", "upwind", "weno"])
def test_vector_invariant_momentum_advection(momentum):
    """The vector-invariant form on the Bickley jet, with the
    ``momentum_advection`` set on the model as JAX reads it (getattr): the
    default, the upwinded vorticity VectorInvariant(WENO(5)) and
    WENOVectorInvariant; 3 steps at 1e-12."""
    from oceananigans_tpu.advection.vector_invariant import (
        VectorInvariant as JVI, WENOVectorInvariant as JWVI)
    from oceananigans_tpu_torch.advection.vector_invariant import \
        VectorInvariant as TVI
    grid = dict(BICKLEY, size=(16, 24))
    jkw = dict(formulation="vector_invariant")
    tkw = dict(formulation=VECTOR_INVARIANT)
    if momentum == "default":
        jm, tm = _bickley_models(jkw, tkw, grid=grid)
    else:
        pairs = {
            "upwind": (lambda: JVI(vorticity_scheme=JWENO(
                5, smoothness_dtype=jnp.float64)),
                lambda: TVI(vorticity_scheme=ot.WENO(
                    5, smoothness_dtype=torch.float64))),
            "weno": (lambda: JWVI(smoothness_dtype=jnp.float64),
                     lambda: ot.WENOVectorInvariant(
                         smoothness_dtype=torch.float64))}
        jmake, tmake = pairs[momentum]
        jg = JGrid(dtype=np.float64, halo=(7, 7, 0), **grid)
        tg = ot.RectilinearGrid(dtype=torch.float64, device="cpu",
                                halo=(7, 7, 0), **grid)
        models = []
        for side, (G_, make) in (("j", (jg, jmake)), ("t", (tg, tmake))):
            if side == "j":
                m = JModel(grid=G_, advection=JWENO(
                    5, smoothness_dtype=jnp.float64), coriolis=JFPlane(f=1.0),
                    gravitational_acceleration=1.0, tracers=("c",), **jkw)
            else:
                m = ShallowWaterModel(G_, advection=ot.WENO(
                    5, smoothness_dtype=torch.float64),
                    coriolis=ot.FPlane(f=1.0), gravitational_acceleration=1.0,
                    tracers=("c",), **tkw)
            m.momentum_advection = make()
            init = _bickley_init(grid["size"])
            m.set(u=init["uh"] / init["h"], v=init["vh"] / init["h"],
                  h=init["h"], c=init["c"])
            for _ in range(3):
                m.time_step(1e-2)
            models.append(m)
        jm, tm = models
    _bickley_compare(jm, tm)


def test_upwinded_vector_invariant_raises():
    """The upwinded vector-invariant forms are ported (the hydrostatic
    slice), and the multi-dimensional stencil builds in both constructors
    (two more halo cells) and is taken by the fused VI kernel."""
    from oceananigans_tpu_torch.kernels.fused_vector_invariant import \
        vi_config
    from oceananigans_tpu_torch.advection.vector_invariant import (
        VectorInvariant, WENOVectorInvariant)
    assert VectorInvariant(vorticity_scheme=ot.WENO(5)).required_halo == 4
    assert WENOVectorInvariant().required_halo == 6
    assert VectorInvariant(
        multi_dimensional_stencil=True).required_halo == 3
    md = WENOVectorInvariant(multi_dimensional_stencil=True,
                             smoothness_dtype=torch.float64)
    assert md.required_halo == 8
    g = ot.LatitudeLongitudeGrid(size=(8, 8, 4), longitude=(0, 60),
                                 latitude=(10, 50), z=(-1, 0),
                                 dtype=torch.float64, device="cpu")
    assert vi_config(g, md, ot.Centered(2), 1, None)["md"] == 1


@pytest.mark.parametrize("vorticity", ["enstrophy_conserving",
                                       "energy_conserving"])
def test_vector_invariant_terms(vorticity):
    """The vorticity flux and Bernoulli head of both conserving forms
    against the JAX VectorInvariant's, on random padded fields at 16²;
    bound 1e-12 relative."""
    from oceananigans_tpu.advection.vector_invariant import \
        VectorInvariant as JVI
    from oceananigans_tpu_torch.advection.vector_invariant import \
        VectorInvariant as TVI
    N, H = (16, 16), (4, 4, 0)
    jg, tg = _jgrid(N, H), _tgrid(N, H)
    rng = np.random.default_rng(9)
    u, v = (rng.standard_normal(jg.padded_shape) for _ in range(2))
    jvi, tvi = JVI(vorticity_scheme=vorticity), TVI(vorticity_scheme=vorticity)
    ints = tg.interior_slices
    for jterm, tterm in ((jvi._horizontal, tvi._horizontal),
                         (jvi._bernoulli, tvi._bernoulli)):
        for want, got in zip(jterm(jg, jnp.asarray(u), jnp.asarray(v)),
                             tterm(tg, torch.as_tensor(u),
                                   torch.as_tensor(v))):
            assert _rel(got[ints].numpy(), np.asarray(want)[ints]) <= 1e-12
