"""The isopycnal closures of the port against the JAX package's, on the CPU
in float64.

- ``IsopycnalSkewSymmetricDiffusivity`` (flux and advective forms) and
  ``TriadIsopycnalSkewSymmetricDiffusivity``: the tracer tendency, the
  implicit R₃₃, the slopes and the eddy velocities on seeded padded fields
  (random halos), every padded slot, at 1e-12 of their scale, on a
  RectilinearGrid, a lat-lon grid and an immersed lat-lon grid
  (GridFittedBottom), with scalar, array and callable κ;
- the invariants: the triads vanish on a linear b, the flux forms conserve
  the tracer, the eddy velocities are non-divergent and the advective form
  slumps a front as the flux form does;
- the eddy-velocity route of both models (the advective form) over 3 steps
  at 1e-10, and the one difference from JAX that the port keeps on
  purpose: its ClosureTuple carries a member's eddy velocities, which the
  JAX tuple drops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoy
from oceananigans_tpu.closures import (
    IsopycnalSkewSymmetricDiffusivity as JIso,
    TriadIsopycnalSkewSymmetricDiffusivity as JTriad)
from oceananigans_tpu.closures.scalar_diffusivity import (
    ClosureTuple as JTuple, HorizontalScalarDiffusivity as JHSD)
from oceananigans_tpu.immersed import (GridFittedBottom as JGFB,
                                       ImmersedBoundaryGrid as JIBG)
from oceananigans_tpu.models.free_surfaces import \
    SplitExplicitFreeSurface as JSplit
from oceananigans_tpu.models.hydrostatic import \
    HydrostaticFreeSurfaceModel as JModel
from oceananigans_tpu.models.nonhydrostatic import NonhydrostaticModel as JNH
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.closures import (
    IsopycnalSkewSymmetricDiffusivity as TIso,
    TriadIsopycnalSkewSymmetricDiffusivity as TTriad)
from oceananigans_tpu_torch.closures.scalar_diffusivity import ClosureTuple
from oceananigans_tpu_torch.models.hydrostatic import (
    HydrostaticFreeSurfaceModel, state_from_jax)
from oceananigans_tpu_torch.models.nonhydrostatic import (
    NonhydrostaticModel, state_from_jax as nh_state_from_jax)
from oceananigans_tpu_torch.operators.operators import div_ccc

torch.set_num_threads(1)

F64 = torch.float64
N = (12, 10, 8)
H = (3, 3, 3)
TOL = 1e-12


def _ridge(lam, phi):
    return np.where(np.abs(lam - 30.0) < 8.0, -600.0, -2000.0) + 0 * phi


def _grids(kind):
    if kind == "rectilinear":
        kw = dict(size=N, x=(0, 1e5), y=(0, 8e4), z=(-1000.0, 0.0), halo=H,
                  topology=("bounded", "periodic", "bounded"))
        return (jo.RectilinearGrid(dtype=np.float64, **kw),
                ot.RectilinearGrid(dtype=F64, device="cpu", **kw))
    kw = dict(size=N, longitude=(0, 60), latitude=(15, 75),
              z=(-2000.0, 0.0), halo=H)
    jg = jo.LatitudeLongitudeGrid(dtype=np.float64, **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, device="cpu", **kw)
    if kind == "immersed":
        return JIBG(jg, JGFB(_ridge)), ot.ImmersedBoundaryGrid(
            tg, ot.GridFittedBottom(_ridge))
    return jg, tg


def _kappa(kind, shape, scale):
    """A diffusivity as a scalar, a padded array or a callable κ(x, y, z)
    (plain arithmetic: both packages call it)."""
    if kind == "scalar":
        return scale
    if kind == "array":
        rng = np.random.default_rng(11)
        return scale * (1.0 + 0.3 * rng.random(shape))
    return lambda x, y, z: scale * (1.0 + 1e-3 * z / 10.0) + 0.01 * x * y


def _fields(shape, seed=3):
    """Seeded padded fields: b stratified (N² of both signs in places) with
    a lateral gradient, a tracer c, small velocities."""
    rng = np.random.default_rng(seed)
    z = np.linspace(-1, 0, shape[2]).reshape(1, 1, -1)
    x = np.linspace(0, 1, shape[0]).reshape(-1, 1, 1)
    out = {"b": 1e-3 * z + 2e-4 * x + 2e-5 * rng.standard_normal(shape),
           "c": rng.standard_normal(shape)}
    for n in ("u", "v", "w"):
        out[n] = 0.01 * rng.standard_normal(shape)
    return ({n: jnp.asarray(a) for n, a in out.items()},
            {n: torch.as_tensor(a.copy()) for n, a in out.items()})


def _close(t, j, tol=TOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.broadcast_to(np.asarray(j), np.shape(t))
    err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-300)
    assert err <= tol, err


def _pair(name, kappa, J):
    buoy = JBuoy() if J else ot.BuoyancyTracer()
    if name == "flux":
        return (JIso if J else TIso)(kappa_redi=kappa, kappa_gm=kappa,
                                     maximum_slope=2e-3, buoyancy=buoy)
    if name == "advective":
        return (JIso if J else TIso)(kappa_redi=kappa, kappa_gm=kappa,
                                     maximum_slope=2e-3, buoyancy=buoy,
                                     skew_flux_formulation="advective")
    return (JTriad if J else TTriad)(kappa_skew=kappa, kappa_symmetric=kappa,
                                     maximum_slope=2e-3, buoyancy=buoy)


GRIDS = ["rectilinear", "latlon", "immersed"]
KAPPAS = ["scalar", "array", "callable"]


@pytest.mark.parametrize("kappa", KAPPAS)
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", ["flux", "advective", "triad"])
def test_closure_terms(name, grid, kappa):
    """The diffusivities (slopes, tapers, R₃₃), the tracer tendencies of b
    and c and the eddy velocities, every padded slot."""
    jg, tg = _grids(grid)
    kj = _kappa(kappa, jg.padded_shape, 800.0)
    jc, tc = _pair(name, kj, True), _pair(name, kj, False)
    jf, tf = _fields(jg.padded_shape)
    ja = jc.compute_diffusivities(jg, jf, 0.0)
    ta = tc.compute_diffusivities(tg, tf, 0.0)
    keys = ([k for k in ja if not isinstance(ja[k], dict)]
            if name != "triad" else ["kappa_R33_ccf", "bx", "by", "bz"])
    for k in keys:
        _close(ta[k], ja[k])
    if name == "triad":
        for h in ("Sx", "Sy", "ekx", "eky"):
            for s in ("pp", "pm", "mp", "mm"):
                _close(ta[h][s], ja[h][s])
        jk = jc.vertical_implicit_kappas(jg, jf, ja)
        tk = tc.vertical_implicit_kappas(tg, tf, ta)
        assert sorted(jk) == sorted(tk) == ["b", "c"]
        _close(tk["c"], jk["c"])
    for tracer in ("b", "c"):
        _close(tc.tracer_tendency(tg, tracer, tf, ta),
               jc.tracer_tendency(jg, tracer, jf, ja))
    if name == "advective":
        assert tc.has_eddy_velocities and jc.has_eddy_velocities
        for t, j in zip(tc.eddy_velocities(tg, tf),
                        jc.eddy_velocities(jg, jf)):
            _close(t, j)


def _front_model(closure, topology=("bounded", "periodic", "bounded")):
    grid = ot.RectilinearGrid(size=(24, 4, 12), x=(0, 1e5), y=(0, 4e3),
                              z=(-1000.0, 0.0), topology=topology,
                              dtype=F64, device="cpu")
    m = HydrostaticFreeSurfaceModel(
        grid, buoyancy=ot.BuoyancyTracer(), closure=closure,
        velocities=ot.PrescribedVelocityFields())
    m.set(b=lambda x, y, z: 1e-5 * z + 5e-8 * (x - 5e4))
    return m


def test_triad_exact_on_linear_b():
    """On a linear b every triad flux of b vanishes (the triads'
    isoneutrality), away from the walls where triads are dropped."""
    clo = TTriad(kappa_symmetric=1000.0, buoyancy=ot.BuoyancyTracer())
    m = _front_model(clo)
    ff = m._fill_all(dict(m.state["fields"]))
    aux = clo.compute_diffusivities(m.grid, ff, 0.0)
    G = clo.tracer_tendency(m.grid, "b", ff, aux)[m.grid.interior_slices]
    assert G[2:-2, :, 2:-2].abs().max() < 1e-17


@pytest.mark.parametrize("name", ["flux", "triad"])
def test_conservation_and_slumping(name):
    """The tracer integral holds over 20 steps while the front slumps."""
    buoy = ot.BuoyancyTracer()
    clo = (TIso(kappa_redi=500.0, kappa_gm=500.0, buoyancy=buoy)
           if name == "flux" else
           TTriad(kappa_symmetric=500.0, kappa_skew=500.0, buoyancy=buoy))
    m = _front_model(clo)
    b0 = m.field("b").interior.clone()
    for _ in range(20):
        m.time_step(3600.0)
    b1 = m.field("b").interior
    assert torch.isfinite(b1).all()
    assert abs(float(b1.sum() - b0.sum())) <= 1e-9 * abs(float(b0.sum()))
    assert float(b1[:, 0, 8].std()) < float(b0[:, 0, 8].std())


def test_advective_form_against_flux_form():
    """The eddy velocities are discretely non-divergent; the advective form
    conserves b and slumps the front as the flux form does (the two agree
    to the discretization, not to roundoff)."""
    buoy = ot.BuoyancyTracer()
    adv = TIso(kappa_gm=500.0, buoyancy=buoy,
               skew_flux_formulation="advective")
    flux = TIso(kappa_gm=500.0, buoyancy=buoy)
    assert adv.has_eddy_velocities and not flux.has_eddy_velocities
    periodic = ("periodic", "periodic", "bounded")
    ma, mf = _front_model(adv, periodic), _front_model(flux, periodic)
    for m in (ma, mf):
        m.set(b=lambda x, y, z: 1e-5 * z
              + 5e-3 * np.sin(2 * np.pi * x / 1e5))
    ff = ma._fill_all(dict(ma.state["fields"]))
    ue, ve, we = adv.eddy_velocities(ma.grid, ff)
    div = div_ccc(ma.grid, ue, ve, we)[ma.grid.interior_slices]
    assert div[:, :, 1:-1].abs().max() < 1e-16
    b0 = ma.field("b").interior.clone()
    for _ in range(10):
        ma.time_step(3600.0)
        mf.time_step(3600.0)
    ba, bf = ma.field("b").interior, mf.field("b").interior
    assert abs(float(ba.sum() - b0.sum())) <= 1e-9 * abs(float(b0.sum()))
    da, df = (ba - b0)[:, 0, 6], (bf - b0)[:, 0, 6]
    assert float(da.abs().max()) > 0
    # the same slumping, to a few per cent of the change
    assert float((da - df).abs().max()) < 0.1 * float(df.abs().max())


# -- the models ---------------------------------------------------------------------

def _np_state(state):
    return {k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


def _hydro_pair(closure_of):
    kw = dict(size=(12, 10, 6), longitude=(0, 60), latitude=(15, 75),
              z=(-2000.0, 0.0))
    jg = jo.LatitudeLongitudeGrid(dtype=np.float64, **kw)
    tg = ot.LatitudeLongitudeGrid(dtype=F64, device="cpu", **kw)
    jm = JModel(jg, momentum_advection=jo.VectorInvariant(),
                free_surface=JSplit(substeps=10), buoyancy=JBuoy(),
                coriolis=jo.HydrostaticSphericalCoriolis(),
                closure=closure_of(True), tracers=("b", "c"))
    tm = HydrostaticFreeSurfaceModel(
        tg, momentum_advection=ot.VectorInvariant(),
        free_surface=ot.SplitExplicitFreeSurface(substeps=10),
        buoyancy=ot.BuoyancyTracer(), coriolis=ot.HydrostaticSphericalCoriolis(),
        closure=closure_of(False), tracers=("b", "c"))
    rng = np.random.default_rng(2)
    jm.set(b=lambda lam, phi, z: 2e-5 * z + 2e-3 * np.cos(np.radians(phi))
           * np.sin(np.radians(3 * lam)),
           c=lambda lam, phi, z: np.sin(np.radians(4 * lam)) + 0 * z,
           u=0.05 * rng.standard_normal(kw["size"]))
    state_from_jax(_np_state(jm.state), tm)
    return jm, tm


def _compare(jm, tm, names, tol=1e-10):
    for name in names:
        a = np.asarray(jm.field(name).interior)
        b = tm.field(name).interior.numpy()
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert err <= tol, (name, err)


def _advective(J):
    return (JIso if J else TIso)(kappa_redi=300.0, kappa_gm=600.0,
                                 skew_flux_formulation="advective")


def test_hydrostatic_eddy_velocities_against_jax():
    """The advective GM form in the hydrostatic model: 3 quasi-AB2 steps
    at 1e-10 (the kernel route refuses it; this CPU model is plain)."""
    jm, tm = _hydro_pair(_advective)
    assert tm.closure.has_eddy_velocities and not tm.uses_kernel
    for _ in range(3):
        jm.time_step(1200.0)
        tm.time_step(1200.0)
    _compare(jm, tm, ("u", "v", "b", "c", "eta", "w"))


def test_nonhydrostatic_eddy_velocities_against_jax():
    """The advective GM form in the NonhydrostaticModel (RK3, WENO(5)):
    3 steps at 1e-10; the tendency kernel route is off for it."""
    kw = dict(size=(8, 8, 8), x=(0, 8e3), y=(0, 8e3), z=(-400.0, 0.0))
    jm = JNH(grid=jo.RectilinearGrid(dtype=np.float64, **kw),
             advection=jo.WENO(5), buoyancy=JBuoy(), tracers=("b", "c"),
             closure=JIso(kappa_redi=20.0, kappa_gm=40.0,
                          skew_flux_formulation="advective"))
    rng = np.random.default_rng(4)
    jm.set(b=lambda x, y, z: 1e-4 * z + 1e-6 * x + 1e-7 * y,
           c=rng.standard_normal(kw["size"]),
           u=0.01 * rng.standard_normal(kw["size"]))
    tm = NonhydrostaticModel(
        ot.RectilinearGrid(dtype=F64, device="cpu", **kw),
        advection=ot.WENO(5), buoyancy=ot.BuoyancyTracer(),
        tracers=("b", "c"),
        closure=TIso(kappa_redi=20.0, kappa_gm=40.0,
                     skew_flux_formulation="advective"))
    assert not tm._kernel_tendency
    nh_state_from_jax(_np_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(10.0)
        tm.time_step(10.0)
    for name in ("u", "v", "w", "b", "c"):
        a = np.asarray(jm.field(name).interior)
        b = tm.field(name).interior.numpy()
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert err <= 1e-10, (name, err)


class _NoEddyTuple(ClosureTuple):
    """The port's tuple without its members' eddy velocities: JAX's."""
    has_eddy_velocities = False


def test_closure_tuple_keeps_eddy_velocities():
    """JAX's ClosureTuple has no eddy velocities, so an advective member
    inside it loses its skew transport there (its tracer_tendency drops
    κ_GM and nothing advects with the eddy velocities). The port's tuple
    carries them. Pinned: the port's tuple without them matches the JAX
    tuple over 3 steps at 1e-10, and the port's tuple differs from it by
    exactly the eddy advection -∇·(𝐯ₑc) in each tracer's tendency."""
    from oceananigans_tpu_torch.advection.fluxes import div_Uc

    def pair(J, cls=None):
        hsd = (JHSD if J else ot.HorizontalScalarDiffusivity)(kappa=50.0)
        return (cls or (JTuple if J else ClosureTuple))(_advective(J), hsd)
    assert not getattr(pair(True), "has_eddy_velocities", False)
    assert pair(False).has_eddy_velocities
    jm, tm = _hydro_pair(lambda J: pair(J, None if J else _NoEddyTuple))
    for _ in range(3):
        jm.time_step(1200.0)
        tm.time_step(1200.0)
    _compare(jm, tm, ("u", "v", "b", "c", "eta", "w"))
    # the two port tuples on the same state: the tendencies differ by the
    # eddy advection alone
    _, with_eddy = _hydro_pair(pair)
    with_eddy.state = tm.state
    fields = with_eddy._fill_all(dict(tm.state["fields"]))
    w = tm._w_from_continuity(fields["u"], fields["v"])
    G_j, _ = tm._compute_tendencies(fields, w)
    G_p, _ = with_eddy._compute_tendencies(fields, w)
    grid = tm.grid
    ue, ve, we = with_eddy.closure.eddy_velocities(grid, dict(fields, w=w))
    u, v = fields["u"], fields["v"]
    ints = grid.interior_slices
    for name in ("b", "c"):
        scheme = tm.tracer_scheme(name)
        eddy = (-div_Uc(grid, scheme, u + ue, v + ve, w + we, fields[name])
                + div_Uc(grid, scheme, u, v, w, fields[name]))[ints]
        diff = (G_p[name] - G_j[name])[ints]
        assert float(eddy.abs().max()) > 0
        assert float((diff - eddy).abs().max()) \
            <= 1e-12 * float(G_j[name][ints].abs().max())
