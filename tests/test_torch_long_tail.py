"""The long tail of the port against the JAX package, on the CPU, float64:

- callable and array immersed conditions (a Flux callable of (x, y, t) and a
  Value array of the bottom plane) in the NonhydrostaticModel over 2 steps,
  from the JAX state, with the solvers at reltol 1e-13: 1e-12 of the field
  scale; a periodic z wraps whatever conditions it is handed, as JAX's fill
  does, and both models refuse such a condition when built;
- ``regrid``: the JAX package's tests/test_grids.py cases, 1e-13;
- ``LagrangianParticles``: positions, tracked fields and properties after
  3 steps with wall bounces (restitution 0.5), a periodic wrap, a custom
  dynamics, drogued particles, and the bounce off an immersed step: 1e-12;
- ``SimpleBiogeochemistry`` with reactions and a sinking drift in the
  NonhydrostaticModel and the HydrostaticFreeSurfaceModel: 1e-12, and the
  host hook's calls;
- auxiliary fields read by a forcing, in both models: 1e-12;
- ``EnsembleModel``: JAX's test_ensemble_model_vmap, every member against
  JAX's ensemble member at 1e-12 and against its solo run bit for bit;
- ``utils.profiling``: ``time_step`` and ``profile_step`` with no card;
- the two cases of the JAX package's tests/test_autodiff.py: gradients
  through 3 plain steps with respect to the initial tracer, and through 2
  steps and a diffusion with respect to ν, by torch.autograd against
  jax.grad: 1e-10 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as J
import oceananigans_tpu.boundary_conditions as jbc
import oceananigans_tpu.closures.diffusion_operators  # noqa: F401
import oceananigans_tpu.fields.regridding  # noqa: F401
import oceananigans_tpu.immersed  # noqa: F401
import oceananigans_tpu.models.ensemble  # noqa: F401
import oceananigans_tpu.particles  # noqa: F401
import oceananigans_tpu.biogeochemistry  # noqa: F401
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.closures.diffusion_operators  # noqa: F401
import oceananigans_tpu_torch.fields.regridding  # noqa: F401
import oceananigans_tpu_torch.immersed  # noqa: F401
import oceananigans_tpu_torch.particles  # noqa: F401
import oceananigans_tpu_torch.biogeochemistry  # noqa: F401
from oceananigans_tpu_torch.utils import profiling

from test_torch_cg import (HALO, check_pair, immersed_grids, numpy_state,
                           tight_solvers)

torch.set_num_threads(1)

F64 = torch.float64
P, B, F = "periodic", "bounded", "flat"


def _kw(pkg):
    return {"device": "cpu", "dtype": F64} if pkg is ot else \
        {"dtype": np.float64}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


# -- item 3's rest: callable and array immersed conditions ----------------------

def _immersed_bcs(pkg, case, N):
    bcs = jbc if pkg is J else ot
    if case == "callable_flux":
        flux = bcs.FluxBoundaryCondition(
            lambda x, y, t: 1e-4 * (1.0 + x * y) + 0.0 * t)
        sides = dict(bottom=flux, east=bcs.FluxBoundaryCondition(
            lambda y, z, t: 2e-4 * (y - z) + 0.0 * t))
        closure = None
    else:
        rng = np.random.default_rng(5)
        sides = dict(bottom=bcs.ValueBoundaryCondition(
            0.01 * rng.standard_normal(N[:2])),
            east=bcs.ValueBoundaryCondition(0.02))
        closure = pkg.ScalarDiffusivity(nu=1e-3, kappa=1e-2)
    return dict(
        advection=pkg.WENO(5, smoothness_dtype=(jnp.float64 if pkg is J
                                                else F64)),
        tracers=("c",), closure=closure,
        boundary_conditions={"c": bcs.FieldBoundaryConditions(
            immersed=bcs.ImmersedBoundaryCondition(**sides))})


@pytest.mark.parametrize("case", ["callable_flux", "array_value"])
def test_immersed_callable_and_array_conditions(case):
    """The hill of tests/test_torch_cg.py (GridFittedBottom, periodic x
    and y) with an immersed condition on the bottom and east sides of the
    tracer c, 2 steps from JAX's state."""
    halo = HALO["gridfitted_3d"]
    jg, tg = immersed_grids("gridfitted_3d", halo)
    N = tg.N
    rng = np.random.default_rng(1)
    values = {c: 0.05 * rng.standard_normal(N) for c in "uvw"}
    values["c"] = rng.standard_normal(N)
    jkw, tkw = _immersed_bcs(J, case, N), _immersed_bcs(ot, case, N)
    jsol, tsol = tight_solvers(J.NonhydrostaticModel(grid=jg, **jkw).grid,
                               tg.with_halo(halo))
    jm = J.NonhydrostaticModel(grid=jg, pressure_solver=jsol, **jkw)
    tm = ot.NonhydrostaticModel(tg, pressure_solver=tsol,
                                fuse_correction=False, **tkw)
    assert tuple(tm.grid.H) == tuple(halo)
    jm.set(**values)
    ot.state_from_jax(numpy_state(jm.state), tm)
    for _ in range(2):
        jm.time_step(2e-2)
        tm.time_step(2e-2)
    check_pair(jm, tm, 1e-12, p_tol=1e-10)


def test_periodic_z_wraps_any_condition():
    """JAX's fill wraps a periodic axis whatever conditions its sides
    name; so does the port's (the plain fill and the kernel's maps), and
    both models refuse a Flux condition on a periodic z when built."""
    N, H = (6, 5, 4), (2, 2, 2)
    kw = dict(size=N, extent=(1, 1, 1), halo=H, topology=(P, P, P))
    jg = J.RectilinearGrid(**kw, dtype=np.float64)
    tg = ot.RectilinearGrid(**kw, device="cpu", dtype=F64)
    a = np.random.default_rng(3).standard_normal(tg.padded_shape)
    jb = jbc.FieldBoundaryConditions(top=jbc.FluxBoundaryCondition(1.0))
    tb = ot.FieldBoundaryConditions(top=ot.FluxBoundaryCondition(1.0))
    want = np.asarray(jbc.fill_halo_regions(jnp.asarray(a), jg, ("c",) * 3,
                                            jb))
    got = ot.fill_halo_regions(torch.as_tensor(a).clone(), tg, ("c",) * 3, tb)
    assert np.array_equal(_np(got), want)
    for pkg, grid, bcs in ((J, jg, jb), (ot, tg, tb)):
        with pytest.raises(ValueError, match="periodic direction"):
            pkg.NonhydrostaticModel(grid=grid, tracers=("c",),
                                    boundary_conditions={"c": bcs})


# -- regrid ----------------------------------------------------------------------

def _regrid_cases(pkg):
    rg = pkg.fields.regridding.regrid
    src = pkg.RectilinearGrid(size=(4, 4, 32), extent=(1.0, 1.0, 1.0),
                              **_kw(pkg))
    zf = -1.0 + np.linspace(0, 1, 17) ** 1.4
    dst = pkg.RectilinearGrid(size=(4, 4, 16), x=(0, 1), y=(0, 1), z=zf,
                              **_kw(pkg))
    dst_x = pkg.RectilinearGrid(size=(8, 4, 32), extent=(1.0, 1.0, 1.0),
                                **_kw(pkg))
    c = np.random.default_rng(2).standard_normal((4, 4, 32))
    arr = torch.as_tensor if pkg is ot else jnp.asarray
    return dict(z=rg(arr(c), src, dst, axes=(2,)),
                ones=rg(arr(np.ones((4, 4, 32))), src, dst, axes=(2,)),
                x=rg(arr(c), src, dst_x, axes=(0,)), c=c, zf=zf)


def test_regrid_against_jax():
    got, want = _regrid_cases(ot), _regrid_cases(J)
    for k in ("z", "ones", "x"):
        assert _rel(got[k], want[k]) <= 1e-13, k
    c, zf = got["c"], got["zf"]
    out = _np(got["z"])
    assert out.shape == (4, 4, 16)
    lhs = c.sum(axis=2) / 32
    rhs = (out * np.diff(zf)[None, None, :]).sum(axis=2)
    assert np.allclose(lhs, rhs, atol=1e-12)
    assert np.allclose(_np(got["ones"]), 1.0, atol=1e-12)
    up = _np(got["x"])
    assert up.shape == (8, 4, 32)
    assert np.allclose(up.mean(axis=0), c.mean(axis=0), atol=1e-12)
    # the Field form
    f = ot.CenterField(ot.RectilinearGrid(size=(4, 4, 32),
                                          extent=(1.0, 1.0, 1.0),
                                          **_kw(ot))).set(c)
    dst = ot.RectilinearGrid(size=(4, 4, 16), x=(0, 1), y=(0, 1), z=zf,
                             **_kw(ot))
    assert np.array_equal(_np(ot.regrid(f, dst)), out)


# -- particles -------------------------------------------------------------------

def _age(grid, fields, particles, dt):
    return dict(particles, age=particles["age"] + dt)


def _particles_box(pkg, case):
    parts_mod = pkg.particles
    grid = pkg.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                               topology=(P, P, B), **_kw(pkg))
    if case == "drogued":
        parts = parts_mod.LagrangianParticles(
            x=[0.1, 0.6, 0.9], y=[0.5, 0.2, 0.95], z=[-0.5, -0.2, -0.9],
            dynamics=parts_mod.DroguedParticleDynamics([-0.3, -0.6, -0.3]))
    else:
        parts = parts_mod.LagrangianParticles(
            x=[0.1, 0.97, 0.5, 0.3], y=[0.5, 0.5, 0.02, 0.7],
            z=[-0.5, -0.03, -0.97, -0.5], restitution=0.5,
            tracked_fields=("u", "w", "c"), properties={"age": [0.0] * 4},
            dynamics=_age)
    model = pkg.NonhydrostaticModel(grid=grid, tracers=("c",),
                                    particles=parts)
    rng = np.random.default_rng(11)
    model.set(u=lambda x, y, z: 0.4 + 0.1 * np.sin(2 * np.pi * y),
              v=lambda x, y, z: -0.3 + 0.1 * np.cos(2 * np.pi * x),
              w=0.2 * rng.standard_normal(grid.N),
              c=rng.standard_normal(grid.N))
    for _ in range(3):
        model.time_step(0.1)
    return {k: _np(v) for k, v in model.state["particles"].items()}


@pytest.mark.parametrize("case", ["bounce_wrap_track", "drogued"])
def test_particles_against_jax(case):
    got, want = _particles_box(ot, case), _particles_box(J, case)
    assert got.keys() == want.keys()
    for k in got:
        assert _rel(got[k], want[k]) <= 1e-12, k
    assert np.all((got["z"] >= -1.0) & (got["z"] <= 0.0))
    assert np.all((got["x"] >= 0.0) & (got["x"] < 1.0))
    if case == "drogued":
        np.testing.assert_array_equal(got["z"], [-0.5, -0.2, -0.9])
    else:
        np.testing.assert_allclose(got["age"], 0.3, rtol=1e-12)


def _immersed_step(pkg):
    base = pkg.RectilinearGrid(size=(16, 1, 16), x=(0, 1.0), y=(0, 1.0),
                               z=(-1.0, 0.0), topology=(P, F, B), **_kw(pkg))
    return pkg.immersed.ImmersedBoundaryGrid(
        base, pkg.immersed.GridFittedBottom(
            lambda x, y: np.where(x > 0.5, -0.5, -1.0)))


def _particles_immersed(pkg, grid, solver):
    parts = pkg.particles.LagrangianParticles(x=[0.3, 0.4], y=[0.5, 0.5],
                                              z=[-0.75, -0.6],
                                              restitution=1.0)
    model = pkg.NonhydrostaticModel(grid=grid, advection=None,
                                    particles=parts, pressure_solver=solver)
    model.set(u=0.5)
    for _ in range(10):
        model.time_step(0.05)
    return {k: _np(v) for k, v in model.state["particles"].items()}


def test_particles_bounce_off_immersed_step_against_jax():
    """JAX's immersed-bounce case, 10 steps, both solvers at reltol
    1e-13."""
    jg, tg = _immersed_step(J), _immersed_step(ot)
    jsol, tsol = tight_solvers(jg, tg)
    got = _particles_immersed(ot, tg, tsol)
    want = _particles_immersed(J, jg, jsol)
    for k in ("x", "y", "z"):
        assert _rel(got[k], want[k]) <= 1e-12, k
    # no particle sits in the solid step (x > 0.5 below z = -0.5)
    assert not np.any((got["x"] > 0.5) & (got["z"] < -0.5))


# -- biogeochemistry ----------------------------------------------------------------

def _bgc_model(pkg, family):
    calls = []

    class Decay(pkg.biogeochemistry.SimpleBiogeochemistry):
        def update_state(self, model):
            calls.append(model.iteration)

    bgc = Decay(tracers=("P",),
                reactions={"P": lambda x, y, z, t, P: -0.5 * P + 0.0 * z},
                drift={"P": -0.05})
    if family == "nonhydrostatic":
        grid = pkg.RectilinearGrid(size=(4, 4, 16), extent=(1, 1, 1),
                                   **_kw(pkg))
        model = pkg.NonhydrostaticModel(grid=grid, biogeochemistry=bgc)
        dt = 0.05
    else:
        grid = pkg.RectilinearGrid(size=(4, 4, 8), extent=(1.0, 1.0, 1.0),
                                   topology=(P, P, B), **_kw(pkg))
        model = pkg.HydrostaticFreeSurfaceModel(
            grid=grid, momentum_advection=None, biogeochemistry=bgc)
        dt = 0.1
    assert "P" in model.tracer_names
    model.set(P=lambda x, y, z: np.exp(-((z + 0.3) / 0.1) ** 2))
    for _ in range(3):
        model.time_step(dt)
    return _np(model.field("P").interior), calls


@pytest.mark.parametrize("family", ["nonhydrostatic", "hydrostatic"])
def test_biogeochemistry_against_jax(family):
    (got, calls), (want, jcalls) = (_bgc_model(ot, family),
                                    _bgc_model(J, family))
    assert _rel(got, want) <= 1e-12
    assert calls == jcalls == [1, 2, 3]


def _aux_forcing(pkg, family):
    grid = pkg.RectilinearGrid(size=(4, 4, 4), extent=(1.0, 1.0, 1.0),
                               topology=(P, P, B), **_kw(pkg))
    A = pkg.CenterField(grid).set(2.0)
    Fc = pkg.forcings.ContinuousForcing(lambda x, y, z, t, c, A: -c * 0.0 + A,
                                        field_dependencies=("c", "A"))
    if family == "nonhydrostatic":
        model = pkg.NonhydrostaticModel(grid=grid, advection=None,
                                        tracers=("c",), forcing={"c": Fc},
                                        auxiliary_fields={"A": A})
    else:
        model = pkg.HydrostaticFreeSurfaceModel(
            grid=grid, momentum_advection=None, tracers=("c",),
            forcing={"c": Fc}, auxiliary_fields={"A": A})
    assert model.field("A") is A
    model.time_step(0.1)
    c1 = _np(model.field("c").interior)
    A.set(4.0)
    model.time_step(0.1)
    return c1, _np(model.field("c").interior)


@pytest.mark.parametrize("family", ["nonhydrostatic", "hydrostatic"])
def test_auxiliary_fields_against_jax(family):
    (c1, c2), (j1, j2) = _aux_forcing(ot, family), _aux_forcing(J, family)
    assert _rel(c1, j1) <= 1e-12 and _rel(c2, j2) <= 1e-12
    np.testing.assert_allclose(c1.mean(), 0.2, rtol=1e-5)
    # the second step sees the new A: Δt·A under RK3, and under the
    # hydrostatic model's quasi-AB2 Δt·(1.6·4 − 0.6·2)
    step2 = 0.4 if family == "nonhydrostatic" else 0.52
    np.testing.assert_allclose(c2.mean() - c1.mean(), step2, rtol=1e-4)


# -- ensembles -----------------------------------------------------------------------

AMPS = [0.01, 0.02, 0.03]


def _ensemble(pkg):
    grid = pkg.RectilinearGrid(size=(8, 8, 4), extent=(1, 1, 1), **_kw(pkg))

    def make():
        return pkg.HydrostaticFreeSurfaceModel(
            grid=grid, free_surface=pkg.ExplicitFreeSurface(
                gravitational_acceleration=0.5))

    eta = lambda a: (lambda x, y, z: a * np.cos(2 * np.pi * x))
    ens = pkg.models.ensemble.EnsembleModel(make(), n=3)
    ens.set_all(lambda i: dict(eta=eta(AMPS[i])))
    for _ in range(5):
        ens.time_step(1e-3)
    solos = []
    for a in AMPS:
        solo = make()
        solo.set(eta=eta(a))
        for _ in range(5):
            solo.time_step(1e-3)
        solos.append(_np(solo.field("eta").interior))
    return [_np(ens.field(i, "eta").interior) for i in range(3)], solos


def test_ensemble_against_jax():
    members, solos = _ensemble(ot)
    jmembers, _ = _ensemble(J)
    for i in range(3):
        np.testing.assert_array_equal(members[i], solos[i])
        assert _rel(members[i], jmembers[i]) <= 1e-12, i
    assert not np.array_equal(members[0], members[1])


# -- profiling ------------------------------------------------------------------------

def test_profiling_on_the_cpu(tmp_path):
    grid = ot.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1), **_kw(ot))
    model = ot.NonhydrostaticModel(grid, advection=ot.WENO(5),
                                   tracers=("c",))
    model.set(u=lambda x, y, z: np.sin(2 * np.pi * y))
    before = {k: v.clone() for k, v in model.state["fields"].items()}
    seconds = profiling.time_step(model, dt=1e-3, steps=2, warmup=1)
    assert 0 < seconds < 60
    logdir = profiling.profile_step(model, dt=1e-3, steps=1,
                                    logdir=str(tmp_path / "trace"))
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    assert model.iteration == 0
    for k, v in model.state["fields"].items():
        assert torch.equal(v, before[k]), k


# -- autodiff ---------------------------------------------------------------------------

def _grid8(pkg):
    return pkg.RectilinearGrid(size=(8, 8, 4), extent=(1, 1, 1),
                               topology=(P, P, P), **_kw(pkg))


def test_gradient_through_steps_against_jax():
    """d/dc₀ of Σc² after 3 steps of Centered(2) advection by u = 0.1
    sin(2πx) (the plain path)."""
    jgrid = _grid8(J)
    jm = J.NonhydrostaticModel(grid=jgrid, tracers=("c",),
                               advection=J.Centered(2), fused_advection=False)
    jm.set(u=lambda x, y, z: 0.1 * jnp.sin(2 * jnp.pi * x))
    step, base = jm._build_step(), jm.state
    dt = jnp.asarray(1e-2, jgrid.dtype)

    def loss(c0):
        state = dict(base, fields=dict(base["fields"], c=c0))
        for _ in range(3):
            state = step(state, dt)
        return jnp.sum(state["fields"]["c"][jgrid.interior_slices] ** 2)

    c0 = jm.state["fields"]["c"] + 0.1
    want = np.asarray(jax.grad(loss)(c0))

    tm = ot.NonhydrostaticModel(_grid8(ot), tracers=("c",),
                                advection=ot.Centered(2))
    tm.set(u=lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    assert tm.grid.padded_shape == jgrid.padded_shape
    c = torch.as_tensor(np.asarray(c0)).requires_grad_(True)
    # the step fills the halos in place: hand it a copy of the leaf
    tm.state = dict(tm.state, fields=dict(tm.state["fields"], c=c.clone()))
    for _ in range(3):
        tm.time_step(1e-2)
    ints = tm.grid.interior_slices
    (tm.state["fields"]["c"][ints] ** 2).sum().backward()
    got = c.grad.numpy()
    assert np.abs(got).max() > 0
    assert _rel(got, want) <= 1e-10


def test_gradient_wrt_viscosity_against_jax():
    """d/dν of Σu² after 2 steps, each followed by a ν∇²u diffusion of u
    as the step leaves it, as JAX's test_autodiff takes it: the
    diffusion reads u's halos, which both projections correct with the
    interior."""
    u0 = 0.1 * np.random.default_rng(0).standard_normal((8, 8, 4))
    loc = ("f", "c", "c")

    def jax_ke(nu):
        m = J.NonhydrostaticModel(grid=_grid8(J), fused_advection=False)
        m.set(u=u0)
        state, step = m.state, m._build_step()
        dkg = J.closures.diffusion_operators.div_kappa_grad
        for _ in range(2):
            state = step(state, jnp.asarray(1e-2, m.grid.dtype))
            f = dict(state["fields"])
            f["u"] = f["u"] + 1e-2 * dkg(m.grid, f["u"], loc, nu)
            state = dict(state, fields=f)
        return jnp.sum(state["fields"]["u"][m.grid.interior_slices] ** 2)

    want = float(jax.grad(jax_ke)(jnp.asarray(0.01, jnp.float64)))

    nu = torch.tensor(0.01, dtype=F64, requires_grad=True)
    m = ot.NonhydrostaticModel(_grid8(ot))
    m.set(u=u0)
    dkg = ot.closures.diffusion_operators.div_kappa_grad
    for _ in range(2):
        m.time_step(1e-2)
        f = dict(m.state["fields"])
        f["u"] = f["u"] + 1e-2 * dkg(m.grid, f["u"], loc, nu)
        m.state = dict(m.state, fields=f)
    ke = (m.state["fields"]["u"][m.grid.interior_slices] ** 2).sum()
    ke.backward()
    got = float(nu.grad)
    assert got < 0 and want < 0
    assert abs(got - want) <= 1e-10 * abs(want)
