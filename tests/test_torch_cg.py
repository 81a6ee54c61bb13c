"""The conjugate-gradient Poisson solvers and the NonhydrostaticModel on the
grids that take them, against the JAX package, on the CPU in float64.

- ``KrylovSolver`` (gmres, bicgstab, cg) on ``tests/test_solvers.py``'s
  nonsymmetric system (cg on a symmetric one), both at reltol 1e-13: 1e-10
  relative, and 1e-10 of the exact solution.
- ``make_immersed_poisson_solver`` on ``GridFittedBottom``,
  ``PartialCellBottom`` and ``GridFittedBoundary`` grids with the
  underlying grid's FFT preconditioner, ``make_variable_spacing_poisson_
  solver`` on grids stretched along two axes (with the preconditioner) and
  with a flat axis (without: the one case where JAX's construction
  fails), and ``ConjugateGradientPoissonSolver`` with a user operator, at
  reltol 1e-13 on both sides: 1e-10 relative to max|φ|.
- the model over 3 RK3 steps from the JAX state with the solvers built at
  reltol 1e-13 (``pressure_solver=`` on both sides): 1e-10 of the velocity
  scale; with the default solvers: 1e-6 (one more or one fewer CG
  iteration changes p by about the default tolerance). Immersed: a 3-D
  hill (``GridFittedBottom``, periodic x and y), a 2-D ``PartialCellBottom``
  ridge and a ``GridFittedBoundary`` block, each with WENO(5) and a
  buoyancy tracer, the hill with an immersed Flux condition on b. Stretched
  and curvilinear: bounded x and z stretched, all three stretched, a
  ``LatitudeLongitudeGrid`` (its solvers at reltol 1e-12, where its CG
  still converges; its p at 1e-6 of max|p|, the accuracy its Laplacian's
  condition number of about 2e7 leaves at any tolerance, and the fields p
  corrects at 1e-10).
- a grid stretched along a periodic axis: the JAX model's variable-spacing
  CG diverges there (NaN after its first step; ROADMAP queue 3); the port
  builds the same solver, and its CG runs to ``maxiter`` without
  converging.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
import oceananigans_tpu.advection as ja
import oceananigans_tpu.boundary_conditions as jbc
import oceananigans_tpu.buoyancy as jb
from oceananigans_tpu.immersed import (
    GridFittedBottom as JGFB, GridFittedBoundary as JGFBd,
    ImmersedBoundaryGrid as JIBG, PartialCellBottom as JPCB)
from oceananigans_tpu.models import NonhydrostaticModel as JModel
from oceananigans_tpu.solvers import conjugate_gradient as jcg
from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver as JFFT
from oceananigans_tpu.solvers.fourier_tridiagonal import \
    make_variable_spacing_poisson_solver as j_variable
from oceananigans_tpu.solvers.krylov import KrylovSolver as JKrylov
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.boundary_conditions import (
    fill_halo_regions as t_fill, regularize_field_boundary_conditions as t_reg)
from oceananigans_tpu_torch.immersed import (
    GridFittedBottom as TGFB, GridFittedBoundary as TGFBd,
    ImmersedBoundaryGrid as TIBG, PartialCellBottom as TPCB)
from oceananigans_tpu_torch.models import NonhydrostaticModel, state_from_jax
from oceananigans_tpu_torch.solvers import (
    ConjugateGradientPoissonSolver, FFTPoissonSolver, KrylovSolver,
    conjugate_gradient, make_immersed_poisson_solver,
    make_variable_spacing_poisson_solver)

torch.set_num_threads(1)

F64 = torch.float64
CCC = ("c", "c", "c")
P, B, F = "periodic", "bounded", "flat"
TIGHT = 1e-13
FACES = np.cumsum(np.r_[0.0, 1.0 + 0.3 * np.sin(np.arange(8))])


def rel(got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    return np.abs(got - want).max() / max(scale, 1e-300)


# -- Krylov ---------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gmres", "bicgstab", "cg"])
def test_krylov_against_jax(method):
    rng = np.random.default_rng(11)
    n = 24
    A = np.eye(n) * 4 + 0.3 * rng.standard_normal((n, n))
    if method == "cg":
        A = 0.5 * (A + A.T)
    b = rng.standard_normal(n)
    exact = np.linalg.solve(A, b)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    want = np.asarray(JKrylov(lambda x: Aj @ x, method=method, reltol=TIGHT,
                              maxiter=200).solve(jnp.asarray(b)))
    got = KrylovSolver(lambda x: At @ x, method=method, reltol=TIGHT,
                       maxiter=200).solve(torch.as_tensor(b)).numpy()
    assert rel(got, want) <= 1e-10
    assert rel(got, exact) <= 1e-10
    with pytest.raises(ValueError):
        KrylovSolver(lambda x: x, method="minres")


def test_krylov_preconditioned_against_jax():
    """GMRES and BiCGStab with a Jacobi preconditioner."""
    rng = np.random.default_rng(4)
    n = 30
    A = np.diag(np.linspace(1.0, 20.0, n)) + 0.2 * rng.standard_normal(
        (n, n))
    b = rng.standard_normal(n)
    d = np.diag(A)
    for method in ("gmres", "bicgstab"):
        Aj, At = jnp.asarray(A), torch.as_tensor(A)
        want = np.asarray(JKrylov(
            lambda x: Aj @ x, method=method, reltol=TIGHT, maxiter=300,
            preconditioner=lambda r: r / jnp.asarray(d)).solve(
                jnp.asarray(b)))
        got = KrylovSolver(
            lambda x: At @ x, method=method, reltol=TIGHT, maxiter=300,
            preconditioner=lambda r: r / torch.as_tensor(d)).solve(
                torch.as_tensor(b)).numpy()
        assert rel(got, want) <= 1e-10, method


# -- the Poisson solvers ----------------------------------------------------------

def _bottom(x, y):
    return -1.0 + 0.45 * np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.05)


def _block(x, y, z):
    return (np.abs(x - 0.5) < 0.2) & (z < -0.6) & (y == y)


IMMERSED = {
    "gridfitted_3d": (dict(size=(10, 8, 6), x=(0, 1.0), y=(0, 1.0),
                           z=(-1.0, 0.0), topology=(P, P, B)),
                      JGFB, TGFB, _bottom),
    "partialcell_2d": (dict(size=(16, 1, 8), x=(0, 1.0), z=(-1.0, 0.0),
                            topology=(B, F, B)),
                       JPCB, TPCB, lambda x, y: _bottom(x, 0.5 + 0 * x)),
    "boundary_block": (dict(size=(12, 8, 8), x=(0, 1.0), y=(0, 1.0),
                            z=(-1.0, 0.0), topology=(B, P, B)),
                       JGFBd, TGFBd, _block),
}


def immersed_grids(case, halo=None):
    spec, JI, TI, geometry = IMMERSED[case]
    kw = dict(spec, **({} if halo is None else dict(halo=halo)))
    return (JIBG(jo.RectilinearGrid(dtype=np.float64, **kw), JI(geometry)),
            TIBG(ot.RectilinearGrid(dtype=F64, device="cpu", **kw),
                 TI(geometry)))


def _compatible_rhs(grid_int_shape, solid, V, seed):
    """A random rhs that is zero on solid cells, with zero volume-weighted
    mean over the fluid (the Neumann compatibility of the masked
    problem)."""
    b = np.random.default_rng(seed).standard_normal(grid_int_shape)
    fluid = ~solid
    b = np.where(solid, 0.0, b - (b * V)[fluid].sum() / V[fluid].sum())
    return b


@pytest.mark.parametrize("case", sorted(IMMERSED))
def test_immersed_solver_against_jax(case):
    jg, tg = immersed_grids(case)
    jbcs = jbc.regularize_field_boundary_conditions(None, jg, CCC)
    tbcs = t_reg(None, tg, CCC)
    js = jcg.make_immersed_poisson_solver(
        jg, lambda p: jbc.fill_halo_regions(p, jg, CCC, jbcs),
        JFFT(jg.underlying_grid), reltol=TIGHT, maxiter=400)
    ts = make_immersed_poisson_solver(
        tg, lambda p: t_fill(p, tg, CCC, tbcs),
        FFTPoissonSolver(tg.underlying_grid), reltol=TIGHT, maxiter=400)
    ii = tg.interior_slices
    V = np.broadcast_to(tg.V(CCC).numpy() if torch.is_tensor(tg.V(CCC))
                        else tg.V(CCC), tg.padded_shape)[ii]
    b = _compatible_rhs(tg.N, tg.solid_ccc[ii], V, 3)
    want = np.asarray(js.solve(jnp.asarray(b)))
    got = ts.solve(torch.as_tensor(b)).numpy()
    assert rel(got, want) <= 1e-10
    assert ts.preconditioner is not None
    # identity rows on the solid cells
    x = np.random.default_rng(4).standard_normal(tg.N)
    solid = tg.solid_ccc[ii]
    assert solid.any()
    assert np.array_equal(ts.operator(torch.as_tensor(x)).numpy()[solid],
                          x[solid])


VARIABLE = {
    "xz_stretched": dict(size=(8, 4, 8), x=tuple(FACES), y=(0, 1.0),
                         z=tuple(FACES - FACES[-1]), topology=(B, P, B)),
    "xyz_stretched": dict(size=(8, 8, 8), x=tuple(FACES), y=tuple(FACES),
                          z=tuple(FACES - FACES[-1]), topology=(B, B, B)),
    "flat_y": dict(size=(8, 8), x=tuple(FACES), z=tuple(FACES - FACES[-1]),
                   topology=(B, F, B)),
}


@pytest.mark.parametrize("case", sorted(VARIABLE))
def test_variable_spacing_solver_against_jax(case):
    """JAX wraps the preconditioner's construction in a blanket ``except``:
    it fails exactly where a Flat axis makes ``RectilinearGrid(extent=
    grid.extent)`` refuse three extents; the port takes no preconditioner
    there and one everywhere else."""
    spec = VARIABLE[case]
    jg = jo.RectilinearGrid(dtype=np.float64, **spec)
    tg = ot.RectilinearGrid(dtype=F64, device="cpu", **spec)
    js = j_variable(jg, reltol=TIGHT, maxiter=600)
    ts = make_variable_spacing_poisson_solver(tg, reltol=TIGHT, maxiter=600)
    assert (ts.preconditioner is None) == (case == "flat_y")
    regular = dict(size=jg.N, extent=jg.extent, topology=jg.topology,
                   halo=jg.H)
    if case == "flat_y":
        with pytest.raises(ValueError, match="extent length"):
            jo.RectilinearGrid(**regular)
    else:
        jo.RectilinearGrid(**regular)
    b = np.random.default_rng(5).standard_normal(tg.N)
    want = np.asarray(js.solve(jnp.asarray(b)))
    got = ts.solve(torch.as_tensor(b)).numpy()
    assert rel(got, want) <= 1e-10


def test_user_operator_solver_against_jax():
    """ConjugateGradientPoissonSolver with a symmetric user operator (a
    1-D Neumann Laplacian along z) and a diagonal preconditioner."""
    n = 12
    L = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 1), -1))
    L[0, 0] = L[-1, -1] = -1.0
    A = -L + 1e-3 * np.eye(n)
    b = np.random.default_rng(2).standard_normal(n)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    js = jcg.ConjugateGradientPoissonSolver(
        None, lambda x: Aj @ x, preconditioner=lambda r: r / 2.0,
        reltol=TIGHT, maxiter=100)
    ts = ConjugateGradientPoissonSolver(
        None, lambda x: At @ x, preconditioner=lambda r: r / 2.0,
        reltol=TIGHT, maxiter=100)
    assert rel(ts.solve(torch.as_tensor(b)).numpy(),
               np.asarray(js.solve(jnp.asarray(b)))) <= 1e-10


# -- the model --------------------------------------------------------------------

def numpy_state(state):
    return {k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


def tight_solvers(jg, tg):
    """The models' solver at reltol 1e-13 on each side, for the models'
    grids (with their halos; the default fill of p)."""
    jbcs = jbc.regularize_field_boundary_conditions(None, jg, CCC)
    tbcs = t_reg(None, tg, CCC)
    jfill = lambda p: jbc.fill_halo_regions(p, jg, CCC, jbcs)
    tfill = lambda p: t_fill(p, tg, CCC, tbcs)
    if hasattr(tg, "solid_ccc"):
        under = tg.underlying_grid
        return (jcg.make_immersed_poisson_solver(
            jg, jfill, JFFT(jg.underlying_grid) if under.all_regular
            else None, reltol=TIGHT, maxiter=500),
            make_immersed_poisson_solver(
                tg, tfill, FFTPoissonSolver(under) if under.all_regular
                else None, reltol=TIGHT, maxiter=500))
    # a lat-lon grid's CG, preconditioned on degrees as lengths, stalls
    # above 1e-13: 1e-12 there
    tol = 1e-12 if hasattr(tg, "radius") else TIGHT
    return (j_variable(jg, jfill, reltol=tol, maxiter=3000),
            make_variable_spacing_poisson_solver(tg, tfill, reltol=tol,
                                                 maxiter=3000))


def run_pair(jgrid, tgrid, jkw, tkw, values, dt, tight, halo):
    """Both models on the grids, the port loaded with the JAX state, 3
    steps. With ``tight`` each model is given ``pressure_solver=`` built at
    reltol 1e-13 on its grid at the model's halos (``halo`` for the port;
    the JAX model's, which rounds Hy up to 8, read off a first build)."""
    if tight:
        jsol, tsol = tight_solvers(JModel(grid=jgrid, **jkw).grid,
                                   tgrid.with_halo(halo))
        jkw, tkw = dict(jkw, pressure_solver=jsol), dict(
            tkw, pressure_solver=tsol)
    jm = JModel(grid=jgrid, **jkw)
    tm = NonhydrostaticModel(tgrid, fuse_correction=False, **tkw)
    assert tuple(tm.grid.H) == tuple(halo)
    jm.set(**values)
    state_from_jax(numpy_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(dt)
        tm.time_step(dt)
    return jm, tm


def check_pair(jm, tm, tol, p_tol=None):
    scale = max(np.abs(np.asarray(jm.field(c).interior)).max() for c in "uvw")
    p_tol = tol if p_tol is None else p_tol
    for name in list(tm.state["fields"]) + ["p"]:
        got = tm.field(name).interior.numpy()
        want = np.asarray(jm.field(name).interior)
        assert np.isfinite(got).all(), name
        # velocities to the velocity scale, p to the larger of it and its
        # own (on a lat-lon grid p ~ uΔx/Δt is far larger than u)
        err = rel(got, want, max(scale, np.abs(want).max()) if name == "p"
                  else scale if name in "uvw" else None)
        assert err <= (p_tol if name == "p" else tol), (name, err)


def _immersed_physics(lib, side, case):
    weno = (ja.WENO(5, smoothness_dtype=jnp.float64) if side == "jax"
            else ot.WENO(5, smoothness_dtype=F64))
    kw = dict(advection=weno,
              buoyancy=(jb.BuoyancyTracer() if side == "jax"
                        else ot.BuoyancyTracer()))
    if case == "gridfitted_3d":
        JI = (jbc.ImmersedBoundaryCondition if side == "jax"
              else ot.ImmersedBoundaryCondition)
        flux = (jbc.FluxBoundaryCondition if side == "jax"
                else ot.FluxBoundaryCondition)(1e-4)
        kw["boundary_conditions"] = {"b": lib.FieldBoundaryConditions(
            immersed=JI(bottom=flux, west=flux))}
    return kw


# the JAX model's halos (it rounds Hy up to 8 where y is not flat), given to
# both grids: near a periodic seam the immersed masks' rolls wrap the padded
# array, so WENO's near-wall cascade depends on the halo (ROADMAP queue 3)
HALO = {"gridfitted_3d": (3, 8, 3), "partialcell_2d": (3, 0, 3),
        "boundary_block": (3, 8, 3)}


@pytest.mark.parametrize("tight", [True, False], ids=["tight", "default"])
@pytest.mark.parametrize("case", sorted(IMMERSED))
def test_immersed_model_against_jax(case, tight):
    jg, tg = immersed_grids(case, HALO[case])
    N = tg.N
    rng = np.random.default_rng(0)
    values = {c: 0.05 * rng.standard_normal(N) for c in "uvw"}
    values["b"] = 1e-3 * rng.standard_normal(N)
    jm, tm = run_pair(jg, tg, _immersed_physics(jo, "jax", case),
                      _immersed_physics(ot, "torch", case), values, 2e-2,
                      tight, HALO[case])
    assert tm.immersed and not tm._kernel_tendency and not tm._z_compact
    check_pair(jm, tm, 1e-10 if tight else 1e-6)
    # the solid cells stay zero
    for c in "uvw":
        fluid = tm.grid.fluid_mask(tm.loc(c)).bool()
        assert torch.all(tm.state["fields"][c][~fluid] == 0)


STRETCHED = {
    "xz_stretched": (lambda lib, kw: lib.RectilinearGrid(
        size=(8, 4, 8), x=tuple(FACES), y=(0, 1.0),
        z=tuple(FACES - FACES[-1]), topology=(B, P, B), **kw), (3, 3, 3)),
    "xyz_stretched": (lambda lib, kw: lib.RectilinearGrid(
        size=(8, 8, 8), x=tuple(FACES), y=tuple(FACES),
        z=tuple(FACES - FACES[-1]), topology=(B, B, B), **kw), (3, 3, 3)),
    "latlon": (lambda lib, kw: lib.LatitudeLongitudeGrid(
        size=(8, 6, 4), longitude=(0, 60), latitude=(10, 50), z=(-100, 0),
        **kw), (3, 3, 3)),
}


@pytest.mark.parametrize("tight", [True, False], ids=["tight", "default"])
@pytest.mark.parametrize("case", sorted(STRETCHED))
def test_stretched_and_curvilinear_models_against_jax(case, tight):
    make, halo = STRETCHED[case]
    jg = make(jo, dict(dtype=np.float64))
    tg = make(ot, dict(dtype=F64, device="cpu"))
    rng = np.random.default_rng(1)
    values = {k: 0.1 * rng.standard_normal(tg.N) for k in ("u", "v", "c")}
    jm, tm = run_pair(jg, tg, dict(advection=ja.Centered(2), tracers=("c",)),
                      dict(advection=ot.Centered(2), tracers=("c",)),
                      values, 1e-2, tight, halo)
    assert hasattr(tm.pressure_solver, "operator")
    # on the lat-lon grid the Laplacian's condition number, about
    # (Δx/Δz)² ≈ 2e7, leaves p accurate to about 1e-7 of max|p| at any CG
    # tolerance (at 1e-13 its CG stalls): p is held there at 1e-6, the
    # fields it corrects at 1e-10
    check_pair(jm, tm, 1e-10 if tight else 1e-6,
               1e-6 if case == "latlon" else None)


def test_periodic_stretched_axis_pinned():
    """A grid stretched along a periodic axis: the JAX model takes its
    variable-spacing CG and produces NaN in its first step (ROADMAP queue
    3); the port takes the same solver, whose CG runs to maxiter without
    reaching its tolerance, and its fields stay finite."""
    spec = dict(size=(8, 4, 6), x=tuple(FACES), y=(0, 1.0), z=(-1, 0),
                topology=(P, P, B))
    rng = np.random.default_rng(0)
    N = (8, 4, 6)
    values = {k: 0.1 * rng.standard_normal(N) for k in ("u", "v", "c")}
    jm = JModel(grid=jo.RectilinearGrid(dtype=np.float64, **spec),
                advection=ja.Centered(2), tracers=("c",))
    tm = NonhydrostaticModel(ot.RectilinearGrid(dtype=F64, device="cpu",
                                                **spec),
                             advection=ot.Centered(2), tracers=("c",))
    jm.set(**values)
    tm.set(**values)
    jm.time_step(1e-2)
    assert not np.isfinite(np.asarray(jm.state["fields"]["u"])).all()
    conjugate_gradient.iterations.clear()
    tm.time_step(1e-2)
    assert list(conjugate_gradient.iterations) == [500] * 3
    assert all(torch.isfinite(a).all() for a in tm.state["fields"].values())
