"""The port's NonhydrostaticModel on every topology the JAX model takes on a
RectilinearGrid, against the JAX package, on the CPU in float64.

- ``FFTPoissonSolver`` on ten combinations of Periodic, Bounded and Flat
  axes against JAX's ``solve`` (1e-12 relative to max|φ|: both solve
  exactly, the JAX CPU path through matmul DFTs, the port through
  torch.fft), with the Laplacian residual |∇²φ − b| < 1e-9 for a zero-mean
  b (the recipe of ``tests/test_solvers.py``).
- ``fill_halos`` on a periodic z and with flat axes against JAX's
  ``fill_halo_regions``: 1e-15 relative (copies and reflections agree bit
  for bit; a Value or Gradient extrapolation rounds alike to one ulp).
- the plain tendency #6 on a flat and on a periodic z against JAX's
  ``build_fused_advection`` in interpret mode, 1e-12 relative.
- the route each topology takes (z-compact, the tendency kernel #6, or the
  plain flux divergences), the same as the JAX model's on a grid whose Nz
  passes the TPU's Nz % 128 gate (the port takes the z-compact layout at any
  Nz).
- the model on each topology over 3 RK3 steps from the JAX state
  (``state_from_jax``) at 1e-10 relative to each field's largest value.
  Velocities and pressure are held to at least 1e-10 of the velocity
  scale: the largest velocity, or the buoyancy's increment of a step,
  max|b|·Δt, where that is larger (the internal wave at 32² starts at the
  grid's Nyquist wavenumber, which the projection removes, so its
  velocities are the roundoff of the hydrostatic balance of b ≈ 3; w and p
  of a one-dimensional column stay zero). Compared are the first N faces of
  a bounded axis (the z-compact layout stores no top face). The port keeps
  the per-stage projection
  (``fuse_correction=False``), so its stored pressure is the JAX padded
  path's.
- the six examples the topologies open, at ``tests/test_examples.py``'s
  sizes with their physics, from the JAX state, 3 steps at 1e-10 (WENO with
  float64 smoothness, so that no float32 rounding of the indicators enters
  the comparison).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
import oceananigans_tpu.advection as ja
import oceananigans_tpu.buoyancy as jb
import oceananigans_tpu.closures as jc
import oceananigans_tpu.coriolis as jcor
import oceananigans_tpu.forcings as jf
from oceananigans_tpu.boundary_conditions import (
    fill_halo_regions as j_fill, regularize_field_boundary_conditions as j_reg)
from oceananigans_tpu.kernels.fused_advection import build_fused_advection
from oceananigans_tpu.models import NonhydrostaticModel as JModel
from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver as JFFT
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.boundary_conditions import (
    fill_all_halo_regions, regularize_field_boundary_conditions as t_reg)
from oceananigans_tpu_torch.kernels import fused_advection as fa
from oceananigans_tpu_torch.models import NonhydrostaticModel, state_from_jax
from oceananigans_tpu_torch.operators.operators import (ddx, ddy, ddz, dx_c,
                                                        dy_c, dz_c)
from oceananigans_tpu_torch.solvers import FFTPoissonSolver

torch.set_num_threads(1)

P, B, F = "periodic", "bounded", "flat"
F64 = torch.float64
CCC = ("c", "c", "c")
TOPOLOGIES = [(P, P, P), (P, P, B), (B, B, B), (P, B, B), (B, P, B),
              (P, F, B), (P, F, P), (B, F, B), (P, P, F), (F, F, B)]
IDS = ["".join(t[0] for t in topo) for topo in TOPOLOGIES]
MODEL_TOL = 1e-10


def grid_kw(topo, n=(8, 6, 10), extent=(1.0, 2.0, 0.5)):
    """Size and extent of the non-flat axes, as both grids take them."""
    keep = [ax for ax in range(3) if topo[ax] != F]
    return dict(size=tuple(n[ax] for ax in keep),
                extent=tuple(extent[ax] for ax in keep), topology=topo)


def full_shape(topo, n=(8, 6, 10)):
    return tuple(1 if t == F else k for t, k in zip(topo, n))


def rel(got, want, floor=1e-300):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    return 0.0 if err == 0 else err / max(np.abs(want).max(), floor)


def numpy_state(state):
    return {k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


def laplacian(grid, phi_int):
    """∇²φ over the interior, φ's halos filled with the default (Neumann
    on bounded axes, periodic) conditions; flat axes add no term."""
    phi = torch.zeros(grid.padded_shape, dtype=F64)
    phi[grid.interior_slices] = phi_int
    fill_all_halo_regions([phi], grid, [(CCC, t_reg(None, grid, CCC))])
    total = torch.zeros_like(phi)
    for ax, (d, delta, A) in enumerate(
            ((ddx, dx_c, grid.Ax), (ddy, dy_c, grid.Ay),
             (ddz, dz_c, grid.Az))):
        if grid.is_flat(ax):
            continue
        loc = tuple("f" if a == ax else "c" for a in range(3))
        total = total + delta(grid, A(loc) * d(grid, phi, loc))
    return (total / grid.V(CCC))[grid.interior_slices]


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=IDS)
def test_fft_solver_against_jax(topo):
    kw = grid_kw(topo)
    N = full_shape(topo)
    b = np.random.default_rng(3).standard_normal(N)
    b -= b.mean()
    want = np.asarray(JFFT(jo.RectilinearGrid(dtype=np.float64, **kw))
                      .solve(jnp.asarray(b)))
    grid = ot.RectilinearGrid(dtype=F64, device="cpu", **kw)
    got = FFTPoissonSolver(grid).solve(torch.as_tensor(b))
    assert rel(got.numpy(), want) <= 1e-12
    res = (laplacian(grid, got) - torch.as_tensor(b)).abs().max().item()
    assert res < 1e-9, res


FILL_TOPOLOGIES = [(P, P, P), (P, F, P), (B, B, P), (P, F, B), (F, F, B),
                   (P, P, F), (B, F, B)]


@pytest.mark.parametrize("topo", FILL_TOPOLOGIES,
                         ids=["".join(t[0] for t in x)
                              for x in FILL_TOPOLOGIES])
def test_fill_against_jax(topo):
    """Every location under Value, Gradient and Flux conditions on the
    bounded sides (scalars; periodic sides wrap, flat axes have no halo)."""
    kw = dict(grid_kw(topo), halo=tuple(
        h for t, h in zip(topo, (3, 2, 4)) if t != F))
    jg = jo.RectilinearGrid(dtype=np.float64, **kw)
    tg = ot.RectilinearGrid(dtype=F64, device="cpu", **kw)
    rng = np.random.default_rng(7)
    sides = ("west", "east", "south", "north", "bottom", "top")
    kinds = ("Value", "Gradient", "Flux")
    for r in range(3):
        for loc in (CCC, ("f", "c", "c"), ("c", "f", "c"), ("c", "c", "f")):
            spec = {}
            for s, side in enumerate(sides):
                if topo[s // 2] == B and loc[s // 2] == "c":
                    spec[side] = (kinds[(s + r) % 3], 0.1 * (s + 1))
            jbcs = j_reg(jo.FieldBoundaryConditions(**{
                side: getattr(jo, k + "BoundaryCondition")(v)
                for side, (k, v) in spec.items()}), jg, loc)
            tbcs = t_reg(ot.FieldBoundaryConditions(**{
                side: getattr(ot, k + "BoundaryCondition")(v)
                for side, (k, v) in spec.items()}), tg, loc)
            a = rng.standard_normal(tg.padded_shape)
            want = np.asarray(j_fill(jnp.asarray(a), jg, loc, jbcs))
            got = fill_all_halo_regions([torch.as_tensor(a.copy())], tg,
                                        [(loc, tbcs)])[0].numpy()
            assert rel(got, want) <= 1e-15, (r, loc)


Z_SCHEMES = {
    "WENO(5)": (lambda: ja.WENO(5, smoothness_dtype=jnp.float64),
                lambda: ot.WENO(5, smoothness_dtype=F64)),
    "WENO(9)": (lambda: ja.WENO(9, smoothness_dtype=jnp.float64),
                lambda: ot.WENO(9, smoothness_dtype=F64)),
    "UpwindBiased(5)": (lambda: ja.UpwindBiased(5),
                        lambda: ot.UpwindBiased(5)),
    "Centered(2)": (lambda: ja.Centered(2), lambda: ot.Centered(2)),
}


@pytest.mark.parametrize("scheme", sorted(Z_SCHEMES))
@pytest.mark.parametrize("topo", [(P, P, F), (P, P, P)], ids=["flat_z",
                                                             "periodic_z"])
def test_plain_tendency_against_jax_kernel(topo, scheme):
    """The plain #6 with a tracer on a flat z (16x16x1, Hz = 0) and on a
    periodic z (16x16x12, Hz = the reach) against the JAX Pallas kernel
    in interpret mode; Hy is 8, the JAX kernel's sublane rule."""
    js, ts = (make() for make in Z_SCHEMES[scheme])
    r = ts.required_halo
    kw = dict(grid_kw(topo, (16, 16, 12), (1.0, 2.0, 0.5)),
              halo=(r, 8) if topo[2] == F else (r, 8, r))
    jg = jo.RectilinearGrid(dtype=np.float64, **kw)
    tg = ot.RectilinearGrid(dtype=F64, device="cpu", **kw)
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(tg.padded_shape) for _ in range(4)]
    Gu, Gv, Gw, Gc = build_fused_advection(jg, js, ("c",))(
        *[jnp.asarray(a) for a in arrays[:3]], {"c": jnp.asarray(arrays[3])})
    got = fa.fused_advection_tendency_plain(
        tg, ts, [torch.as_tensor(a) for a in arrays]).numpy()
    for k, G in enumerate((Gu, Gv, Gw, Gc["c"])):
        assert rel(got[k], np.asarray(G)[jg.interior_slices]) <= 1e-12, k


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=IDS)
def test_route_as_jax(topo):
    """z-compact, #6 or the plain flux divergences, as the JAX model
    chooses, at Nz = 128 (the JAX z-compact gate); a stretched axis takes
    the plain route and the Fourier-tridiagonal solver in both."""
    kw = grid_kw(topo, (8, 8, 128))
    jm = JModel(grid=jo.RectilinearGrid(dtype=np.float64, **kw),
                advection=ja.WENO(5), tracers=("c",))
    tm = NonhydrostaticModel(ot.RectilinearGrid(dtype=F64, device="cpu",
                                                **kw),
                             advection=ot.WENO(5), tracers=("c",))
    assert tm._z_compact == jm._z_compact
    assert tm._kernel_tendency == (jm._fused_advection is not None)
    assert type(tm.pressure_solver).__name__ == \
        type(jm.pressure_solver).__name__
    assert all(tm.grid.H[ax] == 0 for ax in range(3) if topo[ax] == F)


def model_pair(jkw, tkw, grid_spec, init, dt, steps=3):
    """The JAX model built from ``jkw``, set by ``init(jm)``, and the port's
    from ``tkw`` loaded with the JAX state; both take ``steps`` steps of
    Δt. Returns the two models."""
    jm = JModel(grid=jo.RectilinearGrid(dtype=np.float64, **grid_spec),
                **jkw)
    init(jm)
    start = numpy_state(jm.state)
    tm = NonhydrostaticModel(ot.RectilinearGrid(dtype=F64, device="cpu",
                                                **grid_spec),
                             fuse_correction=False, **tkw)
    assert set(tm.state["fields"]) == set(start["fields"])
    state_from_jax(start, tm)
    for _ in range(steps):
        jm.time_step(dt)
        tm.time_step(dt)
    return jm, tm


def check_models(jm, tm, dt):
    scale = max(np.abs(np.asarray(jm.field(c).interior)).max()
                for c in "uvw")
    if "b" in jm.tracer_names:
        scale = max(scale, dt * np.abs(np.asarray(jm.field("b").interior))
                    .max())
    for name in list(tm.state["fields"]) + ["p"]:
        got = tm.field(name).interior.numpy()
        want = np.asarray(jm.field(name).interior)[
            tuple(slice(0, n) for n in got.shape)]
        assert rel(got, want, scale if name in "uvwp" else 1e-300) \
            <= MODEL_TOL, name


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=IDS)
def test_model_against_jax(topo):
    """WENO(5) (float64 smoothness) with a tracer, random u, v, w and c."""
    spec = grid_kw(topo)
    N = full_shape(topo)
    rng = np.random.default_rng(0)
    values = {k: 0.1 * rng.standard_normal(N) for k in ("u", "v", "w", "c")}
    jm, tm = model_pair(
        dict(advection=ja.WENO(5, smoothness_dtype=jnp.float64),
             tracers=("c",)),
        dict(advection=ot.WENO(5, smoothness_dtype=F64), tracers=("c",)),
        spec, lambda m: m.set(**values), 1e-2)
    check_models(jm, tm, 1e-2)


# -- the examples the topologies open ---------------------------------------------

def two_dimensional_turbulence(lib, side):
    n = 32
    spec = dict(size=(n, n), x=(0, 2 * np.pi), y=(0, 2 * np.pi),
                topology=(P, P, F))
    rng = np.random.default_rng(123)
    values = dict(u=rng.standard_normal((n, n, 1)),
                  v=rng.standard_normal((n, n, 1)))
    return spec, dict(advection=weno5(side)), values, 0.01


def internal_wave(lib, side):
    n = 32
    N2, f = 1.0, 0.2
    spec = dict(size=(n, n), x=(-np.pi, np.pi), z=(-np.pi, np.pi),
                topology=(P, F, P))
    k, m, A = 16.0, 16.0, 1e-6
    om = np.sqrt((N2 * k ** 2 + f ** 2 * m ** 2) / (k ** 2 + m ** 2))
    U, V = k * om / (om ** 2 - f ** 2), k * f / (om ** 2 - f ** 2)
    W, Bb = m / om, m * N2 / om ** 2

    def env(x, z):
        return A * np.exp(-(x ** 2 + z ** 2) / (2 * 0.25))

    kw = dict(advection=lib.Centered(4), coriolis=lib.FPlane(f),
              buoyancy=lib.BuoyancyTracer(), tracers=("b",))
    values = dict(
        u=lambda x, y, z: env(x, z) * U * np.cos(k * x + m * z),
        v=lambda x, y, z: env(x, z) * V * np.sin(k * x + m * z),
        w=lambda x, y, z: env(x, z) * W * np.cos(k * x + m * z),
        b=lambda x, y, z: N2 * z + env(x, z) * Bb * np.sin(k * x + m * z))
    return spec, kw, values, 2 * np.pi / om / 200


def kelvin_helmholtz_instability(lib, side):
    nx = nz = 16
    Ri = 0.1
    spec = dict(size=(nx, nz), x=(-5, 5), z=(-5, 5), topology=(P, F, B))
    noise = 1e-3 * np.random.default_rng(7).standard_normal((nx, 1, nz))
    kw = dict(advection=weno5(side), buoyancy=lib.BuoyancyTracer(),
              tracers=("b",))
    values = dict(u=lambda x, y, z: np.tanh(z), b=lambda x, y, z:
                  Ri * np.tanh(z), w=noise)
    return spec, kw, values, 0.02


def convecting_plankton(lib, side):
    n = 16
    hour, day = 3600.0, 86400.0
    spec = dict(size=(n, 1, n), x=(0, 64.0), y=(0, 1.0), z=(-64.0, 0.0),
                topology=(P, F, B))
    ex = jnp.exp if side == "jax" else torch.exp
    ext = jnp.exp if side == "jax" else np.exp     # of the time
    Qb0, shutoff, N2 = 1e-8, 2 * hour, 1e-4
    mu0, lam, mort = 1.0 / day, 5.0, 0.1 / day
    forcing_lib = jf if side == "jax" else ot
    kw = dict(
        advection=lib.UpwindBiased(5),
        closure=lib.ScalarDiffusivity(nu=1e-4, kappa=1e-4),
        coriolis=lib.FPlane(f=1e-4), tracers=("b", "P"),
        buoyancy=lib.BuoyancyTracer(),
        forcing={"P": forcing_lib.ContinuousForcing(
            lambda x, y, z, t, P_: (mu0 * ex(z / lam) - mort) * P_,
            field_dependencies="P")},
        boundary_conditions={"b": lib.FieldBoundaryConditions(
            top=lib.FluxBoundaryCondition(
                lambda x, y, t: Qb0 * ext(-t ** 4 / (24 * shutoff ** 4))
                + 0 * x),
            bottom=lib.GradientBoundaryCondition(N2))})
    rng = np.random.default_rng(11)

    def b0(x, y, z):
        shape = np.broadcast_shapes(np.shape(x), np.shape(y), np.shape(z))
        strat = np.where(z < -32.0, N2 * z, -N2 * 32.0)
        return strat + 1e-4 * N2 * 64.0 * rng.standard_normal(shape) \
            * np.exp(z / 4)

    return spec, kw, dict(b=b0, P=1.0), 120.0


def one_dimensional_diffusion(lib, side):
    n = 32
    spec = dict(size=(1, 1, n), x=(0, 1.0), y=(0, 1.0), z=(-0.5, 0.5),
                topology=(F, F, B))
    kw = dict(tracers=("T",), closure=lib.ScalarDiffusivity(kappa=1.0))
    values = dict(T=lambda x, y, z: np.exp(-z ** 2 / (2 * 0.1 ** 2)))
    return spec, kw, values, 0.1 / n ** 2


def tilted_bottom_boundary_layer(lib, side):
    nx = nz = 16
    Lx, Lz, refinement, stretching = 200.0, 100.0, 1.8, 10.0
    h = (nz - np.arange(nz + 1)) / nz
    zeta = 1 + (h - 1) / refinement
    Sig = (1 - np.exp(-stretching * h)) / (1 - np.exp(-stretching))
    z_faces = -Lz * (zeta * Sig - 1)
    spec = dict(size=(nx, 1, nz), x=(0, Lx), y=(0, 1.0), z=z_faces,
                topology=(P, F, B))
    zhat = (np.sin(np.radians(3.0)), 0.0, np.cos(np.radians(3.0)))
    N2, V_inf = 1e-5, 0.1
    z1 = float(0.5 * (z_faces[0] + z_faces[1]))
    cD = (0.4 / np.log(z1 / 0.1)) ** 2

    def drag_u(x, y, t, u, v):
        return -cD * (u ** 2 + (v + V_inf) ** 2) ** 0.5 * u

    def drag_v(x, y, t, u, v):
        return -cD * (u ** 2 + (v + V_inf) ** 2) ** 0.5 * (v + V_inf)

    kw = dict(
        buoyancy=lib.BuoyancyForce(lib.BuoyancyTracer(),
                                   gravity_unit_vector=tuple(-g for g in
                                                             zhat)),
        coriolis=lib.ConstantCartesianCoriolis(f=1e-4, rotation_axis=zhat),
        closure=lib.ScalarDiffusivity(nu=1e-4, kappa=1e-4),
        advection=lib.UpwindBiased(5), tracers=("b",),
        boundary_conditions={
            "u": lib.FieldBoundaryConditions(bottom=lib.FluxBoundaryCondition(
                drag_u, field_dependencies=("u", "v"))),
            "v": lib.FieldBoundaryConditions(bottom=lib.FluxBoundaryCondition(
                drag_v, field_dependencies=("u", "v"))),
            "b": lib.FieldBoundaryConditions(
                bottom=lib.GradientBoundaryCondition(-N2 * zhat[2]))},
        background_fields={
            "b": lib.BackgroundField(
                lambda x, y, z, t, p: p["N2"] * (x * p["z1"] + z * p["z3"]),
                parameters={"N2": N2, "z1": zhat[0], "z3": zhat[2]}),
            "v": lib.BackgroundField(V_inf)})
    rng = np.random.default_rng(7)

    def noise(x, y, z):
        return 1e-3 * rng.standard_normal(np.broadcast_shapes(
            np.shape(x), np.shape(y), np.shape(z))) * np.exp(
                -(10 * z) ** 2 / Lz ** 2)

    min_dz = float(np.diff(z_faces).min())
    dt = 0.5 * min(min_dz / V_inf, min_dz ** 2 / 1e-4)
    return spec, kw, dict(u=noise, w=noise), dt


def weno5(side):
    return (ja.WENO(5, smoothness_dtype=jnp.float64) if side == "jax"
            else ot.WENO(5, smoothness_dtype=F64))


EXAMPLES = {f.__name__: f for f in (
    two_dimensional_turbulence, internal_wave, kelvin_helmholtz_instability,
    convecting_plankton, one_dimensional_diffusion,
    tilted_bottom_boundary_layer)}


class _JaxLib:
    """The JAX package's names the example configurations use."""
    Centered, UpwindBiased = ja.Centered, ja.UpwindBiased
    FPlane = jcor.FPlane
    ConstantCartesianCoriolis = jcor.ConstantCartesianCoriolis
    BuoyancyTracer, BuoyancyForce = jb.BuoyancyTracer, jb.BuoyancyForce
    ScalarDiffusivity = jc.ScalarDiffusivity
    FieldBoundaryConditions = jo.FieldBoundaryConditions
    FluxBoundaryCondition = jo.FluxBoundaryCondition
    GradientBoundaryCondition = jo.GradientBoundaryCondition
    BackgroundField = jo.BackgroundField


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_against_jax(name):
    """The example's grid, physics and initial state (its seeded noise
    drawn once, on the JAX side), carried into the port; 3 steps of the
    example's Δt."""
    spec, jkw, values, dt = EXAMPLES[name](_JaxLib, "jax")
    _, tkw, _, _ = EXAMPLES[name](ot, "torch")
    jm, tm = model_pair(jkw, tkw, spec, lambda m: m.set(**values), dt)
    check_models(jm, tm, dt)


# -- what stays refused -----------------------------------------------------------

@pytest.mark.parametrize("topo", [(P, P, P), (B, P, B), (P, P, F)],
                         ids=["ppp", "bpb", "ppf"])
def test_sharded_off_periodic_periodic_bounded_raises(topo):
    """Under a mesh the model and the sharded tendency (#7) take periodic x
    and y with a periodic, bounded or flat z, on resident blocks (one step
    runs; ``tests/test_torch_parallel.py`` holds them against JAX); on a
    bounded x the model takes the plain flux divergences on every shard
    (one step runs; ``tests/test_torch_sharded_hydrostatic.py`` holds a
    bounded y against JAX) and the whole-mesh #7 still raises, as JAX's
    takes periodic x and y alone."""
    grid = ot.RectilinearGrid(dtype=F64, device="cpu",
                              **grid_kw(topo, (8, 8, 8)))
    arch = ot.Distributed(ot.Partition(2, 2), devices=["cpu"] * 4)
    if topo[0] == B:
        m = NonhydrostaticModel(grid, advection=ot.WENO(5), architecture=arch)
        assert m._sharded_advection is None
        m.set(u=lambda x, y, z: 0.1 * np.sin(2 * np.pi * y))
        m.time_step(1e-3)
        assert np.isfinite(m.field("u").interior.numpy()).all()
        with pytest.raises(NotImplementedError, match="its eligible"):
            fa.build_sharded_fused_advection(grid, ot.WENO(5), arch.mesh)
        return
    m = NonhydrostaticModel(grid, advection=ot.WENO(5), architecture=arch)
    assert m._sharded_advection is not None
    assert fa.z_mode(m._shards[0].grid) == fa.z_mode(grid)
    m.set(u=lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    m.time_step(1e-3)
    assert np.isfinite(m.field("u").interior.numpy()).all()
    fa.build_sharded_fused_advection(grid, ot.WENO(5), arch.mesh)


def test_periodic_z_user_condition_raises():
    """Conditions other than periodic on a periodic z: regularizing refuses
    them (ValueError, as JAX does), and the fill wraps any that reach it,
    as JAX's fill does (tests/test_torch_long_tail.py holds that fill
    against JAX's)."""
    from oceananigans_tpu_torch.boundary_conditions import (
        BoundaryCondition, FieldBoundaryConditions)
    from oceananigans_tpu_torch.boundary_conditions import \
        boundary_condition as bcm
    grid = ot.RectilinearGrid(dtype=F64, device="cpu",
                              **grid_kw((P, P, P), (8, 8, 8)))
    with pytest.raises(ValueError):
        NonhydrostaticModel(grid, tracers=("c",), boundary_conditions={
            "c": ot.FieldBoundaryConditions(top=ot.FluxBoundaryCondition(
                1.0))})
    bcs = t_reg(None, grid, CCC)
    bad = FieldBoundaryConditions(**{
        side: (BoundaryCondition(bcm.VALUE, 1.0) if side == "top"
               else bcs.side(side))
        for side in ("west", "east", "south", "north", "bottom", "top")})
    a = torch.as_tensor(np.random.default_rng(9).standard_normal(
        grid.padded_shape))
    b = a.clone()
    fill_all_halo_regions([a], grid, [(CCC, bad)])
    fill_all_halo_regions([b], grid, [(CCC, bcs)])
    assert torch.equal(a, b)
