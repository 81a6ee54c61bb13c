"""The port's NonhydrostaticModel with its physics against the JAX model's,
on the CPU in float64.

Each case builds the JAX model (its XLA tendency path: ``fused_advection=
False``) and the port's from one configuration at (8, 8, 8), sets it on the
JAX side from ``np.random.default_rng``, loads that state into the port
(``state_from_jax``), and takes 3 steps on both sides (RK3 for the LES
row's two closures, quasi-AB2 for the rest, so that the JAX model compiles
one tendency evaluation a step): every field, the closure's state fields
and the pressure agree to 1e-10 relative to the field's largest value.
The cases: the 128³ LES row's configuration (WENO(5), BuoyancyTracer,
``SmagorinskyLilly()``; and ``AnisotropicMinimumDissipation(Cb=...)`` with
conditions on νₑ and κₑ), Lilly's coefficient, the dynamic coefficient
with directional and Lagrangian averaging, a vertically implicit
ScalarDiffusivity with Value conditions, a closure tuple, SeawaterBuoyancy
with TEOS-10, a tilted gravity (BuoyancyForce), a non-traditional
β-plane, forcing (continuous with a field dependency, relaxation with a
mask and a target, discrete, advective, several on one field), Stokes
drift, background fields and quasi-AB2. The port takes the z-compact
layout where it has no closure, forcing or z condition (the JAX model
takes it only at Nz % 128 == 0); the two layouts agree to roundoff.

Then the Stokes drifts' tendencies against JAX on random fields, and a
float32 LES step whose every tendency and diffusivity stays float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jot
import oceananigans_tpu.background_fields as jbg
import oceananigans_tpu.buoyancy as jb
import oceananigans_tpu.closures as jc
import oceananigans_tpu.coriolis as jcor
import oceananigans_tpu.forcings as jf
import oceananigans_tpu.stokes_drift as jsd
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFBC, ValueBoundaryCondition as JValue)
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.models import NonhydrostaticModel as JModel
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.background_fields as tbg
import oceananigans_tpu_torch.buoyancy as tb
import oceananigans_tpu_torch.closures as tc
import oceananigans_tpu_torch.coriolis as tcor
import oceananigans_tpu_torch.forcings as tf
import oceananigans_tpu_torch.stokes_drift as tsd
from oceananigans_tpu_torch.models import NonhydrostaticModel, state_from_jax

torch.set_num_threads(1)

N = (8, 8, 8)
DT = 2e-3
TOL = 1e-10


def _lib(side):
    """The modules of one side: (closures, buoyancy, coriolis, forcings,
    stokes drift, background fields, package)."""
    if side == "jax":
        return jc, jb, jcor, jf, jsd, jbg, jot
    return tc, tb, tcor, tf, tsd, tbg, ot


def _value_bcs(side, top, bottom):
    if side == "jax":
        return JFBC(top=JValue(top), bottom=JValue(bottom))
    return ot.FieldBoundaryConditions(top=ot.ValueBoundaryCondition(top),
                                      bottom=ot.ValueBoundaryCondition(bottom))


def _advection(side, weno):
    if side == "jax":
        return (jot.WENO(5, smoothness_dtype=jnp.float64) if weno
                else jot.Centered(2))
    return ot.WENO(5, smoothness_dtype=torch.float64) if weno \
        else ot.Centered(2)


def les_smagorinsky_lilly(side):
    c, b, *_ = _lib(side)
    return dict(advection=_advection(side, True), tracers=("b",),
                buoyancy=b.BuoyancyTracer(), closure=c.SmagorinskyLilly())


def amd_cb(side):
    c, b, *_ = _lib(side)
    return dict(tracers=("b",), buoyancy=b.BuoyancyTracer(),
                closure=c.AnisotropicMinimumDissipation(Cb=1.0),
                boundary_conditions={"nu_e": _value_bcs(side, 0.0, 1e-3),
                                     "kappa_e": {"b": _value_bcs(side, 2e-4,
                                                                 0.0)}})


def lilly_coefficient(side):
    c, b, *_ = _lib(side)
    return dict(tracers=("b",), buoyancy=b.BuoyancyTracer(),
                closure=c.Smagorinsky(coefficient=c.LillyCoefficient(Pr=0.8)))


def dynamic_directional(side):
    c, *_ = _lib(side)
    return dict(tracers=("c",), closure=c.DynamicSmagorinsky(averaging=(0, 1)))


def dynamic_lagrangian(side):
    c, *_ = _lib(side)
    return dict(tracers=("c",), closure=c.DynamicSmagorinsky(
        averaging=c.LagrangianAveraging()))


def vitd(side):
    c, b, *_ = _lib(side)
    return dict(tracers=("b",), buoyancy=b.BuoyancyTracer(),
                closure=c.ScalarDiffusivity(
                    c.VerticallyImplicitTimeDiscretization(),
                    nu=lambda x, y, z, t: 2e-2 * (1.5 + z) + t,
                    kappa={"b": 3e-2}),
                boundary_conditions={"b": _value_bcs(side, -0.05, 0.05)})


def closure_tuple(side):
    c, *_ = _lib(side)
    return dict(tracers=("c",), closure=(
        c.Smagorinsky(), c.HorizontalScalarDiffusivity(nu=1e-3, kappa=2e-3)))


def seawater_teos10(side):
    c, b, *_ = _lib(side)
    return dict(buoyancy=b.SeawaterBuoyancy(b.TEOS10EquationOfState()),
                closure=c.ScalarDiffusivity(nu=1e-4, kappa=1e-4))


def tilted_gravity(side):
    _, b, *_ = _lib(side)
    return dict(buoyancy=b.BuoyancyForce(b.BuoyancyTracer(),
                                         gravity_unit_vector=(0.2, -0.1, -1)))


def coriolis(side):
    _, b, cor, *_ = _lib(side)
    return dict(tracers=("b",), buoyancy=b.BuoyancyTracer(),
                coriolis=cor.NonTraditionalBetaPlane(
                    fz0=0.5, beta=0.2, fy0=0.3, gamma=-0.1, radius=5.0))


def forcing(side):
    _, _, _, f, *_ = _lib(side)
    return dict(tracers=("b", "c"), forcing={
        "u": f.ContinuousForcing(lambda x, y, z, t, b: 0.1 * b * (1 + x) + t,
                                 field_dependencies="b"),
        "b": f.Relaxation(0.5, mask=f.GaussianMask(-0.5, 0.2),
                          target=f.LinearTarget(gradient=0.1)),
        "c": (f.AdvectiveForcing(w=-0.01),
              f.DiscreteForcing(lambda grid, fields, t, p: -p * fields["c"],
                                parameters=0.2)),
    })


def stokes(side):
    *_, sd, _, _ = _lib(side)
    return dict(tracers=("b",), stokes_drift=sd.StokesDrift(
        dz_us=lambda x, y, z, t: 0.2 * (1 + z) + t,
        dy_us=lambda x, y, z, t: 0.05 * x,
        dx_vs=lambda x, y, z, t: 0.03 * y * z,
        dt_ws=lambda x, y, z, t: 0.01 + 0 * z))


def background(side):
    _, b, *_, bg, _ = _lib(side)
    return dict(tracers=("b",), buoyancy=b.BuoyancyTracer(),
                background_fields={
                    "u": bg.BackgroundField(lambda x, y, z, t, p: p * z + t,
                                            parameters=0.1),
                    "v": 0.05,
                    "b": lambda x, y, z, t: 0.01 * z})


def quasi_ab2(side):
    _, b, cor, *_ = _lib(side)
    return dict(tracers=("b",), buoyancy=b.BuoyancyTracer(),
                coriolis=cor.ConstantCartesianCoriolis(fx=0.1, fy=0.2, fz=0.4))


CASES = {f.__name__: f for f in (
    les_smagorinsky_lilly, amd_cb, lilly_coefficient, dynamic_directional,
    dynamic_lagrangian, vitd, closure_tuple, seawater_teos10, tilted_gravity,
    coriolis,
    forcing, stokes, background, quasi_ab2)}
# the LES row's closures step with RK3, the others with quasi-AB2 (Euler,
# then χ = 0.1): one tendency evaluation a step keeps the JAX model's
# compilation, most of each case's time, a third as long
RK3_CASES = ("les_smagorinsky_lilly", "amd_cb")


def _config(case, side):
    kw = CASES[case](side)
    if case not in RK3_CASES:
        kw["timestepper"] = "QuasiAdamsBashforth2"
    return kw


def _initial(jm):
    rng = np.random.default_rng(0)
    values = dict(u=0.1 * rng.standard_normal(N),
                  v=0.1 * rng.standard_normal(N))
    z = np.linspace(-1.0, 0.0, N[2]).reshape(1, 1, -1)
    for name in jm.tracer_names:
        base = {"T": 10.0 + 2.0 * z, "S": 35.0 - 0.5 * z}.get(name, 0.1 * z)
        values[name] = base + 1e-2 * rng.standard_normal(N)
    jm.set(**values)


def _numpy_state(state):
    out = {k: {n: np.asarray(a) for n, a in v.items()} if isinstance(v, dict)
           else np.asarray(v) for k, v in state.items()}
    return out


def _interior(a, n=N):
    h = [(a.shape[ax] - n[ax]) // 2 for ax in range(3)]
    return a[h[0]:h[0] + n[0], h[1]:h[1] + n[1], h[2]:h[2] + n[2]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_against_jax(case):
    grid_kw = dict(size=N, extent=(1.0, 1.0, 1.0))
    jm = JModel(grid=JGrid(dtype=np.float64, **grid_kw),
                fused_advection=False, **_config(case, "jax"))
    assert not jm._z_compact
    _initial(jm)
    start = _numpy_state(jm.state)
    for _ in range(3):
        jm.time_step(DT)
    end = _numpy_state(jm.state)

    tm = NonhydrostaticModel(ot.RectilinearGrid(dtype=torch.float64,
                                                device="cpu", **grid_kw),
                             **_config(case, "torch"))
    assert set(tm.state["fields"]) == set(end["fields"])
    state_from_jax(start, tm)
    for _ in range(3):
        tm.time_step(DT)
    assert tm.iteration == 3
    assert abs(tm.time - float(end["clock"]["time"])) < 1e-15
    names = list(end["fields"]) + ["p"]
    for name in names:
        a = end["pressure"] if name == "p" else end["fields"][name]
        want = _interior(a)
        got = tm.field(name).data[tm.grid.interior_slices].numpy()
        err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
        assert err <= TOL, (case, name, err)


@pytest.mark.parametrize("kind", ["uniform", "general"])
def test_stokes_drift_against_jax(kind):
    H = (3, 3, 3)
    jg = JGrid(size=(6, 5, 7), extent=(1.0, 2.0, 0.5), halo=H,
               dtype=np.float64)
    tg = ot.RectilinearGrid(size=(6, 5, 7), extent=(1.0, 2.0, 0.5), halo=H,
                            dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal(jg.padded_shape) for _ in range(3)]

    def make(sd):
        if kind == "uniform":
            return sd.UniformStokesDrift(
                grad_z_us=lambda z, t: 0.3 * z + t,
                grad_z_vs=lambda z, t: 0.1 + 0.2 * z * z,
                grad_t_us=lambda z, t: 0.05 * z)
        return sd.StokesDrift(
            dx_vs=lambda x, y, z, t: 0.1 * x, dx_ws=lambda x, y, z, t: y * z,
            dy_us=lambda x, y, z, t: 0.2 + 0 * y,
            dy_ws=lambda x, y, z, t: x * y, dz_us=lambda x, y, z, t: z + t,
            dz_vs=lambda x, y, z, t: 0.3 * x * z,
            dt_vs=lambda x, y, z, t: 0.01 * y)

    js, ts = make(jsd), make(tsd)
    ints = jg.interior_slices
    for fn in ("x_tendency", "y_tendency", "z_tendency"):
        want = np.broadcast_to(np.asarray(getattr(js, fn)(
            jg, *(jnp.asarray(a) for a in arrays), 0.4)), jg.padded_shape)
        got = torch.as_tensor(getattr(ts, fn)(
            tg, *(torch.as_tensor(a) for a in arrays), 0.4)).broadcast_to(
                tg.padded_shape)
        scale = max(np.max(np.abs(want[ints])), 1e-300)
        assert np.max(np.abs(got[ints].numpy() - want[ints])) / scale \
            <= 1e-12, fn


@pytest.mark.parametrize("case", ["les_smagorinsky_lilly", "amd_cb",
                                  "seawater_teos10", "forcing", "background",
                                  "vitd"])
def test_float32_step_stays_float32(case):
    """Every tendency, diffusivity and updated field of a float32 step is
    float32: the closures' constants stay Python floats or tensors of the
    grid's dtype."""
    model = NonhydrostaticModel(
        ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                           dtype=torch.float32, device="cpu"),
        **CASES[case]("torch"))
    rng = np.random.default_rng(1)
    values = {n: (10.0 if n == "T" else 35.0 if n == "S" else 0.0)
              + 0.1 * rng.standard_normal(N).astype(np.float32)
              for n in ("u", "v") + model.tracer_names}
    model.set(**values)
    seen = []
    inner = model._tendencies

    def tendencies(fields, time):
        G, aux = inner(fields, time)
        seen.extend(G.values())
        for a in (aux if isinstance(aux, list) else [aux]):
            seen.extend(v for k, v in a.items()
                        if isinstance(v, torch.Tensor))
        return G, aux

    model._tendencies = tendencies
    model.time_step(1e-3)
    assert seen
    for t in seen + list(model.state["fields"].values()):
        assert t.dtype == torch.float32, (case, t.dtype)
        assert torch.isfinite(t).all(), case
