"""The port's run loop and what it drives, against the JAX package's, on the
CPU in float64.

Both packages' models start from the same numpy-seeded state (the JAX
model's, loaded into the port's with ``state_from_jax``):

- the loop: each schedule class, the stop criteria, the aligned Δt and the
  calendar clock give the same sequence of (iteration, time, Δt) and the
  same actuations (iterations equal; times and Δt within 1e-14 relative);
- ``TimeStepWizard``, ``AdvectiveCFL`` and ``DiffusiveCFL`` (a constant,
  a function and a diagnosed diffusivity): 1e-12 relative;
- the NaN check: the port tests every interior point, the JAX one about
  4,096 of them, so only the port aborts on a NaN between its samples;
  both abort on a sampled one (ROADMAP.md queue 3);
- tendency and state hooks over 3 steps (the NonhydrostaticModel, which a
  tendency hook takes off its fused route in both packages, and the
  HydrostaticFreeSurfaceModel): 1e-10 relative to max|JAX|;
- the Field reductions on an immersed lat-lon grid, with and without a
  condition (1e-12), and the tracer-variance budget (1e-12);
- the grid specs of a RectilinearGrid and a LatitudeLongitudeGrid, key for
  key (exact), and the grids they rebuild;
- ``FieldTimeSeries`` interpolation (exact: the same float64 arithmetic)
  and models driven by ``FieldTimeSeriesForcing`` and by
  ``FieldTimeSeriesBoundaryCondition`` over 3 steps (1e-10 relative);
- the port alone: a float32 clock ends at a stop time it cannot represent
  and lands on a TimeInterval without a vanishing Δt, and CATKE takes its
  surface TKE flux from a FieldTimeSeries wind stress (which the JAX model
  cannot) exactly as from the same stress given as a function.
"""

import datetime

import jax
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
import oceananigans_tpu.forcings as jf_mod
from oceananigans_tpu.fields.field import Field as JField
from oceananigans_tpu.grids.reconstruction import \
    constructor_arguments as j_constructor_arguments
from oceananigans_tpu.immersed import (GridFittedBottom as JGFB,
                                       ImmersedBoundaryGrid as JIBG)
from oceananigans_tpu.simulation import Simulation as JSimulation
from oceananigans_tpu.simulation import simulation as jsim
from oceananigans_tpu.simulation.diagnostics import (
    AdvectiveCFL as JAdvCFL, DiffusiveCFL as JDiffCFL,
    TimeStepWizard as JWizard)
from oceananigans_tpu.simulation.output_readers import \
    FieldTimeSeries as JFTS
from oceananigans_tpu.simulation.variance_dissipation import \
    VarianceDissipation as JVD
from oceananigans_tpu.utils import schedules as js
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.grids.reconstruction import (
    constructor_arguments, reconstruct_grid)
from oceananigans_tpu_torch.immersed import (GridFittedBottom,
                                             ImmersedBoundaryGrid)
from oceananigans_tpu_torch.models import state_from_jax
from oceananigans_tpu_torch.models.hydrostatic import \
    state_from_jax as hydro_state_from_jax
from oceananigans_tpu_torch.simulation.diagnostics import (
    AdvectiveCFL, DiffusiveCFL, TimeStepWizard)
from oceananigans_tpu_torch.simulation.variance_dissipation import \
    VarianceDissipation
from oceananigans_tpu_torch.utils import schedules as ts

torch.set_num_threads(1)

F64 = torch.float64
N = (8, 8, 8)
MODEL_TOL = 1e-10


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _initial(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(shape), 0.1 * rng.standard_normal(shape),
            rng.standard_normal(shape))


def _nh_pair(jkw=None, tkw=None, seed=0, **kw):
    """A JAX NonhydrostaticModel with tracer c set from a seeded state, and
    the port's with the same state."""
    u, v, c = _initial(N, seed)
    jm = jo.NonhydrostaticModel(
        grid=jo.RectilinearGrid(size=N, extent=(1, 1, 1), dtype=np.float64),
        tracers=("c",), **kw, **(jkw or {}))
    jm.set(u=u, v=v, c=c)
    tm = ot.NonhydrostaticModel(
        ot.RectilinearGrid(size=N, extent=(1, 1, 1), dtype=F64,
                           device="cpu"), tracers=("c",), **kw, **(tkw or {}))
    state_from_jax(_numpy(jm.state), tm)
    return jm, tm


def _compare_fields(jm, tm, names, tol=MODEL_TOL):
    """Interiors within ``tol`` relative to max|JAX|. The port's z-compact
    layout holds w without its top boundary face, which is 0."""
    for name in names:
        want = np.asarray(jm.field(name).interior)
        got = tm.field(name).interior
        if name == "w" and got.shape[2] == want.shape[2] - 1:
            assert not want[..., -1].any()
            want = want[..., :-1]
        assert tuple(got.shape) == want.shape, name
        assert _rel(got, want) <= tol, (name, _rel(got, want))


# -- the loop ----------------------------------------------------------------------

REF = datetime.datetime(2020, 1, 1)


def _loop_case(S, case):
    """(Simulation kwargs, {label: schedule}) of one loop case in the
    package whose schedules module is ``S``."""
    if case == "iteration":
        return dict(dt=1e-3, stop_iteration=10), {"a": S.IterationInterval(3)}
    if case == "time_interval":
        return dict(dt=1e-3, stop_iteration=12), {"a": S.TimeInterval(2.5e-3)}
    if case == "specified_times":
        return (dict(dt=1e-3, stop_time=9e-3),
                {"a": S.SpecifiedTimes(7e-3, 1.5e-3, 4.2e-3)})
    if case == "and_or":
        return dict(dt=1e-3, stop_iteration=12), {
            "or": S.OrSchedule(S.TimeInterval(3.3e-3), S.SpecifiedTimes(5e-3)),
            "and": S.AndSchedule(S.IterationInterval(2),
                                 S.TimeInterval(2e-3))}
    if case == "wall_time":
        return dict(dt=1e-3, stop_iteration=6), {
            "a": S.WallTimeInterval(3600.0)}
    if case == "stop_time":
        return dict(dt=1e-3, stop_time=7.77e-3), {"a": S.IterationInterval(2)}
    if case == "datetime":
        return (dict(dt=datetime.timedelta(milliseconds=1),
                     stop_time=REF + datetime.timedelta(microseconds=8500)),
                {"a": S.TimeInterval(datetime.timedelta(milliseconds=2)),
                 "b": S.SpecifiedTimes(REF + datetime.timedelta(
                     microseconds=3300))})
    if case == "wizard":
        return dict(dt=1e-3, stop_iteration=9), {"a": S.IterationInterval(3)}
    raise ValueError(case)


LOOP_CASES = ("iteration", "time_interval", "specified_times", "and_or",
              "wall_time", "stop_time", "datetime", "wizard")


def _clone(state):
    return {k: (_clone(v) if isinstance(v, dict) else
                v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


@pytest.fixture(scope="module")
def loop_pair():
    jm, tm = _nh_pair()
    return jm, tm, jm.state, _clone(tm.state)


def _run_loop(sim_cls, S, wizard, model, case):
    kw, schedules = _loop_case(S, case)
    sim = sim_cls(model, **kw)
    record, fired = [], {k: [] for k in schedules}
    for label, sched in schedules.items():
        sim.add_callback((lambda s, label=label: fired[label].append(
            s.model.iteration)), sched, name=f"probe_{label}")
    if case == "wizard":
        wizard(sim, schedules["a"], cfl=0.3)
    sim.add_callback(lambda s: record.append(
        (s.model.iteration, s.model.time,
         float(s.model.state["clock"]["last_dt"]))), name="record")
    sim.run()
    return record, fired, sim


@pytest.mark.parametrize("case", LOOP_CASES)
def test_loop_sequence(loop_pair, case):
    """One Simulation per package with the case's schedules on probe
    callbacks: the same (iteration, time, Δt) after every step and the
    same actuations; times and Δt within 1e-14 relative."""
    jm, tm, j0, t0 = loop_pair
    jm.state = j0
    tm.state = _clone(t0)
    ref = REF if case == "datetime" else None
    jm.reference_datetime = tm.reference_datetime = ref
    jrec, jfired, _ = _run_loop(JSimulation, js, jo.conjure_time_step_wizard,
                                jm, case)
    trec, tfired, _ = _run_loop(ot.Simulation, ts,
                                ot.conjure_time_step_wizard, tm, case)
    assert tfired == jfired
    assert [r[0] for r in trec] == [r[0] for r in jrec]
    for (_, tt, tdt), (_, jt, jdt) in zip(trec, jrec):
        assert abs(tt - jt) <= 1e-14 * abs(jt)
        assert abs(tdt - jdt) <= 1e-14 * abs(jdt)
    if case == "datetime":
        assert tm.datetime == jm.datetime
        assert tm.datetime > np.datetime64(REF, "ns")
    if case in ("time_interval", "specified_times", "datetime"):
        # the schedules shrank Δt at least once
        assert min(r[2] for r in trec) < 1e-3 * (1 - 1e-9)


def test_calendar_time_needs_a_reference():
    _, tm = _nh_pair()
    with pytest.raises(ValueError, match="reference_datetime"):
        ot.Simulation(tm, dt=1e-3, stop_time=REF)


def test_float32_clock_stops_and_lands():
    """A float32 clock: a stop time it cannot represent still ends the run
    (the JAX test of the same name), and a TimeInterval is met without a
    vanishing Δt, where a 1e-12 s tolerance (the JAX schedules') would
    leave a remainder of tens of picoseconds to step."""
    grid = ot.RectilinearGrid(size=(8, 8, 4), extent=(1, 1, 1),
                              dtype=torch.float32, device="cpu")
    m = ot.NonhydrostaticModel(grid)
    m.set(u=lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    stop = 0.3 * 2 * np.pi / 1.4e-3 * 1e-3
    sim = ot.Simulation(m, dt=0.05, stop_time=stop)
    sim.run()
    assert m.iteration < 1000
    assert torch.isfinite(m.field("u").interior).all()

    m = ot.NonhydrostaticModel(grid)
    sim = ot.Simulation(m, dt=1e-4, stop_iteration=40)
    fired, dts = [], []
    sim.add_callback(lambda s: fired.append(s.model.iteration),
                     ts.TimeInterval(5.5e-4))
    sim.add_callback(lambda s: dts.append(
        float(s.model.state["clock"]["last_dt"])))
    sim.run()
    assert min(dts) > 1e-6
    assert fired == [6, 12, 18, 24, 30, 36]


# -- the wizard and the CFL numbers -------------------------------------------------------

def _closure(package, kind):
    if kind == "constant":
        return package.ScalarDiffusivity(nu=2e-3, kappa=3e-3)
    if kind == "function":
        return package.ScalarDiffusivity(
            nu=lambda x, y, z, t: 1e-3 * (2 + z), kappa=1e-3)
    return package.SmagorinskyLilly()


@pytest.mark.parametrize("kind", ["constant", "function", "smagorinsky"])
def test_wizard_and_cfl(kind):
    """new_dt, AdvectiveCFL and DiffusiveCFL on the same state: 1e-12."""
    jm, tm = _nh_pair(jkw=dict(closure=_closure(jo, kind)),
                      tkw=dict(closure=_closure(ot, kind)))
    a, b = AdvectiveCFL(1e-3)(tm), JAdvCFL(1e-3)(jm)
    assert abs(a - b) <= 1e-12 * b
    a, b = DiffusiveCFL(1e-3)(tm), JDiffCFL(1e-3)(jm)
    assert b > 0 and abs(a - b) <= 1e-12 * b
    for dt in (1e-3, 2.0):
        got = TimeStepWizard(cfl=0.4, diffusive_cfl=0.2).new_dt(tm, dt)
        if kind != "function":
            want = JWizard(cfl=0.4, diffusive_cfl=0.2).new_dt(jm, dt)
        else:
            # the JAX wizard cannot read a function ν; the port's takes
            # its interior maximum, which DiffusiveCFL(1)·Δ² gives
            dmin = 1.0 / N[0]
            numax = JDiffCFL(1.0)(jm) * dmin ** 2
            tau = 1e-3 / JAdvCFL(1e-3)(jm)
            want = min(0.4 * tau, 0.2 * dmin ** 2 / numax, 1.1 * dt)
            want = max(want, 0.5 * dt)
        assert abs(got - want) <= 1e-12 * want


def test_hydrostatic_wizard_reads_diagnosed_w(ocean_run):
    """The hydrostatic model keeps w in state["w"]: the port's wizard reads
    it there. On the JAX ocean row's state after 3 steps, loaded into the
    port, it agrees with the JAX advective time scale of u, v and that w:
    1e-12."""
    import chip_smoke
    from oceananigans_tpu.advection.fluxes import \
        cell_advection_timescale as j_timescale
    jm, _ = ocean_run
    tm = chip_smoke.ocean_model(OCEAN_N, F64, "cpu", smoothness=F64,
                                momentum_advection=ot.VectorInvariant())
    hydro_state_from_jax(_numpy(jm.state), tm)
    f = jm.state["fields"]
    tau = float(j_timescale(jm.grid, f["u"], f["v"], jm.state["w"]))
    got = TimeStepWizard(cfl=0.5, max_change=np.inf,
                         min_change=0.0).new_dt(tm, 1.0)
    assert abs(got - 0.5 * tau) <= 1e-12 * 0.5 * tau


# -- the NaN check -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nan_pair():
    shape = (16, 16, 32)        # 8,192 points: JAX samples every other one
    jm = jo.NonhydrostaticModel(grid=jo.RectilinearGrid(
        size=shape, extent=(1, 1, 1), dtype=np.float64))
    tm = ot.NonhydrostaticModel(ot.RectilinearGrid(
        size=shape, extent=(1, 1, 1), dtype=F64, device="cpu"))
    return jm, tm


def _with_nan(model, flat_index, as_jax):
    a = np.array(model.state["fields"]["u"]) if as_jax else \
        model.state["fields"]["u"].clone()
    interior = model.field("u").interior_slices
    view = a[interior]
    idx = np.unravel_index(flat_index, view.shape)
    full = tuple(s.start + i for s, i in zip(interior, idx))
    a[full] = np.nan
    if as_jax:
        import jax.numpy as jnp
        a = jnp.asarray(a)
    model.state = {**model.state,
                   "fields": {**model.state["fields"], "u": a}}


@pytest.mark.parametrize("where", ["sampled", "unsampled"])
def test_nan_checker(nan_pair, where):
    """A NaN at interior point 0 (sampled by JAX) or 1 (not sampled): the
    port aborts on both, JAX on the sampled one only."""
    jm, tm = nan_pair
    flat = 0 if where == "sampled" else 1
    for model, as_jax in ((jm, True), (tm, False)):
        model.state = {**model.state, "fields": {
            **model.state["fields"],
            "u": (jax.numpy.zeros_like(model.state["fields"]["u"]) if as_jax
                  else torch.zeros_like(model.state["fields"]["u"]))}}
        _with_nan(model, flat, as_jax)
    with pytest.raises(RuntimeError, match="NaN found in field 'u'"):
        ot.NaNChecker()(ot.Simulation(tm, dt=1.0))
    jcheck = jsim.NaNChecker()
    if where == "sampled":
        with pytest.raises(RuntimeError, match="NaN found"):
            jcheck(JSimulation(jm, dt=1.0))
    else:
        jcheck(JSimulation(jm, dt=1.0))


# -- hooks ---------------------------------------------------------------------------------

def _c_tendency_hook(shift):
    def hook(grid, fields, G, time):
        G = dict(G)
        G["c"] = G["c"] + shift * (1.0 + time)
        return G
    return hook


def _clip_hook(name, lo):
    def hook(grid, fields, time):
        a = fields[name]
        return {name: a * (a > lo)}
    return hook


def test_nonhydrostatic_hooks():
    """A tendency hook on c and a state hook clipping c below 0.5, over 3
    RK3 steps: 1e-10. Adding the tendency hook takes both models off their
    fused update route."""
    jm, tm = _nh_pair(advection=None)
    assert tm._fused_update
    for m, sim_cls in ((jm, JSimulation), (tm, ot.Simulation)):
        sim = sim_cls(m, dt=1e-3, stop_iteration=3)
        sim.add_callback(_c_tendency_hook(0.25), callsite=(
            jo.TendencyCallsite if m is jm else ot.TendencyCallsite))
        sim.add_callback(_clip_hook("c", 0.5), callsite=(
            jo.UpdateStateCallsite if m is jm else ot.UpdateStateCallsite))
        sim.run()
    assert not tm._fused_update and jm._fused_update is None
    _compare_fields(jm, tm, ("u", "v", "w", "c"))
    assert float(tm.field("c").interior.abs().min()) == 0.0


# -- the ocean row: hooks and the FieldTimeSeries wind stress -------------------------------

OCEAN_N = (12, 10, 8)


def _ocean_pair():
    """chip_smoke.ocean_model's flat-bottom configuration (the golden's
    VectorInvariant(), which JAX compiles faster) in both packages."""
    import jax.numpy as jnp
    import chip_smoke
    from oceananigans_tpu.advection.vector_invariant import \
        VectorInvariant as JVI
    from oceananigans_tpu.closures.catke import CATKEVerticalDiffusivity
    from oceananigans_tpu.models.free_surfaces import \
        SplitExplicitFreeSurface as JSplit
    g = jo.LatitudeLongitudeGrid(size=OCEAN_N, longitude=(0, 60),
                                 latitude=(15, 75), z=(-1800.0, 0.0),
                                 dtype=np.float64)
    buoy = jo.SeawaterBuoyancy(equation_of_state=jo.LinearEquationOfState())
    jm = jo.HydrostaticFreeSurfaceModel(
        g, momentum_advection=JVI(),
        tracer_advection=jo.WENO(5, smoothness_dtype=jnp.float64),
        coriolis=jo.HydrostaticSphericalCoriolis(),
        free_surface=JSplit(cfl=0.7), buoyancy=buoy,
        closure=CATKEVerticalDiffusivity(), tracers=("T", "S"),
        boundary_conditions={"u": jo.FieldBoundaryConditions(
            top=jo.FluxBoundaryCondition(-1e-4),
            bottom=jo.FluxBoundaryCondition(
                chip_smoke.ocean_drag, field_dependencies=("u", "v")))})
    rng = np.random.default_rng(0)
    jm.set(T=lambda lam, phi, z: 12 + 8e-3 * z + 2 * np.cos(np.radians(phi)),
           S=35.0, u=0.05 * rng.standard_normal(OCEAN_N))
    tm = chip_smoke.ocean_model(OCEAN_N, F64, "cpu", smoothness=F64,
                                momentum_advection=ot.VectorInvariant())
    hydro_state_from_jax(_numpy(jm.state), tm)
    return jm, tm


def _uv_damping_hook(grid, fields, G, time):
    G = dict(G)
    G["v"] = G["v"] - 1e-5 * fields["v"]
    return G


def _relax_hook(name, target, rate):
    def hook(grid, fields, time):
        a = fields[name]
        return {name: target + (1 - rate) * (a - target)}
    return hook


@pytest.fixture(scope="module")
def ocean_run():
    """The ocean row in both packages with a tendency hook damping v and a
    state hook relaxing S toward 35, after 3 steps of 600 s."""
    jm, tm = _ocean_pair()
    for m in (jm, tm):
        m.add_tendency_hook(_uv_damping_hook)
        m.add_state_hook(_relax_hook("S", 35.0, 0.1))
    for dt in (600.0, 600.0, 600.0):
        jm.time_step(dt)
        tm.time_step(dt)
    return jm, tm


def test_hydrostatic_hooks(ocean_run):
    """The hooked ocean row after 3 steps: 1e-10 relative to max|JAX| in
    u, v, T, S, e, η and w; the port's tendency kernel route is unchanged
    by the hook (the plain version on the CPU)."""
    jm, tm = ocean_run
    _compare_fields(jm, tm, ("u", "v", "T", "S", "e", "eta", "w"))


# -- fields, reductions and the variance budget ----------------------------------------------

def test_field_set_view_nodes_and_state_checker(capsys):
    """Field.set from a function (halos filled), view of the surface, nodes,
    fill_halos on a copy, and StateChecker's report: as the JAX package's
    (1e-12; the report's text equal)."""
    jm, tm = _nh_pair()
    fn = lambda x, y, z: np.sin(2 * np.pi * x) * np.cos(np.pi * y) + z
    jf = jo.CenterField(jm.grid).set(fn)
    tf = ot.CenterField(tm.grid).set(fn)
    assert _rel(tf.interior, jf.interior) <= 1e-12
    surface = (slice(None), slice(None), -1)
    assert _rel(tf.view(surface), jf.view(surface)) <= 1e-12
    for a, b in zip(tf.nodes(), jf.nodes()):
        assert np.array_equal(a, np.asarray(b))
    held = tm.state["fields"]["c"]
    before = held.clone()
    f = tm.field("c")
    f.data[f.interior_slices] += 1.0
    f.fill_halos()
    assert f.data is not held and torch.equal(held[tm.grid.interior_slices],
                                              before[tm.grid.interior_slices]
                                              + 1.0)
    from oceananigans_tpu.simulation.diagnostics import StateChecker as JSC
    jm2, tm2 = _nh_pair()
    JSC()(JSimulation(jm2, dt=1.0))
    want = capsys.readouterr().out.splitlines()
    ot.StateChecker()(ot.Simulation(tm2, dt=1.0))
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] and len(got) == len(want) == 5
    for a, b in zip(got[1:], want[1:]):
        # "name: min x max y mean z", each within 1e-12 of max(|min|, |max|)
        assert a.split(":")[0] == b.split(":")[0]
        x, y = (np.array(line.split()[2::2], float) for line in (a, b))
        assert np.all(np.abs(x - y) <= 1e-12 * np.abs(y[:2]).max()), (a, b)


# -- reductions and the variance budget ------------------------------------------------------

def _ridge(lam, phi):
    return -1800.0 + 900.0 * np.exp(-((lam - 30.0) / 10.0) ** 2)


def test_field_reductions_immersed():
    """min, max, mean, sum, prod and norm of a centre, a face and a surface
    field on an immersed lat-lon grid, unconditioned and with a condition:
    1e-12 relative (prod of values near 1)."""
    kw = dict(size=(12, 10, 8), longitude=(0, 60), latitude=(15, 75),
              z=(-1800.0, 0.0))
    jg = JIBG(jo.LatitudeLongitudeGrid(dtype=np.float64, **kw),
              JGFB(_ridge))
    tg = ImmersedBoundaryGrid(ot.LatitudeLongitudeGrid(
        dtype=F64, device="cpu", **kw), GridFittedBottom(_ridge))
    rng = np.random.default_rng(3)
    cond = lambda lam, phi, z: (phi > 40) + 0 * lam * z
    for loc, surface in ((("c", "c", "c"), False), (("f", "c", "c"), False),
                         (("c", "c", "c"), True)):
        shape = jg.padded_shape[:2] + (1,) if surface else jg.padded_shape
        data = 1.0 + 0.01 * rng.standard_normal(shape)
        jf = JField(jg, loc, data=jax.numpy.asarray(data))
        tf = ot.Field(tg, loc, data=torch.as_tensor(data))
        for name in ("min", "max", "mean", "sum", "prod", "norm"):
            for c in (None, cond):
                if surface and c is not None:
                    continue
                want = float(getattr(jf, name)(condition=c))
                got = getattr(tf, name)(condition=c)
                assert isinstance(got, torch.Tensor) and got.ndim == 0
                assert abs(float(got) - want) <= 1e-12 * abs(want), (
                    loc, surface, name, c)


def test_variance_dissipation():
    """χ_adv (WENO(5): a dissipating scheme), χ_diff and the variance of c
    on the same state: 1e-12."""
    import jax.numpy as jnp
    jm, tm = _nh_pair(jkw=dict(advection=jo.WENO(
        5, smoothness_dtype=jnp.float64)), tkw=dict(advection=ot.WENO(
            5, smoothness_dtype=F64)))
    want = JVD(jm, "c", kappa=1e-3)()
    got = VarianceDissipation(tm, "c", kappa=1e-3)()
    for key in ("chi_advection", "chi_diffusion", "variance"):
        assert abs(got[key] - want[key]) <= 1e-12 * max(abs(want[key]),
                                                        1e-300), key


# -- grid specs ----------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rectilinear", "latlon"])
def test_grid_specs(kind):
    """constructor_arguments key for key; the rebuilt grid equals the
    original (on the device asked for)."""
    if kind == "rectilinear":
        kw = dict(size=(8, 6, 4), x=(-1.0, 3.0), y=(0.0, 2.0),
                  z=(-5.0, 0.0), topology=("periodic", "bounded", "bounded"))
        jg = jo.RectilinearGrid(dtype=np.float64, **kw)
        tg = ot.RectilinearGrid(dtype=F64, device="cpu", **kw)
    else:
        kw = dict(size=(12, 10, 8), longitude=(0, 60), latitude=(15, 75),
                  z=(-1800.0, 0.0), halo=(4, 4, 4))
        jg = jo.LatitudeLongitudeGrid(dtype=np.float64, **kw)
        tg = ot.LatitudeLongitudeGrid(dtype=F64, device="cpu", **kw)
    spec = constructor_arguments(tg)
    assert spec == j_constructor_arguments(jg)
    assert reconstruct_grid(spec, device="cpu") == tg
    assert reconstruct_grid(spec, device="cpu", halo=(5, 5, 5)).H == (5, 5, 5)


# -- field time series ---------------------------------------------------------------------

class _Stub:
    """A stand-in model for writing a dataset: a grid, an iteration and a
    time."""

    def __init__(self):
        self.grid = ot.RectilinearGrid(size=N, extent=(1, 1, 1), dtype=F64,
                                       device="cpu")
        self.iteration, self.time = 0, 0.0


def _write_series(path, name, snaps, times):
    """A FieldWriter dataset of output ``name`` holding ``snaps`` at
    ``times``, written by the port."""
    stub = _Stub()
    writer = ot.FieldWriter(stub, {name: lambda m: snaps[m.iteration]}, path)
    for i, t in enumerate(times):
        stub.iteration, stub.time = i, t
        writer.write(type("Sim", (), {"model": stub})())


def _snapshot_dataset(path, shape, times, seed=5):
    """Seeded snapshots of output "q" at ``times`` as a dataset."""
    rng = np.random.default_rng(seed)
    snaps = [rng.standard_normal(shape) for _ in times]
    _write_series(path, "q", snaps, times)
    return snaps


def test_field_time_series_interpolation(tmp_path):
    """at_time between, at and beyond the snapshots, both backends, against
    the JAX reader's host and traced interpolation: exact."""
    times = [0.0, 3.0, 7.5, 9.0]
    path = str(tmp_path / "series")
    _snapshot_dataset(path, (4, 3, 2), times)
    jf = JFTS(path, "q")
    for backend in (ot.InMemory, ot.OnDisk):
        tf = ot.FieldTimeSeries(path, "q", backend=backend, device="cpu")
        assert len(tf) == 4 and list(tf.times) == times
        for t in (-1.0, 0.0, 1.3, 3.0, 5.2, 7.5, 8.9, 9.0, 12.0):
            got = tf.at_time(t).numpy()
            assert np.array_equal(got, np.asarray(jf.traced(t))), t
            assert np.array_equal(got, jf.at_time(t)), t


def _fts_tracer_forcing_pair(tmp_path):
    """Snapshots of a tracer forcing on the interior, 1e-3 s apart."""
    path = str(tmp_path / "forcing")
    _snapshot_dataset(path, N, [0.0, 1e-3, 2e-3, 3e-3], seed=7)
    jf = jf_mod.FieldTimeSeriesForcing(JFTS(path, "q"))
    tf = ot.FieldTimeSeriesForcing(ot.FieldTimeSeries(path, "q",
                                                      device="cpu"))
    return _nh_pair(jkw=dict(forcing={"c": jf}), tkw=dict(forcing={"c": tf}))


def _fts_top_flux_pair(tmp_path):
    """Snapshots of c's top flux over the (Nx, Ny) plane."""
    path = str(tmp_path / "flux")
    _snapshot_dataset(path, N[:2], [0.0, 1.5e-3, 3e-3], seed=9)
    jb = jo.FieldTimeSeriesBoundaryCondition(JFTS(path, "q"))
    tb = ot.FieldTimeSeriesBoundaryCondition(ot.FieldTimeSeries(
        path, "q", device="cpu"))
    return _nh_pair(
        jkw=dict(boundary_conditions={"c": jo.FieldBoundaryConditions(
            top=jb)}),
        tkw=dict(boundary_conditions={"c": ot.FieldBoundaryConditions(
            top=tb)}))


@pytest.mark.parametrize("kind", ["forcing", "top_flux"])
def test_field_time_series_drives_model(tmp_path, kind):
    """FieldTimeSeriesForcing of c and a FieldTimeSeriesBoundaryCondition
    on c's top, over 3 RK3 steps of 1e-3 s: 1e-10."""
    make = _fts_tracer_forcing_pair if kind == "forcing" \
        else _fts_top_flux_pair
    jm, tm = make(tmp_path)
    for _ in range(3):
        jm.time_step(1e-3)
        tm.time_step(1e-3)
    _compare_fields(jm, tm, ("u", "v", "w", "c"))


def test_catke_surface_flux_from_field_time_series(tmp_path):
    """The ocean row with its wind stress from a FieldTimeSeries equals the
    same row with the stress as a function of time that interpolates the
    same snapshots, over 3 steps (CATKE's surface TKE flux reads it too):
    1e-12. The JAX model cannot take the series under CATKE."""
    import chip_smoke
    times = [0.0, 900.0, 1800.0]
    rng = np.random.default_rng(11)
    snaps = [-1e-4 * (1 + 0.2 * rng.standard_normal(OCEAN_N[:2]))
             for _ in times]
    path = str(tmp_path / "tau")
    _write_series(path, "tau", snaps, times)

    def lerp(x, y, t):
        j = int(np.clip(np.searchsorted(times, t), 1, len(times) - 1))
        w = (t - times[j - 1]) / (times[j] - times[j - 1])
        plane = (1 - w) * torch.as_tensor(snaps[j - 1]) \
            + w * torch.as_tensor(snaps[j])
        # bounded x and y: the edge values repeated over the halos
        H = (x.shape[0] - OCEAN_N[0]) // 2
        ix = torch.arange(-H, OCEAN_N[0] + H).clamp(0, OCEAN_N[0] - 1)
        iy = torch.arange(-H, OCEAN_N[1] + H).clamp(0, OCEAN_N[1] - 1)
        return plane[ix][:, iy][..., None]

    series = ot.FieldTimeSeries(path, "tau", device="cpu")
    a = chip_smoke.ocean_model(OCEAN_N, F64, "cpu", smoothness=F64,
                               top_u=ot.FieldTimeSeriesBoundaryCondition(
                                   series))
    b = chip_smoke.ocean_model(OCEAN_N, F64, "cpu", smoothness=F64,
                               top_u=lerp)
    for dt in (600.0, 600.0, 600.0):
        a.time_step(dt)
        b.time_step(dt)
    for name in ("u", "v", "T", "S", "e", "eta"):
        assert _rel(a.field(name).interior, b.field(name).interior) \
            <= 1e-12, name
