"""The port's convection path (padded layout, z halos) against the JAX
package's, on the CPU.

- The tendency kernel's plain version against the JAX tendency megakernel
  ``build_fused_advection`` (Pallas interpret mode) at (16, 16, 16), float64,
  the JAX halo (3, 8, 3) against the port's (3, 3, 3); u, v, w and one tracer
  under WENO(5) with float64 smoothness and under Centered(2). Bound 1e-12
  relative to max|G| (the same stencils in another association order).
- The bounded-z fill's plain version against the JAX Pallas fill
  (``get_pallas_fill`` in interpret mode, lane-aligned layout) and against
  ``fill_halo_axes``: copies exact, Value/Gradient extrapolation within 1e-13
  (the Pallas kernel forms the distances as (Hz - m)·Δz, the XLA fill from
  the coordinates).
- Buoyancy, the closure's operators and the boundary fluxes against JAX:
  1e-12 relative.
- The whole model (Rayleigh–Bénard physics: WENO(5) with float64
  smoothness, BuoyancyTracer, ScalarDiffusivity, Value conditions on b) at
  (8, 8, 16), float64, started from the JAX state: 3 RK3 steps within 5e-10
  absolute on u, v, w, b and p.
- Both nonhydrostatic goldens of tests/test_regression.py, rebuilt in the
  port (``chip_smoke.py`` holds the configurations), at their bound of 1e-9.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import Centered as JCentered
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFBC, FluxBoundaryCondition as JFlux,
    GradientBoundaryCondition as JGradient, ValueBoundaryCondition as JValue,
    apply_flux_bcs as j_apply_flux_bcs,
    regularize_field_boundary_conditions as j_regularize)
from oceananigans_tpu.boundary_conditions.fill_halos import fill_halo_axes
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoyancyTracer
from oceananigans_tpu.closures import ScalarDiffusivity as JScalarDiffusivity
from oceananigans_tpu.defaults import defaults as jdefaults
from oceananigans_tpu.fields import set_on_padded as j_set_on_padded
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.kernels.fused_advection import build_fused_advection
from oceananigans_tpu.kernels.pallas_fill import get_pallas_fill
from oceananigans_tpu.models import NonhydrostaticModel as JModel
import chip_smoke
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.biogeochemistry  # noqa: F401
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.boundary_conditions import (
    apply_flux_bcs, fill_halo_regions, regularize_field_boundary_conditions)
from oceananigans_tpu_torch.fields import set_on_padded
from oceananigans_tpu_torch.models import NonhydrostaticModel, state_from_jax

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
LOCS = {"u": ("f", "c", "c"), "v": ("c", "f", "c"), "w": ("c", "c", "f"),
        "c": ("c", "c", "c")}


def _tgrid(N, H, **kw):
    return ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=H,
                              dtype=torch.float64, device="cpu", **kw)


def _jgrid(N, H):
    return JGrid(size=N, extent=(1.0, 1.0, 1.0), halo=H, dtype=np.float64)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# -- kernel #6: tendency-only advection ---------------------------------------

SCHEMES = {
    "weno5": (lambda: JWENO(5, smoothness_dtype=jnp.float64),
              lambda: ot.WENO(5, smoothness_dtype=torch.float64)),
    "centered2": (lambda: JCentered(2), lambda: ot.Centered(2)),
}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_advection_tendency_against_jax(scheme):
    N, JH, TH = (16, 16, 16), (3, 8, 3), (3, 3, 3)
    jgrid, tgrid = _jgrid(N, JH), _tgrid(N, TH)
    rng = np.random.default_rng(21)
    # interiors with their z halos (shared), wrapped in x and y per layout
    zpadded = [0.1 * rng.standard_normal((N[0], N[1], N[2] + 6))
               for _ in range(4)]

    def wrap(a, H):
        return np.pad(a, ((H[0], H[0]), (H[1], H[1]), (0, 0)), mode="wrap")

    jmake, tmake = SCHEMES[scheme]
    jfn = build_fused_advection(jgrid, jmake(), ("c",))
    ju, jv, jw, jc = (jnp.asarray(wrap(a, JH)) for a in zpadded)
    Gu, Gv, Gw, Gc = jfn(ju, jv, jw, {"c": jc})
    sx, sy = slice(JH[0], JH[0] + N[0]), slice(JH[1], JH[1] + N[1])
    want = [np.asarray(g)[sx, sy, 3:3 + N[2]] for g in (Gu, Gv, Gw, Gc["c"])]
    got = K.fused_advection_tendency(
        tgrid, tmake(), [torch.as_tensor(wrap(a, TH)) for a in zpadded])
    assert got.shape == (4,) + N
    for k, name in enumerate("uvwc"):
        assert _rel(got[k].numpy(), want[k]) <= 1e-12, name


# -- kernel #5: bounded-z fill ------------------------------------------------

FILL_CASES = {
    "center_default": ("c", None),
    "center_value_gradient": ("c", dict(top=("value", 1.5),
                                        bottom=("gradient", -0.25))),
    "center_flux_value": ("c", dict(top=("flux", 0.3),
                                    bottom=("value", 0.5))),
    "x_face_default": ("u", None),
    "z_face_default": ("w", None),
    "z_face_value_gradient": ("w", dict(top=("value", 0.2),
                                        bottom=("gradient", 0.7))),
}
J_BC = {"value": JValue, "gradient": JGradient, "flux": JFlux}
T_BC = {"value": ot.ValueBoundaryCondition,
        "gradient": ot.GradientBoundaryCondition,
        "flux": ot.FluxBoundaryCondition}


def _bcs(spec, make, fbc):
    if spec is None:
        return None
    return fbc(**{side: make[kind](value)
                  for side, (kind, value) in spec.items()})


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_bounded_z_fill_against_jax(case):
    name, spec = FILL_CASES[case]
    loc = LOCS[name]
    N, H = (8, 16, 8), (3, 8, 3)
    tgrid = _tgrid(N, H)
    tbcs = regularize_field_boundary_conditions(
        _bcs(spec, T_BC, ot.FieldBoundaryConditions), tgrid, loc)
    a = np.random.default_rng(3).standard_normal(tgrid.padded_shape)
    got = fill_halo_regions(torch.as_tensor(a.copy()), tgrid, loc,
                            tbcs).numpy()
    extrapolates = spec is not None and any(
        kind in ("value", "gradient") for kind, _ in spec.values())
    tol = 1e-13 if extrapolates else 0.0

    jgrid = _jgrid(N, H)
    jbcs = j_regularize(_bcs(spec, J_BC, JFBC), jgrid, loc)
    want = np.asarray(fill_halo_axes(jnp.asarray(a), jgrid, loc, jbcs, 0.0,
                                     (0, 1, 2)))
    assert np.max(np.abs(got - want)) <= tol, "fill_halo_axes"

    jdefaults.lane_align = True
    try:
        lgrid = _jgrid(N, H)
        fast = get_pallas_fill(lgrid, loc, j_regularize(
            _bcs(spec, J_BC, JFBC), lgrid, loc), interpret=True)
        assert fast is not None
        tail = lgrid.lane_tail
        al = np.zeros(lgrid.padded_shape)
        al[..., :-tail] = a
        pallas = np.asarray(fast(jnp.asarray(al)))[..., :-tail]
    finally:
        jdefaults.lane_align = None
    assert np.max(np.abs(got - pallas)) <= tol, "get_pallas_fill"


def test_periodic_wrap_with_z_halos():
    """The wrap covers every z slot, z halos included."""
    tgrid = _tgrid((6, 5, 7), (3, 2, 3))
    a = torch.as_tensor(np.random.default_rng(4).standard_normal(
        tgrid.padded_shape))
    K.periodic_halo_fill(tgrid, [a])
    a = a.numpy()
    np.testing.assert_array_equal(a[:3], a[6:9])
    np.testing.assert_array_equal(a[:, :2], a[:, 5:7])
    np.testing.assert_array_equal(a[-3:], a[3:6])


# -- buoyancy, closure, boundary fluxes, set ----------------------------------

def _random_fields(shape, seed, names="uvwb"):
    rng = np.random.default_rng(seed)
    arrays = {n: rng.standard_normal(shape) for n in names}
    return ({n: jnp.asarray(a) for n, a in arrays.items()},
            {n: torch.as_tensor(a) for n, a in arrays.items()})


@pytest.mark.parametrize("formulation", ["iso", "horizontal", "vertical"])
def test_closure_and_buoyancy_against_jax(formulation):
    N, H = (6, 5, 8), (3, 3, 3)
    jgrid, tgrid = _jgrid(N, H), _tgrid(N, H)
    jf, tf = _random_fields(jgrid.padded_shape, seed=5)
    jcl = JScalarDiffusivity(nu=1e-2, kappa={"b": 3e-2},
                             formulation=formulation)
    tcl = ot.ScalarDiffusivity(nu=1e-2, kappa={"b": 3e-2},
                               formulation=formulation)
    ints = jgrid.interior_slices
    jm = jcl.momentum_tendencies(jgrid, jf, {})
    tm = tcl.momentum_tendencies(tgrid, tf, {})
    for c in "uvw":
        assert _rel(tm[c][ints].numpy(), np.asarray(jm[c])[ints]) <= 1e-12
    want = np.asarray(jcl.tracer_tendency(jgrid, "b", jf, {}))[ints]
    got = tcl.tracer_tendency(tgrid, "b", tf, {})[ints].numpy()
    assert _rel(got, want) <= 1e-12
    want = np.asarray(JBuoyancyTracer().z_buoyancy(jgrid, jf))[ints]
    got = ot.BuoyancyTracer().z_buoyancy(tgrid, tf)[ints].numpy()
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("name", ["c", "u"])
def test_apply_flux_bcs_against_jax(name):
    N, H = (4, 4, 6), (3, 3, 3)
    loc = LOCS[name]
    jgrid, tgrid = _jgrid(N, H), _tgrid(N, H)
    spec = dict(top=("flux", 2e-3), bottom=("flux", -5e-4))
    jbcs = j_regularize(_bcs(spec, J_BC, JFBC), jgrid, loc)
    tbcs = regularize_field_boundary_conditions(
        _bcs(spec, T_BC, ot.FieldBoundaryConditions), tgrid, loc)
    G = np.random.default_rng(6).standard_normal(N)
    jG = jnp.zeros(jgrid.padded_shape).at[jgrid.interior_slices].set(G)
    want = np.asarray(j_apply_flux_bcs(jG, jgrid, loc, jbcs))
    got = apply_flux_bcs(torch.as_tensor(G.copy()), tgrid, loc, tbcs).numpy()
    assert np.max(np.abs(got - want[jgrid.interior_slices])) <= 1e-15


def test_set_callable_with_z_halos():
    N, H = (4, 5, 6), (3, 3, 3)
    fn = lambda x, y, z: np.sin(3 * x) * np.cos(y) + z ** 2
    want = np.asarray(j_set_on_padded(_jgrid(N, H), LOCS["c"], fn))
    got = set_on_padded(_tgrid(N, H), LOCS["c"], fn).numpy()
    assert np.max(np.abs(got - want)) <= 1e-15


# -- the whole model ----------------------------------------------------------

DT = 1e-3
N_MODEL = (8, 8, 16)


def _numpy_state(model):
    return dict(fields={n: np.asarray(a)
                        for n, a in model.state["fields"].items()},
                pressure=np.asarray(model.state["pressure"]),
                clock={k: np.asarray(v)
                       for k, v in model.state["clock"].items()})


def _convection_jax():
    m = JModel(grid=JGrid(size=N_MODEL, extent=(1.0, 1.0, 1.0),
                          dtype=np.float64),
               advection=JWENO(5, smoothness_dtype=jnp.float64),
               buoyancy=JBuoyancyTracer(), tracers=("b",),
               closure=JScalarDiffusivity(nu=1e-4, kappa={"b": 1e-4}),
               boundary_conditions={"b": JFBC(top=JValue(-0.5),
                                              bottom=JValue(0.5))})
    m.set(b=lambda x, y, z: -z - 0.5, enforce_incompressibility=False)
    m.set(u=1e-3 * np.random.default_rng(0).standard_normal(N_MODEL))
    return m


def test_model_against_jax():
    jm = _convection_jax()
    assert jm.grid.H[2] == 3 and not jm._z_compact
    start = _numpy_state(jm)
    for _ in range(3):
        jm.time_step(DT)
    end = _numpy_state(jm)

    port = chip_smoke.convection_model(N_MODEL, torch.float64, "cpu",
                                       smoothness=torch.float64)
    assert port.grid.H == (3, 3, 3) and not port._z_compact
    state_from_jax(start, port)
    for _ in range(3):
        port.time_step(DT)
    assert port.iteration == 3
    assert abs(port.time - float(end["clock"]["time"])) < 1e-15
    for name in ("u", "v", "w", "b", "p"):
        a = end["pressure"] if name == "p" else end["fields"][name]
        h = [(a.shape[ax] - N_MODEL[ax]) // 2 for ax in range(3)]
        want = a[h[0]:h[0] + N_MODEL[0], h[1]:h[1] + N_MODEL[1],
                 h[2]:h[2] + N_MODEL[2]]
        got = port.field(name).data[port.grid.interior_slices].numpy()
        err = np.max(np.abs(got - want))
        assert err < 5e-10, (name, err)


def test_model_set_against_jax():
    """set() with the padded projection gives the JAX initial state."""
    jm = _convection_jax()
    port = chip_smoke.convection_model(N_MODEL, torch.float64, "cpu",
                                       smoothness=torch.float64)
    ints = port.grid.interior_slices
    for name in "uvwb":
        a = np.asarray(jm.state["fields"][name])
        want = a[jm.grid.interior_slices]
        got = port.state["fields"][name][ints].numpy()
        assert np.max(np.abs(got - want)) < 1e-14, name


@pytest.mark.parametrize("name", ["thermal_bubble", "rayleigh_benard"])
def test_goldens(name):
    model, dt, steps = chip_smoke.GOLDENS[name](torch.float64, "cpu")
    for _ in range(steps):
        model.time_step(dt)
    with np.load(os.path.join(DATA, f"regression_{name}.npz")) as ref:
        for field in ref.files:
            got = model.field(field).interior.numpy()
            want = ref[field]
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
            assert err < 1e-9, (name, field, err)


# -- what is not ported -------------------------------------------------------

# the options the port refused before item 15, which the model now takes
# (tests/test_torch_long_tail.py holds them against JAX)
UNPORTED = {
    "particles": lambda: dict(particles=ot.LagrangianParticles(
        x=[0.5], y=[0.5], z=[-0.5])),
    "biogeochemistry": lambda: dict(
        biogeochemistry=ot.biogeochemistry.SimpleBiogeochemistry(
            tracers=("P",))),
    "auxiliary_fields": lambda: dict(auxiliary_fields={"a": None}),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_options_raise(case):
    """Once refused, now taken: the model carries the option, leaves the
    z-compact route where JAX does, and steps."""
    grid = _tgrid((8, 8, 8), (3, 3, 3))
    kw = UNPORTED[case]()
    if case == "auxiliary_fields":
        kw = dict(auxiliary_fields={"a": ot.CenterField(grid).set(1.0)})
    m = NonhydrostaticModel(grid, advection=ot.WENO(5), **kw)
    assert m._z_compact == (case == "auxiliary_fields")
    m.time_step(1e-3)
    if case == "particles":
        assert m.state["particles"]["x"].shape == (1,)
    elif case == "biogeochemistry":
        assert "P" in m.tracer_names
    else:
        assert m.field("a") is kw["auxiliary_fields"]["a"]


def test_pressure_solver_is_taken():
    """``pressure_solver=`` (since item 11c): the model projects with the
    solver it is given, here the FFT solver of its own grid, as with the
    one it selects."""
    from oceananigans_tpu_torch.solvers import FFTPoissonSolver
    grid = _tgrid((8, 8, 8), (3, 3, 3))
    solver = FFTPoissonSolver(grid)
    rng = np.random.default_rng(4)
    u = 0.1 * rng.standard_normal((8, 8, 8))
    given = NonhydrostaticModel(grid, advection=ot.WENO(5),
                                pressure_solver=solver, tracers=("c",))
    chosen = NonhydrostaticModel(grid, advection=ot.WENO(5), tracers=("c",))
    assert given.pressure_solver is solver
    for m in (given, chosen):
        m.set(u=u)
        m.time_step(1e-2)
    for name in ("u", "v", "w", "p"):
        assert torch.equal(given.field(name).interior,
                           chosen.field(name).interior), name


COMPACT = {
    "passive_tracer_z_compact": dict(tracers=("c",)),
    "buoyancy_z_compact": dict(buoyancy=ot.BuoyancyTracer()),
}


@pytest.mark.parametrize("case", sorted(COMPACT))
def test_compact_configurations_step(case):
    """Tracers and buoyancy without a closure or a z condition take the
    z-compact layout (no z halo) and step: the passive tracer by the fused
    update route, the buoyant model by the tendency route."""
    grid = _tgrid((8, 8, 8), (3, 3, 3))
    model = NonhydrostaticModel(grid, advection=ot.WENO(5), **COMPACT[case])
    assert model.grid.H[2] == 0
    assert model._fused_update == ("tracers" in COMPACT[case])
    rng = np.random.default_rng(9)
    model.set(u=0.1 * rng.standard_normal((8, 8, 8)),
              **{n: rng.random((8, 8, 8)) for n in model.tracer_names})
    model.time_step(1e-2)
    for name in model.prognostic_names:
        assert torch.isfinite(model.field(name).interior).all(), name


def test_kernel_scheme_tables():
    """The kernels' coefficient table covers every scheme of the port's
    advection/schemes.py up to buffer 6 (Centered(2-12), UpwindBiased(1-11),
    WENO(3-11)), sized for the scheme's buffer; a FluxFormAdvection takes
    its deepest axis's instantiation and its axes' families and buffers
    after the table (``kernel_coefs``); a deeper order raises naming what
    the kernels are built for."""
    from oceananigans_tpu_torch.advection import FluxFormAdvection
    from oceananigans_tpu_torch.kernels.fused_advection import (
        coefficient_table, kernel_coefs, scheme_code, table_layout)
    for scheme in ([ot.Centered(o) for o in range(2, 13, 2)]
                   + [ot.UpwindBiased(o) for o in range(1, 12, 2)]
                   + [ot.WENO(o) for o in range(3, 12, 2)]):
        _, K = scheme_code(scheme)
        assert K == scheme.required_halo
        assert len(coefficient_table(scheme)) == table_layout(K)["size"]
    assert list(coefficient_table(ot.Centered(2)))[0:2] == [0.5, 0.5]
    per_axis = FluxFormAdvection(ot.WENO(5), ot.WENO(5), ot.WENO(3))
    assert scheme_code(per_axis) == (2, 3)
    assert list(kernel_coefs(per_axis))[-6:] == [2, 2, 2, 3, 3, 2]
    assert list(kernel_coefs(per_axis))[:-6] == list(
        coefficient_table(ot.WENO(5)))
    for scheme in (ot.Centered(14), ot.UpwindBiased(13),
                   FluxFormAdvection(ot.WENO(5), ot.WENO(5), ot.Centered(14))):
        with pytest.raises(NotImplementedError, match="built for"):
            scheme_code(scheme)