"""Tracers and buoyancy on the port's z-compact layout against the JAX
package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode; its z-compact layout
needs Nz % 128 == 0, so the models run at (16, 16, 128). Inputs come from
numpy seeds; float64 fields with float64 WENO smoothness. Bounds:

- the z-compact models after set() and a few RK3 steps of Δt = 1e-3, against
  the JAX model of the same configuration: 5e-10 absolute on u, v, w, p and
  every tracer, the bound tests/test_z_compact.py holds the JAX compact and
  padded paths to after 3 steps:
  - WENO(5) with 2 tracers (the JAX fused update in one group) and with 7
    tracers (a momentum group and tracer groups of 4 and 3), both with the
    deferred correction; 3 and 2 steps;
  - Centered(2) with 2 tracers, 3 steps;
  - BuoyancyTracer (the JAX tendency route with the z-compact #6, the fill
    before each stage, w's face pinned after each update and the fast
    projection), 3 steps;
- the plain versions of the kernels against the JAX Pallas kernels on one
  (16, 16, 128) grid with H = (4, 4, 0): the z-compact tendency (#6)
  against ``build_fused_advection`` and the tracer group of the fused update
  (#1) against ``_build_update_group(include_momentum=False)``, with and
  without G⁻ and the correction: 1e-12 relative to max|JAX| (the same
  stencils in another association order);
- ``state_from_jax`` carries the tracers exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import Centered as JCentered, WENO as JWENO
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoyancyTracer
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.kernels.fused_advection import (_build_update_group,
                                                      build_fused_advection)
from oceananigans_tpu.models import NonhydrostaticModel as JModel
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.models import NonhydrostaticModel, state_from_jax

torch.set_num_threads(1)

N = (16, 16, 128)
DT = 1e-3
BOUND = 5e-10
TOL = 1e-12

# name: (scheme, tracers, buoyancy, steps)
CONFIGS = {
    "weno5_2_tracers": ("weno5", ("c0", "c1"), False, 3),
    "weno5_7_tracers": ("weno5", tuple(f"c{i}" for i in range(7)), False, 2),
    "centered2_2_tracers": ("centered2", ("c0", "c1"), False, 3),
    "buoyancy": ("weno5", (), True, 3),
}


def _schemes(kind):
    if kind == "centered2":
        return JCentered(order=2), ot.Centered(2)
    return (JWENO(5, smoothness_dtype=jnp.float64),
            ot.WENO(5, smoothness_dtype=torch.float64))


def _initial(tracers):
    rng = np.random.default_rng(0)
    values = dict(u=0.1 * rng.standard_normal(N),
                  v=0.1 * rng.standard_normal(N))
    for name in tracers:
        values[name] = rng.random(N)
    return values


def _numpy_state(model):
    return dict(fields={n: np.asarray(a)
                        for n, a in model.state["fields"].items()},
                pressure=np.asarray(model.state["pressure"]),
                clock={k: np.asarray(v)
                       for k, v in model.state["clock"].items()})


def _models(case):
    kind, tracers, buoyant, _ = CONFIGS[case]
    jscheme, tscheme = _schemes(kind)
    jkw = dict(buoyancy=JBuoyancyTracer()) if buoyant else {}
    tkw = dict(buoyancy=ot.BuoyancyTracer()) if buoyant else {}
    jm = JModel(grid=JGrid(size=N, extent=(1.0, 1.0, 1.0), dtype=np.float64),
                advection=jscheme, tracers=tracers, **jkw)
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                              dtype=torch.float64, device="cpu")
    tm = NonhydrostaticModel(grid, advection=tscheme, tracers=tracers, **tkw)
    values = _initial(tracers)
    if buoyant:
        values["b"] = 0.01 * np.random.default_rng(1).standard_normal(N)
    return jm, tm, values


@pytest.fixture(scope="module")
def jax_runs():
    """Each configuration's JAX states after set() and after every step,
    built once for the module."""
    runs = {}

    def run(case):
        if case not in runs:
            jm, _, values = _models(case)
            assert jm._z_compact
            if CONFIGS[case][2]:
                assert jm._fused_advection is not None
                assert jm._fused_update is None and jm._fused_div is not None
            else:
                assert jm._fused_update is not None and jm._fuse_correction
            jm.set(**values)
            states = [_numpy_state(jm)]
            for _ in range(CONFIGS[case][3]):
                jm.time_step(DT)
                states.append(_numpy_state(jm))
            runs[case] = states
        return runs[case]

    return run


def _interior(a):
    h = [(a.shape[ax] - N[ax]) // 2 for ax in range(3)]
    return a[h[0]:h[0] + N[0], h[1]:h[1] + N[1], h[2]:h[2] + N[2]]


def _errors(jstate, model):
    arrays = dict(jstate["fields"], p=jstate["pressure"])
    names = model.prognostic_names + ("p",)
    return {n: np.max(np.abs(model.field(n).interior.numpy()
                             - _interior(arrays[n]))) for n in names}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_compact_model_against_jax(jax_runs, case):
    states = jax_runs(case)
    _, port, values = _models(case)
    assert port.grid.H[2] == 0
    assert port._fused_update == (not CONFIGS[case][2])
    port.set(**values)
    for name, err in _errors(states[0], port).items():
        assert err < BOUND, (case, "set", name, err)
    for _ in range(CONFIGS[case][3]):
        port.time_step(DT)
    assert abs(port.time - float(states[-1]["clock"]["time"])) < 1e-15
    for name, err in _errors(states[-1], port).items():
        assert err < BOUND, (case, name, err)


def test_state_from_jax_with_tracers(jax_runs):
    """The port started from the JAX state after one step holds its
    interiors exactly, tracers included, and one more step of each agrees."""
    states = jax_runs("weno5_2_tracers")
    _, port, _ = _models("weno5_2_tracers")
    state_from_jax(states[1], port)
    assert port.iteration == 1 and port.tracer_names == ("c0", "c1")
    for name, err in _errors(states[1], port).items():
        assert err == 0.0, name
    port.time_step(DT)
    for name, err in _errors(states[2], port).items():
        assert err < BOUND, (name, err)


def test_compact_tracers_conserved():
    """Flux-form advection with zero boundary-face fluxes conserves every
    tracer's sum to roundoff on the z-compact route, with either scheme."""
    for scheme in (ot.WENO(5, smoothness_dtype=torch.float64),
                   ot.Centered(2)):
        grid = ot.RectilinearGrid(size=(8, 8, 16), extent=(1.0, 1.0, 1.0),
                                  dtype=torch.float64, device="cpu")
        m = NonhydrostaticModel(grid, advection=scheme, tracers=("a", "b"))
        rng = np.random.default_rng(3)
        m.set(u=0.1 * rng.standard_normal((8, 8, 16)),
              w=0.1 * rng.standard_normal((8, 8, 16)),
              a=rng.random((8, 8, 16)), b=rng.random((8, 8, 16)))
        before = {n: m.field(n).interior.sum().item() for n in "ab"}
        for _ in range(3):
            m.time_step(1e-2)
        for n in "ab":
            drift = abs(m.field(n).interior.sum().item() - before[n])
            assert drift <= 1e-12 * before[n], (scheme, n, drift)


# -- the kernels' plain versions against the JAX Pallas kernels -------------------

H = (4, 4, 0)


@pytest.fixture(scope="module")
def kernel_inputs():
    jgrid = JGrid(size=N, extent=(1.0, 2.0, 1.0), halo=H, dtype=np.float64)
    tgrid = ot.RectilinearGrid(size=N, extent=(1.0, 2.0, 1.0), halo=H,
                               dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(21)
    ints = [0.1 * rng.standard_normal(N) for _ in range(3)]
    ints[2][..., 0] = 0.0
    ints.append(1e-2 * rng.standard_normal(N))                  # p
    ints += [rng.random(N) for _ in range(3)]                   # tracers
    padded = [np.pad(a, ((H[0], H[0]), (H[1], H[1]), (0, 0)), mode="wrap")
              for a in ints]
    gm = [rng.standard_normal(N) for _ in range(3)]
    return jgrid, tgrid, padded, gm


def test_compact_tendency_against_jax(kernel_inputs):
    """The z-compact #6 (mirrored z reads) with three tracers."""
    jgrid, tgrid, padded, _ = kernel_inputs
    names = ("c0", "c1", "c2")
    for jscheme, tscheme in (_schemes("weno5"), _schemes("centered2")):
        fn = build_fused_advection(jgrid, jscheme, names)
        j = [jnp.asarray(a) for a in padded]
        Gu, Gv, Gw, Gc = fn(j[0], j[1], j[2], dict(zip(names, j[4:])))
        want = [Gu, Gv, Gw] + [Gc[n] for n in names]
        fields = [torch.as_tensor(a) for a in padded[:3] + padded[4:]]
        got = K.fused_advection_tendency(tgrid, tscheme, fields)
        for k, w in enumerate(want):
            w = np.asarray(w)[tgrid.interior_slices]
            err = np.max(np.abs(got[k].numpy() - w)) / np.max(np.abs(w))
            assert err <= TOL, (tscheme, k, err)


@pytest.mark.parametrize("with_gm", [False, True])
@pytest.mark.parametrize("with_corr", [False, True])
def test_update_tracer_group_against_jax(kernel_inputs, with_gm, with_corr):
    """The tracers of #1 against the JAX tracer group (include_momentum=
    False): G and new, with the deferred correction advecting the tracers by
    the corrected velocities."""
    jgrid, tgrid, padded, gm = kernel_inputs
    names = ("c0", "c1", "c2")
    jscheme, tscheme = _schemes("weno5")
    fn = _build_update_group(jgrid, jscheme, names, include_momentum=False,
                             with_corr=with_corr)
    j = [jnp.asarray(a) for a in padded]
    t = [torch.as_tensor(a) for a in padded]
    gdt, zdt, cdt = 0.1, -0.05, 0.07
    jkw = dict(p=j[3], corr_dt=cdt) if with_corr else {}
    tkw = dict(p=t[3], corr_dt=cdt) if with_corr else {}
    jG, jnew = fn(j[0], j[1], j[2], dict(zip(names, j[4:])),
                  [jnp.asarray(g) for g in gm] if with_gm else None,
                  gdt, zdt, **jkw)
    tgm = None
    if with_gm:
        tgm = [torch.zeros(N, dtype=torch.float64)] * 3 \
            + [torch.as_tensor(g) for g in gm]
    tG, tnew = K.fused_advection_update(
        tgrid, tscheme, t[0], t[1], t[2], tgm, gdt, zdt,
        tracers=dict(zip(names, t[4:])), **tkw)
    for k, name in enumerate(names):
        want = np.asarray(jG[k])
        err = np.max(np.abs(tG[3 + k].numpy() - want)) / np.max(np.abs(want))
        assert err <= TOL, ("G", name, err)
        want = np.asarray(jnew[name])
        err = np.max(np.abs(tnew[name].numpy() - want)) / np.max(np.abs(want))
        assert err <= TOL, ("new", name, err)
