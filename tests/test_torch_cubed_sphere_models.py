"""The port's cubed-sphere models against the JAX package's, float64.

- ``CubedSphereShallowWaterModel``: Williamson test case 2 with a
  perturbation, both PV schemes, 5 steps at 1e-12 of each field's scale;
  the total mass conserved to 1e-12.
- ``CubedSphereHydrostaticModel``: the balanced jet of the JAX golden with
  a buoyancy anomaly, 3 steps at 1e-10, under the explicit, implicit (the
  CG at 1e-13 in both packages) and split-explicit free surfaces, the RK3
  and quasi-AB2 steppers, batched (the default) and per panel; a JAX state
  loaded with ``state_from_jax`` and stepped on; the JAX golden
  ``tests/data/regression_cubed_sphere_hydro.npz`` at JAX's own 1e-9.

The JAX references are built once per module. Both packages evaluate the
same stencils; the differences are roundoff (about 1e-15).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.grids.cubed_sphere import \
    ConformalCubedSphereGrid as JGrid
from oceananigans_tpu.models import CubedSphereHydrostaticModel as JHydro
from oceananigans_tpu.models.cubed_sphere_shallow_water import \
    CubedSphereShallowWaterModel as JSW
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.models.cubed_sphere_hydrostatic import \
    state_from_jax as hydro_from_jax
from oceananigans_tpu_torch.models.cubed_sphere_shallow_water import \
    state_from_jax as sw_from_jax

torch.set_num_threads(1)

R, OMEGA, G = 6.371e6, 7.292e-5, 9.81
DATA = os.path.join(os.path.dirname(__file__), "data")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _compare(jm, tm, names, tol):
    for n in names:
        want = np.asarray(jm.field(n).interior)
        got = tm.field(n).interior.numpy()
        assert got.shape == want.shape, n
        assert _rel(got, want) <= tol, (n, _rel(got, want))
    assert tm.iteration == jm.iteration
    assert abs(tm.time - jm.time) <= 1e-9


# -- shallow water ------------------------------------------------------------

A_SW, G_SW, U_SW, H_SW = 6.37122e6, 9.80616, 20.0, 8000.0
N_SW = 8
TC2 = dict(
    h=lambda lam, phi: H_SW - (A_SW * OMEGA * U_SW + 0.5 * U_SW ** 2)
    * np.sin(phi) ** 2 / G_SW + 10.0 * np.cos(3 * lam) * np.cos(phi),
    u_east=lambda lam, phi: U_SW * np.cos(phi) + 2.0 * np.sin(2 * lam),
    v_north=lambda lam, phi: 3.0 * np.cos(lam) * np.cos(phi))
DT_SW = 0.3 * (2 * np.pi * A_SW / (4 * N_SW) * 0.6) / np.sqrt(G_SW * H_SW)


@pytest.mark.parametrize("pv_scheme", ["energy_conserving",
                                       "enstrophy_conserving"])
def test_shallow_water_matches_jax(pv_scheme):
    jg = JGrid((N_SW, N_SW), radius=A_SW, dtype=jnp.float64)
    tg = ot.ConformalCubedSphereGrid((N_SW, N_SW), radius=A_SW,
                                     dtype=torch.float64, device="cpu")
    jm = JSW(jg, gravity=G_SW, rotation_rate=OMEGA, pv_scheme=pv_scheme)
    tm = ot.CubedSphereShallowWaterModel(tg, gravity=G_SW,
                                         rotation_rate=OMEGA,
                                         pv_scheme=pv_scheme)
    jm.set_geographic(**TC2)
    tm.set_geographic(**TC2)
    for n in ("h", "u", "v"):
        assert np.array_equal(tm.state["fields"][n].numpy(),
                              np.asarray(jm.state[n])), n
    m0 = tm.total_mass()
    for _ in range(5):
        jm.time_step(DT_SW)
        tm.time_step(DT_SW)
    _compare(jm, tm, ("h", "u", "v"), 1e-12)
    assert abs(tm.total_mass() - m0) <= 1e-12 * m0
    # a JAX state loaded into a fresh model steps on alike
    tm2 = ot.CubedSphereShallowWaterModel(tg, gravity=G_SW,
                                          rotation_rate=OMEGA,
                                          pv_scheme=pv_scheme)
    sw_from_jax({k: np.asarray(v) for k, v in jm.state.items()}, tm2)
    jm.time_step(DT_SW)
    tm2.time_step(DT_SW)
    _compare(jm, tm2, ("h", "u", "v"), 1e-12)


# -- the hydrostatic model ----------------------------------------------------

U_JET, H0 = 20.0, 1000.0
N_H = 8
DT = 1200.0


def _jet(m):
    """The golden's balanced jet and buoyancy anomaly."""
    m.set_geographic(u_east=lambda lam, phi: U_JET * np.cos(phi),
                     v_north=lambda lam, phi: 0.0 * lam)
    m.set(eta=lambda lam, phi: -(R * OMEGA * U_JET + 0.5 * U_JET ** 2)
          * np.sin(phi) ** 2 / G,
          b=lambda lam, phi, z: 1e-5 * z + 1e-4
          * np.exp(-((lam - np.pi / 4) ** 2 + phi ** 2) / 0.1))
    return m


CONFIGS = {
    "explicit_rk3": dict(),
    "implicit_rk3": dict(free_surface="implicit", implicit_solver_tol=1e-13),
    "explicit_ab2": dict(timestepper="QuasiAdamsBashforth2"),
    "implicit_ab2": dict(free_surface="implicit", implicit_solver_tol=1e-13,
                         timestepper="QuasiAdamsBashforth2"),
    "split_explicit": dict(free_surface="split_explicit", substeps=12),
}


@pytest.fixture(scope="module")
def grids():
    jg = JGrid((N_H, N_H, 2), z=(-H0, 0.0), radius=R, dtype=jnp.float64)
    tg = ot.ConformalCubedSphereGrid((N_H, N_H, 2), z=(-H0, 0.0), radius=R,
                                     dtype=torch.float64, device="cpu")
    return jg, tg


@pytest.fixture(scope="module")
def jax_runs(grids):
    """{config: (the JAX model after 3 steps, its state after 2)}."""
    jg, _ = grids
    out = {}
    for name, kw in CONFIGS.items():
        jm = _jet(JHydro(jg, tracers=("b",), rotation_rate=OMEGA, gravity=G,
                         **kw))
        for _ in range(2):
            jm.time_step(DT)
        mid = jax_state_numpy(jm.state)
        jm.time_step(DT)
        out[name] = (jm, mid)
    return out


def jax_state_numpy(state):
    return {k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_hydrostatic_matches_jax(config, grids, jax_runs):
    """3 steps, batched and per panel, each against JAX at 1e-10; the two
    port modes agree to 1e-12."""
    _, tg = grids
    jm, _ = jax_runs[config]
    runs = []
    for batch in (True, False):
        tm = _jet(ot.CubedSphereHydrostaticModel(
            tg, tracers=("b",), rotation_rate=OMEGA, gravity=G,
            batch_panels=batch, **CONFIGS[config]))
        for _ in range(3):
            tm.time_step(DT)
        _compare(jm, tm, ("u", "v", "eta", "b", "w"), 1e-10)
        runs.append(tm)
    for n in ("u", "v", "eta", "b"):
        assert _rel(runs[1].field(n).interior.numpy(),
                    runs[0].field(n).interior.numpy()) <= 1e-12


@pytest.mark.parametrize("config", ["split_explicit", "implicit_ab2"])
def test_state_from_jax(config, grids, jax_runs):
    """JAX's state after 2 steps, loaded into the port, then one step on
    each side (the AB2 memory and the barotropic state carried over)."""
    _, tg = grids
    jm, mid = jax_runs[config]
    tm = ot.CubedSphereHydrostaticModel(tg, tracers=("b",),
                                        rotation_rate=OMEGA, gravity=G,
                                        **CONFIGS[config])
    hydro_from_jax(mid, tm)
    assert tm.iteration == 2
    tm.time_step(DT)
    _compare(jm, tm, ("u", "v", "eta", "b"), 1e-10)


def test_cubed_sphere_golden():
    """tests/test_regression.py's cubed-sphere run (12×12×2, the balanced
    jet, 5 RK3 steps of 1200 s with the explicit free surface) against its
    golden at JAX's own 1e-9."""
    tg = ot.ConformalCubedSphereGrid((12, 12, 2), z=(-H0, 0.0), radius=R,
                                     dtype=torch.float64, device="cpu")
    m = _jet(ot.CubedSphereHydrostaticModel(tg, tracers=("b",),
                                            rotation_rate=OMEGA, gravity=G))
    for _ in range(5):
        m.time_step(DT)
    with np.load(os.path.join(DATA, "regression_cubed_sphere_hydro.npz")) \
            as ref:
        for name in ref.files:
            got = m.field(name).interior.numpy()
            assert got.shape == ref[name].shape
            assert _rel(got, ref[name]) < 1e-9, name


def test_model_refusals(grids):
    _, tg = grids
    flat = ot.ConformalCubedSphereGrid((4, 4), dtype=torch.float64,
                                       device="cpu")
    with pytest.raises(ValueError, match="z=\\(bottom, top\\)"):
        ot.CubedSphereHydrostaticModel(flat)
    with pytest.raises(ValueError, match="VectorInvariant"):
        ot.CubedSphereHydrostaticModel(tg, momentum_advection=ot.WENO(5))
    with pytest.raises(ValueError, match="halo >= "):
        ot.CubedSphereHydrostaticModel(tg, tracer_advection=ot.WENO(7))
