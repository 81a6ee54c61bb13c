"""The port's CubedSphereHydrostaticModel with the ocean physics, against
the JAX package's, float64, and driven through the run loop.

- a ``GridFittedBottom`` seamount (split-explicit), a ``PartialCellBottom``
  (explicit RK3), z* under quasi-AB2 and RK3, and CATKE with GM/Redi
  triads: 3 steps at 1e-10 of each field's scale;
- ``examples/global_cubed_sphere_ocean.py``'s configuration (WENO-VI(5),
  WENO(5) tracers b and c, CATKE + triads, the continent-and-ridge bottom,
  wind stress and buoyancy flux, split-explicit with 20 substeps) at
  N = 8, nz = 2 over 2 steps at 1e-10, TKE included;
- ``Simulation`` with a ``FieldWriter`` and a ``Checkpointer``, whose
  pickup continues bit for bit (the JAX tests
  ``test_simulation_layer_drives_cubed_sphere_model`` and
  ``test_checkpoint_restore_bitwise``).

WENO takes float64 smoothness on both sides. Callables of the panels'
(λ°, φ°) (the flux conditions) are written with torch functions on the
port's side.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.advection.vector_invariant import \
    WENOVectorInvariant as JWENOVI
from oceananigans_tpu.boundary_conditions import (BoundaryCondition as JBC,
                                                  FieldBoundaryConditions
                                                  as JFBC)
from oceananigans_tpu.boundary_conditions.boundary_condition import \
    FLUX as JFLUX
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoyancyTracer
from oceananigans_tpu.closures import (CATKEVerticalDiffusivity as JCATKE,
                                       ClosureTuple as JTuple,
                                       TriadIsopycnalSkewSymmetricDiffusivity
                                       as JTriad)
from oceananigans_tpu.grids.cubed_sphere import \
    ConformalCubedSphereGrid as JGrid
from oceananigans_tpu.immersed import PartialCellBottom as JPartial
from oceananigans_tpu.models import CubedSphereHydrostaticModel as JHydro
import oceananigans_tpu_torch as ot

torch.set_num_threads(1)

R, OMEGA, G = 6.371e6, 7.292e-5, 9.81


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _compare(jm, tm, names, tol=1e-10):
    for n in names:
        want = np.asarray(jm.field(n).interior)
        got = tm.field(n).interior.numpy()
        assert _rel(got, want) <= tol, (n, _rel(got, want))


def _grids(N, nz, depth, **kw):
    return (JGrid((N, N, nz), z=(-depth, 0.0), radius=R, dtype=jnp.float64,
                  **kw),
            ot.ConformalCubedSphereGrid((N, N, nz), z=(-depth, 0.0),
                                        radius=R, dtype=torch.float64,
                                        device="cpu", **kw))


# -- immersed bottoms, z*, closures -------------------------------------------

def _seamount(lam, phi):
    return -1000.0 + 600.0 * np.exp(-((lam - 0.3) ** 2 + phi ** 2) / 0.1)


def _init(m):
    m.set(b=lambda lam, phi, z: 2e-5 * z
          + 1e-4 * np.exp(-((lam - 0.5) ** 2 + phi ** 2) / 0.2))
    m.set_geographic(u_east=lambda lam, phi: 2.0 * np.cos(phi))
    m.set(eta=lambda lam, phi: 0.05 * np.cos(lam) * np.cos(phi))
    return m


def _closures(jax_side):
    if jax_side:
        return JTuple(JCATKE(buoyancy=JBuoyancyTracer()),
                      JTriad(kappa_skew=500.0, kappa_symmetric=500.0,
                             buoyancy=JBuoyancyTracer()))
    return ot.closures.ClosureTuple(
        ot.CATKEVerticalDiffusivity(buoyancy=ot.BuoyancyTracer()),
        ot.TriadIsopycnalSkewSymmetricDiffusivity(
            kappa_skew=500.0, kappa_symmetric=500.0,
            buoyancy=ot.BuoyancyTracer()))


CASES = {
    "grid_fitted": (lambda j: dict(bottom_height=_seamount,
                                   free_surface="split_explicit",
                                   substeps=10), 6),
    "partial_cell": (lambda j: dict(
        bottom_height=(JPartial if j else ot.PartialCellBottom)(
            _seamount, minimum_fractional_cell_height=0.2)), 6),
    "zstar_ab2": (lambda j: dict(vertical_coordinate="zstar",
                                 free_surface="split_explicit", substeps=10,
                                 bottom_height=_seamount), 4),
    "zstar_rk3": (lambda j: dict(vertical_coordinate="zstar"), 4),
    "catke_triads": (lambda j: dict(closure=_closures(j),
                                    free_surface="split_explicit",
                                    substeps=10), 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_physics_matches_jax(case):
    make, nz = CASES[case]
    jg, tg = _grids(8, nz, 1000.0)
    jm = _init(JHydro(jg, tracers=("b",), rotation_rate=OMEGA, gravity=G,
                      **make(True)))
    tm = _init(ot.CubedSphereHydrostaticModel(
        tg, tracers=("b",), rotation_rate=OMEGA, gravity=G, **make(False)))
    for _ in range(3):
        jm.time_step(300.0)
        tm.time_step(300.0)
    names = ("u", "v", "eta", "b") + (("e",) if case == "catke_triads"
                                      else ())
    _compare(jm, tm, names)
    if case == "partial_cell":
        dz = tm._catp.grid.dz(("c", "c", "c"))
        full = 1000.0 / nz
        assert bool(((dz > 0.21 * full) & (dz < 0.99 * full)).any())
    if case.startswith("zstar"):
        assert abs(tm.total_tracer("b") - jm.total_tracer("b")) <= \
            1e-10 * abs(jm.total_tracer("b"))


# -- the example's configuration ----------------------------------------------

H0, U0 = 3000.0, 5.0


def _bottom(lam, phi):
    continent = 2800.0 * np.exp(-((lam - 1.2) ** 2 + (phi - 0.3) ** 2) / 0.18)
    ridge = 1200.0 * np.exp(-(lam + 1.8) ** 2 / 0.05)
    return -H0 + continent + ridge


def _global_ocean(jax_side, N=8, nz=2):
    if jax_side:
        grid = JGrid((N, N, nz), z=(-H0, 0.0), radius=R, halo=4,
                     dtype=jnp.float64)
        bcs = {"u": JFBC(top=JBC(JFLUX, lambda lam, phi, t:
                                 -1e-4 * np.cos(3.0 * phi))),
               "b": JFBC(top=JBC(JFLUX, lambda lam, phi, t:
                                 3e-9 * np.cos(phi)))}
        m = JHydro(grid, tracers=("b", "c"), rotation_rate=OMEGA, gravity=G,
                   momentum_advection=JWENOVI(
                       order=5, smoothness_dtype=jnp.float64),
                   tracer_advection=JWENO(5, smoothness_dtype=jnp.float64),
                   closure=_closures(True), bottom_height=_bottom,
                   free_surface="split_explicit", substeps=20,
                   boundary_conditions=bcs)
    else:
        grid = ot.ConformalCubedSphereGrid((N, N, nz), z=(-H0, 0.0),
                                           radius=R, halo=4,
                                           dtype=torch.float64, device="cpu")
        bcs = {"u": ot.FieldBoundaryConditions(top=ot.FluxBoundaryCondition(
            lambda lam, phi, t: -1e-4 * torch.cos(3.0 * phi))),
            "b": ot.FieldBoundaryConditions(top=ot.FluxBoundaryCondition(
                lambda lam, phi, t: 3e-9 * torch.cos(phi)))}
        m = ot.CubedSphereHydrostaticModel(
            grid, tracers=("b", "c"), rotation_rate=OMEGA, gravity=G,
            momentum_advection=ot.WENOVectorInvariant(
                order=5, smoothness_dtype=torch.float64),
            tracer_advection=ot.WENO(5, smoothness_dtype=torch.float64),
            closure=_closures(False), bottom_height=_bottom,
            free_surface="split_explicit", substeps=20,
            boundary_conditions=bcs)
    m.set_geographic(u_east=lambda lam, phi: U0 * np.cos(phi),
                     v_north=lambda lam, phi: 0.0 * lam)
    m.set(eta=lambda lam, phi: -(R * OMEGA * U0 + 0.5 * U0 * U0)
          * np.sin(phi) ** 2 / G,
          b=lambda lam, phi, z: 1e-5 * z + 2e-4
          * np.exp(-((lam - np.pi / 4) ** 2 + phi ** 2) / 0.1)
          * np.exp(-((z + H0 / 2) / (H0 / 4)) ** 2),
          c=lambda lam, phi, z: np.exp(-((lam + np.pi / 2) ** 2
                                         + phi ** 2) / 0.15))
    return m


def test_global_ocean_example_matches_jax():
    """2 steps of the example's Δt at N = 8, nz = 2; batched and per panel.
    The passive tracer's total (which the triads' immersed fluxes move) as
    JAX's, to 1e-10."""
    dt = min(0.02 * (2 * np.pi * R / (4 * 8) * 0.6) / U0, 1200.0)
    jm = _global_ocean(True)
    for _ in range(2):
        jm.time_step(dt)
    for batch in (True, False):
        tm = _global_ocean(False)
        tm._batch = batch
        for _ in range(2):
            tm.time_step(dt)
        _compare(jm, tm, ("u", "v", "eta", "b", "c", "e"))
        want = jm.total_tracer("c")
        assert abs(tm.total_tracer("c") - want) <= 1e-10 * want


# -- the run loop -------------------------------------------------------------

def _small_model(tg):
    m = ot.CubedSphereHydrostaticModel(tg, tracers=("b",),
                                       rotation_rate=OMEGA)
    m.set(b=lambda lam, phi, z: 1e-5 * z
          + 1e-4 * np.exp(-(lam ** 2 + phi ** 2) / 0.1))
    return m


def test_simulation_drives_cubed_sphere_model(tmp_path):
    """Simulation, its NaN check and a FieldWriter drive the model through
    its field() view (JAX test_simulation_layer_drives_cubed_sphere_model);
    the shallow-water model too."""
    _, tg = _grids(8, 2, 500.0)
    m = _small_model(tg)
    d = str(tmp_path / "cs_out")
    sim = ot.Simulation(m, dt=300.0, stop_iteration=4)
    sim.add_output_writer(ot.FieldWriter(m, dict(b="b", eta="eta"), d,
                                         schedule=ot.IterationInterval(2)))
    sim.run()
    with open(os.path.join(d, "series.json")) as f:
        idx = json.load(f)
    assert idx["iterations"] == [0, 2, 4]
    arr = np.load(os.path.join(d, "b_4.npy"))
    assert arr.shape == (6, 8, 8, 2) and np.isfinite(arr).all()
    assert np.load(os.path.join(d, "eta_4.npy")).shape == (6, 8, 8, 1)
    sw = ot.CubedSphereShallowWaterModel(
        ot.ConformalCubedSphereGrid((8, 8), radius=R, dtype=torch.float64,
                                    device="cpu"), gravity=G)
    sw.set_geographic(h=lambda lam, phi: 1000.0 + 0.0 * lam)
    ot.Simulation(sw, dt=100.0, stop_iteration=2).run()
    assert sw.iteration == 2


@pytest.mark.parametrize("free_surface", ["explicit", "split_explicit"])
def test_checkpoint_pickup_bitwise(free_surface, tmp_path):
    """A run of 3 steps checkpointed, restored into a fresh model and run 2
    more steps equals 5 uninterrupted steps bit for bit (the state, the AB2
    memory and the barotropic state included)."""
    _, tg = _grids(8, 2, 500.0)

    def model():
        m = ot.CubedSphereHydrostaticModel(tg, tracers=("b",),
                                           rotation_rate=OMEGA,
                                           free_surface=free_surface)
        m.set(b=lambda lam, phi, z: 1e-5 * z
              + 1e-4 * np.exp(-(lam ** 2 + phi ** 2) / 0.1))
        return m

    ref = model()
    for _ in range(5):
        ref.time_step(300.0)
    m = model()
    sim = ot.Simulation(m, dt=300.0, stop_iteration=3)
    sim.add_output_writer(ot.Checkpointer(m, ot.IterationInterval(3),
                                          dir=str(tmp_path)))
    sim.run()
    m2 = model()
    sim2 = ot.Simulation(m2, dt=300.0, stop_iteration=5)
    sim2.add_output_writer(ot.Checkpointer(m2, ot.IterationInterval(100),
                                           dir=str(tmp_path)))
    sim2.run(pickup=True)
    assert m2.iteration == 5
    for name in ("u", "v", "eta", "b"):
        assert torch.equal(m2.field(name).interior, ref.field(name).interior)
