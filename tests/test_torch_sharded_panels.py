"""The cubed sphere sharded over its panels, on the CPU: a panel mesh of
six shards (``Distributed(Mesh(["cpu"] * 6, ("panels",)))``, one thread a
shard, each a per-panel model over its panel), and of three and two,
against the JAX package's serial models (JAX's sharded step is its
per-panel build, which its own tests hold to the serial one) and the
port's serial models. Float64 fields from the same initial conditions.

- ``tests/test_parallel.py:317`` (C8×2, the explicit free surface, RK3, two
  steps of 300 s) at JAX's 1e-11, and the port's per-panel model bit for
  bit;
- ``tests/test_parallel.py:409`` (C8×6, halo 4: WENO-VI momentum, WENO(5)
  tracers, CATKE with the triads, a bathymetry, the split-explicit surface
  with 8 substeps) at JAX's 5e-10, and the port's per-panel model bit for
  bit (WENO's smoothness in float64 on both sides, as
  ``tests/test_torch_cubed_sphere_physics.py`` takes it: JAX's float32
  default rounds differently under jit than op by op);
- the implicit free surface on panels (its CG's dot products summed over
  the mesh: 1e-13 of max|·| from the serial model) and the shallow-water
  model (Williamson 2 with a perturbation; its per-panel mode and the
  sharded model bit for bit with the concatenated mode);
- the step never assembles the six panels, and counts the bytes its
  exchanges send; a panel count that does not divide six, an (x, y) mesh
  and ``CubedSpherePartition`` raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu.parallel as jpar
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.advection.vector_invariant import \
    WENOVectorInvariant as JWVI
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoyancy
from oceananigans_tpu.closures import (
    CATKEVerticalDiffusivity as JCATKE, ClosureTuple as JClosureTuple,
    TriadIsopycnalSkewSymmetricDiffusivity as JTriad)
from oceananigans_tpu.grids.cubed_sphere import \
    ConformalCubedSphereGrid as JGrid
from oceananigans_tpu.models import CubedSphereHydrostaticModel as JHydro
from oceananigans_tpu.models.cubed_sphere_shallow_water import \
    CubedSphereShallowWaterModel as JSW
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.parallel as tpar
from oceananigans_tpu_torch.grids.cubed_sphere import (PanelExchange,
                                                       ShardPanelExchange)

torch.set_num_threads(1)

F64 = torch.float64
R, OMEGA = 6.371e6, 7.292e-5


def panel_mesh(n=6):
    return ot.Distributed(tpar.Mesh(np.array(["cpu"] * n, dtype=object),
                                    ("panels",)))


def _interiors(m, names):
    """{name: the panels' interiors} of a port model's stacked state."""
    H, N = m.grid.H[0], m.grid.N[0]
    f = m.state["fields"]
    return {n: f[n][:, H:H + N, H:H + N].numpy() for n in names}


def _triple(build, steps, dt, shards=(6,)):
    """JAX's serial model, the port's per-panel model and the port's
    models sharded over ``shards`` panel meshes (JAX's call shape), each
    stepped ``steps`` times; ``build(J, batch)`` builds and sets one."""
    jm, serial = build(True, True), build(False, False)
    sharded = []
    for n in shards:
        m = build(False, True)
        m.state = panel_mesh(n).shard(m.state)
        assert m._shards is not None and len(m._shards) == n
        sharded.append(m)
    for _ in range(steps):
        for m in [jm, serial] + sharded:
            m.time_step(dt)
    return jm, serial, sharded


def _check(jm, serial, sharded, names, atol, serial_rel=0.0):
    """Each sharded model's stored panels against the port's serial model
    (bit for bit, or ``serial_rel`` of max|·|) and its fields (``field``:
    u and v through the shared-face sync) against JAX's (``atol``)."""
    want_s = _interiors(serial, names)
    for m in sharded:
        got = _interiors(m, names)
        for n in names:
            if serial_rel == 0.0:
                assert np.array_equal(got[n], want_s[n]), n
            else:
                assert np.abs(got[n] - want_s[n]).max() <= serial_rel * \
                    np.abs(want_s[n]).max(), n
            err = np.abs(m.field(n).interior.numpy()
                         - np.asarray(jm.field(n).interior)).max()
            assert err < atol, (n, err)
        assert m.iteration == jm.iteration


def _jet(J, batch, free_surface="explicit"):
    """``tests/test_parallel.py:317``'s model."""
    if J:
        g = JGrid((8, 8, 2), z=(-500.0, 0.0), radius=R, dtype=jnp.float64)
        m = JHydro(g, tracers=("b",), rotation_rate=OMEGA,
                   free_surface=free_surface, implicit_solver_tol=1e-13)
    else:
        g = ot.ConformalCubedSphereGrid((8, 8, 2), z=(-500.0, 0.0), radius=R,
                                        dtype=F64, device="cpu")
        m = ot.CubedSphereHydrostaticModel(
            g, tracers=("b",), rotation_rate=OMEGA, batch_panels=batch,
            free_surface=free_surface, implicit_solver_tol=1e-13)
    m.set(b=lambda lam, phi, z: 1e-5 * z + 1e-4
          * np.exp(-((lam - np.pi / 4) ** 2 + phi ** 2) / 0.05))
    m.set_geographic(u_east=lambda lam, phi: 5.0 * np.cos(phi))
    return m


def test_panels_against_jax_serial():
    """tests/test_parallel.py:317 over 6, 3 and 2 panel shards."""
    jm, serial, sharded = _triple(_jet, 2, 300.0, shards=(6, 3, 2))
    _check(jm, serial, sharded, ("u", "v", "b", "eta"), 1e-11)


def test_implicit_free_surface_on_panels():
    """The implicit free surface's CG on panel shards: the exchange inside
    the operator, the dot products summed over the mesh."""
    jm, serial, sharded = _triple(
        lambda J, b: _jet(J, b, "implicit"), 2, 300.0)
    _check(jm, serial, sharded, ("u", "v", "b", "eta"), 1e-11,
           serial_rel=1e-13)


def _full(J, batch):
    """``tests/test_parallel.py:409``'s full-capability model."""
    bottom = (lambda lam, phi: -2000.0 + 900.0
              * np.exp(-((lam - 1.0) ** 2 + (phi - 0.4) ** 2) / 0.3))
    if J:
        g = JGrid((8, 8, 6), z=(-2000.0, 0.0), radius=R, halo=4,
                  dtype=jnp.float64)
        m = JHydro(g, tracers=("b",), rotation_rate=OMEGA,
                   momentum_advection=JWVI(
                       order=5, smoothness_dtype=jnp.float64),
                   tracer_advection=JWENO(5, smoothness_dtype=jnp.float64),
                   closure=JClosureTuple(
                       JCATKE(buoyancy=JBuoyancy()),
                       JTriad(kappa_skew=500.0, kappa_symmetric=500.0,
                              buoyancy=JBuoyancy())),
                   bottom_height=bottom, free_surface="split_explicit",
                   substeps=8)
    else:
        g = ot.ConformalCubedSphereGrid((8, 8, 6), z=(-2000.0, 0.0),
                                        radius=R, halo=4, dtype=F64,
                                        device="cpu")
        m = ot.CubedSphereHydrostaticModel(
            g, tracers=("b",), rotation_rate=OMEGA,
            momentum_advection=ot.WENOVectorInvariant(
                order=5, smoothness_dtype=F64),
            tracer_advection=ot.WENO(5, smoothness_dtype=F64),
            closure=(ot.CATKEVerticalDiffusivity(buoyancy=ot.BuoyancyTracer()),
                     ot.TriadIsopycnalSkewSymmetricDiffusivity(
                         kappa_skew=500.0, kappa_symmetric=500.0,
                         buoyancy=ot.BuoyancyTracer())),
            bottom_height=bottom, free_surface="split_explicit", substeps=8,
            batch_panels=batch)
    m.set(b=lambda lam, phi, z: 2e-5 * z
          + 1e-4 * np.exp(-(lam ** 2 + phi ** 2) / 0.2))
    m.set_geographic(u_east=lambda lam, phi: 2.0 * np.cos(phi))
    return m


def test_full_capability_on_panels():
    """tests/test_parallel.py:409 over 6 panel shards."""
    jm, serial, sharded = _triple(_full, 2, 300.0)
    _check(jm, serial, sharded, ("u", "v", "b", "e", "eta"), 5e-10)


A_SW, G_SW, U_SW, H_SW = 6.37122e6, 9.80616, 20.0, 8000.0
TC2 = dict(
    h=lambda lam, phi: H_SW - (A_SW * OMEGA * U_SW + 0.5 * U_SW ** 2)
    * np.sin(phi) ** 2 / G_SW + 10.0 * np.cos(3 * lam) * np.cos(phi),
    u_east=lambda lam, phi: U_SW * np.cos(phi) + 2.0 * np.sin(2 * lam),
    v_north=lambda lam, phi: 3.0 * np.cos(lam) * np.cos(phi))


def _sw(J, batch):
    if J:
        m = JSW(JGrid((8, 8), radius=A_SW, dtype=jnp.float64),
                gravity=G_SW, rotation_rate=OMEGA)
    else:
        m = ot.CubedSphereShallowWaterModel(
            ot.ConformalCubedSphereGrid((8, 8), radius=A_SW, dtype=F64,
                                        device="cpu"),
            gravity=G_SW, rotation_rate=OMEGA, batch_panels=batch)
    m.set_geographic(**TC2)
    return m


def test_shallow_water_on_panels():
    """Williamson 2 with a perturbation, 3 steps: the per-panel mode and
    the models over 6, 3 and 2 panel shards bit for bit with the
    concatenated mode, and against JAX at 1e-12 of each field's scale;
    the mass conserved."""
    dt = 0.3 * (2 * np.pi * A_SW / 32 * 0.6) / np.sqrt(G_SW * H_SW)
    jm, serial, sharded = _triple(_sw, 3, dt, shards=(6, 3, 2))
    batched = _sw(False, True)
    for _ in range(3):
        batched.time_step(dt)
    names = ("h", "u", "v")
    want = _interiors(batched, names)
    got = _interiors(serial, names)
    assert all(np.array_equal(got[n], want[n]) for n in names)
    scale = {n: np.abs(want[n]).max() for n in names}
    _check(jm, serial, sharded, names, min(scale.values()) * 1e-12)
    m0 = _sw(False, True).total_mass()
    assert abs(sharded[0].total_mass() - m0) <= 1e-12 * m0


def test_no_six_panels_in_the_step(monkeypatch):
    """Inside a sharded step no global view is gathered and the global
    exchange (which takes the six panels) is never called; each shard
    holds its own panels, and the exchanges count the strips sent, far
    fewer bytes than the panels."""
    calls = []
    for cls, name in ((tpar.Distributed, "gather"),
                      (PanelExchange, "centers"), (PanelExchange, "_pair")):
        orig = getattr(cls, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(cls, name, spy)
    for build in (_jet, _sw):
        m = build(False, True)
        m.state = panel_mesh(3).shard(m.state)
        calls.clear()
        m.time_step(100.0)
        m.time_step(100.0)
        assert calls == []
        total = 0
        for s in m._shards:
            for a in s._state["fields"].values():
                assert a.shape[0] == 2
            assert isinstance(s.exchange, ShardPanelExchange)
            assert s.exchange.calls > 0 and s.exchange.bytes > 0
            total += s.exchange.bytes / s.exchange.calls
        per_call = sum(a.numel() * a.element_size()
                       for a in m.state["fields"].values())
        assert total < per_call


@pytest.mark.parametrize("n", [4, 5])
def test_panel_count_must_divide_six(n):
    with pytest.raises(ValueError, match=f"a panel mesh of {n} shards"):
        panel_mesh(n)


def test_panel_mesh_refusals():
    """An (x, y) mesh on a cubed sphere and a panel mesh on a rectilinear
    grid raise ValueError; ``CubedSpherePartition`` raises as JAX's."""
    m = _jet(False, True)
    with pytest.raises(ValueError, match="shards over its panels"):
        m.state = ot.Distributed(ot.Partition(2, 2),
                                 devices=["cpu"] * 4).shard(m.state)
    grid = ot.RectilinearGrid(size=(8, 8, 4), extent=(1.0, 1.0, 1.0),
                              dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="panel mesh"):
        ot.NonhydrostaticModel(grid, architecture=panel_mesh(2))
    messages = []
    for mod in (jpar, tpar):
        with pytest.raises(NotImplementedError) as err:
            mod.CubedSpherePartition(6)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_simulation_on_panels():
    """``Simulation`` drives a model on a panel mesh: its NaN check reads
    every shard's panels and combines the flags over the mesh (nothing
    gathered); the run equals the serial model's steps bit for bit."""
    serial = _jet(False, False)
    m = _jet(False, True)
    m.state = panel_mesh(3).shard(m.state)
    sim = ot.Simulation(m, dt=300.0, stop_iteration=2)
    sim.run()
    for _ in range(2):
        serial.time_step(300.0)
    assert m.iteration == 2
    got, want = _interiors(m, ("u", "b")), _interiors(serial, ("u", "b"))
    assert all(np.array_equal(got[n], want[n]) for n in got)
