"""The port's NonhydrostaticModel against the JAX package's, as a whole.

Both models start from the same numpy u, v (bench.py's recipe at small N),
run set() with its projection, then 3 RK3 steps of Δt = 1e-3; interiors of
u, v, w and p are compared.

- (16, 16, 128) against the JAX fused path (Pallas kernels in interpret
  mode: the megakernel with the deferred correction, the projection
  kernels), float64 fields and float64 WENO smoothness: bound 5e-10 absolute,
  the bound tests/test_z_compact.py holds the JAX compact and padded paths
  to after 3 steps.
- (8, 8, 16) against the JAX padded path (z halos, a projection at every
  stage): the same bound for u, v, w. The deferred correction leaves the
  stage-1 and stage-2 pressures inside the stored p, so p is compared with
  the port's per-stage projection (fuse_correction=False).
- The default float32 WENO smoothness, at (8, 8, 16): bound 1e-7 relative
  to max|field|. The indicators are rounded to float32 on both sides, so
  float64 roundoff upstream can flip one float32 rounding and move a
  nonlinear weight by a few 2⁻²⁴; over 9 stages that stays below 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.models import NonhydrostaticModel as JModel
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.models import NonhydrostaticModel, state_from_jax

torch.set_num_threads(1)

DT = 1e-3
BOUND = 5e-10


def _initial(N):
    rng = np.random.default_rng(0)
    return 0.1 * rng.standard_normal(N), 0.1 * rng.standard_normal(N)


def _numpy_state(model):
    return dict(fields={n: np.asarray(a)
                        for n, a in model.state["fields"].items()},
                pressure=np.asarray(model.state["pressure"]),
                clock={k: np.asarray(v)
                       for k, v in model.state["clock"].items()})


def _jax_run(N, smoothness, steps=3):
    u0, v0 = _initial(N)
    m = JModel(grid=JGrid(size=N, extent=(1.0, 1.0, 1.0), dtype=np.float64),
               advection=JWENO(5, smoothness_dtype=smoothness))
    m.set(u=u0, v=v0)
    states = []
    for _ in range(steps):
        m.time_step(DT)
        states.append(_numpy_state(m))
    return m, states


def _port(N, smoothness, **kw):
    u0, v0 = _initial(N)
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                              dtype=torch.float64, device="cpu")
    m = NonhydrostaticModel(grid, advection=ot.WENO(
        5, smoothness_dtype=smoothness), **kw)
    m.set(u=u0, v=v0)
    return m


def _interiors(jstate, N):
    """u, v, w, p interiors of a numpy JAX state (halo widths read off the
    shapes)."""
    out = {}
    arrays = dict(jstate["fields"], p=jstate["pressure"])
    for name in ("u", "v", "w", "p"):
        a = arrays[name]
        h = [(a.shape[ax] - N[ax]) // 2 for ax in range(3)]
        out[name] = a[h[0]:h[0] + N[0], h[1]:h[1] + N[1], h[2]:h[2] + N[2]]
    return out


def _errors(jstate, model, names="uvwp"):
    N = model.grid.N
    want = _interiors(jstate, N)
    return {n: np.max(np.abs(model.field(n).data[model.grid.interior_slices]
                             .numpy() - want[n])) for n in names}


@pytest.fixture(scope="module")
def fused_jax():
    m, states = _jax_run((16, 16, 128), jnp.float64)
    assert m._fused_update is not None and m._fuse_correction
    return states


@pytest.fixture(scope="module")
def padded_jax():
    m, states = _jax_run((8, 8, 16), jnp.float64)
    assert m._fused_update is None and m.grid.H[2] > 0
    return states


def test_against_jax_fused_path(fused_jax):
    port = _port((16, 16, 128), torch.float64)
    for _ in range(3):
        port.time_step(DT)
    assert port.iteration == 3
    assert abs(port.time - float(fused_jax[-1]["clock"]["time"])) < 1e-15
    for name, err in _errors(fused_jax[-1], port).items():
        assert err < BOUND, (name, err)


def test_state_from_jax(fused_jax):
    """Start the port from the JAX state after 2 steps; one more step of
    each agrees."""
    port = _port((16, 16, 128), torch.float64)
    state_from_jax(fused_jax[1], port)
    assert port.iteration == 2
    for name, err in _errors(fused_jax[1], port).items():
        assert err == 0.0, name
    port.time_step(DT)
    for name, err in _errors(fused_jax[2], port).items():
        assert err < BOUND, (name, err)


@pytest.mark.parametrize("fuse_correction", [True, False])
def test_against_jax_padded_path(padded_jax, fuse_correction):
    port = _port((8, 8, 16), torch.float64, fuse_correction=fuse_correction)
    for _ in range(3):
        port.time_step(DT)
    names = "uvwp" if not fuse_correction else "uvw"
    for name, err in _errors(padded_jax[-1], port, names).items():
        assert err < BOUND, (name, err)


def test_default_smoothness_against_jax():
    N = (8, 8, 16)
    _, states = _jax_run(N, jnp.float32)
    port = _port(N, torch.float32)
    for _ in range(3):
        port.time_step(DT)
    want = _interiors(states[-1], N)
    for name, err in _errors(states[-1], port, "uvw").items():
        assert err <= 1e-7 * np.max(np.abs(want[name])), (name, err)


def test_halos_and_invariants():
    """After a step every velocity has valid periodic x/y halos, w's bottom
    face is pinned, and the velocity is divergence-free to roundoff."""
    from oceananigans_tpu_torch.kernels import fused_divergence
    port = _port((8, 8, 16), torch.float64)
    port.time_step(DT)
    Hx, Hy, Hz = port.grid.H
    nx, ny, _ = port.grid.N
    assert Hz == 0 and (Hx, Hy) == (4, 4)
    for name in "uvw":
        a = port.state["fields"][name].numpy()
        np.testing.assert_array_equal(a[:Hx], a[nx:nx + Hx])
        np.testing.assert_array_equal(a[Hx + nx:], a[Hx:2 * Hx])
        np.testing.assert_array_equal(a[:, :Hy], a[:, ny:ny + Hy])
        np.testing.assert_array_equal(a[:, Hy + ny:], a[:, Hy:2 * Hy])
    assert np.all(port.state["fields"]["w"].numpy()[..., 0] == 0.0)
    u, v, w = (port.state["fields"][n] for n in "uvw")
    div = fused_divergence(port.grid, u, v, w, 1.0)
    assert div.abs().max().item() < 1e-12


def test_unported_options_raise():
    grid = ot.RectilinearGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                              dtype=torch.float64, device="cpu")
    # biogeochemistry and auxiliary fields, refused before item 15, are
    # taken (tests/test_torch_long_tail.py holds them against JAX)
    from oceananigans_tpu_torch.biogeochemistry import SimpleBiogeochemistry
    m = NonhydrostaticModel(grid, advection=ot.WENO(5),
                            biogeochemistry=SimpleBiogeochemistry(("P",)))
    assert m.tracer_names == ("P",)
    a = ot.CenterField(grid)
    assert NonhydrostaticModel(grid, auxiliary_fields={"a": a}).field(
        "a") is a
    # a grid stretched along two axes takes JAX's conjugate-gradient
    # solver, the port's since item 11c: the same solution at 1e-6 (both
    # at their default tolerance)
    faces = np.cumsum(np.r_[0.0, 1.0 + 0.3 * np.sin(np.arange(8))])
    spec = dict(size=(8, 8, 8), x=tuple(faces), y=(0.0, 1.0),
                z=tuple(faces - faces[-1]),
                topology=("bounded", "periodic", "bounded"))
    stretched = ot.RectilinearGrid(dtype=torch.float64, device="cpu", **spec)
    b = np.random.default_rng(2).standard_normal((8, 8, 8))
    want = np.asarray(JModel(grid=JGrid(dtype=np.float64, **spec))
                      .pressure_solver.solve(jnp.asarray(b)))
    got = NonhydrostaticModel(stretched).pressure_solver.solve(
        torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
