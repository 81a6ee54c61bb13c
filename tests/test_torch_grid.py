"""The port's RectilinearGrid against the JAX package's.

Coordinates, spacings, areas and volumes are float64 numpy on both sides,
computed by the same formulas, so they agree to 1e-14 (absolute, on
coordinates of order 1-10)."""

import numpy as np
import pytest
import torch

from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu_torch.grids import RectilinearGrid as TGrid

torch.set_num_threads(1)

TOL = 1e-14

CONFIGS = [
    dict(size=(8, 6, 4), extent=(1.0, 2.0, 3.0)),
    dict(size=(16, 16, 128), extent=(1.0, 1.0, 1.0), halo=(4, 8, 0)),
    dict(size=(5, 7, 9), x=(-1.0, 2.0), y=(0.5, 4.0), z=(-10.0, -2.0),
         halo=(4, 4, 2)),
    dict(size=(6, 4), extent=(2.0, 1.5),
         topology=("periodic", "flat", "bounded")),
]
LOCS = [("c", "c", "c"), ("f", "c", "c"), ("c", "f", "c"), ("c", "c", "f"),
        ("f", "f", "c")]


def _close(a, b):
    return np.max(np.abs(np.asarray(a, np.float64)
                         - np.asarray(b, np.float64))) <= TOL


@pytest.mark.parametrize("cfg", CONFIGS)
def test_shapes_and_coordinates(cfg):
    j = JGrid(dtype=np.float64, **cfg)
    t = TGrid(dtype=torch.float64, device="cpu", **cfg)
    assert t.N == j.N and t.H == j.H and t.topology == j.topology
    assert t.padded_shape == j.padded_shape
    assert t.interior_slices == j.interior_slices
    assert _close(t.extent, j.extent)
    for axis in range(3):
        assert t.minimum_spacing(axis) == j.minimum_spacing(axis)
        for loc in ("c", "f"):
            assert _close(t.coord_padded(axis, loc), j.coord_padded(axis, loc))
            assert _close(t.nodes1d(axis, loc), j.nodes1d(axis, loc))


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("loc", LOCS)
def test_metrics(cfg, loc):
    j = JGrid(dtype=np.float64, **cfg)
    t = TGrid(dtype=torch.float64, device="cpu", **cfg)
    for name in ("dx", "dy", "dz", "Ax", "Ay", "Az", "V"):
        assert _close(getattr(t, name)(loc), getattr(j, name)(loc)), name


def test_with_halo_and_device_dtype():
    t = TGrid(size=(8, 8, 16), extent=(1.0, 1.0, 1.0), dtype=torch.float64,
              device="cpu")
    j = JGrid(size=(8, 8, 16), extent=(1.0, 1.0, 1.0), dtype=np.float64)
    t4, j4 = t.with_halo((4, 4, 0)), j.with_halo((4, 4, 0))
    assert t4.padded_shape == j4.padded_shape
    assert _close(t4.coord_padded(0, "f"), j4.coord_padded(0, "f"))
    assert t4.dtype == torch.float64 and t4.device == torch.device("cpu")
    t32 = t4.to(dtype=np.float32)
    assert t32.dtype == torch.float32 and t32.H == (4, 4, 0)


def test_stretched_axis_raises():
    """A stretched z builds, with JAX's coordinates and metrics; the
    nonhydrostatic model takes it with the Fourier-tridiagonal pressure
    solve (since item 11b) and raises, citing ROADMAP item 11c, on a grid
    stretched along x and z, as JAX's model hands it to its
    conjugate-gradient solver."""
    faces = np.linspace(-1.0, 0.0, 9) ** 3
    t = TGrid(size=(4, 4, 8), x=(0.0, 1.0), y=(0.0, 1.0), z=faces,
              dtype=torch.float64, device="cpu")
    j = JGrid(size=(4, 4, 8), x=(0.0, 1.0), y=(0.0, 1.0), z=faces,
              dtype=np.float64)
    assert t.stretched_axes == j.stretched_axes == (2,)
    assert _close(t.coord_padded(2, "f"), j.coord_padded(2, "f"))
    for loc in (("c", "c", "c"), ("c", "c", "f")):
        assert _close(t.dz(loc).numpy(), np.asarray(j.dz(loc)))
        assert _close(t.V(loc).numpy(), np.asarray(j.V(loc)))
    from oceananigans_tpu_torch.models import NonhydrostaticModel
    from oceananigans_tpu_torch.solvers import FourierTridiagonalPoissonSolver
    assert isinstance(NonhydrostaticModel(t).pressure_solver,
                      FourierTridiagonalPoissonSolver)
    spec = dict(size=(8, 4, 8), x=faces + 1.0, y=(0.0, 1.0), z=faces,
                topology=("bounded", "periodic", "bounded"))
    xz = TGrid(dtype=torch.float64, device="cpu", **spec)
    assert xz.stretched_axes == (0, 2)
    # since item 11c: the conjugate-gradient solver of JAX's model, whose
    # solve matches it at 1e-6 (both at their default tolerance)
    import jax.numpy as jnp
    from oceananigans_tpu.models import NonhydrostaticModel as JModel
    b = np.random.default_rng(1).standard_normal((8, 4, 8))
    want = np.asarray(JModel(grid=JGrid(dtype=np.float64, **spec))
                      .pressure_solver.solve(jnp.asarray(b)))
    got = NonhydrostaticModel(xz).pressure_solver.solve(
        torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_default_device_is_cuda():
    from oceananigans_tpu_torch.defaults import defaults
    assert defaults.device == "cuda"


def test_default_device_without_card_raises():
    """A grid built without ``device=`` lives on the card; with no card it
    raises and names ``device="cpu"``, as does moving a model to the card.
    Nothing falls back to the CPU."""
    from oceananigans_tpu_torch.models import NonhydrostaticModel
    if torch.cuda.is_available():
        assert TGrid(size=(4, 4, 8), extent=(1.0, 1.0, 1.0)).device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TGrid(size=(4, 4, 8), extent=(1.0, 1.0, 1.0))
    cpu_grid = TGrid(size=(4, 4, 8), extent=(1.0, 1.0, 1.0), device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        NonhydrostaticModel(cpu_grid, device="cuda")


# -- LatitudeLongitudeGrid ------------------------------------------------------

LATLON = [
    dict(size=(16, 12, 8), longitude=(0, 60), latitude=(15, 75),
         z=(-1800.0, 0.0), halo=(6, 6, 6)),
    dict(size=(24, 10, 4), longitude=(0, 360), latitude=(-60, 60),
         z=(-90.0, 0.0)),
]


@pytest.mark.parametrize("cfg", LATLON, ids=["bounded_x", "periodic_x"])
def test_latlon_metrics(cfg):
    """Topology, coordinates, the exact spherical metrics dx, dy, dz, Ax,
    Ay, Az and V at every location, and the minimum spacings, against the
    JAX LatitudeLongitudeGrid: exact (the same float64 formulas)."""
    from oceananigans_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from oceananigans_tpu_torch.grids import LatitudeLongitudeGrid as TLL
    j = JLL(dtype=np.float64, **cfg)
    t = TLL(dtype=torch.float64, device="cpu", **cfg)
    assert t.topology == j.topology and t.padded_shape == j.padded_shape
    for axis in range(3):
        for loc in "cf":
            np.testing.assert_array_equal(t.coord_padded(axis, loc),
                                          j.coord_padded(axis, loc))
            np.testing.assert_array_equal(t.nodes1d(axis, loc),
                                          j.nodes1d(axis, loc))
        assert t.minimum_spacing(axis) == j.minimum_spacing(axis)
    for loc in LOCS:
        for name in ("dx", "dy", "dz", "Ax", "Ay", "Az", "V"):
            want = np.asarray(getattr(j, name)(loc), np.float64)
            got = getattr(t, name)(loc)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(np.broadcast_to(got, want.shape),
                                          want, err_msg=f"{name}{loc}")
    t4 = t.with_halo((4, 4, 2))
    assert t4.H == (4, 4, 2) and t4.extent == t.extent
    assert t.to(dtype=np.float32).dx(("f", "c", "c")).dtype == torch.float32
