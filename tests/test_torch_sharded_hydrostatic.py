"""The port's models on bounded sharded axes and the hydrostatic model on
resident shard blocks, on a CPU 2×2 mesh (``devices=["cpu"] * 4``: one
thread per shard, the blocks take the plain versions), against the JAX
package's serial models (the JAX model under GSPMD is its serial model
partitioned) and the port's serial models. Float64 fields from numpy seeds.

Bounds: against JAX, the absolute ones of ``tests/test_parallel.py``
(1e-11 on the fields); against the port's serial model, bit for bit where
no reduction crosses the shards (the split-explicit and explicit free
surfaces, the plain tendencies: every block cell sees the serial grid's
operands and metrics) and 1e-14 of max|·| where the pencil transforms
(the implicit free surface, the NH pressure) round apart from the serial
transforms. The cases:

- ``tests/test_parallel.py:220`` (a rectilinear WENO-VI split-explicit
  step with ``FPlane``), :269 (a lat-lon grid with a bounded y), :361 (the
  tripolar fold across the top row of shards) and :472 (z*, with its
  ``eta_grid``, ``G_sigma`` and ``dt_sigma`` blocks and a constant tracer
  held uniform), each through JAX's call shape ``m.state =
  arch.shard(m.state)``;
- the implicit free surface (its FFT/DCT solve through the pencil over x
  and y, its conjugate gradients with the dot products summed over the
  mesh) and the hydrostatic row's bounded x and y;
- the NH model with a bounded y (the pencil's DCT along y) and the
  shallow-water model with a bounded y (the plain tendency per shard);
- a ``FluxFormAdvection`` that ``adapt_advection_order`` builds on a thin
  z (WENO(5) with a WENO(3) z, and its bounds-preserving variant);
- the step holds no global-view tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.advection.vector_invariant import \
    WENOVectorInvariant as JWVI
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoyancy
from oceananigans_tpu.coriolis import FPlane as JFPlane
from oceananigans_tpu.coriolis import HydrostaticSphericalCoriolis as JHSC
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.grids.tripolar import TripolarGrid as JTripolar
from oceananigans_tpu.models import NonhydrostaticModel as JNHModel
from oceananigans_tpu.models.free_surfaces import (
    ImplicitFreeSurface as JImplicit, SplitExplicitFreeSurface as JSplit)
from oceananigans_tpu.models.hydrostatic import \
    HydrostaticFreeSurfaceModel as JModel
from oceananigans_tpu.models.shallow_water import ShallowWaterModel as JSWModel
import oceananigans_tpu_torch as ot
from tests.test_torch_parallel import _cpu_mesh

torch.set_num_threads(1)

F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
N = (16, 16, 4)


def _jax_interior(m, name):
    return np.asarray(m.field(name).interior)


def _port_interior(m, name):
    return m.field(name).interior.numpy()


def _check(jm, serial, sharded, names, atol=1e-11, exact=True):
    """The sharded model against JAX's serial model (``atol``) and the
    port's serial model (bit for bit, or 1e-14 of max|·|)."""
    for name in names:
        got = _port_interior(sharded, name)
        want = _port_interior(serial, name)
        if exact:
            assert np.array_equal(got, want), name
        else:
            assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max(), \
                name
        ref = _jax_interior(jm, name)
        assert np.abs(got - ref).max() < atol, (name,
                                                np.abs(got - ref).max())


def _hydro_triple(build, steps, dt):
    """(JAX serial, port serial, port sharded) after ``steps`` steps of
    ``dt``: ``build(J)`` builds and sets one model (J: the JAX side); the
    sharded model takes JAX's call shape."""
    jm, serial, sharded = build(True), build(False), build(False)
    arch = _cpu_mesh()
    sharded.state = arch.shard(sharded.state)
    assert sharded._shards is not None and sharded.architecture is arch
    for _ in range(steps):
        for m in (jm, serial, sharded):
            m.time_step(dt)
    return jm, serial, sharded


def _rect(J, topology=("periodic", "periodic", "bounded")):
    kw = dict(dtype=np.float64) if J else CPU
    return (JGrid if J else ot.RectilinearGrid)(
        size=N, x=(0, 1e5), y=(0, 1e5), z=(-100.0, 0.0), topology=topology,
        **kw)


def _vi(J):
    return (JWVI(order=5, smoothness_dtype=jnp.float64) if J else
            ot.WENOVectorInvariant(order=5, smoothness_dtype=F64))


def _rect_model(J, zstar=False, free_surface=None,
                topology=("periodic", "periodic", "bounded")):
    """tests/test_parallel.py:220 (and :472 with ``zstar``)."""
    fs = free_surface(J) if free_surface else (
        JSplit if J else ot.SplitExplicitFreeSurface)(substeps=8)
    m = (JModel if J else ot.HydrostaticFreeSurfaceModel)(
        _rect(J, topology), momentum_advection=_vi(J),
        coriolis=(JFPlane if J else ot.FPlane)(f=1e-4),
        tracers=("T", "constant") if zstar else ("T",), free_surface=fs,
        vertical_coordinate="zstar" if zstar else "z")
    rng = np.random.default_rng(3)
    sin = jnp.sin if J else np.sin
    extra = dict(constant=1.0) if zstar else {}
    m.set(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N),
          T=lambda x, y, z: 10 + 1e-3 * z,
          eta=lambda x, y, z: (0.5 if zstar else 0.01)
          * sin(2 * np.pi * x / 1e5), **extra)
    return m


def test_sharded_rectilinear_hydrostatic():
    """tests/test_parallel.py:220: WENO-VI, FPlane, split-explicit with 8
    substeps, 2 steps of 50 s."""
    jm, serial, sharded = _hydro_triple(_rect_model, 2, 50.0)
    _check(jm, serial, sharded, ("u", "v", "T", "eta"))


def test_hydrostatic_architecture_argument():
    """The port's hydrostatic model also takes ``architecture=`` (JAX's
    takes none: ROADMAP.md queue 3): built on the mesh, set() evaluates the
    values on the global grid and fills each shard's blocks, and 2 steps
    equal the serial model's bit for bit."""
    def model(arch):
        m = ot.HydrostaticFreeSurfaceModel(
            _rect(False, ("bounded", "periodic", "bounded")),
            momentum_advection=_vi(False), coriolis=ot.FPlane(f=1e-4),
            tracers=("T",), free_surface=ot.SplitExplicitFreeSurface(
                substeps=8), architecture=arch)
        rng = np.random.default_rng(6)
        m.set(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N),
              T=lambda x, y, z: 10 + 1e-3 * z,
              eta=lambda x, y, z: 0.01 * np.cos(2 * np.pi * y / 1e5))
        return m

    serial, sharded = model(None), model(_cpu_mesh())
    assert sharded._shards is not None and sharded._state is None
    for _ in range(2):
        serial.time_step(50.0)
        sharded.time_step(50.0)
    assert sharded.iteration == 2
    for name in ("u", "v", "T", "eta", "w"):
        assert np.array_equal(_port_interior(sharded, name),
                              _port_interior(serial, name)), name


def _latlon_model(J, longitude=(0, 360), latitude=(20, 52)):
    kw = dict(dtype=np.float64) if J else CPU
    g = (jo if J else ot).LatitudeLongitudeGrid(
        size=N, longitude=longitude, latitude=latitude, z=(-200.0, 0.0),
        **kw)
    m = (JModel if J else ot.HydrostaticFreeSurfaceModel)(
        g, momentum_advection=_vi(J),
        coriolis=(JHSC if J else ot.HydrostaticSphericalCoriolis)(),
        tracers=("T",),
        free_surface=(JSplit if J else ot.SplitExplicitFreeSurface)(
            substeps=8))
    rng = np.random.default_rng(7)
    sin = jnp.sin if J else np.sin
    m.set(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N),
          T=lambda lam, phi, z: 10 + 1e-3 * z + 1e-2 * phi,
          eta=lambda lam, phi, z: 0.05 * sin(np.deg2rad(lam)))
    return m


@pytest.mark.parametrize("case", ["periodic_x", "bounded_xy"])
def test_sharded_latlon_hydrostatic(case):
    """tests/test_parallel.py:269 (a periodic longitude, a bounded
    latitude) and the hydrostatic row's bounded longitude (0, 60) and
    latitude (15, 75): each shard's metrics cut from the global tables, the
    walls on the edge shards' outer sides only, the cascades counted from
    the global walls; 2 steps of 50 s."""
    kw = ({} if case == "periodic_x" else
          dict(longitude=(0, 60), latitude=(15, 75)))
    jm, serial, sharded = _hydro_triple(
        lambda J: _latlon_model(J, **kw), 2, 50.0)
    _check(jm, serial, sharded, ("u", "v", "T", "eta"))
    if case == "bounded_xy":
        conn = [m.grid.connected[:2] for m in sharded._shards]
        assert conn == [((False, True), (False, True)),
                        ((False, True), (True, False)),
                        ((True, False), (False, True)),
                        ((True, False), (True, False))]


def _tripolar_model(J):
    """tests/test_parallel.py:361; η from the true centre longitudes."""
    tkw = dict(size=(32, 16, 4), z=(-1000.0, 0.0))
    g = JTripolar(**tkw) if J else ot.TripolarGrid(**tkw, **CPU)
    m = (JModel if J else ot.HydrostaticFreeSurfaceModel)(
        g, free_surface=(JSplit if J else ot.SplitExplicitFreeSurface)(
            substeps=8),
        buoyancy=(JBuoyancy if J else ot.BuoyancyTracer)(), tracers=("b",))
    rng = np.random.default_rng(7)
    lam, _ = ot.TripolarGrid(**tkw, **CPU).nodes2d(("c", "c"))
    eta = 0.01 * np.sin(np.deg2rad(lam))[:, :, None]
    m.set(b=lambda lam, phi, z: 1e-6 * z,
          u=0.05 * rng.standard_normal(tkw["size"]),
          v=0.05 * rng.standard_normal(tkw["size"]),
          eta=jnp.asarray(eta) if J else eta)
    return m


def test_sharded_tripolar_hydrostatic():
    """tests/test_parallel.py:361: the north fold crosses the shards (the
    top row's halo rows read the folded columns of their partners, the
    eastern half of the last row of a field centred in y its folded
    western half), 2 steps of 120 s; the same fold on a 4×2 mesh, and the
    model without the fold's exchange differs."""
    jm, serial, sharded = _hydro_triple(_tripolar_model, 2, 120.0)
    _check(jm, serial, sharded, ("u", "v", "b", "eta"))
    wide = _tripolar_model(False)
    wide.state = ot.Distributed(ot.Partition(4, 2),
                                devices=["cpu"] * 8).shard(wide.state)
    for _ in range(2):
        wide.time_step(120.0)
    for name in ("u", "v", "b", "eta"):
        assert np.array_equal(_port_interior(wide, name),
                              _port_interior(serial, name)), name


def test_sharded_zstar_hydrostatic():
    """tests/test_parallel.py:472: z* on 2×2, 3 steps of 50 s; the grid's
    η, G_sigma and dt_sigma live in the shards' blocks and gather to the
    serial model's, and the constant tracer stays uniform to 1e-12."""
    jm, serial, sharded = _hydro_triple(
        lambda J: _rect_model(J, zstar=True), 3, 50.0)
    _check(jm, serial, sharded, ("u", "v", "T", "constant", "eta"))
    for key in ("eta_grid", "G_sigma", "dt_sigma"):
        assert key in sharded._shards[0]._state
        a, b = sharded.state[key], serial.state[key]
        ints = serial.grid.interior_slices[:2]
        assert torch.equal(a[ints], b[ints]), key
    c = _port_interior(sharded, "constant")
    assert np.abs(c - 1.0).max() <= 1e-12


IMPLICIT = {
    "fft": lambda J: (JImplicit if J else ot.ImplicitFreeSurface)(),
    "pcg": lambda J: (JImplicit if J else ot.ImplicitFreeSurface)(
        solver_method="PreconditionedConjugateGradient"),
}


@pytest.mark.parametrize("solver", sorted(IMPLICIT))
def test_sharded_implicit_free_surface(solver):
    """The implicit free surface on 2×2 with a bounded y: the FFT/DCT solve
    through the pencil over x and y (nz = 1, its own spectral divide), and
    the preconditioned conjugate gradients with the dot products summed
    over the mesh and the pencil as preconditioner; 2 steps of 50 s."""
    topo = ("periodic", "bounded", "bounded")
    jm, serial, sharded = _hydro_triple(
        lambda J: _rect_model(J, free_surface=IMPLICIT[solver],
                              topology=topo), 2, 50.0)
    sh = sharded._shards[0]
    assert sh.grid.shard.pencil is not None and sh.grid.shard.pencil.N == (
        N[0], N[1], 1)
    _check(jm, serial, sharded, ("u", "v", "T", "eta"), exact=False)


def test_sharded_nh_bounded_y():
    """The NH model on ("periodic", "bounded", "bounded") at 16×16×8 on
    2×2: the plain tendency per shard (JAX's ``eligible`` takes #6 only on
    periodic x and y), the walls on the edge shards, and the pencil with a
    DCT along y where y is whole; against JAX's serial model (1e-11) and
    the port's serial model (1e-14 of max|·|), 2 steps."""
    n = (16, 16, 8)
    topo = ("periodic", "bounded", "bounded")
    rng = np.random.default_rng(1)
    init = dict(u=0.1 * rng.standard_normal(n),
                v=0.1 * rng.standard_normal(n),
                b=0.01 * rng.standard_normal(n))
    jm = JNHModel(grid=JGrid(size=n, extent=(1, 1, 1), topology=topo,
                             dtype=np.float64),
                  advection=JWENO(5, smoothness_dtype=jnp.float64),
                  buoyancy=JBuoyancy(), tracers=("b",),
                  fused_advection=False)

    def port(arch):
        return ot.NonhydrostaticModel(
            ot.RectilinearGrid(size=n, extent=(1, 1, 1), topology=topo,
                               **CPU),
            advection=ot.WENO(5, smoothness_dtype=F64),
            buoyancy=ot.BuoyancyTracer(), tracers=("b",), architecture=arch)

    serial, sharded = port(None), port(_cpu_mesh())
    jm.set(**init)
    serial.set(**init)
    sharded.state = serial.state
    assert sharded.pressure_solver.xy_kind == ("fft", "dct")
    assert not sharded._shards[0]._kernel_tendency
    for _ in range(2):
        for m in (jm, serial, sharded):
            m.time_step(1e-3)
    _check(jm, serial, sharded, ("u", "v", "w", "b"), exact=False)


def test_sharded_shallow_water_bounded_y():
    """The shallow-water model with a bounded y at 32² on 2×2 (the plain
    tendency per shard: #9 refuses a bounded y, as JAX's ``sw_eligible``
    does), 3 steps: the port's serial model bit for bit, JAX's to 1e-11."""
    n = (32, 32)
    topo = ("periodic", "bounded", "flat")
    rng = np.random.default_rng(2)
    uh = 0.01 * rng.standard_normal(n + (1,))

    def h(x, y, z):
        return 1 + 0.1 * np.exp(-((x - 5) ** 2 + (y - 5) ** 2))

    jm = JSWModel(JGrid(size=n, extent=(10.0, 10.0), topology=topo,
                        dtype=np.float64),
                  advection=JWENO(5, smoothness_dtype=jnp.float64),
                  coriolis=JFPlane(f=1.0))

    def port(arch):
        return ot.ShallowWaterModel(
            ot.RectilinearGrid(size=n, extent=(10.0, 10.0), topology=topo,
                               **CPU),
            advection=ot.WENO(5, smoothness_dtype=F64),
            coriolis=ot.FPlane(f=1.0), architecture=arch)

    serial, sharded = port(None), port(_cpu_mesh())
    jm.set(h=lambda x, y, z: 1 + 0.1 * jnp.exp(-((x - 5) ** 2
                                                + (y - 5) ** 2)), uh=uh)
    serial.set(h=h, uh=uh)
    sharded.state = serial.state
    assert not any(s.fused for s in sharded._shards)
    for _ in range(3):
        for m in (jm, serial, sharded):
            m.time_step(0.01)
    _check(jm, serial, sharded, ("uh", "vh", "h"))


@pytest.mark.parametrize("bounded", [False, True])
def test_per_axis_scheme_on_a_thin_axis(bounded):
    """``adapt_advection_order`` on a thin axis under WENO(5) builds a
    ``FluxFormAdvection``: a 2-level z (the z-compact layout) gives
    ``(WENO(5), WENO(5), WENO(3))``; with ``bounds`` (the padded layout,
    whose z halo needs Nz > Hz) a 2-cell bounded x gives the
    bounds-preserving ``(WENO(3), WENO(5), WENO(5))``. The port's NH model
    against JAX's, 3 steps, 1e-11."""
    if bounded:
        n, topo, orders = (2, 16, 8), ("bounded", "periodic", "bounded"), \
            [3, 5, 5]
        bkw = dict(bounds=(0.0, 1.0))
    else:
        n, topo, orders = (16, 16, 2), ("periodic", "periodic", "bounded"), \
            [5, 5, 3]
        bkw = {}
    rng = np.random.default_rng(4)
    init = dict(u=0.1 * rng.standard_normal(n),
                v=0.1 * rng.standard_normal(n),
                c=rng.uniform(0.0, 1.0, n))
    jm = JNHModel(grid=JGrid(size=n, extent=(1, 1, 0.1), topology=topo,
                             dtype=np.float64),
                  advection=JWENO(5, smoothness_dtype=jnp.float64, **bkw),
                  tracers=("c",), fused_advection=False)
    tm = ot.NonhydrostaticModel(
        ot.RectilinearGrid(size=n, extent=(1, 1, 0.1), topology=topo, **CPU),
        advection=ot.WENO(5, smoothness_dtype=F64, **bkw), tracers=("c",))
    assert [s.order for s in tm.advection.schemes] == orders
    assert tm.advection.bounds == bkw.get("bounds")
    assert tm._z_compact == (not bounded)
    for m in (jm, tm):
        m.set(**init)
    for _ in range(3):
        jm.time_step(1e-3)
        tm.time_step(1e-3)
    for name in ("u", "v", "c"):
        ref = _jax_interior(jm, name)
        got = _port_interior(tm, name)
        assert np.abs(got - ref).max() < 1e-11, name


def test_no_global_view_in_the_sharded_hydrostatic_step(monkeypatch):
    """No tensor of the global padded extent is made while the sharded
    hydrostatic row (bounded x and y, split-explicit) steps, in any shard's
    thread, and ``Distributed.gather`` is never called: the shards meet
    only in the exchange. Each block stays on its shard's device."""
    m = _latlon_model(False, longitude=(0, 60), latitude=(15, 75))
    m.state = _cpu_mesh().shard(m.state)
    global_xy = tuple(m.grid.padded_shape[:2])
    made, gathers = [], []

    class Watch(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and out.ndim >= 2 and \
                    tuple(out.shape[:2]) == global_xy:
                made.append(func)
            return out

    for shard in m._shards:
        step = shard.time_step

        def watched(dt, _step=step):
            with Watch():
                return _step(dt)

        shard.time_step = watched
    gather = type(m.architecture).gather
    monkeypatch.setattr(type(m.architecture), "gather",
                        lambda self, *a, **k: gathers.append(1)
                        or gather(self, *a, **k))
    m.time_step(50.0)
    m.time_step(50.0)
    assert made == [] and gathers == []
    for s, sh in zip(m._shards, m.architecture.shards(m.grid)):
        for a in s._state["fields"].values():
            assert a.device == sh.device
            assert tuple(a.shape[:2]) == tuple(s.grid.padded_shape[:2])


def test_fold_kernel_refuses_an_odd_nx_for_an_x_face_field():
    """An x-face field centred in y folded over an odd Nx would swap two
    columns of its last row (the serial fill's plan refuses it): the fold
    kernel's wrapper raises before it builds anything; a y-face field of
    the same width is not refused by that rule."""
    from oceananigans_tpu_torch.parallel import halo_exchange as he
    top = [[torch.zeros(5 + 4, 4 + 4, 2, dtype=torch.float64)]
           for _ in range(3)]
    with pytest.raises(ValueError, match="even Nx"):
        he.mesh_fold_exchange(top, (2, 2), (5, 4), [(-1.0, True, False)])
    b = [[x.clone() for x in t] for t in top]
    he.fold_plain(b, (2, 2), (5, 4), [(-1.0, False, True)])


def test_every_shard_fills_its_walls():
    """On a 2x2 mesh over a grid with bounded x and y, every shard's fill
    of 3-D fields and of 2-D surfaces writes its walls: the corner shard
    keeps both low sides and fills both high ones, and its plan is not
    empty (``fills_nothing``); the codes are KEEP exactly on the connected
    sides."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    m = _latlon_model(False, longitude=(0, 60), latitude=(15, 75))
    for sh in _cpu_mesh().shards(m.grid):
        g = sh.grid
        for shape in (g.padded_shape, g.padded_shape[:2] + (1,)):
            lbs = [(m.loc(n), m.bcs[n]) for n in ("u", "v", "T")]
            codes = hf.fill_codes(g, shape, lbs, z=shape[2] != 1)
            assert not hf.fills_nothing(codes), (sh.index, shape)
            for fc in codes:
                for ax in (0, 1):
                    for side, conn in enumerate(g.connected[ax]):
                        assert (fc[ax][2 * side] == hf.KEEP) == conn


class _Series:
    """A series of one (Nx, Ny) snapshot, constant in time: what a
    FieldTimeSeries boundary condition reads (``times``, the snapshots by
    index, ``at_time``; JAX's ``traced``)."""

    times = np.array([0.0])

    def __init__(self, plane):
        self.plane = plane

    def __getitem__(self, i):
        return self.plane

    def at_time(self, time):
        return self.plane

    traced = at_time


@pytest.mark.parametrize("entry", ["shard", "architecture"])
@pytest.mark.parametrize("value", ["time_series", "array"])
def test_hydrostatic_mesh_refuses_global_boundary_planes(value, entry):
    """A FieldTimeSeries or array top flux holds the global grid's plane:
    on a mesh (through either entry) each shard takes the plane cut at its
    offset (a time series at each snapshot it serves), and 3 steps equal
    the serial model's bit for bit and JAX's to 1e-11."""
    plane = 1e-5 * np.random.default_rng(4).standard_normal(N[:2])

    def bc(J):
        if value == "array":
            return (jo.FluxBoundaryCondition if J else
                    ot.FluxBoundaryCondition)(plane)
        p = jnp.asarray(plane) if J else torch.as_tensor(plane, **CPU)
        return (jo.FieldTimeSeriesBoundaryCondition if J else
                ot.FieldTimeSeriesBoundaryCondition)(_Series(p))

    def model(J, arch=None):
        kw = {} if J else dict(architecture=arch)
        m = (JModel if J else ot.HydrostaticFreeSurfaceModel)(
            _rect(J), momentum_advection=_vi(J), tracers=("T",),
            coriolis=(JFPlane if J else ot.FPlane)(f=1e-4),
            free_surface=(JSplit if J else ot.SplitExplicitFreeSurface)(
                substeps=8),
            boundary_conditions={"T": (jo if J else ot).FieldBoundaryConditions(
                top=bc(J))}, **kw)
        m.set(T=lambda x, y, z: 10 + 1e-3 * z,
              u=0.1 * np.random.default_rng(5).standard_normal(N))
        return m

    jm, serial = model(True), model(False)
    if entry == "shard":
        sharded = model(False)
        sharded.state = _cpu_mesh().shard(sharded.state)
    else:
        sharded = model(False, _cpu_mesh())
        sharded.state = serial.state
    assert sharded._shards is not None
    for _ in range(3):
        for m in (jm, serial, sharded):
            m.time_step(50.0)
    _check(jm, serial, sharded, ("u", "v", "T", "eta"))


@pytest.mark.parametrize("kind", ["nh", "sw"])
def test_sharded_state_puts_a_model_on_the_mesh(kind):
    """JAX's call shape on a NH or shallow-water model built without an
    architecture: ``m.state = arch.shard(m.state)`` puts the model on the
    state's mesh (one model a shard), as it does the hydrostatic model, and
    2 steps equal the serial model's (the NH pressure through the pencil:
    1e-14 of max|·|; the shallow-water step bit for bit)."""
    rng = np.random.default_rng(7)
    if kind == "nh":
        n = (16, 16, 8)
        init = dict(u=0.1 * rng.standard_normal(n),
                    v=0.1 * rng.standard_normal(n),
                    b=0.01 * rng.standard_normal(n))
        names, dt = ("u", "v", "w", "b"), 1e-3

        def build():
            return ot.NonhydrostaticModel(
                ot.RectilinearGrid(size=n, extent=(1, 1, 1), **CPU),
                advection=ot.WENO(5, smoothness_dtype=F64),
                buoyancy=ot.BuoyancyTracer(), tracers=("b",))
    else:
        n = (32, 32)
        init = dict(h=1 + 0.01 * rng.standard_normal(n),
                    uh=0.01 * rng.standard_normal(n))
        names, dt = ("uh", "vh", "h"), 0.01

        def build():
            return ot.ShallowWaterModel(
                ot.RectilinearGrid(size=n, extent=(10.0, 10.0),
                                   topology=("periodic", "periodic", "flat"),
                                   **CPU),
                advection=ot.WENO(5, smoothness_dtype=F64),
                coriolis=ot.FPlane(f=1.0))
    serial, sharded = build(), build()
    for m in (serial, sharded):
        m.set(**init)
    arch = _cpu_mesh()
    sharded.state = arch.shard(sharded.state)
    assert sharded.architecture is arch and len(sharded._shards) == 4
    for _ in range(2):
        serial.time_step(dt)
        sharded.time_step(dt)
    assert sharded.iteration == 2
    for name in names:
        got, want = _port_interior(sharded, name), _port_interior(serial,
                                                                   name)
        if kind == "nh":
            assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max(), \
                name
        else:
            assert np.array_equal(got, want), name
    with pytest.raises(ValueError, match="sharded over"):
        sharded.state = _cpu_mesh(4, 1).shard(serial.state)
