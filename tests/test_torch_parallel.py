"""The port's device meshes and sharded stages against the JAX package's, on
the CPU.

The JAX side runs on the virtual CPU devices of ``tests/conftest.py``; its
sharded stages run their Pallas kernels in interpret mode. The port's meshes
name the CPU four times (``devices=["cpu"] * 4``), so its blocks take the
plain versions: ``halo_exchange_plain`` and the per-shard plain stages.
Float64 fields from numpy seeds. Bounds, relative to max|reference|:

- the halo exchange copies: exact, against ``make_halo_exchange`` and the
  periodic wrap of the global field;
- the sharded shallow-water model (32² on 2×2, WENO(5) with float64
  smoothness, FPlane, an array bathymetry, a tracer) against the JAX sharded
  model: 1e-12 after 1 and 3 steps. The JAX shards re-derive their spacing
  as extent·nlx/Nx and the two sides associate a few sums differently,
  which is roundoff;
- the sharded shallow-water step without bathymetry equals the port's
  serial step exactly (the shards take the global spacing; every cell sees
  the operands of the serial step);
- with the array bathymetry the sharded step differs from the serial one
  near the global edges, where the bathymetry's blocks read exchanged
  (periodic) halos and the serial model reads the zero halos of
  ``set_on_padded``: the port's pair differs as the JAX pair does, within
  1e-12 of max|uh|, about 2.9e-3 in uh after one step (ROADMAP.md queue 3);
- the sharded convection model (16×16×8 on 2×2, Rayleigh–Bénard physics)
  against the JAX sharded model: 1e-10 after 3 steps, and the port's serial
  step within 1e-12. The shards hold resident blocks and solve for the
  pressure with the pencil solver, which transforms y and x in complex form
  where the serial solver takes a real FFT along x: the two agree to
  rounding, no longer bit for bit;
- the sharded buoyant z-compact model (16×16×128 on 2×2, WENO(5),
  BuoyancyTracer, no closure) against the JAX sharded model: 1e-10 after 3
  steps, and the port's serial step within 1e-12 (the pencil, as above);
- the models on resident blocks against the JAX sharded models: in
  ``tests/test_torch_resident.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFBC, ValueBoundaryCondition as JValue)
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoyancyTracer
from oceananigans_tpu.closures import ScalarDiffusivity as JScalarDiffusivity
from oceananigans_tpu.coriolis import FPlane as JFPlane
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.models import NonhydrostaticModel as JNHModel
from oceananigans_tpu.models.shallow_water import ShallowWaterModel as JSWModel
import oceananigans_tpu.parallel as jpar
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.parallel as tpar
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.models import state_from_jax

torch.set_num_threads(1)


def _cpu_mesh(x=2, y=2):
    return ot.Distributed(ot.Partition(x, y), devices=["cpu"] * (x * y))


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# -- Partition and Distributed ---------------------------------------------------

RESOLVE = {
    "fixed": (lambda m: m.Partition(2, 2), 8),
    "equal_x": (lambda m: m.Partition(x=m.Equal(), y=2), 8),
    "equal_y": (lambda m: m.Partition(x=2, y=m.Equal()), 6),
    "equal_x_alone": (lambda m: m.Partition(x=m.Equal()), 4),
    "x_partition": (lambda m: m.XPartition(4), 8),
    "y_partition": (lambda m: m.YPartition(3), 8),
}


@pytest.mark.parametrize("case", sorted(RESOLVE))
def test_partition_resolve_against_jax(case):
    make, n = RESOLVE[case]
    want, got = make(jpar).resolve(n), make(tpar).resolve(n)
    assert (got.x, got.y) == (want.x, want.y)
    assert repr(got) == repr(want)


PARTITION_ERRORS = {
    "two_equal": (lambda m: m.Partition(x=m.Equal(), y=m.Equal()), None),
    "indivisible": (lambda m: m.Partition(x=m.Equal(), y=3), 8),
}


@pytest.mark.parametrize("case", sorted(PARTITION_ERRORS))
def test_partition_errors_against_jax(case):
    make, n = PARTITION_ERRORS[case]
    messages = []
    for mod in (jpar, tpar):
        with pytest.raises(ValueError) as err:
            make(mod).resolve(n)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("kind", ["Fractional", "Sizes",
                                  "CubedSpherePartition"])
def test_raising_kinds_against_jax(kind):
    messages = []
    for mod in (jpar, tpar):
        with pytest.raises(NotImplementedError) as err:
            getattr(mod, kind)(0.5, 0.5)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_default_partition_against_jax(n):
    want = jpar.Distributed(devices=jax.devices()[:n])
    got = tpar.Distributed(devices=["cpu"] * n)
    assert (got.partition.x, got.partition.y) == (want.partition.x,
                                                  want.partition.y)
    assert got.mesh.devices.shape == want.mesh.devices.shape
    assert got.mesh.axis_names == tuple(want.mesh.axis_names) == ("x", "y")
    assert all(d == torch.device("cpu") for d in got.mesh.devices.ravel())


def test_too_few_devices_against_jax():
    messages = []
    for mod, devices in ((jpar, jax.devices()[:3]), (tpar, ["cpu"] * 3)):
        with pytest.raises(ValueError) as err:
            mod.Distributed(mod.Partition(2, 2), devices=devices)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_default_devices_are_the_cards():
    """devices=None names every visible card, and raises with none."""
    if torch.cuda.is_available():
        arch = ot.Distributed()
        assert arch.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no|none"):
            ot.Distributed()


def test_indivisible_interior_raises():
    arch = _cpu_mesh(4, 2)
    grid = ot.RectilinearGrid(size=(30, 32), extent=(1.0, 1.0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        arch.validate_grid(grid)
    with pytest.raises(ValueError, match="not divisible"):
        ot.ShallowWaterModel(grid, advection=ot.WENO(5), architecture=arch)
    # the interior must divide the mesh, not the padded extent (as in JAX)
    grid = ot.RectilinearGrid(size=(32, 32), extent=(1.0, 1.0), halo=(3, 3),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float64, device="cpu")
    _cpu_mesh(2, 4).validate_grid(grid)
    jgrid = JGrid(size=(32, 32), extent=(1.0, 1.0), halo=(3, 3),
                  topology=("periodic", "periodic", "flat"), dtype=np.float64)
    with pytest.raises(ValueError, match="not divisible"):
        jpar.Distributed(jpar.Partition(2, 4)).validate_grid(jgrid)


def test_shard_and_placement():
    arch = _cpu_mesh()
    state = dict(fields={"u": torch.ones(3, device="cpu")},
                 clock=dict(time=np.float64(0.5), iteration=2))
    out = arch.shard(state)
    assert out["fields"]["u"].device == torch.device("cpu")
    assert out["clock"] == state["clock"]
    grid = ot.RectilinearGrid(size=(16, 16), extent=(1.0, 1.0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float64, device="cpu")
    elsewhere = ot.Distributed(ot.Partition(2, 2), devices=["meta"] * 4)
    with pytest.raises(ValueError, match="first device"):
        ot.ShallowWaterModel(grid, advection=ot.WENO(5),
                             architecture=elsewhere)
    for marker in (ot.CPU(), ot.GPU()):
        m = ot.ShallowWaterModel(grid, advection=ot.WENO(5),
                                 architecture=marker)
        assert m.architecture is None and m._shards is None


# -- the halo exchange ----------------------------------------------------------

@pytest.mark.parametrize("shape,halo", [((2, 2), (2, 2, 0)),
                                        ((1, 4), (3, 2, 0))])
def test_halo_exchange_against_jax(shape, halo):
    """The per-shard (8, 8, 4) blocks of a global field, stacked as in
    tests/test_parallel.py: the plain exchange equals JAX's
    ``make_halo_exchange`` at every slot, and every halo slot holds the
    periodic image of the global field (interiors, edges and corners)."""
    Sx, Sy = shape
    nl = (8, 8, 4)
    hx, hy = halo[0], halo[1]
    rng = np.random.default_rng(0)
    glob = rng.normal(size=(Sx * nl[0], Sy * nl[1], nl[2]))
    bx, by = nl[0] + 2 * hx, nl[1] + 2 * hy
    stacked = np.zeros((Sx * bx, Sy * by, nl[2]))
    for i in range(Sx):
        for j in range(Sy):
            stacked[i * bx + hx:i * bx + hx + nl[0],
                    j * by + hy:j * by + hy + nl[1]] = glob[
                i * nl[0]:(i + 1) * nl[0], j * nl[1]:(j + 1) * nl[1]]
    jmesh = JMesh(np.asarray(jax.devices()[:Sx * Sy]).reshape(shape),
                  ("x", "y"))
    want = np.asarray(jpar.make_halo_exchange(jmesh, halo, nl)(
        jnp.asarray(stacked)))
    arch = _cpu_mesh(Sx, Sy)
    got = tpar.make_halo_exchange(arch.mesh, halo, nl)(
        torch.as_tensor(stacked)).numpy()
    assert np.array_equal(got, want)
    wrapped = np.pad(glob, ((hx, hx), (hy, hy), (0, 0)), mode="wrap")
    for i in range(Sx):
        for j in range(Sy):
            blk = got[i * bx:(i + 1) * bx, j * by:(j + 1) * by]
            assert np.array_equal(blk, wrapped[i * nl[0]:i * nl[0] + bx,
                                               j * nl[1]:j * nl[1] + by])


def test_halo_exchange_errors():
    arch = _cpu_mesh()
    blocks = [[torch.zeros(12, 12, 1) for _ in range(2)] for _ in range(2)]
    with pytest.raises(NotImplementedError, match="periodic axes only"):
        tpar.halo_exchange_local(blocks, arch.mesh, (2, 2, 0), (8, 8, 1),
                                 periodic=(True, False))
    narrow = [[torch.zeros(5, 12, 1) for _ in range(2)] for _ in range(2)]
    with pytest.raises(ValueError, match="at least as wide"):
        tpar.halo_exchange_local(narrow, arch.mesh, (2, 2, 0), (1, 8, 1))
    # local routes count no launches; the plain version counts no CUDA calls
    K.reset_counters()
    tpar.halo_exchange_local(blocks, arch.mesh, (2, 2, 0), (8, 8, 1))
    launches, plain = K.counters()
    assert launches["mesh_halo_exchange"] == 0
    assert plain["halo_exchange_plain"] == 0


# -- the sharded shallow-water model --------------------------------------------

SW_N = (32, 32)
SW_DT = 1e-3


def _sw_inputs():
    rng = np.random.default_rng(0)
    hB = 0.05 * rng.standard_normal(SW_N)
    init = dict(h=1.0 + 0.05 * rng.standard_normal(SW_N),
                uh=0.1 * rng.standard_normal(SW_N),
                vh=0.1 * rng.standard_normal(SW_N), c=rng.random(SW_N))
    return hB, init


def _jax_sw(arch, bathymetry):
    _, init = _sw_inputs()
    grid = JGrid(size=SW_N, extent=(10.0, 10.0),
                 topology=("periodic", "periodic", "flat"), dtype=np.float64)
    m = JSWModel(grid=grid, advection=JWENO(5, smoothness_dtype=jnp.float64),
                 coriolis=JFPlane(f=0.3), bathymetry=bathymetry,
                 tracers=("c",), gravitational_acceleration=9.81, fused=True,
                 architecture=arch)
    m.set(**init)
    if arch is not None:
        m.state = arch.shard(m.state)
    return m


def _jax_interiors(m):
    return {n: np.asarray(m.field(n).interior)[..., 0]
            for n in ("uh", "vh", "h", "c")}


@pytest.fixture(scope="module")
def jax_sw_sharded():
    """The JAX sharded model with the array bathymetry: its fields after 1
    and after 3 steps."""
    hB, _ = _sw_inputs()
    arch = jpar.Distributed(jpar.Partition(2, 2))
    m = _jax_sw(arch, hB)
    assert m._fused_update is not None
    m.time_step(SW_DT)
    one = _jax_interiors(m)
    m.time_step(SW_DT)
    m.time_step(SW_DT)
    return one, _jax_interiors(m)


def _port_sw(arch, bathymetry):
    _, init = _sw_inputs()
    grid = ot.RectilinearGrid(size=SW_N, extent=(10.0, 10.0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float64, device="cpu")
    m = ot.ShallowWaterModel(grid, advection=ot.WENO(
        5, smoothness_dtype=torch.float64), coriolis=ot.FPlane(f=0.3),
        bathymetry=bathymetry, tracers=("c",), gravitational_acceleration=9.81,
        architecture=arch)
    m.set(**init)
    return m


def _port_interiors(m):
    return {n: m.field(n).interior[..., 0].numpy()
            for n in ("uh", "vh", "h", "c")}


def test_sharded_shallow_water_against_jax(jax_sw_sharded):
    one, three = jax_sw_sharded
    hB, _ = _sw_inputs()
    port = _port_sw(_cpu_mesh(), hB)
    assert port._shards is not None
    port.time_step(SW_DT)
    got = _port_interiors(port)
    for name in one:
        assert _rel(got[name], one[name]) <= 1e-12, name
    port.time_step(SW_DT)
    port.time_step(SW_DT)
    got = _port_interiors(port)
    for name in three:
        assert _rel(got[name], three[name]) <= 1e-12, name


def test_sharded_shallow_water_equals_serial_without_bathymetry():
    sharded, serial = _port_sw(_cpu_mesh(), 0.0), _port_sw(None, 0.0)
    for _ in range(3):
        sharded.time_step(SW_DT)
        serial.time_step(SW_DT)
    a, b = _port_interiors(sharded), _port_interiors(serial)
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    assert sharded.time == serial.time and sharded.iteration == 3


def test_sharded_bathymetry_differs_from_serial_as_in_jax():
    """The pinned disagreement: with an array bathymetry the sharded step
    reads periodic hB halos and the serial step zero ones. After one step
    the port's pair differs as the JAX pair does, by about 2.9e-3 in uh,
    only near the global edges."""
    hB, _ = _sw_inputs()
    jpair = []
    for arch in (jpar.Distributed(jpar.Partition(2, 2)), None):
        m = _jax_sw(arch, hB)
        m.time_step(SW_DT)
        jpair.append(_jax_interiors(m))
    tpair = []
    for arch in (_cpu_mesh(), None):
        m = _port_sw(arch, hB)
        m.time_step(SW_DT)
        tpair.append(_port_interiors(m))
    for name in ("uh", "vh", "h", "c"):
        jd = jpair[0][name] - jpair[1][name]
        td = tpair[0][name] - tpair[1][name]
        scale = np.max(np.abs(jpair[1][name]))
        assert np.max(np.abs(td - jd)) <= 1e-12 * scale, name
    d = np.abs(tpair[0]["uh"] - tpair[1]["uh"])
    assert 2e-3 < d.max() < 4e-3, d.max()
    # one step of three stages, each reaching four cells, from hB's first
    # interior face: nothing differs farther than 13 cells from an edge
    i, j = np.nonzero(d)
    edge = np.minimum(np.minimum(i, SW_N[0] - 1 - i),
                      np.minimum(j, SW_N[1] - 1 - j))
    assert edge.max() <= 13
    assert d[14:18, 14:18].max() == 0.0


def test_mesh_needs_the_fused_stage():
    """The configurations the fused stage does not take run the plain
    tendencies on every shard under a mesh
    (``test_sharded_plain_shallow_water_against_jax`` holds one against
    JAX); a bounded y still raises, citing ROADMAP item 16b."""
    grid = ot.RectilinearGrid(size=SW_N, extent=(10.0, 10.0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float64, device="cpu")
    for kw in (dict(fused=False), dict(formulation="vector_invariant"),
               dict(coriolis=ot.BetaPlane(f0=0.3, beta=0.1))):
        m = ot.ShallowWaterModel(grid, advection=ot.WENO(5),
                                 architecture=_cpu_mesh(), **kw)
        assert m._shards is not None and not m.fused
        assert all(not s.fused for s in m._shards)
    bounded = ot.RectilinearGrid(size=SW_N, extent=(10.0, 10.0),
                                 topology=("periodic", "bounded", "flat"),
                                 dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16b"):
        ot.ShallowWaterModel(bounded, advection=ot.WENO(5),
                             architecture=_cpu_mesh())


def test_sharded_stage_counts_no_launches_on_the_cpu():
    K.reset_counters()
    m = _port_sw(_cpu_mesh(), 0.0)
    m.time_step(SW_DT)
    launches, plain = K.counters()
    assert not any(launches.values()) and not any(plain.values())


# -- the sharded convection model -------------------------------------------------

NH_N = (16, 16, 8)
NH_DT = 1e-2


def _port_convection(arch):
    grid = ot.RectilinearGrid(size=NH_N, extent=(1.0, 1.0, 1.0),
                              dtype=torch.float64, device="cpu")
    b_bcs = ot.FieldBoundaryConditions(top=ot.ValueBoundaryCondition(-0.5),
                                       bottom=ot.ValueBoundaryCondition(0.5))
    return ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
        buoyancy=ot.BuoyancyTracer(), tracers=("b",),
        closure=ot.ScalarDiffusivity(nu=1e-4, kappa={"b": 1e-4}),
        boundary_conditions={"b": b_bcs}, architecture=arch)


def _numpy_state(m):
    return dict(fields={n: np.asarray(a) for n, a in m.state["fields"].items()},
                pressure=np.asarray(m.state["pressure"]),
                clock={k: np.asarray(v) for k, v in m.state["clock"].items()})


def test_sharded_convection_against_jax():
    arch = jpar.Distributed(jpar.Partition(2, 2))
    jm = JNHModel(grid=JGrid(size=NH_N, extent=(1.0, 1.0, 1.0),
                             dtype=np.float64),
                  advection=JWENO(5, smoothness_dtype=jnp.float64),
                  buoyancy=JBuoyancyTracer(), tracers=("b",),
                  closure=JScalarDiffusivity(nu=1e-4, kappa={"b": 1e-4}),
                  boundary_conditions={"b": JFBC(top=JValue(-0.5),
                                                 bottom=JValue(0.5))},
                  architecture=arch)
    assert jm._fused_advection is not None and not jm._z_compact
    jm.set(b=lambda x, y, z: -z - 0.5, enforce_incompressibility=False)
    rng = np.random.default_rng(0)
    jm.set(u=0.1 * rng.standard_normal(NH_N), v=0.1 * rng.standard_normal(NH_N))
    jm.state = arch.shard(jm.state)
    start = _numpy_state(jm)
    for _ in range(3):
        jm.time_step(NH_DT)
    end = _numpy_state(jm)
    sharded = state_from_jax(start, _port_convection(_cpu_mesh()))
    serial = state_from_jax(start, _port_convection(None))
    assert sharded._sharded_advection is not None
    for _ in range(3):
        sharded.time_step(NH_DT)
        serial.time_step(NH_DT)
    ints = sharded.grid.interior_slices
    for name in ("u", "v", "w", "b"):
        a = end["fields"][name]
        h = [(a.shape[ax] - NH_N[ax]) // 2 for ax in range(3)]
        want = a[h[0]:h[0] + NH_N[0], h[1]:h[1] + NH_N[1],
                 h[2]:h[2] + NH_N[2]]
        got = sharded.state["fields"][name][ints].numpy()
        assert _rel(got, want) <= 1e-10, name
        # the pencil solver transforms y and x in complex form, the serial
        # one takes a real FFT along x first: equal to rounding
        assert _rel(got, serial.state["fields"][name][ints].numpy()) \
            <= 1e-12, name


def test_sharded_advection_equals_serial_kernel():
    """The sharded tendency stage on the resident blocks of a 2x4 mesh
    (scattered once; the stage exchanges their halos and returns each
    shard's tendency) equals the tendency kernel's plain version on the
    global fields."""
    grid = ot.RectilinearGrid(size=(16, 16, 8), extent=(1.0, 2.0, 1.0),
                              halo=(3, 3, 3), dtype=torch.float64,
                              device="cpu")
    rng = np.random.default_rng(4)
    fields = [torch.as_tensor(0.1 * rng.standard_normal(grid.padded_shape))
              for _ in range(4)]
    K.periodic_halo_fill(grid, fields)
    scheme = ot.WENO(5, smoothness_dtype=torch.float64)
    arch = _cpu_mesh(2, 4)
    blocks = arch.scatter(fields, grid.H)
    for b in blocks:       # stale halos: the stage's exchange fills them
        for a in b:
            a[:3] = 0.0
    G = K.build_sharded_fused_advection(grid, scheme, arch.mesh)(blocks)
    assert [tuple(g.shape) for g in G] == [(4, 8, 4, 8)] * 8
    G = torch.cat([torch.cat(G[4 * i:4 * i + 4], dim=2) for i in range(2)],
                  dim=1)
    assert torch.equal(G, K.fused_advection_tendency(grid, scheme, fields))


def test_compact_model_under_a_mesh_raises():
    """A buoyant z-compact model (no closure, no z condition) under a 2x2
    mesh steps: from the JAX sharded model's initial state, 3
    steps of the port's sharded model (the z-compact #7 around #6 with
    mirrored z reads) match the JAX sharded model within 1e-10 and the
    port's serial z-compact steps within 1e-12."""
    N, dt = (16, 16, 128), 1e-3
    arch = jpar.Distributed(jpar.Partition(2, 2))
    jm = JNHModel(grid=JGrid(size=N, extent=(1.0, 1.0, 1.0),
                             dtype=np.float64),
                  advection=JWENO(5, smoothness_dtype=jnp.float64),
                  buoyancy=JBuoyancyTracer(), architecture=arch)
    assert jm._z_compact and jm._fused_advection is not None
    assert jm._fused_update is None
    rng = np.random.default_rng(2)
    jm.set(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N),
           b=0.01 * rng.standard_normal(N))
    jm.state = arch.shard(jm.state)
    start = _numpy_state(jm)
    for _ in range(3):
        jm.time_step(dt)
    end = _numpy_state(jm)

    def port(mesh):
        grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                                  dtype=torch.float64, device="cpu")
        m = ot.NonhydrostaticModel(
            grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
            buoyancy=ot.BuoyancyTracer(), architecture=mesh)
        return state_from_jax(start, m)

    sharded, serial = port(_cpu_mesh()), port(None)
    assert sharded.grid.H[2] == 0 and sharded._sharded_advection is not None
    for _ in range(3):
        sharded.time_step(dt)
        serial.time_step(dt)
    ints = sharded.grid.interior_slices
    for name in ("u", "v", "w", "b"):
        a = end["fields"][name]
        h = [(a.shape[ax] - N[ax]) // 2 for ax in range(3)]
        want = a[h[0]:h[0] + N[0], h[1]:h[1] + N[1], h[2]:h[2] + N[2]]
        got = sharded.state["fields"][name][ints].numpy()
        assert _rel(got, want) <= 1e-10, name
        # the pencil solver against the serial one: equal to rounding (see
        # test_sharded_convection_against_jax)
        assert _rel(got, serial.state["fields"][name][ints].numpy()) \
            <= 1e-12, name
