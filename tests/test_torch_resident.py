"""The port's models on resident shard blocks against the JAX package's
sharded models, on the CPU (``devices=["cpu"] * 4``: one thread per shard,
the blocks take the plain versions; the JAX side on 4 of the virtual
devices of ``tests/conftest.py``). Float64 fields from numpy seeds; bounds
relative to max|reference|:

- the cases of ``tests/test_parallel.py``: the triply periodic step
  (16×16×8, WENO(5)), a stretched z (the pencil's Thomas sweep against
  JAX's Fourier-tridiagonal solve), the immersed hill of :110 (the CG with
  its sums over the mesh and the pencil preconditioner), the z-compact #7
  (16×16×128) and a forcing that reads an auxiliary field set on the host
  between steps: 1e-10;
- a shallow-water configuration the fused stage does not take (BetaPlane,
  a closure, an array bathymetry) against JAX's GSPMD step: 1e-12, and
  the port's serial step exactly;
- a Gaussian hill on the shards' corners against the port's serial step
  with both CGs at reltol 1e-13: 1e-10 (each shard's near-wall masks cut
  from the global grid's);
- the z-compact state's halos after a step (the divergence read through
  them at roundoff);
- no global-view tensor inside a step, a shard's exception raised in the
  caller, a dropped sharded model collected (its shards' threads end), and
  the refusals citing ROADMAP item 16b.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.models import NonhydrostaticModel as JNHModel
from oceananigans_tpu.models.shallow_water import ShallowWaterModel as JSWModel
import oceananigans_tpu.parallel as jpar
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.parallel as tpar
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.models import state_from_jax
from tests.test_torch_parallel import (NH_DT, NH_N, SW_DT, SW_N, _cpu_mesh,
                                       _jax_interiors, _numpy_state,
                                       _port_convection, _port_interiors,
                                       _port_sw, _rel, _sw_inputs)

torch.set_num_threads(1)


def _interiors(state, N):
    """{name: interior} of a numpy state's fields, their halos read off
    their shapes."""
    out = {}
    for name, a in state["fields"].items():
        h = [(a.shape[ax] - N[ax]) // 2 for ax in range(3)]
        out[name] = a[h[0]:h[0] + N[0], h[1]:h[1] + N[1], h[2]:h[2] + N[2]]
    return out


def _nh_pair(N, jkw, tkw, init, steps, dt, jgrid=None, tgrid=None):
    """The JAX sharded model on 4 virtual devices (2x2) from ``init`` and
    the port's sharded model from the JAX model's initial state: both
    fields after ``steps`` steps, interiors."""
    arch = jpar.Distributed(jpar.Partition(2, 2),
                            devices=jax.devices()[:4])
    jm = JNHModel(grid=jgrid or JGrid(size=N, extent=(1.0, 1.0, 1.0),
                                      dtype=np.float64),
                  architecture=arch, **jkw)
    jm.set(**init)
    jm.state = arch.shard(jm.state)
    start = _numpy_state(jm)
    for _ in range(steps):
        jm.time_step(dt)
    want = _interiors(_numpy_state(jm), N)
    tm = ot.NonhydrostaticModel(
        tgrid or ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                                    dtype=torch.float64, device="cpu"),
        architecture=_cpu_mesh(), **tkw)
    state_from_jax(start, tm)
    for _ in range(steps):
        tm.time_step(dt)
    ints = tm.grid.interior_slices
    got = {n: a[ints].numpy() for n, a in tm.state["fields"].items()}
    return tm, got, want


def test_sharded_triply_periodic_against_jax():
    """tests/test_parallel.py:64 at 16x16x8 on 2x2: a triply periodic
    WENO(5) step (the JAX side's GSPMD path; the port's #7 per shard with a
    periodic z and the pencil solver's FFT z), 2 steps, 1e-10."""
    N = (16, 16, 8)
    rng = np.random.default_rng(1)
    init = dict(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N))
    topo = ("periodic",) * 3
    tm, got, want = _nh_pair(
        N, dict(advection=JWENO(5, smoothness_dtype=jnp.float64),
                fused_advection=False),
        dict(advection=ot.WENO(5, smoothness_dtype=torch.float64)),
        init, 2, 1e-3,
        jgrid=JGrid(size=N, extent=(1, 1, 1), topology=topo,
                    dtype=np.float64),
        tgrid=ot.RectilinearGrid(size=N, extent=(1, 1, 1), topology=topo,
                                 dtype=torch.float64, device="cpu"))
    assert tm._sharded_advection is not None
    assert tm._shards[0].pressure_solver.pencil.z_kind == "periodic"
    for name in ("u", "v", "w"):
        assert _rel(got[name], want[name]) <= 1e-10, name


def test_sharded_stretched_z_against_jax():
    """A stretched z (the faces of tests/test_parallel.py:170) on 2x2: the
    JAX GSPMD step with its Fourier-tridiagonal solver against the port's
    shards with the pencil's Thomas sweep (row 0 of the singular mode
    pinned: φ differs by a constant, its gradient does not), 2 steps,
    1e-10."""
    N = (16, 16, 8)
    zf = -1.0 + np.linspace(0, 1, 9) ** 1.5
    topo = ("periodic", "periodic", "bounded")
    rng = np.random.default_rng(5)
    init = dict(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N))
    tm, got, want = _nh_pair(
        N, dict(advection=JWENO(5, smoothness_dtype=jnp.float64),
                fused_advection=False),
        dict(advection=ot.WENO(5, smoothness_dtype=torch.float64)),
        init, 2, 1e-3,
        jgrid=JGrid(size=N, x=(0, 1), y=(0, 1), z=zf, topology=topo,
                    dtype=np.float64),
        tgrid=ot.RectilinearGrid(size=N, x=(0, 1), y=(0, 1), z=zf,
                                 topology=topo, dtype=torch.float64,
                                 device="cpu"))
    assert tm._shards[0].pressure_solver.pencil.z_kind == "tridiagonal"
    for name in ("u", "v", "w"):
        assert _rel(got[name], want[name]) <= 1e-10, name


def test_sharded_immersed_against_jax():
    """tests/test_parallel.py:110 at 16x16x8 on 2x2: a GridFittedBottom
    hill, each shard's masks cut from the global grid's and its CG solve
    summed over the mesh with the pencil preconditioner, 2 steps, 1e-10;
    every shard takes the same iterations."""
    from oceananigans_tpu.immersed import (GridFittedBottom as JBottom,
                                           ImmersedBoundaryGrid as JIBG)
    from oceananigans_tpu_torch.solvers.conjugate_gradient import \
        conjugate_gradient
    N = (16, 16, 8)
    topo = ("periodic", "periodic", "bounded")
    jgrid = JIBG(JGrid(size=N, extent=(1, 1, 1), topology=topo,
                       dtype=np.float64),
                 JBottom(lambda x, y: -0.8 + 0.3 * np.sin(2 * np.pi * x)))
    tgrid = ot.ImmersedBoundaryGrid(
        ot.RectilinearGrid(size=N, extent=(1, 1, 1), topology=topo,
                           dtype=torch.float64, device="cpu"),
        ot.GridFittedBottom(lambda x, y: -0.8 + 0.3 * np.sin(2 * np.pi * x)))
    rng = np.random.default_rng(7)
    init = dict(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N))
    before = len(conjugate_gradient.iterations)
    tm, got, want = _nh_pair(
        N, dict(advection=JWENO(5, smoothness_dtype=jnp.float64),
                fused_advection=False),
        dict(advection=ot.WENO(5, smoothness_dtype=torch.float64)),
        init, 2, 1e-3, jgrid=jgrid, tgrid=tgrid)
    assert len(conjugate_gradient.iterations) == before + 6
    solid = tm.grid.solid_ccc[tm.grid.interior_slices]
    for name in ("u", "v", "w"):
        assert _rel(got[name], want[name]) <= 1e-10, name
    assert np.all(got["u"][solid] == 0)


def test_sharded_fused_advection_against_jax():
    """tests/test_parallel.py:190 at 16x16x128 on 2x2: the z-compact
    WENO(5) model, JAX's sharded #7 (its update route off under the mesh)
    against the port's #7 per shard, 2 steps, 1e-10."""
    N = (16, 16, 128)
    rng = np.random.default_rng(3)
    init = dict(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N))
    tm, got, want = _nh_pair(
        N, dict(advection=JWENO(5, smoothness_dtype=jnp.float64),
                fused_advection=True, z_compact=True),
        dict(advection=ot.WENO(5, smoothness_dtype=torch.float64)),
        init, 2, 1e-3)
    assert tm.grid.H[2] == 0 and not tm._shards[0]._fused_update
    for name in ("u", "v", "w"):
        assert _rel(got[name], want[name]) <= 1e-10, name


def test_sharded_auxiliary_forcing_against_jax():
    """tests/test_parallel.py:557 on 2x2: a forcing that reads an
    auxiliary field; the host's A.set(4.0) between the steps reaches every
    shard on the next step. The tracer's interior after each step against
    the JAX sharded model, 1e-10, and the JAX test's arithmetic."""
    from oceananigans_tpu import CenterField as JCenterField
    from oceananigans_tpu.forcings import ContinuousForcing as JCF
    N = (16, 16, 8)
    arch = jpar.Distributed(jpar.Partition(2, 2), devices=jax.devices()[:4])
    jgrid = JGrid(size=N, extent=(1.0, 1.0, 1.0), dtype=np.float64)
    jA = JCenterField(jgrid).set(2.0)
    jm = JNHModel(grid=jgrid, advection=None, tracers=("c",),
                  forcing={"c": JCF(lambda x, y, z, t, A: A,
                                    field_dependencies=("A",))},
                  auxiliary_fields={"A": jA}, architecture=arch)
    jm.state = arch.shard(jm.state)
    tgrid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                               dtype=torch.float64, device="cpu")
    tA = ot.CenterField(tgrid).set(2.0)
    tm = ot.NonhydrostaticModel(
        tgrid, advection=None, tracers=("c",),
        forcing={"c": ot.ContinuousForcing(lambda x, y, z, t, A: A,
                                           field_dependencies=("A",))},
        auxiliary_fields={"A": tA}, architecture=_cpu_mesh())
    means = []
    for value in (None, 4.0):
        if value is not None:
            jA.set(value)
            tA.set(value)
        jm.time_step(0.1)
        tm.time_step(0.1)
        want = np.asarray(jm.field("c").interior)
        got = tm.field("c").interior.numpy()
        assert _rel(got, want) <= 1e-10
        means.append(float(got.mean()))
    np.testing.assert_allclose(means[0], 0.2, rtol=1e-5)
    np.testing.assert_allclose(means[1] - means[0], 0.4, rtol=1e-4)


def test_sharded_plain_shallow_water_against_jax():
    """A configuration the fused stage does not take under a 2x2 mesh:
    BetaPlane, a ScalarDiffusivity and an array bathymetry, 32² with a
    tracer, 3 steps of each shard's plain tendencies against JAX's GSPMD
    step (fused=False) at 1e-12. The shards' bathymetry blocks carry the
    global array's halos, as JAX's global step reads them, so the sharded
    step equals the port's serial one."""
    from oceananigans_tpu.closures import ScalarDiffusivity as JSD
    from oceananigans_tpu.coriolis import BetaPlane as JBeta
    hB, init = _sw_inputs()
    arch = jpar.Distributed(jpar.Partition(2, 2), devices=jax.devices()[:4])
    jgrid = JGrid(size=SW_N, extent=(10.0, 10.0),
                  topology=("periodic", "periodic", "flat"), dtype=np.float64)
    jm = JSWModel(grid=jgrid, advection=JWENO(5, smoothness_dtype=jnp.float64),
                  coriolis=JBeta(f0=0.3, beta=0.1), bathymetry=hB,
                  closure=JSD(nu=2e-2, kappa=1e-2), tracers=("c",),
                  gravitational_acceleration=9.81, fused=False,
                  architecture=arch)
    jm.set(**init)
    jm.state = arch.shard(jm.state)

    def port(mesh):
        grid = ot.RectilinearGrid(size=SW_N, extent=(10.0, 10.0),
                                  topology=("periodic", "periodic", "flat"),
                                  dtype=torch.float64, device="cpu")
        m = ot.ShallowWaterModel(
            grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
            coriolis=ot.BetaPlane(f0=0.3, beta=0.1), bathymetry=hB,
            closure=ot.ScalarDiffusivity(nu=2e-2, kappa=1e-2),
            tracers=("c",), gravitational_acceleration=9.81,
            architecture=mesh)
        m.set(**init)
        return m

    tm, serial = port(_cpu_mesh()), port(None)
    assert not tm.fused and tm._shards is not None
    for _ in range(3):
        jm.time_step(SW_DT)
        tm.time_step(SW_DT)
        serial.time_step(SW_DT)
    want, got = _jax_interiors(jm), _port_interiors(tm)
    ref = _port_interiors(serial)
    for name in want:
        assert _rel(got[name], want[name]) <= 1e-12, name
        assert np.array_equal(got[name], ref[name]), name


def test_no_global_view_in_the_step(monkeypatch):
    """Each shard's blocks stay on its device across steps, and no step
    forms a global-view tensor: ``Distributed.gather`` (the one place that
    assembles one) is never called inside ``time_step``, for the NH model
    (pencil solve) and the fused shallow-water model."""
    calls = []
    gather = tpar.Distributed.gather

    def counting(self, blocks, halo=None):
        calls.append(len(blocks))
        return gather(self, blocks, halo)

    monkeypatch.setattr(tpar.Distributed, "gather", counting)
    nh = _port_convection(_cpu_mesh())
    nh.set(u=lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    sw = _port_sw(_cpu_mesh(), 0.0)
    for m, dt in ((nh, NH_DT), (sw, SW_DT)):
        blocks = [dict(s._state["fields"]) for s in m._shards]
        calls.clear()
        m.time_step(dt)
        m.time_step(dt)
        assert calls == []
        for s, sh in zip(m._shards, m.architecture.shards(m.grid)):
            for name, a in s._state["fields"].items():
                assert a.device == sh.device
                assert a.shape == s.grid.padded_shape
                assert a.shape[:2] != m.grid.padded_shape[:2]
        assert len(blocks) == 4
    nh.field("u")
    assert calls == [4]


def test_shard_exception_reaches_the_caller():
    """A forcing that raises on the shards whose padded x reaches past 1
    (the high-x half): the exception reaches the caller, no shard hangs,
    and the mesh runs again after."""
    arch = _cpu_mesh()

    def forcing(x, y, z, t):
        if float(x.max()) > 1.0:
            raise ArithmeticError("shard fault")
        return 0.0 * x

    grid = ot.RectilinearGrid(size=NH_N, extent=(1.0, 1.0, 1.0),
                              dtype=torch.float64, device="cpu")
    m = ot.NonhydrostaticModel(grid, tracers=("c",), architecture=arch,
                               forcing={"c": ot.ContinuousForcing(forcing)})
    with pytest.raises(ArithmeticError, match="shard fault"):
        m.time_step(NH_DT)
    out = arch.communicator.run(
        lambda r: float(arch.communicator.all_reduce(
            r, torch.tensor(float(r)), "max")))
    assert out == [3.0] * 4


def test_sharded_model_is_collected_and_its_threads_end():
    """A stepped sharded model, its architecture and its pencil solver are
    collected once the caller drops them: the shards' threads hold nothing
    of the last run and no strong reference to the communicator, and they
    end when it is collected."""
    import gc
    import threading
    import weakref

    def shard_threads():
        return {t for t in threading.enumerate()
                if t.name.startswith("shard-")}

    before = shard_threads()
    grid = ot.RectilinearGrid(size=NH_N, extent=(1.0, 1.0, 1.0),
                              dtype=torch.float64, device="cpu")
    m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5),
                               architecture=_cpu_mesh())
    m.set(u=lambda x, y, z: np.sin(2 * np.pi * x))
    m.time_step(NH_DT)
    threads = shard_threads() - before
    assert len(threads) == 4
    refs = [weakref.ref(o) for o in (m, m.architecture, m.pressure_solver,
                                     m.architecture.communicator)]
    del m
    gc.collect()
    assert [r() for r in refs] == [None] * 4
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


REFUSED = {
    "bounded_y_nh": lambda g: ot.NonhydrostaticModel(
        g(("periodic", "bounded", "bounded")), architecture=_cpu_mesh()),
    "bounded_y_sw": lambda g: ot.ShallowWaterModel(
        ot.RectilinearGrid(size=(16, 16), extent=(1.0, 1.0),
                           topology=("periodic", "bounded", "flat"),
                           dtype=torch.float64, device="cpu"),
        architecture=_cpu_mesh()),
    "particles": lambda g: ot.NonhydrostaticModel(
        g(("periodic", "periodic", "bounded")), architecture=_cpu_mesh(),
        particles=ot.LagrangianParticles(np.array([0.5]), np.array([0.5]),
                                         np.array([-0.5]))),
    "stretched_x": lambda g: ot.NonhydrostaticModel(
        ot.RectilinearGrid(size=NH_N, x=np.linspace(0, 1, 17) ** 1.2,
                           y=(0, 1), z=(-1, 0), dtype=torch.float64,
                           device="cpu"), architecture=_cpu_mesh()),
    "open": lambda g: ot.NonhydrostaticModel(
        g(("periodic", "periodic", "bounded")), architecture=_cpu_mesh(),
        boundary_conditions={"w": ot.FieldBoundaryConditions(
            top=ot.OpenBoundaryCondition(0.0))}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_mesh_refusals_cite_16b(case):
    def grid(topo):
        return ot.RectilinearGrid(size=NH_N, extent=(1.0, 1.0, 1.0),
                                  topology=topo, dtype=torch.float64,
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 16b"):
        REFUSED[case](grid)


def test_sharded_compact_state_keeps_valid_halos():
    """The z-compact correction wraps its outputs' halos within a block; a
    shard's are exchanged after it, so the gathered state's divergence
    (which reads the halos) is at roundoff after set() and after a step,
    as the serial model's."""
    N = (16, 16, 16)

    def model(mesh):
        grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                                  dtype=torch.float64, device="cpu")
        m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5),
                                   buoyancy=ot.BuoyancyTracer(),
                                   architecture=mesh)
        rng = np.random.default_rng(0)
        m.set(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N),
              b=0.01 * rng.standard_normal(N))
        return m

    for m in (model(_cpu_mesh()), model(None)):
        assert m._z_compact
        for _ in range(2):
            u, v, w = (m.state["fields"][c] for c in "uvw")
            div = K.fused_divergence_plain(m.grid, u, v, w, 1.0)
            assert div.abs().max() <= 1e-12
            m.time_step(1e-3)


def test_sharded_hill_equals_serial_at_tight_tolerance():
    """A Gaussian hill whose top sits on the shards' corners (16x16x8 on
    2x2): each shard's near-wall masks are cut from the global grid's, so
    with both CG solves at reltol 1e-13 the sharded step matches the serial
    one within 1e-10 of each field's max|·| (at the default 1e-7 the two
    stop on either side of the tolerance as their sums round apart)."""
    N = (16, 16, 8)

    def model(mesh):
        L = 4000.0
        grid = ot.ImmersedBoundaryGrid(
            ot.RectilinearGrid(size=N, x=(0.0, L), y=(0.0, L),
                               z=(-200.0, 0.0), dtype=torch.float64,
                               device="cpu"),
            ot.GridFittedBottom(lambda x, y: -200.0 + 100.0 * np.exp(
                -((x - L / 2) ** 2 + (y - L / 2) ** 2) / 800.0 ** 2)))
        m = ot.NonhydrostaticModel(
            grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
            buoyancy=ot.BuoyancyTracer(), architecture=mesh)
        for solver in ([m.pressure_solver] if mesh is None else
                       [s.pressure_solver for s in m._shards]):
            solver.reltol, solver.maxiter = 1e-13, 3000
        return m

    serial, sharded = model(None), model(_cpu_mesh())
    rng = np.random.default_rng(0)
    serial.set(b=lambda x, y, z: 1e-5 * z,
               u=0.1 + 0.01 * rng.standard_normal(N),
               v=0.01 * rng.standard_normal(N))
    sharded.state = serial.state
    for _ in range(2):
        serial.time_step(20.0)
        sharded.time_step(20.0)
    for name in ("u", "v", "w", "b"):
        a = sharded.field(name).interior.numpy()
        b = serial.field(name).interior.numpy()
        assert _rel(a, b) <= 1e-10, name
