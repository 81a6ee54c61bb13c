"""The configurations that a device mesh refused before (ROADMAP item 16b,
part 2) on resident shard blocks, on the CPU (``devices=["cpu"] * 4``, or
2 along one axis), against the JAX package's serial models (JAX shards them
with GSPMD, which partitions the serial step) and the port's serial models.
Float64 fields from numpy seeds; bounds relative to max|reference| (for u,
v and w the velocity scale):

- the NH model on a stretched y (``tests/test_solvers.py:237``'s grid, the
  pencil's Thomas sweep along y on the x-slabs, y split over the mesh),
  on a grid stretched along x and z (``:262``) and on a lat-lon grid, the
  last two through the variable-spacing CG on every shard (its sums over
  the mesh, the pencil of the regular grid its preconditioner): 1e-10
  against JAX, 1e-12 against the port (the CG stops at the same
  iteration on the stretched grid, its final residuals equal to rounding;
  on the lat-lon grid, whose CG takes about 165 iterations, within 5
  iterations of the serial CG and below the tolerance: the pencil
  preconditioner rounds apart from the serial FFT);
- the NH model with a flat y on ``Partition(4, 1)`` (the pencil's slabs cut
  x, its transposed slabs z): 1e-10 and 1e-12; a mesh that splits the flat
  axis raises ``ValueError``;
- the shallow-water model on a stretched y (the plain tendency per shard):
  1e-12 against JAX, bit for bit against the port;
- a ``PerturbationAdvection`` side (the mass balance summed over the
  mesh): 1e-10 and 1e-12;
- the per-slot ENO tables of a stretched sharded axis and #10's
  coefficient rows: the global grid's cut at each shard's offset.

``tests/test_torch_resident.py`` ``test_mesh_refusals_cite_16b`` holds the
six configurations it refused before (now comparisons: the cubed sphere on
its panels, polar caps, a stretched y hydrostatic model, particles, a
stretched x NH model, an Open side), ``tests/test_torch_sharded_hydrostatic
.py`` the array and time-series boundary planes and
``tests/test_torch_parallel.py`` a stretched y shallow-water model.
"""

import importlib

import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
import oceananigans_tpu_torch as ot
from tests.test_torch_parallel import _cpu_mesh

torch.set_num_threads(1)

F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
cgm = importlib.import_module("oceananigans_tpu_torch.solvers."
                              "conjugate_gradient")


def lib(J):
    return jo if J else ot


def grid_kw(J):
    return dict(dtype=np.float64) if J else CPU


def interior(m, name):
    a = m.field(name).interior
    return a.numpy() if hasattr(a, "numpy") else np.asarray(a)


def triple(build, steps, dt, arch=None):
    """(JAX serial, port serial, port sharded) after ``steps`` steps of
    ``dt``; ``build(J)`` builds and sets one model, the sharded one enters
    ``arch`` (a 2×2 CPU mesh by default) through JAX's call shape."""
    jm, serial, sharded = build(True), build(False), build(False)
    sharded.state = (arch or _cpu_mesh()).shard(sharded.state)
    assert sharded._shards is not None
    for _ in range(steps):
        for m in (jm, serial, sharded):
            m.time_step(dt)
    return jm, serial, sharded


def check(jm, serial, sharded, names, rel_jax, rel_serial=0.0):
    """The sharded model against JAX's serial model (``rel_jax`` of max|·|,
    the velocity scale for u, v and w) and the port's (bit for bit, or
    ``rel_serial``)."""
    vel = [n for n in ("u", "v", "w") if n in names]
    scale = max([np.abs(interior(jm, n)).max() for n in vel] or [0.0])
    for n in names:
        got, want = interior(sharded, n), interior(serial, n)
        ref = interior(jm, n)
        s = scale if n in vel else np.abs(ref).max()
        assert np.isfinite(got).all(), n
        if rel_serial == 0.0:
            assert np.array_equal(got, want), n
        else:
            assert np.abs(got - want).max() <= rel_serial * s, n
        err = np.abs(got - ref).max() / s
        assert err <= rel_jax, (n, err)


def nh(J, grid, N, seed=0, **kw):
    """An NH model on ``grid`` with a tracer and seeded u, v, c."""
    L = lib(J)
    m = L.NonhydrostaticModel(grid=grid, advection=L.Centered(2),
                              tracers=("c",), **kw)
    rng = np.random.default_rng(seed)
    m.set(**{k: 0.1 * rng.standard_normal(N) for k in ("u", "v", "c")})
    return m


def faces(n, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(np.concatenate([[0.0], rng.uniform(0.5, 1.5, n)]))


def stretched_y(J):
    """tests/test_solvers.py:237's grid."""
    N = (8, 10, 8)
    g = lib(J).RectilinearGrid(size=N, x=(0, 1.0), y=faces(10, 5),
                               z=(0, 1.0),
                               topology=("periodic", "bounded", "bounded"),
                               **grid_kw(J))
    return nh(J, g, N)


def stretched_x(J):
    """tests/test_solvers.py:205's grid."""
    N = (12, 8, 6)
    g = lib(J).RectilinearGrid(size=N, x=faces(12, 3), y=(0, 2.0),
                               z=(0, 1.5),
                               topology=("bounded", "periodic", "bounded"),
                               **grid_kw(J))
    return nh(J, g, N)


def stretched_xz(J):
    """tests/test_solvers.py:262's grid."""
    N = (8, 8, 8)
    g = lib(J).RectilinearGrid(size=N, x=faces(8, 7), y=(0, 1.0),
                               z=faces(8, 8) - faces(8, 8)[-1],
                               topology=("bounded", "periodic", "bounded"),
                               **grid_kw(J))
    return nh(J, g, N)


def latlon(J):
    """A lat-lon grid whose cells are about as wide as deep (the CG's
    condition number stays small enough to converge)."""
    N = (8, 8, 4)
    g = lib(J).LatitudeLongitudeGrid(size=N, longitude=(0, 0.1),
                                     latitude=(10, 10.1), z=(-1000, 0),
                                     **grid_kw(J))
    return nh(J, g, N)


def _cg_log(m, steps, dt):
    cgm.conjugate_gradient.iterations.clear()
    cgm.conjugate_gradient.residuals.clear()
    for _ in range(steps):
        m.time_step(dt)
    return (list(cgm.conjugate_gradient.iterations),
            list(cgm.conjugate_gradient.residuals))


def test_nh_stretched_y_on_a_mesh():
    """Stretched y split over Partition(1, 2): the Thomas sweep along y."""
    arch = ot.Distributed(ot.Partition(1, 2), devices=["cpu"] * 2)
    jm, serial, sharded = triple(stretched_y, 2, 1e-2, arch)
    check(jm, serial, sharded, ("u", "v", "w", "c"), 1e-10, 1e-12)
    assert type(sharded.pressure_solver).__name__ == \
        "DistributedFFTPoissonSolver"


@pytest.mark.parametrize("case", ["stretched_xz", "latlon"])
def test_variable_spacing_cg_on_a_mesh(case):
    """The variable-spacing CG on every shard against JAX and the port's
    serial CG: its iterations and final residuals."""
    build = {"stretched_xz": stretched_xz, "latlon": latlon}[case]
    jm, serial, sharded = build(True), build(False), build(False)
    sharded.state = _cpu_mesh().shard(sharded.state)
    for _ in range(2):
        jm.time_step(1e-2)
    its_s, res_s = _cg_log(serial, 2, 1e-2)
    its_m, res_m = _cg_log(sharded, 2, 1e-2)
    assert len(its_s) == len(its_m) == 6
    if case == "stretched_xz":
        assert its_m == its_s
        assert np.allclose(res_m, res_s, rtol=1e-9, atol=0)
    else:
        assert max(abs(a - b) for a, b in zip(its_m, its_s)) <= 5
        assert max(res_m) <= 1e-8
    check(jm, serial, sharded, ("u", "v", "w", "c"), 1e-10, 1e-12)


def flat_y(J):
    N = (16, 1, 8)
    g = lib(J).RectilinearGrid(size=(16, 8), x=(0, 1.0), z=(-1.0, 0),
                               topology=("periodic", "flat", "bounded"),
                               **grid_kw(J))
    L = lib(J)
    m = L.NonhydrostaticModel(grid=g, advection=L.Centered(2),
                              tracers=("b",), buoyancy=L.BuoyancyTracer())
    rng = np.random.default_rng(2)
    m.set(u=0.1 * rng.standard_normal(N), w=0.1 * rng.standard_normal(N),
          b=1e-2 * rng.standard_normal(N))
    return m


def test_flat_y_unsplit_on_a_mesh():
    """Row D's topology (Periodic, Flat, Bounded) on Partition(4, 1); a
    mesh that splits the flat y raises ValueError."""
    arch = ot.Distributed(ot.Partition(4, 1), devices=["cpu"] * 4)
    jm, serial, sharded = triple(flat_y, 2, 1e-2, arch)
    check(jm, serial, sharded, ("u", "w", "b"), 1e-10, 1e-12)
    m = flat_y(False)
    with pytest.raises(ValueError, match="not divisible"):
        m.state = _cpu_mesh().shard(m.state)


def stretched_sw(J):
    N = (16, 16)
    L = lib(J)
    g = L.RectilinearGrid(size=N, x=(0, 10.0),
                          y=10.0 * np.linspace(0, 1, 17) ** 1.2,
                          topology=("periodic", "bounded", "flat"),
                          **grid_kw(J))
    weno = L.WENO(5, smoothness_dtype=np.float64 if J else F64)
    m = L.ShallowWaterModel(grid=g, advection=weno,
                            gravitational_acceleration=1.0)
    rng = np.random.default_rng(6)
    m.set(h=1.0 + 0.05 * rng.standard_normal(N),
          uh=0.05 * rng.standard_normal(N))
    return m


def test_shallow_water_stretched_y_on_a_mesh():
    jm, serial, sharded = triple(stretched_sw, 3, 1e-2)
    check(jm, serial, sharded, ("uh", "vh", "h"), 1e-12)


def perturbation_advection(J):
    L = lib(J)
    N = (16, 8, 8)
    g = L.RectilinearGrid(size=N, x=(0, 1.0), y=(0, 1.0), z=(-1.0, 0),
                          topology=("bounded", "periodic", "bounded"),
                          **grid_kw(J))
    sch = L.PerturbationAdvection(10.0, 100.0)
    bcs = {"u": L.FieldBoundaryConditions(
        west=L.OpenBoundaryCondition(0.05, scheme=sch),
        east=L.OpenBoundaryCondition(0.05, scheme=sch))}
    return nh(J, g, N, seed=4, boundary_conditions=bcs)


def test_perturbation_advection_on_a_mesh():
    """PerturbationAdvection on the west and east walls of a split x: the
    faces on the edge shards, the mass balance summed over the mesh."""
    jm, serial, sharded = triple(perturbation_advection, 2, 1e-2)
    check(jm, serial, sharded, ("u", "v", "w", "c"), 1e-10, 1e-12)


def test_stretched_tables_cut_from_the_global_grid():
    """A stretched sharded axis's per-slot tables (the ENO coefficients and
    #10's coefficient rows) on each shard are the global grid's cut at the
    shard's offset: the slots near a shard's edges, whose stencils reach
    past its padded range, take the serial values."""
    from oceananigans_tpu_torch.advection.schemes import _nonuniform_eno
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    g = ot.RectilinearGrid(size=(16, 16, 4), x=(0, 1.0),
                           y=np.linspace(0, 1, 17) ** 1.3, z=(-1.0, 0),
                           topology=("periodic", "bounded", "bounded"), **CPU)
    like = torch.zeros((), dtype=F64)
    cfg = fvi.vi_config(g, ot.WENOVectorInvariant(), ot.WENO(5), 1,
                        ot.FPlane(f=1e-4))
    entries = dict(fvi.site_bases(cfg)[1])
    glob_rows = fvi.coefficient_rows(g, entries, 1)
    for sh in _cpu_mesh().shards(g):
        o, n = sh.offset[1], sh.grid.padded_shape[1]
        for mirrored in (False, True):
            want = _nonuniform_eno(g, 1, 1, 3, 1, mirrored, like)
            got = _nonuniform_eno(sh.grid, 1, 1, 3, 1, mirrored, like)
            for a, b in zip(got, want):
                assert torch.equal(a, b.narrow(1, o, n))
        rows = fvi.coefficient_rows(sh.grid, entries, 1)
        assert len(rows) == len(glob_rows) > 0
        for a, b in zip(rows, glob_rows):
            assert np.array_equal(a, b[o:o + n])


def test_what_a_mesh_still_refuses():
    """Deliberate differences (ROADMAP.md queue 3): a particle dynamics
    callable (it reads the global fields, which no shard holds) and a user
    pressure solver other than the pencil (each shard solves on its own
    block) raise under a mesh; JAX's GSPMD step would run both."""
    g = ot.RectilinearGrid(size=(8, 8, 4), extent=(1.0, 1.0, 1.0), **CPU)
    parts = ot.LagrangianParticles(
        np.array([0.5]), np.array([0.5]), np.array([-0.5]),
        dynamics=lambda grid, fields, particles, dt: particles)
    m = ot.NonhydrostaticModel(g, particles=parts, architecture=_cpu_mesh())
    with pytest.raises(NotImplementedError, match="dynamics callable"):
        m.time_step(1e-3)
    from oceananigans_tpu_torch.solvers.fft_poisson import FFTPoissonSolver
    with pytest.raises(NotImplementedError, match="its own block"):
        ot.NonhydrostaticModel(g, pressure_solver=FFTPoissonSolver(g),
                               architecture=_cpu_mesh())
