"""The port's pencil Poisson solvers (``parallel/pencil_fft.py``) against
the JAX package's, on the CPU.

``DistributedFFTPoissonSolver`` and its alias
``DistributedFourierTridiagonalPoissonSolver`` on meshes of 4 and 8 slabs
(``devices=["cpu"] * P``: one thread per slab, the transposes through the
mesh's communicator) against JAX's on 4 and 8 virtual devices, the same
float64 right-hand side from a numpy seed (mean removed) handed to both.
Bounds, on max|φ| of the reference:

- against JAX's pencil solver: 1e-10, for a periodic z (FFT), a regular
  bounded z (DCT), a stretched bounded z (the batched Thomas sweep, row 0
  of the singular mode pinned on both sides) and a flat z;
- against the port's serial ``FFTPoissonSolver`` (and
  ``FourierTridiagonalPoissonSolver`` on the stretched z, which removes a
  Δz-weighted mean after the pin: compared after removing the means, as
  ``tests/test_parallel.py`` compares JAX's): 1e-10; in float32 on a
  stretched z, the pencil's error within 1.25 times the serial solver's;
- JAX's refusals: a bounded x (``NotImplementedError``), an Nx or Ny the
  mesh does not divide (``ValueError``, JAX's message);
- the re-blocking of a 2×2 mesh of resident blocks into 4 x-slabs and
  back: exact, and the block entry against the serial solver at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.parallel.pencil_fft import (
    DistributedFFTPoissonSolver as JPencil)
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.parallel import (
    DistributedFFTPoissonSolver, DistributedFourierTridiagonalPoissonSolver)
from oceananigans_tpu_torch.solvers.fft_poisson import FFTPoissonSolver
from oceananigans_tpu_torch.solvers.fourier_tridiagonal import \
    FourierTridiagonalPoissonSolver

torch.set_num_threads(1)

N = (16, 16, 8)
ZF = -1.0 + np.linspace(0, 1, 9) ** 1.5

Z_KINDS = {
    "periodic": dict(topology=("periodic", "periodic", "periodic"),
                     extent=(1.0, 2.0, 1.0)),
    "dct": dict(topology=("periodic", "periodic", "bounded"),
                extent=(1.0, 2.0, 1.0)),
    "stretched": dict(topology=("periodic", "periodic", "bounded"),
                      x=(0, 1), y=(0, 2), z=ZF),
    "flat": dict(topology=("periodic", "periodic", "flat"),
                 extent=(1.0, 2.0)),
}


def _size(kind):
    return N[:2] if kind == "flat" else N


def _grids(kind):
    kw = Z_KINDS[kind]
    return (JGrid(size=_size(kind), dtype=np.float64, **kw),
            ot.RectilinearGrid(size=_size(kind), dtype=torch.float64,
                               device="cpu", **kw))


def _rhs(grid, seed=0):
    b = np.random.default_rng(seed).standard_normal(grid.N)
    return b - b.mean()


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("kind", sorted(Z_KINDS))
def test_pencil_against_jax(kind, P):
    jgrid, tgrid = _grids(kind)
    b = _rhs(tgrid)
    jmesh = JMesh(np.asarray(jax.devices()[:P]), ("x",))
    want = np.asarray(JPencil(jgrid, jmesh).solve(jnp.asarray(b)))
    solver = DistributedFFTPoissonSolver(tgrid, ["cpu"] * P)
    assert solver.z_kind == kind.replace("stretched", "tridiagonal")
    got = solver.solve(torch.as_tensor(b)).numpy()
    assert got.shape == tuple(tgrid.N)
    assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("kind", sorted(Z_KINDS))
def test_pencil_against_serial(kind):
    _, tgrid = _grids(kind)
    b = torch.as_tensor(_rhs(tgrid, seed=1))
    serial = (FourierTridiagonalPoissonSolver(tgrid, 2) if kind == "stretched"
              else FFTPoissonSolver(tgrid)).solve(b).numpy()
    got = DistributedFourierTridiagonalPoissonSolver(
        tgrid, ["cpu"] * 4).solve(b).numpy()
    if kind == "stretched":
        got, serial = got - got.mean(), serial - serial.mean()
    assert _rel(got, serial) <= 1e-10


def test_alias():
    assert DistributedFourierTridiagonalPoissonSolver is \
        DistributedFFTPoissonSolver


def test_refusals_as_in_jax():
    bounded = dict(size=N, extent=(1.0, 1.0, 1.0),
                   topology=("bounded", "periodic", "bounded"))
    with pytest.raises(NotImplementedError, match="periodic horizontal"):
        JPencil(JGrid(dtype=np.float64, **bounded),
                JMesh(np.asarray(jax.devices()[:4]), ("x",)))
    # the port's pencil takes the bounded x with the serial solver's DCT
    # where x is whole (a deliberate difference, ROADMAP.md queue 3: JAX's
    # model on such a grid under GSPMD runs its serial solver)
    tgrid = ot.RectilinearGrid(dtype=torch.float64, device="cpu", **bounded)
    b = torch.as_tensor(_rhs(tgrid, seed=3))
    got = DistributedFFTPoissonSolver(tgrid, ["cpu"] * 4).solve(b).numpy()
    serial = FFTPoissonSolver(tgrid).solve(b).numpy()
    assert _rel(got, serial) <= 1e-12
    messages = []
    odd = dict(size=(16, 12, 8), extent=(1.0, 1.0, 1.0))
    with pytest.raises(ValueError) as err:
        JPencil(JGrid(dtype=np.float64, **odd),
                JMesh(np.asarray(jax.devices()[:8]), ("x",)))
    messages.append(str(err.value))
    with pytest.raises(ValueError) as err:
        DistributedFFTPoissonSolver(ot.RectilinearGrid(
            dtype=torch.float64, device="cpu", **odd), ["cpu"] * 8)
    messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_reblocking_a_2x2_mesh():
    """Resident (8, 8, 8) blocks of a 2x2 mesh into four (4, 16, 8)
    x-slabs and back, exact; the block entry against the serial solver."""
    _, tgrid = _grids("dct")
    arch = ot.Distributed(ot.Partition(2, 2), devices=["cpu"] * 4)
    solver = DistributedFFTPoissonSolver(tgrid, arch)
    b = torch.as_tensor(_rhs(tgrid, seed=2))
    blocks = [b[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8].clone()
              for i in range(2) for j in range(2)]
    comm = arch.communicator
    slabs = comm.run(lambda r: solver.to_slabs(r, blocks[r]))
    for s, slab in enumerate(slabs):
        assert torch.equal(slab, b[4 * s:4 * (s + 1)])
    back = comm.run(lambda r: solver.from_slabs(r, slabs[r]))
    assert all(torch.equal(x, y) for x, y in zip(back, blocks))
    phi = comm.run(lambda r: solver.solve_block(r, blocks[r]))
    phi = torch.cat([torch.cat(phi[2 * i:2 * i + 2], dim=1)
                     for i in range(2)], dim=0)
    assert _rel(phi.numpy(), FFTPoissonSolver(tgrid).solve(b).numpy()) \
        <= 1e-10


def test_float32_stretched_pencil_rounds_as_the_serial_solver():
    """Float32 on a stretched z at (16, 16, 64): the pencil's error against
    the serial float64 solve within 1.25 times the serial float32 solve's
    own (means removed). Both form the tridiagonal coefficients in float64
    and round them once; formed in float32 the pencil read 2.1 times the
    serial's error here."""
    n = (16, 16, 64)

    def grid(dtype):
        return ot.RectilinearGrid(
            size=n, topology=("periodic", "periodic", "bounded"), x=(0, 1),
            y=(0, 1), z=-1.0 + np.linspace(0, 1, n[2] + 1) ** 1.5,
            dtype=dtype, device="cpu")

    rng = np.random.default_rng(3)
    b = torch.as_tensor(rng.standard_normal(n))
    b -= b.mean()

    def centred(a):
        a = a.double()
        return (a - a.mean()).numpy()

    exact = centred(FourierTridiagonalPoissonSolver(
        grid(torch.float64), 2).solve(b))
    g32 = grid(torch.float32)
    serial = centred(FourierTridiagonalPoissonSolver(g32, 2).solve(b.float()))
    pencil = centred(DistributedFFTPoissonSolver(g32, ["cpu"] * 4).solve(
        b.float()))
    own = _rel(serial, exact)
    assert 0 < own < 1e-5
    assert _rel(pencil, exact) <= 1.25 * own
