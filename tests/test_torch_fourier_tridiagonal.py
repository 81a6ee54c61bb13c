"""The port's Fourier-tridiagonal Poisson solver, its batched tridiagonal
solve along any axis and the DCT along any axis, against the JAX package,
on the CPU in float64; and the NonhydrostaticModel on a stretched grid.

- ``FourierTridiagonalPoissonSolver`` with x, y or z stretched (the grids
  of JAX's ``tests/test_solvers.py``, periodic and bounded transformed
  axes, a flat one) against JAX's ``solve``: 1e-12 relative to max|φ| (the
  same transforms and Thomas recurrence, the JAX ones through matmul DFTs);
  its Laplacian residual < 1e-8 for a volume-weighted zero-mean b; on a
  regular grid it equals the FFT solver up to the constant each removes
  (1e-12).
- ``solve_batched_tridiagonal`` along each axis, with 1-D and full
  coefficients and a complex right-hand side, against a dense solve
  (1e-12) and JAX's solver on the moved axis (1e-14).
- ``apply_matrix_along`` (the DCT and its inverse) on each axis against
  JAX's ``dct_forward`` and ``dct_inverse`` (1e-14).
- the model on a stretched z, (periodic, periodic, bounded) and (periodic,
  flat, bounded), and on a stretched x, over 3 RK3 steps from the JAX state
  at 1e-10 relative; a grid stretched along two axes raises and cites
  ROADMAP item 11c.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
import oceananigans_tpu.advection as ja
from oceananigans_tpu.models import NonhydrostaticModel as JModel
from oceananigans_tpu.solvers.fourier_tridiagonal import (
    FourierTridiagonalPoissonSolver as JFT)
from oceananigans_tpu.solvers.transforms import dct_forward, dct_inverse
from oceananigans_tpu.solvers.tridiagonal import (
    solve_batched_tridiagonal as j_tridiag)
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.models import NonhydrostaticModel, state_from_jax
from oceananigans_tpu_torch.solvers import (FFTPoissonSolver,
                                            FourierTridiagonalPoissonSolver,
                                            apply_matrix_along, dct2_matrix,
                                            idct2_matrix)
from oceananigans_tpu_torch.solvers.tridiagonal import \
    solve_batched_tridiagonal
from test_torch_topologies import laplacian, numpy_state, rel

torch.set_num_threads(1)

P, B, F = "periodic", "bounded", "flat"
F64 = torch.float64


def faces(n, L, lo=0.0, seed=3):
    """n + 1 increasing faces over [lo, lo + L] with uneven spacing."""
    d = np.random.default_rng(seed).uniform(0.5, 1.5, n)
    f = np.concatenate([[0.0], np.cumsum(d)])
    return lo + L * f / f[-1]


# JAX's test grids (tests/test_solvers.py): a stretched z of geometric
# spacing, a stretched x and y of uneven spacing; then a flat y with a
# stretched z (the tilted boundary layer's kind) and a bounded x with a
# stretched z.
Z_FACES = -np.flip(np.concatenate([[0], np.cumsum(0.1 * 1.15 ** np.arange(8))]))
CASES = {
    "z": dict(size=(8, 8, 8), x=(0, 1), y=(0, 1), z=Z_FACES),
    "x": dict(size=(12, 8, 6), x=faces(12, 12.0), y=(0, 2.0), z=(0, 1.5),
              topology=(B, P, B)),
    "y": dict(size=(8, 10, 8), x=(0, 1.0), y=faces(10, 10.0), z=(0, 1.0),
              topology=(P, B, B)),
    "z_flat_y": dict(size=(8, 10), x=(0, 1.0), z=faces(10, 1.0, -1.0),
                     topology=(P, F, B)),
    "z_bounded_x": dict(size=(6, 8, 10), x=(0, 1.0), y=(0, 2.0),
                        z=faces(10, 1.0, -1.0), topology=(B, P, B)),
}
AXIS = {"z": 2, "x": 0, "y": 1, "z_flat_y": 2, "z_bounded_x": 2}


def interior_shape(grid):
    return tuple(grid.N)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_against_jax(case):
    spec = CASES[case]
    jg = jo.RectilinearGrid(dtype=np.float64, **spec)
    tg = ot.RectilinearGrid(dtype=F64, device="cpu", **spec)
    s = AXIS[case]
    assert tg.stretched_axes == (s,) == jg.stretched_axes
    b = np.random.default_rng(4).standard_normal(interior_shape(tg))
    V = torch.as_tensor(tg.V(("c", "c", "c"))).broadcast_to(
        tg.padded_shape)[tg.interior_slices].numpy()
    b -= (b * V).sum() / V.sum()
    want = np.asarray(JFT(jg, stretched_axis=s).solve(jnp.asarray(b)))
    solver = FourierTridiagonalPoissonSolver(tg, stretched_axis=s)
    got = solver.solve(torch.as_tensor(b))
    assert rel(got.numpy(), want) <= 1e-12
    res = (laplacian(tg, got) - torch.as_tensor(b)).abs().max().item()
    assert res < 1e-8, res


@pytest.mark.parametrize("topology", [(P, P, B), (B, B, B), (P, F, B)],
                         ids="-".join)
def test_equals_fft_solver_on_regular_grid(topology):
    keep = [ax for ax in range(3) if topology[ax] != F]
    spec = dict(size=tuple((8, 6, 10)[ax] for ax in keep),
                extent=tuple((1.0, 2.0, 0.5)[ax] for ax in keep),
                topology=topology)
    grid = ot.RectilinearGrid(dtype=F64, device="cpu", **spec)
    N = tuple(grid.N)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal(N))
    b = b - b.mean()
    p1 = FFTPoissonSolver(grid).solve(b)
    p2 = FourierTridiagonalPoissonSolver(grid, stretched_axis=2).solve(b)
    p1, p2 = p1 - p1.mean(), p2 - p2.mean()
    assert rel(p2.numpy(), p1.numpy()) <= 1e-12


@pytest.mark.parametrize("coefs", ["1d", "full"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_tridiagonal_along_any_axis(axis, coefs):
    rng = np.random.default_rng(6 + axis)
    shape = (5, 6, 7)
    n = shape[axis]
    cshape = (n,) if coefs == "1d" else shape
    a = 0.1 * rng.standard_normal(cshape)
    b = 2.0 + rng.random(cshape)
    c = 0.1 * rng.standard_normal(cshape)
    d = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = solve_batched_tridiagonal(*(torch.as_tensor(x) for x in (a, b, c, d)),
                                    axis=axis).numpy()
    # dense, line by line
    dm = np.moveaxis(d, axis, -1)
    gm = np.moveaxis(got, axis, -1)
    full = [np.broadcast_to(np.moveaxis(x, axis, -1) if x.ndim == 3 else x,
                            dm.shape) for x in (a, b, c)]
    for idx in np.ndindex(dm.shape[:-1]):
        aa, bb, cc = (x[idx] for x in full)
        M = np.diag(bb) + np.diag(aa[1:], -1) + np.diag(cc[:-1], 1)
        want = np.linalg.solve(M, dm[idx])
        assert np.abs(gm[idx] - want).max() <= 1e-12 * np.abs(want).max()
    # JAX's solver (last axis) on the moved axis, real and imaginary parts
    move = (lambda x: np.moveaxis(x, axis, -1)) if coefs == "full" else \
        (lambda x: x)
    for part in (np.real, np.imag):
        want = np.moveaxis(np.asarray(j_tridiag(
            *(jnp.asarray(move(x)) for x in (a, b, c)),
            jnp.asarray(np.moveaxis(part(d), axis, -1)))), -1, axis)
        assert rel(part(got), want) <= 1e-14


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_dct_along_any_axis(axis):
    x = np.random.default_rng(8).standard_normal((5, 12, 7))
    n = x.shape[axis]
    M = torch.as_tensor(dct2_matrix(n))
    Mi = torch.as_tensor(idct2_matrix(n))
    fwd = apply_matrix_along(torch.as_tensor(x), M, axis)
    assert rel(fwd.numpy(), np.asarray(dct_forward(jnp.asarray(x), axis))) \
        <= 1e-14
    back = apply_matrix_along(fwd, Mi, axis)
    assert rel(back.numpy(), np.asarray(dct_inverse(
        dct_forward(jnp.asarray(x), axis), axis))) <= 1e-14
    assert rel(back.numpy(), x) <= 1e-13


MODEL_CASES = {
    "z_ppb": dict(size=(8, 8, 8), x=(0, 1.0), y=(0, 2.0),
                  z=faces(8, 0.5, -0.5)),
    "z_pfb": dict(size=(8, 8), x=(0, 1.0), z=faces(8, 0.5, -0.5),
                  topology=(P, F, B)),
    "x_bpb": dict(size=(8, 8, 8), x=faces(8, 1.0), y=(0, 2.0), z=(-0.5, 0),
                  topology=(B, P, B)),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_against_jax(case):
    spec = MODEL_CASES[case]
    jm = JModel(grid=jo.RectilinearGrid(dtype=np.float64, **spec),
                advection=ja.WENO(5, smoothness_dtype=jnp.float64),
                tracers=("c",))
    N = tuple(jm.grid.N)
    rng = np.random.default_rng(0)
    jm.set(**{k: 0.1 * rng.standard_normal(N) for k in ("u", "v", "w", "c")})
    start = numpy_state(jm.state)
    tm = NonhydrostaticModel(ot.RectilinearGrid(dtype=F64, device="cpu",
                                                **spec),
                             advection=ot.WENO(5, smoothness_dtype=F64),
                             tracers=("c",))
    assert isinstance(tm.pressure_solver, FourierTridiagonalPoissonSolver)
    assert not tm._z_compact and not tm._kernel_tendency
    state_from_jax(start, tm)
    for _ in range(3):
        jm.time_step(1e-2)
        tm.time_step(1e-2)
    for name in ("u", "v", "w", "c", "p"):
        got = tm.field(name).interior.numpy()
        want = np.asarray(jm.field(name).interior)
        assert rel(got, want) <= 1e-10, name


def test_multiply_stretched_raises():
    """Two stretched axes take JAX's conjugate-gradient solver (since item
    11c the port's too): the model and the solver selection build
    ``make_variable_spacing_poisson_solver``, whose solve of a compatible
    rhs matches the JAX model's at 1e-6 (both at their default
    tolerance)."""
    from oceananigans_tpu_torch.models.nonhydrostatic import \
        select_pressure_solver
    spec = dict(size=(8, 8, 8), x=faces(8, 1.0), y=(0, 1.0),
                z=faces(8, 1.0, -1.0), topology=(B, P, B))
    grid = ot.RectilinearGrid(dtype=F64, device="cpu", **spec)
    assert grid.stretched_axes == (0, 2)
    b = np.random.default_rng(0).standard_normal((8, 8, 8))
    want = np.asarray(JModel(grid=jo.RectilinearGrid(dtype=np.float64,
                                                     **spec))
                      .pressure_solver.solve(jnp.asarray(b)))
    for solver in (NonhydrostaticModel(grid).pressure_solver,
                   select_pressure_solver(grid)):
        assert solver.preconditioner is not None
        got = solver.solve(torch.as_tensor(b)).numpy()
        assert rel(got, want) <= 1e-6
