"""The port's FFT/DCT Poisson solver against the JAX package's, and its
residual.

Bounds:
- against JAX, 1e-12 relative to max|φ|: both solve exactly in float64 (the
  JAX CPU path through matmul DFTs, the port through torch.fft), so they
  differ by transform roundoff only;
- residual |∇²φ − (b − mean b)|, 1e-10 relative to max|b|: the discrete
  Laplacian of the solution reproduces the zero-mean source to roundoff
  amplified by the eigenvalue range (about N² for these sizes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.solvers.fft_poisson import \
    FFTPoissonSolver as JSolver
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.solvers import (FFTPoissonSolver, dct2_matrix,
                                            idct2_matrix, poisson_eigenvalues)
from oceananigans_tpu.solvers import transforms as jtransforms
from oceananigans_tpu.solvers.fft_poisson import \
    poisson_eigenvalues as j_poisson_eigenvalues

torch.set_num_threads(1)

SIZES = [(8, 8, 16), (16, 16, 128)]
EXTENT = (1.0, 2.0, 0.5)


def _laplacian(phi, extent):
    """Discrete Laplacian: periodic x/y, Neumann (even mirror) z."""
    N = phi.shape
    d = [L / n for L, n in zip(extent, N)]
    lap = (np.roll(phi, -1, 0) - 2 * phi + np.roll(phi, 1, 0)) / d[0] ** 2
    lap += (np.roll(phi, -1, 1) - 2 * phi + np.roll(phi, 1, 1)) / d[1] ** 2
    ext = np.concatenate([phi[..., :1], phi, phi[..., -1:]], axis=2)
    lap += (ext[..., 2:] - 2 * phi + ext[..., :-2]) / d[2] ** 2
    return lap


@pytest.mark.parametrize("N", SIZES)
def test_solve_matches_jax(N):
    b = np.random.default_rng(3).standard_normal(N)
    want = np.asarray(JSolver(JGrid(size=N, extent=EXTENT, halo=(4, 4, 0),
                                    dtype=np.float64)).solve(jnp.asarray(b)))
    grid = ot.RectilinearGrid(size=N, extent=EXTENT, halo=(4, 4, 0),
                              dtype=torch.float64, device="cpu")
    got = FFTPoissonSolver(grid).solve(torch.as_tensor(b)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize("N", SIZES)
def test_residual(N):
    b = np.random.default_rng(4).standard_normal(N)
    grid = ot.RectilinearGrid(size=N, extent=EXTENT, halo=(4, 4, 0),
                              dtype=torch.float64, device="cpu")
    phi = FFTPoissonSolver(grid).solve(torch.as_tensor(b)).numpy()
    res = _laplacian(phi, EXTENT) - (b - b.mean())
    assert np.max(np.abs(res)) <= 1e-10 * np.max(np.abs(b))
    assert abs(phi.mean()) <= 1e-12 * np.max(np.abs(phi))


@pytest.mark.parametrize("n", [1, 8, 128])
def test_transforms_and_eigenvalues(n):
    assert np.array_equal(dct2_matrix(n), jtransforms.dct2_matrix(n))
    assert np.array_equal(idct2_matrix(n), jtransforms.idct2_matrix(n))
    for topo in ("periodic", "bounded", "flat"):
        assert np.array_equal(poisson_eigenvalues(n, 2.0, topo),
                              j_poisson_eigenvalues(n, 2.0, topo))
