"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)

Float64 fields with float64 WENO smoothness at (16, 16, 32); bound 1e-12
relative to max|plain|: the kernels evaluate the same stencils with FMA
contraction and in another association order, which is roundoff. The halo
fill copies, so it must agree exactly."""

import pytest
import torch

import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K

torch.set_num_threads(1)

TOL = 1e-12
N = (16, 16, 32)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=(4, 4, 0),
                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    u, v, w, p = (0.1 * torch.randn(grid.padded_shape, generator=gen,
                                    dtype=torch.float64, device="cuda")
                  for _ in range(4))
    K.periodic_halo_fill(grid, [u, v, w, p])
    Gm = [torch.randn(N, generator=gen, dtype=torch.float64, device="cuda")
          for _ in range(3)]
    return grid, u, v, w, p, Gm


def _close(got, want):
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL * b.abs().max().item()


@pytest.mark.parametrize("with_gm", [False, True])
@pytest.mark.parametrize("with_corr", [False, True])
def test_fused_advection_update(inputs, with_gm, with_corr):
    grid, u, v, w, p, Gm = inputs
    scheme = ot.WENO(5, smoothness_dtype=torch.float64)
    args = (grid, scheme, u, v, w, Gm if with_gm else None, 0.1, -0.05,
            p if with_corr else None, 0.07 if with_corr else None)
    Gk, nk = K.fused_advection_update(*args)
    Gp, np_ = K.fused_advection_update_plain(*args)
    _close(Gk + list(nk.values()), Gp + list(np_.values()))


def test_fused_divergence(inputs):
    grid, u, v, w, _, _ = inputs
    _close([K.fused_divergence(grid, u, v, w, 2.0)],
           [K.fused_divergence_plain(grid, u, v, w, 2.0)])


def test_fused_correct(inputs):
    grid, u, v, w, p, _ = inputs
    _close(K.fused_correct(grid, p, u, v, w, 0.3),
           K.fused_correct_plain(grid, p, u, v, w, 0.3))


def test_periodic_halo_fill(inputs):
    grid = inputs[0]
    a = torch.randn(grid.padded_shape, dtype=torch.float64, device="cuda")
    b = a.clone()
    K.periodic_halo_fill(grid, [a])
    K.periodic_halo_fill_plain(grid, [b])
    assert torch.equal(a, b)
