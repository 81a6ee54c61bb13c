"""FFT-based Poisson solver on fully-regular grids.

Counterpart of ``oceananigans_tpu/solvers/fft_poisson.py``: solve ∇²φ = b on
any combination of Periodic, Bounded and Flat axes by a forward transform —
a DCT-II along each Bounded axis (a full-float32 matmul with
``dct2_matrix``), a real FFT along the first Periodic axis, a complex FFT
along the others —, the eigenvalue division φ̂ = -b̂/(λx+λy+λz), the
zero-mode fix φ̂[λ = 0] = 0, and the inverse transforms in reverse order,
the DCT axes last. Eigenvalues:

    Periodic: λ[k] = (2 sin(kπ/N)  · N/L)²,  k = 0…N-1
    Bounded:  λ[k] = (2 sin(kπ/2N) · N/L)²
    Flat:     λ = 0 (the axis is skipped)

The solver works on INTERIOR tensors (no halos), z contiguous. The JAX
package's matmul DFT path (``_use_matmul_dft``) is a TPU workaround and is
not ported: the periodic axes go through ``torch.fft`` (cuFFT on the card).
TF32 is switched off for the DCT matmuls: the transform must be full
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from .transforms import apply_matrix_along, dct2_matrix, idct2_matrix


def poisson_eigenvalues(N, L, topology):
    k = np.arange(N)
    if topology == PERIODIC:
        return (2 * np.sin(k * np.pi / N) * N / L) ** 2
    if topology == BOUNDED:
        return (2 * np.sin(k * np.pi / (2 * N)) * N / L) ** 2
    return np.zeros(N)


def disable_tf32():
    """Full-precision float32 matmuls and convolutions on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def transform_plan(grid, skip=None):
    """The eigenvalues λ (a broadcastable (1|N, 1|N, 1|N) float64 array)
    and the transformed axes of ``grid`` but ``skip``: the Bounded ones (the
    DCT axes) and the Periodic ones (the FFT axes), each in axis order;
    Flat axes take no transform."""
    lam = np.zeros((1, 1, 1))
    dct_axes, fft_axes = [], []
    for axis in range(3):
        topo = grid.topology[axis]
        if axis == skip or topo == FLAT:
            continue
        shape = [1, 1, 1]
        shape[axis] = grid.N[axis]
        lam = lam + poisson_eigenvalues(grid.N[axis], grid.extent[axis],
                                        topo).reshape(shape)
        (fft_axes if topo == PERIODIC else dct_axes).append(axis)
    return lam, dct_axes, fft_axes


def dct_matrices(grid, axes):
    """{axis: (DCT-II, its inverse)} as tensors of the grid's dtype on its
    device."""
    kw = dict(dtype=grid.dtype, device=grid.device)
    return {ax: (torch.as_tensor(dct2_matrix(grid.N[ax]), **kw),
                 torch.as_tensor(idct2_matrix(grid.N[ax]), **kw))
            for ax in axes}


class FFTPoissonSolver:
    """Eigenfunction solver for ∇²φ = b on an all-regular RectilinearGrid
    of any topology."""

    def __init__(self, grid):
        if not grid.all_regular:
            raise ValueError(
                "FFTPoissonSolver requires regular spacing in every "
                "direction (use FourierTridiagonalPoissonSolver for one "
                "stretched direction)")
        self.grid = grid
        lam, self._dct_axes, self._fft_axes = transform_plan(grid)
        self.eigenvalues = lam
        self._rfft_axis = self._fft_axes[0] if self._fft_axes else None
        if self._rfft_axis is not None:
            # the real FFT keeps the half spectrum 0..N//2 along its axis
            ax, n = self._rfft_axis, grid.N[self._rfft_axis]
            full = list(lam.shape)
            full[ax] = n
            sl = [slice(None)] * 3
            sl[ax] = slice(0, n // 2 + 1)
            lam = np.broadcast_to(lam, full)[tuple(sl)]
        kw = dict(dtype=grid.dtype, device=grid.device)
        self._lam = torch.as_tensor(np.array(lam), **kw)
        self._denom = torch.where(self._lam == 0,
                                  torch.ones_like(self._lam), self._lam)
        self._zero_mode = self._lam == 0
        self._dct = dct_matrices(grid, self._dct_axes)
        if grid.device.type == "cuda":
            disable_tf32()

    def solve(self, b):
        """Solve ∇²φ = b for the interior tensor b (shape grid.N); returns
        the interior φ (zero mean where a λ = 0 mode exists), in b's
        dtype."""
        bh = b
        for axis in self._dct_axes:
            bh = apply_matrix_along(bh, self._dct[axis][0], axis)
        if self._rfft_axis is not None:
            bh = torch.fft.rfft(bh, dim=self._rfft_axis)
        for axis in self._fft_axes[1:]:
            bh = torch.fft.fft(bh, dim=axis)
        ph = -bh / self._denom
        ph = torch.where(self._zero_mode, torch.zeros_like(ph), ph)
        for axis in reversed(self._fft_axes[1:]):
            ph = torch.fft.ifft(ph, dim=axis)
        if self._rfft_axis is not None:
            ph = torch.fft.irfft(ph, n=b.shape[self._rfft_axis],
                                 dim=self._rfft_axis)
        for axis in reversed(self._dct_axes):
            ph = apply_matrix_along(ph.contiguous(), self._dct[axis][1], axis)
        return ph.to(b.dtype).contiguous()
