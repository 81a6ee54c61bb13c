"""FFT-based Poisson solver on fully-regular grids.

Counterpart of ``oceananigans_tpu/solvers/fft_poisson.py``: solve ∇²φ = b by a
forward transform — a DCT-II along Bounded dims (matmul with ``dct2_matrix``),
a real FFT along the first Periodic dim, a complex FFT along the others —,
the eigenvalue division φ̂ = -b̂/(λx+λy+λz), the zero-mode fix φ̂[0,0,0] = 0,
and the inverse transforms. Eigenvalues:

    Periodic: λ[k] = (2 sin(kπ/N)  · N/L)²,  k = 0…N-1
    Bounded:  λ[k] = (2 sin(kπ/2N) · N/L)²

The solver works on INTERIOR tensors (no halos), z contiguous. The DCT is a
matmul along z, which is the only DCT axis supported here. TF32 is switched
off for it: the transform must be full float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from .transforms import apply_along_last, dct2_matrix, idct2_matrix


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


class FFTPoissonSolver:
    """Eigenfunction solver for ∇²φ = b on an all-regular RectilinearGrid
    with periodic x and y and a bounded (or flat) z."""

    def __init__(self, grid):
        if not grid.all_regular:
            raise ValueError("FFTPoissonSolver requires regular spacing")
        if grid.topology[0] != PERIODIC or grid.topology[1] != PERIODIC \
                or grid.topology[2] not in (BOUNDED, FLAT):
            raise NotImplementedError(
                "the port's FFT solver covers periodic x/y with a bounded z: "
                "ROADMAP.md queue 1 item 11 (other solver configurations)")
        self.grid = grid
        lam = np.zeros((1, 1, 1))
        self._dct_axes = []
        self._fft_axes = []
        for axis in range(3):
            topo = grid.topology[axis]
            if topo == FLAT:
                continue
            shape = [1, 1, 1]
            shape[axis] = grid.N[axis]
            lam = lam + poisson_eigenvalues(grid.N[axis], grid.extent[axis],
                                            topo).reshape(shape)
            (self._fft_axes if topo == PERIODIC
             else self._dct_axes).append(axis)
        self.eigenvalues = lam
        Nx = grid.N[0]
        # the real FFT along x keeps the half spectrum 0..Nx//2
        lam_half = np.broadcast_to(lam, (Nx,) + lam.shape[1:])[:Nx // 2 + 1]
        kw = dict(dtype=grid.dtype, device=grid.device)
        self._lam = torch.as_tensor(np.array(lam_half), **kw)
        self._denom = torch.where(self._lam == 0,
                                  torch.ones_like(self._lam), self._lam)
        self._zero_mode = self._lam == 0
        if self._dct_axes:
            Nz = grid.N[2]
            self._dct = torch.as_tensor(dct2_matrix(Nz), **kw)
            self._idct = torch.as_tensor(idct2_matrix(Nz), **kw)
        if grid.device.type == "cuda":
            disable_tf32()

    def solve(self, b):
        """Solve ∇²φ = b for the interior tensor b (shape grid.N); returns
        the interior φ with zero mean, in b's dtype."""
        Nx = b.shape[0]
        bh = b
        if self._dct_axes:
            bh = apply_along_last(bh, self._dct)
        bh = torch.fft.rfft(bh, dim=0)
        bh = torch.fft.fft(bh, dim=1)
        ph = -bh / self._denom
        ph = torch.where(self._zero_mode, torch.zeros_like(ph), ph)
        ph = torch.fft.ifft(ph, dim=1)
        ph = torch.fft.irfft(ph, n=Nx, dim=0)
        if self._dct_axes:
            ph = apply_along_last(ph.contiguous(), self._idct)
        return ph.to(b.dtype).contiguous()
