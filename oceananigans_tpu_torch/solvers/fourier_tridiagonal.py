"""Fourier-tridiagonal Poisson solver: FFT/DCT in the two regular
directions, a tridiagonal solve along the one stretched, bounded direction,
which may be x, y or z.

Counterpart of ``oceananigans_tpu/solvers/fourier_tridiagonal.py``
``FourierTridiagonalPoissonSolver``. For each transformed mode, multiplying
the ∇²φ = b rows by Δs_c(k) along the stretched axis s gives

    (1/Δs_f[k])   φ[k-1]
  - (1/Δs_f[k] + 1/Δs_f[k+1] + Δs_c[k](λ₁+λ₂)) φ[k]
  + (1/Δs_f[k+1]) φ[k+1]  =  Δs_c[k] b̂[k]

with Neumann (staggered) walls: the boundary couplings are dropped. The
singular (λ = 0) mode is pinned, φ[0] = 0 for that mode, and the solution's
volume mean, weighted by Δs_c, is removed at the end. The transforms follow
the JAX order: the DCT axes first, then a complex FFT along each periodic
axis; ``solve_batched_tridiagonal`` runs along the stretched axis, on the
real and imaginary parts of a complex spectrum. Grids stretched along more
than one axis, or along a periodic one, and curvilinear grids take
``make_variable_spacing_poisson_solver``, the JAX package's
conjugate-gradient solver with its FFT preconditioner.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.topology import BOUNDED, CENTER, FACE
from .fft_poisson import dct_matrices, disable_tf32, transform_plan
from .transforms import apply_matrix_along
from .tridiagonal import solve_batched_tridiagonal


def stretched_spacings(grid, s):
    """Δs at the interior centres (N,) and at the faces 0..N (N + 1,) of
    axis ``s``, float64 numpy (the padded face spacings extend one slot into
    the high halo)."""
    h, n = grid.H[s], grid.N[s]

    def prof(loc):
        m = np.asarray(grid.metric_numpy(("dx", "dy", "dz")[s], loc),
                       dtype=np.float64)
        return np.broadcast_to(m.reshape(-1), (grid.padded_shape[s],))

    loc_c = [CENTER] * 3
    loc_f = list(loc_c)
    loc_f[s] = FACE
    return (prof(tuple(loc_c))[h:h + n].copy(),
            prof(tuple(loc_f))[h:h + n + 1].copy())


class FourierTridiagonalPoissonSolver:
    def __init__(self, grid, stretched_axis):
        self.grid = grid
        self.s = s = int(stretched_axis)
        if grid.topology[s] != BOUNDED:
            raise NotImplementedError("the stretched direction must be "
                                      "Bounded (staggered Neumann walls)")
        for axis in range(3):
            if axis != s and not grid.is_flat(axis) and \
                    not grid.regular(axis):
                raise ValueError("the two transformed directions must be "
                                 "regular")
        lam, dct_axes, fft_axes = transform_plan(grid, skip=s)
        self.eigenvalues = lam
        self._dct_axes, self._fft_axes = dct_axes, fft_axes
        self._dct = dct_matrices(grid, dct_axes)
        dsc, dsf = stretched_spacings(grid, s)
        n = grid.N[s]
        # lower[k] couples φ[k-1]: 1/Δs_f[k]; upper[k] couples φ[k+1]
        lower = 1.0 / dsf[:n]
        upper = 1.0 / dsf[1:n + 1]
        lower[0] = 0.0     # Neumann: no coupling below the first cell
        upper[-1] = 0.0
        kw = dict(dtype=grid.dtype, device=grid.device)
        shape = [1, 1, 1]
        shape[s] = n

        def along(v):
            return v.reshape(shape)

        # the coefficients in the grid's layout; λ has size 1 along s
        first = tuple(slice(0, 1) if ax == s else slice(None)
                      for ax in range(3))
        singular = lam == 0
        diag = -along(lower + upper) - along(dsc) * lam
        up = np.broadcast_to(along(upper), diag.shape).copy()
        diag[first] = np.where(singular, 1.0, diag[first])
        up[first] = np.where(singular, 0.0, up[first])
        self._lower = torch.as_tensor(lower, **kw)
        self._diag = torch.as_tensor(diag, **kw)
        self._upper = torch.as_tensor(up, **kw)
        self._dsc = torch.as_tensor(along(dsc), **kw)
        self._keep0 = torch.as_tensor(~singular, **kw)
        self._weights = torch.as_tensor(dsc / dsc.sum(), **kw)
        if grid.device.type == "cuda":
            disable_tf32()

    def solve(self, b):
        """Solve ∇²φ = b for the interior tensor b (shape grid.N); returns
        the interior φ with zero Δs-weighted volume mean, in b's dtype."""
        s = self.s
        bh = b
        for axis in self._dct_axes:
            bh = apply_matrix_along(bh, self._dct[axis][0], axis)
        for axis in self._fft_axes:
            bh = torch.fft.fft(bh, dim=axis)
        rhs = bh * self._dsc
        # the pinned singular mode: φ[0] = 0
        n = rhs.shape[s]
        rhs = torch.cat([rhs.narrow(s, 0, 1) * self._keep0,
                         rhs.narrow(s, 1, n - 1)], dim=s)
        ph = solve_batched_tridiagonal(self._lower, self._diag, self._upper,
                                       rhs, axis=s)
        for axis in self._fft_axes:
            ph = torch.fft.ifft(ph, dim=axis)
        if ph.is_complex():
            ph = ph.real
        for axis in self._dct_axes:
            ph = apply_matrix_along(ph.contiguous(), self._dct[axis][1], axis)
        other = tuple(ax for ax in range(3) if ax != s)
        mean = torch.sum(ph.mean(dim=other) * self._weights)
        return (ph - mean).to(b.dtype).contiguous()


def regular_preconditioner_grid(grid):
    """The regular RectilinearGrid of ``grid``'s size, extent, topology and
    halo on which the JAX ``make_variable_spacing_poisson_solver`` builds
    its FFT preconditioner, or None where the JAX construction fails: a grid
    with a Flat axis (its ``RectilinearGrid(extent=grid.extent)`` takes an
    extent per non-flat axis and refuses the three it is given). Every other
    grid, curvilinear ones included (a lat-lon grid's extent is in degrees
    along x and y, as in JAX), gets one."""
    from ..grids.rectilinear import RectilinearGrid
    if any(grid.is_flat(axis) for axis in range(3)):
        return None
    return RectilinearGrid(size=grid.N, extent=grid.extent,
                           topology=grid.topology, halo=grid.H,
                           dtype=grid.dtype, device=grid.device)


def make_variable_spacing_poisson_solver(grid, fill_p=None, reltol=1e-8,
                                         maxiter=500, fft_solver=None):
    """The CG solver of a multiply stretched or curvilinear grid (the JAX
    function's): the flux-form finite-volume Laplacian without masks
    (the Neumann fill zeroes the gradient at bounded faces), b scaled by -V
    with its mean removed, the solution's mean removed, and the FFT
    preconditioner of ``regular_preconditioner_grid`` where JAX builds it.
    ``fill_p`` fills a padded pressure's halos in place (by default with
    the default conditions of a centre field). On a shard's grid the dot
    products and means are sums over the mesh and ``fft_solver`` (the
    shard's view of the pencil solver of the regular grid, or None) is the
    preconditioner's solve."""
    from ..boundary_conditions import (fill_halo_regions,
                                       regularize_field_boundary_conditions)
    from ..grids.topology import LOC_CCC
    from .conjugate_gradient import (FluxLaplacian, VolumeScaledPoissonSolver,
                                     _cut, fft_preconditioner)
    from .fft_poisson import FFTPoissonSolver

    if fill_p is None:
        bcs = regularize_field_boundary_conditions(None, grid, LOC_CCC)
        fill_p = lambda p: fill_halo_regions(p, grid, LOC_CCC, bcs)
    lap = FluxLaplacian(grid, fill_p)
    V = _cut(grid, grid.V(LOC_CCC), grid.interior_slices)
    shard = getattr(grid, "shard", None)
    if shard is None:
        reg = regular_preconditioner_grid(grid)
        precond = None if reg is None else fft_preconditioner(
            FFTPoissonSolver(reg))
    else:
        precond = None if fft_solver is None else fft_preconditioner(
            fft_solver, fft_solver.pencil.grid)

    return VolumeScaledPoissonSolver(grid, lap, V, precond, reltol, maxiter,
                                     shard)
