"""Preconditioned conjugate gradients and the conjugate-gradient Poisson
solvers.

Under a device mesh each shard runs the iteration on its own block: the
dot products are sums over the block combined by the mesh's ``all_reduce``
(``shard``: a ``parallel.distributed.Shard``), so every shard reads the same
norm on the host and takes the same number of iterations; the operator's
fill ends with the halo exchange, and the preconditioner is the pencil
solver's block entry. The first shard alone records the iterations and
norms.

Counterpart of ``oceananigans_tpu/solvers/conjugate_gradient.py``:
``conjugate_gradient`` is the same iteration on tensors. The JAX loop is a
``lax.while_loop`` on the residual norm; here a Python loop reads the norm on
the host each iteration (one device-to-host copy of a scalar an iteration,
``conjugate_gradient.syncs`` counts them; ``.iterations`` and
``.residuals`` keep each solve's iterations and final residual over ‖b‖).
``ConjugateGradientPoissonSolver`` solves with a user operator;
``VolumeScaledPoissonSolver`` scales the right-hand side by -V first (the
variable-spacing solver's); ``make_immersed_poisson_solver`` builds the
``ImmersedPoissonSolver`` of an ``ImmersedBoundaryGrid``: the finite-volume
Laplacian in flux form, -Σ δ(A·m·∂p) with the fluid mask m of each face (no flux through the
topography), identity rows on solid cells, the right-hand side scaled by the
cell volume V, and the regular-grid FFT solver as the preconditioner when
the underlying grid is regular. The flux form (no 1/V) keeps the operator
symmetric in the plain dot product where partial cells make V vary.
"""

from __future__ import annotations

import collections
import math

import torch

from ..grids.topology import CENTER, FACE, LOC_CCC


def conjugate_gradient(A, b, x0=None, preconditioner=None, reltol=1e-7,
                       abstol=0.0, maxiter=500, shard=None):
    """Solve A(x) = b. ``A`` and ``preconditioner`` are callables from a
    tensor to a tensor of its shape. Returns (x, iterations, the residual
    norm as a float). With ``shard`` the tensors are the shard's blocks and
    the dot products are summed over the mesh."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = preconditioner if preconditioner is not None else (lambda r: r)
    leader = shard is None or shard.rank == 0

    def dot(u, v):
        local = torch.sum(u * v)
        return local if shard is None else shard.all_reduce(local)

    def norm(r):
        if leader:
            conjugate_gradient.syncs += 1
        return math.sqrt(dot(r, r).item())

    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    bnorm = norm(b)
    tol = max(reltol * bnorm, abstol)
    it = 0
    while it < maxiter and norm(r) > tol:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
    res = math.sqrt(dot(r, r).item())
    if leader:
        conjugate_gradient.iterations.append(it)
        conjugate_gradient.residuals.append(res / bnorm if bnorm else 0.0)
    return x, it, res


conjugate_gradient.syncs = 0        # host reads of a norm
# the iterations and the final residual norms over ‖b‖ of the latest solves
# (bounded: a long run solves millions of times)
conjugate_gradient.iterations = collections.deque(maxlen=4096)
conjugate_gradient.residuals = collections.deque(maxlen=4096)


class ConjugateGradientPoissonSolver:
    """CG Poisson solve with a user ``operator`` (interior tensor to
    interior tensor) and an optional ``preconditioner``: the right-hand side
    and the solution have their means removed (the Neumann
    compatibility)."""

    def __init__(self, grid, operator, preconditioner=None, reltol=1e-7,
                 maxiter=200, shard=None):
        self.grid = grid
        self.operator = operator
        self.preconditioner = preconditioner
        self.reltol = reltol
        self.maxiter = maxiter
        self.shard = shard

    def _mean(self, x):
        if self.shard is None:
            return torch.mean(x)
        return self.shard.all_reduce(torch.sum(x)) / (
            x.numel() * self.shard.comm.size)

    def solve(self, b):
        x = self.iterate(b - self._mean(b))
        return x - self._mean(x)

    def iterate(self, b):
        """``conjugate_gradient``'s solution of operator(x) = b."""
        return conjugate_gradient(self.operator, b,
                                  preconditioner=self.preconditioner,
                                  reltol=self.reltol, maxiter=self.maxiter,
                                  shard=self.shard)[0]


class VolumeScaledPoissonSolver(ConjugateGradientPoissonSolver):
    """The flux-form solve of ∇²p = b: the right-hand side scaled by -V (a
    scalar or a tensor over the interior) before the means are removed."""

    def __init__(self, grid, operator, V, preconditioner=None, reltol=1e-7,
                 maxiter=200, shard=None):
        super().__init__(grid, operator, preconditioner, reltol, maxiter,
                         shard)
        self.V = V

    def solve(self, b):
        return super().solve(-b * self.V)


class ImmersedPoissonSolver(VolumeScaledPoissonSolver):
    """The immersed solve: b scaled by -V and zero on the ``solid`` cells,
    whose rows are the identity; no mean is removed (JAX's), as the mean
    would put a value on the solid rows."""

    def __init__(self, grid, operator, V, solid, preconditioner=None,
                 reltol=1e-7, maxiter=200, shard=None):
        super().__init__(grid, operator, V, preconditioner, reltol, maxiter,
                         shard)
        self.solid = solid

    def solve(self, b):
        return self.iterate(torch.where(
            self.solid, torch.zeros((), dtype=b.dtype, device=b.device),
            -b * self.V))


def _face_loc(axis):
    return tuple(FACE if a == axis else CENTER for a in range(3))


def _region(grid, axis, lo, hi):
    """The interior slices with ``axis`` running over padded [lo, hi)."""
    out = list(grid.interior_slices)
    out[axis] = slice(lo, hi)
    return tuple(out)


def _cut(grid, m, slices):
    """A metric (a Python scalar or a padded-broadcastable tensor) at the
    padded ``slices``, contiguous."""
    if not isinstance(m, torch.Tensor) or m.ndim == 0:
        return m
    return m.broadcast_to(grid.padded_shape)[slices].contiguous()


class FluxLaplacian:
    """-Σ δ(A·m·∂p) over the interior of ``grid`` in flux form (no 1/V),
    as the JAX operators form it: ``(A·m)·(δp/Δ)`` at the N + 1 faces of
    each axis that is not flat, differenced and summed in axis order.
    ``masks`` gives each face's fluid mask (None: no mask). ``fill_p``
    fills the halos of the padded p in place; the padded buffer is kept
    between calls (its interior rewritten, its halos refilled)."""

    def __init__(self, grid, fill_p, masks=None):
        self.grid = grid
        self.fill_p = fill_p
        self.terms = []
        for axis in range(3):
            if grid.is_flat(axis):
                continue
            H, N = grid.H[axis], grid.N[axis]
            loc = _face_loc(axis)
            faces = _region(grid, axis, H, H + N + 1)
            A = (grid.Ax, grid.Ay, grid.Az)[axis](loc)
            if masks is not None:
                A = A * masks[axis]
            spacing = (grid.dx, grid.dy, grid.dz)[axis](loc)
            self.terms.append((axis, _cut(grid, A, faces),
                               _cut(grid, spacing, faces),
                               _region(grid, axis, H - 1, H + N)))
        self._p = None

    def padded(self, p_int):
        """The padded p with ``p_int`` in its interior and its halos
        filled."""
        if self._p is None or self._p.dtype != p_int.dtype:
            self._p = torch.zeros(self.grid.padded_shape, dtype=p_int.dtype,
                                  device=p_int.device)
        self._p[self.grid.interior_slices] = p_int
        self.fill_p(self._p)
        return self._p

    def __call__(self, p_int):
        """-∇·(A m ∇p) of an interior tensor (shape grid.N)."""
        p = self.padded(p_int)
        lap = None
        for axis, Am, spacing, below in self.terms:
            N = self.grid.N[axis]
            upper = _region(self.grid, axis, below[axis].start + 1,
                            below[axis].stop + 1)
            flux = Am * ((p[upper] - p[below]) / spacing)
            term = flux.narrow(axis, 1, N) - flux.narrow(axis, 0, N)
            lap = term if lap is None else lap + term
        return -lap


def fft_preconditioner(fft_solver):
    """``r ↦ -φ`` with ∇²φ = r / V on the FFT solver's regular grid: the
    inverse of the flux-form operator's regular-grid twin."""
    Vr = fft_solver.grid.V(LOC_CCC)

    def precond(r):
        return -fft_solver.solve(r / Vr)

    return precond


def make_immersed_poisson_solver(grid, fill_p, fft_solver=None, reltol=1e-7,
                                 maxiter=200):
    """The CG Poisson solver of an ``ImmersedBoundaryGrid`` (the JAX
    function's): the masked flux-form Laplacian, identity rows on solid
    cells, b scaled by -V and zero on solid cells; preconditioned by
    ``fft_solver`` (the underlying regular grid's) when given. ``fill_p``
    fills a padded pressure's halos in place. On a shard's grid the dot
    products are summed over the mesh and ``fft_solver`` is the shard's
    view of the pencil solver."""
    masks = [grid.fluid_mask(_face_loc(axis)) for axis in range(3)]
    lap = FluxLaplacian(grid, fill_p, masks)
    ii = grid.interior_slices
    solid = torch.as_tensor(grid.solid_ccc[ii], device=grid.device)
    V = _cut(grid, grid.V(LOC_CCC), ii)
    precond = None if fft_solver is None else fft_preconditioner(fft_solver)

    def operator(p_int):
        return torch.where(solid, p_int, lap(p_int))

    return ImmersedPoissonSolver(grid, operator, V, solid, precond, reltol,
                                 maxiter, getattr(grid, "shard", None))
