"""Pencil-decomposed distributed Poisson solvers.

Counterpart of ``oceananigans_tpu/parallel/pencil_fft.py``
(``DistributedFFTPoissonSolver`` and its alias
``DistributedFourierTridiagonalPoissonSolver``): ∇²φ = b for an interior
field cut into P x-slabs over a mesh's P devices (P the flattened mesh),
by the JAX slab algorithm, making one direction local at a time:

    transform(z, y local) → all_to_all y↔x → FFT(x) → zsolve →
    IFFT(x) → all_to_all x↔y → inverse transforms(y, z)

``zsolve`` is the eigen-divide for a flat, periodic or regular bounded z
(the bounded z by the DCT-II, a full-precision matmul along the local z),
or, on a stretched bounded z, the batched Thomas sweep of every (kx, ky)
column with the singular mode's row 0 pinned, as JAX's (the serial
``FourierTridiagonalPoissonSolver`` pins the same row and then removes the
Δz-weighted mean: the two differ by a constant), its coefficients formed
in float64 and rounded once, as the serial solver forms them. z is never
sharded, so its transforms and
its solve are local. The transforms run in complex form along y and then x
(the serial ``FFTPoissonSolver`` takes a real FFT along x first), so the
two solvers agree to rounding, not bit for bit.

The collectives are those of ``parallel/communicator.py``: every
``all_to_all`` is one meeting of the shards. ``solve(b)`` takes and returns
a global interior tensor, as JAX's ``solve`` does: it cuts b into slabs,
runs the slab algorithm on every shard's thread and puts φ back together
on b's device. The models call ``solve_block`` from each shard's thread: on
an (Sx, Sy) mesh of resident blocks it first re-blocks them into x-slabs
over all Sx·Sy devices (``to_slabs``: an all_to_all within each mesh row)
and re-blocks φ back after (``from_slabs``). The JAX package's
transposes are XLA collectives, not Pallas kernels; here plain PyTorch
copies and ``torch.fft`` serve them.

Refusals, as JAX's: x and y must be periodic or flat (a bounded one raises
``NotImplementedError``), and P must divide Nx and Ny (``ValueError``). A
stretched x or y raises ``NotImplementedError`` (ROADMAP.md item 16b).
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.topology import BOUNDED, PERIODIC
from ..solvers.fft_poisson import disable_tf32, poisson_eigenvalues
from ..solvers.fourier_tridiagonal import stretched_spacings
from ..solvers.transforms import (apply_matrix_along, dct2_matrix,
                                  idct2_matrix)
from ..solvers.tridiagonal import solve_batched_tridiagonal
from .distributed import Distributed, Mesh


def _as_mesh(mesh):
    """A ``Mesh`` from a ``Mesh``, a ``Distributed`` or a list of devices
    (a 1-D mesh of slabs)."""
    if isinstance(mesh, Distributed):
        return mesh.mesh
    if isinstance(mesh, Mesh):
        return mesh
    devices = np.empty(len(mesh), dtype=object)
    devices[:] = [torch.device(d) for d in mesh]
    return Mesh(devices.reshape(-1, 1))


class DistributedFFTPoissonSolver:
    """Solve ∇²φ = b for an interior field cut into x-slabs over the P
    devices of ``mesh`` (a ``Mesh``, a ``Distributed`` architecture or a
    list of devices).

    x and y must be Periodic (or Flat); z may be Periodic, Flat,
    Bounded-regular (local DCT), or Bounded-stretched (local tridiagonal
    solve — the distributed Fourier-tridiagonal variant). Nx % P == 0,
    Ny % P == 0. ``axis_name`` is accepted for the JAX call shape; the
    slabs run over the whole mesh."""

    def __init__(self, grid, mesh, axis_name="x"):
        for i in (0, 1):
            if not (grid.topology[i] == PERIODIC or grid.is_flat(i)):
                raise NotImplementedError(
                    "pencil solver requires periodic horizontal dims")
            if not grid.is_flat(i) and not grid.regular(i):
                raise NotImplementedError(
                    "the pencil solver on a stretched horizontal axis: "
                    "ROADMAP.md queue 1 item 16b")
        self.grid = grid
        self.mesh = _as_mesh(mesh)
        self.axis_name = axis_name
        self.devices = list(self.mesh.devices.ravel())
        self.P = len(self.devices)
        nx, ny, nz = grid.N
        if nx % self.P or ny % self.P:
            raise ValueError(
                f"the mesh size {self.P} must divide Nx={nx} and Ny={ny} "
                "(reference analogue: distributed_fft_based_poisson_solver.jl"
                ":80-91 divisibility constraints)")
        self.comm = self.mesh.communicator

        if grid.is_flat(2):
            self.z_kind = "flat"
        elif grid.topology[2] == PERIODIC:
            self.z_kind = "periodic"
        elif grid.regular(2):
            self.z_kind = "dct"
        else:
            self.z_kind = "tridiagonal"

        lam = np.zeros((1, 1, 1))
        for axis in range(3):
            if grid.is_flat(axis) or (axis == 2 and
                                      self.z_kind == "tridiagonal"):
                continue
            N, L = grid.N[axis], grid.extent[axis]
            topo = PERIODIC if grid.topology[axis] == PERIODIC else BOUNDED
            sh = [1, 1, 1]
            sh[axis] = N
            lam = lam + poisson_eigenvalues(N, L, topo).reshape(sh)
        self.eigenvalues = lam

        if self.z_kind == "tridiagonal":
            n = grid.N[2]
            dzc, dzf = stretched_spacings(grid, 2)
            lower = 1.0 / dzf[:n]
            upper = 1.0 / dzf[1:n + 1]
            lower[0] = 0.0
            upper[-1] = 0.0
            self._dzc, self._lower, self._upper = dzc, lower, upper
        self._consts = {}
        if any(d.type == "cuda" for d in self.devices):
            disable_tf32()

    # -- per-shard constants -----------------------------------------------------

    def _constants(self, rank, dtype, device):
        """The eigenvalues of slab ``rank`` in the transposed (x-local,
        y-slab) layout and the z operators, as tensors of ``dtype`` on
        ``device``, made once."""
        key = (rank, dtype, str(device))
        out = self._consts.get(key)
        if out is not None:
            return out
        kw = dict(dtype=dtype, device=device)
        ny = self.grid.N[1] // self.P
        lam = self.eigenvalues
        if lam.shape[1] > 1:
            lam = lam[:, rank * ny:(rank + 1) * ny]
        out = {"lam": torch.as_tensor(np.ascontiguousarray(lam), **kw)}
        nz = self.grid.N[2]
        if self.z_kind == "dct":
            out["dct"] = torch.as_tensor(dct2_matrix(nz), **kw)
            out["idct"] = torch.as_tensor(idct2_matrix(nz), **kw)
        elif self.z_kind == "tridiagonal":
            # the coefficients are formed in float64 and rounded once, as
            # the serial FourierTridiagonalPoissonSolver forms them: formed
            # in float32, -(lower + upper) - Δz·λ rounds twice, and the
            # sweep of the near-singular modes amplified that to 2.4 times
            # the serial solver's float32 error; row 0 of the singular mode
            # is pinned (φ[0] = 0)
            singular = lam[..., 0] == 0
            diag = -(self._lower + self._upper) - self._dzc * lam
            diag[..., 0] = np.where(singular, 1.0, diag[..., 0])
            up = np.broadcast_to(self._upper, diag.shape).copy()
            up[..., 0] = np.where(singular, 0.0, up[..., 0])
            out.update(diag=torch.as_tensor(diag, **kw),
                       up=torch.as_tensor(up, **kw),
                       lower=torch.as_tensor(self._lower, **kw),
                       dzc=torch.as_tensor(self._dzc, **kw),
                       singular=torch.as_tensor(singular,
                                                device=device))
        self._consts[key] = out
        return out

    def _zsolve(self, bh, c):
        """Eigen-divide (flat, periodic or DCT z) or the vertical
        tridiagonal solve, in the (x-local, y-slab) layout."""
        lam = c["lam"]
        if self.z_kind != "tridiagonal":
            zero = lam == 0
            denom = torch.where(zero, torch.ones_like(lam), lam)
            ph = -bh / denom
            return torch.where(zero, torch.zeros_like(ph), ph)
        rhs = bh * c["dzc"]
        rhs[..., 0] = torch.where(c["singular"], torch.zeros_like(rhs[..., 0]),
                                  rhs[..., 0])
        return solve_batched_tridiagonal(c["lower"], c["diag"], c["up"], rhs)

    # -- the slab algorithm --------------------------------------------------

    def solve_slab(self, rank, b):
        """φ on slab ``rank``: ``b`` is the (Nx/P, Ny, Nz) interior slab of
        x-cells rank·Nx/P .. (rank + 1)·Nx/P on this shard's device; called
        from every shard's thread (two ``all_to_all`` meetings)."""
        comm = self.comm
        P = self.P
        nx, ny = self.grid.N[0] // P, self.grid.N[1] // P
        c = self._constants(rank, b.dtype, b.device)
        x = b
        if self.z_kind == "dct":
            x = apply_matrix_along(x, c["dct"], 2)
        bh = torch.fft.fft(x, dim=1)
        if self.z_kind == "periodic":
            bh = torch.fft.fft(bh, dim=2)
        # transpose x↔y: gather x, cut y
        got = comm.all_to_all(rank, [bh[:, t * ny:(t + 1) * ny]
                                     for t in range(P)])
        bh = torch.fft.fft(torch.cat(got, dim=0), dim=0)
        ph = torch.fft.ifft(self._zsolve(bh, c), dim=0)
        # back to x-slabs
        got = comm.all_to_all(rank, [ph[t * nx:(t + 1) * nx]
                                     for t in range(P)])
        ph = torch.fft.ifft(torch.cat(got, dim=1), dim=1)
        if self.z_kind == "periodic":
            ph = torch.fft.ifft(ph, dim=2)
        ph = ph.real
        if self.z_kind == "dct":
            ph = apply_matrix_along(ph.contiguous(), c["idct"], 2)
        return ph.to(b.dtype).contiguous()

    def solve(self, b):
        """b: the global interior tensor (Nx, Ny, Nz); returns φ on b's
        device. The slabs go to the mesh's devices and every shard runs
        the slab algorithm."""
        P, w = self.P, self.grid.N[0] // self.P
        if tuple(b.shape) != tuple(self.grid.N):
            raise ValueError(f"b has shape {tuple(b.shape)}; the grid's "
                             f"interior is {self.grid.N}")
        slabs = [b[s * w:(s + 1) * w].to(d, copy=True) for s, d in
                 enumerate(self.devices)]
        out = self.comm.run(lambda r: self.solve_slab(r, slabs[r]))
        return torch.cat([o.to(b.device) for o in out], dim=0)

    # -- resident (Sx, Sy) blocks ------------------------------------------------

    def to_slabs(self, rank, block):
        """The x-slab of shard ``rank`` from the mesh's (nlx, nly, Nz)
        blocks: slab i·Sy + k takes the k-th x-range of Nx/P cells of every
        block of mesh row i (an all_to_all within each row; nothing moves
        on an (Sx, 1) mesh)."""
        comm = self.comm
        Sx, Sy = comm.mesh.devices.shape
        if Sy == 1:
            return block
        i = rank // Sy
        w = block.shape[0] // Sy
        pieces = [None] * self.P
        for k in range(Sy):
            pieces[i * Sy + k] = block[k * w:(k + 1) * w]
        got = comm.all_to_all(rank, pieces)
        return torch.cat([got[i * Sy + j] for j in range(Sy)], dim=1)

    def from_slabs(self, rank, slab):
        """The inverse of ``to_slabs``: shard ``rank``'s (nlx, nly, Nz)
        block from the x-slabs of its mesh row."""
        comm = self.comm
        Sx, Sy = comm.mesh.devices.shape
        if Sy == 1:
            return slab
        i = rank // Sy
        nly = slab.shape[1] // Sy
        pieces = [None] * self.P
        for j in range(Sy):
            pieces[i * Sy + j] = slab[:, j * nly:(j + 1) * nly]
        got = comm.all_to_all(rank, pieces)
        return torch.cat([got[i * Sy + k] for k in range(Sy)], dim=0)

    def solve_block(self, rank, b):
        """φ on shard ``rank``'s (nlx, nly, Nz) interior block of an
        (Sx, Sy) mesh of resident blocks (called from every shard's
        thread)."""
        slab = self.to_slabs(rank, b)
        return self.from_slabs(rank, self.solve_slab(rank, slab)).contiguous()


# reference naming parity (distributed_fft_tridiagonal_solver.jl)
DistributedFourierTridiagonalPoissonSolver = DistributedFFTPoissonSolver


class ShardPoissonSolver:
    """A shard's view of a ``DistributedFFTPoissonSolver``, the pressure
    solver of a model's shard: ``solve(b)`` takes and returns the shard's
    interior block (``solve_block``). ``grid`` is the shard's grid (the
    underlying one of an immersed grid, as the serial preconditioner's)."""

    def __init__(self, pencil, shard):
        self.pencil = pencil
        self.shard = shard
        self.grid = getattr(shard.grid, "underlying_grid", shard.grid)

    def solve(self, b):
        return self.pencil.solve_block(self.shard.rank, b)
