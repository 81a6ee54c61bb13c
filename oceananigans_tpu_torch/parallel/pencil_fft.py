"""Pencil-decomposed distributed Poisson solvers.

Counterpart of ``oceananigans_tpu/parallel/pencil_fft.py``
(``DistributedFFTPoissonSolver`` and its alias
``DistributedFourierTridiagonalPoissonSolver``): ∇²φ = b for an interior
field cut into P x-slabs over a mesh's P devices (P the flattened mesh),
by the JAX slab algorithm, making one direction local at a time:

    transform(z, y local) → all_to_all y↔x → transform(x) → zsolve →
    inverse(x) → all_to_all x↔y → inverse transforms(y, z)

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

A bounded x or y takes the serial solver's DCT-II along it (a
full-precision matmul with ``dct2_matrix``) where the axis is whole: y on
the x-slabs, x on the transposed slabs. JAX's pencil class takes periodic
x and y only; JAX's model on such a grid under GSPMD runs its serial
solver, which this matches to rounding. P must divide Nx and Ny
(``ValueError``).

A stretched bounded x or y (JAX's model runs its serial
``FourierTridiagonalPoissonSolver`` under GSPMD) takes the batched Thomas
sweep along it where it is whole: x on the transposed slabs (after the
transforms of y and z), y on the x-slabs (after the transform of x on the
transposed slabs: two more transposes). Its coefficients are formed from
the global spacings in float64 and rounded once; the singular mode's row 0
is pinned and the Δs-weighted mean removed (a sum over the mesh), as the
serial solver does: the two agree to rounding. A flat x or y (which the
mesh does not split) moves the slabs' cuts: the slabs cut the other
horizontal axis and the transposed slabs cut z (P must divide it).
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
    """Solve ∇²φ = b for an interior field cut into slabs over the P
    devices of ``mesh`` (a ``Mesh``, a ``Distributed`` architecture or a
    list of devices).

    x and y may be Periodic (FFT), Bounded (DCT), Bounded and stretched
    (the batched Thomas sweep along it) or Flat; z may be Periodic, Flat,
    Bounded-regular (local DCT), or Bounded-stretched (local tridiagonal
    solve — the distributed Fourier-tridiagonal variant); at most one axis
    is stretched. ``horizontal`` solves for (Nx, Ny, 1) fields over x and
    y alone (the implicit free surface, with its own spectral divide:
    ``solve_block``'s ``spectral``). The slabs cut x (y where x is flat);
    the transposed slabs cut y (z where y or x is flat): P divides both.
    ``axis_name`` is accepted for the JAX call shape; the slabs run over
    the whole mesh."""

    def __init__(self, grid, mesh, axis_name="x", horizontal=False):
        self.grid = grid
        self.horizontal = bool(horizontal)
        self.mesh = _as_mesh(mesh)
        self.axis_name = axis_name
        self.devices = list(self.mesh.devices.ravel())
        self.P = len(self.devices)
        nx, ny, nz = grid.N
        if nx % self.P or ny % self.P:
            if not (grid.is_flat(0) or grid.is_flat(1)):
                raise ValueError(
                    f"the mesh size {self.P} must divide Nx={nx} and "
                    f"Ny={ny} (reference analogue: distributed_fft_based_"
                    f"poisson_solver.jl:80-91 divisibility constraints)")
        self.comm = self.mesh.communicator
        self.N = (nx, ny, 1 if self.horizontal else nz)
        # the kind of every axis: "fft" (periodic), "dct" (bounded),
        # "tri" (bounded and stretched: the Thomas sweep) or None (flat)
        kinds = []
        for axis in range(3):
            if grid.is_flat(axis) or (axis == 2 and self.horizontal):
                kinds.append(None)
            elif grid.topology[axis] == PERIODIC:
                if not grid.regular(axis):
                    raise NotImplementedError(
                        "the pencil solver on a stretched periodic axis: the "
                        "variable-spacing CG solves it")
                kinds.append("fft")
            else:
                kinds.append("dct" if grid.regular(axis) else "tri")
        if kinds.count("tri") > 1:
            raise NotImplementedError(
                "the pencil solver on a grid stretched along several axes: "
                "the variable-spacing CG solves it")
        self.kinds = tuple(kinds)
        self.xy_kind = self.kinds[:2]
        self.z_kind = {None: "flat", "fft": "periodic", "dct": "dct",
                       "tri": "tridiagonal"}[self.kinds[2]]
        self.s = kinds.index("tri") if "tri" in kinds else None
        # the slabs' cut axis a and the transposed slabs' b
        self.a = 1 if grid.is_flat(0) else 0
        self.b = 2 if (self.a == 1 or grid.is_flat(1)) else 1
        for ax in (self.a, self.b):
            if self.N[ax] % self.P:
                raise ValueError(
                    f"the mesh size {self.P} must divide N{'xyz'[ax]}="
                    f"{self.N[ax]}: the pencil's slabs cut it")

        lam = np.zeros((1, 1, 1))
        for axis in range(3):
            if self.kinds[axis] not in ("fft", "dct"):
                continue
            N, L = grid.N[axis], grid.extent[axis]
            topo = PERIODIC if self.kinds[axis] == "fft" else BOUNDED
            sh = [1, 1, 1]
            sh[axis] = N
            lam = lam + poisson_eigenvalues(N, L, topo).reshape(sh)
        self.eigenvalues = lam

        if self.s is not None:
            n = grid.N[self.s]
            dsc, dsf = stretched_spacings(grid, self.s)
            lower = 1.0 / dsf[:n]
            upper = 1.0 / dsf[1:n + 1]
            lower[0] = 0.0
            upper[-1] = 0.0
            self._dsc, self._lower, self._upper = dsc, lower, upper
        self._consts = {}
        if any(d.type == "cuda" for d in self.devices):
            disable_tf32()

    # -- per-shard constants -----------------------------------------------------

    def _cut(self, arr, axis, rank):
        """``arr`` cut to slab ``rank``'s range along ``axis`` (where it
        spans the axis)."""
        if arr.shape[axis] == 1:
            return arr
        w = arr.shape[axis] // self.P
        return np.take(arr, np.arange(rank * w, (rank + 1) * w), axis=axis)

    def _constants(self, rank, dtype, device):
        """The eigenvalues of the transformed axes in the layout where the
        divide or the sweep runs, the DCT matrices and the sweep's
        coefficients, as tensors of ``dtype`` on ``device``, made once."""
        key = (rank, dtype, str(device))
        out = self._consts.get(key)
        if out is not None:
            return out
        kw = dict(dtype=dtype, device=device)
        lam = self._cut(self.eigenvalues, self._solve_cut(), rank)
        out = {"lam": torch.as_tensor(np.ascontiguousarray(lam), **kw)}
        for i in range(3):
            if self.kinds[i] == "dct":
                n = self.N[i]
                out[("dct", i)] = torch.as_tensor(dct2_matrix(n), **kw)
                out[("idct", i)] = torch.as_tensor(idct2_matrix(n), **kw)
        if self.s is not None:
            # the coefficients are formed in float64 and rounded once, as
            # the serial FourierTridiagonalPoissonSolver forms them: formed
            # in float32, -(lower + upper) - Δs·λ rounds twice, and the
            # sweep of the near-singular modes amplified that to 2.4 times
            # the serial solver's float32 error; row 0 of the singular mode
            # is pinned (φ[0] = 0)
            s = self.s
            sh = [1, 1, 1]
            sh[s] = -1
            lower, upper = self._lower.reshape(sh), self._upper.reshape(sh)
            dsc = self._dsc.reshape(sh)
            first = tuple(slice(0, 1) if ax == s else slice(None)
                          for ax in range(3))
            singular = lam == 0
            diag = -(lower + upper) - dsc * lam
            diag[first] = np.where(singular, 1.0, diag[first])
            up = np.broadcast_to(upper, diag.shape).copy()
            up[first] = np.where(singular, 0.0, up[first])
            out.update(diag=torch.as_tensor(diag, **kw),
                       up=torch.as_tensor(up, **kw),
                       lower=torch.as_tensor(self._lower, **kw),
                       dsc=torch.as_tensor(dsc, **kw),
                       keep0=torch.as_tensor(~singular, **kw))
            if s != 2:
                w = self._cut((self._dsc / self._dsc.sum()).reshape(sh),
                              s, rank) if s == self.a else \
                    (self._dsc / self._dsc.sum()).reshape(sh)
                out["weights"] = torch.as_tensor(w, **kw)
        self._consts[key] = out
        return out

    def _solve_cut(self):
        """The axis cut in the layout where the divide or the sweep runs:
        the transposed slabs' b, or the slabs' a where the sweep runs along
        b (whole on the slabs)."""
        return self.a if self.s == self.b else self.b

    def _zsolve(self, bh, c):
        """The eigen-divide, or the Thomas sweep along the stretched axis,
        of the transformed right-hand side."""
        lam = c["lam"]
        if self.s is None:
            zero = lam == 0
            denom = torch.where(zero, torch.ones_like(lam), lam)
            ph = -bh / denom
            return torch.where(zero, torch.zeros_like(ph), ph)
        s = self.s
        rhs = bh * c["dsc"]
        n = rhs.shape[s]
        # the pinned singular mode: φ[0] = 0
        rhs = torch.cat([rhs.narrow(s, 0, 1) * c["keep0"],
                         rhs.narrow(s, 1, n - 1)], dim=s)
        return solve_batched_tridiagonal(c["lower"], c["diag"], c["up"], rhs,
                                         axis=s)

    # -- the slab algorithm --------------------------------------------------

    def _transpose(self, rank, x, to_b):
        """Slabs (cut along a) to transposed slabs (cut along b) with
        ``to_b``, else back: one ``all_to_all`` meeting."""
        P = self.P
        cut, join = (self.b, self.a) if to_b else (self.a, self.b)
        w = x.shape[cut] // P
        got = self.comm.all_to_all(rank, [x.narrow(cut, t * w, w)
                                          for t in range(P)])
        return torch.cat(got, dim=join)

    def solve_slab(self, rank, b, spectral=None):
        """φ on slab ``rank``: ``b`` is the interior slab of cells
        rank·N/P .. (rank + 1)·N/P along the slabs' cut axis (x, or y
        where x is flat) on this shard's device; called from every shard's
        thread (two ``all_to_all`` meetings, four when the sweep runs along
        the transposed slabs' cut axis). ``spectral(b̂, λ)`` replaces the
        eigen-divide (λ the Laplacian's positive eigenvalues of the slab,
        broadcastable). A stretched x or y ends with its Δs-weighted mean
        removed, as the serial solver's (a sum over the mesh)."""
        a, bax = self.a, self.b
        c = self._constants(rank, b.dtype, b.device)
        # the slabs: every transformed axis but a (z's DCT, the other
        # horizontal axis, z's FFT: the JAX order)
        x = self._along(b, 2, c, kinds=("dct",))
        if a == 0:
            x = self._along(x, 1, c)
        x = self._along(x, 2, c, kinds=("fft",))
        x = self._transpose(rank, x, True)
        x = self._along(x, a, c)
        if self.s == bax:
            # the sweep along b, whole on the slabs
            x = self._transpose(rank, x, False)
            x = self._zsolve(x, c)
            x = self._transpose(rank, x, True)
        else:
            x = (self._zsolve(x, c) if spectral is None
                 else spectral(x, c["lam"]))
        x = self._along(x, a, c, inverse=True)
        x = self._transpose(rank, x, False)
        x = self._along(x, 2, c, inverse=True, kinds=("fft",))
        if a == 0:
            x = self._along(x, 1, c, inverse=True)
        if x.is_complex():
            x = x.real
        x = self._along(x.contiguous(), 2, c, inverse=True, kinds=("dct",))
        if "weights" in c:
            other = self.N[0] * self.N[1] * self.N[2] // self.N[self.s]
            mean = self.comm.all_reduce(rank, torch.sum(x * c["weights"]))
            x = x - mean / other
        return x.to(b.dtype).contiguous()

    def _along(self, t, axis, c, inverse=False, kinds=("fft", "dct")):
        """The transform of ``axis`` along it (whole there), if its kind is
        among ``kinds``: the FFT of a periodic axis, the DCT-II of a
        bounded one (their inverses with ``inverse``)."""
        kind = self.kinds[axis]
        if kind not in kinds:
            return t
        if kind == "fft":
            return (torch.fft.ifft if inverse else torch.fft.fft)(t, dim=axis)
        return apply_matrix_along(t.contiguous(), c[(
            "idct" if inverse else "dct", axis)], axis)

    def solve(self, b):
        """b: the global interior tensor (Nx, Ny, Nz); returns φ on b's
        device. The slabs go to the mesh's devices and every shard runs
        the slab algorithm."""
        P, a = self.P, self.a
        w = self.N[a] // P
        if tuple(b.shape) != tuple(self.N):
            raise ValueError(f"b has shape {tuple(b.shape)}; the solver's "
                             f"interior is {self.N}")
        slabs = [b.narrow(a, s * w, w).to(d, copy=True) for s, d in
                 enumerate(self.devices)]
        out = self.comm.run(lambda r: self.solve_slab(r, slabs[r]))
        return torch.cat([o.to(b.device) for o in out], dim=a)

    # -- resident (Sx, Sy) blocks ------------------------------------------------

    def to_slabs(self, rank, block):
        """The slab of shard ``rank`` from the mesh's (nlx, nly, Nz)
        blocks: slab i·Sy + k takes the k-th x-range of Nx/P cells of every
        block of mesh row i (an all_to_all within each row; nothing moves
        on an (Sx, 1) mesh, nor on a (1, Sy) one whose x is flat: its
        blocks are the y-slabs)."""
        comm = self.comm
        Sx, Sy = comm.mesh.devices.shape
        if Sy == 1 or self.a == 1:
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
        if Sy == 1 or self.a == 1:
            return slab
        i = rank // Sy
        nly = slab.shape[1] // Sy
        pieces = [None] * self.P
        for j in range(Sy):
            pieces[i * Sy + j] = slab[:, j * nly:(j + 1) * nly]
        got = comm.all_to_all(rank, pieces)
        return torch.cat([got[i * Sy + k] for k in range(Sy)], dim=0)

    def solve_block(self, rank, b, spectral=None):
        """φ on shard ``rank``'s (nlx, nly, Nz) interior block of an
        (Sx, Sy) mesh of resident blocks (called from every shard's
        thread); ``spectral`` as ``solve_slab``'s."""
        slab = self.to_slabs(rank, b)
        return self.from_slabs(
            rank, self.solve_slab(rank, slab, spectral)).contiguous()


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
