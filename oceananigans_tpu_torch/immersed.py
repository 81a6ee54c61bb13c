"""Immersed boundaries: solid topography inside the domain.

Counterpart of ``oceananigans_tpu/immersed.py``:

- ``GridFittedBottom``: cells whose centre lies below a bottom height
  z_b(x, y) are solid;
- ``PartialCellBottom``: the bottommost fluid cell of each column shrinks so
  that its lower face sits on the bottom (never below a fraction ε of Δz),
  with the effective Δz at all eight staggered locations;
- ``GridFittedBoundary``: solid where a mask(x, y, z) is true;
- ``ImmersedBoundaryGrid``: an underlying grid and one of these, with the
  fluid masks at each location, ``mask_immersed`` and the metric
  pass-throughs (partial cells change Δz, and with it Ax, Ay and V).

The geometry is static: it is formed once on the host in numpy float64, as
the JAX package forms it, and held as boolean arrays (``solid_ccc`` …);
the masks and effective spacings the models read are tensors of the grid's
dtype on its device, made on first use and cached. A bottom height or mask
given as a callable is evaluated on the interior centre coordinates as
float64 numpy arrays, as the JAX package evaluates it (write it with numpy
operations), on a shell grid at the true 2-D (λ, φ) centres; the halos are
then padded by topology (wrapped on a periodic axis, extended on a bounded
one).
"""

from __future__ import annotations

import numpy as np
import torch

from .grids.base import (AbstractGrid, broadcastable_1d,
                         horizontal_nodes_numpy, numpy_metric)
from .grids.topology import CENTER, FACE, LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC


def _pad_columns(grid, a):
    """Pad an interior per-column array over the x and y halos: wrapped on
    a periodic axis, extended by the edge value otherwise."""
    a = np.asarray(a)
    for ax in (0, 1):
        if grid.H[ax] == 0:
            continue
        mode = "wrap" if str(grid.topology[ax]) == "periodic" else "edge"
        pad = [(0, 0)] * a.ndim
        pad[ax] = (grid.H[ax], grid.H[ax])
        a = np.pad(a, pad, mode=mode)
    return a


def _interior_centers_2d(grid):
    """Interior (x, y) centre coordinates as broadcastable numpy arrays:
    the true 2-D (λ, φ) centres on a shell grid (the JAX package passes
    the 1-D centre lines there)."""
    return horizontal_nodes_numpy(grid, (CENTER, CENTER))


def _bottom_padded_2d(grid, b):
    """A padded (npx, npy, 1) bottom-height array from a scalar, a callable
    of the interior centres, an interior-shaped array or a padded one."""
    if np.isscalar(b):
        return np.full(grid.padded_shape[:2] + (1,), float(b))
    if callable(b):
        x, y = _interior_centers_2d(grid)
        zb = np.broadcast_to(np.asarray(b(x, y), np.float64),
                             (grid.N[0], grid.N[1]))
        return _pad_columns(grid, zb)[..., None]
    zb = np.asarray(b, np.float64)
    if zb.shape == (grid.N[0], grid.N[1]):
        zb = _pad_columns(grid, zb)
    return zb[..., None] if zb.ndim == 2 else zb


def _bottom_fp(b):
    return (id(b) if callable(b)
            else (b if np.isscalar(b) else np.asarray(b).tobytes()))


class GridFittedBottom:
    def __init__(self, bottom_height):
        self.bottom_height = bottom_height

    def solid_centers(self, grid):
        """Boolean padded array: True where the cell centre is below the
        bottom."""
        zc = broadcastable_1d(grid.coord_padded(2, CENTER), 2)
        zb = _bottom_padded_2d(grid, self.bottom_height)
        return np.broadcast_to(zc < zb, grid.padded_shape).copy()

    def _fp(self):
        return ("GridFittedBottom", _bottom_fp(self.bottom_height))


class PartialCellBottom:
    """Fractional bottom cells: the bottommost fluid cell of each column
    shrinks so its lower face sits on the bottom height, never below
    ``minimum_fractional_cell_height``·Δz."""

    def __init__(self, bottom_height, minimum_fractional_cell_height=0.2):
        self.bottom_height = bottom_height
        self.epsilon = float(minimum_fractional_cell_height)

    def _zb_padded(self, grid):
        zb = _bottom_padded_2d(grid, self.bottom_height)
        return (np.broadcast_to(zb, grid.padded_shape[:2] + (1,)).copy()
                if zb.shape[:2] != grid.padded_shape[:2] else zb)

    def _geometry(self, grid):
        """(bottom, solid, Δzᶜᶜᶜ, Δzᶜᶜᶠ) as padded numpy arrays."""
        h, n = grid.H[2], grid.N[2]
        npz = grid.padded_shape[2]
        zf = np.asarray(grid.coord_padded(2, FACE), np.float64)
        zc = np.asarray(grid.coord_padded(2, CENTER), np.float64)
        dzc = np.broadcast_to(np.asarray(numpy_metric(grid, "dz", (CENTER,) * 3)).reshape(-1),
                              (npz,))
        ztop = zf + dzc

        zb = np.clip(self._zb_padded(grid), zf[h], ztop[h + n - 1])
        # cap the bottom so that the partial cell is at least εΔz tall
        bottom_cell = (zf[None, None, :] <= zb) & (ztop[None, None, :] >= zb)
        capped = np.minimum(ztop[None, None, :] - self.epsilon * dzc, zb)
        zb = np.where(bottom_cell.any(axis=2, keepdims=True),
                      np.max(np.where(bottom_cell, capped, -np.inf), axis=2,
                             keepdims=True), zb)

        solid = (ztop[None, None, :] - self.epsilon * dzc) < zb
        fluid = ~solid
        below_solid = np.concatenate(
            [np.ones_like(solid[..., :1]), solid[..., :-1]], axis=2)
        bottommost = fluid & below_solid
        dz_ccc = np.where(bottommost, ztop[None, None, :] - zb, dzc)
        # the face just above a partial cell k-1:
        # Δzᶜᶜᶠ = zc[k] - zf[k] + Δzᶜᶜᶜ(k-1)/2
        just_above = np.concatenate(
            [np.zeros_like(bottommost[..., :1]), bottommost[..., :-1]],
            axis=2)
        dz_ccf_full = np.broadcast_to(
            np.asarray(numpy_metric(grid, "dz", (CENTER, CENTER, FACE))).reshape(1, 1, -1),
            solid.shape)
        dz_prev = np.concatenate([dz_ccc[..., :1], dz_ccc[..., :-1]], axis=2)
        dz_ccf = np.where(just_above,
                          (zc - zf)[None, None, :] + dz_prev / 2, dz_ccf_full)
        return zb, solid, dz_ccc, dz_ccf

    def solid_centers(self, grid):
        return self._geometry(grid)[1]

    def effective_dz(self, grid):
        """{(x face?, y face?, z face?): padded float64 Δz} for the eight
        staggered locations; a horizontal stagger takes the smaller of the
        two adjacent columns."""
        _, _, dz_ccc, dz_ccf = self._geometry(grid)

        def minx(a):
            return a if grid.is_flat(0) else np.minimum(a, np.roll(a, 1, 0))

        def miny(a):
            return a if grid.is_flat(1) else np.minimum(a, np.roll(a, 1, 1))

        out = {}
        for lz_face, base in ((False, dz_ccc), (True, dz_ccf)):
            out[(False, False, lz_face)] = base
            out[(True, False, lz_face)] = minx(base)
            out[(False, True, lz_face)] = miny(base)
            out[(True, True, lz_face)] = miny(minx(base))
        return out

    def _fp(self):
        return ("PartialCellBottom", _bottom_fp(self.bottom_height),
                self.epsilon)


class GridFittedBoundary:
    """Solid where ``mask(x, y, z)`` is true (evaluated on the interior
    centres, padded by topology in x and y and by edge in z)."""

    def __init__(self, mask):
        self.mask = mask

    def solid_centers(self, grid):
        x, y = _interior_centers_2d(grid)
        z = np.asarray(grid.coord_padded(2, CENTER))[
            grid.H[2]:grid.H[2] + grid.N[2]].reshape(1, 1, -1)
        m = np.broadcast_to(np.asarray(self.mask(x[..., None], y[..., None],
                                                 z), bool),
                            (grid.N[0], grid.N[1], grid.N[2]))
        m = _pad_columns(grid, m)
        if grid.H[2] or grid.padded_shape[2] != m.shape[2]:
            tail = grid.padded_shape[2] - m.shape[2] - grid.H[2]
            m = np.pad(m, [(0, 0), (0, 0), (grid.H[2], tail)], mode="edge")
        return np.broadcast_to(m, grid.padded_shape).copy()

    def _fp(self):
        return ("GridFittedBoundary", id(self.mask))


class ImmersedBoundaryGrid(AbstractGrid):
    """An underlying grid with solid topography. Every attribute the wrapper
    does not define comes from the underlying grid."""

    def __init__(self, grid, immersed_boundary):
        self._underlying = grid
        self.immersed_boundary = immersed_boundary
        self._dz_eff = (immersed_boundary.effective_dz(grid)
                        if hasattr(immersed_boundary, "effective_dz")
                        else None)
        solid_c = immersed_boundary.solid_centers(grid)
        self.solid_ccc = solid_c
        # a face is solid (carries no transport) if either adjacent centre is
        self.solid_fcc = solid_c | np.roll(solid_c, 1, 0)
        self.solid_cfc = solid_c | np.roll(solid_c, 1, 1)
        self.solid_ccf = solid_c | np.roll(solid_c, 1, 2)
        self.mask = {LOC_CCC: ~self.solid_ccc, LOC_FCC: ~self.solid_fcc,
                     LOC_CFC: ~self.solid_cfc, LOC_CCF: ~self.solid_ccf}
        self._tensors = {}

    @property
    def underlying_grid(self):
        return self._underlying

    def __getattr__(self, name):
        if name.startswith("__") or name == "_underlying":
            raise AttributeError(name)
        return getattr(self._underlying, name)

    def _tensor(self, key, make, dtype=None):
        """A cached tensor on the grid's device (``dtype`` None: boolean)."""
        k = (key, dtype)
        if k not in self._tensors:
            self._tensors[k] = torch.as_tensor(np.ascontiguousarray(make()),
                                               dtype=dtype,
                                               device=self.device)
        return self._tensors[k]

    def _fluid_numpy(self, loc):
        return self.mask.get(tuple(loc), ~self.solid_ccc)

    def fluid_mask(self, loc, dtype=None):
        """The fluid mask at ``loc`` (u, v, w and the centres) as a padded
        tensor of ``dtype`` (the grid's by default)."""
        return self._tensor(("mask",) + tuple(loc),
                            lambda: self._fluid_numpy(loc),
                            dtype or self.dtype)

    def fluid_mask_at(self, loc, dtype=None):
        """The fluid mask at any staggered location: a point is solid if
        any of the 2^f adjacent centres (f face-located axes) is solid."""
        key = ("at",) + tuple(loc)
        if key not in self.mask:
            solid = self.solid_ccc
            for axis in range(3):
                if loc[axis] == FACE:
                    solid = solid | np.roll(solid, 1, axis)
            self.mask[key] = ~solid
        return self._tensor(("mask",) + key, lambda: self.mask[key],
                            dtype or self.dtype)

    def mask_immersed(self, a, loc, value=0.0):
        """``a`` with its solid cells at ``loc`` set to ``value``."""
        m = self._tensor(("bool",) + tuple(loc),
                         lambda: self._fluid_numpy(loc))
        return torch.where(m, a, torch.as_tensor(value, dtype=a.dtype,
                                                 device=a.device))

    def mask_immersed_(self, a, loc, value=0.0):
        """Set ``a``'s solid cells at ``loc`` to ``value`` in place; returns
        it."""
        solid = self._tensor(("solid",) + tuple(loc),
                             lambda: ~self._fluid_numpy(loc))
        return a.masked_fill_(solid, value)

    # -- metrics: partial cells change Δz and with it Ax, Ay and V -------------

    def _dz_eff_numpy(self, loc):
        return self._dz_eff[(loc[0] == FACE, loc[1] == FACE, loc[2] == FACE)]

    def _eff(self, name, loc):
        def make():
            dz = self._dz_eff_numpy(loc)
            if name == "dz":
                return dz
            if name == "Ax":
                return numpy_metric(self._underlying, "dy", loc) * dz
            if name == "Ay":
                return numpy_metric(self._underlying, "dx", loc) * dz
            return numpy_metric(self._underlying, "Az", loc) * dz
        return self._tensor((name,) + tuple(loc), make, self.dtype)

    def dx(self, loc):
        return self._underlying.dx(loc)

    def dy(self, loc):
        return self._underlying.dy(loc)

    def dz(self, loc):
        if self._dz_eff is not None:
            return self._eff("dz", loc)
        return self._underlying.dz(loc)

    def Ax(self, loc):
        if self._dz_eff is not None:
            return self._eff("Ax", loc)
        return self._underlying.Ax(loc)

    def Ay(self, loc):
        if self._dz_eff is not None:
            return self._eff("Ay", loc)
        return self._underlying.Ay(loc)

    def Az(self, loc):
        # z-normal areas are untouched by partial cells
        return self._underlying.Az(loc)

    def V(self, loc):
        if self._dz_eff is not None:
            return self._eff("V", loc)
        return self._underlying.V(loc)

    # -- copies ---------------------------------------------------------------

    def with_halo(self, halo):
        if tuple(halo) == tuple(self.H):
            return self
        return ImmersedBoundaryGrid(self._underlying.with_halo(halo),
                                    self.immersed_boundary)

    def to(self, device=None, dtype=None):
        under = self._underlying.to(device=device, dtype=dtype)
        if under is self._underlying:
            return self
        return ImmersedBoundaryGrid(under, self.immersed_boundary)

    def _fingerprint(self):
        return ("ImmersedBoundaryGrid", self._underlying._fingerprint(),
                self.immersed_boundary._fp())

    def __repr__(self):
        return (f"ImmersedBoundaryGrid({self._underlying!r}, "
                f"{type(self.immersed_boundary).__name__})")


__all__ = ["GridFittedBottom", "PartialCellBottom", "GridFittedBoundary",
           "ImmersedBoundaryGrid"]
