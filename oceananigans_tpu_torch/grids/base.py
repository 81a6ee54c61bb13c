"""Abstract grid machinery shared by all grid types.

Counterpart of ``oceananigans_tpu/grids/base.py``. All fields on a grid share
ONE padded tensor shape ``(Nx + 2Hx, Ny + 2Hy, Nz + 2Hz)`` with z contiguous,
whatever their staggered location. Interior cell ``i`` lives at padded index
``i + H``; for a Face location in a Bounded direction the extra boundary face
``i = N`` lives in the first halo slot. Metric accessors return Python
scalars (regular spacing) or numpy arrays broadcastable against padded 3D
tensors. A grid also names the ``dtype`` and ``device`` of its fields.
"""

from __future__ import annotations

import numpy as np

from . import topology as topo


class AbstractGrid:
    """Protocol: concrete grids define ``N``, ``H``, ``topology``, ``dtype``,
    ``device``, the metric methods ``dx/dy/dz(loc)`` and the coordinate
    methods."""

    # -- shapes ---------------------------------------------------------------

    @property
    def shape(self):
        """Interior shape (Nx, Ny, Nz)."""
        return tuple(self.N)

    @property
    def padded_shape(self):
        return tuple(n + 2 * h for n, h in zip(self.N, self.H))

    @property
    def interior_slices(self):
        return tuple(slice(h, h + n) for n, h in zip(self.N, self.H))

    # -- derived metrics (areas and volumes) ---------------------------------

    def Ax(self, loc):
        """Area of the x-normal cell face at location ``loc``."""
        return self.dy(loc) * self.dz(loc)

    def Ay(self, loc):
        return self.dx(loc) * self.dz(loc)

    def Az(self, loc):
        return self.dx(loc) * self.dy(loc)

    def V(self, loc):
        """Cell volume at location ``loc``."""
        return (self.dx(loc) * self.dy(loc)) * self.dz(loc)

    # -- topology helpers -----------------------------------------------------

    def is_flat(self, axis):
        return self.topology[axis] == topo.FLAT

    def is_bounded(self, axis):
        return self.topology[axis] == topo.BOUNDED

    # -- hashing / equality ---------------------------------------------------

    def _fingerprint(self):
        raise NotImplementedError

    def __hash__(self):
        return hash(self._fingerprint())

    def __eq__(self, other):
        return type(self) is type(other) and self._fingerprint() == other._fingerprint()


def broadcastable_1d(arr, axis):
    """Reshape a 1D numpy metric array for broadcasting along ``axis`` of a 3D
    padded tensor."""
    shape = [1, 1, 1]
    shape[axis] = -1
    return np.asarray(arr).reshape(shape)


def numpy_metric(grid, name, loc):
    """Metric ``name`` (dx, dy, dz, Ax, Ay, Az, V) of ``grid`` at ``loc`` in
    float64 numpy, as the JAX grids form it (a float, or a broadcastable
    array): the grid's own float64 form where it keeps one, else its value
    brought to the host."""
    import torch
    if hasattr(grid, "metric_numpy") and not hasattr(grid, "solid_ccc"):
        return grid.metric_numpy(name, loc)
    m = getattr(grid, name)(loc)
    if isinstance(m, torch.Tensor):
        return m.detach().to("cpu", torch.float64).numpy()
    return m
