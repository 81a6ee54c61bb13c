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
import torch

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

    # -- nodes and spacings ---------------------------------------------------

    def nodes(self, loc=topo.LOC_CCC):
        """The interior coordinates at ``loc`` along each axis (numpy)."""
        return tuple(self.nodes1d(i, loc[i]) for i in range(3))

    def minimum_spacing(self, axis):
        """The smallest interior spacing between cell faces along ``axis``
        (inf on a flat axis)."""
        if self.is_flat(axis):
            return np.inf
        m = (self.dx, self.dy, self.dz)[axis](topo.LOC_CCC)
        if isinstance(m, float):
            return m
        m = torch.as_tensor(m).broadcast_to(self.padded_shape)
        return float(m[self.interior_slices].min())

    def minimum_xspacing(self):
        return self.minimum_spacing(0)

    def minimum_yspacing(self):
        return self.minimum_spacing(1)

    def minimum_zspacing(self):
        return self.minimum_spacing(2)

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


class MetricCache:
    """Metric accessors from a grid's ``metric_numpy(name, loc)``: a float
    stays a Python float; an array becomes a tensor of the grid's dtype on
    its device, formed once and cached in ``self._cache``."""

    def _metric(self, name, loc):
        key = (name, tuple(loc))
        if key not in self._cache:
            m = self.metric_numpy(name, loc)
            self._cache[key] = (float(m) if np.ndim(m) == 0 else
                                torch.as_tensor(np.ascontiguousarray(m),
                                                dtype=self.dtype,
                                                device=self.device))
        return self._cache[key]

    def dx(self, loc):
        return self._metric("dx", loc)

    def dy(self, loc):
        return self._metric("dy", loc)

    def dz(self, loc):
        return self._metric("dz", loc)

    def Ax(self, loc):
        return self._metric("Ax", loc)

    def Ay(self, loc):
        return self._metric("Ay", loc)

    def Az(self, loc):
        return self._metric("Az", loc)

    def V(self, loc):
        return self._metric("V", loc)


def padded_horizontal_nodes(grid, loc):
    """The (x, y) coordinates at ``loc`` over the padded horizontal extent,
    float64 numpy broadcastable against a padded field: the true 2-D
    (λ, φ) nodes, (npx, npy, 1), on a grid that has them (a shell grid),
    else the 1-D padded coordinates."""
    if hasattr(grid, "nodes2d_padded"):
        lam, phi = grid.nodes2d_padded(tuple(loc[:2]))
        return lam[..., None], phi[..., None]
    return tuple(broadcastable_1d(grid.coord_padded(ax, loc[ax]), ax)
                 for ax in (0, 1))


def horizontal_nodes(grid, loc, dtype=None, device=None):
    """``padded_horizontal_nodes`` as tensors of the grid's dtype and device
    (or the given ones)."""
    kw = dict(dtype=dtype or grid.dtype, device=device or grid.device)
    return tuple(torch.as_tensor(c, **kw)
                 for c in padded_horizontal_nodes(grid, loc))


def horizontal_nodes_numpy(grid, loc):
    """``padded_horizontal_nodes`` over the interior: (Nx, Ny) arrays of the
    true nodes on a shell grid, else (Nx, 1) and (1, Ny)."""
    ints = [slice(h, h + n) for h, n in zip(grid.H[:2], grid.N[:2])]
    return tuple(c[tuple(s if c.shape[a] > 1 else slice(None)
                         for a, s in enumerate(ints))][..., 0]
                 for c in padded_horizontal_nodes(grid, loc))


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
    if hasattr(grid, "solid_ccc") and getattr(grid, "_dz_eff", None) is None:
        # an immersed grid without partial cells keeps the underlying metrics
        return numpy_metric(grid.underlying_grid, name, loc)
    if hasattr(grid, "metric_numpy") and not hasattr(grid, "solid_ccc"):
        return grid.metric_numpy(name, loc)
    m = getattr(grid, name)(loc)
    if isinstance(m, torch.Tensor):
        return m.detach().to("cpu", torch.float64).numpy()
    return m
