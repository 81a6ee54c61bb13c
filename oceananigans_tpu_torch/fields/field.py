"""Field: a staggered quantity on a grid.

Counterpart of ``oceananigans_tpu/fields/field.py``: a grid, a location,
boundary conditions and one padded data tensor on the grid's device. Models
carry raw padded tensors in their state and build Fields only at the
user-facing API boundary.

The reductions (``min``, ``max``, ``mean``, ``sum``, ``prod``, ``norm``) run
over the interior on the device and return 0-d tensors, as the JAX ones
return device scalars: reading one on the host is the caller's sync. On an
immersed grid they skip the solid points; ``condition=`` (a Field, a
callable of the coordinates or a boolean array) restricts them further.
"""

from __future__ import annotations

import numpy as np
import torch

from ..boundary_conditions import (fill_halo_regions,
                                   regularize_field_boundary_conditions)
from ..grids.base import broadcastable_1d, padded_horizontal_nodes
from ..grids.topology import (BOUNDED, FACE, LOC_CCC, LOC_CCF, LOC_CFC,
                              LOC_FCC, validate_location)


class Field:
    def __init__(self, grid, loc=LOC_CCC, bcs=None, data=None, _regularize=True):
        self.grid = grid
        self.loc = validate_location(loc)
        if _regularize:
            bcs = regularize_field_boundary_conditions(bcs, grid, self.loc)
        self.bcs = bcs
        if data is None:
            data = torch.zeros(grid.padded_shape, dtype=grid.dtype,
                               device=grid.device)
        self.data = data

    @property
    def interior_slices(self):
        """Per-axis interior slices of THIS field: N points per direction,
        N+1 for a Face location in a Bounded direction (the boundary face
        lives in the first halo slot; it is absent on a halo-free axis), the
        one slot of a size-1 axis."""
        sls = []
        for axis in range(3):
            if self.data.shape[axis] == 1:
                # a reduced (surface) field: its size-1 axis has no halo
                sls.append(slice(0, 1))
                continue
            n, h = self.grid.N[axis], self.grid.H[axis]
            extra = 1 if (self.loc[axis] == FACE
                          and self.grid.topology[axis] == BOUNDED) else 0
            sls.append(slice(h, min(h + n + extra, self.data.shape[axis])))
        return tuple(sls)

    @property
    def interior(self):
        return self.data[self.interior_slices]

    @property
    def shape(self):
        return tuple(self.interior.shape)

    def view(self, indices):
        """A window of the interior: ``indices`` is a 3-tuple of slices and
        integers, e.g. ``(slice(None), slice(None), -1)`` for the surface."""
        return self.interior[tuple(indices)]

    def nodes(self):
        """The interior coordinates along each axis at the field's
        location (numpy)."""
        return tuple(self.grid.nodes1d(ax, self.loc[ax]) for ax in range(3))

    def set(self, value):
        """Replace the data by ``value`` (a scalar, an interior or padded
        array, or a callable of the coordinates) with its halos filled; the
        tensor the field held is left as it was. Returns the field."""
        data = set_on_padded(self.grid, self.loc, value)
        self.data = fill_halo_regions(data, self.grid, self.loc, self.bcs)
        return self

    def fill_halos(self):
        """Fill the halos of a copy of the data, which the field then holds
        (a model's tensor it wrapped is left as it was). Returns the
        field."""
        self.data = fill_halo_regions(self.data.clone(), self.grid, self.loc,
                                      self.bcs)
        return self

    # -- reductions over the interior ------------------------------------------

    def _reduction_mask(self, condition=None):
        """The interior boolean mask of a reduction: the fluid points of an
        immersed grid and ``condition``; None when neither applies."""
        m = condition_interior(condition, self.grid, self.loc)
        fm = getattr(self.grid, "fluid_mask_at", None)
        if fm is not None:
            # this field's interior on full axes; the grid's on a size-1
            # axis, which align_reduction_mask collapses
            sl = list(self.interior_slices)
            for ax in range(3):
                if self.data.shape[ax] == 1:
                    sl[ax] = self.grid.interior_slices[ax]
            f = fm(self.loc, torch.bool)[tuple(sl)]
            m = f if m is None else align_reduction_mask(m, f.shape) & f
        if m is not None:
            m = align_reduction_mask(m, self.interior.shape)
        return m

    def _masked(self, condition, fill):
        x = self.interior
        m = self._reduction_mask(condition)
        if m is None:
            return x, None
        return torch.where(m, x, torch.as_tensor(fill, dtype=x.dtype,
                                                 device=x.device)), m

    def min(self, condition=None):
        return self._masked(condition, float("inf"))[0].min()

    def max(self, condition=None):
        return self._masked(condition, float("-inf"))[0].max()

    def mean(self, condition=None):
        x, m = self._masked(condition, 0.0)
        if m is None:
            return x.mean()
        return x.sum() / m.to(x.dtype).sum()

    def sum(self, condition=None):
        return self._masked(condition, 0.0)[0].sum()

    def prod(self, condition=None):
        return self._masked(condition, 1.0)[0].prod()

    def norm(self, condition=None):
        return torch.linalg.vector_norm(self._masked(condition, 0.0)[0])

    def __repr__(self):
        return (f"Field{self.loc} on {type(self.grid).__name__}, "
                f"size {self.shape}")


def condition_interior(condition, grid, loc):
    """The interior boolean mask of a reduction's ``condition``: a Field, an
    operation (``abstract_operations``), a callable of the coordinates
    (evaluated at ``loc``), or an interior- or padded-shaped array; None for
    no condition."""
    if condition is None:
        return None
    ii = grid.interior_slices
    if hasattr(condition, "materialize"):
        return condition.materialize()[ii].to(torch.bool)
    if isinstance(condition, Field):
        return condition.data[ii].to(torch.bool)
    if callable(condition):
        return set_on_padded(grid, loc, condition)[ii].to(torch.bool)
    c = (condition.to(grid.device) if isinstance(condition, torch.Tensor)
         else torch.as_tensor(np.asarray(condition), device=grid.device))
    if tuple(c.shape) == grid.padded_shape:
        return c[ii].to(torch.bool)
    return c.to(torch.bool).broadcast_to(
        tuple(s.stop - s.start for s in ii))


def align_reduction_mask(m, shape):
    """A full-interior mask fitted to an operand of ``shape``: an axis the
    operand holds at size 1 collapses with ``any`` (a column takes part if
    any of its cells does), and an axis one longer (a face in a bounded
    direction) repeats its last slot."""
    axes = tuple(ax for ax in range(min(len(shape), m.ndim))
                 if shape[ax] == 1 and m.shape[ax] != 1)
    if axes:
        m = m.any(dim=axes, keepdim=True)
    for ax in range(min(len(shape), m.ndim)):
        if shape[ax] - m.shape[ax] == 1:
            m = torch.cat([m, m.narrow(ax, m.shape[ax] - 1, 1)], dim=ax)
    return m


def coordinates_numpy(grid, loc):
    """The padded coordinates at ``loc`` as broadcastable float64 arrays
    (x, y, z): on a shell grid the true 2-D (λ, φ) nodes, (npx, npy, 1)
    (the JAX package passes the 1-D centre lines there)."""
    return list(padded_horizontal_nodes(grid, loc)) + [
        broadcastable_1d(grid.coord_padded(2, loc[2]), 2)]


def coordinates(grid, loc):
    """The padded coordinates at ``loc`` as broadcastable tensors of the
    grid's dtype and device (x, y, z); the true nodes on a shell grid."""
    return [torch.as_tensor(c, dtype=grid.dtype, device=grid.device)
            for c in coordinates_numpy(grid, loc)]


def as_padded(grid, value):
    """A tensor (or array) broadcast to the padded shape, in the grid's
    dtype and on its device."""
    return torch.as_tensor(value, dtype=grid.dtype,
                           device=grid.device).broadcast_to(grid.padded_shape)


def set_on_padded(grid, loc, value):
    """Build a padded data tensor from a scalar / interior array / padded
    array / callable f(x, y, z)."""
    shape = grid.padded_shape
    kw = dict(dtype=grid.dtype, device=grid.device)
    if callable(value):
        coords = coordinates_numpy(grid, loc)
        data = torch.as_tensor(np.asarray(value(*coords)), **kw)
        return data.broadcast_to(shape).contiguous()
    if np.isscalar(value):
        return torch.full(shape, value, **kw)
    value = torch.as_tensor(value, **kw)
    if value.ndim == 2:
        flat_axes = [ax for ax in range(3) if grid.is_flat(ax)]
        if len(flat_axes) == 1:
            value = value.unsqueeze(flat_axes[0])
    if tuple(value.shape) == shape:
        # a copy: the halo fills that follow write in place
        return value.clone(memory_format=torch.contiguous_format)
    data = torch.zeros(shape, **kw)
    ints = grid.interior_slices
    int_shape = tuple(s.stop - s.start for s in ints)
    if tuple(value.shape) == int_shape:
        data[ints] = value
        return data
    # interior-plus-boundary-face shape (Face/Bounded dims have N+1 entries,
    # the last one landing in the first halo slot)
    sls, exp = [], []
    for axis in range(3):
        n, h = grid.N[axis], grid.H[axis]
        extra = 1 if (loc[axis] == FACE and grid.topology[axis] == BOUNDED) else 0
        sls.append(slice(h, h + n + extra))
        exp.append(n + extra)
    if tuple(value.shape) == tuple(exp) and all(
            s.stop <= d for s, d in zip(sls, shape)):
        data[tuple(sls)] = value
        return data
    raise ValueError(f"cannot set field of interior shape {int_shape} "
                     f"from array of shape {tuple(value.shape)}")



# -- constructors ----------------------------------------------------------------

def CenterField(grid, bcs=None):
    return Field(grid, LOC_CCC, bcs)


def XFaceField(grid, bcs=None):
    return Field(grid, LOC_FCC, bcs)


def YFaceField(grid, bcs=None):
    return Field(grid, LOC_CFC, bcs)


def ZFaceField(grid, bcs=None):
    return Field(grid, LOC_CCF, bcs)


def VelocityFields(grid, u_bcs=None, v_bcs=None, w_bcs=None):
    """u, v and w at (f, c, c), (c, f, c) and (c, c, f)."""
    return dict(u=XFaceField(grid, u_bcs), v=YFaceField(grid, v_bcs),
                w=ZFaceField(grid, w_bcs))


def TracerFields(grid, names, bcs=None):
    bcs = bcs or {}
    return {name: CenterField(grid, bcs.get(name)) for name in names}
