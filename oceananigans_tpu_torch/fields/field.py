"""Field: a staggered quantity on a grid.

Counterpart of ``oceananigans_tpu/fields/field.py``: a grid, a location,
boundary conditions and one padded data tensor on the grid's device. Models
carry raw padded tensors in their state and build Fields only at the
user-facing API boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from ..boundary_conditions import regularize_field_boundary_conditions
from ..grids.base import broadcastable_1d
from ..grids.topology import BOUNDED, FACE, LOC_CCC, validate_location


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

    def __repr__(self):
        return (f"Field{self.loc} on {type(self.grid).__name__}, "
                f"size {self.shape}")


def coordinates(grid, loc):
    """The padded coordinates at ``loc`` as broadcastable tensors of the
    grid's dtype and device (x, y, z)."""
    return [torch.as_tensor(broadcastable_1d(grid.coord_padded(ax, loc[ax]),
                                             ax),
                            dtype=grid.dtype, device=grid.device)
            for ax in range(3)]


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
        coords = [broadcastable_1d(grid.coord_padded(ax, loc[ax]), ax)
                  for ax in range(3)]
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

