"""Diagnostics over a model's forcings, boundary conditions, buoyancy and
pressure.

Counterpart of ``oceananigans_tpu/models/diagnostic_operations.py``:
``ForcingOperation`` / ``ForcingField`` evaluate ``model.forcing[name]`` at
the model's state; ``BoundaryConditionOperation`` /
``BoundaryConditionField`` a prognostic field's condition on one side as a
boundary plane (the normal axis of length 1); ``boundary_adjacent_mean`` and
``BoundaryAdjacentMean`` the area-weighted mean over the interior plane next
to a side; ``BuoyancyField`` and ``PressureField``.
"""

from __future__ import annotations

import torch

from ..abstract_operations import AbstractOperation, ComputedField
from ..boundary_conditions.fill_halos import boundary_condition_value
from ..fields import Field
from ..grids.topology import BOUNDED, FACE, LOC_CCC

_SIDE_AXIS = {"west": 0, "east": 0, "south": 1, "north": 1,
              "bottom": 2, "top": 2}
_LEFT = {"west", "south", "bottom"}


class ForcingOperation(AbstractOperation):
    """``model.forcing[name]`` evaluated at the model's current state."""

    def __init__(self, name, model):
        if name not in model.forcing:
            raise KeyError(f"model has no forcing on {name!r}")
        self.name = name
        self.model = model
        self.grid = model.grid
        self.loc = model.loc(name)

    def materialize(self):
        model = self.model
        F = model.forcing[self.name]
        fields = dict(model.state["fields"])
        out = F(model.grid, fields, model.time) if callable(F) else F
        return torch.as_tensor(out, dtype=model.grid.dtype,
                               device=model.grid.device).broadcast_to(
            model.grid.padded_shape)


def ForcingField(name, model):
    """``ForcingOperation(name, model)`` as a ComputedField."""
    return ComputedField(ForcingOperation(name, model))


class BoundaryConditionOperation(AbstractOperation):
    """The ``side`` condition of prognostic field ``name`` as a keep-dims
    boundary plane (length 1 along the side's axis)."""

    def __init__(self, name, side, model):
        if side not in _SIDE_AXIS:
            raise ValueError(f"side must be one of {sorted(_SIDE_AXIS)}")
        self.name = name
        self.side = side
        self.model = model
        self.grid = model.grid
        self.loc = model.loc(name)
        self.axis = _SIDE_AXIS[side]

    @property
    def bc(self):
        return self.model.bcs[self.name].side(self.side)

    def materialize(self):
        grid, axis = self.grid, self.axis
        shape = [1, 1, 1]
        for ax in range(3):
            if ax != axis:
                shape[ax] = grid.padded_shape[ax]
        kw = dict(dtype=grid.dtype, device=grid.device)
        bc = self.bc
        if bc is None:
            return torch.zeros(tuple(shape), **kw)
        val = boundary_condition_value(bc, grid, self.loc, axis,
                                       self.model.time)
        if val is None:
            val = 0.0
        return torch.as_tensor(val, **kw).broadcast_to(tuple(shape))

    @property
    def interior(self):
        data = self.materialize()
        sl = [slice(None)] * 3
        for ax in range(3):
            if ax != self.axis:
                sl[ax] = slice(self.grid.H[ax],
                               self.grid.H[ax] + self.grid.N[ax])
        return data[tuple(sl)]

    def compute(self):
        return self

    def __call__(self, model=None):
        return self


def BoundaryConditionField(name, side, model):
    """``BoundaryConditionOperation`` as a ComputedField."""
    return ComputedField(BoundaryConditionOperation(name, side, model))


def boundary_adjacent_mean(field, side):
    """The area-weighted mean of ``field`` over the interior plane next to
    ``side``: the first (last) interior cell, or for a face-located normal
    axis the first interior face in from the boundary face."""
    if side not in _SIDE_AXIS:
        raise ValueError(f"side must be one of {sorted(_SIDE_AXIS)}")
    axis = _SIDE_AXIS[side]
    grid, loc = field.grid, field.loc
    area = (grid.Ax, grid.Ay, grid.Az)[axis](loc)
    data = field.interior
    An = torch.as_tensor(area, dtype=data.dtype, device=data.device
                         ).broadcast_to(grid.padded_shape)[grid.interior_slices]
    if side in _LEFT:
        i = 1 if loc[axis] == FACE else 0
    else:
        i = data.shape[axis] - 1
        if loc[axis] == FACE and grid.topology[axis] == BOUNDED:
            i -= 1
    sl = [slice(None)] * 3
    sl[axis] = i
    plane, w = data[tuple(sl)], An[tuple(sl)]
    return (plane * w).sum() / w.sum()


class BoundaryAdjacentMean:
    """Called with ``(side, field)`` it computes and keeps
    ``boundary_adjacent_mean``; called with nothing it returns the kept
    value."""

    def __init__(self):
        self.value = 0.0

    def __call__(self, side=None, field=None):
        if side is None:
            return self.value
        self.value = float(boundary_adjacent_mean(field, side))
        return self.value


def BuoyancyField(model):
    """The buoyancy at (c, c, c) of the model's current tracers."""
    if model.buoyancy is None:
        raise ValueError("model has no buoyancy formulation")
    tracers = {n: model.state["fields"][n] for n in model.tracer_names}
    data = model.buoyancy.buoyancy_ccc(model.grid, tracers)
    data = torch.as_tensor(data, dtype=model.grid.dtype,
                           device=model.grid.device).broadcast_to(
        model.grid.padded_shape)
    return Field(model.grid, LOC_CCC, None, data)


def PressureField(model):
    """The model's (kinematic) pressure as a Field."""
    return model.field("p")
