"""Analytic fields: FunctionField, ConstantField, ZeroField, OneField,
GridMetricOperation, and ``interpolate``.

Counterpart of ``oceananigans_tpu/fields/function_field.py``. With a grid a
FunctionField is an ordinary Field whose padded data is the function
evaluated at the field's nodes (``at_time(t)`` evaluates it again). Without
a grid a ConstantField is a callable placeholder that works wherever the
package takes an ``f(x, y, z)`` setter; ``on_grid(grid, loc)`` makes it a
Field.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from ..grids.topology import LOC_CCC
from .field import Field, set_on_padded


class FunctionField(Field):
    """``FunctionField(loc, func, grid, time=0.0, parameters=None)``:
    ``func(x, y, z)``, ``func(x, y, z, t)`` or ``func(x, y, z, t, p)``
    evaluated at the nodes of ``loc`` (numpy coordinates, as ``set``
    passes them)."""

    def __init__(self, loc, func, grid, time=0.0, parameters=None):
        self.func = func
        self.parameters = parameters
        try:
            self._nargs = len(inspect.signature(func).parameters)
        except (TypeError, ValueError):
            self._nargs = 3
        super().__init__(grid, loc, None,
                         self._evaluate(grid, tuple(loc), time))
        self.time = time

    def _evaluate(self, grid, loc, time):
        if self._nargs <= 3:
            return set_on_padded(grid, loc, self.func)
        if self.parameters is not None and self._nargs >= 5:
            f = lambda x, y, z: self.func(x, y, z, time, self.parameters)
        else:
            f = lambda x, y, z: self.func(x, y, z, time)
        return set_on_padded(grid, loc, f)

    def at_time(self, time):
        """Evaluate the function again at ``time``; returns the field."""
        self.data = self._evaluate(self.grid, self.loc, time)
        self.time = time
        return self


class ConstantField:
    """A uniform field of ``value`` with no grid: a callable ``f(x, y, z)``
    (numpy or torch coordinates) for ``model.set``, background fields and
    prescribed velocities; ``on_grid(grid, loc)`` gives a Field."""

    def __init__(self, value):
        self.value = value

    def __call__(self, x, y, z, *rest):
        if any(isinstance(q, torch.Tensor) for q in (x, y, z)):
            t = next(q for q in (x, y, z) if isinstance(q, torch.Tensor))
            shape = torch.broadcast_shapes(*(np.shape(q) for q in (x, y, z)))
            return torch.zeros(shape, dtype=t.dtype,
                               device=t.device) + self.value
        return np.zeros(np.broadcast_shapes(np.shape(x), np.shape(y),
                                            np.shape(z))) + self.value

    def __float__(self):
        return float(self.value)

    def on_grid(self, grid, loc=LOC_CCC):
        return Field(grid, loc, None, set_on_padded(grid, loc, self.value))

    def __repr__(self):
        return f"ConstantField({self.value})"


def ZeroField():
    return ConstantField(0.0)


def OneField():
    return ConstantField(1.0)


def GridMetricOperation(loc, metric, grid):
    """A grid metric as a Field at ``loc``: one of ``"dx" | "dy" | "dz" |
    "Ax" | "Ay" | "Az" | "volume"`` (``"V"``)."""
    loc = tuple(loc)
    names = {"dx": grid.dx, "dy": grid.dy, "dz": grid.dz,
             "Ax": grid.Ax, "Ay": grid.Ay, "Az": grid.Az,
             "volume": grid.V, "V": grid.V}
    if metric not in names:
        raise ValueError(f"unknown metric {metric!r} "
                         f"(one of {sorted(names)})")
    data = torch.as_tensor(names[metric](loc), dtype=grid.dtype,
                           device=grid.device).broadcast_to(grid.padded_shape)
    return Field(grid, loc, None, data)


def interpolate(field, x, y, z):
    """``field`` at physical positions by trilinear interpolation with
    fractional indices (``particles.interpolate_field``); ``x, y, z``
    scalars or equal-length arrays or tensors."""
    from ..particles import interpolate_field
    kw = dict(dtype=field.grid.dtype, device=field.data.device)
    x, y, z = (torch.atleast_1d(torch.as_tensor(q, **kw)) for q in (x, y, z))
    out = interpolate_field(field.grid, field.data, field.loc, x, y, z)
    return out[0] if tuple(out.shape) == (1,) else out
