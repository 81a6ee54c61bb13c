"""Background (mean-flow) fields.

Counterpart of ``oceananigans_tpu/background_fields.py``: the prognostic
fields are perturbations about a prescribed background, possibly varying in
time, and the tendencies gain the cross terms

    Gu += -∇·(𝐔 u′) - ∇·(𝐮′ U_bg),   Gc += -∇·(𝐔 c′) - ∇·(𝐮′ c_bg),

with 𝐔 = 𝐮′ + 𝐮_bg; the background's self-advection is left out (it is
taken to satisfy its own balance). A background function is called with the
padded coordinates as broadcastable tensors of the grid's dtype and device
and the time as a Python float.
"""

from __future__ import annotations

import inspect

from .fields.field import as_padded, coordinates, set_on_padded


class BackgroundField:
    """A background ``func(x, y, z, t[, parameters])``; a scalar or an
    array is held constant in time."""

    def __init__(self, func_or_value, parameters=None):
        self.value = func_or_value
        self.parameters = parameters

    def evaluate(self, grid, loc, time):
        v = self.value
        if not callable(v):
            return set_on_padded(grid, loc, v)
        args = (*coordinates(grid, loc), float(time))
        if self.parameters is not None:
            args = args + (self.parameters,)
        return as_padded(grid, v(*args)).contiguous()


def evaluate_background(grid, loc, bg, time):
    """A background entry (a :class:`BackgroundField`, a callable of
    (x, y, z) or (x, y, z, t), a scalar or an array) as a padded tensor. A
    callable of (x, y, z) is evaluated as ``set`` evaluates one: on numpy
    coordinates."""
    if isinstance(bg, BackgroundField):
        return bg.evaluate(grid, loc, time)
    if callable(bg):
        try:
            n = len(inspect.signature(bg).parameters)
        except (TypeError, ValueError):
            n = 3
        if n >= 4:
            return BackgroundField(bg).evaluate(grid, loc, time)
    return set_on_padded(grid, loc, bg)
