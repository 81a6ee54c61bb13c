"""User forcing of the prognostic fields.

Counterpart of ``oceananigans_tpu/forcings/forcings.py``: the continuous
form f(x, y, z, t, fields..., [p]) at the forced field's location, the
discrete form f(grid, fields, t[, p]), ``Relaxation`` with its masks and
targets, ``AdvectiveForcing`` (the divergence of a prescribed advective
flux), sums of forcings, and ``regularize_forcing``.

Model protocol: every forcing is called as ``F(grid, fields, time)`` on
padded tensors and returns a padded (or broadcastable) tensor or a scalar.
Continuous forms, masks and targets are called with the padded coordinates
as broadcastable tensors of the grid's dtype and device and the time as a
Python float, so they are written with torch operations (or plain
arithmetic). ``FieldTimeSeriesForcing`` interpolates a saved
``FieldTimeSeries`` to the stage's time (the two snapshots picked on the
host, the interpolation on the device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.field import coordinates
from ..grids.topology import LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from ..operators.operators import interp_to

VELOCITY_LOCS = {"u": LOC_FCC, "v": LOC_CFC, "w": LOC_CCF}


class Forcing:
    loc = LOC_CCC

    def __call__(self, grid, fields, time):
        raise NotImplementedError


class ContinuousForcing(Forcing):
    """f(x, y, z, t, *dependencies[, parameters]) at the forced field's
    location (or ``loc``); ``field_dependencies`` name fields passed,
    interpolated to that location, as trailing arguments."""

    def __init__(self, func, loc=None, field_dependencies=(),
                 parameters=None):
        self.func = func
        # None: the forced field's location, set when the model binds it
        self.loc = tuple(loc) if loc is not None else None
        self._dep_locs = None
        if isinstance(field_dependencies, str):
            field_dependencies = (field_dependencies,)
        self.field_dependencies = tuple(field_dependencies)
        self.parameters = parameters

    def bind(self, name, loc=None, locs=None):
        if self.loc is None and loc is not None:
            self.loc = tuple(loc)
        if locs is not None:
            self._dep_locs = dict(locs)
        return self

    def __call__(self, grid, fields, time):
        loc = self.loc or LOC_CCC
        dep_locs = self._dep_locs or VELOCITY_LOCS
        deps = [interp_to(grid, fields[name],
                          dep_locs.get(name, VELOCITY_LOCS.get(name,
                                                               LOC_CCC)),
                          loc)
                for name in self.field_dependencies]
        if self.parameters is not None:
            deps.append(self.parameters)
        return self.func(*coordinates(grid, loc), float(time), *deps)


class DiscreteForcing(Forcing):
    """f(grid, fields, t[, parameters]) on padded tensors."""

    def __init__(self, func, parameters=None):
        self.func = func
        self.parameters = parameters

    def __call__(self, grid, fields, time):
        if self.parameters is not None:
            return self.func(grid, fields, time, self.parameters)
        return self.func(grid, fields, time)


def make_forcing(func=None, parameters=None, field_dependencies=(),
                 discrete_form=False, loc=LOC_CCC):
    """``Forcing(func; parameters, field_dependencies, discrete_form)``: a
    :class:`ContinuousForcing` or a :class:`DiscreteForcing`."""
    if discrete_form:
        if field_dependencies:
            raise ValueError("field_dependencies only apply to the "
                             "continuous form (the discrete form receives "
                             "all fields)")
        return DiscreteForcing(func, parameters=parameters)
    return ContinuousForcing(func, loc=loc,
                             field_dependencies=field_dependencies,
                             parameters=parameters)


class GaussianMask:
    """exp(-(ξ - center)²/(2 width²)) along ``axis``."""

    def __init__(self, center, width, axis=2):
        self.center, self.width, self.axis = center, width, axis

    def __call__(self, x, y, z):
        xi = (x, y, z)[self.axis]
        return torch.exp(-((xi - self.center) ** 2) / (2 * self.width ** 2))


class PiecewiseLinearMask:
    """1 at ``center``, falling linearly to 0 at |ξ - center| = width."""

    def __init__(self, center, width, axis=2):
        self.center, self.width, self.axis = center, width, axis

    def __call__(self, x, y, z):
        xi = (x, y, z)[self.axis]
        return torch.clamp(1 - abs(xi - self.center) / self.width, min=0.0)


class LinearTarget:
    """intercept + gradient·ξ along ``axis``."""

    def __init__(self, intercept=0.0, gradient=0.0, axis=2):
        self.intercept, self.gradient, self.axis = intercept, gradient, axis

    def __call__(self, x, y, z, t):
        return self.intercept + self.gradient * (x, y, z)[self.axis]


class Relaxation(Forcing):
    """F = -rate · mask(x, y, z) · (field - target(x, y, z, t))."""

    def __init__(self, rate, mask=None, target=0.0, field_name=None,
                 loc=None):
        self.rate = float(rate)
        self.mask = mask
        self.target = target
        self.field_name = field_name
        self.loc = tuple(loc) if loc is not None else None

    def bind(self, name, loc=None, locs=None):
        self.field_name = self.field_name or name
        if self.loc is None and loc is not None:
            self.loc = tuple(loc)
        return self

    def __call__(self, grid, fields, time):
        name = self.field_name
        if name is None:
            raise ValueError("Relaxation needs field_name (models bind it "
                             "when it is passed as forcing={name: ...})")
        q = fields[name]
        coords = coordinates(grid, self.loc or LOC_CCC)
        target = self.target
        if callable(target):
            target = target(*coords, float(time))
        m = 1.0 if self.mask is None else self.mask(*coords)
        return -self.rate * m * (q - target)


class AdvectiveForcing(Forcing):
    """The divergence of an extra advective flux with prescribed velocities
    (e.g. a settling velocity): F = -∇·(𝐮ₛ q), Centered(2)."""

    def __init__(self, w=0.0, u=0.0, v=0.0, field_name=None):
        self.u, self.v, self.w = u, v, w
        self.field_name = field_name

    def bind(self, name, loc=None, locs=None):
        self.field_name = self.field_name or name
        return self

    def __call__(self, grid, fields, time):
        from ..advection import Centered
        from ..advection.fluxes import div_Uc
        from ..fields.field import set_on_padded
        q = fields[self.field_name]

        def vel(a):
            if hasattr(a, "data") and hasattr(a, "loc"):     # a Field
                if tuple(a.data.shape) != tuple(grid.padded_shape):
                    return set_on_padded(grid, a.loc, a.interior)
                return a.data
            if np.isscalar(a):
                return torch.full(grid.padded_shape, float(a),
                                  dtype=q.dtype, device=q.device)
            return a

        return -div_Uc(grid, Centered(2), vel(self.u), vel(self.v),
                       vel(self.w), q)


class FieldTimeSeriesForcing(Forcing):
    """Forcing from a saved field time series, linearly interpolated in
    time at each evaluation. ``fts`` is a
    ``simulation.output_readers.FieldTimeSeries`` (or anything with
    ``at_time(t)``) of interior-shaped snapshots on the model's device;
    ``loc`` defaults to the forced field's location."""

    def __init__(self, fts, loc=None):
        self.fts = fts
        self.loc = tuple(loc) if loc is not None else None

    def bind(self, name, loc=None, locs=None):
        if self.loc is None and loc is not None:
            self.loc = tuple(loc)
        return self

    def __call__(self, grid, fields, time):
        from ..fields.field import set_on_padded
        return set_on_padded(grid, self.loc or LOC_CCC,
                             self.fts.at_time(float(time)))


class _FieldForcing(Forcing):
    """A Field used as a constant forcing, re-embedded on the model's grid
    when its padding differs."""

    def __init__(self, field):
        self.field = field

    def bind(self, name, loc=None, locs=None):
        return self

    def __call__(self, grid, fields, time):
        f = self.field
        if tuple(f.data.shape) != tuple(grid.padded_shape):
            from ..fields.field import set_on_padded
            return set_on_padded(grid, f.loc, f.interior)
        return f.data


class MultipleForcings(Forcing):
    """The sum of several forcings."""

    def __init__(self, *forcings):
        self.forcings = forcings

    def bind(self, name, loc=None, locs=None):
        for f in self.forcings:
            if hasattr(f, "bind"):
                f.bind(name, loc, locs=locs)
        return self

    def __call__(self, grid, fields, time):
        total = 0
        for f in self.forcings:
            total = total + f(grid, fields, time)
        return total


def regularize_forcing(forcing):
    """A model's ``forcing=`` dict normalized: tuples and lists become
    :class:`MultipleForcings`, Fields constant forcings."""
    out = {}
    for name, F in dict(forcing or {}).items():
        if isinstance(F, (tuple, list)):
            F = MultipleForcings(*F)
        if hasattr(F, "interior") and hasattr(F, "loc"):
            F = _FieldForcing(F)
        out[name] = F
    return out
