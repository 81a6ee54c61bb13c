"""Boundary condition types and their regularization.

Counterpart of ``oceananigans_tpu/boundary_conditions/boundary_condition.py``.
A field's conditions default from its grid's topology: periodic on periodic
sides, impenetrable (Open, value 0) for a wall-normal velocity on a bounded
side, no-flux for everything else on a bounded side. On any bounded side the
user may set ``ValueBoundaryCondition``, ``GradientBoundaryCondition`` or
``FluxBoundaryCondition`` with a scalar (or no) condition. Callable or array
conditions, field dependencies and Open conditions with a value or a scheme
are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np

from ..grids.topology import BOUNDED, FACE, FLAT, PERIODIC

PERIODIC_BC = "periodic"
FLUX = "flux"
VALUE = "value"
GRADIENT = "gradient"
OPEN = "open"

USER_BCS_ITEM = "ROADMAP.md queue 1 item 3 (boundary_conditions/)"


class BoundaryCondition:
    __slots__ = ("classification", "condition")

    def __init__(self, classification, condition=None):
        self.classification = classification
        self.condition = condition

    def _fp(self):
        return (self.classification, self.condition)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, other):
        return (isinstance(other, BoundaryCondition)
                and self._fp() == other._fp())

    def __repr__(self):
        return f"BoundaryCondition({self.classification}, {self.condition})"


def PeriodicBoundaryCondition():
    return BoundaryCondition(PERIODIC_BC)


def FluxBoundaryCondition(condition=None):
    return BoundaryCondition(FLUX, condition)


def ValueBoundaryCondition(condition=None):
    return BoundaryCondition(VALUE, condition)


def GradientBoundaryCondition(condition=None):
    return BoundaryCondition(GRADIENT, condition)


def ImpenetrableBoundaryCondition():
    """No-penetration: wall-normal velocity face pinned to zero."""
    return BoundaryCondition(OPEN, None)


_SIDES = ("west", "east", "south", "north", "bottom", "top")
# side index → (axis, is_left)
SIDE_AXIS = {"west": (0, True), "east": (0, False),
             "south": (1, True), "north": (1, False),
             "bottom": (2, True), "top": (2, False)}


class FieldBoundaryConditions:
    """Per-side container (west/east/south/north/bottom/top)."""

    __slots__ = _SIDES

    def __init__(self, west=None, east=None, south=None, north=None,
                 bottom=None, top=None):
        self.west, self.east = west, east
        self.south, self.north = south, north
        self.bottom, self.top = bottom, top

    def side(self, name):
        return getattr(self, name)

    def pair(self, axis):
        return (self.side(_SIDES[2 * axis]), self.side(_SIDES[2 * axis + 1]))

    def _fp(self):
        return tuple(getattr(self, s)._fp() if getattr(self, s) is not None
                     else None for s in self.__slots__)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, other):
        return (isinstance(other, FieldBoundaryConditions)
                and self._fp() == other._fp())

    def __repr__(self):
        parts = [f"{s}={getattr(self, s)!r}" for s in self.__slots__
                 if getattr(self, s) is not None]
        return "FieldBoundaryConditions(" + ", ".join(parts) + ")"


def default_bc(topology_axis, loc_axis):
    """Default BC for one side of one direction, from topology + location."""
    if topology_axis == PERIODIC:
        return PeriodicBoundaryCondition()
    if topology_axis == FLAT:
        return None
    if loc_axis == FACE:
        return ImpenetrableBoundaryCondition()   # wall-normal velocity
    return FluxBoundaryCondition(None)           # no-flux for centered fields


def default_bcs(grid, loc):
    return FieldBoundaryConditions(**{
        side: default_bc(grid.topology[axis], loc[axis])
        for side, (axis, _) in SIDE_AXIS.items()})


def _check_user_bc(bc, side, axis, grid):
    """Raise unless ``bc`` is a condition the port takes on this side."""
    topo = grid.topology[axis]
    if topo == PERIODIC:
        if bc.classification != PERIODIC_BC:
            raise ValueError(f"cannot set {bc.classification} BC on {side} "
                             "of a periodic direction")
        return
    if topo == FLAT:
        raise ValueError(f"cannot set a BC on {side} of a flat direction")
    cond = bc.condition
    if cond is not None and (callable(cond) or not np.isscalar(cond)):
        raise NotImplementedError(
            f"{side} {bc.classification} BC with a non-scalar condition "
            f"{cond!r}: only scalar conditions are ported: {USER_BCS_ITEM}")
    if bc.classification == OPEN and cond is not None:
        raise NotImplementedError(
            f"{side} Open BC with a value: only the impenetrable (None) Open "
            f"condition is ported: {USER_BCS_ITEM}")
    if bc.classification not in (FLUX, VALUE, GRADIENT, OPEN):
        raise ValueError(f"unknown classification {bc.classification!r}")


def regularize_field_boundary_conditions(bcs, grid, loc):
    """Fill missing sides with the topology defaults; user conditions are
    checked against what the port takes (see the module docstring)."""
    if bcs is None:
        return default_bcs(grid, loc)
    kw = {}
    for side, (axis, _) in SIDE_AXIS.items():
        user = bcs.side(side)
        if user is None:
            kw[side] = default_bc(grid.topology[axis], loc[axis])
        else:
            _check_user_bc(user, side, axis, grid)
            kw[side] = user
    return FieldBoundaryConditions(**kw)
