"""Boundary condition types: the default regularization the flagship needs.

Counterpart of ``oceananigans_tpu/boundary_conditions/boundary_condition.py``,
cut to the defaults that a field gets from its grid's topology: periodic on
periodic sides, impenetrable (Open, value 0) for a wall-normal velocity on a
bounded side, no-flux for everything else on a bounded side. User-supplied
conditions (Value, Gradient, Flux with a condition, Open with a scheme) are
not ported yet and raise.
"""

from __future__ import annotations

from ..grids.topology import FACE, FLAT, PERIODIC

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


def regularize_field_boundary_conditions(bcs, grid, loc):
    """The topology defaults; any user-supplied condition raises."""
    if bcs is not None and bcs != default_bcs(grid, loc):
        raise NotImplementedError(
            f"user boundary conditions are not ported yet: {USER_BCS_ITEM}")
    return default_bcs(grid, loc)
