"""Boundary condition types and their regularization.

Counterpart of ``oceananigans_tpu/boundary_conditions/boundary_condition.py``.
A field's conditions default from its grid's topology: periodic on periodic
sides, impenetrable (Open, value 0) for a wall-normal velocity on a bounded
side, no-flux for everything else on a bounded side. On any bounded side the
user may set ``ValueBoundaryCondition``, ``GradientBoundaryCondition`` or
``FluxBoundaryCondition`` with a scalar (or no) condition. On the z sides a
``FluxBoundaryCondition`` may also take a callable ``f(ξ1, ξ2, t, *values)``
of the two transverse coordinates (broadcastable tensors of the grid's dtype
and device at the field's location), the time (a Python float) and, with
``field_dependencies``, the named fields' boundary-cell values at the field's
location, or a ``FieldTimeSeriesBoundaryCondition``: a saved series of the
boundary plane's interior, interpolated in time and padded over the halo
ring by topology (wrapped on a periodic axis, its edge repeated on a bounded
one), as the JAX condition is. The ``immersed`` slot of
``FieldBoundaryConditions`` holds an
``ImmersedBoundaryCondition`` (or one condition for every side) of Flux,
Value or Gradient conditions applied where a fluid cell touches the solid of
an immersed grid. Array conditions, callable or FieldTimeSeries conditions
on the x and y sides or of another classification, and Open conditions with
a value are not ported yet and raise.

Two conditions come from the grid, not the user, on a side the user leaves
empty: the tripolar fold (``ZIPPER``, ``ZipperBoundaryCondition``) on the
north side of a ``TripolarGrid``, with sign −1 for fields at a face in x or
y and +1 otherwise; and the polar cap (``PolarBoundaryCondition``) on a
side of a ``LatitudeLongitudeGrid`` that ends at a pole: Value with the
zonal mean of the boundary row (``PolarValue``) for fields centred in y,
Open with that mean (the pole face pinned to it) for y-face fields.
"""

from __future__ import annotations

import numpy as np

from ..grids.topology import BOUNDED, FACE, FLAT, PERIODIC

PERIODIC_BC = "periodic"
FLUX = "flux"
VALUE = "value"
GRADIENT = "gradient"
OPEN = "open"
ZIPPER = "zipper"   # the tripolar north fold; the condition is its sign

USER_BCS_ITEM = "ROADMAP.md queue 1 item 3 (boundary_conditions/)"


class PolarValue:
    """The pole-cap condition: the boundary value is the zonal mean of the
    field's own boundary row over the interior x, taken anew at every
    fill."""

    __slots__ = ("side",)

    def __init__(self, side):
        self.side = side

    def _fp(self):
        return ("PolarValue", self.side)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, other):
        return isinstance(other, PolarValue) and self._fp() == other._fp()

    def __repr__(self):
        return f"PolarValue({self.side!r})"


class BoundaryCondition:
    __slots__ = ("classification", "condition", "field_dependencies")

    def __init__(self, classification, condition=None, field_dependencies=()):
        self.classification = classification
        self.condition = condition
        if isinstance(field_dependencies, str):
            field_dependencies = (field_dependencies,)
        self.field_dependencies = tuple(field_dependencies)

    def _fp(self):
        return (self.classification, self.condition, self.field_dependencies)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, other):
        return (isinstance(other, BoundaryCondition)
                and self._fp() == other._fp())

    def __repr__(self):
        return f"BoundaryCondition({self.classification}, {self.condition})"


def PeriodicBoundaryCondition():
    return BoundaryCondition(PERIODIC_BC)


def FluxBoundaryCondition(condition=None, field_dependencies=()):
    """``field_dependencies`` names fields whose boundary-cell values, at
    this field's location, a callable condition receives as trailing
    arguments: ``f(ξ1, ξ2, t, *values)`` (a quadratic drag, for one)."""
    return BoundaryCondition(FLUX, condition,
                             field_dependencies=field_dependencies)


def ValueBoundaryCondition(condition=None):
    return BoundaryCondition(VALUE, condition)


def GradientBoundaryCondition(condition=None):
    return BoundaryCondition(GRADIENT, condition)


def ImpenetrableBoundaryCondition():
    """No-penetration: wall-normal velocity face pinned to zero."""
    return BoundaryCondition(OPEN, None)


def ZipperBoundaryCondition(sign=1.0):
    """The tripolar north fold; ``sign`` is -1 for velocity-like fields and
    +1 for tracer-like ones."""
    return BoundaryCondition(ZIPPER, float(sign))


def PolarBoundaryCondition(side, loc_y):
    """The pole cap of a pole-touching lat-lon grid: Value with the zonal
    mean of the boundary row for a field centred in y, Open (the pole face
    pinned to the mean) for a y-face field."""
    return BoundaryCondition(OPEN if loc_y == FACE else VALUE,
                             PolarValue(side))


def _grid_condition(grid, side, loc):
    """The fold or polar condition that ``grid`` puts on ``side`` of a field
    at ``loc``, or None."""
    if side == "north" and getattr(grid, "zipper_north", False):
        return ZipperBoundaryCondition(
            -1.0 if FACE in (loc[0], loc[1]) else 1.0)
    if side in ("south", "north") and getattr(grid, f"polar_{side}", False):
        return PolarBoundaryCondition(side, loc[1])
    return None


_SIDES = ("west", "east", "south", "north", "bottom", "top")
# side index → (axis, is_left)
SIDE_AXIS = {"west": (0, True), "east": (0, False),
             "south": (1, True), "north": (1, False),
             "bottom": (2, True), "top": (2, False)}


class ImmersedBoundaryCondition:
    """Per-side conditions at immersed faces (the ``immersed`` slot of
    ``FieldBoundaryConditions``): each side's Flux, Value or Gradient
    condition applies where a fluid cell touches the solid from that
    side."""

    __slots__ = _SIDES

    def __init__(self, west=None, east=None, south=None, north=None,
                 bottom=None, top=None):
        for name, bc in zip(_SIDES, (west, east, south, north, bottom, top)):
            if bc is not None and bc.classification not in (FLUX, VALUE,
                                                            GRADIENT):
                raise NotImplementedError(
                    "immersed boundary conditions must be Flux, Value or "
                    f"Gradient (got {bc.classification!r} on {name})")
            setattr(self, name, bc)

    def side(self, name):
        return getattr(self, name)

    def _fp(self):
        return ("ImmersedBoundaryCondition",) + tuple(
            getattr(self, s)._fp() if getattr(self, s) is not None else None
            for s in self.__slots__)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return (isinstance(o, ImmersedBoundaryCondition)
                and self._fp() == o._fp())


class FieldBoundaryConditions:
    """Per-side container (west/east/south/north/bottom/top) and the
    ``immersed`` slot."""

    __slots__ = _SIDES + ("immersed",)

    def __init__(self, west=None, east=None, south=None, north=None,
                 bottom=None, top=None, immersed=None):
        self.west, self.east = west, east
        self.south, self.north = south, north
        self.bottom, self.top = bottom, top
        self.immersed = immersed

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
        side: (_grid_condition(grid, side, loc)
               or default_bc(grid.topology[axis], loc[axis]))
        for side, (axis, _) in SIDE_AXIS.items()})


def _check_user_bc(bc, side, axis, grid):
    """Raise unless ``bc`` is a condition the port takes on this side."""
    topo = grid.topology[axis]
    if bc.classification == ZIPPER or isinstance(bc.condition, PolarValue):
        if side != "north" and bc.classification == ZIPPER:
            raise ValueError("a zipper condition folds the north side only")
        return
    if topo == PERIODIC:
        if bc.classification != PERIODIC_BC:
            raise ValueError(f"cannot set {bc.classification} BC on {side} "
                             "of a periodic direction")
        return
    if topo == FLAT:
        raise ValueError(f"cannot set a BC on {side} of a flat direction")
    cond = bc.condition
    z_flux_function = ((callable(cond) or hasattr(cond, "evaluate_padded"))
                       and axis == 2 and bc.classification == FLUX)
    if cond is not None and not z_flux_function and (
            callable(cond) or not np.isscalar(cond)):
        raise NotImplementedError(
            f"{side} {bc.classification} BC with a non-scalar condition "
            f"{cond!r}: only scalar conditions, and callable or "
            f"FieldTimeSeries Flux conditions on the z sides, are ported: "
            f"{USER_BCS_ITEM}")
    if bc.field_dependencies and not z_flux_function:
        raise NotImplementedError(
            f"{side} {bc.classification} BC with field dependencies: only a "
            f"callable Flux condition on a z side takes them: "
            f"{USER_BCS_ITEM}")
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
            kw[side] = (_grid_condition(grid, side, loc)
                        or default_bc(grid.topology[axis], loc[axis]))
        else:
            _check_user_bc(user, side, axis, grid)
            kw[side] = user
    kw["immersed"] = bcs.immersed
    return FieldBoundaryConditions(**kw)


def FieldTimeSeriesBoundaryCondition(fts, classification=FLUX,
                                     field_dependencies=()):
    """A boundary condition driven by a saved field time series
    (``simulation.output_readers.FieldTimeSeries``), interpolated in time at
    each evaluation. The snapshots cover the interior of a z-normal
    boundary plane, shape ``(Nx, Ny)`` or ``(Nx, Ny, 1)``, on the model's
    device; the port takes it as a Flux condition on a z side."""
    return BoundaryCondition(classification,
                             _FieldTimeSeriesCondition(fts),
                             field_dependencies=field_dependencies)


def _pad_index(n, lo, hi, periodic, device):
    """Indices of an axis of ``n`` slots padded by ``lo`` and ``hi``: the
    wrapped ones on a periodic axis, the edge repeated elsewhere."""
    import torch
    idx = torch.arange(-lo, n + hi, device=device)
    return idx.remainder(n) if periodic else idx.clamp(0, n - 1)


class _FieldTimeSeriesCondition:
    """The condition of ``FieldTimeSeriesBoundaryCondition``: the series at
    the time, over the padded boundary plane."""

    __slots__ = ("fts",)

    def __init__(self, fts):
        self.fts = fts

    def evaluate_padded(self, grid, time):
        """The plane (Nx + 2Hx, Ny + 2Hy, 1) at ``time``."""
        a = self.fts.at_time(float(time))
        a = a.reshape(a.shape[0], a.shape[1], -1)[..., :1]
        for ax in range(2):
            npad = grid.padded_shape[ax] - a.shape[ax]
            a = a.index_select(ax, _pad_index(
                a.shape[ax], npad // 2, npad - npad // 2,
                grid.topology[ax] == PERIODIC, a.device))
        return a.to(grid.dtype)
