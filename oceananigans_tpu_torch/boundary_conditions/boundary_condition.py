"""Boundary condition types and their regularization.

Counterpart of ``oceananigans_tpu/boundary_conditions/boundary_condition.py``.
A field's conditions default from its grid's topology: periodic on periodic
sides, impenetrable (Open, value 0) for a wall-normal velocity on a bounded
side, no-flux for everything else on a bounded side. On any bounded side the
user may set ``ValueBoundaryCondition``, ``GradientBoundaryCondition``,
``FluxBoundaryCondition`` or ``OpenBoundaryCondition`` (optionally with the
``PerturbationAdvection`` scheme) with a condition that is None, a scalar,
an array over the boundary plane's interior (``(N1, N2)``, the two
transverse axes in order, padded over the halos by topology: wrapped along a
periodic axis, its edge repeated along the others) or broadcastable against
the padded plane, or a callable ``f(ξ1, ξ2, t)`` of the two transverse
padded coordinates (broadcastable tensors of the grid's dtype and device at
the field's location) and the time (a Python float). A callable Flux
condition may name ``field_dependencies``: the named fields' boundary-cell
values at the field's location follow as trailing arguments. A
``FieldTimeSeriesBoundaryCondition`` (a saved series of a z-normal boundary
plane's interior, interpolated in time and padded over the halo ring by
topology, as the JAX condition is) takes any classification on a z side;
the JAX condition pads its snapshots as z-normal planes, so the port refuses
it on an x or y side. The ``immersed`` slot of ``FieldBoundaryConditions``
holds an ``ImmersedBoundaryCondition`` (or one condition for every side) of
Flux, Value or Gradient conditions applied where a fluid cell touches the
solid of an immersed grid; its conditions are scalars, arrays of the
side's plane or callables of its transverse coordinates and the time, as
the JAX ``eval_bc`` takes them.

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

from ..grids.topology import BOUNDED, FACE, FLAT, FULLY_CONNECTED, PERIODIC

PERIODIC_BC = "periodic"
FLUX = "flux"
VALUE = "value"
GRADIENT = "gradient"
OPEN = "open"
ZIPPER = "zipper"   # the tripolar north fold; the condition is its sign



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


class PerturbationAdvection:
    """The open-boundary scheme of the wall-normal velocity: a
    backward-Euler upwind step of the boundary face toward the exterior
    value, relaxed with the inflow and outflow timescales (0 pins the face
    to the exterior value, ∞ does not relax)."""

    __slots__ = ("inflow_timescale", "outflow_timescale")

    def __init__(self, inflow_timescale=0.0, outflow_timescale=np.inf):
        self.inflow_timescale = float(inflow_timescale)
        self.outflow_timescale = float(outflow_timescale)

    def _fp(self):
        return ("PerturbationAdvection", self.inflow_timescale,
                self.outflow_timescale)

    def __repr__(self):
        return (f"PerturbationAdvection({self.inflow_timescale}, "
                f"{self.outflow_timescale})")


def _condition_fp(c):
    """A hashable fingerprint of a condition: the value of a scalar or
    None, the bytes of an array, the identity of a callable."""
    if c is None or isinstance(c, (int, float, np.number)):
        return c
    if hasattr(c, "_fp"):
        return c._fp()
    if callable(c) or hasattr(c, "evaluate_padded"):
        return ("identity", id(c))
    a = np.asarray(c.detach().cpu() if hasattr(c, "detach") else c)
    return ("array", a.shape, a.dtype.str, a.tobytes())


class BoundaryCondition:
    __slots__ = ("classification", "condition", "scheme",
                 "field_dependencies")

    def __init__(self, classification, condition=None, scheme=None,
                 field_dependencies=()):
        self.classification = classification
        self.condition = condition
        self.scheme = scheme
        if isinstance(field_dependencies, str):
            field_dependencies = (field_dependencies,)
        self.field_dependencies = tuple(field_dependencies)

    def _fp(self):
        return (self.classification, _condition_fp(self.condition),
                None if self.scheme is None else self.scheme._fp(),
                self.field_dependencies)

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


def OpenBoundaryCondition(condition=None, scheme=None):
    """Open (cross-boundary flow) condition: a wall-normal velocity's
    boundary face takes ``condition`` (the exterior value);
    ``scheme=PerturbationAdvection(...)`` steps it toward that value
    instead, where the fill is given the stage's Δt."""
    return BoundaryCondition(OPEN, condition, scheme)


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
    if topology_axis in (FLAT, FULLY_CONNECTED):
        return None
    if loc_axis == FACE:
        return ImpenetrableBoundaryCondition()   # wall-normal velocity
    return FluxBoundaryCondition(None)           # no-flux for centered fields


def default_bcs(grid, loc):
    return FieldBoundaryConditions(**{
        side: (_grid_condition(grid, side, loc)
               or default_bc(grid.topology[axis], loc[axis]))
        for side, (axis, _) in SIDE_AXIS.items()})


def is_plane_condition(cond):
    """True for a condition that varies over the boundary plane or in time
    (an array, a callable, a FieldTimeSeries condition); False for None and
    scalars (and the grid's fold and polar conditions)."""
    return not (cond is None or isinstance(cond, (int, float, np.number,
                                                  PolarValue)))


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
    if topo in (FLAT, FULLY_CONNECTED):
        raise ValueError(f"cannot set a BC on {side} of a {topo} direction")
    if bc.classification not in (FLUX, VALUE, GRADIENT, OPEN):
        raise ValueError(f"unknown classification {bc.classification!r}")
    cond = bc.condition
    if hasattr(cond, "evaluate_padded") and axis != 2:
        raise NotImplementedError(
            f"{side} FieldTimeSeries condition: a FieldTimeSeries condition "
            "pads its snapshots as z-normal planes (evaluate_padded), so it "
            "takes the bottom and top sides only, as in the JAX package")
    if bc.field_dependencies and bc.classification != FLUX:
        raise ValueError(
            f"{side} {bc.classification} BC with field dependencies: only a "
            "Flux condition takes them (the fill evaluates conditions "
            "without the model state; a scalar ignores them)")
    if bc.scheme is not None and (
            bc.classification != OPEN
            or not isinstance(bc.scheme, PerturbationAdvection)):
        raise ValueError(f"{side}: a scheme belongs to an Open condition "
                         "and must be PerturbationAdvection")


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
