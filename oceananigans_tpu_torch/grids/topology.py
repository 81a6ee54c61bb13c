"""Topologies and staggered-grid locations.

Counterpart of ``oceananigans_tpu/grids/topology.py``: topologies are plain
strings and a field's location is a 3-tuple of ``"c"`` (Center) and ``"f"``
(Face), e.g. ``("f", "c", "c")`` for the u-velocity on an Arakawa C grid.
"""

from __future__ import annotations

PERIODIC = "periodic"
BOUNDED = "bounded"
FLAT = "flat"
# a cubed-sphere panel's x and y: the halos hold the neighbouring panels'
# data, written by the panel exchange; stencils treat the axis as unbounded
# and no fill or boundary condition acts on it
FULLY_CONNECTED = "fully_connected"

TOPOLOGIES = (PERIODIC, BOUNDED, FLAT, FULLY_CONNECTED)

CENTER = "c"
FACE = "f"

LOC_CCC = (CENTER, CENTER, CENTER)  # tracers, pressure
LOC_FCC = (FACE, CENTER, CENTER)    # u
LOC_CFC = (CENTER, FACE, CENTER)    # v
LOC_CCF = (CENTER, CENTER, FACE)    # w


def validate_topology(topo):
    topo = tuple(topo)
    if len(topo) != 3:
        raise ValueError(f"topology must have 3 entries, got {topo}")
    for t in topo:
        if t not in TOPOLOGIES:
            raise ValueError(f"unknown topology {t!r}; expected one of {TOPOLOGIES}")
    return topo


def validate_location(loc):
    loc = tuple(loc)
    if len(loc) != 3:
        raise ValueError(f"location must have 3 entries, got {loc}")
    for l in loc:
        if l not in (CENTER, FACE, None):
            raise ValueError(f"unknown location {l!r}")
    return loc


def side_connected(grid, axis):
    """(low, high): whether each side of ``axis`` of a shard's grid is
    connected to another shard (its halo comes from the halo exchange and
    no boundary condition acts on it); (False, False) on any other grid."""
    c = getattr(grid, "connected", None)
    return (False, False) if c is None else tuple(c[axis])


def wall_sides(grid, axis):
    """(low, high): whether each side of ``axis`` is a wall of the global
    grid, where the boundary conditions act: both sides of a bounded axis,
    but on a shard's grid only the sides that are the global grid's own
    (the low side of the first shard along the axis, the high side of the
    last, the tripolar fold of the top row: ``grid.walls``); (False, False)
    on an axis that is not bounded."""
    if grid.topology[axis] != BOUNDED:
        return (False, False)
    walls = getattr(grid, "walls", None)
    if walls is not None:
        return tuple(walls[axis])
    lo, hi = side_connected(grid, axis)
    return (not lo, not hi)


def global_extent(grid, axis):
    """(offset, N): the global index of the grid's first interior cell along
    ``axis`` and the global grid's interior cells there ((0, N) on a grid
    that is no shard's): the near-wall order cascades count from the
    global walls."""
    shard = getattr(grid, "shard", None)
    if shard is None or axis == 2:
        return 0, grid.N[axis]
    return shard.offset[axis], shard.global_grid.N[axis]
