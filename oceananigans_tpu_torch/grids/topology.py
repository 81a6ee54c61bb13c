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
