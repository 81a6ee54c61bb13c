"""Halo filling and boundary-flux tendencies.

Counterpart of ``oceananigans_tpu/boundary_conditions/fill_halos.py`` for
periodic (or flat) x and y and a bounded (or flat) z:

- the periodic x/y wrap, over the full padded z, by the batched halo-fill
  kernel (``kernels/halo_fill.py`` ``periodic_halo_fill``);
- the bounded-z fill of ``_fill_axis`` (Flux/Open mirror, Value/Gradient
  extrapolation for center fields; pinned or reflected faces for z-face
  fields) by the bounded-z kernel (``bounded_z_fill``), after the wrap, so
  that corners carry wrapped columns (the reference's x → y → z order). A
  bounded z with no halo (``H[2] == 0``, the z-compact layout) has its
  boundary values applied inside the stencil reads instead;
- ``apply_flux_bcs``: the boundary-flux divergence of Flux conditions with a
  scalar value, added to a tendency.

Every fill updates the tensors in place and returns them. Bounded x/y and
periodic z raise.
"""

from __future__ import annotations

from ..grids.topology import BOUNDED, CENTER, FACE, FLAT, PERIODIC
from .boundary_condition import (FLUX, GRADIENT, OPEN, SIDE_AXIS, VALUE,
                                 USER_BCS_ITEM)

_CODES = {FLUX: 0, OPEN: 1, VALUE: 2, GRADIENT: 3}


def check_fillable(grid):
    """Raise unless the grid's halos are what this module fills: periodic
    (or flat) x and y, and a bounded (or flat) z."""
    for axis in (0, 1):
        if grid.topology[axis] not in (PERIODIC, FLAT):
            raise NotImplementedError(
                f"bounded x/y halo fills are not ported yet: {USER_BCS_ITEM}")
    if grid.topology[2] == PERIODIC:
        raise NotImplementedError(
            f"periodic z halo fills are not ported yet: {USER_BCS_ITEM}")


def z_fill_spec(loc, bcs):
    """The bounded-z fill of one field (``kernels.halo_fill.ZFill``): its z
    location and the (classification code, scalar value) of its bottom and
    top conditions (None counts as 0)."""
    from ..kernels.halo_fill import ZFill

    def side(bc):
        if bc is None:
            return (_CODES[FLUX], 0.0)
        cond = 0.0 if bc.condition is None else float(bc.condition)
        return (_CODES[bc.classification], cond)

    return ZFill(loc[2] == FACE, side(bcs.bottom), side(bcs.top))


def fill_all_halo_regions(arrays, grid, locs_bcs=None):
    """Refresh the halos of several padded tensors on one grid, in place:
    one wrap launch for all of them, then, with a z halo, one bounded-z
    launch. ``locs_bcs`` gives each tensor's (location, boundary
    conditions); it is needed only when the grid has a z halo."""
    from ..kernels.halo_fill import bounded_z_fill, periodic_halo_fill
    check_fillable(grid)
    arrays = periodic_halo_fill(grid, list(arrays))
    if grid.topology[2] == BOUNDED and grid.H[2] > 0:
        if locs_bcs is None or len(locs_bcs) != len(arrays):
            raise ValueError("a z halo fill needs each field's location and "
                             "boundary conditions")
        bounded_z_fill(grid, arrays,
                       [z_fill_spec(loc, bcs) for loc, bcs in locs_bcs])
    return arrays


def fill_halo_regions(a, grid, loc, bcs):
    """Refresh all halos of one padded tensor in place; returns it."""
    return fill_all_halo_regions([a], grid, [(loc, bcs)])[0]


def apply_flux_bcs(G, grid, loc, bcs):
    """Add boundary-flux divergences to an interior-shaped tendency, in place
    (``G[first] += q·A/V`` on west/south/bottom, ``G[last] -= q·A/V`` on
    east/north/top, for Flux conditions with a scalar value q); returns G."""
    for side, (axis, is_left) in SIDE_AXIS.items():
        if grid.topology[axis] != BOUNDED:
            continue
        bc = bcs.side(side)
        if bc is None or bc.classification != FLUX or bc.condition is None:
            continue
        floc = list(loc)
        floc[axis] = FACE if loc[axis] == CENTER else CENTER
        A = (grid.Ax, grid.Ay, grid.Az)[axis](tuple(floc))
        AoV = A / grid.V(loc)
        sgn = 1.0 if is_left else -1.0
        boundary = G.narrow(axis, 0 if is_left else grid.N[axis] - 1, 1)
        boundary += sgn * float(bc.condition) * AoV
    return G
