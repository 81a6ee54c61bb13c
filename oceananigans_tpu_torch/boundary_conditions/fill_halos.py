"""Halo filling for the default boundary conditions.

Counterpart of ``oceananigans_tpu/boundary_conditions/fill_halos.py``, cut to
what the flagship needs: the periodic x/y wrap, done in place by the batched
halo-fill kernel (``kernels/halo_fill.py``), and the z-compact skip: a
bounded z axis with no halo (``H[2] == 0``) has its boundary values applied
inside the stencil reads (``operators/shifts.py`` ``shift_zbc``). Other
topologies and z halos raise.
"""

from __future__ import annotations

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from .boundary_condition import USER_BCS_ITEM

_Z_HALO_ITEM = "ROADMAP.md queue 2, kernel #5 z-fix (bounded-z halo fill)"


def check_fillable(grid):
    """Raise unless the grid's halos are what this module fills: periodic
    (or flat) x and y, and a halo-free bounded (or flat) z."""
    for axis in (0, 1):
        if grid.topology[axis] not in (PERIODIC, FLAT):
            raise NotImplementedError(
                f"bounded x/y halo fills are not ported yet: {USER_BCS_ITEM}")
    if grid.topology[2] == PERIODIC:
        raise NotImplementedError(
            f"periodic z halo fills are not ported yet: {USER_BCS_ITEM}")
    if grid.topology[2] == BOUNDED and grid.H[2] != 0:
        raise NotImplementedError(
            f"bounded z halos are not ported yet: {_Z_HALO_ITEM}")


def fill_all_halo_regions(arrays, grid):
    """Refresh the halos of several padded tensors on one grid, in place, in
    one batched kernel launch."""
    from ..kernels.halo_fill import periodic_halo_fill
    check_fillable(grid)
    return periodic_halo_fill(grid, list(arrays))
