"""Halo filling and boundary-flux tendencies.

Counterpart of ``oceananigans_tpu/boundary_conditions/fill_halos.py`` for
periodic, bounded or flat x and y and a bounded (or flat) z, in the
reference's x → y → z order, so that corners come out as in JAX. Every fill
goes through ``kernels/halo_fill.py`` ``fill_halos``: one launch for a batch
of fields on the card, filling every axis (a periodic wrap; on a bounded
axis ``_fill_axis``: center fields mirror the interior under Flux/Open and
extrapolate linearly from the boundary cell under Value/Gradient, the
wall-normal face field is pinned at the boundary face under Open/Value and
reflected about it), and its plain version on the CPU. A bounded z with no
halo (``H[2] == 0``, the z-compact layout) has its boundary values applied
inside the stencil reads instead. ``apply_flux_bcs`` (interior-shaped
tendencies) and ``apply_flux_bcs_padded`` (padded tendencies) add the
boundary-flux divergence of Flux conditions with a scalar value to a
tendency.

Every fill updates the tensors in place and returns them. A periodic z
raises.
"""

from __future__ import annotations

from ..grids.topology import BOUNDED, CENTER, FACE, PERIODIC
from .boundary_condition import FLUX, SIDE_AXIS, USER_BCS_ITEM


def check_fillable(grid):
    """Raise unless the grid's halos are what this module fills: a bounded
    (or flat) z."""
    if grid.topology[2] == PERIODIC:
        raise NotImplementedError(
            f"periodic z halo fills are not ported yet: {USER_BCS_ITEM}")


def _check_conditions(arrays, grid, locs_bcs, axes):
    if any(grid.topology[ax] == BOUNDED and grid.H[ax] > 0 for ax in axes) \
            and (locs_bcs is None or len(locs_bcs) != len(arrays)):
        raise ValueError("a bounded halo fill needs each field's location "
                         "and boundary conditions")


def fill_all_halo_regions(arrays, grid, locs_bcs=None):
    """Refresh the halos of several padded tensors of one shape on one
    grid, in place: one fill launch for all of them, every axis.
    ``locs_bcs`` gives each tensor's (location, boundary conditions); it is
    needed when the grid has a bounded x or y or a z halo."""
    from ..kernels.halo_fill import fill_halos
    check_fillable(grid)
    arrays = list(arrays)
    _check_conditions(arrays, grid, locs_bcs, (0, 1, 2))
    return fill_halos(grid, arrays, locs_bcs)


def fill_halo_regions(a, grid, loc, bcs):
    """Refresh all halos of one padded tensor in place; returns it."""
    return fill_all_halo_regions([a], grid, [(loc, bcs)])[0]


def fill_surface_halo_regions(arrays, grid, locs_bcs):
    """Refresh the x and y halos of padded tensors of one shape (2-D
    surface fields (Nx + 2Hx, Ny + 2Hy, 1), or 3-D ones over their full z)
    in place, one fill launch for all of them (the JAX
    ``fill_halo_axes(..., (0, 1))``); returns them."""
    from ..kernels.halo_fill import fill_halos
    arrays = list(arrays)
    _check_conditions(arrays, grid, locs_bcs, (0, 1))
    return fill_halos(grid, arrays, locs_bcs, z=False)


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


def _boundary_slice(metric, axis, i):
    """A metric (Python scalar or broadcastable tensor) at padded index
    ``i`` along ``axis``, dims kept."""
    if isinstance(metric, (int, float)) or metric.shape[axis] == 1:
        return metric
    return metric.narrow(axis, i, 1)


def apply_flux_bcs_padded(G, grid, loc, bcs):
    """``apply_flux_bcs`` on a padded tendency, as the JAX function does it:
    the boundary face's area at the flipped location over the boundary
    cell's volume, at padded slots H (west/south/bottom) and H+N-1
    (east/north/top); in place, returns G."""
    for side, (axis, is_left) in SIDE_AXIS.items():
        if grid.topology[axis] != BOUNDED:
            continue
        bc = bcs.side(side)
        if bc is None or bc.classification != FLUX or bc.condition is None:
            continue
        H, N = grid.H[axis], grid.N[axis]
        floc = list(loc)
        floc[axis] = FACE if loc[axis] == CENTER else CENTER
        A = (grid.Ax, grid.Ay, grid.Az)[axis](tuple(floc))
        cell = H if is_left else H + N - 1
        AoV = (_boundary_slice(A, axis, H if is_left else H + N)
               / _boundary_slice(grid.V(loc), axis, cell))
        sgn = 1.0 if is_left else -1.0
        G.narrow(axis, cell, 1).add_(sgn * float(bc.condition) * AoV)
    return G
