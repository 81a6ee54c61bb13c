"""Halo filling and boundary-flux tendencies.

Counterpart of ``oceananigans_tpu/boundary_conditions/fill_halos.py`` for
periodic, bounded or flat x and y and a bounded (or flat) z, in the
reference's x → y → z order, so that corners come out as in JAX:

- a bounded x or y: ``_fill_axis`` in plain PyTorch (``fill_bounded_axis``):
  center fields mirror the interior under Flux/Open and extrapolate linearly
  from the boundary cell under Value/Gradient; the wall-normal face field is
  pinned at the boundary face (the first halo slot) under Open/Value and
  reflected about it. No TPU kernel fills a bounded x or y (the JAX package
  runs these as XLA concatenations);
- a periodic x and/or y: the batched wrap kernel (``kernels/halo_fill.py``
  ``periodic_halo_fill``), over the full padded z, wrapping only the periodic
  axes;
- the bounded-z fill of ``_fill_axis`` by the bounded-z kernel
  (``bounded_z_fill``), after x and y. A bounded z with no halo
  (``H[2] == 0``, the z-compact layout) has its boundary values applied
  inside the stencil reads instead;
- ``apply_flux_bcs`` (interior-shaped tendencies) and
  ``apply_flux_bcs_padded`` (padded tendencies): the boundary-flux
  divergence of Flux conditions with a scalar value, added to a tendency.

Every fill updates the tensors in place and returns them. A periodic z
raises.
"""

from __future__ import annotations

import torch

from ..grids.topology import BOUNDED, CENTER, FACE, PERIODIC
from .boundary_condition import (FLUX, GRADIENT, OPEN, SIDE_AXIS, VALUE,
                                 USER_BCS_ITEM)

_CODES = {FLUX: 0, OPEN: 1, VALUE: 2, GRADIENT: 3}


def check_fillable(grid):
    """Raise unless the grid's halos are what this module fills: a bounded
    (or flat) z."""
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


def _value(bc):
    return 0.0 if bc is None or bc.condition is None else float(bc.condition)


def fill_bounded_axis(a, grid, loc, bcs, axis):
    """``_fill_axis`` along a bounded ``axis`` of one padded tensor (3-D, or
    a 2-D surface field for axis 0 or 1), in place; returns it."""
    H, N = grid.H[axis], grid.N[axis]
    if H == 0:
        return a
    left, right = bcs.pair(axis)
    cls_l = left.classification if left is not None else FLUX
    cls_r = right.classification if right is not None else FLUX

    def sl(start, stop):
        return a.narrow(axis, start, stop - start)

    def flipped(start, stop):
        return torch.flip(sl(start, stop), [axis])

    if loc[axis] == CENTER:
        xC = grid.coord_padded(axis, CENTER)
        if cls_l in (FLUX, OPEN):
            sl(0, H).copy_(flipped(H, 2 * H))
        elif cls_l in (VALUE, GRADIENT):
            vv = _value(left)
            c1 = sl(H, H + 1).clone()
            grad = ((c1 - vv) / ((xC[H] - xC[H - 1]) / 2) if cls_l == VALUE
                    else vv * torch.ones_like(c1))
            for m in range(H):
                sl(m, m + 1).copy_(c1 - grad * (xC[H] - xC[m]))
        else:
            raise ValueError(f"unsupported BC {cls_l} for a centered location")
        if cls_r in (FLUX, OPEN):
            sl(H + N, 2 * H + N).copy_(flipped(N, H + N))
        elif cls_r in (VALUE, GRADIENT):
            vv = _value(right)
            cN = sl(H + N - 1, H + N).clone()
            grad = ((vv - cN) / ((xC[H + N] - xC[H + N - 1]) / 2)
                    if cls_r == VALUE else vv * torch.ones_like(cN))
            for m in range(H):
                sl(H + N + m, H + N + m + 1).copy_(
                    cN + grad * (xC[H + N + m] - xC[H + N - 1]))
        else:
            raise ValueError(f"unsupported BC {cls_r} for a centered location")
        return a

    # the wall-normal face field: slot H is the left boundary face, slot H+N
    # the right one
    low = flipped(H + 1, 2 * H + 1)
    high = flipped(N + 1, H + N)
    if cls_l in (OPEN, VALUE):
        vL = _value(left)
        sl(0, H).copy_(2 * vL - low)
        sl(H, H + 1).fill_(vL)
    else:
        sl(0, H).copy_(low)
    if cls_r in (OPEN, VALUE):
        vR = _value(right)
        sl(H + N, H + N + 1).fill_(vR)
        sl(H + N + 1, 2 * H + N).copy_(2 * vR - high)
    else:
        sl(H + N + 1, 2 * H + N).copy_(high)
    return a


def _fill_xy(arrays, grid, locs_bcs):
    """The x and y halos of padded tensors, in place, in the order x → y: a
    bounded x, then one wrap launch for the periodic axes, then a bounded
    y."""
    from ..kernels.halo_fill import periodic_halo_fill, wrap_axes
    bounded = [grid.topology[ax] == BOUNDED and grid.H[ax] > 0
               for ax in (0, 1)]
    if any(bounded) and (locs_bcs is None or len(locs_bcs) != len(arrays)):
        raise ValueError("a bounded x/y halo fill needs each field's "
                         "location and boundary conditions")
    if bounded[0]:
        for a, (loc, bcs) in zip(arrays, locs_bcs):
            fill_bounded_axis(a, grid, loc, bcs, 0)
    if any(wrap_axes(grid)):
        periodic_halo_fill(grid, arrays)
    if bounded[1]:
        for a, (loc, bcs) in zip(arrays, locs_bcs):
            fill_bounded_axis(a, grid, loc, bcs, 1)
    return arrays


def fill_all_halo_regions(arrays, grid, locs_bcs=None):
    """Refresh the halos of several padded tensors on one grid, in place:
    x and y (a bounded-axis fill or one wrap launch for all of them), then,
    with a z halo, one bounded-z launch. ``locs_bcs`` gives each tensor's
    (location, boundary conditions); it is needed when the grid has a
    bounded x or y or a z halo."""
    from ..kernels.halo_fill import bounded_z_fill
    check_fillable(grid)
    arrays = _fill_xy(list(arrays), grid, locs_bcs)
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


def fill_surface_halo_regions(arrays, grid, locs_bcs):
    """Refresh the x and y halos of 2-D surface fields (Nx + 2Hx, Ny + 2Hy,
    1) in place (the JAX ``fill_halo_axes(..., (0, 1))``); returns them."""
    return _fill_xy(list(arrays), grid, locs_bcs)


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
