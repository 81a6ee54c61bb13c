"""Halo filling and boundary-flux tendencies.

Counterpart of ``oceananigans_tpu/boundary_conditions/fill_halos.py`` for
periodic, bounded or flat x, y and z, in the reference's x → y → z order,
so that corners come out as in JAX. Every fill
goes through ``kernels/halo_fill.py`` ``fill_halos``: one launch for a batch
of fields on the card, filling every axis (a periodic wrap; on a bounded
axis ``_fill_axis``: center fields mirror the interior under Flux/Open and
extrapolate linearly from the boundary cell under Value/Gradient, the
wall-normal face field is pinned at the boundary face under Open/Value and
reflected about it, or, given the stage's Δt, stepped by its
PerturbationAdvection scheme with its halo set to the face), and its plain
version on the CPU. Conditions are evaluated at the fill's time
(``boundary_condition_value``, JAX's ``eval_bc``): scalars, arrays of the
boundary plane's interior padded by topology, callables of the padded
transverse coordinates and the time, FieldTimeSeries planes. A bounded z
with no halo (``H[2] == 0``, the z-compact layout) has its boundary values
applied inside the stencil reads instead. ``apply_flux_bcs``
(interior-shaped tendencies, or a given padded region) and
``apply_flux_bcs_padded`` (padded tendencies) add the boundary-flux
divergence of Flux conditions (with field dependencies for callables) to
a tendency; ``apply_immersed_flux_bcs`` adds the conditions of an immersed
grid's ``immersed`` slot.

Every fill updates the tensors in place and returns them. A periodic z
wraps; conditions other than periodic on it raise (``fill_codes``).
"""

from __future__ import annotations

import numpy as np

from ..grids.topology import BOUNDED, CENTER, FACE, PERIODIC
from ..operators.operators import interp_to
from .boundary_condition import FLUX, SIDE_AXIS


def _check_conditions(arrays, grid, locs_bcs, axes):
    if any(grid.topology[ax] == BOUNDED and grid.H[ax] > 0 for ax in axes) \
            and (locs_bcs is None or len(locs_bcs) != len(arrays)):
        raise ValueError("a bounded halo fill needs each field's location "
                         "and boundary conditions")


def fill_all_halo_regions(arrays, grid, locs_bcs=None, time=0.0, dt=None):
    """Refresh the halos of several padded tensors of one shape on one
    grid, in place: one fill launch for all of them, every axis.
    ``locs_bcs`` gives each tensor's (location, boundary conditions); it is
    needed when the grid has a bounded x or y or a z halo. Conditions are
    evaluated at ``time``; ``dt`` (the stage's Δt) activates the
    PerturbationAdvection faces."""
    from ..kernels.halo_fill import fill_halos
    arrays = list(arrays)
    _check_conditions(arrays, grid, locs_bcs, (0, 1, 2))
    return fill_halos(grid, arrays, locs_bcs, time=time, dt=dt)


def fill_halo_regions(a, grid, loc, bcs, time=0.0, dt=None):
    """Refresh all halos of one padded tensor in place; returns it."""
    return fill_all_halo_regions([a], grid, [(loc, bcs)], time, dt)[0]


def fill_surface_halo_regions(arrays, grid, locs_bcs, time=0.0):
    """Refresh the x and y halos of padded tensors of one shape (2-D
    surface fields (Nx + 2Hx, Ny + 2Hy, 1), or 3-D ones over their full z)
    in place, one fill launch for all of them (the JAX
    ``fill_halo_axes(..., (0, 1))``); returns them."""
    from ..kernels.halo_fill import fill_halos
    arrays = list(arrays)
    _check_conditions(arrays, grid, locs_bcs, (0, 1))
    return fill_halos(grid, arrays, locs_bcs, z=False, time=time)


def _transverse_coordinates(grid, loc, axis):
    """The two transverse padded coordinates of the ``axis`` sides at
    ``loc``, broadcastable tensors of the grid's dtype and device: on the z
    sides of a shell grid the true 2-D (λ, φ) nodes, as the JAX ``eval_bc``
    passes them."""
    import torch
    from ..grids.base import broadcastable_1d, horizontal_nodes
    if axis == 2:
        return list(horizontal_nodes(grid, loc))
    return [torch.as_tensor(broadcastable_1d(grid.coord_padded(ax, loc[ax]),
                                             ax),
                            dtype=grid.dtype, device=grid.device)
            for ax in range(3) if ax != axis]


_array_planes = {}    # (id(grid), id(condition), axis) -> (condition, tensor)


def _array_plane(grid, cond, axis):
    """An array condition as a tensor broadcastable against the padded
    boundary plane of ``axis`` (1 along it), in the grid's dtype on its
    device, as the JAX ``eval_bc`` forms it: an array of the plane's
    interior (N1, N2) is padded over the transverse halos, wrapped along a
    periodic axis and its edge repeated along the others; any other array
    is taken as it is. Cached per grid, condition and axis."""
    import torch
    key = (id(grid), id(cond), axis)
    hit = _array_planes.get(key)
    if hit is not None and hit[0] is cond:
        return hit[1]
    arr = np.asarray(cond.detach().cpu() if hasattr(cond, "detach")
                     else cond, dtype=np.float64)
    t_axes = [ax for ax in range(3) if ax != axis]
    if arr.shape == tuple(grid.N[ax] for ax in t_axes):
        for d, ax in enumerate(t_axes):
            pad = [(0, 0), (0, 0)]
            pad[d] = (grid.H[ax], grid.H[ax])
            arr = np.pad(arr, pad, mode="wrap" if grid.topology[ax] == PERIODIC
                         else "edge")
    out = torch.as_tensor(np.ascontiguousarray(np.expand_dims(arr, axis)),
                          dtype=grid.dtype, device=grid.device)
    if hit is None:
        import weakref
        weakref.finalize(grid, _array_planes.pop, key, None)
    _array_planes[key] = (cond, out)
    return out


def boundary_condition_value(bc, grid, loc, axis, time=0.0, dep_values=()):
    """A side's condition at ``time`` (JAX ``eval_bc``): None for a
    homogeneous condition, a float for a scalar, else a tensor
    broadcastable against the padded boundary plane (1 along ``axis``): a
    FieldTimeSeries condition's padded plane, an array's (``_array_plane``),
    or a callable evaluated on the padded transverse coordinates at
    ``loc``, the time and ``dep_values``."""
    cond = bc.condition
    if cond is None:
        return None
    if isinstance(cond, (int, float, np.number)):
        return float(cond)
    if hasattr(cond, "evaluate_padded"):
        return cond.evaluate_padded(grid, time)
    if callable(cond):
        return cond(*_transverse_coordinates(grid, loc, axis), float(time),
                    *dep_values)
    return _array_plane(grid, cond, axis)


def boundary_flux(bc, grid, loc, axis, is_left, time=0.0, fields=None,
                  locs=None):
    """The value of a Flux condition on one side (``boundary_condition_value``)
    with, for a callable, the dependencies' boundary-cell planes (each
    interpolated to ``loc``, then cut at the boundary cell, as the JAX
    ``apply_flux_bcs`` does). None for a homogeneous condition."""
    deps = ()
    if bc.field_dependencies and callable(bc.condition):
        if fields is None:
            raise ValueError("a flux BC with field_dependencies needs the "
                             "model state; this path did not supply it")
        H, N = grid.H[axis], grid.N[axis]
        cell = H if is_left else H + N - 1
        vals = []
        for dep in bc.field_dependencies:
            a = fields[dep]
            src = (locs or {}).get(dep)
            if src is not None and tuple(src) != tuple(loc):
                a = interp_to(grid, a, tuple(src), tuple(loc))
            vals.append(a.narrow(axis, cell, 1))
        deps = tuple(vals)
    return boundary_condition_value(bc, grid, loc, axis, time, deps)


def _boundary_slice(metric, axis, i):
    """A metric (Python scalar or broadcastable tensor) at padded index
    ``i`` along ``axis``, dims kept."""
    if isinstance(metric, (int, float)) or metric.shape[axis] == 1:
        return metric
    return metric.narrow(axis, i, 1)


def _flux_increments(grid, loc, bcs, time, fields, locs):
    """(axis, is_left, increment) for each bounded side with a Flux
    condition: ``±q·A/V`` on the boundary plane, the area of the boundary
    face at the flipped location over the boundary cell's volume, as the
    JAX ``apply_flux_bcs`` forms it (a scalar, or a tensor over the padded
    transverse extents)."""
    for side, (axis, is_left) in SIDE_AXIS.items():
        if grid.topology[axis] != BOUNDED:
            continue
        bc = bcs.side(side)
        if bc is None or bc.classification != FLUX or bc.condition is None:
            continue
        q = boundary_flux(bc, grid, loc, axis, is_left, time, fields, locs)
        H, N = grid.H[axis], grid.N[axis]
        floc = list(loc)
        floc[axis] = FACE if loc[axis] == CENTER else CENTER
        A = (grid.Ax, grid.Ay, grid.Az)[axis](tuple(floc))
        cell = H if is_left else H + N - 1
        AoV = (_boundary_slice(A, axis, H if is_left else H + N)
               / _boundary_slice(grid.V(loc), axis, cell))
        sgn = 1.0 if is_left else -1.0
        yield axis, is_left, sgn * q * AoV


def apply_flux_bcs(G, grid, loc, bcs, time=0.0, fields=None, locs=None,
                   region=None):
    """Add boundary-flux divergences to a tendency over the padded
    ``region`` (slices; the interior by default), in place (``G[first] +=
    q·A/V`` on west/south/bottom, ``G[last] -= q·A/V`` on east/north/top,
    for Flux conditions); returns G. The increments are formed on the
    padded plane (``apply_flux_bcs_padded``) and cut to the region."""
    region = grid.interior_slices if region is None else region
    for axis, is_left, inc in _flux_increments(grid, loc, bcs, time, fields,
                                               locs):
        if not isinstance(inc, (int, float)):
            inc = _cut_transverse(inc, axis, region)
        H, N = grid.H[axis], grid.N[axis]
        cell = (H if is_left else H + N - 1) - region[axis].start
        G.narrow(axis, cell, 1).add_(inc)
    return G


def _cut_transverse(a, axis, region):
    """A padded boundary-plane tensor cut to ``region`` along the two axes
    transverse to ``axis`` (axes of length 1 pass)."""
    for ax in range(3):
        if ax != axis and a.shape[ax] > 1:
            a = a[tuple(region[ax] if d == ax else slice(None)
                        for d in range(3))]
    return a


def apply_flux_bcs_padded(G, grid, loc, bcs, time=0.0, fields=None,
                          locs=None):
    """``apply_flux_bcs`` on a padded tendency, as the JAX function does it,
    at padded slots H (west/south/bottom) and H+N-1 (east/north/top); in
    place, returns G. ``fields`` and ``locs`` (the model's padded state and
    locations) feed conditions with field dependencies."""
    for axis, is_left, inc in _flux_increments(grid, loc, bcs, time, fields,
                                               locs):
        H, N = grid.H[axis], grid.N[axis]
        G.narrow(axis, H if is_left else H + N - 1, 1).add_(inc)
    return G


def immersed_diffusivity(closure, name):
    """The scalar diffusivity that Value and Gradient immersed conditions of
    field ``name`` use (ν for u, v and w, κ for tracers), summed over a
    closure tuple; a closure without a scalar one adds 0."""
    total = 0.0
    for cl in getattr(closure, "closures", (closure,)):
        if cl is None:
            continue
        if name in ("u", "v", "w"):
            nu = getattr(cl, "nu", 0.0)
            if np.isscalar(nu):
                total += float(nu)
        else:
            k = getattr(cl, "kappa", 0.0)
            if isinstance(k, dict):
                k = k.get(name, 0.0)
            if np.isscalar(k):
                total += float(k)
    return total


def apply_immersed_flux_bcs(G, grid, loc, ibc, time=0.0, c=None, kappa=0.0):
    """Add the immersed-boundary flux divergences to a padded tendency and
    return the new tensor: for each side, the flux is deposited into the
    fluid cells whose neighbour on that side is solid (a positive flux
    through a cell's west/south/bottom immersed face raises its tendency).
    Flux conditions deposit the given flux; Value and Gradient conditions a
    one-sided diffusive flux q = -κ∇c with ∇c the given gradient or
    ±2(c - c_b)/Δ. ``c`` is the field's padded tensor, ``kappa`` the
    closure's scalar diffusivity of the field. A condition is a scalar, an
    array of the side's plane or a callable of its transverse coordinates
    and the time (``boundary_condition_value``)."""
    import torch
    from .boundary_condition import (GRADIENT, VALUE,
                                     ImmersedBoundaryCondition)
    if not hasattr(ibc, "side"):
        # one condition in the slot applies on every side
        ibc = ImmersedBoundaryCondition(west=ibc, east=ibc, south=ibc,
                                        north=ibc, bottom=ibc, top=ibc)
    solid = grid.solid_ccc
    fluid = ~solid
    kw = dict(dtype=G.dtype, device=G.device)
    for side, (axis, is_left) in SIDE_AXIS.items():
        bc = ibc.side(side)
        if bc is None or bc.condition is None:
            continue
        # a scalar, or a plane (1 along the axis) broadcast across the
        # grid: an array, or a callable of the transverse coordinates and
        # the time, as the JAX ``eval_bc`` evaluates it
        val = boundary_condition_value(bc, grid, loc, axis, time)
        if val is None:
            continue
        if bc.classification == GRADIENT:
            q = -kappa * val
        elif bc.classification == VALUE:
            if c is None:
                raise ValueError("Value immersed BCs need the field")
            D = (grid.dx, grid.dy, grid.dz)[axis](loc)
            D = D if isinstance(D, float) else torch.as_tensor(D, **kw)
            grad = (2.0 * (c - val) / D) if is_left \
                else (2.0 * (val - c) / D)
            q = -kappa * grad
        else:
            q = val
        off = -1 if is_left else +1
        mask = fluid & np.roll(solid, -off, axis=axis)
        floc = list(loc)
        floc[axis] = FACE if loc[axis] == CENTER else CENTER
        A = (grid.Ax, grid.Ay, grid.Az)[axis](tuple(floc))
        A = torch.as_tensor(A, **kw).broadcast_to(G.shape)
        V = torch.as_tensor(grid.V(loc), **kw).broadcast_to(G.shape)
        if not is_left:
            # the east/north/top face of cell j is face j + 1
            A = torch.roll(A, -1, dims=axis)
        sgn = 1.0 if is_left else -1.0
        G = G + torch.where(torch.as_tensor(mask, device=G.device),
                            sgn * q * (A / V), torch.zeros((), **kw))
    return G
