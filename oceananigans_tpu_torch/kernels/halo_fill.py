"""Halo fills, in place: one launch fills every axis of a batch of fields.

``fill_halos`` replaces both TPU fill kernels of
``oceananigans_tpu/kernels/pallas_fill.py``: ``_build_batched`` (via
``get_batched_fill``, the batched periodic x/y wrap) and ``_build`` (via
``get_pallas_fill``, the wrap followed by the bounded-z fix), and it also
takes the bounded x/y fills that the JAX package leaves to XLA. It computes
what the reference's x → y → z sequence of ``_fill_axis`` computes, corners
included: a periodic axis wraps; a bounded axis, given each field's location
and boundary conditions, mirrors, extrapolates or pins and reflects
(``fill_bounded_axis``). Without conditions (``locs_bcs=None``) only the
periodic axes are filled (``periodic_halo_fill``).

Design (``csrc/halo_fill.cu``): along each axis each fill maps one source
slot to each halo slot, and each source slot is one the launch does not
write, so one thread forms any slot's final value from one load by applying
the x, y and z maps in order. The side codes below name the maps;
``fill_codes`` assigns them and ``axis_geometry`` gives the float64 half
spacings and distances the extrapolations use. A launch takes a batch of up
to ``build.BATCH`` fields of one padded shape; its parameter block is built
once per (grid, shape, dtype, field locations and conditions) and cached,
and a call only writes the fields' pointers into it. The wrapper raises
where one load per slot would not hold: a periodic axis with N < H, a
bounded one with H > ``MAX_H``, conditions other than periodic on a
periodic z (which wraps like x and y, in the same launch). On a bounded
axis narrower than its halo needs (N < H for a centre field, N < H + 1 for a
pinned face), the far halo slots whose source that axis itself writes keep
their value (``narrow_slots``; the JAX fill reads such a source before it
writes it, and no stencil of the models reads that far), so the kernel and
``fill_halos_plain`` agree there and the JAX fill may not.

Two codes come from the grid. ``FOLD`` (``FOLD_FACE`` for a y-face field)
is the tripolar north fold (``ZipperBoundaryCondition``): north halo row
j = Ny − 1 + m reads interior row Ny − 1 − m (Ny − m for a y-face field,
whose boundary face Ny is the first folded row) with x reversed (i ↦ Nx − 1
− i, or Nx − i and the wrap element i = 0 kept for an x-face field) and
times the sign (not at that wrap element); for a field centred in y the
eastern half of the last interior row is overwritten by its folded western
half. The fold couples x and y: as in JAX, whose fill folds the interior x
first and wraps x after, a slot in an x halo first wraps its x into the
interior and then folds, so every slot still reads one interior slot. An
x-face field with an even Nx maps column Nx/2 of the last row onto itself;
one thread fills that column, its z ends before its interior.
``POLAR_VALUE`` and ``POLAR_PINNED`` are the polar caps of a pole-touching
lat-lon grid (``PolarBoundaryCondition``): Value and Open with the zonal
mean of the boundary row over the interior x, one per field, side and z
slot (``polar_means``: a PyTorch reduction, as the JAX package takes it in
XLA), which the kernel reads from a small table.

Boundary values that vary over the boundary plane or in time (array,
callable and FieldTimeSeries conditions) are *planes*: per call the wrapper
evaluates each such side's condition at the fill's time over the padded
transverse extents of the field (``side_planes``), and the Value, Gradient
and pinned-face maps read the plane at the slot's transverse source in
place of the scalar: an x side at the slot's y and z sources, a y side at
its x and the z source, a z side at its x and y (the composition of the
sequential fills). An Open side with ``PerturbationAdvection`` under a fill
given the stage's Δt (``dt``) takes the ``PA_FACE`` map: the boundary face
and every halo slot beyond it take the perturbation-advection face value
(``pa_face_plane``, JAX's ``pa_face``), a plane computed before the launch
from the field's boundary face, the face inside it and the exterior value,
after the fills of the earlier axes (on the card a launch of the kernel
over those axes alone fills a copy of the field; the plain version fills a
copy of the two rows along them); computing it inside the launch would
read a face slot that other blocks write. Without Δt the side is an Open condition with its
value (a pinned face), as in JAX. The planes of a launch go to the kernel in
one buffer; their offsets are part of the cached parameter block, their
values and Δt are not.

The plain version ``fill_halos_plain`` is the sequence the kernel replaces:
``fill_bounded_axis`` along x, ``periodic_halo_fill_plain`` (the periodic
axes, x then y), ``fill_bounded_axis`` along y, then the periodic z wrap or
``bounded_z_fill_plain``. CPU tensors take it; CUDA tensors launch the
kernel. Bound on the H100: data movement only (each written slot read once
and written once); the z ends of interior columns are a few bytes of each
row, so 32-byte DRAM sectors set the floor of a bounded-z fill.

On a shard's grid (``parallel/distributed.py`` ``Shard``) the sides
connected to other shards keep their values (``KEEP``, side by side: a
bounded axis's walls are filled on the edge shards' outer sides only) and
the fill ends with the halo exchange of the mesh (``exchange_connected``;
the tripolar fold across the top row of shards is the exchange's): the z
halos are filled first, so the exchanged strips carry them into the x and
y halos, as the serial fill's x → y → z order puts them there, and the
exchange's strips over the full extent of the other axis carry the walls'
halos into the corners.

The fills update the tensors in place (as the TPU kernels alias their
outputs to their inputs) and return them.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..boundary_conditions import boundary_condition as bcm
from ..grids.topology import (BOUNDED, CENTER, FACE, PERIODIC,
                              side_connected)
from . import build

MAX_H = 8

# Classifications of a ZFill side (bounded_z_fill_plain); PERTURBATION is
# an Open side with PerturbationAdvection under a fill given Δt.
FLUX, OPEN, VALUE, GRADIENT, PERTURBATION = 0, 1, 2, 3, 4
_CLASS_CODES = {bcm.FLUX: FLUX, bcm.OPEN: OPEN, bcm.VALUE: VALUE,
                bcm.GRADIENT: GRADIENT}

# Side codes of csrc/halo_fill.cu: the map of one side of one axis.
KEEP = 0                   # not filled
WRAP = 1                   # periodic
MIRROR = 2                 # center field, Flux or Open
EXTRAPOLATE_VALUE = 3      # center field, Value
EXTRAPOLATE_GRADIENT = 4   # center field, Gradient
PINNED = 5                 # face field, Open or Value: pin the face, reflect oddly
REFLECT = 6                # face field, Flux or Gradient: reflect evenly
FOLD = 7                   # tripolar north fold, field centred in y
FOLD_FACE = 8              # tripolar north fold, y-face field
POLAR_VALUE = 9            # polar cap, center field: extrapolate to the mean
POLAR_PINNED = 10          # polar cap, face field: pin to the mean, reflect
PA_FACE = 11               # face field, PerturbationAdvection: face and halo take the plane
EXTRAPOLATES = (EXTRAPOLATE_VALUE, EXTRAPOLATE_GRADIENT, POLAR_VALUE)
FOLDS = (FOLD, FOLD_FACE)
POLARS = (POLAR_VALUE, POLAR_PINNED)
PINS = (PINNED, POLAR_PINNED, PA_FACE)
PLANE_CODES = (EXTRAPOLATE_VALUE, EXTRAPOLATE_GRADIENT, PINNED)


class ZFill(NamedTuple):
    """The bounded-z fill of one field: ``face`` for a z-face location (w);
    ``bottom`` and ``top`` are (classification code, scalar value)."""
    face: bool
    bottom: tuple
    top: tuple


def _geometry(grid):
    Nx, Ny, Nz = grid.N
    Hx, Hy, Hz = grid.H
    return Nx, Ny, Nz, Hx, Hy, Hz


def _value(bc):
    """The scalar a fill reads: a Flux condition's value is never read (its
    fill mirrors or reflects), so a callable Flux condition counts as 0; a
    fold's is its sign; a polar cap's comes from ``polar_means``, a plane
    condition's from its plane (``side_planes``)."""
    if bc is None or bc.classification == bcm.FLUX or \
            bcm.is_plane_condition(bc.condition) or bc.condition is None \
            or isinstance(bc.condition, bcm.PolarValue):
        return 0.0
    return float(bc.condition)


def _is_pa(bc, pa):
    """An Open side with PerturbationAdvection in a fill given Δt."""
    return (pa and bc is not None and bc.classification == bcm.OPEN
            and isinstance(bc.scheme, bcm.PerturbationAdvection))


def _is_polar(bc):
    return bc is not None and isinstance(bc.condition, bcm.PolarValue)


def _is_fold(bc):
    return bc is not None and bc.classification == bcm.ZIPPER


def polar_row_means(grid, a):
    """The zonal means of a field's two boundary rows along y over the
    interior x, at every z slot, (2, nz): the pole values of the polar caps
    (the boundary row is the first interior row at the south, the last at
    the north, for centre and y-face fields alike). One reduction over a
    view of the two rows. On a shard's grid, the means over the global x
    that the fill's meeting formed (``shard_polar_means``)."""
    held = getattr(grid, "_polar_means", None)
    if held is not None and id(a) in held:
        return held[id(a)]
    Hx, Nx = grid.H[0], grid.N[0]
    Hy, Ny = grid.H[1], grid.N[1]
    return a[Hx:Hx + Nx, Hy:Hy + Ny:max(Ny - 1, 1)].mean(0)


def shard_polar_means(grid, fields, locs_bcs):
    """The polar caps' zonal means over the global x on a shard of a
    pole-touching grid: every shard of the mesh meets here in every fill
    that fills y (the shards at a pole post their boundary rows' sums over
    their x, the others zeros; ``all_reduce`` adds them in the mesh's
    row-major order), and the shards at a pole keep the means for
    ``polar_row_means`` during the fill. Returns the {id: means} held, or
    None where the grid is not such a shard."""
    shard = getattr(grid, "shard", None)
    if shard is None or locs_bcs is None:
        return None
    glob = shard.global_grid
    glob = getattr(glob, "underlying_grid", glob)
    if not (getattr(glob, "polar_south", False)
            or getattr(glob, "polar_north", False)):
        return None
    Hx, Nx = grid.H[0], grid.N[0]
    Hy, Ny = grid.H[1], grid.N[1]
    sums = []
    for a, (_, bcs) in zip(fields, locs_bcs):
        row = torch.zeros((2, a.shape[2]), dtype=a.dtype, device=a.device)
        for k, (side, bc) in enumerate((("south", bcs.south),
                                        ("north", bcs.north))):
            if _is_polar(bc) and getattr(grid, f"polar_{side}", False):
                y = Hy if k == 0 else Hy + Ny - 1
                row[k] = a[Hx:Hx + Nx, y].sum(0)
        sums.append(row)
    total = shard.all_reduce(torch.stack(sums)) / glob.N[0]
    held = {id(a): total[k] for k, a in enumerate(fields)}
    grid._polar_means = held
    return held


def polar_row_mean(grid, a, is_left):
    """``polar_row_means`` of one side, (1, 1, nz)."""
    return polar_row_means(grid, a)[0 if is_left else -1][None, None]


def _classification(bc):
    return bcm.FLUX if bc is None else bc.classification


def z_fill_spec(loc, bcs, pa=False):
    """The bounded-z fill of one field (``ZFill``): its z location and the
    (classification code, scalar value) of its bottom and top conditions
    (None counts as Flux with 0; with ``pa``, a PerturbationAdvection side of
    a z-face field is ``PERTURBATION``)."""
    def side(bc):
        if loc[2] == FACE and _is_pa(bc, pa):
            return (PERTURBATION, 0.0)
        return (_CLASS_CODES[_classification(bc)], _value(bc))

    return ZFill(loc[2] == FACE, side(bcs.bottom), side(bcs.top))


# -- the plain versions ---------------------------------------------------------

def wrap_axes(grid):
    """(wrap_x, wrap_y): which of x and y are periodic with a halo and not
    connected to other shards."""
    return tuple(grid.topology[a] == PERIODIC and grid.H[a] > 0
                 and not connected(grid, a) for a in (0, 1))


def connected(grid, axis):
    """Whether a side of ``axis`` of a shard's grid is connected to a
    neighbouring shard: its halo comes from the halo exchange, and the fill
    keeps it (``KEEP``; ``side_connected`` says which side)."""
    return any(side_connected(grid, axis))


def exchange_connected(grid, fields, locs_bcs=None):
    """End a fill of a shard's ``fields`` with the halo exchange of its
    connected axes (every other shard's fill meets it there); nothing on a
    grid with no connected axis. With ``locs_bcs`` the fields whose north
    side is a tripolar fold are folded across the top row of shards."""
    shard = getattr(grid, "shard", None)
    if shard is not None and any(connected(grid, a) for a in (0, 1)):
        fold = None
        if locs_bcs is not None and getattr(grid, "zipper_north", False):
            fold = [(float(bcs.north.condition), loc[0] == FACE,
                     loc[1] == FACE) if _is_fold(bcs.north) else None
                    for loc, bcs in locs_bcs]
        shard.exchange(fields, fold=fold)
    return fields


def _z_extent(grid, a):
    """(Nz, Hz) of a padded tensor: the grid's, or (1, 0) for a 2-D
    (Nx + 2Hx, Ny + 2Hy, 1) surface field on a grid with a z halo."""
    if a.shape[2] == 1 and grid.padded_shape[2] != 1:
        return 1, 0
    return grid.N[2], grid.H[2]


def periodic_halo_fill_plain(grid, fields, z=True):
    """Plain PyTorch version of the wrap: x (over the full y extent), then y
    over the full x extent, then (with ``z``) z over the full x and y
    extents, each axis only if it is periodic with a halo (every z slot, z
    halos included; a 2-D surface field has no z to wrap)."""
    Nx, Ny, _, Hx, Hy, _ = _geometry(grid)
    wx, wy = wrap_axes(grid)
    for a in fields:
        if a.is_cuda:
            periodic_halo_fill_plain.cuda_calls += 1
        if wx:
            a[:Hx] = a[Nx:Nx + Hx]
            a[Hx + Nx:] = a[Hx:2 * Hx]
        if wy:
            a[:, :Hy] = a[:, Ny:Ny + Hy]
            a[:, Hy + Ny:] = a[:, Hy:2 * Hy]
        if z:
            _wrap_z(grid, a)
    return fields


def _wrap_z(grid, a):
    """The periodic z wrap of one padded tensor, in place (nothing on a z
    that is not periodic, has no halo, or on a 2-D surface field)."""
    Nz, Hz = _z_extent(grid, a)
    if grid.topology[2] == PERIODIC and Hz > 0:
        a[..., :Hz] = a[..., Nz:Nz + Hz]
        a[..., Hz + Nz:] = a[..., Hz:2 * Hz]


periodic_halo_fill_plain.cuda_calls = 0


def _div(x, d):
    """x / d, the scalar ``d`` as a tensor of x's dtype on x's device: PyTorch
    multiplies by the reciprocal of a scalar divisor on the card, which
    rounds apart from the kernel's division."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def fill_bounded_axis(a, grid, loc, bcs, axis, planes=None, pa=False):
    """``_fill_axis`` along a bounded ``axis`` of one padded tensor (3-D, or
    a 2-D surface field for axis 0 or 1), in place; returns it. Center
    fields mirror the interior under Flux/Open and extrapolate linearly from
    the boundary cell under Value/Gradient; the wall-normal face field is
    pinned at the boundary face under Open/Value and reflected about it, and
    with ``pa`` an Open side with PerturbationAdvection sets its face and
    halo to its plane. ``planes`` ({(axis, side): plane}, ``side_planes``)
    gives the sides whose value is a plane. A polar cap's value is the zonal
    mean of the boundary row (``polar_row_mean``); a folded north side
    (``fold_north``, which runs first) is left as it is, and so are the
    ``narrow_slots``."""
    H, N = grid.H[axis], grid.N[axis]
    if H == 0:
        return a
    if a.is_cuda:
        fill_bounded_axis.cuda_calls += 1
    left, right = bcs.pair(axis)
    face = loc[axis] == FACE
    keep = side_connected(grid, axis)
    narrow = narrow_slots(tuple(
        x for side, bc in enumerate((left, right))
        for x in ((KEEP if keep[side] else _side_code(bc, face, pa)), 0.0)),
        N, H)
    kept = {n: a.narrow(axis, n, 1).clone() for n in narrow}
    _fill_bounded_sides(a, grid, loc, left, right, axis, planes or {}, pa,
                        keep)
    for n, old in kept.items():
        a.narrow(axis, n, 1).copy_(old)
    return a


def _fill_bounded_sides(a, grid, loc, left, right, axis, planes, pa,
                        keep=(False, False)):
    """The two sides of ``fill_bounded_axis``; a side that ``keep`` names
    (connected to another shard) is left as it is."""
    H, N = grid.H[axis], grid.N[axis]
    cls_l, cls_r = _classification(left), _classification(right)
    fold = _is_fold(right)

    def value(bc, is_left):
        plane = planes.get((axis, 0 if is_left else 1))
        if plane is not None:
            return plane
        return (polar_row_mean(grid, a, is_left) if _is_polar(bc)
                else _value(bc))

    def sl(start, stop):
        return a.narrow(axis, start, stop - start)

    def flipped(start, stop):
        return torch.flip(sl(start, stop), [axis])

    if loc[axis] == CENTER:
        xC = grid.coord_padded(axis, CENTER)
        if keep[0]:
            pass
        elif cls_l in (bcm.FLUX, bcm.OPEN):
            sl(0, H).copy_(flipped(H, 2 * H))
        elif cls_l in (bcm.VALUE, bcm.GRADIENT):
            vv = value(left, True)
            c1 = sl(H, H + 1).clone()
            grad = (_div(c1 - vv, (xC[H] - xC[H - 1]) / 2)
                    if cls_l == bcm.VALUE else vv * torch.ones_like(c1))
            for m in range(H):
                sl(m, m + 1).copy_(c1 - grad * (xC[H] - xC[m]))
        else:
            raise ValueError(f"unsupported BC {cls_l} for a centered location")
        if fold or keep[1]:
            return a            # its north rows were folded first
        if cls_r in (bcm.FLUX, bcm.OPEN):
            sl(H + N, 2 * H + N).copy_(flipped(N, H + N))
        elif cls_r in (bcm.VALUE, bcm.GRADIENT):
            vv = value(right, False)
            cN = sl(H + N - 1, H + N).clone()
            grad = (_div(vv - cN, (xC[H + N] - xC[H + N - 1]) / 2)
                    if cls_r == bcm.VALUE else vv * torch.ones_like(cN))
            for m in range(H):
                sl(H + N + m, H + N + m + 1).copy_(
                    cN + grad * (xC[H + N + m] - xC[H + N - 1]))
        else:
            raise ValueError(f"unsupported BC {cls_r} for a centered location")
        return a

    # the wall-normal face field: slot H is the left boundary face, slot H+N
    # the right one
    pa_l, pa_r = _is_pa(left, pa), _is_pa(right, pa) and not fold
    vL = (value(left, True) if cls_l in (bcm.OPEN, bcm.VALUE)
          and not keep[0] else None)
    vR = (value(right, False) if cls_r in (bcm.OPEN, bcm.VALUE)
          and not fold and not keep[1] else None)
    for v, slot in ((vL, H), (vR, H + N)):
        if v is not None:
            sl(slot, slot + 1).copy_(torch.as_tensor(
                v, dtype=a.dtype).expand_as(sl(slot, slot + 1)))
    low = flipped(H + 1, 2 * H + 1)
    high = flipped(N + 1, H + N)
    if keep[0]:
        pass
    elif pa_l:
        sl(0, H).copy_(vL.expand_as(sl(0, H)))
    else:
        sl(0, H).copy_(low if vL is None else 2 * vL - low)
    if keep[1]:
        pass
    elif pa_r:
        sl(H + N + 1, 2 * H + N).copy_(vR.expand_as(sl(H + N + 1, 2 * H + N)))
    elif not fold:
        sl(H + N + 1, 2 * H + N).copy_(high if vR is None else 2 * vR - high)
    return a


fill_bounded_axis.cuda_calls = 0


def fold_north(a, grid, loc, bcs):
    """The tripolar north fold of one padded tensor, in place (JAX
    ``_fill_zipper_north``), over the interior x: north halo row
    j = Ny − 1 + m takes interior row Ny − 1 − m (Ny − m for a y-face field,
    from its boundary face Ny on) with x reversed, times the sign of
    ``bcs.north``; for an x-face field the reversed index rolls by one and
    the wrap element keeps its sign. For a field centred in y the eastern
    half of the last interior row takes its folded western half. Rows whose
    source lies past the south side's reach keep their value
    (``narrow_slots``)."""
    if a.is_cuda:
        fold_north.cuda_calls += 1
    Hx, Hy = grid.H[0], grid.H[1]
    Nx, Ny = grid.N[0], grid.N[1]
    face_x, face_y = loc[0] == FACE, loc[1] == FACE
    sign = bcs.north.condition
    narrow = narrow_slots((_side_code(bcs.south, face_y), 0.0,
                           _side_code(bcs.north, face_y), 0.0), Ny, Hy)
    orig = a[Hx:Hx + Nx].clone()
    sgn = torch.full((Nx, 1), float(sign), dtype=a.dtype, device=a.device)
    if face_x:
        sgn[0] = abs(float(sign))

    def fold_x(row):
        flipped = torch.flip(row, [0])
        return sgn * (torch.roll(flipped, 1, 0) if face_x else flipped)

    out = a[Hx:Hx + Nx]
    for m in range(1, Hy + 1):
        src = Hy + Ny - m if face_y else Hy + Ny - 1 - m
        if Hy + Ny - 1 + m not in narrow:
            out[:, Hy + Ny - 1 + m] = fold_x(orig[:, src])
    if not face_y:
        row = Hy + Ny - 1
        out[Nx // 2:, row] = fold_x(orig[:, row])[Nx // 2:]
    return a


fold_north.cuda_calls = 0


def z_distances(grid):
    """Half spacings of the boundary cells and the distances from the
    boundary cell centers to each halo slot, float64 from the grid's center
    coordinates, as ``_fill_axis`` forms them:
    (half_b, half_t, dist_b[Hz], dist_t[Hz])."""
    H, N = grid.H[2], grid.N[2]
    zc = grid.coord_padded(2, "c")
    half_b = float(zc[H] - zc[H - 1]) / 2
    half_t = float(zc[H + N] - zc[H + N - 1]) / 2
    dist_b = [float(zc[H] - zc[s]) for s in range(H)]
    dist_t = [float(zc[H + N + m] - zc[H + N - 1]) for m in range(H)]
    return half_b, half_t, dist_b, dist_t


def _pins(cls):
    return cls in (OPEN, VALUE, PERTURBATION)


def bounded_z_fill_plain(grid, fields, specs, planes=None):
    """Plain PyTorch version of the bounded-z fill (``_fill_axis`` along z,
    in place); ``specs`` holds one ``ZFill`` per field, ``planes`` (None, or
    one {(axis, side): plane} per field) the sides whose value is a plane
    (a ``PERTURBATION`` side's is its face plane)."""
    H, N = grid.H[2], grid.N[2]
    half_b, half_t, dist_b, dist_t = z_distances(grid)
    for k, (a, spec) in enumerate(zip(fields, specs)):
        if a.is_cuda:
            bounded_z_fill_plain.cuda_calls += 1
        narrow = _zfill_narrow(grid, spec)
        kept = {n: a[..., n].clone() for n in narrow}
        own = {} if planes is None else planes[k]
        _fill_z_sides(a, spec, H, N, half_b, half_t, dist_b, dist_t,
                      own.get((2, 0)), own.get((2, 1)))
        for n, old in kept.items():
            a[..., n] = old
    return fields


def _fill_z_sides(a, spec, H, N, half_b, half_t, dist_b, dist_t, plane_b,
                  plane_t):
    (cb, vb), (ct, vt) = spec.bottom, spec.top
    vb = vb if plane_b is None else plane_b
    vt = vt if plane_t is None else plane_t
    if not spec.face:
        if cb in (FLUX, OPEN):
            a[..., :H] = torch.flip(a[..., H:2 * H], [-1])
        else:
            c1 = a[..., H:H + 1].clone()
            grad = _div(c1 - vb, half_b) if cb == VALUE \
                else vb * torch.ones_like(c1)
            for s in range(H):
                a[..., s:s + 1] = c1 - grad * dist_b[s]
        if ct in (FLUX, OPEN):
            a[..., H + N:] = torch.flip(a[..., N:H + N], [-1])
        else:
            cN = a[..., H + N - 1:H + N].clone()
            grad = _div(vt - cN, half_t) if ct == VALUE \
                else vt * torch.ones_like(cN)
            for m in range(H):
                a[..., H + N + m:H + N + m + 1] = cN + grad * dist_t[m]
        return
    if _pins(cb):
        a[..., H:H + 1] = vb
    if _pins(ct):
        a[..., H + N:H + N + 1] = vt
    low = torch.flip(a[..., H + 1:2 * H + 1], [-1])
    if cb == PERTURBATION:
        a[..., :H] = vb
    else:
        a[..., :H] = 2 * vb - low if _pins(cb) else low
    high = torch.flip(a[..., N + 1:H + N], [-1])
    if ct == PERTURBATION:
        a[..., H + N + 1:] = vt
    else:
        a[..., H + N + 1:] = 2 * vt - high if _pins(ct) else high


def _zfill_narrow(grid, spec):
    """``narrow_slots`` of a bounded-z fill."""
    code = {FLUX: MIRROR, OPEN: MIRROR, VALUE: EXTRAPOLATE_VALUE,
            GRADIENT: EXTRAPOLATE_GRADIENT}
    (cb, _), (ct, _) = spec.bottom, spec.top

    def face_code(c):
        return PA_FACE if c == PERTURBATION else (PINNED if _pins(c)
                                                  else REFLECT)

    if spec.face:
        codes = (face_code(cb), 0.0, face_code(ct), 0.0)
    else:
        codes = (code[cb], 0.0, code[ct], 0.0)
    return narrow_slots(codes, grid.N[2], grid.H[2])


bounded_z_fill_plain.cuda_calls = 0


def fill_halos_plain(grid, fields, locs_bcs=None, z=True, time=0.0,
                     dt=None):
    """Plain PyTorch version of ``fill_halos``, in the reference's order: the
    tripolar fold, a bounded x, the periodic axes (x, then y), a bounded y,
    then (with ``z``) the periodic z wrap or a bounded z, each bounded axis
    only when ``locs_bcs`` gives the fields' (location, boundary
    conditions). The planes of the sides that read one (``side_planes`` at
    ``time``, with ``dt`` the perturbation-advection faces) are formed
    first."""
    fields = list(fields)
    if any(a.is_cuda for a in fields):
        fill_halos_plain.cuda_calls += 1
    planes = side_planes(grid, fields, locs_bcs, z, time, dt)
    _fill_sequence(grid, fields, locs_bcs, z, dt is not None, planes)
    return fields


def _fill_sequence(grid, fields, locs_bcs, z, pa, planes, until=3):
    """The sequential fill of ``fill_halos_plain`` with the given planes,
    of the axes before ``until`` (a copy of two rows along axis ``until``
    takes the fills of the axes before it)."""
    bounded = [locs_bcs is not None and grid.topology[ax] == BOUNDED
               and grid.H[ax] > 0 for ax in range(3)]
    if bounded[1] and until >= 2:
        # the fold first, over the interior x, so that the wrap carries the
        # folded rows into the corners (a shard's fold is its exchange's)
        for a, (loc, bcs) in zip(fields, locs_bcs):
            if _is_fold(bcs.north) and not side_connected(grid, 1)[1]:
                fold_north(a, grid, loc, bcs)
    if bounded[0] and until > 0:
        for a, (loc, bcs), pl in zip(fields, locs_bcs, planes):
            fill_bounded_axis(a, grid, loc, bcs, 0, pl, pa)
    if until > 0:
        periodic_halo_fill_plain(grid, fields, z=False)
    if bounded[1] and until > 1:
        for a, (loc, bcs), pl in zip(fields, locs_bcs, planes):
            fill_bounded_axis(a, grid, loc, bcs, 1, pl, pa)
    if not z or until < 3:
        return
    for a in fields:
        _wrap_z(grid, a)
    if bounded[2] and fields and _z_extent(grid, fields[0])[1] > 0:
        bounded_z_fill_plain(grid, fields, [z_fill_spec(loc, bcs, pa)
                                            for loc, bcs in locs_bcs],
                             planes)


def boundary_plane(bc, grid, loc, axis, shape, dtype, device, time=0.0):
    """A side's condition over the boundary plane of a field of ``shape``:
    a tensor of ``shape`` with 1 along ``axis``, the padded transverse
    extents along the others, of ``dtype`` on ``device`` (JAX's
    ``eval_bc``): a scalar everywhere; an array of the plane's interior
    padded over the halos by topology (wrapped along a periodic transverse
    axis, its edge repeated along the others), any other array broadcast;
    a callable of the padded transverse coordinates at ``loc`` and the
    time; a FieldTimeSeries condition's padded z plane at the time."""
    from ..boundary_conditions.fill_halos import boundary_condition_value
    q = boundary_condition_value(bc, grid, loc, axis, time)
    out_shape = list(shape)
    out_shape[axis] = 1
    q = torch.as_tensor(0.0 if q is None else q, dtype=dtype, device=device)
    return q.broadcast_to(out_shape).contiguous()


def pa_face_plane(grid, rows, loc, bc, axis, is_left, ubar, dt):
    """The perturbation-advection face value of one side (JAX
    ``pa_face``): ``rows`` holds the boundary face uB and the face inside
    it uA along ``axis`` (a copy of two slots, filled along the earlier
    axes: left [uB, uA], right [uA, uB]), ``ubar`` the exterior value's
    plane. A backward-Euler upwind step toward ubar, relaxed with the
    inflow or outflow timescale (0 pins the face to ubar, ∞ relaxes
    nothing)."""
    H, N = grid.H[axis], grid.N[axis]
    dX = (grid.dx, grid.dy, grid.dz)[axis](loc)
    if isinstance(dX, torch.Tensor) and dX.ndim and dX.shape[axis] > 1:
        dX = dX.narrow(axis, H if is_left else H + N, 1)
    uB = rows.narrow(axis, 0 if is_left else 1, 1)
    uA = rows.narrow(axis, 1 if is_left else 0, 1)
    c = dt / dX * ubar
    if is_left:
        U = torch.clamp(c, -1.0, 0.0)
        outflowing = ubar <= 0
        num = uB - U * uA
        den = 1.0 - U
    else:
        U = torch.clamp(c, 0.0, 1.0)
        outflowing = ubar >= 0
        num = uB + U * uA
        den = 1.0 + U
    tin = bc.scheme.inflow_timescale
    tout = bc.scheme.outflow_timescale
    inv_in = 0.0 if (tin == 0 or np.isinf(tin)) else 1.0 / tin
    inv_out = 0.0 if (tout == 0 or np.isinf(tout)) else 1.0 / tout
    kw = dict(dtype=rows.dtype, device=rows.device)
    taut = dt * torch.where(outflowing, torch.tensor(inv_out, **kw),
                            torch.tensor(inv_in, **kw))
    relaxed = (num + ubar * taut) / (den + taut)
    pin = torch.where(outflowing, torch.tensor(tout == 0, device=rows.device),
                      torch.tensor(tin == 0, device=rows.device))
    return torch.where(pin, ubar, relaxed).contiguous()


def side_planes(grid, fields, locs_bcs, z=True, time=0.0, dt=None,
                kernel=False):
    """Per field, {(axis, side): plane} for each side whose map reads a
    plane (``PLANE_CODES`` with an array, callable or FieldTimeSeries
    condition; ``PA_FACE``), each a contiguous tensor of the field's
    shape with 1 along ``axis``, in the field's dtype on its device. A
    ``PA_FACE`` plane is ``pa_face_plane`` of the field's two boundary
    rows after the fills of the earlier axes, with the exterior value's
    plane at ``time``: with ``kernel`` the fill kernel fills those axes of
    a copy of the field, otherwise the plain fill fills them on a copy of
    the two rows."""
    fields = list(fields)
    if locs_bcs is None or not fields:
        return [{} for _ in fields]
    pa = dt is not None
    a0 = fields[0]
    codes = fill_codes(grid, a0.shape, locs_bcs, len(fields), z, pa=pa)
    out = []
    for a, (loc, bcs), fc in zip(fields, locs_bcs, codes):
        planes = {}
        pending = []
        for axis in range(3):
            for side, bc in enumerate(bcs.pair(axis)):
                code = fc[axis][2 * side]
                if code == PA_FACE:
                    pending.append((axis, side, bc))
                elif code in PLANE_CODES and bc is not None and \
                        bcm.is_plane_condition(bc.condition):
                    planes[(axis, side)] = boundary_plane(
                        bc, grid, loc, axis, a.shape, a.dtype, a.device,
                        time)
        for axis, side, bc in pending:
            start = grid.H[axis] + (0 if side == 0 else grid.N[axis] - 1)
            if kernel and axis > 0:
                rows = _launch(grid, [a.clone()], [(loc, bcs)], False, time,
                               None, until=axis)[0].narrow(axis, start, 2)
            else:
                rows = a.narrow(axis, start, 2).clone()
                cut = {k: p.narrow(axis, start, 2) if p.shape[axis] > 1
                       else p for k, p in planes.items() if k[0] < axis}
                _fill_sequence(grid, [rows], [(loc, bcs)], z, True, [cut],
                               until=axis)
            ubar = boundary_plane(bc, grid, loc, axis, a.shape, a.dtype,
                                  a.device, time)
            planes[(axis, side)] = pa_face_plane(grid, rows, loc, bc, axis,
                                                 side == 0, ubar, dt)
        out.append(planes)
    return out


fill_halos_plain.cuda_calls = 0


# -- the kernel's plan ----------------------------------------------------------

def extents(grid, shape):
    """(N, H) along each axis of a padded tensor of ``shape``: the grid's,
    with (1, 0) along z for a 2-D surface field."""
    shape = tuple(shape)
    padded = grid.padded_shape
    if len(shape) != 3 or shape[:2] != padded[:2] or \
            shape[2] not in (padded[2], 1):
        raise ValueError(f"field shape {shape} is neither the padded shape "
                         f"{padded} nor its 2-D surface")
    z = (grid.N[2], grid.H[2]) if shape[2] == padded[2] else (1, 0)
    return [(grid.N[0], grid.H[0]), (grid.N[1], grid.H[1]), z]


def _side_code(bc, face, pa=False):
    if _is_fold(bc):
        return FOLD_FACE if face else FOLD
    if _is_polar(bc):
        return POLAR_PINNED if face else POLAR_VALUE
    cls = _classification(bc)
    if face:
        if _is_pa(bc, pa):
            return PA_FACE
        return PINNED if cls in (bcm.OPEN, bcm.VALUE) else REFLECT
    if cls in (bcm.FLUX, bcm.OPEN):
        return MIRROR
    if cls == bcm.VALUE:
        return EXTRAPOLATE_VALUE
    if cls == bcm.GRADIENT:
        return EXTRAPOLATE_GRADIENT
    raise ValueError(f"unsupported BC {cls} for a centered location")


def fill_codes(grid, shape, locs_bcs=None, n=1, z=True, pa=False, until=3):
    """Per field, per axis, (low code, low value, high code, high value):
    ``locs_bcs`` gives each field's (location, boundary conditions), or None
    for ``n`` fields whose periodic axes alone are filled; ``pa``: the fill
    is given Δt (PerturbationAdvection sides take ``PA_FACE``); the axes
    from ``until`` on are not filled. A side whose map reads a plane has
    the value 0. Raises where the kernel's one load per slot would not
    hold."""
    ext = extents(grid, shape)
    out = []
    for lb in (locs_bcs if locs_bcs is not None else [None] * n):
        axes = []
        for ax, (N, H) in enumerate(ext):
            topo = grid.topology[ax]
            keep = (KEEP, 0.0, KEEP, 0.0)
            if H == 0 or (ax == 2 and not z) or ax >= until or \
                    topo not in (PERIODIC, BOUNDED) or \
                    all(side_connected(grid, ax)):
                axes.append(keep)
            elif topo == PERIODIC:
                # a periodic axis wraps whatever conditions its sides name,
                # as the JAX fill does (a model refuses them when built)
                if N < H:
                    raise ValueError(f"a periodic halo fill needs N >= H "
                                     f"along axis {ax} (N={N}, H={H})")
                axes.append((WRAP, 0.0, WRAP, 0.0))
            elif lb is None:
                axes.append(keep)
            else:
                loc, bcs = lb
                low, high = bcs.pair(ax)
                face = loc[ax] == FACE
                codes = (_side_code(low, face, pa), _value(low),
                         _side_code(high, face, pa), _value(high))
                # a side connected to another shard is the exchange's
                for side, on in enumerate(side_connected(grid, ax)):
                    if on:
                        codes = (codes[:2 * side] + (KEEP, 0.0)
                                 + codes[2 * side + 2:])
                if H > MAX_H:
                    raise ValueError(f"a bounded halo fill needs H <= "
                                     f"{MAX_H} along axis {ax} (H={H})")
                axes.append(codes)
        if axes[1][2] in FOLDS and (
                axes[0][0] != WRAP or ext[0][0] <= 2 * ext[0][1]
                or (axes[1][2] == FOLD and lb[0][0] == FACE
                    and ext[0][0] % 2)):
            # an x-face field centred in y with an odd Nx would swap two
            # columns of the substituted row: no single read
            raise ValueError("the north fold needs a periodic x with "
                             "Nx > 2Hx, and an even Nx for an x-face "
                             "field centred in y")
        out.append(axes)
    return out


def _side_source(codes, N, H, n):
    """The slot that slot ``n`` reads under its side's map (None for a
    pinned face, which reads nothing)."""
    lo, hi = kept_range(codes, N, H, N + 2 * H)
    if lo <= n < hi:
        return n
    E = H + N
    if n < lo:
        c = codes[0]
        if c == WRAP:
            return n + N
        if c == MIRROR:
            return 2 * H - 1 - n
        if c in EXTRAPOLATES:
            return H
        if (c in PINS and n == H) or c == PA_FACE:
            return None
        return 2 * H - n                     # reflect, or pinned's halo
    c = codes[2]
    if c == WRAP:
        return n - N
    if c == MIRROR:
        return 2 * E - 1 - n
    if c in EXTRAPOLATES:
        return E - 1
    if c in PINS and n == E:
        return None
    if c == PA_FACE:
        return None
    if c == FOLD:
        return n if n == E - 1 else 2 * E - 2 - n
    if c == FOLD_FACE:
        return 2 * E - 1 - n
    return 2 * E - n


def narrow_slots(codes, N, H):
    """The slots an axis's map leaves as they are although its side would
    write them: those whose source the axis itself writes (a bounded axis
    narrower than its halo needs). JAX's fill reads such a source before it
    writes it; no stencil of the models reaches that far. (The fold's
    substituted row reads its own slots through the x fold.)"""
    lo, hi = kept_range(codes, N, H, N + 2 * H)
    out = []
    for n in list(range(lo)) + list(range(hi, N + 2 * H)):
        src = _side_source(codes, N, H, n)
        if src is None or (codes[2] == FOLD and n == H + N - 1):
            continue
        if not lo <= src < hi:
            out.append(n)
    return out


def source_index(codes, N, H, n):
    """The slot that slot ``n`` reads along one axis under the kernel's map
    (``map_at`` in csrc/halo_fill.cu; None for a pinned face)."""
    if n in narrow_slots(codes, N, H):
        return n
    return _side_source(codes, N, H, n)


def axis_geometry(grid, shape):
    """Per axis (N, H, padded extent, (half_low, half_high),
    (dist_low[MAX_H], dist_high[MAX_H])): float64 from the grid's center
    coordinates, as ``fill_bounded_axis`` and ``z_distances`` form them (zero
    where an axis is not bounded)."""
    out = []
    for ax, (N, H) in enumerate(extents(grid, shape)):
        half, dist = [0.0, 0.0], [[0.0] * MAX_H, [0.0] * MAX_H]
        if grid.topology[ax] == BOUNDED and 0 < H <= MAX_H:
            xC = np.asarray(grid.coord_padded(ax, CENTER), dtype=np.float64)
            half = [float(xC[H] - xC[H - 1]) / 2,
                    float(xC[H + N] - xC[H + N - 1]) / 2]
            dist[0][:H] = [float(xC[H] - xC[m]) for m in range(H)]
            dist[1][:H] = [float(xC[H + N + m] - xC[H + N - 1])
                           for m in range(H)]
        out.append((N, H, N + 2 * H, half, dist))
    return out


def kept_range(codes, N, H, P):
    """The slots [lo, hi) along an axis that its map leaves as they are
    (``kept`` in csrc/halo_fill.cu)."""
    low, _, high, _ = codes
    return (0 if low == KEEP else H + (low in PINS),
            P if high == KEEP else H + N + (high == REFLECT) - (high == FOLD))


def extrapolated_slots(grid, shape, locs_bcs, z=True):
    """Per field, a boolean CPU tensor of ``shape``: the slots whose value
    involves an extrapolation (Value or Gradient on a center axis), which
    the kernel forms to roundoff; every other slot it copies exactly."""
    geom = axis_geometry(grid, shape)
    out = []
    for codes in fill_codes(grid, shape, locs_bcs, z=z):
        masks = []
        for ax, (N, H, P, _, _) in enumerate(geom):
            lo, hi = kept_range(codes[ax], N, H, P)
            m = torch.zeros(P, dtype=torch.bool)
            m[:lo] = codes[ax][0] in EXTRAPOLATES
            m[hi:] = codes[ax][2] in EXTRAPOLATES
            masks.append(m)
        out.append(masks[0][:, None, None] | masks[1][None, :, None]
                   | masks[2][None, None, :])
    return out


class _Plan(NamedTuple):
    batches: list      # (first, stop, parameter block, polar fields,
                       #  plane sides, any PA_FACE side)
    ptrs: object       # the launch's device pointers, rewritten per call


_plans = {}            # id(grid) -> {key: _Plan}, dropped with the grid


def plane_sides(codes, locs_bcs):
    """Per field, the (axis, side) of each side whose map reads a plane,
    in (axis, side) order: ``PA_FACE``, and ``PLANE_CODES`` with an array,
    callable or FieldTimeSeries condition (``side_planes`` forms them)."""
    out = []
    for fc, lb in zip(codes, locs_bcs or [None] * len(codes)):
        sides = []
        for axis in range(3):
            for side in range(2):
                code = fc[axis][2 * side]
                bc = None if lb is None else lb[1].pair(axis)[side]
                if code == PA_FACE or (code in PLANE_CODES and bc is not None
                                       and bcm.is_plane_condition(
                                           bc.condition)):
                    sides.append((axis, side))
        out.append(sides)
    return out


def _plane_size(shape, axis):
    return int(np.prod([n for ax, n in enumerate(shape) if ax != axis]))


def fills_nothing(codes):
    """Whether ``fill_codes``' codes keep every side of every axis (no
    launch): a shard's grid may keep one side of an axis and fill the
    other."""
    return all(c[0] == KEEP and c[2] == KEEP for f in codes for c in f)


def _build_plan(grid, shape, dtype, n, locs_bcs, z, pa, until):
    codes = fill_codes(grid, shape, locs_bcs, n, z, pa=pa, until=until)
    if fills_nothing(codes):
        return _Plan([], None)
    geom = axis_geometry(grid, shape)
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    dbls = lambda xs: (ctypes.c_double * len(xs))(*xs)
    N, H, P = (ints([g[i] for g in geom]) for i in range(3))
    half = dbls([h for g in geom for h in g[3]])
    dist = dbls([d for g in geom for side in g[4] for d in side])
    lib = build.library()
    size = lib.oc_fill_params_size()
    esize = torch.empty((), dtype=dtype).element_size()
    face_x = [int(lb is not None and lb[0][0] == FACE)
              for lb in (locs_bcs or [None] * n)]
    sides_of = plane_sides(codes, locs_bcs)
    batches = []
    for a, b in build.batches(n):
        sides = [s for f in codes[a:b] for c in f
                 for s in ((c[0], c[1]), (c[2], c[3]))]
        offsets, at = [], 0
        for k in range(a, b):
            own = [-1] * 6
            for axis, side in sides_of[k]:
                own[2 * axis + side] = at
                at += _plane_size(shape, axis)
            offsets += own
        params = ctypes.create_string_buffer(size)
        build.check(lib.oc_fill_plan(params, b - a, esize, N, H, P, half,
                                     dist, ints([s[0] for s in sides]),
                                     dbls([s[1] for s in sides]),
                                     ints(face_x[a:b]), ints(offsets)), lib)
        polar = [k for k, f in enumerate(codes[a:b])
                 if f[1][0] in POLARS or f[1][2] in POLARS]
        pa_batch = any(c in (f[ax][0], f[ax][2]) for f in codes[a:b]
                       for ax in range(3) for c in (PA_FACE,))
        batches.append((a, b, params, polar, sides_of[a:b], pa_batch))
    return _Plan(batches, (ctypes.c_void_p * build.BATCH)())


def _plan(grid, fields, locs_bcs, z, pa, until=3):
    per_grid = _plans.get(id(grid))
    if per_grid is None:
        per_grid = _plans[id(grid)] = {}
        weakref.finalize(grid, _plans.pop, id(grid), None)
    a = fields[0]
    key = (tuple(a.shape), a.dtype, len(fields), z, pa, until,
           None if locs_bcs is None else tuple(locs_bcs))
    plan = per_grid.get(key)
    if plan is None:
        plan = per_grid[key] = _build_plan(grid, tuple(a.shape), a.dtype,
                                           len(fields), locs_bcs, z, pa,
                                           until)
    return plan


def _check_batch(fields):
    dev, dt, shape = fields[0].device, fields[0].dtype, fields[0].shape
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dt}")
    if dev.type != "cuda":
        raise ValueError(f"no halo-fill kernel for device {dev}")
    for a in fields:
        if a.device != dev or a.dtype != dt:
            raise ValueError("all fields must share one device and dtype")
        if a.shape != shape:
            raise ValueError(f"field shapes differ: {tuple(a.shape)} and "
                             f"{tuple(shape)}")
        if not a.is_contiguous():
            raise ValueError("fields must be contiguous")
    if fields[0].numel() >= 2 ** 31:
        raise ValueError("the fill kernel takes fields of fewer than 2^31 "
                         "values (32-bit offsets)")


def fill_halos(grid, fields, locs_bcs=None, z=True, time=0.0, dt=None):
    """Fill the halos of padded tensors of one shape in place (the grid's
    padded shape, or all 2-D surface fields (Nx + 2Hx, Ny + 2Hy, 1)); returns
    them. ``locs_bcs`` gives each field's (location, boundary conditions):
    with it every periodic and bounded axis is filled (z only with ``z``),
    without it the periodic axes alone. Plane conditions are evaluated at
    ``time``; ``dt`` (the stage's Δt) activates the PerturbationAdvection
    faces. CPU tensors take the plain version; CUDA tensors launch the
    kernel, once per ``build.BATCH`` fields."""
    fields = list(fields)
    if not fields:
        return fields
    if locs_bcs is not None and len(locs_bcs) != len(fields):
        raise ValueError("one (location, boundary conditions) per field")
    pa = dt is not None
    held = shard_polar_means(grid, fields, locs_bcs)
    try:
        if all(a.device.type == "cpu" for a in fields):
            # raise where the kernel would
            fill_codes(grid, fields[0].shape, locs_bcs, len(fields), z,
                       pa=pa)
            fill_halos_plain(grid, fields, locs_bcs, z, time, dt)
        else:
            _launch(grid, fields, locs_bcs, z, time, dt)
    finally:
        if held is not None:
            grid._polar_means = None
    return exchange_connected(grid, fields, locs_bcs)


def _launch(grid, fields, locs_bcs, z, time, dt, until=3):
    """The kernel's launches of ``fill_halos`` on CUDA tensors, the axes
    from ``until`` on left as they are."""
    _check_batch(fields)
    plan = _plan(grid, fields, locs_bcs, z, dt is not None, until)
    if not plan.batches:
        return fields
    planes = None
    if any(sides for batch in plan.batches for sides in batch[4]):
        planes = side_planes(grid, fields, locs_bcs, z, time, dt,
                             kernel=True)
    surface = fields[0].shape[2] == 1 and grid.padded_shape[2] != 1
    with torch.cuda.device(fields[0].device):
        lib = build.library()
        stream = build.stream_of(fields[0])
        for a, b, params, polar, sides, pa_batch in plan.batches:
            for n, t in enumerate(fields[a:b]):
                plan.ptrs[n] = t.data_ptr()
            means = polar_means(grid, fields[a:b], polar)
            table = plane_table(planes[a:b], sides) if planes else None
            build.check(lib.oc_fill_halos(
                params, plan.ptrs, b - a,
                None if means is None else means.data_ptr(),
                None if table is None else table.data_ptr(), stream), lib)
            fill_halos.launches += 1
            if surface:
                fill_halos.surface_launches += 1
            if any(sides):
                fill_halos.plane_launches += 1
            if pa_batch:
                fill_halos.pa_launches += 1
    return fields


def plane_table(planes, sides):
    """The planes of one launch in one buffer, in the order of the plan's
    offsets (``plane_sides``); None without planes."""
    flat = [planes[k][s].reshape(-1) for k, own in enumerate(sides)
            for s in own]
    return torch.cat(flat) if flat else None


def polar_means(grid, fields, polar):
    """The polar caps' table of one launch: (fields, 2, nz), the south and
    north boundary rows' zonal means (``polar_row_mean``) of the fields
    listed in ``polar``, zero for the others; None without polar caps."""
    if not polar:
        return None
    zero = torch.zeros((2, fields[0].shape[2]), dtype=fields[0].dtype,
                       device=fields[0].device)
    return torch.stack([polar_row_means(grid, f) if k in polar else zero
                        for k, f in enumerate(fields)])


fill_halos.launches = 0
fill_halos.surface_launches = 0    # of them, those on 2-D surface fields
fill_halos.plane_launches = 0      # of them, those that read planes
fill_halos.pa_launches = 0         # of them, those with a PA_FACE side


def periodic_halo_fill(grid, fields):
    """Fill the periodic x/y halos of padded tensors in place (the axes the
    grid's topology makes periodic, over the full padded z); returns them:
    ``fill_halos`` without conditions."""
    return fill_halos(grid, fields)
