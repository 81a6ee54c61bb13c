"""Halo fills, in place: the batched periodic wrap and the bounded-z fill.

``periodic_halo_fill`` replaces the TPU kernel
``oceananigans_tpu/kernels/pallas_fill.py`` ``_build_batched`` (via
``get_batched_fill``) and the wrap half of ``_build`` (via
``get_pallas_fill``): periodic x, then periodic y over the full x extent, so
that corners carry the x-wrapped columns, over the full padded z; like the
TPU kernel's per-axis flags, only the axes the grid makes periodic wrap.

``bounded_z_fill`` replaces the z-fix half of ``_build``: the bounded-z fill
of ``_fill_axis`` (``boundary_conditions/fill_halos.py``) for a batch of
fields, each with its z location and a (classification, scalar value) pair
per side (``ZFill``). It runs after the wrap, over the full padded x and y,
so corner columns carry wrapped values (the reference's x → y → z order).

Bound on the H100: data movement only, a few MB per field, so launch latency
dominates. Design (``csrc/halo_fill.cu``): one launch for a batch of up to
``build.BATCH`` fields (their pointers ride in the kernel's parameter block;
more fields take one launch per batch, and no field's fill reads another's),
one thread per halo element, z fastest across threads; every slot is written
from the interior cells it images, so the in-place update has no race.

The fills update the tensors in place (as the TPU kernels alias their
outputs to their inputs) and return them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

MAX_HZ = 8

# Boundary classifications as csrc/halo_fill.cu numbers them.
FLUX, OPEN, VALUE, GRADIENT = 0, 1, 2, 3


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


def _check_batch(grid, fields, shape=None):
    shape = grid.padded_shape if shape is None else shape
    dev, dt = fields[0].device, fields[0].dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dt}")
    if dev.type != "cuda":
        raise ValueError(f"no halo-fill kernel for device {dev}")
    for a in fields:
        if a.device != dev or a.dtype != dt:
            raise ValueError("all fields must share one device and dtype")
        if tuple(a.shape) != shape:
            raise ValueError(f"field shape {tuple(a.shape)} != padded {shape}")
        if not a.is_contiguous():
            raise ValueError("fields must be contiguous")


def _on_cpu(fields):
    return all(a.device.type == "cpu" for a in fields)


# -- periodic wrap ------------------------------------------------------------

def wrap_axes(grid):
    """(wrap_x, wrap_y): which of x and y are periodic with a halo."""
    from ..grids.topology import PERIODIC
    return tuple(grid.topology[a] == PERIODIC and grid.H[a] > 0
                 for a in (0, 1))


def _z_extent(grid, a):
    """(Nz, Hz) of a padded tensor: the grid's, or (1, 0) for a 2-D
    (Nx + 2Hx, Ny + 2Hy, 1) surface field on a grid with a z halo."""
    if a.shape[2] == 1 and grid.padded_shape[2] != 1:
        return 1, 0
    return grid.N[2], grid.H[2]


def periodic_halo_fill_plain(grid, fields):
    """Plain PyTorch version: wrap x (over the full y extent), then wrap y
    over the full x extent, each axis only if it is periodic (every z slot,
    z halos included)."""
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
    return fields


periodic_halo_fill_plain.cuda_calls = 0


def periodic_halo_fill(grid, fields):
    """Fill the periodic x/y halos of padded tensors in place (the axes the
    grid's topology makes periodic); returns them. The tensors are the
    grid's padded shape, or all 2-D surface fields (Nx + 2Hx, Ny + 2Hy, 1).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    fields = list(fields)
    wx, wy = wrap_axes(grid)
    if not fields or not (wx or wy):
        return fields
    if _on_cpu(fields):
        return periodic_halo_fill_plain(grid, fields)
    Nz, Hz = _z_extent(grid, fields[0])
    shape = grid.padded_shape[:2] + (Nz + 2 * Hz,)
    _check_batch(grid, fields, shape)
    Nx, Ny, _, Hx, Hy, _ = _geometry(grid)
    if (wx and Nx < Hx) or (wy and Ny < Hy):
        raise ValueError("the periodic wrap needs N >= H along x and y")
    with torch.cuda.device(fields[0].device):
        lib = build.library()
        for a, b in build.batches(len(fields)):
            batch = fields[a:b]
            build.check(lib.oc_halo_fill(build.pointers(batch), len(batch),
                                         fields[0].element_size(), Nx, Ny, Nz,
                                         Hx, Hy, Hz, int(wx), int(wy),
                                         build.stream_of(fields[0])),
                        lib)
            periodic_halo_fill.launches += 1
    return fields


periodic_halo_fill.launches = 0


# -- bounded z ----------------------------------------------------------------

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
    return cls in (OPEN, VALUE)


def bounded_z_fill_plain(grid, fields, specs):
    """Plain PyTorch version of the bounded-z fill (``_fill_axis`` along z,
    in place); ``specs`` holds one ``ZFill`` per field."""
    H, N = grid.H[2], grid.N[2]
    half_b, half_t, dist_b, dist_t = z_distances(grid)
    for a, spec in zip(fields, specs):
        if a.is_cuda:
            bounded_z_fill_plain.cuda_calls += 1
        (cb, vb), (ct, vt) = spec.bottom, spec.top
        if not spec.face:
            if cb in (FLUX, OPEN):
                a[..., :H] = torch.flip(a[..., H:2 * H], [-1])
            else:
                c1 = a[..., H:H + 1].clone()
                grad = (c1 - vb) / half_b if cb == VALUE \
                    else vb * torch.ones_like(c1)
                for s in range(H):
                    a[..., s:s + 1] = c1 - grad * dist_b[s]
            if ct in (FLUX, OPEN):
                a[..., H + N:] = torch.flip(a[..., N:H + N], [-1])
            else:
                cN = a[..., H + N - 1:H + N].clone()
                grad = (vt - cN) / half_t if ct == VALUE \
                    else vt * torch.ones_like(cN)
                for m in range(H):
                    a[..., H + N + m:H + N + m + 1] = cN + grad * dist_t[m]
            continue
        low = torch.flip(a[..., H + 1:2 * H + 1], [-1])
        a[..., :H] = 2 * vb - low if _pins(cb) else low
        if _pins(cb):
            a[..., H] = vb
        if _pins(ct):
            a[..., H + N] = vt
        high = torch.flip(a[..., N + 1:H + N], [-1])
        a[..., H + N + 1:] = 2 * vt - high if _pins(ct) else high
    return fields


bounded_z_fill_plain.cuda_calls = 0


def bounded_z_fill(grid, fields, specs):
    """Fill the bounded-z halos of padded tensors in place; returns them.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    fields, specs = list(fields), list(specs)
    if len(fields) != len(specs):
        raise ValueError("one ZFill per field")
    if not fields:
        return fields
    Nx, Ny, Nz, Hx, Hy, Hz = _geometry(grid)
    if not 1 <= Hz <= MAX_HZ or Nz < Hz + 1:
        raise ValueError(f"the bounded-z fill needs 1 <= Hz <= {MAX_HZ} and "
                         "Nz > Hz")
    if _on_cpu(fields):
        return bounded_z_fill_plain(grid, fields, specs)
    _check_batch(grid, fields)
    half_b, half_t, dist_b, dist_t = z_distances(grid)
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    dbls = lambda xs: (ctypes.c_double * len(xs))(*xs)
    with torch.cuda.device(fields[0].device):
        lib = build.library()
        for a, b in build.batches(len(fields)):
            batch, bspecs = fields[a:b], specs[a:b]
            build.check(lib.oc_bounded_z_fill(
                build.pointers(batch), len(batch), fields[0].element_size(),
                ints([int(s.face) for s in bspecs]),
                ints([s.bottom[0] for s in bspecs]),
                ints([s.top[0] for s in bspecs]),
                dbls([float(s.bottom[1]) for s in bspecs]),
                dbls([float(s.top[1]) for s in bspecs]),
                Nx, Ny, Nz, Hx, Hy, Hz, half_b, half_t, dbls(dist_b),
                dbls(dist_t), build.stream_of(fields[0])), lib)
            bounded_z_fill.launches += 1
    return fields


bounded_z_fill.launches = 0
