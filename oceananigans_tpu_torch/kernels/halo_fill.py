"""Batched periodic halo fill, in place.

Replaces the TPU kernel ``oceananigans_tpu/kernels/pallas_fill.py``
``_build_batched`` (via ``get_batched_fill``) and the wrap half of ``_build``
(via ``get_pallas_fill``): periodic x, then periodic y over the full x
extent, so that corners carry the x-wrapped columns. The z-fix of the TPU
kernel is the identity in the z-compact layout and is not part of this
kernel.

Bound on the H100: data movement only, (2Hx·PY + 2Nx·Hy)·Nz elements read and
written per field (about 4.3 MB each way per float32 field at 264x264x256),
so launch latency dominates. Design: one launch for a whole batch of fields,
one thread per halo element, z fastest across threads, each halo slot copied
straight from the interior cell it images (``csrc/halo_fill.cu``).

The fill updates the tensors in place (as the TPU kernel aliases its
outputs to its inputs) and returns them.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_FIELDS = 16


def _geometry(grid):
    Nx, Ny, Nz = grid.N
    Hx, Hy, Hz = grid.H
    return Nx, Ny, Nz, Hx, Hy, Hz


def periodic_halo_fill_plain(grid, fields):
    """Plain PyTorch version: wrap x, then wrap y over the full x extent."""
    Nx, Ny, _, Hx, Hy, _ = _geometry(grid)
    for a in fields:
        if a.is_cuda:
            periodic_halo_fill_plain.cuda_calls += 1
        if Hx:
            a[:Hx] = a[Nx:Nx + Hx]
            a[Hx + Nx:] = a[Hx:2 * Hx]
        if Hy:
            a[:, :Hy] = a[:, Ny:Ny + Hy]
            a[:, Hy + Ny:] = a[:, Hy:2 * Hy]
    return fields


periodic_halo_fill_plain.cuda_calls = 0


def _check(grid, fields):
    Nx, Ny, Nz, Hx, Hy, Hz = _geometry(grid)
    if Hz != 0:
        raise ValueError("the halo-fill kernel takes z-halo-free fields")
    if Nx < Hx or Ny < Hy:
        raise ValueError("the periodic wrap needs N >= H along x and y")
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"the halo-fill kernel takes 1 to {MAX_FIELDS} fields")
    shape = grid.padded_shape
    dev, dt = fields[0].device, fields[0].dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dt}")
    for a in fields:
        if a.device != dev or a.dtype != dt:
            raise ValueError("all fields must share one device and dtype")
        if tuple(a.shape) != shape:
            raise ValueError(f"field shape {tuple(a.shape)} != padded {shape}")
        if not a.is_contiguous():
            raise ValueError("fields must be contiguous")


def periodic_halo_fill(grid, fields):
    """Fill the periodic x/y halos of padded tensors in place; returns them.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    fields = list(fields)
    if not fields:
        return fields
    if all(a.device.type == "cpu" for a in fields):
        return periodic_halo_fill_plain(grid, fields)
    _check(grid, fields)
    if not fields[0].is_cuda:
        raise ValueError(f"no halo-fill kernel for device {fields[0].device}")
    Nx, Ny, Nz, Hx, Hy, _ = _geometry(grid)
    ptrs = (ctypes.c_void_p * len(fields))(*[a.data_ptr() for a in fields])
    with torch.cuda.device(fields[0].device):
        lib = build.library()
        build.check(lib.oc_halo_fill(ptrs, len(fields),
                                     fields[0].element_size(), Nx, Ny, Nz,
                                     Hx, Hy, build.stream_of(fields[0])), lib)
    periodic_halo_fill.launches += 1
    return fields


periodic_halo_fill.launches = 0
