"""Halo exchange between the per-shard blocks of a device mesh.

The blocks are resident: each shard's padded blocks live on its device for
the whole run (``parallel/distributed.py``), and every halo fill of a
shard's grid ends with this exchange, through the mesh's communicator
(``parallel/communicator.py`` ``exchange``), which runs it once over every
shard's fields.

Counterpart of ``oceananigans_tpu/parallel/halo_exchange.py``. Each shard
holds its own halo-padded local block, laid out [h | n | h] along x and y
(z, when present, is carried whole). The exchange fills the x halos of every
block from its x neighbours, then the y halos from its y neighbours over the
full x extent: the y strips carry the x halos just filled, so the corners
arrive in two hops, as in the JAX package. Neighbours wrap around the mesh
(periodic axes); a non-periodic axis raises, as ``_exchange_axis`` does.

Routes, chosen by where the blocks lie (none is a fallback for another):

- ``halo_exchange_plain`` slices and copies; it serves CPU blocks.
- Blocks on one CUDA device: ``mesh_halo_exchange`` launches the kernel
  ``oc_mesh_halo_exchange`` (``csrc/halo_exchange.cu``), one launch per axis
  and device for every co-resident block of every field, from a table of
  (destination block, source block, side) strips. On a one-shard axis it is
  the periodic wrap of kernel #4.
- A strip whose source block lies on another device goes by a peer
  ``copy_``, the counterpart of a ``ppermute`` over the chips' links.

The JAX exchange is ``lax.ppermute`` (XLA, not Pallas): the kernel keeps the
48-64 strips of a shallow-water or convection stage off the host.

Bound on the H100: memory traffic, each halo element read once and written
once (2 × the strips' bytes over 3.35 TB/s). Design (``csrc/halo_exchange.cu``):
one thread per halo element, z fastest across threads, the strip uniform per
block (``blockIdx.y``), 64-bit offsets. Every strip reads interior slots of
its source and writes halo slots of its destination, so with each local
interior at least as wide as the halo no slot is both read and written in
one pass.
"""

from __future__ import annotations

import ctypes

import torch

MAX_STRIPS = 128      # kMaxStrips in csrc/halo_exchange.cu


def _fields_of(block):
    return [block] if isinstance(block, torch.Tensor) else list(block)


def _check(blocks, mesh, halo, local_n, periodic):
    Sx, Sy = mesh.devices.shape
    if len(blocks) != Sx or any(len(row) != Sy for row in blocks):
        raise ValueError(f"blocks must be a ({Sx}, {Sy}) nested list")
    for axis in (0, 1):
        if not periodic[axis]:
            raise NotImplementedError(
                "shard_map halo exchange supports periodic axes only")
        if local_n[axis] < halo[axis]:
            raise ValueError(
                f"the local interior ({local_n[axis]} along axis {axis}) "
                f"must be at least as wide as the halo ({halo[axis]})")
    fields = [_fields_of(b) for row in blocks for b in row]
    nf = len(fields[0])
    first = fields[0][0]
    shape = tuple(n + 2 * h for n, h in zip(local_n[:2], halo[:2]))
    for fs in fields:
        if len(fs) != nf:
            raise ValueError("every shard must hold the same fields")
        for a in fs:
            if a.dtype != first.dtype or tuple(a.shape[:2]) != shape \
                    or a.shape[2:] != first.shape[2:]:
                raise ValueError(
                    f"block of shape {tuple(a.shape)} and dtype {a.dtype}; "
                    f"expected {shape} + {tuple(first.shape[2:])}, "
                    f"{first.dtype}")
    return fields


def _strips(fields, shape, axis):
    """(destination, source, side) of every strip along ``axis``: side 0 is
    the low halo, filled from the low neighbour's high interior edge; side 1
    the high halo, from the high neighbour's low interior edge. ``fields``
    lists each shard's fields in the mesh's row-major order."""
    Sx, Sy = shape
    out = []
    for i in range(Sx):
        for j in range(Sy):
            if axis == 0:
                lo, hi = ((i - 1) % Sx, j), ((i + 1) % Sx, j)
            else:
                lo, hi = (i, (j - 1) % Sy), (i, (j + 1) % Sy)
            dst = fields[i * Sy + j]
            for f, a in enumerate(dst):
                out.append((a, fields[lo[0] * Sy + lo[1]][f], 0))
                out.append((a, fields[hi[0] * Sy + hi[1]][f], 1))
    return out


def _strip_slices(axis, side, h, n):
    """(destination slices, source slices) of a strip."""
    dst = slice(0, h) if side == 0 else slice(h + n, n + 2 * h)
    src = slice(n, n + h) if side == 0 else slice(h, 2 * h)
    if axis == 0:
        return (dst,), (src,)
    return (slice(None), dst), (slice(None), src)


def halo_exchange_plain(blocks, mesh, halo, local_n, periodic=(True, True)):
    """Plain PyTorch version: the strips as slice copies, x then y. Returns
    ``blocks``, updated in place."""
    fields = _check(blocks, mesh, halo, local_n, periodic)
    if fields[0][0].is_cuda:
        halo_exchange_plain.cuda_calls += 1
    for axis in (0, 1):
        h, n = halo[axis], local_n[axis]
        if h == 0:
            continue
        for dst, src, side in _strips(fields, mesh.devices.shape, axis):
            ds, ss = _strip_slices(axis, side, h, n)
            dst[ds].copy_(src[ss])
    return blocks


halo_exchange_plain.cuda_calls = 0


def mesh_halo_exchange(strips, axis, h, n):
    """Fill the halo strips ``strips`` ((destination, source, side) of
    padded blocks of one shape, dtype and CUDA device) along ``axis`` in one
    launch of ``oc_mesh_halo_exchange`` per ``MAX_STRIPS`` strips."""
    from ..kernels import build
    first = strips[0][0]
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"no halo-exchange kernel for device {dev}")
    if first.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {first.dtype}")
    for dst, src, _ in strips:
        for a in (dst, src):
            if a.device != dev or a.shape != first.shape \
                    or a.dtype != first.dtype or not a.is_contiguous():
                raise ValueError("the strips' blocks must share one device, "
                                 "shape and dtype, and be contiguous")
    PX, PY = first.shape[0], first.shape[1]
    PZ = first.shape[2] if first.dim() == 3 else 1
    with torch.cuda.device(dev):
        lib = build.library()
        for k in range(0, len(strips), MAX_STRIPS):
            chunk = strips[k:k + MAX_STRIPS]
            m = len(chunk)
            dsts = (ctypes.c_void_p * m)(*[d.data_ptr() for d, _, _ in chunk])
            srcs = (ctypes.c_void_p * m)(*[s.data_ptr() for _, s, _ in chunk])
            sides = (ctypes.c_int * m)(*[side for _, _, side in chunk])
            build.check(lib.oc_mesh_halo_exchange(
                dsts, srcs, sides, m, first.element_size(), axis, PX, PY, PZ,
                h, n, build.stream_of(first)), lib)
            mesh_halo_exchange.launches += 1


mesh_halo_exchange.launches = 0


def halo_exchange_local(blocks, mesh, halo, local_n, periodic=(True, True)):
    """Exchange the halos of the per-shard blocks, x then y.

    ``blocks`` is the mesh's (Sx, Sy) nested list; ``blocks[i][j]`` is the
    locally padded tensor of shard (i, j), or a list of them, one per field,
    each on the shard's device. ``halo`` and ``local_n`` give (Hx, Hy, ...)
    and the local interior (nlx, nly, ...); every local interior must be at
    least as wide as its halo. ``periodic`` flags x and y; a non-periodic
    axis raises ``NotImplementedError``. CPU blocks take the plain version;
    blocks on CUDA devices take the kernel for strips within a device and
    peer copies between devices. Returns ``blocks``, updated in place."""
    fields = _check(blocks, mesh, halo, local_n, periodic)
    on_cpu = [a.device.type == "cpu" for fs in fields for a in fs]
    if all(on_cpu):
        return halo_exchange_plain(blocks, mesh, halo, local_n, periodic)
    if any(on_cpu):
        raise ValueError("the blocks mix CPU and CUDA devices")
    for axis in (0, 1):
        h, n = halo[axis], local_n[axis]
        if h == 0:
            continue
        local = {}
        for dst, src, side in _strips(fields, mesh.devices.shape, axis):
            if src.device == dst.device:
                local.setdefault(dst.device, []).append((dst, src, side))
            else:
                ds, ss = _strip_slices(axis, side, h, n)
                dst[ds].copy_(src[ss])
        for strips in local.values():
            mesh_halo_exchange(strips, axis, h, n)
    return blocks


def make_halo_exchange(mesh, halo, local_n):
    """The exchange as a function of one tensor laid out as the per-shard
    padded blocks side by side, (Sx·(nlx + 2Hx), Sy·(nly + 2Hy), ...): it
    cuts the blocks out onto their shards' devices, exchanges their halos
    and returns them stitched back together on the input's device."""
    Sx, Sy = mesh.devices.shape
    bx = local_n[0] + 2 * halo[0]
    by = local_n[1] + 2 * halo[1]

    def fn(a):
        blocks = [[a[i * bx:(i + 1) * bx, j * by:(j + 1) * by].to(
            mesh.devices[i, j], copy=True, memory_format=torch.contiguous_format)
            for j in range(Sy)] for i in range(Sx)]
        halo_exchange_local(blocks, mesh, halo, local_n)
        return torch.cat([torch.cat([b.to(a.device) for b in row], dim=1)
                          for row in blocks], dim=0)

    return fn
