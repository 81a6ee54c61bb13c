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
along a periodic axis; along a bounded one the edge shards' outer sides are
the global grid's walls, which their own fills write, and have no strip
(JAX's ``_exchange_axis`` takes periodic axes only: its bounded sharded
axes go through GSPMD).

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

from .distributed import MULTI_CARD

MAX_STRIPS = 128      # kMaxStrips in csrc/halo_exchange.cu


def _fields_of(block):
    return [block] if isinstance(block, torch.Tensor) else list(block)


def _check(blocks, mesh, halo, local_n):
    Sx, Sy = mesh.devices.shape
    if len(blocks) != Sx or any(len(row) != Sy for row in blocks):
        raise ValueError(f"blocks must be a ({Sx}, {Sy}) nested list")
    for axis in (0, 1):
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


def _strips(fields, shape, axis, periodic=True):
    """(destination, source, side) of every strip along ``axis``: side 0 is
    the low halo, filled from the low neighbour's high interior edge; side 1
    the high halo, from the high neighbour's low interior edge. ``fields``
    lists each shard's fields in the mesh's row-major order. Along a
    periodic axis the last shard's neighbour is the first; along a bounded
    one the edge shards' outer sides are the global walls and have no
    strip."""
    Sx, Sy = shape
    S = shape[axis]
    out = []
    for i in range(Sx):
        for j in range(Sy):
            n = (i, j)[axis]
            dst = fields[i * Sy + j]
            for side, step in ((0, -1), (1, 1)):
                m = n + step
                if not periodic and not 0 <= m < S:
                    continue
                src = (m % Sx, j) if axis == 0 else (i, m % Sy)
                for f, a in enumerate(dst):
                    out.append((a, fields[src[0] * Sy + src[1]][f], side))
    return out


def _strip_slices(axis, side, h, n):
    """(destination slices, source slices) of a strip."""
    dst = slice(0, h) if side == 0 else slice(h + n, n + 2 * h)
    src = slice(n, n + h) if side == 0 else slice(h, 2 * h)
    if axis == 0:
        return (dst,), (src,)
    return (slice(None), dst), (slice(None), src)


def halo_exchange_plain(blocks, mesh, halo, local_n, periodic=(True, True),
                        fold=None):
    """Plain PyTorch version: the strips as slice copies, x, then the
    north fold (``fold``, as ``halo_exchange_local``'s), then y. Returns
    ``blocks``, updated in place."""
    fields = _check(blocks, mesh, halo, local_n)
    if fields[0][0].is_cuda:
        halo_exchange_plain.cuda_calls += 1
    for axis in (0, 1):
        h, n = halo[axis], local_n[axis]
        if axis == 1 and fold is not None:
            fold_plain(_top_row(fields, mesh), halo, local_n, fold)
        if h == 0:
            continue
        for dst, src, side in _strips(fields, mesh.devices.shape, axis,
                                      periodic[axis]):
            ds, ss = _strip_slices(axis, side, h, n)
            dst[ds].copy_(src[ss])
    return blocks


halo_exchange_plain.cuda_calls = 0


def _top_row(fields, mesh):
    """The fields of the top row of shards (i, Sy - 1), by i."""
    Sx, Sy = mesh.devices.shape
    return [fields[i * Sy + Sy - 1] for i in range(Sx)]


def fold_plain(top, halo, local_n, fold):
    """The tripolar north fold across the top row of shards, in place:
    ``top[i]`` the fields of shard (i, Sy - 1), ``fold[f]`` field f's
    (sign, x-face, y-face), or None for a field that does not fold. As the
    serial fill's ``fold_north`` over the global columns: halo row
    Hy + n - 1 + m takes row Hy + n - 1 - m (Hy + n - m for a y-face field)
    of the folded column i ↦ Nx - 1 - i (Nx - i for an x-face field, whose
    wrap element keeps |sign|), times the sign, over each block's padded x
    extent (the periodic images included); a field centred in y also
    substitutes the eastern half (global i >= Nx/2) of its last row."""
    hx, hy = halo[0], halo[1]
    nlx, nly = local_n[0], local_n[1]
    if nly < hy + 1:
        raise ValueError(
            f"the fold across shards reads the {hy} rows below the last "
            f"one inside the top row's blocks: a block needs Ny/Sy >= "
            f"{hy + 1} rows (has {nly})")
    Sx = len(top)
    Nx = Sx * nlx
    px = nlx + 2 * hx
    last = hy + nly - 1
    if top[0][0].is_cuda:
        fold_plain.cuda_calls += 1
    for f, spec in enumerate(fold):
        if spec is None:
            continue
        sign, face_x, face_y = spec
        dev = top[0][f].device
        # every top block's interior columns, before any write
        whole = torch.cat([b[f][hx:hx + nlx].to(dev) for b in top])
        for i, blocks in enumerate(top):
            a = blocks[f]
            ig = (i * nlx + torch.arange(px) - hx) % Nx
            src = (Nx - ig) % Nx if face_x else Nx - 1 - ig
            sgn = torch.full((px,) + (1,) * (a.ndim - 2), float(sign),
                             dtype=a.dtype)
            if face_x:
                sgn[ig == 0] = abs(float(sign))
            sgn = sgn.to(a.device)
            cols = whole[src.to(dev)].to(a.device)
            for m in range(1, hy + 1):
                row = last + 1 - m if face_y else last - m
                a[:, last + m] = sgn * cols[:, row]
            if not face_y:
                east = (ig >= Nx // 2).to(a.device)
                a[east, last] = (sgn * cols[:, last])[east]


fold_plain.cuda_calls = 0


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


def mesh_fold_exchange(top, halo, local_n, fold):
    """``fold_plain`` in launches of ``oc_mesh_fold_exchange`` (one per
    ``build.BATCH`` folding fields), the top row's blocks on one CUDA
    device."""
    from ..kernels import build
    first = top[0][0]
    dev = first.device
    idx = [f for f, spec in enumerate(fold) if spec is not None]
    for fs in top:
        for f in idx:
            if fs[f].device != dev or not fs[f].is_contiguous():
                raise NotImplementedError(
                    f"the north fold across shards on several cards: "
                    f"{MULTI_CARD}")
    Sx = len(top)
    if (Sx * local_n[0]) % 2 and any(fold[f][1] and not fold[f][2]
                                     for f in idx):
        raise ValueError(
            f"the fold of an x-face field centred in y needs an even Nx "
            f"(has {Sx * local_n[0]}): its last row's columns would swap")
    PY = first.shape[1]
    PZ = first.shape[2] if first.dim() == 3 else 1
    with torch.cuda.device(dev):
        lib = build.library()
        for k in range(0, len(idx), build.BATCH):
            chunk = idx[k:k + build.BATCH]
            ptrs = [top[i][f].data_ptr() for f in chunk for i in range(Sx)]
            blocks = (ctypes.c_void_p * len(ptrs))(*ptrs)
            signs = (ctypes.c_double * len(chunk))(
                *[float(fold[f][0]) for f in chunk])
            faces = (ctypes.c_int * len(chunk))(
                *[int(fold[f][1]) | 2 * int(fold[f][2]) for f in chunk])
            build.check(lib.oc_mesh_fold_exchange(
                blocks, signs, faces, len(chunk), Sx, first.element_size(),
                PY, PZ, halo[0], halo[1], local_n[0], local_n[1],
                build.stream_of(first)), lib)
            mesh_fold_exchange.launches += 1


mesh_fold_exchange.launches = 0


def halo_exchange_local(blocks, mesh, halo, local_n, periodic=(True, True),
                        fold=None):
    """Exchange the halos of the per-shard blocks, x then y.

    ``blocks`` is the mesh's (Sx, Sy) nested list; ``blocks[i][j]`` is the
    locally padded tensor of shard (i, j), or a list of them, one per field,
    each on the shard's device. ``halo`` and ``local_n`` give (Hx, Hy, ...)
    and the local interior (nlx, nly, ...); every local interior must be at
    least as wide as its halo. ``periodic`` flags x and y: along a bounded
    axis the edge shards' outer sides are not exchanged. ``fold`` (a
    tripolar grid's north side) gives each field's (sign, x-face, y-face),
    or None for a field that does not fold: between the x and the y
    strips the top row of shards exchanges across the fold
    (``fold_plain``; on one card ``oc_mesh_fold_exchange``). CPU blocks
    take the plain version;
    blocks on CUDA devices take the kernel for strips within a device and
    peer copies between devices. Returns ``blocks``, updated in place."""
    fields = _check(blocks, mesh, halo, local_n)
    on_cpu = [a.device.type == "cpu" for fs in fields for a in fs]
    if all(on_cpu):
        return halo_exchange_plain(blocks, mesh, halo, local_n, periodic,
                                   fold)
    if any(on_cpu):
        raise ValueError("the blocks mix CPU and CUDA devices")
    for axis in (0, 1):
        h, n = halo[axis], local_n[axis]
        if axis == 1 and fold is not None:
            mesh_fold_exchange(_top_row(fields, mesh), halo, local_n, fold)
        if h == 0:
            continue
        local = {}
        for dst, src, side in _strips(fields, mesh.devices.shape, axis,
                                      periodic[axis]):
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
