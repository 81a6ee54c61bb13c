"""The two stencil passes around the pressure solve (z-compact layout).

``fused_divergence`` replaces the TPU kernel
``oceananigans_tpu/kernels/fused_projection.py`` ``build_fused_divergence``
(``dct_z=False``): ``rhs = div(u, v, w) / Δt`` on the interior, with w's
bottom boundary face read as 0 (the pin) and its missing top face read as 0
(the rigid lid). Velocity halos must be valid (one ring is read).

``fused_correct`` replaces ``build_fused_correct``: ``u, v, w ← u*, v*, w* −
Δt ∇p`` from a padded ``p`` with valid halos. w's bottom face comes out
pinned to 0, and the outputs are padded with valid periodic x/y halos.

Bound on the H100: memory. The divergence moves 16 B per cell in float32
(3 reads, 1 write), the correction 28 B (4 reads, 3 writes); the stencil
neighbours are the same z-runs of adjacent columns and hit L1/L2. Design
(``csrc/fused_projection.cu``): one thread per interior cell, z fastest
across threads so every warp access is contiguous; the correction stores
each result at its periodic halo images too, replacing the TPU kernel's
strip DMAs.
"""

from __future__ import annotations

import torch

from ..defaults import numpy_dtype
from ..grids.topology import LOC_CCC
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _metrics(grid):
    """Regular-grid metric scalars in float64, formed as the TPU kernels'
    tile grid forms them."""
    ccc = LOC_CCC
    dx, dy, dz = grid.dx(ccc), grid.dy(ccc), grid.dz(ccc)
    return dict(dx=dx, dy=dy, dz=dz, Ax=dy * dz, Ay=dx * dz, Az=dx * dy,
                V=dx * dy * dz)


def scalar_product(dtype, a, b):
    """a·b rounded in the field dtype (both factors first cast to it), as a
    Python float."""
    nt = numpy_dtype(dtype)
    return float(nt(a) * nt(b))


def check_fast_layout(grid):
    """Raise unless the grid is in the layout the kernels take: regular,
    periodic x/y, no z halo, N >= H along x and y."""
    from ..grids.topology import BOUNDED, PERIODIC
    if grid.topology[:2] != (PERIODIC, PERIODIC) or grid.topology[2] != BOUNDED:
        raise ValueError(
            "the z-compact kernels take periodic x/y and a bounded z, as the "
            "TPU kernels do (the model takes the padded layout elsewhere)")
    if grid.H[2] != 0:
        raise ValueError("the fused kernels take the z-compact layout (H[2] == 0)")
    if grid.N[0] < grid.H[0] or grid.N[1] < grid.H[1]:
        raise ValueError("the periodic halo images need N >= H along x and y")


def check_tensors(grid, tensors, shape):
    """Device, dtype, shape and contiguity checks shared by the wrappers."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dt}")
    if dt != grid.dtype:
        raise TypeError(f"tensor dtype {dt} != grid dtype {grid.dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError("all tensors must share one device and dtype")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"tensor shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    if not dev.type == "cuda":
        raise ValueError(f"no kernel for device {dev}")


# -- divergence ----------------------------------------------------------------

def fused_divergence_plain(grid, u, v, w, inv_dt):
    """Plain PyTorch version of the divergence source."""
    if u.is_cuda:
        fused_divergence_plain.cuda_calls += 1
    m = _metrics(grid)
    Hx, Hy, _ = grid.H
    Nx, Ny, _ = grid.N
    sx, sy = slice(Hx, Hx + Nx), slice(Hy, Hy + Ny)
    du = u[Hx + 1:Hx + Nx + 1, sy] - u[sx, sy]
    dv = v[sx, Hy + 1:Hy + Ny + 1] - v[sx, sy]
    wt = w[sx, sy].clone()
    wt[..., 0] = 0
    wtop = torch.zeros_like(wt)
    wtop[..., :-1] = wt[..., 1:]
    dw = wtop - wt
    ax_v, ay_v, az_v = m["Ax"] / m["V"], m["Ay"] / m["V"], m["Az"] / m["V"]
    return (ax_v * du + ay_v * dv + az_v * dw) * float(inv_dt)


fused_divergence_plain.cuda_calls = 0


def fused_divergence(grid, u, v, w, inv_dt):
    """``rhs = div(u, v, w) · inv_dt`` of shape ``grid.N``. ``inv_dt`` is a
    scalar in the field dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if u.device.type == "cpu":
        return fused_divergence_plain(grid, u, v, w, inv_dt)
    check_fast_layout(grid)
    check_tensors(grid, (u, v, w), grid.padded_shape)
    m = _metrics(grid)
    Nx, Ny, Nz = grid.N
    Hx, Hy, _ = grid.H
    rhs = torch.empty(grid.N, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        lib = build.library()
        build.check(lib.oc_fused_divergence(
            _DTYPE_CODES[u.dtype], build.ptr(u), build.ptr(v), build.ptr(w),
            build.ptr(rhs), Nx, Ny, Nz, Hx, Hy, m["Ax"] / m["V"],
            m["Ay"] / m["V"], m["Az"] / m["V"], float(inv_dt),
            build.stream_of(u)), lib)
    fused_divergence.launches += 1
    return rhs


fused_divergence.launches = 0


# -- correction ----------------------------------------------------------------

def fused_correct_plain(grid, p, u, v, w, dt):
    """Plain PyTorch version of the correction: padded outputs with valid
    periodic halos."""
    from .halo_fill import periodic_halo_fill_plain
    if u.is_cuda:
        fused_correct_plain.cuda_calls += 1
    m = _metrics(grid)
    Hx, Hy, _ = grid.H
    Nx, Ny, _ = grid.N
    sx, sy = slice(Hx, Hx + Nx), slice(Hy, Hy + Ny)
    pt = p[sx, sy]
    dpx = pt - p[Hx - 1:Hx + Nx - 1, sy]
    dpy = pt - p[sx, Hy - 1:Hy + Ny - 1]
    dpz = pt.clone()
    dpz[..., 1:] = pt[..., 1:] - pt[..., :-1]
    # Δt·(1/Δ) formed in the field dtype, as the TPU kernel does
    cx, cy, cz = (scalar_product(u.dtype, dt, 1.0 / m[d])
                  for d in ("dx", "dy", "dz"))
    outs = [torch.empty_like(u), torch.empty_like(v), torch.empty_like(w)]
    outs[0][sx, sy] = u[sx, sy] - cx * dpx
    outs[1][sx, sy] = v[sx, sy] - cy * dpy
    wn = w[sx, sy] - cz * dpz
    wn[..., 0] = 0
    outs[2][sx, sy] = wn
    periodic_halo_fill_plain(grid, outs)
    return tuple(outs)


fused_correct_plain.cuda_calls = 0


def fused_correct(grid, p, u, v, w, dt):
    """``(u, v, w) ← (u*, v*, w*) − Δt ∇p``: padded outputs with valid
    periodic halos, w's bottom face pinned. ``dt`` is a scalar in the field
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if u.device.type == "cpu":
        return fused_correct_plain(grid, p, u, v, w, dt)
    check_fast_layout(grid)
    check_tensors(grid, (p, u, v, w), grid.padded_shape)
    m = _metrics(grid)
    Nx, Ny, Nz = grid.N
    Hx, Hy, _ = grid.H
    outs = tuple(torch.empty_like(u) for _ in range(3))
    with torch.cuda.device(u.device):
        lib = build.library()
        build.check(lib.oc_fused_correct(
            _DTYPE_CODES[u.dtype], build.ptr(p), build.ptr(u), build.ptr(v),
            build.ptr(w), *[build.ptr(o) for o in outs], Nx, Ny, Nz, Hx, Hy,
            float(dt), 1.0 / m["dx"], 1.0 / m["dy"], 1.0 / m["dz"],
            build.stream_of(u)), lib)
    fused_correct.launches += 1
    return outs


fused_correct.launches = 0
