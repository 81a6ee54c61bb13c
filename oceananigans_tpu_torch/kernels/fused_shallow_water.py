"""The fused shallow-water stage: conservative tendency plus RK3 update.

``fused_sw_update`` replaces the TPU kernel
``oceananigans_tpu/kernels/fused_shallow_water.py`` ``build_fused_sw_update``:
for the padded (Nx+2Hx, Ny+2Hy, 1) fields uh, vh, h and the tracers, with
filled periodic halos, it computes the whole conservative-formulation
tendency of ``advection/shallow_water.py`` ``conservative_tendencies`` (WENO
transports, the gravity head ½gh², the bathymetry term g·ℑx(h)·∂x hB, a
constant-f Coriolis force on the transports, advective-form tracers) and the
stage update

    new = q + γΔt·G + ζΔt·G⁻        (ζΔt·G⁻ only when G⁻ is given)

G is one interior-shaped (nf, Nx, Ny, 1) tensor, handed on as the next
stage's G⁻; ``new`` holds padded tensors whose halo slots are left for the
next stage's wrap.

Bound on the H100: memory traffic. The function reads each field, hB and
G⁻ once and writes G and the new fields, 40-52 B per interior cell and stage
in float32; it needs about 550 floating-point operations per cell (each face
flux and each derived velocity u = uh/ℑx(h) once), which take about half as
long at the card's float32 rate. Design (``csrc/fused_shallow_water.cu``):
one thread per (component, interior cell), y fastest across threads, the
component uniform per block; each thread recomputes its two face fluxes per
axis and every velocity they select (about 1,100 operations per cell), and
reads its stencil through L1/L2.
Division is exact. Schemes: WENO(5) and Centered(2); any other scheme raises
on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..advection.shallow_water import conservative_tendencies
from ..coriolis import FPlane, constant_f
from ..grids.topology import PERIODIC
from ..timesteppers import stage_update
from . import build
from .fused_advection import coefficient_table, scheme_code
from .fused_projection import _DTYPE_CODES, _metrics, check_tensors

MAX_FIELDS = 3 + 8          # uh, vh, h and up to 8 tracers
PROGNOSTIC = ("uh", "vh", "h")


def sw_eligible(grid, formulation="conservative", coriolis=None):
    """Whether a shallow-water configuration runs the fused stage: a regular
    grid, the conservative formulation, a flat z, periodic x and y, and no
    rotation or a constant f. The model also requires no closure, forcing or
    user boundary conditions."""
    return (getattr(grid, "all_regular", False)
            and formulation == "conservative"
            and grid.is_flat(2)
            and not grid.is_flat(0) and not grid.is_flat(1)
            and grid.topology[0] == PERIODIC and grid.topology[1] == PERIODIC
            and constant_f(coriolis) is not None)


def fused_sw_update_plain(grid, scheme, g, f, hB, names, fields, Gm,
                          gamma_dt, zeta_dt):
    """Plain PyTorch version: ``conservative_tendencies`` on the padded
    tensors, the interiors stacked, then the stage update."""
    names = tuple(names)
    if fields[names[0]].is_cuda:
        fused_sw_update_plain.cuda_calls += 1
    coriolis = FPlane(f=f) if f else None
    Gd = conservative_tendencies(grid, scheme, g, coriolis, hB, names[3:],
                                 fields)
    ints = grid.interior_slices
    G = torch.stack([Gd[n][ints] for n in names])
    return G, stage_update(grid, names, fields, G, Gm, gamma_dt, zeta_dt)


fused_sw_update_plain.cuda_calls = 0


def fused_sw_update(grid, scheme, g, f, hB, names, fields, Gm, gamma_dt,
                    zeta_dt):
    """One shallow-water RK3 stage. ``names`` orders the fields (uh, vh, h,
    then the tracers); ``fields`` maps each name to its padded tensor with
    filled halos; ``hB`` is the padded bathymetry with filled halos; ``g``
    the gravitational acceleration and ``f`` the constant Coriolis parameter
    (0 for none). ``Gm`` is the previous stage's G, or None on the first
    stage. Scalars are values in the field dtype. Returns ``(G, new)``. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    names = tuple(names)
    q = [fields[n] for n in names]
    if q[0].device.type == "cpu":
        return fused_sw_update_plain(grid, scheme, g, f, hB, names, fields,
                                     Gm, gamma_dt, zeta_dt)
    code = scheme_code(scheme)
    if not sw_eligible(grid):
        raise ValueError("the fused shallow-water stage takes a regular grid "
                         "with periodic x/y and a flat z")
    nf = len(names)
    if names[:3] != PROGNOSTIC or not 3 <= nf <= MAX_FIELDS:
        raise ValueError(f"the fused shallow-water stage takes uh, vh, h and "
                         f"at most {MAX_FIELDS - 3} tracers, in that order")
    req = scheme.required_halo + 1
    if min(grid.H[0], grid.H[1]) < req:
        raise ValueError(f"the kernel needs Hx, Hy >= {req}")
    check_tensors(grid, q + [hB], grid.padded_shape)
    Nx, Ny, _ = grid.N
    if Gm is not None:
        check_tensors(grid, [Gm], (nf, Nx, Ny, 1))
        if Gm.device != q[0].device:
            raise ValueError("Gm must be on the fields' device")
    sdt = getattr(scheme, "smoothness_dtype", q[0].dtype)
    if sdt not in _DTYPE_CODES:
        raise TypeError(f"unsupported smoothness dtype {sdt}")
    table = coefficient_table(scheme)
    m = _metrics(grid)
    G = torch.empty((nf, Nx, Ny, 1), dtype=q[0].dtype, device=q[0].device)
    outs = [torch.empty_like(a) for a in q]
    ins = (ctypes.c_void_p * nf)(*[a.data_ptr() for a in q])
    news = (ctypes.c_void_p * nf)(*[a.data_ptr() for a in outs])
    with torch.cuda.device(G.device):
        lib = build.library()
        build.check(lib.oc_fused_sw_update(
            code, _DTYPE_CODES[G.dtype], _DTYPE_CODES[sdt], ins, news, nf,
            build.ptr(hB), build.ptr(Gm), build.ptr(G), Nx, Ny, grid.H[0],
            grid.H[1], m["dx"], m["dy"], m["Ax"], m["Ay"], m["Az"], m["V"],
            float(g), float(f), float(gamma_dt),
            float(zeta_dt) if Gm is not None else 0.0, table, len(table),
            build.stream_of(G)), lib)
    fused_sw_update.launches += 1
    return G, dict(zip(names, outs))


fused_sw_update.launches = 0
