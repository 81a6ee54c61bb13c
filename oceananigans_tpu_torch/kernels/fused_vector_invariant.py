"""The fused hydrostatic tendency: vector-invariant momentum plus tracers.

``fused_vi_tendency`` replaces the TPU kernels
``oceananigans_tpu/kernels/fused_vector_invariant.py`` ``_build_phase_call``
(via ``build_fused_hydrostatic_tendency``) and ``_build_phase_call_packed``
(via ``build_fused_hydrostatic_tendency_packed``; the packed (y, z) layout is
a view that only the TPU's 128-lane tiles need, so on the card both are this
one kernel). From padded u, v, w, the hydrostatic pressure anomaly ph (when
there is buoyancy) and the tracers, with filled halos, it returns

    Gu = -(ζ flux) - ∂x K - (vertical advection) - (f×U)ˣ - ∂x ph      (fcc)
    Gv = +(ζ flux) - ∂y K - (vertical advection) - (f×U)ʸ - ∂y ph      (cfc)
    Gc = -∇·(𝐯c)                                                       (ccc)

as padded tensors holding the interior cells and, on a bounded x (y), the
boundary-face row of u (v) in the first halo slot, which the XLA path also
evolves; every other slot is zero. The four phases of the TPU function
(vorticity, Bernoulli head, vertical, forces and tracers) are summed in the
same order.

Configurations (``vi_config``; anything else raises): a grid whose metrics do not vary along x
with regular axes (``LatitudeLongitudeGrid`` that does not reach a pole, or
a regular ``RectilinearGrid``), a bounded z with a halo, bounded or
periodic x and y;
vorticity ``ENSTROPHY``, ``ENERGY`` or WENO(5/7/9) with the velocity
stencil; vertical advection, divergence and kinetic-energy schemes all
``ENERGY`` or all WENO(5) with ``ONLY_SELF``; Coriolis None, ``FPlane`` or
``HydrostaticSphericalCoriolis`` (either scheme); ``Centered(2)`` or WENO(5)
tracers, at most 8; float32 or float64. Every WENO of a configuration shares
one smoothness dtype.

Bound on the H100: operations. For the hydro_row configuration at
512x256x32 the function needs about 1,800 floating-point operations per cell
(each derived field, face flux and reconstruction once; ``chip_smoke.py``
counts them), 0.114 ms at the float32 rate; its compulsory bytes (u, v, w
and T read, Gu, Gv and G_T written) take 0.045 ms at 3.35 TB/s. Design
(``csrc/fused_vector_invariant.cu``): one launch, one block per tile of
output cells, and no scratch tensor. The block stages u and v over the tile
plus the stencils' reach, and the tile's metric rows, into shared memory,
then forms each phase's derived fields (ζ and the velocity-stencil
operands; the ½u² and ½v² differences and ℑx u, ℑy v, or K; δx(Ax u) and
δy(Ay v)) once into a shared buffer that the next phase reuses, each z face
flux of the vertical advection and each tracer face flux once, and sums the
phases per cell in the TPU function's order. ``launch_plan`` gives the
tile, the block count and the shared memory; the C entry checks them.
Divisions are exact.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..advection.reconstruction import (eno_coefficients, optimal_weights,
                                        smoothness_factors)
from ..advection.schemes import (TAU_COEFFS, WENO_EPSILON, WENO_R_MAX,
                                 Centered, WENO)
from ..advection.vector_invariant import (ENERGY, ENSTROPHY, ONLY_SELF,
                                          VELOCITY_STENCIL, VectorInvariant)
from ..advection.fluxes import div_Uc
from ..coriolis import FPlane, HydrostaticSphericalCoriolis
from ..grids.topology import (BOUNDED, FLAT, LOC_CCC, LOC_CCF, LOC_CFC,
                              LOC_FCC)
from ..operators.operators import LOC_FFC, ddx, ddy
from . import build
from .fused_advection import _align
from .fused_projection import _DTYPE_CODES

MAX_TRACERS = 8

# Metric rows (csrc/fused_vector_invariant.cu numbers them in this order):
# (name, location) per row, each the metric's value along the padded y.
ROWS = (("dx", LOC_FCC), ("dx", LOC_CFC), ("dy", LOC_FCC), ("dy", LOC_CFC),
        ("Az", LOC_FFC), ("Az", LOC_FCC), ("Az", LOC_CFC), ("Az", LOC_CCF),
        ("Ax", LOC_FCC), ("Ay", LOC_CFC), ("V", LOC_FCC), ("V", LOC_CFC),
        ("V", LOC_CCC))     # then one more row: the Coriolis f at (f, f)

VORT_CODES = {ENSTROPHY: 0, ENERGY: 1}
WENO_VORT = 2


def _weno_order(s):
    return s.order if isinstance(s, WENO) else None


COVERAGE_ITEM = ("ROADMAP.md queue 1 item 13 (hydrostatic: the fused VI "
                 "kernel's coverage)")


def _uncovered(why):
    return NotImplementedError(
        "not covered by the fused VI kernel: " + ", ".join(why)
        + f"; fused_tendencies=False takes the plain path: {COVERAGE_ITEM}")


def vi_config(grid, vi, tracer_scheme, n_tracers, coriolis):
    """The kernel's configuration codes, or raise ``NotImplementedError``
    naming what the kernel does not cover."""
    from ..grids.latlon import LatitudeLongitudeGrid
    from ..grids.rectilinear import RectilinearGrid
    why = []
    if not isinstance(grid, (LatitudeLongitudeGrid, RectilinearGrid)):
        why.append(f"grid type {type(grid).__name__}")
    if getattr(grid, "polar_south", False) or getattr(grid, "polar_north",
                                                      False):
        why.append("a latitude range that ends at a pole (polar caps)")
    if getattr(grid, "stretched_axes", ()):
        why.append("stretched axes")
    if grid.topology[2] != BOUNDED or grid.H[2] < 1:
        why.append("z must be bounded with a halo")
    if FLAT in grid.topology[:2]:
        why.append("flat x or y")
    if not isinstance(vi, VectorInvariant):
        why.append("momentum advection must be a VectorInvariant")
        raise _uncovered(why)
    smooth = set()
    vs = vi.vorticity_scheme
    if vs in VORT_CODES:
        vort, kv = VORT_CODES[vs], 0
    elif _weno_order(vs) in (5, 7, 9) and \
            vi.vorticity_stencil == VELOCITY_STENCIL:
        vort, kv = WENO_VORT, vs.buffer
        smooth.add(vs.smoothness_dtype)
    else:
        why.append(f"vorticity scheme {vs!r} with stencil "
                   f"{vi.vorticity_stencil!r}")
        vort = kv = None
    others = (vi.vertical_advection_scheme, vi.divergence_scheme,
              vi.kinetic_energy_gradient_scheme)
    if all(s == ENERGY for s in others):
        upw = 0
    elif all(_weno_order(s) == 5 for s in others) \
            and vi.upwinding == ONLY_SELF:
        upw = 1
        smooth.update(s.smoothness_dtype for s in others)
    else:
        why.append("vertical, divergence and kinetic-energy schemes must be "
                   "all ENERGY or all WENO(5) with ONLY_SELF")
        upw = None
    if isinstance(tracer_scheme, Centered) and tracer_scheme.order == 2:
        tsch = 0
    elif _weno_order(tracer_scheme) == 5:
        tsch = 1
        smooth.add(tracer_scheme.smoothness_dtype)
    else:
        why.append(f"tracer scheme {tracer_scheme!r}")
        tsch = None
    if n_tracers > MAX_TRACERS:
        why.append(f"more than {MAX_TRACERS} tracers")
    if coriolis is None:
        cor = 0
    elif isinstance(coriolis, FPlane):
        cor = 1
    elif isinstance(coriolis, HydrostaticSphericalCoriolis) and isinstance(
            grid, LatitudeLongitudeGrid):
        cor = 2 if coriolis.scheme == "energy_conserving" else 3
    else:
        why.append(f"Coriolis {coriolis!r}")
        cor = None
    if len(smooth) > 1:
        why.append("the WENO schemes differ in smoothness dtype")
    elif smooth and not smooth <= set(_DTYPE_CODES):
        why.append(f"smoothness dtype {next(iter(smooth))}")
    if grid.dtype not in _DTYPE_CODES:
        why.append(f"dtype {grid.dtype}")
    if why:
        raise _uncovered(why)
    sdt = smooth.pop() if smooth else grid.dtype
    return dict(vort=vort, kv=kv, upw=upw, cor=cor, tsch=tsch, sdtype=sdt)


def kept_slices(grid):
    """(Gu, Gv, Gc) regions the function writes: the interiors, plus the
    boundary-face row of u on a bounded x and of v on a bounded y."""
    (Hx, Hy, Hz), (Nx, Ny, Nz) = grid.H, grid.N
    bx = int(grid.topology[0] == BOUNDED)
    by = int(grid.topology[1] == BOUNDED)
    z = slice(Hz, Hz + Nz)
    return ((slice(Hx, Hx + Nx + bx), slice(Hy, Hy + Ny), z),
            (slice(Hx, Hx + Nx), slice(Hy, Hy + Ny + by), z),
            grid.interior_slices)


def _keep(a, sl):
    out = torch.zeros_like(a)
    out[sl] = a[sl]
    return out


def fused_vi_tendency_plain(grid, vi, tracer_scheme, names, coriolis, u, v,
                            w, tracers, ph=None):
    """Plain PyTorch version: the TPU function's four phase bodies with the
    port's operators on whole padded tensors, cut to the kept regions."""
    if u.is_cuda:
        fused_vi_tendency_plain.cuda_calls += 1
    h_u, h_v = vi._horizontal(grid, u, v)
    b_u, b_v = vi._bernoulli(grid, u, v)
    z_u, z_v = vi._vertical(grid, u, v, w)
    f_u = f_v = None
    if coriolis is not None:
        f_u = -coriolis.x_f_cross_U(grid, u, v, w)
        f_v = -coriolis.y_f_cross_U(grid, u, v, w)
    if ph is not None:
        p_u, p_v = -ddx(grid, ph, LOC_FCC), -ddy(grid, ph, LOC_CFC)
        f_u = p_u if f_u is None else f_u + p_u
        f_v = p_v if f_v is None else f_v + p_v
    Gu = (-h_u + -b_u) + -z_u
    Gv = (-h_v + -b_v) + -z_v
    if f_u is not None:
        Gu, Gv = Gu + f_u, Gv + f_v
    su, sv, sc = kept_slices(grid)
    Gc = {n: _keep(-div_Uc(grid, tracer_scheme, u, v, w, tracers[n]), sc)
          for n in names}
    return _keep(Gu, su), _keep(Gv, sv), Gc


fused_vi_tendency_plain.cuda_calls = 0


# -- the kernel ------------------------------------------------------------------

def coefficient_table():
    """The kernel's constant table (float64, csrc's ``VITab`` order): for
    WENO buffers k = 2..5 the stencil coefficients, smoothness factors
    (|c| < 1e-14 set to 0, as the plain version skips them), optimal weights
    and τ coefficients, zero-padded to 5; then Centered(4), Centered(2), ε
    and the saturation of τ/(β+ε)."""
    coef = np.zeros((4, 5, 5))
    fac = np.zeros((4, 5, 5, 5))
    gam = np.zeros((4, 5))
    tau = np.zeros((4, 5))
    for k in range(2, 6):
        for s in range(k):
            coef[k - 2, s, :k] = eno_coefficients(k, s)
            for m, f in enumerate(smoothness_factors(k, s)):
                f = np.asarray(f)
                fac[k - 2, s, m, :k] = np.where(np.abs(f) < 1e-14, 0.0, f)
        gam[k - 2, :k] = optimal_weights(k)
        tau[k - 2, :k] = TAU_COEFFS[k]
    return np.concatenate([coef.ravel(), fac.ravel(), gam.ravel(),
                           tau.ravel(), eno_coefficients(4, 1),
                           eno_coefficients(2, 0),
                           [WENO_EPSILON, WENO_R_MAX]])


TABLE_SIZE = 100 + 500 + 20 + 20 + 4 + 2 + 2
_tables_on = set()          # devices whose constant tables are set


@functools.lru_cache(maxsize=16)
def metric_rows(grid, coriolis, dtype, device):
    """The (len(ROWS) + 1, Ny + 2Hy) metric rows in the field dtype: each
    metric of ROWS broadcast along the padded y, then f. Built once per
    grid, Coriolis, dtype and device (grids and Coriolis objects compare by
    value), since building them copies host arrays to the card."""
    NYP = grid.padded_shape[1]

    def row(m):
        t = torch.as_tensor(m, dtype=dtype, device=device)
        return t.reshape(-1).expand(NYP) if t.numel() == 1 else t.reshape(-1)

    rows = [row(getattr(grid, name)(loc)) for name, loc in ROWS]
    if isinstance(coriolis, HydrostaticSphericalCoriolis):
        rows.append(row(coriolis.f_ffc_numpy(grid)))
    else:
        rows.append(row(coriolis.f if isinstance(coriolis, FPlane) else 0.0))
    return torch.stack(rows).contiguous()


# Threads a block and the tile of output cells a block owns, by the fields'
# element size: at float32 a 16 x 8 x 8 tile takes 98.9 KB of shared memory
# with the WENO-9 vorticity's reach (two blocks an SM), at float64 an
# 8 x 8 x 8 tile 138.4 KB.
THREADS = 256
TILES = {4: (16, 8, 8), 8: (8, 8, 8)}
# z reach of the vertical and tracer reconstructions and horizontal reach of
# a tracer box (csrc/fused_vector_invariant.cu kRz, kRc)
RZ = RC = 3


def reach(cfg):
    """The box's reach along x and y: the WENO vorticity buffer or WENO-5's
    3, and one more for the derived fields' own stencils."""
    kv = cfg["kv"] if cfg["vort"] == WENO_VORT else 0
    return max(kv, 3) + 1


def smem_bytes(tile, R, esize):
    """Dynamic shared memory of one block (csrc/fused_vector_invariant.cu
    Layout): u and v over the tile plus the reach R, two per-cell sums, the
    metric rows over the box's y, and a work buffer large enough for each
    phase in turn (three derived fields; w, the z face fluxes of u and v and
    two columns or two derived fields; w and ph; w, a tracer box and its
    fluxes)."""
    TX, TY, TZ = tile
    BY = TY + 2 * R
    box = _align((TX + 2 * R) * BY * TZ)
    wsz = _align((TX + 3) * (TY + 3) * (TZ + 1))
    col = _align(TX * TY * (TZ + 2 * RZ))
    fz = _align(TX * TY * (TZ + 1))
    phb = _align((TX + 1) * (TY + 1) * TZ)
    tb = _align((TX + 2 * RC) * (TY + 2 * RC) * (TZ + 2 * RZ))
    tfx = _align((TX + 1) * TY * TZ)
    tfy = _align(TX * (TY + 1) * TZ)
    rows = len(ROWS) + 1           # the metric rows and f
    persistent = 2 * box + 2 * _align(TX * TY * TZ) + _align(rows * BY)
    work = max(3 * box, wsz + 2 * fz + 2 * max(col, box), wsz + phb,
               wsz + tb + tfx + tfy + fz)
    return esize * (persistent + work)


def launch_plan(grid, cfg, dtype):
    """The launch of ``fused_vi_tendency`` for configuration ``cfg``
    (``vi_config``) with fields of ``dtype`` on ``grid``: a dict with
    ``tile`` (TX, TY, TZ), ``tiles`` (along x, y and z over the output
    region of Nx + bx by Ny + by by Nz cells, bx and by 1 on a bounded axis;
    block n owns tile (tx, ty, tz) with n = (tx·tiles_y + ty)·tiles_z + tz,
    cells [TX·tx, min(TX·(tx + 1), Nx + bx)) and likewise along y and z),
    ``blocks``, ``threads``, ``reach`` and ``smem`` (bytes)."""
    esize = torch.empty((), dtype=dtype).element_size()
    tile = TILES[esize]
    (Nx, Ny, Nz) = grid.N
    bx = int(grid.topology[0] == BOUNDED)
    by = int(grid.topology[1] == BOUNDED)
    tiles = tuple(-(-n // t) for n, t in zip((Nx + bx, Ny + by, Nz), tile))
    R = reach(cfg)
    return dict(tile=tile, tiles=tiles, blocks=tiles[0] * tiles[1] * tiles[2],
                threads=THREADS, reach=R, smem=smem_bytes(tile, R, esize))


def fused_vi_tendency(grid, vi, tracer_scheme, names, coriolis, u, v, w,
                      tracers, ph=None):
    """The hydrostatic tendency ``(Gu, Gv, {name: Gc})`` of padded u, v, w,
    ``tracers`` ({name: padded tensor}, in the order of ``names``) and
    ``ph`` (None without buoyancy), all with filled halos. CPU tensors take
    the plain version; CUDA tensors launch the kernel, or raise for a
    configuration it does not cover."""
    names = tuple(names)
    if u.device.type == "cpu":
        return fused_vi_tendency_plain(grid, vi, tracer_scheme, names,
                                       coriolis, u, v, w, tracers, ph)
    cfg = vi_config(grid, vi, tracer_scheme, len(names), coriolis)
    ins = [u, v, w] + ([ph] if ph is not None else []) + \
        [tracers[n] for n in names]
    from .fused_projection import check_tensors
    check_tensors(grid, ins, grid.padded_shape)
    dev, dt = u.device, u.dtype
    with torch.cuda.device(dev):
        lib = build.library()
        if dev not in _tables_on:
            table = coefficient_table()
            build.check(lib.oc_vi_set_tables(
                table.ctypes.data_as(ctypes.c_void_p), len(table)), lib)
            _tables_on.add(dev)
        rows = metric_rows(grid, coriolis, dt, dev)
        Gu, Gv = torch.zeros_like(u), torch.zeros_like(v)
        Gc = [torch.zeros_like(u) for _ in names]
        ptrs = lambda ts: (ctypes.c_void_p * len(ts))(
            *[t.data_ptr() if t is not None else None for t in ts])
        in_ptrs = ptrs([u, v, w, ph] + [tracers[n] for n in names])
        out_ptrs = ptrs([Gu, Gv] + Gc)
        (Nx, Ny, Nz), (Hx, Hy, Hz) = grid.N, grid.H
        conf = (ctypes.c_int * 15)(
            Nx, Ny, Nz, Hx, Hy, Hz, int(grid.topology[0] == BOUNDED),
            int(grid.topology[1] == BOUNDED), cfg["vort"], cfg["kv"],
            cfg["upw"], cfg["cor"], cfg["tsch"], len(names),
            int(ph is not None))
        plan = launch_plan(grid, cfg, dt)
        build.check(lib.oc_fused_vi_tendency(
            _DTYPE_CODES[dt], _DTYPE_CODES[cfg["sdtype"]], in_ptrs, out_ptrs,
            build.ptr(rows), conf, float(grid.dz(LOC_CCF)), *plan["tile"],
            plan["threads"], plan["blocks"], plan["smem"],
            build.stream_of(u)), lib)
    fused_vi_tendency.launches += 1
    return Gu, Gv, dict(zip(names, Gc))


fused_vi_tendency.launches = 0
