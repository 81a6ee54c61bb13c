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
with regular x and z (``LatitudeLongitudeGrid`` or a regular
``RectilinearGrid``), a bounded z with a halo, bounded or periodic x and y;
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
and T read, Gu, Gv and G_T written) take 0.045 ms at 3.35 TB/s. The
scratch below is a cost of this design, not of the function: writing and
reading it once would add 0.19 ms of traffic. Design
(``csrc/fused_vector_invariant.cu``): one call is two launches. The first writes the derived fields once per padded cell
into scratch tensors (ζ, û, v̂, the velocity-stencil operands ℑy u and ℑx v,
the ½u² and ½v² differences, ℑx u, ℑy v, δx(Ax u), δy(Ay v), or K for the
energy-conserving Bernoulli head); the second reconstructs and assembles,
one thread per output cell and component, with the metrics read from small
per-y rows. Divisions are exact.
"""

from __future__ import annotations

import ctypes

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
from .fused_projection import _DTYPE_CODES

MAX_TRACERS = 8

# Metric rows (csrc/fused_vector_invariant.cu numbers them in this order):
# (name, location) per row, each the metric's value along the padded y.
ROWS = (("dx", LOC_FCC), ("dx", LOC_CFC), ("dy", LOC_FCC), ("dy", LOC_CFC),
        ("Az", LOC_FFC), ("Az", LOC_FCC), ("Az", LOC_CFC), ("Az", LOC_CCF),
        ("Ax", LOC_FCC), ("Ay", LOC_CFC), ("V", LOC_FCC), ("V", LOC_CFC),
        ("V", LOC_CCC))     # then one more row: the Coriolis f at (f, f)

# Scratch tensors of the derive launch, in the kernel's order.
SCRATCH = ("zeta", "vhat", "uhat", "su", "sv", "du2", "dv2", "du2y", "dv2x",
           "ixu", "iyv", "dU", "dV", "K")

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


def metric_rows(grid, coriolis, dtype, device):
    """The (len(ROWS) + 1, Ny + 2Hy) metric rows in the field dtype: each
    metric of ROWS broadcast along the padded y, then f."""
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


def _needed_scratch(cfg):
    need = {"zeta"}
    if cfg["vort"] != VORT_CODES[ENERGY]:
        need |= {"vhat", "uhat"}
    if cfg["vort"] == WENO_VORT:
        need |= {"su", "sv"}
    if cfg["upw"]:
        need |= {"du2", "dv2", "du2y", "dv2x", "ixu", "iyv", "dU", "dV"}
    else:
        need |= {"K"}
    return need


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
        need = _needed_scratch(cfg)
        scratch = [torch.empty(grid.padded_shape, dtype=dt, device=dev)
                   if name in need else None for name in SCRATCH]
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
        build.check(lib.oc_fused_vi_tendency(
            _DTYPE_CODES[dt], _DTYPE_CODES[cfg["sdtype"]], in_ptrs, out_ptrs,
            ptrs(scratch), build.ptr(rows), conf,
            float(grid.dz(LOC_CCC)), float(grid.dz(LOC_CCF)),
            build.stream_of(u)), lib)
    fused_vi_tendency.launches += 1
    return Gu, Gv, dict(zip(names, Gc))


fused_vi_tendency.launches = 0
