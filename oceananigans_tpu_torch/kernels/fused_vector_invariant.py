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

Configurations (``vi_config``) are those the JAX kernel's
``eligible_hydrostatic`` takes on a ``LatitudeLongitudeGrid`` or a
``RectilinearGrid``: any ``VectorInvariant`` (the vorticity ENSTROPHY, ENERGY
or a scheme in either stencil; vertical, divergence and kinetic-energy
schemes each ENERGY or a scheme; ``ONLY_SELF`` or ``CROSS_AND_SELF``), any
tracer scheme and count, every Coriolis of ``coriolis.py`` (None, FPlane,
BetaPlane, ConstantCartesianCoriolis, NonTraditionalBetaPlane,
HydrostaticSphericalCoriolis in both schemes), stretched y and z, and the
multi-dimensional stencil (each filtered reconstruction formed over the tile
plus 2 along its filter's axis, then the 5-point centred WENO filter,
``md_filter``; two more cells of box reach). A
scheme is Centered(2-12), UpwindBiased(1-11), WENO(3-11) or a per-axis
``FluxFormAdvection`` of them; each reconstruction and symmetric
interpolation is a *site* (``SITES``) holding its family and buffer. The
fields are float32 or float64; every WENO shares one smoothness dtype
(float32, float64, or bfloat16 with float32 fields). Refused, naming
ROADMAP item 13, is what JAX refuses (an immersed grid, another grid type
(a z* moving grid among them), metrics that vary along x, a stretched x,
polar caps, a flat axis, the z-compact layout, per-tracer schemes). The
model keeps from the kernel what JAX's explicit fused path refuses
(``HydrostaticFreeSurfaceModel._unfused``).

Bound on the H100: operations (``chip_smoke.py`` ``vi_flop`` counts each
derived field, face flux and reconstruction once, by scheme, buffer and
tracer count; for the hydro_row configuration at 512x256x32 about 1,800 a
cell, 0.114 ms at the float32 rate, against 0.045 ms for its compulsory
bytes at 3.35 TB/s). Design (``csrc/vi_kernel.cuh``): one launch per 32
tracers (the first also forms Gu and Gv), one block per tile of output
cells, and no scratch tensor. The block stages u and v over the tile plus
the stencils' reach, the tile's metric rows (y rows; on a stretched z the
rows of V, Ax and Ay hold their horizontal factor and a z column of Δz
multiplies them) and, along a stretched y or z, the per-slot ENO
coefficients of its sites (``coefficient_rows``), into shared memory, then
forms each phase's derived fields once into a shared buffer that the next
phase reuses, each z face flux of the vertical advection and each tracer
face flux once, and sums the phases per cell in the TPU function's order.
A uniform axis reads its coefficients from the constant table
(``coefficient_table``). ``launch_plan`` gives the tile (by the reach, as
#1's ``pick_tile``), the block count and the shared memory; the C entry
checks them. Divisions are exact.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..advection.fluxes import div_Uc, div_Uu, div_Uv
from ..advection.reconstruction import (eno_coefficients, optimal_weights,
                                        smoothness_factors, typed_constants)
from ..advection.schemes import (TAU_COEFFS, WENO_EPSILON, WENO_R_MAX,
                                 AdvectionScheme, Centered,
                                 FluxFormAdvection, UpwindBiased, WENO,
                                 _is_stretched, _nonuniform_eno_np,
                                 _padded_faces, shard_cut)
from ..advection.vector_invariant import (CROSS_AND_SELF, ENERGY, ENSTROPHY,
                                          VELOCITY_STENCIL, VectorInvariant)
from ..coriolis import (BetaPlane, ConstantCartesianCoriolis, FPlane,
                        HydrostaticSphericalCoriolis, NonTraditionalBetaPlane)
from ..grids.base import numpy_metric
from ..grids.topology import (BOUNDED, FLAT, LOC_CCC, LOC_CCF, LOC_CFC,
                              LOC_FCC, global_extent, wall_sides)
from ..operators.operators import LOC_FFC, ddx, ddy
from . import build
from .fused_advection import (BOUNDED_WENO_FAMILY, CENTERED, MAX_SMEM,
                              SM_SMEM, SMEM_RESERVED, UPWIND, WENO_FAMILY,
                              _SMOOTHNESS_CODES, _align, scheme_code)
from .fused_projection import _DTYPE_CODES

# Tracers one launch takes (csrc/vi_kernel.cuh kBatch); a call with more
# launches once per 32, the first launch also forming Gu and Gv.
TRACER_BATCH = 32

# Metric rows (csrc/vi_kernel.cuh Row numbers them in this order): (name,
# location) per row, each the metric's value along the padded y; on a
# stretched z the rows of Z_FACTORED hold the factor before the z column Δz
# (at centres) that multiplies them. Then the Coriolis rows: f at y centres
# and y faces (a plane's, or the sphere's at the (f, f) nodes), and the
# non-traditional β-plane's γy at centres, βy at centres and at faces.
ROWS = (("dx", LOC_FCC), ("dx", LOC_CFC), ("dy", LOC_FCC), ("dy", LOC_CFC),
        ("Az", LOC_FFC), ("Az", LOC_FCC), ("Az", LOC_CFC), ("Az", LOC_CCF),
        ("Ax", LOC_FCC), ("Ay", LOC_CFC), ("V", LOC_FCC), ("V", LOC_CFC),
        ("V", LOC_CCC))
Z_FACTORED = {("Ax", LOC_FCC): ("dy", LOC_FCC), ("Ay", LOC_CFC): ("dx", LOC_CFC),
              ("V", LOC_FCC): ("Az", LOC_FCC), ("V", LOC_CFC): ("Az", LOC_CFC),
              ("V", LOC_CCC): ("Az", LOC_CCC)}
N_CORIOLIS_ROWS = 5
N_ROWS = len(ROWS) + N_CORIOLIS_ROWS
# z columns (csrc ZCol): Δz at centres and at faces, the non-traditional
# β-plane's fy(1 − z/R) and fz(1 + 2z/R) at centres
N_ZCOLS = 4

# Reconstruction and interpolation sites (csrc Site), each (axis, β, kind):
# the ζ reconstruction of v (along x) and u (along y); the self-upwinded
# kinetic-energy gradient of u (x) and v (y) and its cross interpolation
# δx(v²/2) → fcc... (``kc``); the vertical reconstruction of u and v; the
# vertical scheme's interpolation of Az·w along x and y (``vs``); the
# divergence flux's reconstruction along x and y and its cross
# interpolation (``dc``); the tracer faces along x, y and z.
SITES = ("vort_x", "vort_y", "ke_x", "ke_y", "kc_x", "kc_y", "vz", "vs_x",
         "vs_y", "div_x", "div_y", "dc_x", "dc_y", "t_x", "t_y", "t_z")
SITE_AXIS = dict(zip(SITES, (0, 1, 0, 1, 0, 1, 2, 0, 1, 0, 1, 0, 1, 0, 1, 2)))
SITE_BETA = dict(zip(SITES, (1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)))
SYM_SITES = ("kc_x", "kc_y", "vs_x", "vs_y", "dc_x", "dc_y")

# Vorticity and smoothness codes (csrc): ENSTROPHY, ENERGY or a scheme; the
# WENO smoothness of the reconstructed line itself or of the velocity
# stencil's two lines.
VORT_CODES = {ENSTROPHY: 0, ENERGY: 1}
VORT_SCHEME = 2
SMOOTH_SELF, SMOOTH_TWO = 0, 2

# Coriolis codes (csrc): none; a plane f(y) (FPlane, BetaPlane); the sphere's
# energy- and enstrophy-conserving forms; a constant Cartesian rotation; the
# non-traditional β-plane.
COR_NONE, COR_PLANE, COR_SPHERE_ENERGY, COR_SPHERE_ENSTROPHY, \
    COR_CARTESIAN, COR_NONTRADITIONAL = range(6)

# The floor of every box reach (WENO-5's), so that the configurations the
# kernel took before its coverage grew keep their boxes and tiles.
MIN_REACH = 3

COVERAGE_ITEM = ("ROADMAP.md queue 1 item 13 (hydrostatic: the fused VI "
                 "kernel's coverage)")


def _uncovered(why):
    return NotImplementedError(
        "not covered by the fused VI kernel: " + ", ".join(why)
        + f"; fused_tendencies=False takes the plain path: {COVERAGE_ITEM}")


def _on_axis(scheme, axis):
    """The scheme a reconstruction along ``axis`` takes (a per-axis
    FluxFormAdvection's own)."""
    return scheme.schemes[axis] if isinstance(scheme, FluxFormAdvection) \
        else scheme


def _metrics_x_invariant(grid):
    """True when no metric varies along x (JAX's ``_metrics_x_invariant``)."""
    locs = (LOC_CCC, LOC_FCC, LOC_CFC, LOC_CCF, LOC_FFC)
    for loc in locs:
        for name in ("dx", "dy", "dz", "Az"):
            m = np.asarray(numpy_metric(grid, name, loc))
            if m.ndim == 3 and m.shape[0] != 1:
                return False
    return True


def sym_buffer(code):
    """The Centered(2b) buffer b of a symmetric site's top level: the
    scheme's own for Centered, its advecting velocity's (max(K − 1, 1)) for
    UpwindBiased and WENO."""
    fam, K = code
    return K if fam == CENTERED else max(K - 1, 1)


def vi_config(grid, vi, tracer_scheme, n_tracers, coriolis):
    """The kernel's configuration, or raise ``NotImplementedError`` naming
    what it does not cover. A dict: ``vort`` (VORT_CODES or VORT_SCHEME),
    ``vort_sm``, ``ke`` and ``vert`` (0 the energy forms, 1 a scheme),
    ``upw`` (1 for CROSS_AND_SELF), ``cor``, ``cor_f`` (the Cartesian (fx,
    fy, fz)), ``sites`` ({site: (family, buffer)} of the sites the
    configuration uses), ``tracers`` (False without tracer advection),
    ``sdtype``, ``KM`` (the buffer the kernel is instantiated for: the
    deepest site's, at least MIN_REACH), the box
    reaches ``R``, ``Rw``, ``Rz``, ``Rc`` and the stretched axes ``ys``,
    ``zs``."""
    from ..grids.latlon import LatitudeLongitudeGrid
    from ..grids.rectilinear import RectilinearGrid
    why = []
    if not isinstance(grid, (LatitudeLongitudeGrid, RectilinearGrid)):
        why.append(f"grid type {type(grid).__name__}")
        raise _uncovered(why)
    if getattr(grid, "polar_south", False) or getattr(grid, "polar_north",
                                                      False):
        why.append("a latitude range that ends at a pole (polar caps)")
    if FLAT in grid.topology:
        why.append("a flat axis")
    elif grid.topology[2] != BOUNDED or grid.H[2] < 1:
        why.append("z must be bounded with a halo (not the z-compact layout)")
    if grid.topology[0] != FLAT and not grid.regular(0):
        why.append("a stretched x")
    if not why and not _metrics_x_invariant(grid):
        why.append("metrics that vary along x")
    if not isinstance(vi, VectorInvariant):
        why.append("momentum advection must be a VectorInvariant")
        raise _uncovered(why)
    if grid.dtype not in _DTYPE_CODES:
        why.append(f"dtype {grid.dtype}")
    if isinstance(tracer_scheme, dict):
        why.append("per-tracer advection schemes")
        raise _uncovered(why)
    sites = {}
    smooth = set()

    def code(site, scheme, smoothing=True):
        try:
            # #10 takes one scheme a site: a FluxFormAdvection's axes differ
            c = (None if isinstance(scheme, FluxFormAdvection)
                 else scheme_code(scheme))
        except NotImplementedError:
            c = None
        if c is None or c[0] == BOUNDED_WENO_FAMILY:
            # #10 has no bounds-preserving limiter (ROADMAP.md queue 2)
            why.append(f"scheme {scheme!r} at {site}")
            return
        sites[site] = c
        if smoothing and c[0] == WENO_FAMILY:
            smooth.add(scheme.smoothness_dtype)

    def sym_scheme(s):
        return s if isinstance(s, AdvectionScheme) else Centered(2)

    vs = vi.vorticity_scheme
    vort_sm = SMOOTH_SELF
    if vs in VORT_CODES:
        vort = VORT_CODES[vs]
    else:
        vort = VORT_SCHEME
        if isinstance(vs, WENO) and vi.vorticity_stencil == VELOCITY_STENCIL:
            vort_sm = SMOOTH_TWO
        code("vort_x", _on_axis(vs, 0))
        code("vort_y", _on_axis(vs, 1))
    ds = vi.divergence_scheme
    cross = vi.upwinding_cross_scheme
    ks = vi.kinetic_energy_gradient_scheme
    ke = int(isinstance(ks, AdvectionScheme))
    if ke:
        code("ke_x", _on_axis(ks, 0))
        code("ke_y", _on_axis(ks, 1))
        code("kc_x", sym_scheme(_on_axis(cross, 0)), False)
        code("kc_y", sym_scheme(_on_axis(cross, 1)), False)
    vas = vi.vertical_advection_scheme
    vert = int(isinstance(vas, AdvectionScheme))
    upw = int(vi.upwinding == CROSS_AND_SELF)
    if vert:
        code("vz", _on_axis(vas, 2))
        code("vs_x", _on_axis(vas, 0), False)
        code("vs_y", _on_axis(vas, 1), False)
        if not isinstance(ds, AdvectionScheme):
            why.append("a vertical scheme without a divergence scheme "
                       "(the plain VI needs one too)")
        else:
            code("div_x", _on_axis(ds, 0))
            code("div_y", _on_axis(ds, 1))
            if not upw:
                code("dc_x", sym_scheme(_on_axis(cross, 0)), False)
                code("dc_y", sym_scheme(_on_axis(cross, 1)), False)
    tracers = tracer_scheme is not None and n_tracers > 0
    if tracers:
        for site, axis in (("t_x", 0), ("t_y", 1), ("t_z", 2)):
            code(site, _on_axis(tracer_scheme, axis))
    cor_f = (0.0, 0.0, 0.0)
    if coriolis is None:
        cor = COR_NONE
    elif isinstance(coriolis, (FPlane, BetaPlane)):
        cor = COR_PLANE
    elif isinstance(coriolis, HydrostaticSphericalCoriolis):
        cor = (COR_SPHERE_ENERGY if coriolis.scheme == "energy_conserving"
               else COR_SPHERE_ENSTROPHY)
    elif isinstance(coriolis, ConstantCartesianCoriolis):
        cor = COR_CARTESIAN
        cor_f = (coriolis.fx, coriolis.fy, coriolis.fz)
    elif isinstance(coriolis, NonTraditionalBetaPlane):
        cor = COR_NONTRADITIONAL
    else:
        why.append(f"Coriolis {coriolis!r}")
        cor = None
    if len(smooth) > 1:
        why.append("the WENO schemes differ in smoothness dtype")
    elif smooth:
        sdt = next(iter(smooth))
        if sdt not in _SMOOTHNESS_CODES:
            why.append(f"smoothness dtype {sdt}")
        elif sdt == torch.bfloat16 and grid.dtype != torch.float32:
            why.append("bfloat16 smoothness with fields other than float32")
        elif vi.multi_dimensional_stencil and sdt not in (grid.dtype,
                                                           torch.bfloat16):
            why.append("the multi-dimensional stencil with a smoothness "
                       "dtype other than the fields' or bfloat16")
    if why:
        raise _uncovered(why)
    sdt = smooth.pop() if smooth else grid.dtype

    def K(*names):
        return max([sites[n][1] for n in names if n in sites] + [MIN_REACH])

    # the multi-dimensional stencil filters each horizontal reconstruction
    # over ±2 cells along the other horizontal axis: two more cells of box
    md = int(vi.multi_dimensional_stencil)
    R = K("vort_x", "vort_y", "ke_x", "ke_y", "kc_x", "kc_y", "div_x",
          "div_y", "dc_x", "dc_y") + 1 + 2 * md
    Rw = max([sym_buffer(sites[n]) for n in ("vs_x", "vs_y") if n in sites]
             + [2])
    return dict(vort=vort, vort_sm=vort_sm, ke=ke, vert=vert, upw=upw, md=md,
                cor=cor, cor_f=cor_f, sites=sites, tracers=tracers,
                sdtype=sdt, KM=K(*sites), R=R, Rw=Rw, Rz=K("vz", "t_z"),
                Rc=K("t_x", "t_y"), ys=_is_stretched(grid, 1),
                zs=_is_stretched(grid, 2))


def variant_name(cfg):
    """The kernel variant of a configuration: ``k`` and the buffer it is
    instantiated for, then ``_y`` / ``_z`` for a stretched y / z, ``_bf16``
    for bfloat16 smoothness and ``_md`` for the multi-dimensional stencil's
    family (``k5``, ``k5_z``, ``k6_y_z``, ``k5_md``)."""
    return (f"k{cfg['KM']}" + ("_y" if cfg["ys"] else "")
            + ("_z" if cfg["zs"] else "")
            + ("_bf16" if cfg["sdtype"] == torch.bfloat16 else "")
            + ("_md" if cfg["md"] else ""))


def high_walls(grid):
    """(bx, by): 1 where the high x (y) side is a wall, whose boundary-face
    row of u (v) the function writes: a bounded axis's, but on a shard's
    grid only the global grid's own wall (``wall_sides``)."""
    return tuple(int(wall_sides(grid, ax)[1]) for ax in (0, 1))


def cascade_geometry(grid):
    """Per horizontal axis (bounded, H - offset, global N): the near-wall
    cascade counts from the global walls (``global_extent``)."""
    out = []
    for ax in (0, 1):
        offset, n = global_extent(grid, ax)
        out.append((int(grid.topology[ax] == BOUNDED), grid.H[ax] - offset,
                    n))
    return out


def kept_slices(grid):
    """(Gu, Gv, Gc) regions the function writes: the interiors, plus the
    boundary-face row of u on a bounded x and of v on a bounded y (on a
    shard's grid, at the global grid's walls only)."""
    (Hx, Hy, Hz), (Nx, Ny, Nz) = grid.H, grid.N
    bx, by = high_walls(grid)
    z = slice(Hz, Hz + Nz)
    return ((slice(Hx, Hx + Nx + bx), slice(Hy, Hy + Ny), z),
            (slice(Hx, Hx + Nx), slice(Hy, Hy + Ny + by), z),
            grid.interior_slices)


def _keep(a, sl):
    out = torch.zeros_like(a)
    out[sl] = a[sl]
    return out


def fused_vi_tendency_plain(grid, vi, tracer_scheme, names, coriolis, u, v,
                            w, tracers, ph=None, grid_motion=None,
                            tracer_velocities=None, zeta=None, cut=True):
    """Plain PyTorch version: the TPU function's four phase bodies with the
    port's operators on whole padded tensors, cut to the kept regions.

    It is also the hydrostatic model's tendency wherever the kernel is off,
    so it takes what the kernel refuses: ``vi`` a flux-form scheme
    (-∇·(𝐯u), -∇·(𝐯v) in place of the vector-invariant terms),
    ``grid_motion`` (z*'s Az·Δr·∂t_σ in the vector invariant's divergence
    flux), ``tracer_scheme`` a {name: scheme} dict, and
    ``tracer_velocities``, the (u, v, w) that advect the tracers (with an
    advective GM closure's eddy velocities), and ``zeta``, the vertical
    vorticity at (f, f, c) in place of the curl of (u, v) (the cubed
    sphere's, corrected at the cube's vertices). ``cut=False`` keeps the
    stencil values in every slot, as the JAX XLA path does (the cubed
    sphere's stored halos carry them, and its substepped TKE reads them)."""
    if u.is_cuda:
        fused_vi_tendency_plain.cuda_calls += 1
    if isinstance(vi, VectorInvariant):
        h_u, h_v = vi._horizontal(grid, u, v, zeta=zeta)
        b_u, b_v = vi._bernoulli(grid, u, v)
        z_u, z_v = vi._vertical(grid, u, v, w, grid_motion)
        Gu = (-h_u + -b_u) + -z_u
        Gv = (-h_v + -b_v) + -z_v
    else:
        Gu, Gv = -div_Uu(grid, vi, u, v, w), -div_Uv(grid, vi, u, v, w)
    f_u = f_v = None
    if coriolis is not None:
        f_u = -coriolis.x_f_cross_U(grid, u, v, w)
        f_v = -coriolis.y_f_cross_U(grid, u, v, w)
    if ph is not None:
        p_u, p_v = -ddx(grid, ph, LOC_FCC), -ddy(grid, ph, LOC_CFC)
        f_u = p_u if f_u is None else f_u + p_u
        f_v = p_v if f_v is None else f_v + p_v
    if f_u is not None:
        Gu, Gv = Gu + f_u, Gv + f_v
    Gc = tracer_advection_plain(grid, tracer_scheme, names,
                                *(tracer_velocities or (u, v, w)), tracers,
                                cut=cut)
    if not cut:
        return Gu, Gv, Gc
    su, sv, _ = kept_slices(grid)
    return _keep(Gu, su), _keep(Gv, sv), Gc


def tracer_advection_plain(grid, tracer_scheme, names, u, v, w, tracers,
                           cut=True):
    """{name: -∇·(𝐯c)} of ``tracers`` by ``tracer_scheme`` (a scheme, or a
    {name: scheme} dict), cut to the interior (unless ``cut=False``)."""
    sc = grid.interior_slices
    out = {n: -div_Uc(grid, tracer_scheme[n] if isinstance(
        tracer_scheme, dict) else tracer_scheme, u, v, w, tracers[n])
        for n in names}
    return out if not cut else {n: _keep(a, sc) for n, a in out.items()}


fused_vi_tendency_plain.cuda_calls = 0


# -- the coefficient tables ------------------------------------------------------

MAX_K = 6


def coefficient_table(bf16=False):
    """The kernel's constant table (float64, csrc's ``VITab`` order) of a
    uniform axis: for WENO buffers k = 2..6 the stencil coefficients,
    smoothness factors (|c| < 1e-14 set to 0, as the plain version skips
    them), optimal weights and τ coefficients, zero-padded to 6; Centered(2b)
    for b = 1..6 (padded to 12) and UpwindBiased(2k-1) for k = 1..6 (padded
    to 11); then ε and the saturation of τ/(β+ε). ``bf16``: every entry
    rounded to bfloat16, as the plain version rounds the constants that
    meet bfloat16 smoothness (``typed_constants``)."""
    coef = np.zeros((5, 6, 6))
    fac = np.zeros((5, 6, 6, 6))
    gam = np.zeros((5, 6))
    tau = np.zeros((5, 6))
    cen = np.zeros((6, 12))
    ub = np.zeros((6, 11))
    for k in range(2, MAX_K + 1):
        for s in range(k):
            coef[k - 2, s, :k] = eno_coefficients(k, s)
            for m, f in enumerate(smoothness_factors(k, s)):
                f = np.asarray(f)
                fac[k - 2, s, m, :k] = np.where(np.abs(f) < 1e-14, 0.0, f)
        gam[k - 2, :k] = optimal_weights(k)
        tau[k - 2, :k] = TAU_COEFFS[k]
    for b in range(1, MAX_K + 1):
        cen[b - 1, :2 * b] = Centered(order=2 * b)._coeffs
        ub[b - 1, :2 * b - 1] = UpwindBiased(order=2 * b - 1)._coeffs
    table = np.concatenate([coef.ravel(), fac.ravel(), gam.ravel(),
                            tau.ravel(), cen.ravel(), ub.ravel(),
                            [WENO_EPSILON, WENO_R_MAX]])
    if bf16:
        table = np.asarray([t.item() for t in typed_constants(
            tuple(float(x) for x in table), torch.bfloat16)])
    return table


TABLE_SIZE = 180 + 1080 + 30 + 30 + 72 + 66 + 2
_tables_on = set()          # devices whose constant tables are set


# Per-slot coefficients of a stretched axis (csrc/vi_kernel.cuh): a site
# reads an *entry* of rows, one row a coefficient over the padded axis, by
# its kind and β; an entry holds every level from buffer 1 up, so that one
# entry of a kind and β serves every site of that kind and β:
#   WENO:     level 1 (UpwindBiased(1)) left, right; then for k = 2.. the k
#             stencils × k cells of the left-biased, then of the right-biased
#             reconstruction
#   UPWIND:   for k = 1.. UpwindBiased(2k-1)'s 2k-1 cells, left then right
#   CENTERED: for b = 1.. Centered(2b)'s 2b cells (symmetric)
def weno_off(k, side):
    return side if k == 1 else 2 + 2 * sum(i * i for i in range(2, k)) \
        + side * k * k


def ub_off(k, side):
    return 2 * (k - 1) ** 2 + side * (2 * k - 1)


def cen_off(b):
    return b * (b - 1)


ENTRY_ROWS = {WENO_FAMILY: lambda K: weno_off(K + 1, 0),
              UPWIND: lambda K: 2 * K * K, CENTERED: lambda K: K * (K + 1)}


def site_entry(site, code):
    """(kind, β, buffer) of the entry a site reads on a stretched axis: its
    own family for a reconstruction (Centered's is its symmetric
    interpolation, as the plain version evaluates it there), the Centered
    rows of its top level for a symmetric interpolation."""
    if site in SYM_SITES:
        return CENTERED, SITE_BETA[site], sym_buffer(code)
    return code[0], SITE_BETA[site], code[1]


def stretched_entries(cfg, axis):
    """{(kind, β): buffer} of the entries the configuration reads along a
    stretched ``axis`` (empty along a uniform one), and each such site's
    entry key."""
    if axis == 0 or not cfg[("ys", "zs")[axis - 1]]:
        return {}, {}
    entries, keys = {}, {}
    for site, code in cfg["sites"].items():
        if SITE_AXIS[site] != axis:
            continue
        kind, beta, K = site_entry(site, code)
        entries[(kind, beta)] = max(entries.get((kind, beta), 0), K)
        keys[site] = (kind, beta)
    return entries, keys


def entry_coefficients(faces, npad, kind, beta, K):
    """The float64 rows of one entry (``weno_off`` .. ``cen_off`` order)
    from the plain version's per-slot coefficients
    (``advection.schemes._nonuniform_eno_np``)."""
    f = (faces.tobytes(), faces.size)

    def eno(k, s, mirrored):
        return list(_nonuniform_eno_np(*f, beta, k, s, mirrored, npad))

    rows = []
    if kind == WENO_FAMILY:
        rows += eno(1, 0, False) + eno(1, 0, True)
        for k in range(2, K + 1):
            for mirrored in (False, True):
                for s in range(k):
                    rows += eno(k, s, mirrored)
    elif kind == UPWIND:
        for k in range(1, K + 1):
            for mirrored in (False, True):
                rows += eno(2 * k - 1, k - 1, mirrored)
    else:
        for b in range(1, K + 1):
            rows += eno(2 * b, b - 1, False)
    assert len(rows) == ENTRY_ROWS[kind](K), (kind, K, len(rows))
    return rows


def entry_firsts(entries):
    """{(kind, β): its first row} of ``entries`` ({(kind, β): buffer}) laid
    out in sorted order, and the rows they take together."""
    first, row = {}, 0
    for key in sorted(entries):
        first[key] = row
        row += ENTRY_ROWS[key[0]](entries[key])
    return first, row


def coefficient_rows(grid, entries, axis):
    """The float64 rows of ``entries`` along ``axis``, in
    ``entry_firsts``' layout (on a shard's grid, the global grid's cut at
    its offset: ``shard_cut``)."""
    cut = shard_cut(grid, axis)
    if cut is not None:
        glob, o = cut
        n = grid.padded_shape[axis]
        return [r[o:o + n] for r in coefficient_rows(glob, entries, axis)]
    faces = _padded_faces(grid, axis)
    npad = grid.padded_shape[axis]
    rows = []
    for key in sorted(entries):
        rows += entry_coefficients(faces, npad, *key, entries[key])
    assert len(rows) == entry_firsts(entries)[1]
    return rows


def _coriolis_rows(grid, coriolis):
    """The Coriolis rows (float64, over the padded y): f at y centres and y
    faces, γy at centres, βy at centres and at faces."""
    NYP = grid.padded_shape[1]
    zero = np.zeros(NYP)
    yc = np.asarray(grid.coord_padded(1, "c"), np.float64)
    yf = np.asarray(grid.coord_padded(1, "f"), np.float64)
    if isinstance(coriolis, FPlane):
        return [zero + coriolis.f, zero + coriolis.f, zero, zero, zero]
    if isinstance(coriolis, BetaPlane):
        return [coriolis.f0 + coriolis.beta * yc,
                coriolis.f0 + coriolis.beta * yf, zero, zero, zero]
    if isinstance(coriolis, HydrostaticSphericalCoriolis):
        return [zero, np.asarray(coriolis.f_ffc_numpy(grid)).reshape(-1),
                zero, zero, zero]
    if isinstance(coriolis, NonTraditionalBetaPlane):
        return [zero, zero, coriolis.gamma * yc, coriolis.beta * yc,
                coriolis.beta * yf]
    return [zero] * N_CORIOLIS_ROWS


def _along(m, axis, n):
    """A float64 metric (a float or a broadcastable array) as its n values
    along ``axis``."""
    m = np.asarray(m, np.float64)
    if m.ndim == 0:
        return np.full(n, float(m))
    if m.shape[axis] == 1:
        return np.full(n, float(m.reshape(-1)[0]))
    assert m.size == m.shape[axis], ("a metric that varies along more than "
                                     "one axis", m.shape)
    return m.reshape(-1)


@functools.lru_cache(maxsize=32)
def y_rows(grid, coriolis, entries, dtype, device):
    """The (N_ROWS + coefficient rows, Ny + 2Hy) y rows in the field dtype:
    each metric of ROWS along the padded y (the horizontal factor of
    Z_FACTORED on a stretched z), the Coriolis rows, then the per-slot
    coefficients of ``entries`` (a tuple of ((kind, β), buffer)) along a
    stretched y. Built once per grid, Coriolis, entries, dtype and device
    (grids and Coriolis objects compare by value), since building them
    copies host arrays to the card."""
    NYP = grid.padded_shape[1]
    zs = _is_stretched(grid, 2)
    rows = []
    for name, loc in ROWS:
        if zs and (name, loc) in Z_FACTORED:
            name, loc = Z_FACTORED[(name, loc)]
        rows.append(_along(numpy_metric(grid, name, loc), 1, NYP))
    rows += _coriolis_rows(grid, coriolis)
    if entries:
        rows += coefficient_rows(grid, dict(entries), 1)
    return torch.as_tensor(np.stack(rows), dtype=dtype,
                           device=device).contiguous()


@functools.lru_cache(maxsize=32)
def z_rows(grid, coriolis, entries, dtype, device):
    """The (N_ZCOLS + coefficient rows, Nz + 2Hz) z columns in the field
    dtype: Δz at centres and at faces, the non-traditional β-plane's
    fy(1 − z/R) and fz(1 + 2z/R) at centres, then the per-slot coefficients
    of ``entries`` along a stretched z."""
    NZP = grid.padded_shape[2]
    cols = [_along(numpy_metric(grid, "dz", LOC_CCC), 2, NZP),
            _along(numpy_metric(grid, "dz", LOC_CCF), 2, NZP)]
    if isinstance(coriolis, NonTraditionalBetaPlane):
        zc = np.asarray(grid.coord_padded(2, "c"), np.float64)
        cols += [coriolis.fy0 * (1 - zc / coriolis.R),
                 coriolis.fz0 * (1 + 2 * zc / coriolis.R)]
    else:
        cols += [np.zeros(NZP)] * 2
    if entries:
        cols += coefficient_rows(grid, dict(entries), 2)
    return torch.as_tensor(np.stack(cols), dtype=dtype,
                           device=device).contiguous()


def site_bases(cfg):
    """{site: first row of its entry in its axis's coefficient rows} for
    the sites on a stretched axis, and the (y, z) entries as tuples."""
    bases, ent = {}, []
    for axis in (1, 2):
        entries, keys = stretched_entries(cfg, axis)
        first, _ = entry_firsts(entries)
        bases.update({site: first[key] for site, key in keys.items()})
        ent.append(tuple(sorted(entries.items())))
    return bases, ent[0], ent[1]


# -- the launch -----------------------------------------------------------------

THREADS = 256
# Tiles of output cells a block may own, largest first, by the fields'
# element size: ``pick_tile`` takes the first whose shared memory lets
# TILE_BLOCKS_PER_SM blocks share an SM (at float32 two: the 16 x 8 x 8
# tile up to the WENO-9 vorticity's reach with WENO-5 tracers, 98.9 KB; at
# float64 one: 8 x 8 x 8, 138.4 KB there).
TILES = {4: ((16, 8, 8), (8, 8, 8), (8, 8, 4), (4, 8, 4), (4, 4, 4)),
         8: ((8, 8, 8), (8, 8, 4), (4, 8, 4), (4, 4, 4))}
TILE_BLOCKS_PER_SM = {4: 2, 8: 1}


def smem_bytes(tile, cfg, esize, n_yrows=N_ROWS, n_zrows=N_ZCOLS):
    """Dynamic shared memory of one block (csrc/vi_kernel.cuh Layout): u and
    v over the tile plus the reach R, two per-cell sums, the y rows over the
    box's y and the z rows over the tile's z faces, and a work buffer large
    enough for each phase in turn (three derived fields; w, the z face
    fluxes of u and v and two columns or two derived fields; w and ph; w, a
    tracer box and its fluxes). The multi-dimensional stencil adds to the
    first three phases two buffers of a reconstruction over the tile plus 2
    along x and y."""
    TX, TY, TZ = tile
    mdb = _align((TX + 4) * (TY + 4) * TZ) if cfg.get("md") else 0
    R, Rw, Rz, Rc = cfg["R"], cfg["Rw"], cfg["Rz"], cfg["Rc"]
    BY = TY + 2 * R
    box = _align((TX + 2 * R) * BY * TZ)
    wsz = _align((TX + 2 * Rw - 1) * (TY + 2 * Rw - 1) * (TZ + 1))
    col = _align(TX * TY * (TZ + 2 * Rz))
    fz = _align(TX * TY * (TZ + 1))
    phb = _align((TX + 1) * (TY + 1) * TZ)
    tb = _align((TX + 2 * Rc) * (TY + 2 * Rc) * (TZ + 2 * Rz))
    tfx = _align((TX + 1) * TY * TZ)
    tfy = _align(TX * (TY + 1) * TZ)
    persistent = (2 * box + 2 * _align(TX * TY * TZ) + _align(n_yrows * BY)
                  + _align(n_zrows * (TZ + 1)))
    work = max(3 * box + 2 * mdb, wsz + 2 * fz + 2 * max(col, box) + 2 * mdb,
               wsz + phb, wsz + tb + tfx + tfy + fz)
    return esize * (persistent + work)


def row_counts(cfg):
    """(y rows, z rows) the launch stages: the metric rows and z columns
    and the per-slot coefficient rows of the stretched axes."""
    _, ye, ze = site_bases(cfg)
    return (N_ROWS + entry_firsts(dict(ye))[1],
            N_ZCOLS + entry_firsts(dict(ze))[1])


def pick_tile(cfg, esize):
    """The first tile of TILES[esize] whose shared memory lets
    TILE_BLOCKS_PER_SM[esize] blocks share an SM (the last one if none)."""
    per_sm = TILE_BLOCKS_PER_SM[esize]
    ny, nz = row_counts(cfg)
    for tile in TILES[esize]:
        smem = smem_bytes(tile, cfg, esize, ny, nz)
        if smem <= MAX_SMEM and SM_SMEM // (smem + SMEM_RESERVED) >= per_sm:
            return tile
    return TILES[esize][-1]


def launch_plan(grid, cfg, dtype):
    """The launch of ``fused_vi_tendency`` for configuration ``cfg``
    (``vi_config``) with fields of ``dtype`` on ``grid``: a dict with
    ``tile`` (TX, TY, TZ; ``pick_tile``), ``tiles`` (along x, y and z over
    the output region of Nx + bx by Ny + by by Nz cells, bx and by 1 on a
    bounded axis; block n owns tile (tx, ty, tz) with n = (tx·tiles_y +
    ty)·tiles_z + tz, cells [TX·tx, min(TX·(tx + 1), Nx + bx)) and likewise
    along y and z), ``blocks``, ``threads``, ``reach`` (R, Rw, Rz, Rc), the
    staged ``rows`` (y, z) and ``smem`` (bytes)."""
    esize = torch.empty((), dtype=dtype).element_size()
    tile = pick_tile(cfg, esize)
    (Nx, Ny, Nz) = grid.N
    bx, by = high_walls(grid)
    tiles = tuple(-(-n // t) for n, t in zip((Nx + bx, Ny + by, Nz), tile))
    ny, nz = row_counts(cfg)
    return dict(tile=tile, tiles=tiles, blocks=tiles[0] * tiles[1] * tiles[2],
                threads=THREADS,
                reach=(cfg["R"], cfg["Rw"], cfg["Rz"], cfg["Rc"]),
                rows=(ny, nz), smem=smem_bytes(tile, cfg, esize, ny, nz))


# The C entry's int configuration (csrc/vi_kernel.cuh Conf): the geometry,
# the codes, the reaches, the multi-dimensional stencil's flag, then per
# site its family, buffer and first coefficient row (-1 on a uniform axis).
CONF_HEAD = 32


def conf_array(grid, cfg, plan, n_tr, with_ph, momentum):
    (Nx, Ny, Nz), (Hx, Hy, Hz) = grid.N, grid.H
    bases, _, _ = site_bases(cfg)
    (cx, hox, gnx), (cy, hoy, gny) = cascade_geometry(grid)
    head = [Nx, Ny, Nz, Hx, Hy, Hz, *high_walls(grid), cfg["vort"],
            cfg["vort_sm"], cfg["ke"], cfg["vert"], cfg["upw"], cfg["cor"],
            n_tr, int(with_ph), int(momentum), cfg["KM"],
            *plan["reach"], *plan["rows"], int(cfg["zs"]), cfg["md"],
            cx, cy, hox, hoy, gnx, gny]
    assert len(head) == CONF_HEAD
    fam = [cfg["sites"].get(s, (0, 0))[0] for s in SITES]
    K = [cfg["sites"].get(s, (0, 0))[1] for s in SITES]
    base = [bases.get(s, -1) for s in SITES]
    vals = head + fam + K + base
    return (ctypes.c_int * len(vals))(*vals)


def _set_tables(lib, dev):
    if dev in _tables_on:
        return
    table = coefficient_table()
    table_bf16 = coefficient_table(bf16=True)
    build.check(lib.oc_vi_set_tables(
        table.ctypes.data_as(ctypes.c_void_p),
        table_bf16.ctypes.data_as(ctypes.c_void_p), len(table)), lib)
    _tables_on.add(dev)


@functools.lru_cache(maxsize=32)
def launch_setup(grid, vi, tracer_scheme, n_tracers, coriolis, dtype, device,
                 with_ph):
    """Everything a call's launches need that depends only on the
    configuration, formed once per grid, schemes, tracer count, Coriolis,
    dtype, device and pₕ′ (grids, schemes and Coriolis objects compare by
    value): ``vi_config``, the launch plan, the y and z rows on the device,
    and per launch its (first, stop) tracers and int configuration. Raises
    NotImplementedError for an uncovered configuration (not cached)."""
    cfg = vi_config(grid, vi, tracer_scheme, n_tracers, coriolis)
    _, ye, ze = site_bases(cfg)
    plan = launch_plan(grid, cfg, dtype)
    n_eff = n_tracers if cfg["tracers"] else 0
    groups = [(a, min(n_eff, a + TRACER_BATCH))
              for a in range(0, n_eff, TRACER_BATCH)] or [(0, 0)]
    confs = [conf_array(grid, cfg, plan, stop - first, with_ph, first == 0)
             for first, stop in groups]
    return dict(cfg=cfg, plan=plan, groups=groups, confs=confs,
                yr=y_rows(grid, coriolis, ye, dtype, device),
                zr=z_rows(grid, coriolis, ze, dtype, device),
                cor_f=(ctypes.c_double * 3)(*cfg["cor_f"]),
                sdtype=_SMOOTHNESS_CODES[cfg["sdtype"]],
                variant=variant_name(cfg))


def fused_vi_tendency(grid, vi, tracer_scheme, names, coriolis, u, v, w,
                      tracers, ph=None):
    """The hydrostatic tendency ``(Gu, Gv, {name: Gc})`` of padded u, v, w,
    ``tracers`` ({name: padded tensor}, in the order of ``names``) and
    ``ph`` (None without buoyancy), all with filled halos. CPU tensors take
    the plain version; CUDA tensors launch the kernel (once per 32 tracers),
    or raise for a configuration it does not cover."""
    names = tuple(names)
    if u.device.type == "cpu":
        return fused_vi_tendency_plain(grid, vi, tracer_scheme, names,
                                       coriolis, u, v, w, tracers, ph)
    ins = [u, v, w] + ([ph] if ph is not None else []) + \
        [tracers[n] for n in names]
    from .fused_projection import check_tensors
    check_tensors(grid, ins, grid.padded_shape)
    dev, dt = u.device, u.dtype
    with torch.cuda.device(dev):
        setup = launch_setup(grid, vi, tracer_scheme, len(names), coriolis,
                             dt, dev, ph is not None)
        lib = build.library()
        _set_tables(lib, dev)
        Gu, Gv = torch.zeros_like(u), torch.zeros_like(v)
        Gc = [torch.zeros_like(u) for _ in names]
        plan = setup["plan"]
        for (first, stop), conf in zip(setup["groups"], setup["confs"]):
            in_ptrs = _pointers([u, v, w, ph]
                                + [tracers[n] for n in names[first:stop]])
            out_ptrs = _pointers([Gu, Gv] + Gc[first:stop])
            build.check(lib.oc_fused_vi_tendency(
                _DTYPE_CODES[dt], setup["sdtype"], in_ptrs, out_ptrs,
                build.ptr(setup["yr"]), build.ptr(setup["zr"]), conf,
                setup["cor_f"], *plan["tile"], plan["threads"],
                plan["blocks"], plan["smem"], build.stream_of(u)), lib)
            count_launch(setup["variant"])
    return Gu, Gv, dict(zip(names, Gc))


def _pointers(ts):
    """A host array of device pointers, null for None."""
    return (ctypes.c_void_p * len(ts))(
        *[t.data_ptr() if t is not None else None for t in ts])


def count_launch(name):
    """One more launch of #10 (its ``launches``) and of its variant ``name``
    (its ``variant_launches``, by ``variant_name``)."""
    fused_vi_tendency.launches += 1
    fused_vi_tendency.variant_launches[name] = \
        fused_vi_tendency.variant_launches.get(name, 0) + 1


fused_vi_tendency.launches = 0
fused_vi_tendency.variant_launches = {}
