"""Flux-form advection kernels: the fused RK3 stage update and the
tendency-only form.

``fused_advection_update`` replaces the TPU kernel
``oceananigans_tpu/kernels/fused_advection.py`` ``_build_update_group`` (via
``build_fused_advection_update``), for u, v, w and the tracers, in the
z-compact layout (no z halo; the z boundary conditions are applied inside
the stencil reads):

    G   = -∇·(𝐯 q)            for q = u, v, w, tracers  (interior-shaped)
    new = q + γΔt·G + ζΔt·G⁻   (ζΔt·G⁻ only when G⁻ is given; padded, with
                               valid periodic x/y halos)

With ``p`` and ``corr_dt`` (the previous stage's deferred pressure
correction), G is the tendency of the corrected fields q* − corr_dt·∂p (w's
bottom face pinned to 0) and the tracers are advected by the corrected
velocities, while ``new`` adds the increment to the uncorrected q* (the
tracers are never corrected), as the TPU kernel does.

Bound on the H100: over u, v, w, arithmetic (for WENO(5) about 300
floating-point operations per component and cell, each face flux once, for
WENO(9) about 1,090, against 16 B of compulsory traffic per component in
float32); with tracers at WENO(5), the bytes. Design
(``csrc/advection_kernel.cuh``, face fluxes in
``csrc/advection_stencils.cuh``, reconstructions in
``csrc/reconstruction.cuh``): one block per TX × TY × TZ tile of interior
cells, z fastest across threads; the block stages the corrected u, v, w
over the tile plus the stencil's reach into shared memory once, then for
each component of the launch (u, v, w, the tracers, each tracer staged in
turn) forms each face flux once and each cell's update, with the
velocities resident throughout. ``launch_plan`` gives the tile (by the
reach and the element size), the block count and the shared memory; the C
entry checks them. Division is exact. Schemes: every scheme of
``advection/schemes.py``, as the TPU kernels take them: Centered(2-12),
UpwindBiased(1-11) and WENO(3-11), each with its near-wall cascade along
the bounded z (``scheme_code``; the scheme's buffer K is a compile-time
choice, one source of instantiations a buffer, ``csrc/advection_k1.cu`` ..
``advection_k6.cu``); any other scheme raises on the card. The WENO
smoothness arithmetic runs in float32 or float64, or with float32 fields in
bfloat16, rounded operation by operation as the plain version rounds it
(``smoothness_code``).

``fused_advection_tendency`` replaces ``build_fused_advection``: ``G =
-∇·(𝐯q)`` for u, v, w and each tracer as one (3 + n_tracers, Nx, Ny, Nz)
tensor, with no stage update (the model adds buoyancy, closure and boundary
fluxes to G and updates in PyTorch), on the grids the TPU kernel takes
(``eligible``: a regular grid with periodic x and y, neither flat). As in
the TPU kernel, the z keeps its topology (``z_mode``) and the layout follows
it and the z halo: on a bounded z, padded fields whose halos (z included)
were filled beforehand, with the near-wall cascade, or the z-compact layout
(``H[2] == 0``: filled x/y halos, the z boundary mirrors inside the reads,
zero boundary-face fluxes); on a periodic z, padded fields whose filled z
halos are read as they are, with no cascade; on a flat z (Nz = 1, no z
halo), no z flux, and the tile is one level deep (``FLAT_TILES``). Its
CUDA kernel is the update kernel's template with the tendency epilogue
(``csrc/fused_advection.cu``): the same tiles, staging and face fluxes,
each formed once, G written straight to the output, under the same
``launch_plan``.

With a bounds-preserving ``WENO(order, bounds=(lo, hi))`` the padded
``fused_advection_tendency`` launches its bounded variant
(``csrc/bounded_limiter.cuh``, the family ``BOUNDED_WENO_FAMILY``): u, v
and w as the unlimited scheme, each tracer's fluxes limited by θ per cell
and axis as the JAX ``_div_Uc_bounded`` limits them, the limited face
values formed over the tile plus one cell each way in shared memory (the
array of ``limited_elems``); built for a bounded, periodic or flat z, with
float32 fields and smoothness or float64 fields and float32 or float64
smoothness (``BOUNDED_PAIRS``). ``bounded_refusal`` says what it does not
take: the z-compact #6 and #1 refuse the limiter with JAX's reason.

Both kernels take any number of components: the per-component pointers ride
in the kernel's parameter block, at most ``build.BATCH`` a launch, and a
call with more launches once per batch. Every component's result depends only on its
own field and u, v, w (and p), so the batching changes no bit of it.

``shard_fused_advection`` and ``build_sharded_fused_advection`` replace
``build_sharded_fused_advection`` (#7): the tendency kernel once per shard
of a device mesh, on the shard's resident blocks, whose x/y halos come
from the mesh's halo exchange, in either layout and with any z.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..advection import (WENO, Centered, UpwindBiased, div_Uc, div_Uu,
                         div_Uv, div_Uw)
from ..advection.fluxes import BOUNDED_REFUSAL
from ..advection.reconstruction import typed_constants
from ..advection.schemes import TAU_COEFFS, WENO_EPSILON, WENO_R_MAX
from ..grids.topology import PERIODIC
from ..operators.shifts import shift
from ..parallel.distributed import mesh_shards
from . import build
from .fused_projection import (_DTYPE_CODES, _metrics, check_fast_layout,
                               check_tensors, scalar_product)
from .halo_fill import periodic_halo_fill_plain

ZBC = {"u": "even", "v": "even", "w": "odd_face", "c": "even"}

MESH_TOPOLOGY_ITEM = ("ROADMAP.md queue 1 item 16b (bounded or stretched "
                      "sharded axes)")

OTHER_SCHEMES_ITEM = ("ROADMAP.md queue 1 item 15 (the long tail: a "
                      "per-axis FluxFormAdvection in the CUDA advection "
                      "kernels)")

# Scheme families of csrc/reconstruction.cuh (kCentered, kUpwind, kWeno),
# and WENO with the bounds-preserving limiter, which the padded #6 alone
# takes (csrc/bounded_limiter.cuh).
CENTERED, UPWIND, WENO_FAMILY, BOUNDED_WENO_FAMILY = 0, 1, 2, 3

# The (fields, smoothness) dtypes of the bounded #6's instantiations
# (csrc/advection_kernel.cuh dispatch_bounded): WENO's default float32
# smoothness with either field dtype, and float64 throughout.
BOUNDED_PAIRS = ((torch.float32, torch.float32),
                 (torch.float64, torch.float32),
                 (torch.float64, torch.float64))

# The deepest buffer the kernels are built for (kMaxBuffer):
# Centered(12), UpwindBiased(11), WENO(11).
MAX_BUFFER = 6

# Codes of the WENO smoothness dtype (OC_FLOAT32, OC_FLOAT64, OC_BFLOAT16 in
# csrc/common.cuh). The fields' dtype takes fused_projection._DTYPE_CODES,
# which has no bfloat16.
_SMOOTHNESS_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

# Threads a block of the update kernel (csrc/advection_kernel.cuh kThreads
# is the most it takes, and a thread updates at most kCells =
# CELLS_PER_THREAD cells) and the tiles of interior cells a block may own,
# largest first, by the fields' element size. ``launch_plan`` takes the
# first whose shared memory (it grows with the reach, and with tracer
# boxes) lets TILE_BLOCKS_PER_SM blocks share an SM: at float32 two (a 16 x
# 8 x 8 tile up to reach 3, 104.7 KB at WENO(5) with tracers), at float64
# one (8 x 8 x 8, 129.9 KB at WENO(5)).
UPDATE_THREADS = 256
UPDATE_TILES = {4: ((16, 8, 8), (8, 8, 8), (8, 8, 4), (4, 8, 4), (4, 4, 4)),
                8: ((8, 8, 8), (8, 8, 4), (4, 8, 4), (4, 4, 4))}
TILE_BLOCKS_PER_SM = {4: 2, 8: 1}
CELLS_PER_THREAD = 4

# The tiles of #6 on a flat z (one level, no z reach): the same cells a
# block (at most CELLS_PER_THREAD x UPDATE_THREADS) spread over x and y, so
# that no thread idles, y fastest across threads (y is the contiguous axis
# when Nz = 1). A 32 x 32 tile stages (32 + 2r)² cells per velocity, 1.41
# times its cells at WENO(5) against 16 x 8 x 8's 3.52 with z reach.
FLAT_TILES = ((32, 32, 1), (16, 32, 1), (16, 16, 1), (8, 16, 1), (8, 8, 1))

# The z modes of #6 (csrc/advection_stencils.cuh kZBounded, kZPeriodic,
# kZFlat): the kernel's z keeps the grid's topology.
Z_BOUNDED, Z_PERIODIC, Z_FLAT = 0, 1, 2
Z_MODE_NAMES = {Z_BOUNDED: "", Z_PERIODIC: "_zperiodic", Z_FLAT: "_zflat"}

# The H100's shared memory: the most a block takes, and an SM's, of which
# each block reserves 1 KB (csrc/tiles.cuh kMaxSmemBytes).
MAX_SMEM = 232448
SM_SMEM = 233472
SMEM_RESERVED = 1024


def _align(n):
    """Elements rounded up to a multiple of four (csrc/tiles.cuh
    align_elems)."""
    return (n + 3) // 4 * 4


def tracer_z(reach):
    """Cells a tracer box's rows run past the tile each way along z
    (csrc/advection_kernel.cuh tracer_z): the reach rounded up to 16 bytes
    of float32, at least 4, so that the rows are 16-byte aligned."""
    return 4 if reach <= 4 else -(-reach // 4) * 4


def limited_elems(tile, flat=False):
    """The bounded #6's limited face values (csrc/advection_kernel.cuh
    limited_elems): the faces of one axis at a time."""
    TX, TY, TZ = tile
    return max((TX + 1) * TY * TZ, TX * (TY + 1) * TZ,
               0 if flat else TX * TY * (TZ + 1))


def smem_bytes(tile, reach, esize, tracers, flat=False, bounded=False):
    """Dynamic shared memory of one block of the update kernel
    (csrc/advection_kernel.cuh Layout): u, v, w over the tile plus the
    reach (none along a flat z), when the launch holds a tracer two tracer
    boxes (one filling while the other is read; ``tracer_z(reach)`` cells
    past the tile along z, none on a flat z), the x-, y- and z-flux
    arrays, and for the bounded #6 with tracers the limited face
    values."""
    TX, TY, TZ = tile
    rz, tz = (0, 0) if flat else (reach, tracer_z(reach))
    box = _align((TX + 2 * reach) * (TY + 2 * reach) * (TZ + 2 * rz))
    cbox = _align((TX + 2 * reach) * (TY + 2 * reach) * (TZ + 2 * tz))
    fluxes = (_align((TX + 1) * TY * TZ) + _align(TX * (TY + 1) * TZ)
              + _align(TX * TY * (TZ + 1)))
    lim = _align(limited_elems(tile, flat)) if bounded and tracers else 0
    return esize * (3 * box + (2 * cbox if tracers else 0) + fluxes + lim)


def pick_tile(reach, esize, tracers, flat=False, bounded=False):
    """The first tile of UPDATE_TILES[esize] (FLAT_TILES on a flat z)
    whose shared memory lets TILE_BLOCKS_PER_SM[esize] blocks share an SM
    (the last one fits one block at every reach up to MAX_BUFFER)."""
    per_sm = TILE_BLOCKS_PER_SM[esize]
    tiles = FLAT_TILES if flat else UPDATE_TILES[esize]
    for tile in tiles:
        smem = smem_bytes(tile, reach, esize, tracers, flat, bounded)
        if smem <= MAX_SMEM and SM_SMEM // (smem + SMEM_RESERVED) >= per_sm:
            return tile
    return tiles[-1]


def launch_plan(grid, scheme, dtype, n_components):
    """The launches of ``fused_advection_update`` and
    ``fused_advection_tendency`` (one kernel template, one layout) for
    ``n_components`` components (u, v, w, then the tracers) of ``dtype`` on
    ``grid``: a dict with ``tile`` (TX, TY, TZ; ``pick_tile`` by the
    scheme's reach and whether the launches stage tracers), ``tiles``
    (along x, y and z; block n owns tile (tx, ty, tz) with n = (tx·tiles_y
    + ty)·tiles_z + tz, cells [TX·tx, min(TX·(tx + 1), Nx)) and likewise
    along y and z), ``blocks``, ``threads`` and ``launches``, one (first,
    stop, smem) per batch of components (the shared memory in bytes: a
    batch holding a tracer stages it)."""
    esize = torch.empty((), dtype=dtype).element_size()
    reach = scheme.required_halo
    flat = z_mode(grid) == Z_FLAT
    bounded = getattr(scheme, "bounds", None) is not None
    tile = pick_tile(reach, esize, n_components > 3, flat, bounded)
    tiles = tuple(-(-n // t) for n, t in zip(grid.N, tile))
    return dict(tile=tile, tiles=tiles,
                blocks=tiles[0] * tiles[1] * tiles[2],
                threads=UPDATE_THREADS,
                launches=[(a, b, smem_bytes(tile, reach, esize, b > 3, flat,
                                            bounded))
                          for a, b in build.batches(n_components)])


def kernel_tendency_eligible(grid):
    """Whether the advection tendency takes the kernel (#6): JAX's
    ``eligible`` (periodic x and y, neither flat, a regular grid); the z may
    be bounded (padded or z-compact), periodic or flat."""
    return (getattr(grid, "all_regular", False)
            and grid.topology[:2] == (PERIODIC, PERIODIC)
            and not grid.is_flat(0) and not grid.is_flat(1))


def bounded_refusal(grid, scheme, dtype):
    """Why #6 cannot take ``scheme`` with fields of ``dtype`` on ``grid``,
    or None: the limiter of a bounds-preserving scheme is refused on the
    z-compact layout with JAX's reason, and the bounded variant is built for
    the (fields, smoothness) dtypes of BOUNDED_PAIRS on any z of the padded
    layout. The model and ``fused_advection_tendency`` both ask it."""
    if getattr(scheme, "bounds", None) is None:
        return None
    if z_mode(grid) == Z_BOUNDED and grid.H[2] == 0:
        return BOUNDED_REFUSAL
    # (a scheme with no smoothness dtype is no WENO: scheme_code refuses it)
    sdt = getattr(scheme, "smoothness_dtype", None)
    if sdt is not None and (dtype, sdt) not in BOUNDED_PAIRS:
        return (f"the bounded #6 is built for float32 fields with float32 "
                f"smoothness and float64 fields with float32 or float64 "
                f"smoothness, not {sdt} smoothness with {dtype} fields "
                f"(ROADMAP.md queue 2)")
    return None


def z_mode(grid):
    """Z_BOUNDED, Z_PERIODIC or Z_FLAT: the z topology the tendency kernel
    keeps."""
    if grid.is_flat(2):
        return Z_FLAT
    return Z_PERIODIC if grid.topology[2] == PERIODIC else Z_BOUNDED


def corrected_velocities(grid, u, v, w, p, corr_dt):
    """q* − corr_dt·∂p on the whole padded tensors, w's bottom face pinned;
    the factors corr_dt·(1/Δ) are rounded in the field dtype."""
    m = _metrics(grid)
    cx, cy, cz = (scalar_product(u.dtype, corr_dt, 1.0 / m[d])
                  for d in ("dx", "dy", "dz"))
    uc = u - cx * (p - shift(p, -1, 0))
    vc = v - cy * (p - shift(p, -1, 1))
    wc = w - cz * (p - shift(p, -1, 2))
    wc[..., 0] = 0
    return uc, vc, wc


def fused_advection_update_plain(grid, scheme, u, v, w, Gm, gamma_dt, zeta_dt,
                                 p=None, corr_dt=None, tracers=None):
    """Plain PyTorch version: the port's flux functions on the whole padded
    tensors, then the stage update and the periodic halo wrap."""
    if u.is_cuda:
        fused_advection_update_plain.cuda_calls += 1
    tracers = dict(tracers or {})
    qs = [u, v, w] + list(tracers.values())
    names = ("u", "v", "w") + tuple(tracers)
    if p is not None:
        u, v, w = corrected_velocities(grid, u, v, w, p, corr_dt)
    ints = grid.interior_slices
    G = [-div(grid, scheme, u, v, w, zbc=ZBC)[ints]
         for div in (div_Uu, div_Uv, div_Uw)]
    G += [-div_Uc(grid, scheme, u, v, w, c, zbc=ZBC)[ints]
          for c in tracers.values()]
    new = {}
    for k, name in enumerate(names):
        inc = float(gamma_dt) * G[k]
        if Gm is not None:
            inc = inc + float(zeta_dt) * Gm[k]
        out = torch.empty_like(qs[k])
        out[ints] = qs[k][ints] + inc
        new[name] = out
    periodic_halo_fill_plain(grid, list(new.values()))
    return G, new


fused_advection_update_plain.cuda_calls = 0


# -- the CUDA kernel -----------------------------------------------------------

_tables = {}


def scheme_code(scheme):
    """(family, K) of a scheme the kernels take: CENTERED, UPWIND,
    WENO_FAMILY or (bounds-preserving WENO, the padded #6's alone:
    ``bounded_refusal``) BOUNDED_WENO_FAMILY and the scheme's buffer K (its
    reach, ``required_halo``): Centered(2K) for K = 1..MAX_BUFFER,
    UpwindBiased(2K-1), WENO(2K-1) for K >= 2. Raises for any other scheme:
    another class (a per-axis FluxFormAdvection included) or a deeper
    order."""
    K = getattr(scheme, "buffer", None)
    bounded = getattr(scheme, "bounds", None) is not None
    if type(scheme) is Centered:
        family = CENTERED
    elif type(scheme) is UpwindBiased:
        family = UPWIND
    elif type(scheme) is WENO and K >= 2:
        family = BOUNDED_WENO_FAMILY if bounded else WENO_FAMILY
    else:
        family = None
    if family is None or not 1 <= K <= MAX_BUFFER:
        raise NotImplementedError(
            f"no CUDA advection kernel for {scheme!r}: {OTHER_SCHEMES_ITEM}")
    return family, K


def variant_name(scheme):
    """The name of a scheme's kernel variant, by family and order:
    ``centered4``, ``upwind5``, ``weno9``."""
    family, K = scheme_code(scheme)
    return (("centered", "upwind", "weno", "weno")[family]
            + str(2 * K if family == CENTERED else 2 * K - 1)
            + ("_bounded" if family == BOUNDED_WENO_FAMILY else ""))


def count_launch(kernel, scheme, zmode=Z_BOUNDED):
    """One more launch of ``kernel`` (its ``launches``) and of the scheme's
    variant (its ``variant_launches``, by ``variant_name`` and, for a z
    that is not bounded, ``_zperiodic`` or ``_zflat``); the shards of a
    device mesh count from their own threads."""
    name = variant_name(scheme) + Z_MODE_NAMES[zmode]
    with _count_lock:
        kernel.launches += 1
        kernel.variant_launches[name] = kernel.variant_launches.get(name,
                                                                    0) + 1


_count_lock = threading.Lock()


def smoothness_code(scheme, dtype):
    """The kernels' code for the scheme's smoothness dtype with fields of
    ``dtype`` (a scheme without one computes in the field dtype); raises
    TypeError for a pair no kernel was built for."""
    sdt = getattr(scheme, "smoothness_dtype", dtype)
    if sdt not in _SMOOTHNESS_CODES:
        raise TypeError(f"unsupported smoothness dtype {sdt}")
    if sdt == torch.bfloat16 and dtype != torch.float32:
        raise TypeError(
            f"bfloat16 smoothness takes float32 fields on the card, not "
            f"{dtype}: the kernels are built for that one pair (the plain "
            f"version takes any)")
    return _SMOOTHNESS_CODES[sdt]


def table_layout(K):
    """Offsets of the coefficient table of buffer K (csrc/reconstruction.cuh
    off_sym .. off_eps): ``sym[b]`` (Centered(2b), b = 1..K), ``ub[k]``
    (UpwindBiased(2k-1), k = 1..K), ``wc[k]``, ``wf[k]``, ``wg[k]``,
    ``wt[k]`` (WENO-(2k-1), k = 2..K), ``eps`` (ε, then the saturation),
    ``lin`` (the size of the linear part) and ``size``."""
    sym = {b: b * (b - 1) for b in range(1, K + 1)}
    ub = {k: K * (K + 1) + (k - 1) ** 2 for k in range(1, K + 1)}
    wc, o = {}, K * (K + 1) + K * K
    for k in range(2, K + 1):
        wc[k], o = o, o + k * k
    lin = o
    wf, o = {}, lin
    for k in range(2, K + 1):
        wf[k], o = o, o + k ** 3
    wg = {}
    for k in range(2, K + 1):
        wg[k], o = o, o + k
    wt = {}
    for k in range(2, K + 1):
        wt[k], o = o, o + k
    return dict(sym=sym, ub=ub, wc=wc, wf=wf, wg=wg, wt=wt, eps=o, lin=lin,
                size=o + 2)


def _padded_factors(factors, k):
    """k×k smoothness factor rows, missing rows zero and |c| < 1e-14 zeroed
    (the plain evaluation skips those terms)."""
    rows = [list(f) for f in factors] + [[0.0] * k] * (k - len(factors))
    return [0.0 if abs(c) < 1e-14 else c for row in rows for c in row]


def coefficient_table(scheme):
    """The kernels' coefficient table (csrc/reconstruction.cuh) for the
    scheme's buffer K, as a ctypes float64 array in ``table_layout(K)``'s
    order: the Centered and UpwindBiased rows of every buffer up to K and
    the WENO rows of buffers 2..K, each from the scheme objects of the
    scheme's cascade (``buffer_scheme()`` down to buffer 1) and of their
    advecting-velocity schemes. With bfloat16 smoothness the entries that
    meet the smoothness arithmetic (factors, optimal weights, τ
    coefficients, ε, the saturation) are rounded to bfloat16 here, as the
    plain version rounds them (``advection.reconstruction.typed_constants``);
    the stencil coefficients, read in the field type, are not."""
    family, K = scheme_code(scheme)
    key = scheme._fp()
    if key in _tables:
        return _tables[key]
    lay = table_layout(K)
    vals = [0.0] * lay["size"]
    sdt = getattr(scheme, "smoothness_dtype", None)

    def put(at, row, smooth=False):
        row = list(row)
        if smooth and sdt == torch.bfloat16:
            row = [t.item() for t in typed_constants(tuple(row), sdt)]
        vals[at:at + len(row)] = row

    # the cascade, buffer K down to 1, and the Centered / UpwindBiased rows
    # of every buffer (a WENO kernel reads the UpwindBiased(1) row at buffer
    # 1 and the Centered rows of its advecting velocities)
    chain, s = [], scheme
    while s is not None:
        chain.append(s)
        s = s.buffer_scheme()
    assert [c.buffer for c in chain] == list(range(K, 0, -1)), chain
    for b in range(1, K + 1):
        put(lay["sym"][b], Centered(order=2 * b)._coeffs)
        put(lay["ub"][b], UpwindBiased(order=2 * b - 1)._coeffs)
    for c in chain:
        if isinstance(c, (Centered, UpwindBiased)):
            row = lay["sym" if isinstance(c, Centered) else "ub"][c.buffer]
            assert tuple(vals[row:row + len(c._coeffs)]) == tuple(c._coeffs)
        if not isinstance(c, Centered):
            v = c.advecting_velocity_scheme
            row = lay["sym"][v.buffer]
            assert tuple(vals[row:row + len(v._coeffs)]) == tuple(v._coeffs)
        if isinstance(c, WENO):
            k = c.buffer
            put(lay["wc"][k], [x for st in range(k) for x in c._coeffs[st]])
            put(lay["wf"][k], [x for st in range(k)
                               for x in _padded_factors(c._sfactors[st], k)],
                smooth=True)
            put(lay["wg"][k], c._gammas, smooth=True)
            put(lay["wt"][k], TAU_COEFFS[k], smooth=True)
    put(lay["eps"], (WENO_EPSILON, WENO_R_MAX), smooth=True)
    _tables[key] = (ctypes.c_double * len(vals))(*vals)
    return _tables[key]


def fused_advection_update(grid, scheme, u, v, w, Gm, gamma_dt, zeta_dt,
                           p=None, corr_dt=None, tracers=None):
    """Advection + RK3 stage update of u, v, w and the ``tracers`` ({name:
    padded tensor}). Returns ``(G, new)``: ``G`` a list of the 3 + n
    interior-shaped tendencies (pass back as the next stage's ``Gm``),
    ``new`` a dict of the padded u, v, w and tracers with valid periodic x/y
    halos. ``Gm=None`` is the first-stage variant (ζ = 0); ``p``/``corr_dt``
    apply the deferred correction. Scalars are values in the field dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel, once
    per ``build.BATCH`` components."""
    if u.device.type == "cpu":
        return fused_advection_update_plain(grid, scheme, u, v, w, Gm,
                                            gamma_dt, zeta_dt, p, corr_dt,
                                            tracers)
    if getattr(scheme, "bounds", None) is not None:
        raise NotImplementedError(BOUNDED_REFUSAL)
    fam, K = scheme_code(scheme)
    check_fast_layout(grid)
    table = coefficient_table(scheme)
    has_corr = p is not None
    if has_corr and corr_dt is None:
        raise ValueError("the corrected variant needs p and corr_dt")
    req = scheme.required_halo + (1 if has_corr else 0)
    if min(grid.H[0], grid.H[1]) < req:
        raise ValueError(f"the kernel needs Hx, Hy >= {req}")
    tracers = dict(tracers or {})
    qs = [u, v, w] + list(tracers.values())
    nc = len(qs)
    check_tensors(grid, qs + ([p] if has_corr else []), grid.padded_shape)
    if Gm is not None:
        Gm = list(Gm)
        if len(Gm) != nc:
            raise ValueError(f"Gm holds {len(Gm)} tendencies for {nc} fields")
        check_tensors(grid, Gm, grid.N)
        if Gm[0].device != u.device:
            raise ValueError("Gm must be on the fields' device")
    scode = smoothness_code(scheme, u.dtype)
    m = _metrics(grid)
    Nx, Ny, Nz = grid.N
    Hx, Hy, _ = grid.H
    G = list(torch.empty((nc,) + grid.N, dtype=u.dtype,
                         device=u.device).unbind(0))
    outs = [torch.empty_like(q) for q in qs]
    vel = build.pointers([u, v, w])
    plan = launch_plan(grid, scheme, u.dtype, nc)
    with torch.cuda.device(u.device):
        lib = build.library()
        for a, b, smem in plan["launches"]:
            build.check(lib.oc_fused_advection_update(
                fam, K, _DTYPE_CODES[u.dtype], scode, vel, build.ptr(p),
                build.pointers(qs[a:b]),
                build.pointers(Gm[a:b]) if Gm is not None else None,
                build.pointers(G[a:b]), build.pointers(outs[a:b]), b - a, a,
                Nx, Ny, Nz, Hx, Hy,
                float(gamma_dt), float(zeta_dt) if Gm is not None else 0.0,
                float(corr_dt) if has_corr else 0.0,
                m["Ax"], m["Ay"], m["Az"], m["V"],
                1.0 / m["dx"], 1.0 / m["dy"], 1.0 / m["dz"],
                table, len(table), *plan["tile"], plan["threads"],
                plan["blocks"], smem, build.stream_of(u)), lib)
            count_launch(fused_advection_update, scheme)
    return G, dict(zip(("u", "v", "w") + tuple(tracers), outs))


fused_advection_update.launches = 0
fused_advection_update.variant_launches = {}


# -- tendency only ---------------------------------------------------------------

def fused_advection_tendency_plain(grid, scheme, fields):
    """Plain PyTorch version: the port's flux functions on the padded
    tensors (halos read as they are; on a bounded z with no z halo, through
    the z boundary mirrors; a flat z has no z flux), interiors stacked."""
    if fields[0].is_cuda:
        fused_advection_tendency_plain.cuda_calls += 1
    u, v, w = fields[:3]
    zbc = ZBC if z_mode(grid) == Z_BOUNDED and grid.H[2] == 0 else None
    ints = grid.interior_slices
    G = [-div(grid, scheme, u, v, w, zbc=zbc)[ints]
         for div in (div_Uu, div_Uv, div_Uw)]
    G += [-div_Uc(grid, scheme, u, v, w, c, zbc=zbc)[ints]
          for c in fields[3:]]
    return torch.stack(G)


fused_advection_tendency_plain.cuda_calls = 0


def fused_advection_tendency(grid, scheme, fields):
    """``G = -∇·(𝐯q)`` at every interior cell for ``fields`` = [u, v, w,
    tracers...], padded tensors with filled halos (z included; on a bounded
    z with ``grid.H[2] == 0`` the z-compact layout; a flat z has no halo)
    on a regular grid with periodic x and y. Returns one (len(fields), Nx,
    Ny, Nz) tensor. CPU tensors take the plain version; CUDA tensors launch
    the kernel, once per ``build.BATCH`` components."""
    fields = list(fields)
    if fields[0].device.type == "cpu":
        return fused_advection_tendency_plain(grid, scheme, fields)
    if not kernel_tendency_eligible(grid):
        raise ValueError(
            "the tendency kernel takes what the TPU kernel's eligible "
            "takes: a regular grid with periodic x and y, neither flat "
            "(the model takes the plain flux divergences elsewhere)")
    Hx, Hy, Hz = grid.H
    zmode = z_mode(grid)
    fam, K = scheme_code(scheme)
    why = bounded_refusal(grid, scheme, fields[0].dtype)
    if why is not None:
        raise NotImplementedError(why)
    if len(fields) < 3:
        raise ValueError("the tendency kernel takes u, v, w and the tracers")
    if min(Hx, Hy) < scheme.required_halo:
        raise ValueError(f"the tendency kernel needs Hx, Hy >= "
                         f"{scheme.required_halo}")
    if (Hz or zmode == Z_PERIODIC) and Hz < scheme.required_halo:
        raise ValueError(f"the padded layout needs Hz >= "
                         f"{scheme.required_halo}")
    check_tensors(grid, fields, grid.padded_shape)
    scode = smoothness_code(scheme, fields[0].dtype)
    table = coefficient_table(scheme)
    m = _metrics(grid)
    Nx, Ny, Nz = grid.N
    nc = len(fields)
    G = torch.empty((nc, Nx, Ny, Nz), dtype=fields[0].dtype,
                    device=fields[0].device)
    vel = build.pointers(fields[:3])
    plan = launch_plan(grid, scheme, G.dtype, nc)
    with torch.cuda.device(G.device):
        lib = build.library()
        for a, b, smem in plan["launches"]:
            if fam == BOUNDED_WENO_FAMILY:
                lo, hi = scheme.bounds
                build.check(lib.oc_advection_tendency_bounded(
                    K, _DTYPE_CODES[G.dtype], scode, vel,
                    build.pointers(fields[a:b]), b - a, a,
                    build.pointers(G[a:b].unbind(0)), Nx, Ny, Nz, Hx, Hy, Hz,
                    zmode, m["Ax"], m["Ay"], m["Az"], m["V"], lo, hi, table,
                    len(table), *plan["tile"], plan["threads"],
                    plan["blocks"], smem, build.stream_of(G)), lib)
            else:
                build.check(lib.oc_advection_tendency(
                    fam, K, _DTYPE_CODES[G.dtype], scode, vel,
                    build.pointers(fields[a:b]), b - a, a,
                    build.pointers(G[a:b].unbind(0)), Nx, Ny, Nz, Hx, Hy, Hz,
                    zmode, m["Ax"], m["Ay"], m["Az"], m["V"], table,
                    len(table), *plan["tile"], plan["threads"],
                    plan["blocks"], smem, build.stream_of(G)), lib)
            count_launch(fused_advection_tendency, scheme, zmode)
    return G


fused_advection_tendency.launches = 0
fused_advection_tendency.variant_launches = {}


# -- tendency only, under a device mesh ------------------------------------------

def shard_fused_advection(grid, scheme, fields):
    """#7 on one shard's resident block: the TPU kernel
    ``oceananigans_tpu/kernels/fused_advection.py``
    ``build_sharded_fused_advection`` (a ``shard_map`` around #6 with the
    ``ppermute`` halo exchange) as each shard of a model on a device mesh
    runs it: ``fused_advection_tendency`` (#6) on the shard's padded
    ``fields`` (u, v, w, tracers) on its local grid ``grid``, in either
    layout, with a bounded, periodic or flat z. The x and y halos must hold
    the neighbours' values: the shard's fill ends with the halo exchange.
    The shards' grids take the global spacing exactly, so every block cell
    sees the operands and metrics the serial kernel sees there and the
    result equals the serial kernel's bit for bit. Counts its launches on
    CUDA tensors (by scheme and z variant) in
    ``build_sharded_fused_advection``'s counters; a CPU block takes the
    plain version."""
    refuse_mesh_topology(grid)
    if fields[0].is_cuda:
        count_launch(build_sharded_fused_advection, scheme, z_mode(grid))
        return fused_advection_tendency(grid, scheme, fields)
    return fused_advection_tendency_plain(grid, scheme, fields)


def refuse_mesh_topology(grid):
    """#7 takes periodic (or connected) x and y on a regular grid: raise
    for the others (ROADMAP.md item 16b)."""
    if not grid.all_regular or grid.topology[:2] != (PERIODIC, PERIODIC):
        raise NotImplementedError(
            f"the sharded tendency on a {grid.topology} grid: "
            f"{MESH_TOPOLOGY_ITEM}")


def build_sharded_fused_advection(grid, scheme, mesh):
    """#7 over a whole device mesh, the JAX call shape: replaces the TPU
    kernel ``oceananigans_tpu/kernels/fused_advection.py``
    ``build_sharded_fused_advection`` (a ``shard_map`` around #6), on the
    padded layout or the z-compact one (``grid.H[2] == 0``), with a
    bounded, periodic or flat z.

    Returns ``sharded(blocks) -> G``: ``blocks`` holds each shard's list of
    padded fields [u, v, w, tracers...] (the blocks ``Distributed.scatter``
    cuts, resident on the shards' devices), in rank order. The call runs on
    the mesh's communicator what a model's shard runs: each shard
    (``parallel.distributed.mesh_shards``) exchanges its halos in place
    and calls ``shard_fused_advection`` on its grid. It returns the list of
    per-shard (nf, nlx, nly, nz) tendencies on the shards' devices."""
    return _build_sharded_tendency(grid, scheme, mesh, plain=False)


build_sharded_fused_advection.launches = 0
build_sharded_fused_advection.variant_launches = {}


def build_sharded_fused_advection_plain(grid, scheme, mesh):
    """Plain PyTorch version: the same shards through the plain exchange
    and ``fused_advection_tendency_plain``. Counts its calls on CUDA tensors
    in ``cuda_calls``."""
    return _build_sharded_tendency(grid, scheme, mesh, plain=True)


build_sharded_fused_advection_plain.cuda_calls = 0


def _build_sharded_tendency(grid, scheme, mesh, plain):
    refuse_mesh_topology(grid)
    shards = mesh_shards(grid, mesh)

    def shard_tendency(r, fields):
        sh = shards[r]
        sh.exchange(fields, plain=plain)
        if plain:
            return fused_advection_tendency_plain(sh.grid, scheme, fields)
        return shard_fused_advection(sh.grid, scheme, fields)

    def sharded(blocks):
        blocks = [list(b) for b in blocks]
        if plain and blocks[0][0].is_cuda:
            build_sharded_fused_advection_plain.cuda_calls += 1
        return mesh.communicator.run(lambda r: shard_tendency(r, blocks[r]))

    return sharded
