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

Bound on the H100: the function reads each field, hB and G⁻ once and
writes G and the new fields, 40-52 B per interior cell and stage in
float32; it needs about 550 floating-point operations per cell (each face
flux and each derived velocity u = uh/ℑx(h) once), and at the card's own
rate for the WENO-5 body with exact divisions those take longer than the
bytes. Design (``csrc/sw_kernel.cuh``): one block per TX × TY tile
of interior cells, y fastest across threads; the block stages uh, vh, h and
hB with a ring of the scheme's reach plus one into shared memory, forms each
derived velocity and ½gh² once, each face flux once, then each cell's
update, and walks the launch's tracers with uh and vh resident.
``launch_plan`` gives the tile, the block count and the shared memory; the
C entry checks them. Division is exact. Schemes: those of the 3-D
advection kernels (``fused_advection.scheme_code``: Centered(2-12),
UpwindBiased(1-11), WENO(3-11); the periodic 2-D domain has no cascade),
the WENO smoothness in float32, float64 or (with float32 fields) bfloat16;
any other scheme raises on the card. A launch takes at most ``build.BATCH``
fields (their pointers ride in the kernel's parameter block); more fields
take one launch per batch, and since every field's result depends only on
its own values and uh, vh, h, the batching changes no bit of it.

``shard_fused_sw_update`` and ``build_sharded_fused_sw_update`` replace
``build_sharded_fused_sw_update`` (#9): the stage once per shard of a
device mesh, on the shard's resident blocks, whose halos come from the
mesh's halo exchange.
"""

from __future__ import annotations

import torch

from ..advection.fluxes import BOUNDED_REFUSAL
from ..advection.shallow_water import conservative_tendencies
from ..coriolis import FPlane, constant_f
from ..grids.topology import PERIODIC
from ..parallel.distributed import cut_block, mesh_shards
from ..timesteppers import stage_update
from . import build
from .fused_advection import (coefficient_table, count_launch, scheme_code,
                             smoothness_code)
from .fused_projection import _DTYPE_CODES, _metrics, check_tensors

PROGNOSTIC = ("uh", "vh", "h")

# Threads a block (csrc/sw_kernel.cuh kThreads is the most it takes) and the
# tile of interior cells a block owns, by the fields' element size: at
# float32 a 32 x 32 tile takes 64.8 KB of shared memory at WENO(5) (three
# blocks an SM) and 79.1 KB at WENO(11) (two), at float64 a 16 x 32 tile
# 73.4 KB at WENO(5) and 96.5 KB at WENO(11).
THREADS = 256
TILES = {4: (32, 32), 8: (16, 32)}


def _align(n):
    """Elements rounded up to a multiple of four (csrc/tiles.cuh
    align_elems)."""
    return (n + 3) // 4 * 4


def smem_bytes(tile, reach, esize):
    """Dynamic shared memory of one block (csrc/sw_kernel.cuh Layout): five staged fields (uh, vh, h, hB, a tracer) over the tile and
    a ring of reach + 1, u and v over the tile and the reach, ½gh², and two
    x- and two y-flux arrays."""
    TX, TY = tile
    R = reach + 1
    staged = _align((TX + 2 * R) * (TY + 2 * R))
    derived = _align((TX + 2 * reach) * (TY + 2 * reach))
    head = _align((TX + 1) * (TY + 1))
    fx, fy = _align((TX + 1) * TY), _align(TX * (TY + 1))
    return esize * (5 * staged + 2 * derived + head + 2 * fx + 2 * fy)


def launch_plan(grid, scheme, dtype, n_fields):
    """The launches of ``fused_sw_update`` for ``n_fields`` fields of
    ``dtype`` on ``grid``: a dict with ``tile`` (TX, TY), ``tiles`` (along x
    and y; block n owns tile (n // tiles_y, n % tiles_y), cells
    [TX·tx, min(TX·(tx + 1), Nx)) × [TY·ty, min(TY·(ty + 1), Ny))),
    ``blocks``, ``threads``, ``smem`` (bytes) and ``batches``, the (first,
    stop) fields of each launch."""
    esize = torch.empty((), dtype=dtype).element_size()
    tile = TILES[esize]
    Nx, Ny = grid.N[0], grid.N[1]
    tiles = (-(-Nx // tile[0]), -(-Ny // tile[1]))
    return dict(tile=tile, tiles=tiles, blocks=tiles[0] * tiles[1],
                threads=THREADS,
                smem=smem_bytes(tile, scheme.required_halo, esize),
                batches=build.batches(n_fields))


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
    tensors take the plain version; CUDA tensors launch the kernel, once per
    ``build.BATCH`` fields."""
    names = tuple(names)
    q = [fields[n] for n in names]
    if q[0].device.type == "cpu":
        return fused_sw_update_plain(grid, scheme, g, f, hB, names, fields,
                                     Gm, gamma_dt, zeta_dt)
    if getattr(scheme, "bounds", None) is not None:
        raise NotImplementedError(BOUNDED_REFUSAL)
    fam, K = scheme_code(scheme)
    if not sw_eligible(grid):
        raise ValueError("the fused shallow-water stage takes a regular grid "
                         "with periodic x/y and a flat z")
    nf = len(names)
    if names[:3] != PROGNOSTIC:
        raise ValueError("the fused shallow-water stage takes uh, vh, h and "
                         "the tracers, in that order")
    req = scheme.required_halo + 1
    if min(grid.H[0], grid.H[1]) < req:
        raise ValueError(f"the kernel needs Hx, Hy >= {req}")
    check_tensors(grid, q + [hB], grid.padded_shape)
    Nx, Ny, _ = grid.N
    if Gm is not None:
        check_tensors(grid, [Gm], (nf, Nx, Ny, 1))
        if Gm.device != q[0].device:
            raise ValueError("Gm must be on the fields' device")
    scode = smoothness_code(scheme, q[0].dtype)
    table = coefficient_table(scheme)
    m = _metrics(grid)
    G = torch.empty((nf, Nx, Ny, 1), dtype=q[0].dtype, device=q[0].device)
    outs = [torch.empty_like(a) for a in q]
    prog = build.pointers(q[:3])
    plan = launch_plan(grid, scheme, G.dtype, nf)
    with torch.cuda.device(G.device):
        lib = build.library()
        for a, b in plan["batches"]:
            build.check(lib.oc_fused_sw_update(
                fam, K, _DTYPE_CODES[G.dtype], scode, prog,
                build.pointers(q[a:b]), build.pointers(outs[a:b]), b - a, a,
                build.ptr(hB), build.ptr(Gm), build.ptr(G), Nx, Ny,
                grid.H[0], grid.H[1], m["dx"], m["dy"], m["Ax"], m["Ay"],
                m["Az"], m["V"], float(g), float(f), float(gamma_dt),
                float(zeta_dt) if Gm is not None else 0.0, table, len(table),
                *plan["tile"], plan["threads"], plan["blocks"], plan["smem"],
                build.stream_of(G)), lib)
            count_launch(fused_sw_update, scheme)
    return G, dict(zip(names, outs))


fused_sw_update.launches = 0
fused_sw_update.variant_launches = {}


# -- under a device mesh -------------------------------------------------------

def shard_fused_sw_update(grid, scheme, g, f, hB, names, fields, Gm, gamma_dt,
                          zeta_dt):
    """#9 on one shard's resident blocks: the TPU kernel
    ``oceananigans_tpu/kernels/fused_shallow_water.py``
    ``build_sharded_fused_sw_update`` (a ``shard_map`` around #8) as each
    shard of a model on a device mesh runs it: ``fused_sw_update`` (#8) on
    the shard's padded ``fields`` and bathymetry block ``hB`` on its local
    grid ``grid``, whose x and y halos hold the neighbours' values (the
    shard's fill ends with the halo exchange). Returns ``(G, new)`` as
    ``fused_sw_update``: G is the shard's (nf, nlx, nly, 1) tendency, kept
    for the next stage. The shards' grids take the global Δx and Δy
    exactly, so with hB's halos the periodic images the stage equals the
    serial stage bit for bit. Counts its launches on CUDA tensors in
    ``build_sharded_fused_sw_update``'s counters; CPU blocks take the plain
    version."""
    if fields[names[0]].is_cuda:
        count_launch(build_sharded_fused_sw_update, scheme)
        return fused_sw_update(grid, scheme, g, f, hB, names, fields, Gm,
                               gamma_dt, zeta_dt)
    return fused_sw_update_plain(grid, scheme, g, f, hB, names, fields, Gm,
                                 gamma_dt, zeta_dt)


def build_sharded_fused_sw_update(grid, scheme, g, f, hB, names, mesh):
    """#9 over a whole device mesh, the JAX call shape: replaces the TPU
    kernel ``oceananigans_tpu/kernels/fused_shallow_water.py``
    ``build_sharded_fused_sw_update`` (a ``shard_map`` around #8).

    Returns ``fused_update(blocks, Gm, gamma_dt, zeta_dt) -> (G, new)``:
    ``blocks`` holds each shard's {name: padded block} (resident on its
    device, as ``Distributed.scatter`` cuts them), in rank order. The call
    runs on the mesh's communicator what a model's shard runs: each shard
    (``parallel.distributed.mesh_shards``) exchanges its halos in place
    (two launches of the exchange kernel for blocks on one card) and calls
    ``shard_fused_sw_update`` on its grid. ``G`` and ``new`` are the
    per-shard tendencies and new blocks, in rank order; ``Gm`` is the list
    of the previous stage's ``G``.

    ``hB`` is the global padded bathymetry. As in the JAX package, its
    blocks take their halos from the exchange, made once here: periodic
    images at the global edges, where the serial model reads the halos
    ``set_on_padded`` left (zero for an array). So the sharded stage equals
    the serial one only where hB's halos are periodic images, e.g. with no
    bathymetry (ROADMAP.md queue 3)."""
    return _build_sharded(grid, scheme, g, f, hB, names, mesh, plain=False)


build_sharded_fused_sw_update.launches = 0
build_sharded_fused_sw_update.variant_launches = {}


def build_sharded_fused_sw_update_plain(grid, scheme, g, f, hB, names, mesh):
    """Plain PyTorch version: the same shards through the plain exchange
    and ``fused_sw_update_plain``. Counts its calls on CUDA tensors in
    ``cuda_calls``."""
    return _build_sharded(grid, scheme, g, f, hB, names, mesh, plain=True)


build_sharded_fused_sw_update_plain.cuda_calls = 0


def sharded_bathymetry(shards, hB, plain=False):
    """The blocks of the global padded bathymetry ``hB`` on ``shards`` (a
    mesh's ``Shard``s in rank order), their halos exchanged once as JAX's
    #9 takes them."""
    comm = shards[0].comm
    S = comm.mesh.devices.shape
    H = shards[0].global_grid.H
    blocks = [cut_block(hB, H, S, *sh.index, sh.device) for sh in shards]
    comm.run(lambda r: shards[r].exchange([blocks[r]], plain=plain))
    return blocks


def _build_sharded(grid, scheme, g, f, hB, names, mesh, plain):
    names = tuple(names)
    if grid.topology[:2] != (PERIODIC, PERIODIC):
        raise NotImplementedError(
            f"the sharded stage on a {grid.topology} grid: ROADMAP.md queue "
            "1 item 16b")
    shards = mesh_shards(grid, mesh)
    hb = sharded_bathymetry(shards, hB, plain)
    kernel = fused_sw_update_plain if plain else shard_fused_sw_update

    def shard_stage(r, fields, Gm, gamma_dt, zeta_dt):
        sh = shards[r]
        sh.exchange([fields[n] for n in names], plain=plain)
        return kernel(sh.grid, scheme, g, f, hb[r], names, fields, Gm,
                      gamma_dt, zeta_dt)

    def fused_update(blocks, Gm, gamma_dt, zeta_dt):
        if plain and blocks[0][names[0]].is_cuda:
            build_sharded_fused_sw_update_plain.cuda_calls += 1
        out = mesh.communicator.run(lambda r: shard_stage(
            r, blocks[r], None if Gm is None else Gm[r], gamma_dt, zeta_dt))
        return [o[0] for o in out], [o[1] for o in out]

    return fused_update
