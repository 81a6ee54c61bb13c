"""The launch plans of the block-tiled CUDA kernels, on the CPU.

``kernels/fused_advection.py`` ``launch_plan`` (#1, the advection + RK3
update, and #6, the advection tendency, in either layout),
``kernels/fused_shallow_water.py`` ``launch_plan`` (#8, the shallow-water
stage) and ``kernels/fused_vector_invariant.py`` ``launch_plan`` (#10, the
hydrostatic tendency) give each launch's tile, block count, threads and
dynamic shared memory; the C entries recompute and check them. For every
configuration the port launches these kernels with, the plan must:
- keep a block's dynamic shared memory at or below the H100's 232,448 B,
  and at float32 let at least two blocks share an SM;
- cover every interior cell exactly once: along each axis the tiles
  [T·t, min(T·(t + 1), N)) partition [0, N), and the block index maps one
  to one onto the tile grid (the kernels' mapping, stated in the plans'
  docstrings);
- batch the components as ``build.batches`` does, with the tracer box's
  shared memory only in a launch that holds a tracer.
#10's tiles cover the interior plus, on a bounded x (y), u's (v's)
boundary-face row, each cell once; at float64 it takes a smaller tile than
at float32.
"""

import numpy as np
import pytest
import torch

import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.kernels import build
from oceananigans_tpu_torch.kernels import fused_advection as fa
from oceananigans_tpu_torch.kernels import fused_shallow_water as fsw
from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi

torch.set_num_threads(1)

MAX_SMEM = 232448
SM_SMEM = 233472          # shared memory of one SM, of which 1 KB a block is reserved
RESERVED = 1024

# (label, size, dtype, scheme, components): #1 as the port launches it
ADVECTION = [
    ("flagship", (256, 256, 256), torch.float32, "weno5", 3),
    ("12_tracer_weno5", (256, 256, 256), torch.float32, "weno5", 15),
    ("12_tracer_centered2", (256, 256, 256), torch.float32, "centered2", 15),
    ("40_components", (32, 32, 48), torch.float64, "weno5", 40),
    ("12_tracer_float64", (32, 32, 48), torch.float64, "centered2", 15),
    ("whole_step_float64", (32, 32, 32), torch.float64, "weno5", 3),
    ("golden_grid_thermal_bubble", (16, 16, 16), torch.float64, "centered2",
     4),
    ("golden_grid_rayleigh_benard", (16, 16, 8), torch.float64, "weno5", 4),
    ("bf16_smoothness", (256, 256, 256), torch.float32, "weno5_bf16", 15),
    ("tile_edges_small", (12, 10, 5), torch.float64, "weno5", 40),
    ("tile_edges_ragged", (37, 29, 19), torch.float64, "weno5", 15),
    # every reach (the tile follows it): the WENO(9) flagship, the checks'
    # shapes and every family
    ("weno9_flagship", (256, 256, 256), torch.float32, "weno9", 3),
    ("weno9_tracers", (256, 256, 256), torch.float32, "weno9", 5),
    ("weno9_bf16", (256, 256, 256), torch.float32, "weno9_bf16", 15),
    ("weno11", (256, 256, 256), torch.float32, "weno11", 3),
    ("weno11_tracers", (256, 256, 256), torch.float32, "weno11", 15),
    ("weno7", (256, 256, 256), torch.float32, "weno7", 3),
    ("weno7_tracers", (256, 256, 256), torch.float32, "weno7", 15),
    ("weno3", (256, 256, 256), torch.float32, "weno3", 3),
    ("centered4", (256, 256, 256), torch.float32, "centered4", 3),
    ("centered12_tracers", (70, 44, 36), torch.float32, "centered12", 5),
    ("upwind5", (256, 256, 256), torch.float32, "upwind5", 3),
    ("upwind1_float64", (70, 44, 36), torch.float64, "upwind1", 5),
    ("weno9_float64", (70, 44, 36), torch.float64, "weno9", 5),
    ("weno11_float64", (70, 44, 36), torch.float64, "weno11", 40),
    ("centered10_float64", (70, 44, 36), torch.float64, "centered10", 3),
]

# (label, size, dtype, scheme, fields): #8 as the port launches it
SHALLOW_WATER = [
    ("16384", (16384, 16384), torch.float32, "weno5", 3),
    ("8200_shard", (8200, 8200), torch.float32, "weno5", 3),
    ("4096", (4096, 4096), torch.float32, "weno5", 3),
    ("256_float64", (256, 256), torch.float64, "weno5", 4),
    ("256_centered2", (256, 256), torch.float64, "centered2", 4),
    ("256_12_tracers", (256, 256), torch.float64, "weno5", 15),
    ("256_bf16", (256, 256), torch.float32, "weno5_bf16", 4),
    ("tile_edges_45x61", (45, 61), torch.float64, "weno5", 36),
    ("tile_edges_9x130", (9, 130), torch.float64, "weno5", 4),
    ("16384_weno9", (16384, 16384), torch.float32, "weno9", 3),
    ("16384_weno11", (16384, 16384), torch.float32, "weno11", 3),
    ("256_upwind11_float64", (256, 256), torch.float64, "upwind11", 4),
    ("256_centered12_float64", (256, 256), torch.float64, "centered12", 4),
]


# (label, size, dtype, scheme, components, halo): #6 as the port launches it,
# padded (z halo) or z-compact, and on the shards of #7
TENDENCY = [
    ("convection", (256, 256, 256), torch.float32, "weno5", 4, (3, 3, 3)),
    ("convection_shard", (128, 128, 256), torch.float32, "weno5", 4,
     (3, 3, 3)),
    ("buoyant_compact", (256, 256, 256), torch.float32, "weno5", 4,
     (4, 4, 0)),
    ("buoyant_compact_shard", (128, 128, 256), torch.float32, "weno5", 4,
     (4, 4, 0)),
    ("bf16_padded", (256, 256, 256), torch.float32, "weno5_bf16", 4,
     (3, 3, 3)),
    ("golden_thermal_bubble", (16, 16, 16), torch.float64, "centered2", 4,
     (3, 3, 3)),
    ("golden_rayleigh_benard", (16, 16, 8), torch.float64, "weno5", 4,
     (3, 3, 3)),
    ("40_components_padded", (37, 29, 19), torch.float64, "weno5", 40,
     (3, 3, 3)),
    ("40_components_compact", (12, 10, 5), torch.float64, "weno5", 40,
     (4, 4, 0)),
    ("15_components_float32", (37, 29, 19), torch.float32, "weno5", 15,
     (4, 4, 0)),
    ("upwind5_convection", (256, 256, 256), torch.float32, "upwind5", 4,
     (3, 3, 3)),
    ("weno9_padded", (70, 44, 36), torch.float64, "weno9", 4, (5, 5, 5)),
    ("weno11_compact", (70, 44, 36), torch.float32, "weno11", 4,
     (6, 6, 0)),
    ("centered12_shard", (128, 128, 256), torch.float32, "centered12", 4,
     (6, 6, 0)),
]


def _scheme(name):
    if name.endswith("_bf16"):
        return ot.WENO(int(name[4:-5]), smoothness_dtype=torch.bfloat16)
    for family, cls in (("weno", ot.WENO), ("centered", ot.Centered),
                        ("upwind", ot.UpwindBiased)):
        if name.startswith(family):
            return cls(int(name[len(family):]))
    raise KeyError(name)


def _grid(size, dtype):
    if len(size) == 2:
        return ot.RectilinearGrid(size=size, extent=(1.0, 1.0),
                                  halo=(4, 4, 0),
                                  topology=("periodic", "periodic", "flat"),
                                  dtype=dtype, device="cpu")
    return ot.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                              halo=(4, 4, 0), dtype=dtype, device="cpu")


def _covers_once(N, tile, tiles, blocks):
    """The tiles along each axis partition the interior, and the blocks map
    one to one onto the tile grid (block n -> the row-major unravelling of
    n over ``tiles``, the last axis fastest)."""
    for n, t, nt in zip(N, tile, tiles):
        count = np.zeros(n, dtype=np.int64)
        for k in range(nt):
            start, stop = t * k, min(t * (k + 1), n)
            assert start < stop, "a tile without cells"
            count[start:stop] += 1
        assert (count == 1).all()
    assert blocks == int(np.prod(tiles))
    idx = np.unravel_index(np.arange(blocks), tiles)
    flat = np.ravel_multi_index(idx, tiles)
    assert np.array_equal(np.sort(flat), np.arange(blocks))


@pytest.mark.parametrize("label,size,dtype,scheme,nc", ADVECTION,
                         ids=[c[0] for c in ADVECTION])
def test_advection_plan(label, size, dtype, scheme, nc):
    grid = _grid(size, dtype)
    s = _scheme(scheme)
    plan = fa.launch_plan(grid, s, dtype, nc)
    _covers_once(grid.N, plan["tile"], plan["tiles"], plan["blocks"])
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 256
    assert np.prod(plan["tile"]) <= fa.CELLS_PER_THREAD * plan["threads"]
    esize = torch.empty((), dtype=dtype).element_size()
    batches = build.batches(nc)
    assert [(a, b) for a, b, _ in plan["launches"]] == batches
    for a, b, smem in plan["launches"]:
        assert smem <= MAX_SMEM
        assert smem == fa.smem_bytes(plan["tile"], s.required_halo, esize,
                                     b > 3)
        if dtype == torch.float32:
            assert SM_SMEM // (smem + RESERVED) >= 2


@pytest.mark.parametrize("label,size,dtype,scheme,nc,halo", TENDENCY,
                         ids=[c[0] for c in TENDENCY])
def test_tendency_plan(label, size, dtype, scheme, nc, halo):
    """#6 takes #1's plan: the same tile, blocks and layout, in both
    layouts."""
    grid = ot.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0), halo=halo,
                              dtype=dtype, device="cpu")
    s = _scheme(scheme)
    plan = fa.launch_plan(grid, s, dtype, nc)
    _covers_once(grid.N, plan["tile"], plan["tiles"], plan["blocks"])
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 256
    esize = torch.empty((), dtype=dtype).element_size()
    reach = s.required_halo
    assert plan["tile"] == fa.pick_tile(reach, esize, nc > 3)
    if reach <= 3:   # WENO(5)'s tiles, as before the tiles followed the reach
        assert plan["tile"] == fa.UPDATE_TILES[esize][0]
    assert [(a, b) for a, b, _ in plan["launches"]] == build.batches(nc)
    for a, b, smem in plan["launches"]:
        assert smem <= MAX_SMEM
        assert smem == fa.smem_bytes(plan["tile"], s.required_halo, esize,
                                     b > 3)
        if dtype == torch.float32:
            assert SM_SMEM // (smem + RESERVED) >= 2


def _vi_grid(kind, size, dtype, halo=(6, 6, 6)):
    if kind == "latlon_bounded_x":
        return ot.LatitudeLongitudeGrid(size=size, longitude=(0, 60),
                                        latitude=(15, 75), z=(-1800.0, 0.0),
                                        halo=halo, dtype=dtype, device="cpu")
    if kind == "latlon_periodic_x":
        return ot.LatitudeLongitudeGrid(size=size, longitude=(0, 360),
                                        latitude=(15, 75), z=(-1800.0, 0.0),
                                        halo=halo, dtype=dtype, device="cpu")
    topo = {"rect_bounded_xy": ("bounded", "bounded", "bounded"),
            "rect_periodic_xy": ("periodic", "periodic", "bounded")}[kind]
    return ot.RectilinearGrid(size=size, extent=(4e5, 2.4e5, 1800.0),
                              halo=halo, topology=topo, dtype=dtype,
                              device="cpu")


def _vi_scheme(name, dtype):
    return {"weno_vi": lambda: (ot.WENOVectorInvariant(smoothness_dtype=dtype),
                                ot.Centered(2)),
            "weno5_vi": lambda: (ot.WENOVectorInvariant(
                order=5, smoothness_dtype=dtype),
                                 ot.WENO(5, smoothness_dtype=dtype)),
            "weno_vi_md": lambda: (ot.WENOVectorInvariant(
                smoothness_dtype=dtype, multi_dimensional_stencil=True),
                ot.WENO(5, smoothness_dtype=dtype)),
            "vector_invariant": lambda: (ot.VectorInvariant(),
                                         ot.Centered(2))}[name]()


# (label, grid kind, size, dtype, configuration, tracers): #10 as the port
# launches it
VI = [
    ("hydro_row", "latlon_bounded_x", (512, 256, 32), torch.float32,
     "weno_vi", 1),
    ("hydro_row_periodic_x", "latlon_periodic_x", (512, 256, 32),
     torch.float32, "weno_vi", 1),
    ("hydro_row_float64", "latlon_bounded_x", (512, 256, 32), torch.float64,
     "weno_vi", 1),
    ("golden_hydrostatic_turbulence", "latlon_bounded_x", (16, 12, 4),
     torch.float64, "vector_invariant", 1),
    ("checks_16x12x8_weno5", "latlon_periodic_x", (16, 12, 8), torch.float64,
     "weno5_vi", 3),
    ("tile_edges_bounded_xy", "rect_bounded_xy", (19, 13, 11), torch.float64,
     "weno_vi", 8),
    ("tile_edges_small", "rect_bounded_xy", (9, 7, 7), torch.float64,
     "vector_invariant", 3),
    ("tile_edges_periodic", "rect_periodic_xy", (19, 13, 11), torch.float64,
     "weno_vi", 8),
    ("tile_edges_float32", "latlon_bounded_x", (37, 21, 13), torch.float32,
     "weno_vi", 1),
    # the multi-dimensional stencil: two more cells of reach and two
    # reconstruction buffers
    ("hydro_row_md", "latlon_bounded_x", (512, 256, 32), torch.float32,
     "weno_vi_md", 1),
    ("hydro_row_md_periodic_x", "latlon_periodic_x", (512, 256, 32),
     torch.float32, "weno_vi_md", 1),
    ("hydro_row_md_float64", "latlon_bounded_x", (512, 256, 32),
     torch.float64, "weno_vi_md", 1),
    ("tile_edges_md", "rect_bounded_xy", (19, 13, 11), torch.float64,
     "weno_vi_md", 8),
]


@pytest.mark.parametrize("label,kind,size,dtype,config,ntr", VI,
                         ids=[c[0] for c in VI])
def test_vi_plan(label, kind, size, dtype, config, ntr):
    grid = _vi_grid(kind, size, dtype)
    vi, ts = _vi_scheme(config, dtype)
    cfg = fvi.vi_config(grid, vi, ts, ntr, ot.FPlane(f=1e-4))
    plan = fvi.launch_plan(grid, cfg, dtype)
    bx = int(grid.topology[0] == "bounded")
    by = int(grid.topology[1] == "bounded")
    # the interior plus u's and v's boundary-face rows, each cell once
    region = (grid.N[0] + bx, grid.N[1] + by, grid.N[2])
    _covers_once(region, plan["tile"], plan["tiles"], plan["blocks"])
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 256
    assert plan["smem"] <= MAX_SMEM
    esize = torch.empty((), dtype=dtype).element_size()
    assert plan["smem"] == fvi.smem_bytes(plan["tile"], cfg, esize,
                                          *plan["rows"])
    kv = vi.vorticity_scheme.buffer if cfg["vort"] == fvi.VORT_SCHEME else 0
    assert plan["reach"][0] == max(kv, 3) + 1 + 2 * cfg["md"]
    if dtype == torch.float32:
        assert SM_SMEM // (plan["smem"] + RESERVED) >= 2
    else:
        # float64: a smaller tile than float32's, so the box fits
        assert np.prod(plan["tile"]) < np.prod(fvi.TILES[4])


@pytest.mark.parametrize("label,size,dtype,scheme,nf", SHALLOW_WATER,
                         ids=[c[0] for c in SHALLOW_WATER])
def test_shallow_water_plan(label, size, dtype, scheme, nf):
    grid = _grid(size, dtype)
    s = _scheme(scheme)
    plan = fsw.launch_plan(grid, s, dtype, nf)
    _covers_once(grid.N[:2], plan["tile"], plan["tiles"], plan["blocks"])
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 256
    assert plan["smem"] <= MAX_SMEM
    if dtype == torch.float32:
        assert SM_SMEM // (plan["smem"] + RESERVED) >= 2
    assert plan["batches"] == build.batches(nf)


def test_smem_bytes_by_hand():
    """The layouts' totals at the chosen tiles, counted by hand: #1 float32
    16x8x8 with WENO(5)'s reach 3 (u, v, w over 22x14x14 = 4312 cells, two
    tracer boxes over 22x14x16 = 4928; fluxes 17x8x8 + 16x9x8 + 16x8x9 =
    3392), #8 float32 32x32 with a ring of 4 (five staged 40x40 fields, u
    and v over 38x38, ½gh² over 33x33 = 1089 rounded to 1092, four flux
    arrays of 1056)."""
    assert fa.smem_bytes((16, 8, 8), 3, 4, True) == 4 * (3 * 4312 + 2 * 4928
                                                        + 3392)
    assert fa.smem_bytes((16, 8, 8), 3, 4, False) == 4 * (3 * 4312 + 3392)
    assert fsw.smem_bytes((32, 32), 3, 4) == 4 * (5 * 1600 + 2 * 1444 + 1092
                                                 + 4 * 1056)


def test_smem_bytes_by_reach_by_hand():
    """The tiles the reach picks, counted by hand: WENO(9) (reach 5) over u,
    v, w alone at float32 keeps 16x8x8 (boxes of 26x18x18 = 8424 cells,
    fluxes 3392; 114,656 B, two blocks an SM); with tracers it takes 8x8x4
    (boxes of 18x18x14 = 4536, tracer boxes z-extended by 8 each way:
    18x18x20 = 6480; fluxes 9x8x4 + 8x9x4 + 8x8x5 = 896); WENO(11) (reach 6)
    at float64 with tracers takes 4x8x4 (boxes 16x20x16 = 5120, tracer
    boxes 16x20x20 = 6400, fluxes 5x8x4 + 4x9x4 + 4x8x5 = 464)."""
    assert fa.pick_tile(5, 4, False) == (16, 8, 8)
    assert fa.smem_bytes((16, 8, 8), 5, 4, False) == 4 * (3 * 8424 + 3392)
    assert fa.pick_tile(5, 4, True) == (8, 8, 4)
    assert fa.smem_bytes((8, 8, 4), 5, 4, True) == 4 * (3 * 4536 + 2 * 6480
                                                       + 896)
    assert fa.pick_tile(6, 8, True) == (4, 8, 4)
    assert fa.smem_bytes((4, 8, 4), 6, 8, True) == 8 * (3 * 5120 + 2 * 6400
                                                       + 464)


def test_vi_smem_bytes_by_hand():
    """#10's layout at float32 16x8x8 with WENO-9 vorticity (reach 6): u
    and v over 28x20x8 = 4480 cells, two per-cell sums of 1024, the 18
    metric and Coriolis rows over 20 y and the 4 z columns over the 9 z
    faces; the work buffer's largest phase, three derived fields of 4480 (w
    over 19x11x9 = 1881, rounded to 1884, the two z-flux arrays 2 x 16x8x9
    and two derived fields need 13148); at float64 8x8x8 (u and v over
    20x20x8 = 3200, sums of 512, work 3 x 3200)."""
    cfg = dict(R=6, Rw=2, Rz=3, Rc=3)
    assert fvi.smem_bytes((16, 8, 8), cfg, 4) == 4 * (2 * 4480 + 2 * 1024
                                                     + 360 + 36 + 3 * 4480)
    assert fvi.smem_bytes((8, 8, 8), cfg, 8) == 8 * (2 * 3200 + 2 * 512 + 360
                                                    + 36 + 3 * 3200)


def test_vi_md_smem_bytes_by_hand():
    """#10 with the multi-dimensional stencil at float32 8x8x8, WENO-9
    vorticity (reach 6 + 2 = 8): u and v over 24x24x8 = 4608 cells, sums of
    512, the 18 rows over 24 y and the z columns (36); the largest phase
    holds three derived fields and two reconstruction buffers of
    (8 + 4)(8 + 4)8 = 1152. Two blocks share an SM; the 16x8x8 tile would
    not let them (148,304 B a block)."""
    cfg = dict(R=8, Rw=2, Rz=3, Rc=3, md=1)
    assert fvi.smem_bytes((8, 8, 8), cfg, 4) == 4 * (
        2 * 4608 + 2 * 512 + 432 + 36 + 3 * 4608 + 2 * 1152)
    assert fvi.smem_bytes((16, 8, 8), cfg, 4) == 148304
    assert SM_SMEM // (fvi.smem_bytes((8, 8, 8), cfg, 4) + RESERVED) >= 2
