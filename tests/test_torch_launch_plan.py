"""The launch plans of the block-tiled CUDA kernels, on the CPU.

``kernels/fused_advection.py`` ``launch_plan`` (#1, the advection + RK3
update) and ``kernels/fused_shallow_water.py`` ``launch_plan`` (#8, the
shallow-water stage) give each launch's tile, block count, threads and
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
"""

import numpy as np
import pytest
import torch

import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.kernels import build
from oceananigans_tpu_torch.kernels import fused_advection as fa
from oceananigans_tpu_torch.kernels import fused_shallow_water as fsw

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
]


def _scheme(name):
    return {"weno5": lambda: ot.WENO(5),
            "weno5_bf16": lambda: ot.WENO(5, smoothness_dtype=torch.bfloat16),
            "centered2": lambda: ot.Centered(2)}[name]()


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
