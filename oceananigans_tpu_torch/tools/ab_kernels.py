"""A/B timing of the advection-update kernel (#1), the z-compact tendency
kernel (#6), the shallow-water stage (#8) and the flagship step on the
card, for whichever copy of the package is on PYTHONPATH. Run it for two
copies in one call, in the order A, B, B, A, and compare the JSON lines:

    PYTHONPATH=<copy A> python oceananigans_tpu_torch/tools/ab_kernels.py A
    PYTHONPATH=<copy B> python oceananigans_tpu_torch/tools/ab_kernels.py B

CUDA-event medians, in ms, at the main paths' shapes:
- at 256³ float32 (H = (4, 4, 0)), WENO(5):
  - ``update3_corr_gm_ms``: #1 over u, v, w with G⁻ and the deferred
    correction (RK3 stages 2 and 3 of the flagship);
  - ``update3_stage1_ms``: #1 over u, v, w without either (stage 1);
  - ``update15_corr_gm_ms``: #1 with G⁻ and the correction over u, v, w and
    12 tracers;
  - ``update15_bf16_corr_gm_ms``: the same with bfloat16 smoothness;
  - ``update3_c2_corr_gm_ms``, ``update15_c2_corr_gm_ms``: the corrected
    G⁻ variant over 3 and 15 components with Centered(2);
  - ``tendency_compact4_ms``: the z-compact #6 over u, v, w and one tracer;
- ``sw_update_gm_ms``: #8's G⁻ variant at 16384² (16392² padded) float32,
  WENO(5), f = 0, no tracer;
and ``flagship_step_ms``, the median host-clock flagship RK3 step (10 steps
after 3 warm-up). Prints one JSON line, with the card's name.

    python oceananigans_tpu_torch/tools/ab_kernels.py sweep

times the block-tiled #1 and #8 of this copy under other launch plans: for
each float32 tile and thread count of ``ADV_SWEEP`` and ``SW_SWEEP`` (set
in the wrappers' ``UPDATE_TILES``/``UPDATE_THREADS`` and ``TILES``/
``THREADS`` for the call), the four #1 times above or #8's, one JSON line
each.
"""
import json
import statistics
import sys
import time

import numpy as np
import torch

import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K

# (float32 tile, threads a block) of the sweep
ADV_SWEEP = [((16, 8, 8), 256), ((8, 8, 16), 256), ((8, 8, 8), 256),
             ((8, 8, 8), 128), ((16, 16, 4), 256), ((32, 8, 4), 256)]
SW_SWEEP = [((32, 32), 256)]


def ev(fn, reps=10, warm=2):
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def advection(res, n=256):
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              halo=(4, 4, 0), dtype=torch.float32,
                              device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    f = [s * torch.randn(grid.padded_shape, generator=gen, device="cuda")
         for s in (0.1, 0.1, 0.1, 1e-3)]
    f[2][..., 0] = 0
    tr = {f"c{i}": torch.rand(grid.padded_shape, generator=gen, device="cuda")
          for i in range(12)}
    K.periodic_halo_fill(grid, f + list(tr.values()))
    u, v, w, p = f
    Gm = [torch.randn((n, n, n), generator=gen, device="cuda")
          for _ in range(15)]
    s = ot.WENO(5)
    bf16 = ot.WENO(5, smoothness_dtype=torch.bfloat16)
    res["update3_corr_gm_ms"] = ev(lambda: K.fused_advection_update(
        grid, s, u, v, w, Gm[:3], 0.1, -0.05, p, 0.07))
    res["update3_stage1_ms"] = ev(lambda: K.fused_advection_update(
        grid, s, u, v, w, None, 0.1, 0.0))
    res["update15_corr_gm_ms"] = ev(lambda: K.fused_advection_update(
        grid, s, u, v, w, Gm, 0.1, -0.05, p, 0.07, tracers=tr), reps=5)
    res["update15_bf16_corr_gm_ms"] = ev(lambda: K.fused_advection_update(
        grid, bf16, u, v, w, Gm, 0.1, -0.05, p, 0.07, tracers=tr), reps=5)
    c2 = ot.Centered(2)
    res["update3_c2_corr_gm_ms"] = ev(lambda: K.fused_advection_update(
        grid, c2, u, v, w, Gm[:3], 0.1, -0.05, p, 0.07))
    res["update15_c2_corr_gm_ms"] = ev(lambda: K.fused_advection_update(
        grid, c2, u, v, w, Gm, 0.1, -0.05, p, 0.07, tracers=tr), reps=5)
    res["tendency_compact4_ms"] = ev(lambda: K.fused_advection_tendency(
        grid, s, [u, v, w, tr["c0"]]))


def shallow_water(res, n=16384):
    grid = ot.RectilinearGrid(size=(n, n), extent=(1.0, 1.0), halo=(4, 4, 0),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(shape, scale, offset=0.0):
        return offset + scale * torch.randn(shape, generator=gen,
                                            device="cuda")

    shape = grid.padded_shape
    fields = dict(uh=randn(shape, 0.01), vh=randn(shape, 0.01),
                  h=randn(shape, 0.01, 1.0))
    hB = randn(shape, 0.01)
    K.periodic_halo_fill(grid, list(fields.values()) + [hB])
    Gm = randn((3,) + grid.N, 1.0)
    res["sw_update_gm_ms"] = ev(lambda: K.fused_sw_update(
        grid, ot.WENO(5), 9.81, 0.0, hB, ("uh", "vh", "h"), fields, Gm, 2e-5,
        -1e-5))


def flagship(res, n=256):
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              dtype=torch.float32, device="cuda")
    m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5))
    rng = np.random.default_rng(0)
    m.set(u=0.1 * rng.standard_normal((n, n, n)).astype(np.float32),
          v=0.1 * rng.standard_normal((n, n, n)).astype(np.float32))
    for _ in range(3):
        m.time_step(1e-4)
    torch.cuda.synchronize()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        m.time_step(1e-4)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    res["flagship_step_ms"] = statistics.median(ts) * 1e3


def sweep():
    from oceananigans_tpu_torch.kernels import fused_advection as fa
    from oceananigans_tpu_torch.kernels import fused_shallow_water as fsw
    dev = torch.cuda.get_device_name(0)
    for tile, threads in ADV_SWEEP:
        fa.UPDATE_TILES[4], fa.UPDATE_THREADS = tile, threads
        res = {"label": "sweep #1", "tile": tile, "threads": threads,
               "device": dev}
        advection(res)
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    for tile, threads in SW_SWEEP:
        fsw.TILES[4], fsw.THREADS = tile, threads
        res = {"label": "sweep #8", "tile": tile, "threads": threads,
               "device": dev}
        shallow_water(res)
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()


def main(label):
    if label == "sweep":
        return sweep()
    res = {"label": label, "package": ot.__file__,
           "device": torch.cuda.get_device_name(0)}
    for part in (advection, shallow_water, flagship):
        part(res)
        torch.cuda.empty_cache()
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "run")
