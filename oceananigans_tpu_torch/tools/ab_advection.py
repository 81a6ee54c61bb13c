"""A/B timing of the z-compact advection kernels and the flagship step on
the card, for whichever copy of the package is on PYTHONPATH. Run it for
two copies in one call, in the order A, B, B, A, and compare the JSON lines:

    PYTHONPATH=<copy A> python oceananigans_tpu_torch/tools/ab_advection.py A
    PYTHONPATH=<copy B> python oceananigans_tpu_torch/tools/ab_advection.py B

At 256³ float32 (H = (4, 4, 0)), CUDA-event medians of:
- ``update3_corr_gm_ms``: #1 over u, v, w with G⁻ and the deferred
  correction (RK3 stages 2 and 3 of the flagship);
- ``update3_plain_stage1_ms``: #1 over u, v, w without either (stage 1);
- ``update15_corr_gm_ms``: #1 with G⁻ and the correction over u, v, w and 12
  tracers;
- ``tendency_compact4_ms``: the z-compact #6 over u, v, w and one tracer;
and ``flagship_step_ms``, the median host-clock flagship RK3 step (10 steps
after 3 warm-up). Prints one JSON line.
"""
import json
import statistics
import sys
import time

import numpy as np
import torch

import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K


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


def main(label):
    n = 256
    res = {"label": label, "package": ot.__file__,
           "device": torch.cuda.get_device_name(0)}
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
    res["update3_corr_gm_ms"] = ev(lambda: K.fused_advection_update(
        grid, s, u, v, w, Gm[:3], 0.1, -0.05, p, 0.07))
    res["update3_plain_stage1_ms"] = ev(lambda: K.fused_advection_update(
        grid, s, u, v, w, None, 0.1, 0.0))
    res["update15_corr_gm_ms"] = ev(lambda: K.fused_advection_update(
        grid, s, u, v, w, Gm, 0.1, -0.05, p, 0.07, tracers=tr), reps=5)
    res["tendency_compact4_ms"] = ev(lambda: K.fused_advection_tendency(
        grid, s, [u, v, w, tr["c0"]]))
    del f, tr, Gm, u, v, w, p
    torch.cuda.empty_cache()
    g2 = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                            dtype=torch.float32, device="cuda")
    m = ot.NonhydrostaticModel(g2, advection=ot.WENO(5))
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
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "run")
