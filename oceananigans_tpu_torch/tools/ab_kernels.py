"""A/B timing of the advection-update kernel (#1), the advection tendency
(#6, both layouts), the shallow-water stage (#8), the hydrostatic tendency
(#10) and five model steps on the card, for whichever copy of the package is
on PYTHONPATH. Run it for two copies in one call, in the order A, B, B, A,
and compare the JSON lines:

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
- ``tendency_padded4_ms``: the padded #6 over u, v, w and one tracer at 256³
  (262³ padded, H = 3, z halos filled), WENO(5), float32;
- ``sw_update_gm_ms``: #8's G⁻ variant at 16384² (16392² padded) float32,
  WENO(5), f = 0, no tracer;
- ``vi_hydro_ms``: #10 at bench_extra.py's hydro_row shapes (512x256x32
  lat-lon, H = 6, float32, WENOVectorInvariant(), spherical Coriolis, T),
  on the state after set() with w from continuity;
and the median host-clock steps (10 after 3 warm-up): ``flagship_step_ms``
(256³ RK3), ``convection_step_ms`` (256³ Rayleigh–Bénard: BuoyancyTracer,
ScalarDiffusivity, the padded layout), ``buoyant_step_ms`` (256³
BuoyancyTracer on the z-compact layout) and ``hydro_step_ms`` (the
hydro_row, quasi-AB2, split-explicit with 30 substeps, Δt = 120 s). Prints
one JSON line, with the card's name.

    python oceananigans_tpu_torch/tools/ab_kernels.py profile-vi

prints the device kernels one hydrostatic-tendency call launches, with
their median durations over 10 calls (torch.profiler), at the hydro_row
shapes, without and with ph.

    PYTHONPATH=<copy> python oceananigans_tpu_torch/tools/ab_kernels.py fill <label>

times the halo fills through the entry points every copy since the port
began has (``periodic_halo_fill``, ``fill_all_halo_regions``,
``fill_surface_halo_regions``), at the main paths' shapes: the flagship's
u, v, w, p (264x264x256, the wrap), the convection path's u, v, w, b (262³,
wrap and bounded z, b under Value conditions), the hydro_row's u, v, T, w
(524x268x44, bounded x, y and z) and its η, U, V surfaces, and the
shallow-water path's three 16392² fields; each as the device time of a
call behind a busy card (``*_ms``) and as the call from an idle card
(``*_call_ms``, host launch work included). Then the hydro_row's median
step, its device-busy share and its device kernels per step
(torch.profiler over 3 steps), and the convection step. One JSON line.

    PYTHONPATH=<copy> python oceananigans_tpu_torch/tools/ab_kernels.py vi <label>

times #10 alone at the hydro_row shapes (524x268x44 padded, float32), on
the state after set() with w from continuity, without and with a pₕ′:
five CUDA-event medians of 10 calls each (``vi_hydro_ms``,
``vi_hydro_ph_ms``), so that one run shows its own spread. One JSON line.

    PYTHONPATH=<copy> python oceananigans_tpu_torch/tools/ab_kernels.py nh-rows <label>

steps the nonhydrostatic rows A (triply periodic 256³, WENO(5), H = 3, u,
v, w from np.random.default_rng(0), float32) and B (two-dimensional
turbulence at 8192², WENO(5), a flat z, u, v from np.random.default_rng(0))
on the padded layout: for each, the median host-clock step (10 after 3
warm-up), the peak device memory over those steps, and the device-busy ms
and device kernels per step (torch.profiler over 3 steps). One JSON line.

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
from oceananigans_tpu_torch.boundary_conditions import (
    fill_all_halo_regions, fill_surface_halo_regions,
    regularize_field_boundary_conditions)

# (float32 tile, threads a block) of the sweep
ADV_SWEEP = [((16, 8, 8), 256), ((8, 8, 16), 256), ((8, 8, 8), 256),
             ((8, 8, 8), 128), ((16, 16, 4), 256), ((32, 8, 4), 256)]
SW_SWEEP = [((32, 32), 256)]


def convection_locs_bcs(grid):
    """(location, conditions) of the convection path's u, v, w, b."""
    b = ot.FieldBoundaryConditions(top=ot.ValueBoundaryCondition(-0.5),
                                   bottom=ot.ValueBoundaryCondition(0.5))
    locs = (("f", "c", "c"), ("c", "f", "c"), ("c", "c", "f"),
            ("c", "c", "c"))
    return [(loc, regularize_field_boundary_conditions(
        b if k == 3 else None, grid, loc)) for k, loc in enumerate(locs)]


def dev(fn, reps=20, warm=3):
    """Median CUDA-event time of one call with the card kept busy ahead of
    it (a spin of about 2 ms), so that the events time the device's work
    and not the host's launch."""
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


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
    del f, tr, Gm
    pgrid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                               halo=(3, 3, 3), dtype=torch.float32,
                               device="cuda")
    q = [s_ * torch.randn(pgrid.padded_shape, generator=gen, device="cuda")
         for s_ in (0.1, 0.1, 0.1, 1.0)]
    fill_all_halo_regions(q, pgrid, convection_locs_bcs(pgrid))
    res["tendency_padded4_ms"] = ev(lambda: K.fused_advection_tendency(
        pgrid, s, q))


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


def steps(model, dt, warm=3, timed=10):
    """Median host-clock step of ``model`` in ms."""
    for _ in range(warm):
        model.time_step(dt)
    torch.cuda.synchronize()
    ts = []
    for _ in range(timed):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def flagship(res, n=256):
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              dtype=torch.float32, device="cuda")
    m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5))
    rng = np.random.default_rng(0)
    m.set(u=0.1 * rng.standard_normal((n, n, n)).astype(np.float32),
          v=0.1 * rng.standard_normal((n, n, n)).astype(np.float32))
    res["flagship_step_ms"] = steps(m, 1e-4)


def convection(res, n=256):
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              dtype=torch.float32, device="cuda")
    b_bcs = ot.FieldBoundaryConditions(top=ot.ValueBoundaryCondition(-0.5),
                                       bottom=ot.ValueBoundaryCondition(0.5))
    m = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5), buoyancy=ot.BuoyancyTracer(),
        tracers=("b",), closure=ot.ScalarDiffusivity(nu=1e-4,
                                                     kappa={"b": 1e-4}),
        boundary_conditions={"b": b_bcs})
    m.set(b=lambda x, y, z: -z - 0.5, enforce_incompressibility=False)
    rng = np.random.default_rng(0)
    m.set(u=1e-3 * rng.standard_normal((n, n, n)))
    res["convection_step_ms"] = steps(m, 1e-3)


def buoyant(res, n=256):
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              dtype=torch.float32, device="cuda")
    m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5),
                               buoyancy=ot.BuoyancyTracer())
    rng = np.random.default_rng(42)
    N = (n, n, n)
    m.set(u=0.1 * rng.standard_normal(N).astype(np.float32),
          v=0.1 * rng.standard_normal(N).astype(np.float32),
          b=0.01 * rng.standard_normal(N).astype(np.float32))
    res["buoyant_step_ms"] = steps(m, 1e-3)


def hydro_model(N=(512, 256, 32)):
    grid = ot.LatitudeLongitudeGrid(size=N, longitude=(0, 60),
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    dtype=torch.float32, device="cuda")
    m = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.WENOVectorInvariant(),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=ot.SplitExplicitFreeSurface(substeps=30),
        tracers=("T",))
    rng = np.random.default_rng(0)
    m.set(u=0.05 * rng.standard_normal(N).astype(np.float32),
          T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi)
    return m


def vi_args(m, ph=None):
    fields = m._fill_all(dict(m.state["fields"]))
    w = m._w_from_continuity(fields["u"], fields["v"])
    return (m.grid, m.momentum_advection, m.tracer_advection, ("T",),
            m.coriolis, fields["u"], fields["v"], w, {"T": fields["T"]}, ph)


def hydrostatic(res):
    m = hydro_model()
    args = vi_args(m)
    res["vi_hydro_ms"] = ev(lambda: K.fused_vi_tendency(*args))
    del args
    res["hydro_step_ms"] = steps(m, 120.0)


def device_profile(model, dt, steps=3):
    """(busy ms, device kernels, device activities) per step of ``model``
    over ``steps`` steps (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.time_step(dt)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = sum(1 for e in events
                  if not e.name.startswith(("Memcpy", "Memset")))
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3 / steps, kernels / steps, len(events) / steps


def fill(res):
    def both(key, fn):
        res[key + "_ms"] = dev(fn)
        res[key + "_call_ms"] = ev(fn, reps=20)

    gen = torch.Generator(device="cuda").manual_seed(9)
    grid = ot.RectilinearGrid(size=(256, 256, 256), extent=(1.0, 1.0, 1.0),
                              halo=(4, 4, 0), dtype=torch.float32,
                              device="cuda")
    f = [torch.randn(grid.padded_shape, generator=gen, device="cuda")
         for _ in range(4)]
    both("fill_flagship", lambda: K.periodic_halo_fill(grid, f))
    pgrid = ot.RectilinearGrid(size=(256, 256, 256), extent=(1.0, 1.0, 1.0),
                               halo=(3, 3, 3), dtype=torch.float32,
                               device="cuda")
    q = [torch.randn(pgrid.padded_shape, generator=gen, device="cuda")
         for _ in range(4)]
    lb = convection_locs_bcs(pgrid)
    both("fill_convection", lambda: fill_all_halo_regions(q, pgrid, lb))
    del f, q
    m = hydro_model()
    fields = dict(m.state["fields"])
    names = ("u", "v", "T")
    hf = [fields[n].clone() for n in names] + [m.state["w"].clone()]
    hlb = [(m.loc(n), m.bcs[n]) for n in names + ("w",)]
    both("fill_hydro", lambda: fill_all_halo_regions(hf, m.grid, hlb))
    bt = m.state["barotropic"]
    sf = [fields["eta"].clone(), bt["U"].clone(), bt["V"].clone()]
    slb = [(("c", "c", "c"), m.bcs["eta"]), (("f", "c", "c"), m.bcs["u"]),
           (("c", "f", "c"), m.bcs["v"])]
    both("fill_surfaces", lambda: fill_surface_halo_regions(sf, m.grid, slb))
    del hf, sf
    res["hydro_step_ms"] = steps(m, 120.0)
    busy, kernels, acts = device_profile(m, 120.0)
    res["hydro_busy_share"] = busy / res["hydro_step_ms"]
    res["hydro_kernels_per_step"] = kernels
    res["hydro_device_activities_per_step"] = acts
    del m
    torch.cuda.empty_cache()
    sgrid = ot.RectilinearGrid(size=(16384, 16384), extent=(1.0, 1.0),
                               halo=(4, 4, 0),
                               topology=("periodic", "periodic", "flat"),
                               dtype=torch.float32, device="cuda")
    s3 = [torch.randn(sgrid.padded_shape, generator=gen, device="cuda")
          for _ in range(3)]
    both("fill_sw", lambda: K.periodic_halo_fill(sgrid, s3))
    del s3
    torch.cuda.empty_cache()
    convection(res)


def profile_vi():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m = hydro_model()
    print(f"device: {torch.cuda.get_device_name(0)}; package {ot.__file__}")
    for label, ph in (("no ph", None), ("ph", "ph")):
        args = vi_args(m)
        if ph:
            args = args[:-1] + (torch.randn_like(args[8]["T"]),)
        for _ in range(3):
            K.fused_vi_tendency(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                K.fused_vi_tendency(*args)
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per.setdefault(e.name[:70], []).append(
                    (e.time_range.end - e.time_range.start) / 1e3)
        for name, ts in sorted(per.items()):
            print(f"  {label}: {name}: {len(ts)} launches, median "
                  f"{statistics.median(ts):.4f} ms")
        print(f"  {label}: the whole call, CUDA events: "
              f"{ev(lambda: K.fused_vi_tendency(*args)):.4f} ms")


def sweep():
    from oceananigans_tpu_torch.kernels import fused_advection as fa
    from oceananigans_tpu_torch.kernels import fused_shallow_water as fsw
    dev = torch.cuda.get_device_name(0)
    for tile, threads in ADV_SWEEP:
        fa.UPDATE_TILES[4], fa.UPDATE_THREADS = (tile,), threads
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


def nh_row(row):
    rng = np.random.default_rng(0)
    if row == "A":
        n = 256
        grid = ot.RectilinearGrid(size=(n, n, n), extent=(2 * np.pi,) * 3,
                                  topology=("periodic",) * 3, halo=3,
                                  dtype=torch.float32, device="cuda")
        m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5))
        m.set(**{c: rng.standard_normal((n, n, n), dtype=np.float32)
                 for c in "uvw"})
        return m, 1e-3
    n = 8192
    grid = ot.RectilinearGrid(size=(n, n), x=(0, 2 * np.pi),
                              y=(0, 2 * np.pi),
                              topology=("periodic", "periodic", "flat"),
                              dtype=torch.float32, device="cuda")
    m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5))
    m.set(**{c: rng.standard_normal((n, n, 1), dtype=np.float32)
             for c in "uv"})
    return m, 5e-5


def nh_rows(res):
    for row in "AB":
        model, dt = nh_row(row)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res[f"row{row}_step_ms"] = steps(model, dt)
        res[f"row{row}_peak_GiB"] = (torch.cuda.max_memory_allocated()
                                     / 2 ** 30)
        busy, kernels, _ = device_profile(model, dt)
        res[f"row{row}_busy_ms"] = busy
        res[f"row{row}_kernels_per_step"] = kernels
        del model
        torch.cuda.empty_cache()


def vi_rounds(res, rounds=5):
    m = hydro_model()
    args = vi_args(m)
    ph_args = args[:-1] + (torch.randn_like(args[8]["T"]),)
    for key, a in (("vi_hydro_ms", args), ("vi_hydro_ph_ms", ph_args)):
        res[key] = [ev(lambda: K.fused_vi_tendency(*a)) for _ in range(rounds)]


def main(label):
    if label == "sweep":
        return sweep()
    if label == "vi":
        res = {"label": sys.argv[2] if len(sys.argv) > 2 else "vi",
               "package": ot.__file__,
               "device": torch.cuda.get_device_name(0)}
        vi_rounds(res)
        return print(json.dumps(res))
    if label == "nh-rows":
        res = {"label": sys.argv[2] if len(sys.argv) > 2 else "nh-rows",
               "package": ot.__file__,
               "device": torch.cuda.get_device_name(0)}
        nh_rows(res)
        return print(json.dumps(res))
    if label == "profile-vi":
        return profile_vi()
    if label == "fill":
        res = {"label": sys.argv[2] if len(sys.argv) > 2 else "fill",
               "package": ot.__file__,
               "device": torch.cuda.get_device_name(0)}
        fill(res)
        return print(json.dumps(res))
    res = {"label": label, "package": ot.__file__,
           "device": torch.cuda.get_device_name(0)}
    for part in (advection, shallow_water, hydrostatic, flagship, convection,
                 buoyant):
        part(res)
        torch.cuda.empty_cache()
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "run")
