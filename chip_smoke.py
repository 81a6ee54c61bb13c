"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. Device: require a CUDA card; print its name and `nvidia-smi`'s name and
   power limit.
2. Build: compile the port's CUDA kernels from the checkout's sources.
3. Kernels against their plain PyTorch versions on the card: each of the four
   kernels in float64 at 32³ and in float32 at the flagship's shapes (padded
   264x264x256, H = (4, 4, 0)), with the bound and its reason; CUDA-event
   times of kernel and plain version at the flagship's shapes.
4. Main path: NonhydrostaticModel on a 256³ grid, WENO(5), float32, RK3,
   set(u=, v=) from a seeded generator, warm-up steps and timed steps. Every
   kernel's launch counter must rise and no plain version may run on CUDA
   tensors; fields must be finite and the velocity divergence at roundoff.
5. Whole step, kernel path against plain path: 3 steps at 32³ in float64.

The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}. The script exits non-zero, without that line,
when no CUDA card is available.
"""

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {name}")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    return name, card


def build_phase():
    from oceananigans_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s)")


def cuda_ms(fn, reps=10, warmup=2):
    """Median CUDA-event time of one call of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want):
    """(max abs difference, that over max |want|) across paired tensors."""
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    return err, err / scale


def kernel_inputs(N, dtype, seed):
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import periodic_halo_fill
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=(4, 4, 0),
                              dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def field(scale):
        return scale * torch.randn(grid.padded_shape, generator=gen,
                                   dtype=dtype, device="cuda")

    u, v, w, p = field(0.1), field(0.1), field(0.1), field(1e-3)
    w[..., 0] = 0
    periodic_halo_fill(grid, [u, v, w, p])
    Gm = [torch.randn(N, generator=gen, dtype=dtype, device="cuda")
          for _ in range(3)]
    return grid, u, v, w, p, Gm


def kernels_phase():
    """Each kernel against its plain version. Bounds:
    - float64 at 32³: 1e-12 relative to max|plain| (the kernel contracts
      multiply-adds into FMAs and sums in another order; that is roundoff);
      the WENO smoothness runs in float64 there, so no float32 rounding of
      the indicators enters.
    - float32 at 256³: advection 2e-5 relative (float32 rounding with FMA
      contraction; the WENO weights square τ/(β+ε), so a one-ulp change in
      a float32 indicator moves a weight by a few ulp, and 256³ cells give
      the tail of that distribution); divergence and correction 1e-5
      relative (divergence of fields of size 0.1 with cancellation); the halo
      fill copies, so 0.
    Returns {kernel: dict(max_abs_err, ms, plain_ms)} at the flagship shapes.
    """
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K

    out = {}
    for N, dtype, sdt, bounds in (
            ((32, 32, 32), torch.float64, torch.float64,
             dict(adv=1e-12, div=1e-12, cor=1e-12)),
            ((256, 256, 256), torch.float32, torch.float32,
             dict(adv=2e-5, div=1e-5, cor=1e-5))):
        flagship = N[0] == 256
        grid, u, v, w, p, Gm = kernel_inputs(N, dtype, seed=1)
        scheme = ot.WENO(5, smoothness_dtype=sdt)
        gdt, zdt, cdt = 0.1, -0.05, 0.07
        worst_adv = 0.0
        for gm in (None, Gm):
            for pp in (None, p):
                args = (grid, scheme, u, v, w, gm, gdt, zdt, pp,
                        cdt if pp is not None else None)
                Gk, nk = K.fused_advection_update(*args)
                Gp, np_ = K.fused_advection_update_plain(*args)
                err, rel = max_err(Gk + [nk[c] for c in "uvw"],
                                   Gp + [np_[c] for c in "uvw"])
                print(f"  fused_advection_update {N} {dtype} Gm={gm is not None}"
                      f" corr={pp is not None}: max abs {err:.3e}, rel {rel:.3e}")
                assert rel <= bounds["adv"], ("fused_advection_update", N, rel)
                worst_adv = max(worst_adv, err)
        rk = K.fused_divergence(grid, u, v, w, 3.0)
        rp = K.fused_divergence_plain(grid, u, v, w, 3.0)
        err_div, rel = max_err(rk, rp)
        print(f"  fused_divergence {N} {dtype}: max abs {err_div:.3e}, rel {rel:.3e}")
        assert rel <= bounds["div"], ("fused_divergence", N, rel)
        ck = K.fused_correct(grid, p, u, v, w, 0.2)
        cp = K.fused_correct_plain(grid, p, u, v, w, 0.2)
        err_cor, rel = max_err(list(ck), list(cp))
        print(f"  fused_correct {N} {dtype}: max abs {err_cor:.3e}, rel {rel:.3e}")
        assert rel <= bounds["cor"], ("fused_correct", N, rel)
        a = torch.randn(grid.padded_shape, dtype=dtype, device="cuda")
        b = a.clone()
        K.periodic_halo_fill(grid, [a])
        K.periodic_halo_fill_plain(grid, [b])
        err_fill = (a - b).abs().max().item()
        print(f"  periodic_halo_fill {N} {dtype}: max abs {err_fill:.3e}")
        assert err_fill == 0.0, ("periodic_halo_fill", N, err_fill)
        torch.cuda.synchronize()
        if not flagship:
            continue
        # times at the flagship shapes: the corrected Gm variant (stages 2-3)
        adv = (grid, scheme, u, v, w, Gm, gdt, zdt, p, cdt)
        fields4 = [u.clone(), v.clone(), w.clone(), p.clone()]
        timings = {
            "fused_advection_update": (
                lambda: K.fused_advection_update(*adv),
                lambda: K.fused_advection_update_plain(*adv), worst_adv),
            "fused_divergence": (
                lambda: K.fused_divergence(grid, u, v, w, 3.0),
                lambda: K.fused_divergence_plain(grid, u, v, w, 3.0), err_div),
            "fused_correct": (
                lambda: K.fused_correct(grid, p, u, v, w, 0.2),
                lambda: K.fused_correct_plain(grid, p, u, v, w, 0.2), err_cor),
            "periodic_halo_fill": (
                lambda: K.periodic_halo_fill(grid, fields4),
                lambda: K.periodic_halo_fill_plain(grid, fields4), err_fill),
        }
        for name, (kfn, pfn, err) in timings.items():
            ms = cuda_ms(kfn)
            plain_ms = cuda_ms(pfn, reps=5)
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            print(f"  time {name} at {grid.padded_shape}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
    return out


def bench_model(n, dtype, device, seed=0):
    """The flagship configuration (bench.py's recipe) on the port."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.models import NonhydrostaticModel
    rng = np.random.default_rng(seed)
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              topology=("periodic", "periodic", "bounded"),
                              dtype=dtype, device=device)
    model = NonhydrostaticModel(grid, advection=ot.WENO(5))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    model.set(u=0.1 * rng.standard_normal((n, n, n)).astype(npdt),
              v=0.1 * rng.standard_normal((n, n, n)).astype(npdt))
    return model


def main_path_phase(card):
    from oceananigans_tpu_torch import kernels as K
    n, dt = 256, 1e-4
    K.reset_counters()
    model = bench_model(n, torch.float32, "cuda")
    for _ in range(3):
        model.time_step(dt)
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain_cuda = K.counters()
    print(f"main path launches: {launches}; plain calls on CUDA: {plain_cuda}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the main path"
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    u, v, w = (model.state["fields"][c] for c in "uvw")
    p = model.state["pressure"]
    for name, a in (("u", u), ("v", v), ("w", w), ("p", p)):
        assert torch.isfinite(a).all().item(), f"{name} is not finite"
    div = K.fused_divergence_plain(model.grid, u, v, w, 1.0)
    umax = max(u.abs().max().item(), v.abs().max().item())
    div_rel = div.abs().max().item() * model.grid.dx(("c", "c", "c")) / umax
    print(f"max|div u|·Δx/max|u| after {model.iteration} steps: {div_rel:.3e}")
    assert div_rel < 1e-4, ("divergence not at roundoff", div_rel)
    step_ms = statistics.median(times) * 1e3
    print(f"main path: 256^3 WENO5 float32 RK3 step median {step_ms:.3f} ms "
          f"over {len(times)} steps (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}), {n ** 3 / (step_ms / 1e3):.4e} "
          f"cell-updates/s [{card}]")
    rhs = K.fused_divergence(model.grid, u, v, w, 1.0)
    solve_ms = cuda_ms(lambda: model.pressure_solver.solve(rhs))
    print(f"pressure solve (torch.fft + DCT matmul) at 256^3: "
          f"{solve_ms:.4f} ms [{card}]")
    return launches, step_ms


@contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    import oceananigans_tpu_torch.models.nonhydrostatic as nh
    from oceananigans_tpu_torch import kernels as K
    swaps = [(nh, "fused_advection_update", K.fused_advection_update_plain),
             (nh, "fused_divergence", K.fused_divergence_plain),
             (nh, "fused_correct", K.fused_correct_plain),
             (nh, "periodic_halo_fill", K.periodic_halo_fill_plain),
             (hf, "periodic_halo_fill", K.periodic_halo_fill_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def whole_step_phase():
    """3 steps at 32³ float64 (float64 WENO smoothness) through the kernels
    and through the plain versions; bound 1e-12 relative to max|field|."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.models import NonhydrostaticModel

    def run():
        rng = np.random.default_rng(0)
        n = 32
        grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                                  dtype=torch.float64, device="cuda")
        m = NonhydrostaticModel(grid, advection=ot.WENO(
            5, smoothness_dtype=torch.float64))
        m.set(u=0.1 * rng.standard_normal((n, n, n)),
              v=0.1 * rng.standard_normal((n, n, n)))
        for _ in range(3):
            m.time_step(1e-3)
        return m

    mk = run()
    with plain_kernels():
        mp = run()
    for name in ("u", "v", "w", "p"):
        err, rel = max_err(mk.field(name).data, mp.field(name).data)
        print(f"  whole step {name}: max abs {err:.3e}, rel {rel:.3e}")
        assert rel <= 1e-12, ("whole step", name, rel)


KERNEL_SOURCES = {
    "fused_advection_update": (
        "oceananigans_tpu_torch/csrc/fused_advection.cu",
        "oceananigans_tpu/kernels/fused_advection.py:269"),
    "fused_divergence": (
        "oceananigans_tpu_torch/csrc/fused_projection.cu",
        "oceananigans_tpu/kernels/fused_projection.py:56"),
    "fused_correct": (
        "oceananigans_tpu_torch/csrc/fused_projection.cu",
        "oceananigans_tpu/kernels/fused_projection.py:160"),
    "periodic_halo_fill": (
        "oceananigans_tpu_torch/csrc/halo_fill.cu",
        "oceananigans_tpu/kernels/pallas_fill.py:265"),
}


def main():
    name, card = device_phase()
    build_phase()
    print("kernels against plain versions:")
    measured = kernels_phase()
    launches, _ = main_path_phase(card)
    print("whole step, kernels against plain versions:")
    whole_step_phase()
    rows = []
    for kname, (source, replaces) in KERNEL_SOURCES.items():
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=launches[kname],
                         **measured[kname]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
