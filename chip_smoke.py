"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. Device: require a CUDA card; print its name and `nvidia-smi`'s name and
   power limit.
2. Build: compile the port's CUDA kernels from the checkout's sources; for
   the block-tiled kernels (#1 and #6, one template; #8; #10) each
   instantiation's registers and spills from ptxas, and each launch plan's
   tile, shared memory per block and blocks per SM (the runtime's
   occupancy query).
3. Kernels against their plain PyTorch versions on the card, with the bound
   and its reason, and CUDA-event times of kernel and plain version at the
   main paths' shapes:
   - the flagship's four kernels in float64 at 32³ and in float32 at the
     flagship's shapes (padded 264x264x256, H = (4, 4, 0)); #1 timed in its
     corrected G⁻ variant (RK3 stages 2-3) and its uncorrected first-stage
     variant;
   - #1 in float64 at the tile edges: interiors (37, 29, 19) and (12, 10,
     5), with 3 and 40 components, each of the four variants;
   - the fill kernel (#4 and #5, one launch for every axis of a batch of
     fields) at the flagship's shapes (the periodic wrap of u, v, w, p),
     with the time of torch.nn.functional.pad(mode="circular");
   - the convection path's kernels: the advection tendency (float64 at 32³,
     float32 at 256³, H = (3, 3, 3)) and the fill on 262³ (every location
     under every condition combination in float64, 16 fields, and the
     path's own u, v, w, b in float32);
   - the advection tendency in float64 at the tile edges, both layouts, 4
     and 40 components, and the sharded tendency on a tile grid unlike the
     serial one (bit for bit).
4. Flagship path: NonhydrostaticModel on a 256³ grid, WENO(5), float32,
   RK3, set(u=, v=) from a seeded generator, warm-up steps and timed steps.
   Its kernels' launch counters must rise and no plain version may run on
   CUDA tensors; fields must be finite and the velocity divergence at
   roundoff. Then the device's busy share over 3 more steps
   (torch.profiler).
5. Convection path: Rayleigh–Bénard convection at 256³ (BuoyancyTracer,
   ScalarDiffusivity, Value conditions on b; the padded layout), float32,
   the same checks, and the phase shares of the step from CUDA events (its
   device-busy share after phase 14, on the same model).
6. The goldens of tests/test_regression.py (thermal bubble, Rayleigh–Bénard,
   hydrostatic turbulence and ocean_catke_windstress), rebuilt in the port,
   in float64 through the kernels, against tests/data/*.npz.
7. Shallow-water kernels against their plain versions: the fused
   shallow-water stage at 256² in float64 (WENO(5) and Centered(2), FPlane,
   bathymetry, a tracer; the first-stage and the G⁻ variants) and at 4096²
   in float32, the wrap on three 16392² fields; CUDA-event times at the
   shallow-water path's shapes; the stage in float64 at the tile edges
   (interiors (45, 61) and (9, 130), 0 and 33 tracers, f = 0 and 0.3).
8. Shallow-water path: ShallowWaterModel on a 16384² periodic grid,
   WENO(5), float32, RK3, Δt = 1e-5, h, uh, vh from a seeded generator
   (bench_extra.py's shallow-water row): warm-up and timed steps, launch
   counters (the kernel and the wrap three times per step, no plain version
   on CUDA tensors), finite fields, mass conservation, peak memory and the
   phase shares of the step from CUDA events.
9. Hydrostatic kernel against its plain version: the fused vector-invariant
   tendency in float64 at 16x12x8 lat-lon (bounded and periodic x; three
   vector-invariant configurations, with and without ph; every Coriolis
   branch; three tracers; regular RectilinearGrids), at the tile edges
   (ragged float64 tiles, bounded x and y, 3 and 8 tracers) and in float32
   at 512x256x32 on the hydro_row state and on the CATKE ocean row's (T,
   S, e, pₕ′ from SeawaterBuoyancy); CUDA-event times of kernel and plain
   version; the fill at the path's shapes (524x268x44: every location
   under every condition combination in float64, the path's u, v, T, w over
   all three axes and its η, U, V surfaces in float32, halos overwritten
   with noise first).
10. Hydrostatic path: HydrostaticFreeSurfaceModel with bench_extra.py's
   hydro_row at 512x256x32 lat-lon, float32 (WENOVectorInvariant,
   HydrostaticSphericalCoriolis, SplitExplicitFreeSurface(substeps=30), T,
   quasi-AB2, Δt = 120 s): warm-up and timed steps, launch counters (the
   kernel once per step, the fill kernel, no plain version on CUDA tensors:
   no plain fill of a bounded axis), finite fields, peak memory, the phase
   shares of the step from CUDA events, the device-busy share and the
   device kernels per step.
11. Whole step, kernel path against plain path: 3 steps in float64 of the
   flagship and of the convection configuration at 32³, of shallow water at
   128², of the hydro_row and of the flat-bottom CATKE ocean row at
   16x12x8 (quasi-AB2 and split RK3), of the LES row at 32³ (SmagorinskyLilly,
   AMD with Cb, Lilly's coefficient) and of its vertically implicit variant;
   one step of each physics module of the nonhydrostatic model at 32³
   (dynamic Smagorinsky with Lagrangian and (0, 1) averaging, AMD with
   conditions on νₑ and κₑ, a vertically implicit diffusivity with a
   function ν, SeawaterBuoyancy with TEOS-10, a tilted gravity, the non-traditional β-plane, forcing, Stokes drift, background fields,
   quasi-AB2, a closure tuple).
12. Mesh pieces against their plain versions, on Distributed(Partition(2,
   2)) naming the card four times: the halo exchange at both sharded paths'
   shapes (exact), over distinct cards when more than one is visible (peer
   copies; otherwise the script says that route did not run), and #9 and
   #7 on resident blocks in float64 at small size (shallow water 128² with
   bathymetry and a tracer, the convection tendency at 32³), kernel route
   against plain route.
13. Sharded shallow-water path: the 16384² step on that mesh, each shard's
   blocks resident on it, from the serial path's initial
   state scattered: launch counters (#9 and #8 once per shard and stage,
   the exchange twice per stage, no plain version on CUDA tensors), finite
   fields, mass conservation, step ms, peak memory against the state held,
   the busy share, device kernels a step and the exchange's share
   (torch.profiler), the fields against the serial model's after the same
   16 steps (bit for bit), and #9 against its plain route on the path's
   blocks in float32; then the device's busy share over 3 more steps of
   the serial model.
14. Sharded convection path: the 256³ step on that mesh, with the same
   checks (#7 and #6 once per shard and stage, the exchange at every
   fill), the divergence at roundoff, the fields against the serial
   model's within 1e-4 (the pencil solver rounds apart from the serial
   one: the serial model with the pencil as its solver, a twin, against
   the serial model shows it, and the sharded model against the twin
   within a tenth of that), and #7 against its plain route on the path's
   own blocks, bound
   relative to the size of the flux differences (the term scale).
15. The z-compact kernels with 12 tracers and the lifted caps against their
   plain versions in float64: #1 (WENO(5) and Centered(2), with and without
   G⁻ and the correction), #6 z-compact, #7 on z-compact blocks, #6 padded,
   #8 at 256², fills of 20 fields; a 12-tracer launch against 12 one-tracer
   launches (bit for bit).
16. Tracer-scaling path (bench_extra.py's row): 256³ float32, Centered(2)
   and WENO(5), each with 0 and 12 tracers: median step, the 12/0 ratio,
   launches per step, peak memory, phase shares, the divergence and tracer
   conservation; #1 over 15 components on the path's state in float32.
17. Buoyant z-compact path (tests/test_z_compact.py's model at 256³): the
   tendency route with #6 z-compact, the same checks and Σb conserved; #6
   z-compact on the path's state in float32 (its device-busy share after
   phase 18, on the same model).
18. The same path on the 2x2 mesh of the card from its initial state,
   resident blocks: #7 on z-compact blocks, the serial path's fields after
   the same steps within 1e-5 and the pencil twin as in 14, the profile,
   and #7 against its plain route
   on the path's blocks.
19. bfloat16 WENO smoothness (float32 fields): #6 padded at 256³ and #8 at
   256² with tracers against their plain versions, the bound held to a
   tenth of the bf16-vs-float32 difference; then bench_extra.py's
   weno5_bf16smooth tracer row (256³, 0 and 12 tracers, right after the
   WENO(5) row, from its initial state): median step, the 12/0 ratio, #1's
   share, peak memory, tracer drift, the divergence, the difference from
   the float32-smoothness run after the same steps, and #1 (3 and 15
   components) and the z-compact #6 on the row's states.
20. The vector-unit probes (#12): each probe kernel against its plain
   version, then the three entry points of oceananigans_tpu_torch/tools as
   a user runs them (the microbench and the mix also on a slab that fills
   every SM), with the card's float32 peak from its SM count and clock.
21. LES path (bench_extra.py's LES row, :259-289): 128³, WENO(5),
   BuoyancyTracer, float32, Δt = 1e-4, RK3, with SmagorinskyLilly() and then
   AnisotropicMinimumDissipation() (u and b from a seeded generator), and
   the same configuration with a vertically implicit
   VerticalScalarDiffusivity: warm-up and timed steps, launch counters (#6
   three times a step, the fill kernel, no plain version on CUDA tensors),
   finite fields, the divergence, Σb conserved, peak memory, the phase
   shares from CUDA events with the closure's share and the implicit
   solve's time, the device-busy share and the device kernels per step.
   The closures and the implicit solve are plain PyTorch (the JAX package
   computes them in XLA).
22. CATKE ocean row: the ocean_catke_windstress golden's configuration at
   the hydro_row's size (512x256x32 lat-lon, 0-60°E, 15-75°N, 1800 m,
   float32): WENOVectorInvariant, WENO(5) tracers, spherical Coriolis,
   SplitExplicitFreeSurface(cfl=0.7), linear SeawaterBuoyancy, CATKE, T
   and S, a wind stress and the quadratic bottom drag on u, Δt = 120 s;
   with a flat bottom (#10) and with an immersed ridge (the plain tendency,
   as in JAX): warm-up and timed steps, launch counters, finite fields, T
   conserved over the fluid cells, the solid cells zero, the cfl's substep
   count, the phase shares from CUDA events (#10 or the plain tendency,
   CATKE's diffusivities, the implicit solve, step_turbulence, the substep
   loop, the fills), the device-busy share, the device kernels per step
   and peak memory.
23. The run loop (every file in a temporary directory):
   (a) the flagship through ``Simulation.run``: the bare ``time_step``
   loop against ``Simulation.run`` without writers, alternated three times
   in the same call; then 20 steps from iteration 0 with
   ``TimeStepWizard(cfl=0.5)`` every 5 iterations, a progress callback,
   the default NaN check, a FieldWriter of the surface u and w on
   ``TimeInterval(5.5e-4)`` (it shrinks Δt), a FieldWriter of u on
   ``AveragedTimeInterval(1e-3, window=5e-4)``, a NetCDFWriter of a
   mid-depth slice of u and a Checkpointer every 10 iterations: the
   launch counters of #1-#4 rise in ``run()`` and no plain version runs
   on CUDA tensors, the files read back (the port's FieldTimeSeries,
   scipy) equal the state recorded at their iterations (the averages
   within 1e-6 of the recorded states' average), a second model picked up
   from the iteration-10 checkpoint with the first run's Δt sequence
   equals the first at iteration 20 bit for bit in every state tensor;
   each write's and checkpoint's time and bytes, the wizard's time a call,
   the run's wall time and peak memory. At 64³ a no-op tendency hook
   moves the model from #1 to #6 (counters), its 3 steps equal the
   hook-free tendency route bit for bit and the fused route within 1e-5.
   (b) the CATKE ocean row (flat bottom) through ``Simulation.run`` with
   ``reference_datetime``, a calendar ``stop_time`` (20 steps of 120 s),
   u's top stress from a FieldTimeSeries (4 snapshots of τx 6 h apart,
   written with this phase's FieldWriter) through
   ``FieldTimeSeriesBoundaryCondition``, the wizard capped at 120 s, a
   NetCDFWriter of the surface T, S and η and a Checkpointer: the series
   at a mid-snapshot time equals the hand-lerped snapshots bit for bit
   (and so does the condition's padded plane), #10 launches once a step
   and the fills rise, no plain version on CUDA tensors, T conserved over
   the fluid cells (1e-6), the NetCDF file equals the recorded state, the
   pickup from iteration 10 is bit for bit (the AB2 G⁻, the barotropic
   state and CATKE's e included); the writes' and checkpoint's times and
   bytes, the wizard's time, wall time and peak memory, then the loop
   against the bare step, alternated three times.

24. The global tripolar ocean: ``global_model`` at 360x170x32 float32
   (TripolarGrid with its poles at 70°E and 250°E, 55°N, 4000 m in 32
   exponentially stretched levels, an immersed array bottom with land
   around both poles and two meridional barriers, WENO vector-invariant
   momentum, WENO(5) T and S, linear SeawaterBuoyancy, CATKE, spherical
   Coriolis, SplitExplicitFreeSurface(cfl=0.7), a zonal wind stress and the
   quadratic drag; T from φ and z, random geographic u and v that set()
   rotates), Δt = 600 s: 3 warm-up and 20 timed steps with the counters
   (the fill kernel; the plain tendency, as in JAX), finite fields, T's
   content over the wet cells within 1e-6, step median/min/max, peak
   memory, the phase shares, the busy share and device kernels per step;
   the fill kernel with the FOLD codes against ``fill_halos_plain`` on the
   row's own state (u, v, w, T, S, e and η, U, V, noisy halos) bit for
   bit, timed, with bytes and sector floors; then a pole-to-pole
   360x180x32 lat-lon piece: 3 steps of 60 s, finite, and the POLAR codes
   against the plain fill (every location, and the piece's state), bit
   for bit.

25. Every scheme of the advection kernels (#1, #6, #8): Centered(2-12),
   UpwindBiased(1-11) and WENO(3-11), each with its near-wall cascade.
   Each of the 17 against its plain version at 70x44x36 (no tile divides
   x, y or z; both z walls; #8 at 70x44): #1's four variants, #6 z-compact
   and padded and #8 in float64 (bound 1e-12 relative), and #1, #6 in
   float32 within 2e-5 of each component's term scale, #8 within 1e-5;
   bf16 smoothness at WENO(7) and WENO(9) (#1 corrected, #6 padded, #8); #7
   and #9 with WENO(9) on the 2x2 mesh of the card, equal to the serial
   kernels bit for bit; the launch plans by reach (tile, shared memory,
   blocks per SM); CUDA-event times of #1 (corrected G⁻, u, v, w) and #6
   (padded, u, v, w, b) at 256³ for WENO(3, 7, 9, 11), UpwindBiased(3, 5)
   and Centered(4), and of #8 with WENO(9) at 16384², each beside its plain
   version and its bound; then the 256³ WENO(9) flagship (z-compact, #1
   with the deferred correction; 3 warm-up and 20 timed steps: the step
   median, min and max, the divergence, peak memory, the phase shares, the
   busy share and the device kernels per step) and the 256³
   UpwindBiased(5) convection row (the padded layout, 13 steps, Σb
   conserved to 1e-6, the same reports). Its wall time is printed.

26. Every configuration of the hydrostatic tendency #10 (the JAX kernel's
   coverage on lat-lon and rectilinear grids): #10 against its plain
   version in float64 at 16x12x8 (bound 1e-12 relative) on a stretched z
   (JAX's test grid and an ExponentialDiscretization) and a stretched y
   (a lat-lon grid with a latitude array, a RectilinearGrid), with
   WENOVectorInvariant(order=3, 5, 7, 9, 11), CROSS_AND_SELF,
   DEFAULT_STENCIL, an UpwindBiased and a Centered VI and mixed vertical,
   divergence and kinetic-energy schemes, the tracer schemes Centered(4,
   12), UpwindBiased(1, 3), WENO(7, 9, 11) and a per-axis
   FluxFormAdvection, 9, 17 and 40 tracers (two launches), and every
   Coriolis (none, FPlane, BetaPlane, ConstantCartesianCoriolis,
   NonTraditionalBetaPlane, both spherical forms); bf16 smoothness on
   float32 fields held as phase 19 holds #1; the tile edges at the new
   reaches (WENO(11) and CROSS_AND_SELF on a stretched y and z, 3 and 40
   tracers); then the 512x256x32 stretched-z CATKE ocean row (phase 22's
   row with ExponentialDiscretization(32, -1800, 0, scale=450) levels)
   under "auto": #10 against its plain version on the row's state (phase
   9's float32 bound), timed with its bound; 3 warm-up and 10 timed steps
   with the counters (#10 once a step in its k5_z variant, no plain
   tendency on CUDA tensors, the fill kernel), finite fields, T conserved,
   the step median, min and max, peak memory, the phase shares (CUDA
   events), the busy share and the device kernels per step; the same row
   with fused_tendencies=False (the plain route's step in the same call);
   and #10 alone with WENOVectorInvariant(order=9) and WENO(9) T on the
   hydro_row's 512x256x32 grid (reach 5 in every direction), checked and
   timed. Its wall time is printed.

27. The NonhydrostaticModel on every topology and one stretched axis: #6
   on a flat z (32x32x1) and a periodic z (32³) against its plain version
   in float64 for WENO(5), WENO(9), UpwindBiased(5) and Centered(2) with a
   tracer, and at the tile edges (45x37x1, 19x13x30; 1 and 37 tracers),
   1e-12; the fill against fill_halos_plain in float64 on (P, P, P), (P,
   Flat, P), (B, B, B), (B, P, B), (P, Flat, B) and (Flat, Flat, B), every
   location under every condition, bit for bit; each topology's model
   (those six, (P, P, Flat), (P, B, B), a stretched x and a stretched z) in
   float64 on the card against the same model on the CPU over 3 steps at
   1e-10. Then three rows in float32, each with 3 warm-up and 10 timed
   steps, the counters (#6 three times a step in its z variant, or not at
   all on row C; the fill kernel; no plain version on CUDA tensors), finite
   fields, max|∇·u|·Δx/max|u| < 1e-4, the step median, min and max, peak
   memory, the phase shares from CUDA events (#6 or the plain flux
   divergences, the pressure solve and its tridiagonal sweep, the fills,
   the rest), the busy share and device kernels per step, and the pressure
   residual of its grid in float64: row A, triply periodic 256³ (WENO(5),
   H = 3: #6 padded on a periodic z, the fill wrapping x, y and z, the 3-D
   FFT), with #6 on its state against the plain version within 2e-5 of the
   term scale and the fill on its u, v, w, p bit for bit, timed beside
   F.pad(mode="circular"); row B, two-dimensional turbulence 8192² (#6 on a
   flat z, the 2-D wrap, the 2-D FFT), the same checks; row C, the tilted
   bottom boundary layer at 2048x1x512 on the example's stretched z (the
   Fourier-tridiagonal solve, the plain flux divergences, the fill on a
   bounded z with a flat y, timed). Its wall time is printed.

28. The NonhydrostaticModel on immersed, multiply stretched and curvilinear
   grids with open and per-point conditions: the fill with planes and
   perturbation faces against its plain version, small CG and open models
   on the card against the CPU, the ``open_boundary_radiation`` golden, and
   rows D (the 2048×1×512 seamount) and E (the 256×256×128 hill) with the
   CG's iterations and residuals and float64 witnesses of their solves.

29. The rest of the single-grid hydrostatic model: seven small float64
   models on the card against the CPU over 3 steps at 1e-10 (rows F and
   G's constructions on z* and z, prescribed velocities under quasi-AB2
   and the split RK3, per-tracer schemes, the NonhydrostaticModel with
   the advective GM form), each with the fill kernel and no plain fill;
   then three float32 rows, each with 3 warm-up and 10 timed steps, the
   counters (the fill kernel; no plain fill; #10 once a step on row H),
   finite fields, the step median, min and max, peak memory, the phase
   shares from CUDA events (the tendency, the closure, z*'s σ work, the
   substep loop, the implicit solve, step_turbulence, the fills, the
   rest), the busy share and device kernels per step: row F,
   ``examples/near_global_ocean.py`` at 1° (360×180×24: CATKE, horizontal
   ν and triad GM/Redi on the immersed continents, split-explicit with 30
   substeps, Δt = 1800 s), with the fill against its plain version on its
   u, v, b, e, timed; row G, ``examples/internal_tide.py`` on z* at
   2048×1×512 (flux-form WENO(5), Δt = 30 s), the same; row H, the
   hydrostatic row with the multi-dimensional stencil (H = 8): #10's md
   variant against its plain version on the row's state (2e-5), timed with
   its bound, its launch plan, registers and blocks per SM. Its wall time
   is printed.

32. Resident blocks and the pencil solvers (item 16a), on a mesh that
   names cuda:0 four times: (a) the pencil solver on 4 slabs against the
   serial solvers, float64 at 64³ (DCT z) and 64×64×32 (stretched z)
   within 1e-12, float32 at 256³ and 256×256×128 against the serial
   float64 solve (1e-5; on the stretched z also 1.25 times the serial
   float32 solve's error; a bfloat16-input control reads above it), each
   solve timed beside the serial one,
   and its block entry on 2x2 resident blocks; (b) row A (triply periodic
   256³, WENO(5)) on 2x2 against the serial row over 3 steps (1e-5), #7's
   zperiodic launches, the profile and #7 against its plain route; (c) row
   E's hill on 2x2, float64 at 64×64×32 against serial (1e-10, both CGs at
   1e-13, 3 steps) and float32 at 128×128×64 (one step, each solve's
   iterations and residual); (d) an auxiliary-field forcing at 64³ whose
   host update reaches every shard. Its wall time is printed.

Fill times are CUDA events around one call behind a busy card (the device's
time, ``device_ms``), with the call from an idle card beside them (host
launch work included, as PR 9's were taken). The line before the last is
the JSON list of kernels; the last line is
{"ok": true, "device": {...}}. The script exits non-zero, without that line,
when no CUDA card is available.
"""

import ctypes
import datetime
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
from scipy.io import netcdf_file


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
          f"(nvcc {build.build_seconds:.1f} s; per source, from the start: "
          + ", ".join(f"{name} {sec:.1f} s" for name, sec in
                      sorted(build.source_seconds.items(),
                             key=lambda kv: -kv[1])) + ")")
    for line in build.compile_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    tiled_kernels_report()


def ptxas_entries(log, marks):
    """{kernel name: (registers, spill stores, spill loads)} of the entries
    of ptxas's -v report whose mangled name holds one of ``marks``."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if not any(m in name for m in marks):
                name = None
            spills = (0, 0)
        elif name and "spill stores" in line:
            w = line.replace(",", "").split()
            spills = (int(w[w.index("spill") - 2]),
                      int(w[w.index("loads") - 3]))
        elif name and "Used" in line and "registers" in line:
            w = line.replace(",", "").split()
            out[name] = (int(w[w.index("Used") + 1]), *spills)
            name = None
    return out


def demangle(names):
    """Demangled names by c++filt where it is installed, else the names."""
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True, check=True)
        return dict(zip(names, r.stdout.splitlines()))
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def tiled_kernels_report():
    """Registers and spills of each instantiation of the block-tiled #1 and
    #6 (one template), #8 and #10 (ptxas -v), and for each launch plan of
    the paths the tile, the dynamic shared memory per block and the blocks
    an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes

    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import build
    from oceananigans_tpu_torch.kernels import fused_advection as fa
    from oceananigans_tpu_torch.kernels import fused_shallow_water as fsw
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    entries = ptxas_entries(build.compile_log, ("advection_kernel",
                                                "sw_update_kernel",
                                                "vi_tendency_kernel",
                                                "vi_tendency_full_kernel"))
    names = demangle(list(entries))
    print("block-tiled kernels, ptxas (registers, spill stores / loads in "
          "bytes):")
    for mangled, (regs, st, ld) in entries.items():
        print(f"  {names[mangled][:110]}: {regs} registers, spills {st} / "
              f"{ld} B")
    lib = build.library()
    codes = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
    print("block-tiled kernels, launch plans (dynamic shared memory per "
          "block, blocks per SM):")
    kinds = {0: "#1 uncorrected", 1: "#1 corrected", 2: "#6 z-compact",
             3: "#6 padded"}
    for label, N, dt, sdt, nc, ks in (
            ("flagship 256^3 float32, 3 components", (256, 256, 256),
             torch.float32, torch.float32, 3, (0, 1)),
            ("256^3 float32, 15 components", (256, 256, 256),
             torch.float32, torch.float32, 15, (0, 1)),
            ("256^3 float32 bf16 smoothness, 15 components",
             (256, 256, 256), torch.float32, torch.bfloat16, 15, (0, 1)),
            ("32^3 float64, 15 components", (32, 32, 32), torch.float64,
             torch.float64, 15, (0, 1, 2, 3)),
            ("256^3 float32, u, v, w, b", (256, 256, 256), torch.float32,
             torch.float32, 4, (2, 3)),
            ("256^3 float32 bf16 smoothness, u, v, w, b", (256, 256, 256),
             torch.float32, torch.bfloat16, 4, (2, 3))):
        grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                                  halo=(4, 4, 0), dtype=dt, device="cuda")
        scheme = ot.WENO(5, smoothness_dtype=sdt)
        plan = fa.launch_plan(grid, scheme, dt, nc)
        for a, b, smem in plan["launches"]:
            for kind in ks:
                per_sm = ctypes.c_int(0)
                build.check(lib.oc_advection_blocks_per_sm(
                    *fa.scheme_code(scheme), codes[dt], codes[sdt], kind,
                    int(b > 3),
                    *plan["tile"], plan["threads"], smem,
                    ctypes.byref(per_sm)), lib)
                print(f"  {kinds[kind]} {label} (components {a}-{b - 1}): "
                      f"tile {plan['tile']}, {plan['threads']} threads, "
                      f"{plan['blocks']} blocks, {smem} B shared, "
                      f"{per_sm.value} blocks per SM")
    for label, n, dt, sdt in (
            ("#8 16384^2 float32", 16384, torch.float32, torch.float32),
            ("#8 256^2 float64", 256, torch.float64, torch.float64)):
        grid = ot.RectilinearGrid(size=(n, n), extent=(1.0, 1.0),
                                  halo=(4, 4, 0), topology=SW_TOPOLOGY,
                                  dtype=dt, device="cuda")
        plan = fsw.launch_plan(grid, ot.WENO(5), dt, 3)
        per_sm = ctypes.c_int(0)
        build.check(lib.oc_fused_sw_update_blocks_per_sm(
            *fa.scheme_code(ot.WENO(5)), codes[dt], codes[sdt],
            *plan["tile"], plan["threads"],
            plan["smem"], ctypes.byref(per_sm)), lib)
        print(f"  {label}: tile {plan['tile']}, {plan['threads']} threads, "
              f"{plan['blocks']} blocks, {plan['smem']} B shared, "
              f"{per_sm.value} blocks per SM")
    for label, dt in (("#10 hydro_row 512x256x32 float32", torch.float32),
                      ("#10 hydro_row 512x256x32 float64", torch.float64)):
        grid = ot.LatitudeLongitudeGrid(size=HYDRO_N, longitude=(0, 60),
                                        latitude=(15, 75), z=(-1800.0, 0.0),
                                        dtype=dt, device="cuda")
        vi = ot.WENOVectorInvariant(smoothness_dtype=dt)
        vi_plan_report(label, grid, vi, ot.Centered(2), 1,
                       ot.HydrostaticSphericalCoriolis())


def vi_plan_report(label, grid, vi, tracer_scheme, n_tracers, coriolis):
    """Print #10's launch plan for a configuration: its variant, tile,
    reaches, staged rows, shared memory and the blocks an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the plan."""
    import ctypes

    from oceananigans_tpu_torch.kernels import build
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    codes = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
    lib = build.library()
    cfg = fvi.vi_config(grid, vi, tracer_scheme, n_tracers, coriolis)
    plan = fvi.launch_plan(grid, cfg, grid.dtype)
    per_sm = ctypes.c_int(0)
    conf = fvi.conf_array(grid, cfg, plan, min(n_tracers, fvi.TRACER_BATCH),
                          False, True)
    build.check(lib.oc_vi_blocks_per_sm(
        codes[grid.dtype], codes[cfg["sdtype"]], conf, *plan["tile"],
        plan["threads"], plan["smem"], ctypes.byref(per_sm)), lib)
    print(f"  {label}: variant {fvi.variant_name(cfg)}, tile {plan['tile']}, "
          f"reach (R, Rw, Rz, Rc) {plan['reach']}, rows (y, z) "
          f"{plan['rows']}, {plan['threads']} threads, {plan['blocks']} "
          f"blocks, {plan['smem']} B shared, {per_sm.value} blocks per SM")
    return plan

def busy_share(label, model, dt, steps, step_ms, card):
    """The device's busy share over ``steps`` steady steps of ``model``: the
    union of the device activities' intervals on the card's timeline
    (torch.profiler), per step, over the median step time measured without
    the profiler (``step_ms``), and over the host-clock window of the
    profiled steps (which the profiler's host work lengthens). Returns the
    first share, or None (and says so) if the profiler shows no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.time_step(dt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"{label}: torch.profiler shows no device time; the phase "
              f"shares (CUDA events) stand for the busy share [{card}]")
        return None
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_ms = busy / 1e3 / steps
    share = busy_ms / step_ms
    kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    print(f"{label}: device kernels per step {kernels / steps:.1f} "
          f"(device activities {len(spans) / steps:.1f}, copies and sets "
          f"included) [{card}]")
    print(f"{label}: device busy {busy_ms:.4f} ms per step over {steps} "
          f"steps ({len(spans)} device activities, torch.profiler): "
          f"{share:.4f} of the {step_ms:.3f} ms median step, "
          f"{busy_ms * steps / wall_ms:.4f} of the profiled window "
          f"({wall_ms / steps:.3f} ms per step under the profiler) [{card}]")
    return share


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


def device_ms(fn, reps=10, warmup=2, sleep_cycles=4_000_000):
    """Median CUDA-event time of one call of ``fn`` in milliseconds with the
    card kept busy ahead of it (a spin of about 2 ms), so that the events
    time the call's device work and not the host's time to launch it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
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


def kernel_inputs(N, dtype, seed, halo=(4, 4, 0)):
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import periodic_halo_fill
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo,
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
    Returns {kernel: dict(max_abs_err, ms, plain_ms)} at the flagship shapes
    (the fill's entry also its call time, library time and bounds).
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
        }
        for name, (kfn, pfn, err) in timings.items():
            ms = cuda_ms(kfn)
            plain_ms = cuda_ms(pfn, reps=5)
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            print(f"  time {name} at {grid.padded_shape}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
        out["fill_halos"] = time_fill(
            "flagship u, v, w, p (the wrap)", grid, fields4, None, err_fill)
        out["fill_halos"]["library_ms"] = circular_pad_ms(grid, fields4)
        # the uncorrected first-stage variant beside the corrected one
        stage1 = (grid, scheme, u, v, w, None, gdt, zdt)
        ms = cuda_ms(lambda: K.fused_advection_update(*stage1))
        plain_ms = cuda_ms(lambda: K.fused_advection_update_plain(*stage1),
                           reps=5)
        print(f"  time fused_advection_update (uncorrected, first stage) at "
              f"{grid.padded_shape}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (corrected G⁻ variant "
              f"{out['fused_advection_update']['ms']:.4f} ms)")
    advection_tile_edge_checks()
    return out


ADVECTION_TILE_EDGES = ((37, 29, 19), (12, 10, 5))
SW_TILE_EDGES = (45, 61), (9, 130)


def advection_tile_edge_checks():
    """#1 against its plain version in float64 (WENO(5), float64
    smoothness) on interiors its 8x8x8 float64 tiles do not divide, one
    with an Nz so small that the WENO-5, WENO-3 and upwind cascade fills the
    column; 3 and 40 components (the 40 in two launches); all four
    variants. Bound 1e-12 relative to each tensor's own max|plain|."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    scheme = ot.WENO(5, smoothness_dtype=torch.float64)
    for N in ADVECTION_TILE_EDGES:
        for ntr in (0, 37):
            grid, (u, v, w), p, tracers, Gm = tracer_kernel_inputs(
                N, torch.float64, ntr, seed=30)
            worst = 0.0
            for gm in (None, Gm):
                for pp in (None, p):
                    args = (grid, scheme, u, v, w, gm, 0.1, -0.05, pp,
                            0.07 if pp is not None else None)
                    Gk, nk = K.fused_advection_update(*args, tracers=tracers)
                    Gp, np_ = K.fused_advection_update_plain(
                        *args, tracers=tracers)
                    err, rel = worst_rel(Gk + list(nk.values()),
                                         Gp + list(np_.values()))
                    assert rel <= 1e-12, ("fused_advection_update tile edges",
                                          N, ntr, gm is not None,
                                          pp is not None, rel)
                    worst = max(worst, rel)
            print(f"  fused_advection_update tile edges {N} float64, "
                  f"{3 + ntr} components, four variants: worst rel "
                  f"{worst:.3e}")
    torch.cuda.synchronize()


def tendency_tile_edge_checks():
    """#6 against its plain version in float64 (WENO(5) with float64
    smoothness, and Centered(2)) on the interiors its 8x8x8 float64 tiles
    do not divide, in both layouts (z-compact, and padded with H = 3 and
    its z halos filled), with 4 and 40 components (the 40 in two
    launches); bound 1e-12 relative to each tensor's own max|plain|. Then
    #7 on a 74x58x19 grid over 2x2 blocks of 37x29, whose tiles fall unlike
    the serial grid's: equal to the serial #6 bit for bit."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    ZF = K.ZFill

    def inputs(N, ntr, layout, seed):
        halo = (4, 4, 0) if layout == "compact" else (3, 3, 3)
        grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo,
                                  dtype=torch.float64, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        f = [0.1 * torch.randn(grid.padded_shape, generator=gen,
                               dtype=torch.float64, device="cuda")
             for _ in range(3)]
        f += [torch.rand(grid.padded_shape, generator=gen,
                         dtype=torch.float64, device="cuda")
              for _ in range(ntr)]
        K.periodic_halo_fill(grid, f)
        if layout == "compact":
            f[2][..., 0] = 0
        else:
            K.bounded_z_fill_plain(grid, f,
                                   [ZF(False, (0, 0.0), (0, 0.0))] * 2
                                   + [ZF(True, (1, 0.0), (1, 0.0))]
                                   + [ZF(False, (2, 0.5), (2, -0.5))] * ntr)
        return grid, f

    for layout in ("compact", "padded"):
        for N in ADVECTION_TILE_EDGES:
            worst = 0.0
            for ntr in (1, 37):
                grid, f = inputs(N, ntr, layout, 31)
                for s in (ot.WENO(5, smoothness_dtype=torch.float64),
                          ot.Centered(2)):
                    err, rel = worst_rel(
                        list(K.fused_advection_tendency(grid, s, f)),
                        list(K.fused_advection_tendency_plain(grid, s, f)))
                    assert rel <= 1e-12, ("fused_advection_tendency tile "
                                          "edges", layout, N, ntr, s, rel)
                    worst = max(worst, rel)
            print(f"  fused_advection_tendency tile edges {layout} {N} "
                  f"float64, 4 and 40 components, WENO(5) and Centered(2): "
                  f"worst rel {worst:.3e}")
        grid, f = inputs((74, 58, 19), 2, layout, 32)
        s = ot.WENO(5, smoothness_dtype=torch.float64)
        arch = card_mesh()
        G = stitch(K.build_sharded_fused_advection(grid, s, arch.mesh)(
            arch.scatter(f, grid.H)), MESH_SHAPE)
        assert torch.equal(G, K.fused_advection_tendency(grid, s, f)), \
            ("sharded tendency on another tile grid", layout)
        print(f"  sharded tendency {layout} 74x58x19 on 2x2 blocks of "
              f"37x29: equal to serial bit for bit")
    torch.cuda.synchronize()


def vi_tile_edge_checks(configs=None, tracer_counts=(3, 8), y=None, z=None,
                        label="two configurations"):
    """#10 against its plain version in float64 on interiors its 8x8x8
    float64 tiles do not divide, over the interior and the boundary-face
    rows: a bounded-x-and-y RectilinearGrid and a periodic-x one (FPlane,
    ph), by default WENOVectorInvariant() and VectorInvariant() with 3 and 8
    tracers on regular axes; ``configs`` ({label: (make VI, make tracer
    scheme)}), ``tracer_counts`` and stretched ``y`` and ``z`` face
    positions (19 and 12 cells) take others; bound 1e-12 relative to each
    output's own max|plain|."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    f64 = torch.float64
    configs = configs or {"WENOVectorInvariant()": (
        lambda: ot.WENOVectorInvariant(smoothness_dtype=f64),
        lambda: ot.WENO(5, smoothness_dtype=f64)),
        "VectorInvariant()": (ot.VectorInvariant, lambda: ot.Centered(2))}
    for N in ((19, 13, 11), (9, 7, 7)):
        for topo in (("bounded", "bounded", "bounded"),
                     ("periodic", "bounded", "bounded")):
            worst = 0.0
            for clabel, (mvi, mts) in configs.items():
                for ntr in tracer_counts:
                    names = tuple(f"c{i}" for i in range(ntr))
                    grid = ot.RectilinearGrid(
                        size=N, x=(0.0, 4e5),
                        y=(0.0, 2.4e5) if y is None else y(N[1]),
                        z=(-1800.0, 0.0) if z is None else z(N[2]),
                        halo=(7, 7, 7), topology=topo, dtype=f64,
                        device="cuda")
                    grid, f = hydro_kernel_inputs(None, seed=6, grid=grid,
                                                  tracers=names)
                    args = (grid, mvi(), mts(), names, ot.FPlane(f=1e-4),
                            f["u"], f["v"], f["w"], {n: f[n] for n in names},
                            f["ph"])
                    Gk = K.fused_vi_tendency(*args)
                    Gp = K.fused_vi_tendency_plain(*args)
                    err, rel = worst_rel(
                        [Gk[0], Gk[1]] + [Gk[2][n] for n in names],
                        [Gp[0], Gp[1]] + [Gp[2][n] for n in names])
                    assert rel <= 1e-12, ("fused_vi_tendency tile edges", N,
                                          topo, clabel, ntr, rel)
                    worst = max(worst, rel)
            print(f"  fused_vi_tendency tile edges {N} {topo[0]} x, bounded "
                  f"y float64, {label}, {tracer_counts} tracers: worst "
                  f"rel {worst:.3e}")
    torch.cuda.synchronize()


# -- bounds ---------------------------------------------------------------------
# The least time the card could take for a kernel's work: the larger of the
# bytes it must move (each input read once, each output written once) over
# 3.35 TB/s and its floating-point operations over 67 TFLOP/s (float32
# outside the tensor cores), the H100 SXM's published peaks at 700 W.

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Floating-point operations the function needs (an FMA counts 2), each face
# flux counted once: a face is shared by the two cells beside it, so a cell
# owns three face fluxes per component, one per axis (advection_flop). The
# near-wall cells with lower orders (2K of 256 z levels for a scheme of
# buffer K) are counted at the full cost. The block-tiled #1, #6 and #8
# compute each face flux once, and the faces on a tile's edge once more in
# the neighbouring block.
UPDATE_FLOP = 4          # γΔt·G + ζΔt·G⁻ added to q


def scheme_buffers(scheme):
    """(K, b): the scheme's buffer and that of its advecting velocity's
    Centered(2b) (b = K for Centered, max(K - 1, 1) for UpwindBiased and
    WENO)."""
    import oceananigans_tpu_torch as ot
    K = scheme.buffer
    return K, K if isinstance(scheme, ot.Centered) else max(K - 1, 1)


def recon_flop(scheme):
    """Operations of one advected value at the scheme's own buffer K: a
    WENO-(2K-1) reconstruction (weno_flop(K, 0)), a selected
    UpwindBiased(2K-1) value (2K-1 products, 2K-2 sums) or a selected
    Centered(2K) value (2K products, 2K-1 sums)."""
    import oceananigans_tpu_torch as ot
    K, _ = scheme_buffers(scheme)
    if isinstance(scheme, ot.WENO):
        return weno_flop(K, 0)
    cells = 2 * K if isinstance(scheme, ot.Centered) else 2 * K - 1
    return 2 * cells - 1


def advection_flop(scheme, n_momentum, n_tracers, flat_z=False):
    """Operations of the advective tendency per interior cell, each face flux
    counted once: a momentum component-cell takes a face flux per axis that
    is not flat (three; two on a flat z), each the Centered(2b)
    interpolation of A·q (2b products for A·q, 2b products and 2b - 1
    sums), the advected value (recon_flop) and the flux product, then the
    differences, sums, a division and a sign (2 per axis + 1); a tracer
    component-cell reads the face velocity (1 product for A·u) in place of
    the interpolation, and so does w on a flat z, whose interpolation along
    z is the identity. WENO(5): 3 x (11 + 85 + 1) + 7 = 298 and 3 x (1 +
    85 + 1) + 7 = 268; on a flat z 2 x 97 + 5 = 199 for u and v and 2 x 87
    + 5 = 179 for w."""
    _, b = scheme_buffers(scheme)
    recon = recon_flop(scheme)
    axes = 2 if flat_z else 3

    def cell(interp):
        return axes * (interp + recon + 1) + 2 * axes + 1

    n_interp = n_momentum - 1 if flat_z else n_momentum
    return (n_interp * cell(6 * b - 1)
            + (n_momentum - n_interp + n_tracers) * cell(1))


def bound(nbytes, flop):
    """(bound_ms, bound_by) for a kernel's compulsory bytes and operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flop = flop / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


# -- the fill kernel (#4 and #5) ---------------------------------------------------
# One launch fills every axis of a batch of fields. Its bound: the distinct
# slots it writes and the distinct slots it reads, each once, over 3.35
# TB/s; beside it the floor of the 32-byte DRAM sectors those slots lie in
# (a z end of a padded row is a few bytes of one or two sectors).

FILL_LOCS = (("c", "c", "c"), ("f", "c", "c"), ("c", "f", "c"),
             ("c", "c", "f"))
FILL_SIDES = ("west", "east", "south", "north", "bottom", "top")


def rotated_locs_bcs(n):
    """``n`` (location, conditions): the four locations, each under four
    rotations of Flux, Open, Value and Gradient over the six sides, with
    nonzero values: every condition combination the fill takes."""
    from oceananigans_tpu_torch.boundary_conditions import (
        BoundaryCondition, FieldBoundaryConditions)
    from oceananigans_tpu_torch.boundary_conditions import \
        boundary_condition as bcm
    classes = (bcm.FLUX, bcm.OPEN, bcm.VALUE, bcm.GRADIENT)
    return [(FILL_LOCS[k % 4], FieldBoundaryConditions(**{
        side: BoundaryCondition(classes[(s + (k // 4)) % 4],
                                0.1 * (s + 1) * (-1) ** s)
        for s, side in enumerate(FILL_SIDES)})) for k in range(n)]


def model_locs_bcs(model, names):
    """The (location, conditions) of a model's fields."""
    return [(model.loc(n), model.bcs[n]) for n in names]


def fill_check(label, grid, fields, locs_bcs, z=True, time_=0.0, dt=None):
    """The fill kernel against its plain version on copies of ``fields``
    (plane conditions at ``time_``, the perturbation-advection faces with
    ``dt``): every slot bit for bit, the copies, reflections and pins and
    the slots an extrapolation forms alike (the kernel rounds each
    operation of an extrapolation as the plain version does), each kind
    reported apart. Returns the max abs difference."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    from oceananigans_tpu_torch import kernels as K
    a = [f.clone() for f in fields]
    b = [f.clone() for f in fields]
    K.fill_halos(grid, a, locs_bcs, z=z, time=time_, dt=dt)
    K.fill_halos_plain(grid, b, locs_bcs, z=z, time=time_, dt=dt)
    masks = (hf.extrapolated_slots(grid, a[0].shape, locs_bcs, z)
             if locs_bcs is not None else [None] * len(a))
    err = copies = rel = 0.0
    for x, y, m in zip(a, b, masks):
        err = max(err, (x - y).abs().max().item())
        if m is None or not m.any():
            copies = max(copies, (x - y).abs().max().item())
            continue
        m = m.to(x.device)
        copies = max(copies, (x[~m] - y[~m]).abs().max().item())
        rel = max(rel, (x[m] - y[m]).abs().max().item()
                  / max(y.abs().max().item(), 1e-300))
    print(f"  fill_halos {label}: {len(a)} fields of {tuple(a[0].shape)} "
          f"{a[0].dtype}: copied slots max abs {copies:.3e} (bound 0), "
          f"extrapolated slots rel {rel:.3e} (bound 0)")
    assert copies == 0.0 and rel == 0.0, ("fill_halos", label, copies, rel)
    torch.cuda.synchronize()
    return err


def fill_sources(codes, N, H, P):
    """The source slot of each slot along one axis under the fill kernel's
    map (``map_at`` in csrc/halo_fill.cu); -1 for a pinned face."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    src = [hf.source_index(codes, N, H, n) for n in range(P)]
    return np.array([-1 if s is None else s for s in src])


def fold_columns(codes, geom, face_x, i, j, sx):
    """The x sources of written columns (i, j) after the tripolar fold: a
    fold row reads x reversed over the interior (rolled by one for an
    x-face field), the substituted last row of a field centred in y only
    in its eastern half."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    (Nx, Hx, _, _, _), (Ny, Hy, _, _, _) = geom[0], geom[1]
    high = codes[1][2]
    if high not in hf.FOLDS:
        return sx
    E = Hy + Ny
    i0 = sx - Hx
    fold = j >= E
    if high == hf.FOLD:
        fold = fold | ((j == E - 1) & (i0 >= Nx // 2))
    folded = (np.where(i0 == 0, 0, Nx - i0) if face_x else Nx - 1 - i0) + Hx
    return np.where(fold, folded, sx)


def fill_traffic(grid, shape, esize, locs_bcs=None, n=1, z=True, pa=False):
    """(bytes, sector bytes) of one fill: the distinct slots it writes and
    reads, and the 32-byte sectors they lie in, summed over the fields (the
    tripolar fold's columns read their folded sources; a column that reads
    itself writes its z ends only)."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    geom = hf.axis_geometry(grid, shape)
    PX, PY, PZ = (g[2] for g in geom)
    nbytes = sectors = 0
    lbs = locs_bcs if locs_bcs is not None else [None] * n
    for codes, lb in zip(hf.fill_codes(grid, shape, locs_bcs, n, z, pa=pa),
                         lbs):
        face_x = lb is not None and lb[0][0] == "f"
        (xlo, xhi), (ylo, yhi), (zlo, zhi) = (
            hf.kept_range(c, g[0], g[1], g[2]) for c, g in zip(codes, geom))
        sx, sy, sz = (fill_sources(c, g[0], g[1], g[2])
                      for c, g in zip(codes, geom))
        # the columns outside the kept x/y box, written whole
        ix, jy = np.r_[0:xlo, xhi:PX], np.r_[0:ylo, yhi:PY]
        inner = np.arange(xlo, xhi)
        i = np.concatenate([np.repeat(ix, PY), np.repeat(inner, len(jy))])
        j = np.concatenate([np.tile(np.arange(PY), len(ix)),
                            np.tile(jy, len(inner))])
        src_x = fold_columns(codes, geom, face_x, i, j, sx[i])
        ok = (src_x >= 0) & (sy[j] >= 0)
        self_read = ok & (src_x == i) & (sy[j] == j)
        kz = np.r_[0:zlo, zhi:PZ]
        whole = ~self_read
        writes = [((i[whole] * PY + j[whole]) * PZ)[:, None]
                  + np.arange(PZ)[None, :],
                  ((i[self_read] * PY + j[self_read]) * PZ)[:, None]
                  + kz[None, :]]
        src_cols = ((src_x * PY + sy[j]) * PZ)
        zs = sz[sz >= 0]
        reads = [src_cols[ok & whole][:, None] + zs[None, :],
                 src_cols[self_read][:, None] + sz[kz][sz[kz] >= 0][None, :]]
        # the z ends of the columns inside it
        if len(kz):
            cols = ((np.repeat(inner, yhi - ylo) * PY
                     + np.tile(np.arange(ylo, yhi), len(inner))) * PZ)
            moved = kz[sz[kz] != kz]
            writes.append(cols[:, None] + moved[None, :])
            zm = sz[moved]
            reads.append(cols[:, None] + zm[zm >= 0][None, :])
        w = np.unique(np.concatenate([x.ravel() for x in writes]))
        r = np.unique(np.concatenate([x.ravel() for x in reads]))
        nbytes += esize * (len(w) + len(r))
        sectors += (len(np.unique(w * esize // 32))
                    + len(np.unique(r * esize // 32)))
    return nbytes, 32 * sectors


def time_fill(label, grid, fields, locs_bcs, err, z=True, time_=0.0,
              dt=None):
    """The fill's device time (a call behind a busy card), its call time
    from an idle card, its plain version's time, and its byte bound with
    the sector floor beside it. A fill that reads planes (plane conditions
    at ``time_``, the perturbation-advection faces with ``dt``) forms them
    by plane operations before its launch: its kernel's own device time
    (torch.profiler) is then the kernel's, the whole call's beside it, and
    the bound counts each plane read once."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    from oceananigans_tpu_torch import kernels as K
    pa = dt is not None
    call = lambda: K.fill_halos(grid, fields, locs_bcs, z=z, time=time_,
                                dt=dt)
    ms = whole_ms = device_ms(call)
    call_ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: K.fill_halos_plain(
        grid, fields, locs_bcs, z=z, time=time_, dt=dt), reps=5)
    esize = fields[0].element_size()
    nbytes, sector_bytes = fill_traffic(grid, fields[0].shape, esize,
                                        locs_bcs, len(fields), z, pa=pa)
    plane_elems = 0
    if locs_bcs is not None:
        codes = hf.fill_codes(grid, fields[0].shape, locs_bcs, len(fields),
                              z, pa=pa)
        plane_elems = sum(hf._plane_size(fields[0].shape, ax)
                          for sides in hf.plane_sides(codes, locs_bcs)
                          for ax, _ in sides)
    how = ""
    if plane_elems:
        nbytes += esize * plane_elems
        kernel_ms = profiled_kernel_ms(call, "fill_halos_kernel")
        if kernel_ms is not None:
            ms = kernel_ms
        source = ("torch.profiler" if kernel_ms is not None
                  else "no profiler device time: the whole call")
        how = (f" ({source}; {plane_elems} plane values), the whole call "
               f"{whole_ms:.4f} ms behind a busy card")
    out = dict(max_abs_err=err, ms=ms, call_ms=call_ms, whole_ms=whole_ms,
               plain_ms=plain_ms, bound=bound(nbytes, 0),
               sector_ms=sector_bytes / HBM_BYTES_PER_S * 1e3)
    print(f"  time fill_halos {label} ({len(fields)} fields of "
          f"{tuple(fields[0].shape)}): kernel {ms:.4f} ms{how} (call from "
          f"an idle card {call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{out['bound'][0]:.4f} ms ({nbytes} bytes), sector floor "
          f"{out['sector_ms']:.4f} ms ({sector_bytes} bytes)")
    return out


def circular_pad_ms(grid, fields):
    """torch.nn.functional.pad(mode="circular") of the fields' interiors,
    stacked as channels: the one PyTorch call that computes a periodic x/y
    fill (out of place); checked against the filled fields."""
    import torch.nn.functional as F
    Hx, Hy, _ = grid.H
    x = torch.stack([f[grid.interior_slices] for f in fields])[None]
    pad = (0, 0, Hy, Hy, Hx, Hx)
    got = F.pad(x, pad, mode="circular")[0]
    assert all(torch.equal(g, f) for g, f in zip(got, fields)), \
        "circular pad differs from the filled fields"
    ms = device_ms(lambda: F.pad(x, pad, mode="circular"))
    print(f"  time torch.nn.functional.pad(mode='circular') of "
          f"{tuple(x.shape)}: {ms:.4f} ms")
    return ms


def flagship_bounds(N, H, esize, scheme=None):
    """Bounds of the flagship's four kernels at interior N, halo H, with the
    flagship's WENO(5) or ``scheme``."""
    import oceananigans_tpu_torch as ot
    scheme = scheme or ot.WENO(5)
    cells = N[0] * N[1] * N[2]
    padded = (N[0] + 2 * H[0]) * (N[1] + 2 * H[1]) * N[2]
    return {
        # corrected, G⁻ variant: read u, v, w, p padded and G⁻; write G, new
        "fused_advection_update": bound(
            esize * (4 * padded + 3 * cells + 3 * cells + 3 * padded),
            cells * (advection_flop(scheme, 3, 0) + 3 * UPDATE_FLOP)),
        # read u, v, w padded, write rhs; 3 differences, 3 products, 2 sums,
        # 1 product per cell
        "fused_divergence": bound(esize * (3 * padded + cells), 9 * cells),
        # read p, u, v, w, write u, v, w (padded); 3 x (difference, product,
        # difference) per cell
        "fused_correct": bound(esize * 7 * padded, 9 * cells),
    }


def convection_bounds(N, H, esize, n_tracers=1, scheme=None):
    """Bounds of the convection path's kernels at interior N, halo H, with
    the path's WENO(5) or ``scheme``."""
    import oceananigans_tpu_torch as ot
    scheme = scheme or ot.WENO(5)
    cells = N[0] * N[1] * N[2]
    PX, PY, PZ = (n + 2 * h for n, h in zip(N, H))
    padded = PX * PY * PZ
    nf = 3 + n_tracers
    return {
        "fused_advection_tendency": bound(
            esize * nf * (padded + cells),
            cells * advection_flop(scheme, 3, n_tracers)),
    }


# The fused shallow-water stage, per interior cell: the operations the
# function needs, each face flux and each derived velocity counted once (the
# kernel recomputes both, about twice as many). A momentum component has two
# face fluxes per cell, one per axis, each a Centered(2b) interpolation of a
# transport (2b products + 2b - 1 sums: 7 for WENO(5)'s Centered(4)), a
# metric product, the advected value (recon_flop: 85 for WENO(5)) and the
# flux product; one velocity u = uh/ℑx(h) (a sum, a product, a division:
# 3); then 2 differences, a sum and a division (4), the gravity head (4
# products, a difference, a division, a difference: 7), the bathymetry term
# (a sum, 3 products, 2 differences, a division: 7) and the Coriolis term (3
# sums, 4 products, a sum: 8): 2 x (7 + 1 + 85 + 1) + 3 + 26 = 217 at
# WENO(5). h: 4 products, 2 differences, a sum, 2 divisions, a negation, a
# product = 11. A tracer: the divergence of U (8) and two fluxes of (1 +
# the advected value + 1) plus 6.
SW_H_FLOP = 11


def sw_flop(scheme, n_tracers):
    """Operations of the fused shallow-water stage per interior cell, its
    stage update included (see above)."""
    _, b = scheme_buffers(scheme)
    recon = recon_flop(scheme)
    momentum = 2 * (4 * b - 1 + 1 + recon + 1) + 3 + 26
    tracer = 8 + 2 * (1 + recon + 1) + 6
    return (2 * momentum + SW_H_FLOP + n_tracers * tracer
            + (3 + n_tracers) * UPDATE_FLOP)


def sw_bounds(n, H, esize, n_tracers=0, scheme=None):
    """Bounds of the shallow-water path's stage at interior n², halo H: its
    G⁻ variant (stages 2 and 3), with the path's WENO(5) or ``scheme``."""
    import oceananigans_tpu_torch as ot
    scheme = scheme or ot.WENO(5)
    nf = 3 + n_tracers
    cells = n * n
    PX, PY = n + 2 * H[0], n + 2 * H[1]
    padded = PX * PY
    return {
        # read the fields, hB and G⁻; write G and the new fields
        "fused_sw_update": bound(
            esize * ((nf + 1) * padded + 2 * nf * cells + nf * padded),
            cells * sw_flop(scheme, n_tracers)),
    }


def convection_kernel_inputs(N, dtype, seed):
    """u, v, w, b on an H = (3, 3, 3) grid, halos filled by the plain
    versions (default conditions for u, v, w; b's Value conditions)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import ZFill
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=(3, 3, 3),
                              dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fields = [0.1 * torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                                device="cuda") for _ in range(4)]
    specs = [ZFill(False, (0, 0.0), (0, 0.0)), ZFill(False, (0, 0.0), (0, 0.0)),
             ZFill(True, (1, 0.0), (1, 0.0)), ZFill(False, (2, 0.5), (2, -0.5))]
    return grid, fields, specs


def convection_kernels_phase():
    """The convection path's kernels against their plain versions. Bounds:
    - advection tendency: float64 at 32³, 1e-12 relative to max|plain| (FMA
      contraction and another association order), for WENO(5) with float64
      smoothness and for Centered(2); float32 at 256³ with the default
      float32 smoothness, 2e-5 relative (the reasons of the update kernel's
      bound).
    - the fill (wrap and bounded z in one launch): bit for bit, the
      extrapolated (Value, Gradient) slots too (``fill_check``): every
      location under every
      condition combination (16 fields) in float64, and the path's own u,
      v, w, b (b under Value conditions) in float32.
    Returns {kernel: dict(max_abs_err, ms, plain_ms)} at the main path's
    shapes (256³ float32, H = (3, 3, 3), u, v, w and b)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.boundary_conditions import \
        regularize_field_boundary_conditions as reg

    out = {}
    for N, dtype, schemes, tols in (
            ((32, 32, 32), torch.float64,
             (ot.WENO(5, smoothness_dtype=torch.float64), ot.Centered(2)),
             dict(adv=1e-12)),
            ((256, 256, 256), torch.float32, (ot.WENO(5),),
             dict(adv=2e-5))):
        main = N[0] == 256
        grid, fields, specs = convection_kernel_inputs(N, dtype, seed=2)
        K.bounded_z_fill_plain(grid, fields, specs)
        K.periodic_halo_fill_plain(grid, fields)
        worst_adv = 0.0
        for scheme in schemes:
            Gk = K.fused_advection_tendency(grid, scheme, fields)
            Gp = K.fused_advection_tendency_plain(grid, scheme, fields)
            err, rel = max_err(list(Gk), list(Gp))
            print(f"  fused_advection_tendency {N} {dtype} {scheme!r}: "
                  f"max abs {err:.3e}, rel {rel:.3e}")
            assert rel <= tols["adv"], ("fused_advection_tendency", N, rel)
            worst_adv = max(worst_adv, err)
        torch.cuda.synchronize()
        if not main:
            continue
        scheme = schemes[0]
        ms = cuda_ms(lambda: K.fused_advection_tendency(grid, scheme, fields))
        plain_ms = cuda_ms(lambda: K.fused_advection_tendency_plain(
            grid, scheme, fields), reps=5)
        out["fused_advection_tendency"] = dict(max_abs_err=worst_adv, ms=ms,
                                               plain_ms=plain_ms)
        print(f"  time fused_advection_tendency at {grid.padded_shape} (4 "
              f"fields): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        del fields
        torch.cuda.empty_cache()
        # the fill on 262³: every condition combination in float64, then
        # the path's own fields and conditions in float32
        gen = torch.Generator(device="cuda").manual_seed(3)
        combos = rotated_locs_bcs(16)
        grid64 = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                                    halo=(3, 3, 3), dtype=torch.float64,
                                    device="cuda")
        fill_check("convection 262^3, every combination", grid64,
                   [torch.randn(grid.padded_shape, generator=gen,
                                dtype=torch.float64, device="cuda")
                    for _ in combos], combos)
        del grid64
        torch.cuda.empty_cache()
        b_bcs = ot.FieldBoundaryConditions(
            top=ot.ValueBoundaryCondition(-0.5),
            bottom=ot.ValueBoundaryCondition(0.5))
        locs = (("f", "c", "c"), ("c", "f", "c"), ("c", "c", "f"),
                ("c", "c", "c"))
        path = [(loc, reg(b_bcs if k == 3 else None, grid, loc))
                for k, loc in enumerate(locs)]
        fields = [torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                              device="cuda") for _ in path]
        err = fill_check("convection u, v, w, b", grid, fields, path)
        out["fill_halos_convection"] = time_fill(
            "convection u, v, w, b (wrap + bounded z)", grid, fields, path,
            err)
    tendency_tile_edge_checks()
    return out


def bench_model(n, dtype, device, seed=0, scheme=None):
    """The flagship configuration (bench.py's recipe) on the port, with its
    WENO(5) or ``scheme``."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.models import NonhydrostaticModel
    rng = np.random.default_rng(seed)
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              topology=("periodic", "periodic", "bounded"),
                              dtype=dtype, device=device)
    model = NonhydrostaticModel(grid, advection=scheme or ot.WENO(5))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    model.set(u=0.1 * rng.standard_normal((n, n, n)).astype(npdt),
              v=0.1 * rng.standard_normal((n, n, n)).astype(npdt))
    return model


def convection_model(N, dtype, device, smoothness=torch.float32, seed=0,
                     architecture=None, state=None, scheme=None,
                     pressure_solver=None):
    """Rayleigh–Bénard convection, the convection path's configuration
    (tests/test_regression.py rayleigh_benard_model at full width): extent
    1x1x1, WENO(5) (or ``scheme``), BuoyancyTracer, ScalarDiffusivity(ν = κ
    = 1e-4, Rayleigh number 1e8), b = 0.5 on the bottom and -0.5 on the
    top, b = -z - 0.5 and u = 1e-3·N(0, 1) from
    np.random.default_rng(seed); or, given ``state`` (a model state on the
    host), that state instead of set(). ``pressure_solver(grid)`` makes the
    model's pressure solver."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), dtype=dtype,
                              device=device)
    b_bcs = ot.FieldBoundaryConditions(top=ot.ValueBoundaryCondition(-0.5),
                                       bottom=ot.ValueBoundaryCondition(0.5))
    kw = {} if pressure_solver is None else dict(
        pressure_solver=pressure_solver(grid))
    model = ot.NonhydrostaticModel(
        grid, advection=scheme or ot.WENO(5, smoothness_dtype=smoothness),
        buoyancy=ot.BuoyancyTracer(), tracers=("b",),
        closure=ot.ScalarDiffusivity(nu=1e-4, kappa={"b": 1e-4}),
        boundary_conditions={"b": b_bcs}, architecture=architecture, **kw)
    if state is not None:
        model.state = to_device(state, grid.device)
        return model
    model.set(b=lambda x, y, z: -z - 0.5, enforce_incompressibility=False)
    rng = np.random.default_rng(seed)
    model.set(u=1e-3 * rng.standard_normal(N))
    return model


def to_device(state, device):
    """A copy of a model state (nested dicts of tensors and scalars) with its
    tensors on ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device, copy=True)
    if isinstance(state, dict):
        return {k: to_device(v, device) for k, v in state.items()}
    return state


def thermal_bubble_model(dtype, device):
    """tests/test_regression.py thermal_bubble_model in the port: a warm
    bubble in a 100 m box, Centered(2), BuoyancyTracer, ScalarDiffusivity;
    Δt = 1, 10 steps."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=(16, 16, 16), extent=(100.0, 100.0, 100.0),
                              dtype=dtype, device=device)
    model = ot.NonhydrostaticModel(
        grid, advection=ot.Centered(2), buoyancy=ot.BuoyancyTracer(),
        tracers=("b",),
        closure=ot.ScalarDiffusivity(nu=4e-2, kappa={"b": 4e-2}))
    model.set(b=lambda x, y, z: 0.01 * np.exp(
        -((x - 50) ** 2 + (y - 50) ** 2 + (z + 75) ** 2) / 200.0))
    return model, 1.0, 10


def rayleigh_benard_model(dtype, device):
    """tests/test_regression.py rayleigh_benard_model in the port: 16x16x8,
    WENO(5) with float64 smoothness, Value conditions on b; Δt = 0.05, 10
    steps."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                              dtype=dtype, device=device)
    b_bcs = ot.FieldBoundaryConditions(top=ot.ValueBoundaryCondition(-0.5),
                                       bottom=ot.ValueBoundaryCondition(0.5))
    model = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
        buoyancy=ot.BuoyancyTracer(), tracers=("b",),
        closure=ot.ScalarDiffusivity(nu=1e-2, kappa={"b": 1e-2}),
        boundary_conditions={"b": b_bcs})
    rng = np.random.default_rng(42)
    model.set(b=lambda x, y, z: -z - 0.5, enforce_incompressibility=False)
    model.set(u=1e-3 * rng.standard_normal((16, 16, 8)))
    return model, 0.05, 10


GOLDENS = {"thermal_bubble": thermal_bubble_model,
           "rayleigh_benard": rayleigh_benard_model,
           "hydrostatic_turbulence": lambda dtype, device:
           hydrostatic_turbulence_model(dtype, device),
           # the immersed ridge takes the plain tendency, as in JAX
           "ocean_catke_windstress": lambda dtype, device:
           ocean_catke_windstress_model(dtype, device)}
GOLDEN_KERNELS = {"thermal_bubble": "fused_advection_tendency",
                  "rayleigh_benard": "fused_advection_tendency",
                  "hydrostatic_turbulence": "fused_vi_tendency",
                  "ocean_catke_windstress": "fill_halos"}


def hydrostatic_turbulence_model(dtype, device):
    """tests/test_regression.py hydrostatic_turbulence_model in the port: a
    16x12x4 lat-lon strip (0-60°E, 15-75°N, 90 m), VectorInvariant(),
    HydrostaticSphericalCoriolis(), SplitExplicitFreeSurface(substeps=8),
    T; Δt = 600 s, 10 steps."""
    import oceananigans_tpu_torch as ot
    grid = ot.LatitudeLongitudeGrid(size=(16, 12, 4), longitude=(0, 60),
                                    latitude=(15, 75), z=(-90.0, 0.0),
                                    dtype=dtype, device=device)
    model = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.VectorInvariant(),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=ot.SplitExplicitFreeSurface(substeps=8), tracers=("T",))
    assert model.uses_kernel
    rng = np.random.default_rng(7)
    model.set(u=0.1 * rng.standard_normal((16, 12, 4)),
              v=0.1 * rng.standard_normal((16, 12, 4)),
              T=lambda lam, phi, z: 10 + 5e-3 * z)
    return model, 600.0, 10


def flagship_path_phase(card, scheme=None):
    """The flagship path at 256³ float32 with its WENO(5) or ``scheme``:
    counters reset just before the model is built and read just after the
    timed steps; then the phase shares and the busy share."""
    from oceananigans_tpu_torch import kernels as K
    n, dt = 256, 1e-4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    model = bench_model(n, torch.float32, "cuda", scheme=scheme)
    label = scheme_label(model.advection)
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
    print(f"flagship path launches: {launches}; plain calls on CUDA: "
          f"{plain_cuda}")
    for name in FLAGSHIP_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched on the path"
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
    print(f"flagship path: 256^3 {label} float32 RK3 step median "
          f"{step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n ** 3 / (step_ms / 1e3):.4e} cell-updates/s [{card}]")
    print(f"flagship peak device memory (model, set() and steps): "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    rhs = K.fused_divergence(model.grid, u, v, w, 1.0)
    solve_ms = cuda_ms(lambda: model.pressure_solver.solve(rhs))
    print(f"pressure solve (torch.fft + DCT matmul) at 256^3: "
          f"{solve_ms:.4f} ms [{card}]")
    compact_phase_shares(model, dt, 3, card, f"flagship {label}")
    busy_share(f"flagship path {label}", model, dt, 3, step_ms, card)
    return launches, step_ms


FLAGSHIP_KERNELS = ("fused_advection_update", "fused_divergence",
                    "fused_correct", "fill_halos")
CONVECTION_KERNELS = ("fused_advection_tendency", "fill_halos")


class PhaseTimer:
    """CUDA events around calls of wrapped functions, summed per phase after
    a synchronize (events are recorded on the stream; no host waits). A call
    made while another wrapped phase runs is also counted under
    "<phase>@<outer phase>"."""

    def __init__(self):
        self.events = {}
        self.active = []

    def wrap(self, phase, fn):
        # functools.wraps copies fn's attributes (its launch counter), so a
        # function patched in its own module still finds its counter
        @functools.wraps(fn)
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            labels = [phase] + [f"{phase}@{outer}" for outer in self.active]
            self.active.append(phase)
            start.record()
            try:
                out = fn(*args, **kw)
            finally:
                end.record()
                self.active.pop()
            for label in labels:
                self.events.setdefault(label, []).append((start, end))
            return out
        return timed

    def totals(self):
        torch.cuda.synchronize()
        return {phase: sum(s.elapsed_time(e) for s, e in pairs)
                for phase, pairs in self.events.items()}


def convection_phase_shares(model, dt, steps, card):
    """Per-step CUDA-event times of the convection step's phases: the
    advection kernel, the halo fills (wrap + bounded z), buoyancy + closure +
    boundary fluxes (the rest of the tendencies), the projection (its
    divergence, solve and correction, its fills excluded), and the rest
    (stage updates, allocations, host gaps)."""
    import oceananigans_tpu_torch.models.nonhydrostatic as nh
    timer = PhaseTimer()
    saved = (nh.fused_advection_tendency, nh.fill_all_halo_regions)
    nh.fused_advection_tendency = timer.wrap("advection", saved[0])
    nh.fill_all_halo_regions = timer.wrap("fills", saved[1])
    model._tendencies = timer.wrap("tendencies", model._tendencies)
    model._project = timer.wrap("projection", model._project)
    model.time_step = timer.wrap("step", model.time_step)
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        nh.fused_advection_tendency, nh.fill_all_halo_regions = saved
        for name in ("_tendencies", "_project", "time_step"):
            delattr(model, name)
    shares = {
        "advection kernel": t["advection"],
        "halo fills": t["fills"],
        "buoyancy + closure + boundary fluxes":
            t["tendencies"] - t["advection"],
        "projection (divergence, solve, correction)":
            t["projection"] - t["fills@projection"],
    }
    shares["rest (updates, allocations, host gaps)"] = \
        t["step"] - sum(shares.values())
    print(f"convection step phases, ms per step over {steps} steps "
          f"(CUDA events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.1f}%)")
    print(f"  step: {t['step']:.4f} ms")
    return shares


def convection_path_phase(card, scheme=None):
    """The convection path at 256³ float32 with its WENO(5) or ``scheme``:
    counters reset just before the model is built and read just after the
    timed steps. With ``scheme`` also Σb against its initial value
    (check_conserved)."""
    from oceananigans_tpu_torch import kernels as K
    n, dt = 256, 1e-3
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    model = convection_model((n, n, n), torch.float32, "cuda", scheme=scheme)
    label = scheme_label(model.advection)
    state0 = to_device(model.state, "cpu")
    sums0 = tracer_sums(model)
    for _ in range(3):
        model.time_step(dt)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain_cuda = K.counters()
    print(f"convection path launches over set() and {model.iteration} steps: "
          f"{launches}; plain calls on CUDA: {plain_cuda}")
    for name in CONVECTION_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched on the path"
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    fields = model.state["fields"]
    for name in ("u", "v", "w", "b"):
        assert torch.isfinite(fields[name]).all().item(), f"{name} not finite"
    ints = model.grid.interior_slices
    u, v, w = (fields[c] for c in "uvw")
    model._fill_all(dict(u=u, v=v, w=w))
    from oceananigans_tpu_torch.models.nonhydrostatic import \
        _interior_divergence
    div = _interior_divergence(model.grid, u, v, w)
    umax = max(a[ints].abs().max().item() for a in (u, v, w))
    div_rel = div.abs().max().item() * model.grid.dx(("c", "c", "c")) / umax
    print(f"convection: max|div u|·Δx/max|u| after {model.iteration} steps: "
          f"{div_rel:.3e}; max|u| {umax:.3e}")
    assert div_rel < 1e-4, ("divergence not at roundoff", div_rel)
    step_ms = statistics.median(times) * 1e3
    if scheme is not None:
        check_conserved(f"convection {label}", model, sums0)
    print(f"convection path: 256^3 Rayleigh-Benard {label} float32 RK3 step "
          f"median {step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n ** 3 / (step_ms / 1e3):.4e} cell-updates/s [{card}]")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    per_step = {k: launches[k] / model.iteration for k in CONVECTION_KERNELS}
    print(f"launches per step (set() included): {per_step}")
    convection_phase_shares(model, dt, 3, card)
    return launches, step_ms, model, state0


def goldens_phase():
    """tests/test_regression.py's thermal bubble, Rayleigh–Bénard,
    hydrostatic-turbulence and ocean_catke_windstress goldens in float64
    through the kernels (the last one's immersed ridge through the fill
    kernel and the plain tendency); bound 1e-9 relative to max|golden|, the
    golden's own."""
    import os
    from oceananigans_tpu_torch import kernels as K
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    for name, make in GOLDENS.items():
        before = K.counters()[0]
        model, dt, steps = make(torch.float64, "cuda")
        for _ in range(steps):
            model.time_step(dt)
        after = K.counters()[0]
        kname = GOLDEN_KERNELS[name]
        assert after[kname] > before[kname], name
        with np.load(os.path.join(data, f"regression_{name}.npz")) as ref:
            for field in ref.files:
                got = model.field(field).interior.cpu().numpy()
                want = ref[field]
                err = np.abs(got - want).max() / max(np.abs(want).max(),
                                                      1e-12)
                print(f"  golden {name} {field}: rel {err:.3e}")
                assert err < 1e-9, ("golden", name, field, err)


@contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    import oceananigans_tpu_torch.models.hydrostatic as hs
    import oceananigans_tpu_torch.models.nonhydrostatic as nh
    import oceananigans_tpu_torch.models.shallow_water as sw
    from oceananigans_tpu_torch import kernels as K
    swaps = [(sw, "fused_sw_update", K.fused_sw_update_plain),
             (hs, "fused_vi_tendency", K.fused_vi_tendency_plain),
             (nh, "fused_advection_update", K.fused_advection_update_plain),
             (nh, "fused_advection_tendency",
              K.fused_advection_tendency_plain),
             (nh, "fused_divergence", K.fused_divergence_plain),
             (nh, "fused_correct", K.fused_correct_plain),
             (nh, "periodic_halo_fill", K.periodic_halo_fill_plain),
             (hf, "fill_halos", K.fill_halos_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def whole_step_phase():
    """3 steps in float64 (float64 WENO smoothness) through the kernels and
    through the plain versions: the flagship and the convection
    configuration at 32³, the z-compact routes at 32³ (WENO(5) with two
    tracers on the fused route; the buoyant model on the tendency route),
    shallow water at 128² (FPlane(0.3), bathymetry, a tracer), the hydro_row
    at 16x12x8 (v added to u's noise), the flat-bottom CATKE ocean row at
    16x12x8 (v added too), quasi-AB2 and split RK3, the LES row at 32³
    with SmagorinskyLilly, AMD(Cb=1) and Lilly's coefficient (a stratified
    b), its vertically implicit variant; then one step of each physics module's
    configuration (PHYSICS_TRACERS) at 32³; bound 1e-12 relative to
    max|field|."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.models import NonhydrostaticModel

    def flagship():
        rng = np.random.default_rng(0)
        n = 32
        grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                                  dtype=torch.float64, device="cuda")
        m = NonhydrostaticModel(grid, advection=ot.WENO(
            5, smoothness_dtype=torch.float64))
        m.set(u=0.1 * rng.standard_normal((n, n, n)),
              v=0.1 * rng.standard_normal((n, n, n)))
        return m

    def convection():
        m = convection_model((32, 32, 32), torch.float64, "cuda",
                             smoothness=torch.float64)
        # a stronger start than 1e-3 noise, so that 3 steps exercise advection
        rng = np.random.default_rng(1)
        m.set(v=0.1 * rng.standard_normal((32, 32, 32)))
        return m

    def shallow_water():
        n = 128
        rng = np.random.default_rng(5)
        m = sw_model(n, torch.float64, "cuda", scheme=ot.WENO(
            5, smoothness_dtype=torch.float64), coriolis=ot.FPlane(f=0.3),
            bathymetry=0.05 * rng.standard_normal((n, n)), tracers=("c",))
        m.set(c=rng.random((n, n)))
        assert m.fused
        return m

    def tracers_compact():
        rng = np.random.default_rng(3)
        n = (32, 32, 32)
        grid = ot.RectilinearGrid(size=n, extent=(1.0, 1.0, 1.0),
                                  dtype=torch.float64, device="cuda")
        m = NonhydrostaticModel(grid, advection=ot.WENO(
            5, smoothness_dtype=torch.float64), tracers=("a", "c"))
        m.set(u=0.1 * rng.standard_normal(n), v=0.1 * rng.standard_normal(n),
              a=rng.random(n), c=rng.random(n))
        assert m._fused_update
        return m

    def buoyant_compact():
        m = buoyant_model((32, 32, 32), torch.float64, "cuda",
                          smoothness=torch.float64)
        assert not m._fused_update and m.grid.H[2] == 0
        return m

    def hydrostatic():
        n = (16, 12, 8)
        m = hydro_model(n, torch.float64, "cuda", smoothness=torch.float64)
        m.set(v=0.05 * np.random.default_rng(2).standard_normal(n))
        assert m.uses_kernel
        return m

    def ocean(**kw):
        def make():
            n = (16, 12, 8)
            m = ocean_model(n, torch.float64, "cuda",
                            smoothness=torch.float64, **kw)
            m.set(v=0.05 * np.random.default_rng(2).standard_normal(n))
            assert m.uses_kernel
            return m
        return make

    def les(closure):
        def make():
            m = les_model(32, closure(), torch.float64, "cuda",
                          smoothness=torch.float64)
            # a stronger buoyancy than the row's 1e-4 noise, so that 3 steps
            # exercise Lilly's factor and AMD's buoyancy term
            z = np.linspace(-1.0, 0.0, 32).reshape(1, 1, -1)
            m.set(b=0.1 * z + 0.01 * np.random.default_rng(4)
                  .standard_normal((32, 32, 32)),
                  enforce_incompressibility=False)
            return m
        return make

    runs_3 = [
        ("flagship", flagship, "uvwp", 1e-3),
        ("convection", convection, "uvwbp", 1e-3),
        ("tracers z-compact", tracers_compact, "uvwacp", 1e-3),
        ("buoyant z-compact", buoyant_compact, "uvwbp", 1e-3),
        ("shallow water", shallow_water, ("uh", "vh", "h", "c"), 1e-4),
        ("hydrostatic", hydrostatic, ("u", "v", "T", "eta", "w"), 120.0),
        ("CATKE ocean, flat bottom", ocean(),
         ("u", "v", "T", "S", "e", "eta", "w"), OCEAN_DT),
        ("CATKE ocean, flat bottom, split RK3", ocean(
            timestepper="SplitRungeKutta3"),
         ("u", "v", "T", "S", "e", "eta", "w"), OCEAN_DT),
        ("LES SmagorinskyLilly 32^3", les(ot.SmagorinskyLilly), "uvwbp",
         1e-3),
        ("LES AMD(Cb=1) 32^3", les(
            lambda: ot.AnisotropicMinimumDissipation(Cb=1.0)), "uvwbp", 1e-3),
        ("LES Smagorinsky(LillyCoefficient) 32^3", les(
            lambda: ot.Smagorinsky(coefficient=ot.LillyCoefficient())),
         "uvwbp", 1e-3),
        ("vertically implicit VerticalScalarDiffusivity 32^3",
         lambda: vitd_model(32, torch.float64, "cuda",
                            smoothness=torch.float64), "uvwbp", 1e-3)]
    runs_1 = [(f"{label} 32^3, one step", functools.partial(
        physics_model, label), "uvwp" + tracers, 1e-3)
        for label, tracers in PHYSICS_TRACERS.items()]
    for (label, make, names, dt), steps in (
            [(r, 3) for r in runs_3] + [(r, 1) for r in runs_1]):
        runs = []
        for plain in (False, True):
            with plain_kernels() if plain else nullcontext():
                m = make()
                for _ in range(steps):
                    m.time_step(dt)
            runs.append(m)
        for name in names:
            err, rel = max_err(runs[0].field(name).interior,
                               runs[1].field(name).interior)
            print(f"  whole step {label} {name}: max abs {err:.3e}, "
                  f"rel {rel:.3e}")
            assert rel <= 1e-12, ("whole step", label, name, rel)


# one configuration of each physics module of the nonhydrostatic model
# (phase 11): its tracers (each a one-letter field name)
PHYSICS_TRACERS = {"dynamic Smagorinsky, Lagrangian": "c",
                   "dynamic Smagorinsky, (0, 1) averaging": "c",
                   "AMD, conditions on the diffusivities": "b",
                   "vertically implicit, function ν": "b",
                   "SeawaterBuoyancy TEOS-10": "TS",
                   "tilted gravity": "b",
                   "non-traditional beta-plane": "b", "forcing": "bc",
                   "Stokes drift": "b", "background fields": "b",
                   "quasi-AB2": "b", "closure tuple": "c"}


def physics_model(label, n=32, dtype=torch.float64, device="cuda"):
    """The configuration of ``label`` (PHYSICS_TRACERS) at n³ on the LES
    row's grid, WENO(5) (float64 smoothness), from
    np.random.default_rng(2)."""
    import oceananigans_tpu_torch as ot

    def value_bcs(top, bottom):
        return ot.FieldBoundaryConditions(
            top=ot.ValueBoundaryCondition(top),
            bottom=ot.ValueBoundaryCondition(bottom))

    kw = {
        "dynamic Smagorinsky, Lagrangian": lambda: dict(
            closure=ot.DynamicSmagorinsky(
                averaging=ot.LagrangianAveraging())),
        "dynamic Smagorinsky, (0, 1) averaging": lambda: dict(
            closure=ot.DynamicSmagorinsky(averaging=(0, 1))),
        "AMD, conditions on the diffusivities": lambda: dict(
            buoyancy=ot.BuoyancyTracer(),
            closure=ot.AnisotropicMinimumDissipation(Cb=1.0),
            boundary_conditions={"nu_e": value_bcs(0.0, 1e-3),
                                 "kappa_e": {"b": value_bcs(2e-4, 0.0)}}),
        "vertically implicit, function ν": lambda: dict(
            closure=ot.ScalarDiffusivity(
                ot.VerticallyImplicitTimeDiscretization(),
                nu=lambda x, y, z, t: 2e-2 * (1.5 + z) + t,
                kappa={"b": 3e-2}),
            boundary_conditions={"b": value_bcs(-0.05, 0.05)}),
        "SeawaterBuoyancy TEOS-10": lambda: dict(
            buoyancy=ot.SeawaterBuoyancy(ot.TEOS10EquationOfState()),
            closure=ot.ScalarDiffusivity(nu=1e-4, kappa=1e-4)),
        "tilted gravity": lambda: dict(buoyancy=ot.BuoyancyForce(
            ot.BuoyancyTracer(), gravity_unit_vector=(0.2, -0.1, -1.0))),
        "non-traditional beta-plane": lambda: dict(
            buoyancy=ot.BuoyancyTracer(), coriolis=ot.NonTraditionalBetaPlane(
                fz0=0.5, beta=0.2, fy0=0.3, gamma=-0.1, radius=5.0)),
        "forcing": lambda: dict(forcing={
            "u": ot.ContinuousForcing(
                lambda x, y, z, t, b: 0.1 * b * (1 + x) + t,
                field_dependencies="b"),
            "b": ot.Relaxation(0.5, mask=ot.GaussianMask(-0.5, 0.2),
                               target=ot.LinearTarget(gradient=0.1)),
            "c": (ot.AdvectiveForcing(w=-0.01), ot.DiscreteForcing(
                lambda grid, fields, t, p: -p * fields["c"],
                parameters=0.2))}),
        "Stokes drift": lambda: dict(stokes_drift=ot.StokesDrift(
            dz_us=lambda x, y, z, t: 0.2 * (1 + z) + t,
            dy_us=lambda x, y, z, t: 0.05 * x)),
        "background fields": lambda: dict(
            buoyancy=ot.BuoyancyTracer(), background_fields={
                "u": ot.BackgroundField(lambda x, y, z, t: 0.1 * z + t),
                "b": lambda x, y, z, t: 0.01 * z}),
        "quasi-AB2": lambda: dict(
            buoyancy=ot.BuoyancyTracer(),
            coriolis=ot.ConstantCartesianCoriolis(fx=0.1, fy=0.2, fz=0.4),
            timestepper="QuasiAdamsBashforth2"),
        "closure tuple": lambda: dict(closure=(
            ot.Smagorinsky(), ot.HorizontalScalarDiffusivity(nu=1e-3,
                                                              kappa=2e-3))),
    }[label]()
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              dtype=dtype, device=device)
    model = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=dtype),
        tracers=tuple(PHYSICS_TRACERS[label]), **kw)
    rng = np.random.default_rng(2)
    z = np.linspace(-1.0, 0.0, n).reshape(1, 1, -1)
    base = {"T": 10.0 + 2.0 * z, "S": 35.0 - 0.5 * z}
    values = {c: 0.1 * rng.standard_normal((n, n, n)) for c in "uv"}
    for name in model.tracer_names:
        values[name] = base.get(name, 0.1 * z) + 0.01 * rng.standard_normal(
            (n, n, n))
    model.set(**values)
    return model


# -- shallow water --------------------------------------------------------------

SW_TOPOLOGY = ("periodic", "periodic", "flat")
SW_NAMES = ("uh", "vh", "h")
SW_KERNELS = ("fused_sw_update", "fill_halos")


def sw_kernel_inputs(n, dtype, tracers, seed):
    """Padded uh, vh, h (h about 1), the tracers and a bathymetry on an
    n² grid with H = (4, 4, 0), halos wrapped, and a G⁻ tensor."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import periodic_halo_fill
    grid = ot.RectilinearGrid(size=(n, n), extent=(1.0, 1.0), halo=(4, 4, 0),
                              topology=SW_TOPOLOGY, dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(shape, scale, offset=0.0):
        return offset + scale * torch.randn(shape, generator=gen, dtype=dtype,
                                            device="cuda")

    shape = grid.padded_shape
    fields = dict(uh=randn(shape, 0.01), vh=randn(shape, 0.01),
                  h=randn(shape, 0.01, 1.0))
    fields.update({name: randn(shape, 1.0) for name in tracers})
    hB = randn(shape, 0.01)
    periodic_halo_fill(grid, list(fields.values()) + [hB])
    Gm = randn((len(fields),) + grid.N, 1.0)
    return grid, fields, hB, Gm


def worst_rel(got, want):
    """(max abs difference, the largest of each pair's difference over its
    own max|want|) across paired tensors."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    rel = max((g - w).abs().max().item() / w.abs().max().item()
              for g, w in zip(got, want))
    return err, rel


def sw_kernels_phase(n_main):
    """The shallow-water path's kernels against their plain versions.
    Bounds, each tensor relative to its own max|plain|:
    - the fused stage in float64 at 256² (WENO(5) with float64 smoothness,
      and Centered(2); FPlane(0.3), bathymetry, one tracer): 1e-12, FMA
      contraction and another association order;
    - in float32 at 4096² and at n_main² (WENO(5) with its default float32
      smoothness, no tracer; at n_main² the timed inputs: f = 0, the G⁻
      variant): 1e-5, float32 rounding with FMA contraction, where a one-ulp
      change of a float32 smoothness indicator moves a nonlinear weight by a
      few ulp;
    - the wrap of three 16392² fields: exact (it copies).
    Returns {kernel: dict(max_abs_err, ms, plain_ms)} at the path's shapes
    (n_main², float32, the G⁻ variant of the stage)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K

    out = {}
    for n, dtype, schemes, tracers, tol in (
            (256, torch.float64,
             (ot.WENO(5, smoothness_dtype=torch.float64), ot.Centered(2)),
             ("c",), 1e-12),
            (4096, torch.float32, (ot.WENO(5),), (), 1e-5)):
        grid, fields, hB, Gm = sw_kernel_inputs(n, dtype, tracers, seed=3)
        names = SW_NAMES + tracers
        ints = grid.interior_slices
        for scheme in schemes:
            for gm in (None, Gm):
                args = (grid, scheme, 9.81, 0.3, hB, names, fields, gm, 2e-5,
                        -1e-5)
                Gk, nk = K.fused_sw_update(*args)
                Gp, np_ = K.fused_sw_update_plain(*args)
                err, rel = worst_rel(
                    list(Gk) + [nk[c][ints] for c in names],
                    list(Gp) + [np_[c][ints] for c in names])
                print(f"  fused_sw_update {n}^2 {dtype} {scheme!r} "
                      f"Gm={gm is not None}: max abs {err:.3e}, rel {rel:.3e}")
                assert rel <= tol, ("fused_sw_update", n, scheme, rel)
        del grid, fields, hB, Gm, Gk, nk, Gp, np_
        torch.cuda.synchronize()

    grid, fields, hB, Gm = sw_kernel_inputs(n_main, torch.float32, (), seed=4)
    scheme = ot.WENO(5)
    args = (grid, scheme, 9.81, 0.0, hB, SW_NAMES, fields, Gm, 2e-5, -1e-5)
    ms = cuda_ms(lambda: K.fused_sw_update(*args))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plain_ms = cuda_ms(lambda: K.fused_sw_update_plain(*args), reps=3,
                       warmup=1)
    plain_peak = torch.cuda.max_memory_allocated() - base
    # the check at the path's shape, on the timed inputs (bound 1e-5, as at
    # 4096²); the two outputs fit beside the plain version's temporaries
    Gk, nk = K.fused_sw_update(*args)
    Gp, np_ = K.fused_sw_update_plain(*args)
    ints = grid.interior_slices
    err, rel = worst_rel(list(Gk) + [nk[c][ints] for c in SW_NAMES],
                         list(Gp) + [np_[c][ints] for c in SW_NAMES])
    print(f"  fused_sw_update {n_main}^2 {torch.float32} {scheme!r} Gm=True "
          f"f=0: max abs {err:.3e}, rel {rel:.3e}")
    assert rel <= 1e-5, ("fused_sw_update", n_main, scheme, rel)
    del Gk, nk, Gp, np_
    torch.cuda.empty_cache()
    out["fused_sw_update"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    print(f"  time fused_sw_update (G⁻ variant) at {grid.padded_shape}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (plain peak "
          f"{plain_peak / 2 ** 30:.2f} GiB above its inputs)")
    a = [fields[c] for c in SW_NAMES]
    err_wrap = fill_check("shallow water uh, vh, h (the wrap)", grid, a, None)
    out["fill_halos_sw"] = time_fill("shallow water uh, vh, h (the wrap)",
                                     grid, a, None, err_wrap)
    del grid, fields, hB, Gm, a
    torch.cuda.empty_cache()
    sw_tile_edge_checks()
    return out


def sw_tile_edge_checks():
    """#8 against its plain version in float64 (WENO(5), float64
    smoothness, bathymetry) on interiors its 16x32 float64 tiles do not
    divide, with 0 and 33 tracers (the 36 fields in two launches), f = 0
    and 0.3, the first-stage and G⁻ variants. Bound 1e-12 relative to each
    tensor's own max|plain|."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.kernels import periodic_halo_fill
    scheme = ot.WENO(5, smoothness_dtype=torch.float64)
    for n in SW_TILE_EDGES:
        for ntr in (0, 33):
            grid = ot.RectilinearGrid(size=n, extent=(1.0, 1.0),
                                      halo=(4, 4, 0), topology=SW_TOPOLOGY,
                                      dtype=torch.float64, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(31)
            shape = grid.padded_shape

            def randn(shp, scale, offset=0.0):
                return offset + scale * torch.randn(
                    shp, generator=gen, dtype=torch.float64, device="cuda")

            fields = dict(uh=randn(shape, 0.1), vh=randn(shape, 0.1),
                          h=randn(shape, 0.05, 1.0))
            fields.update({f"c{i}": randn(shape, 1.0) for i in range(ntr)})
            hB = randn(shape, 0.05)
            periodic_halo_fill(grid, list(fields.values()) + [hB])
            Gm = randn((len(fields),) + grid.N, 1.0)
            names = tuple(fields)
            ints = grid.interior_slices
            worst = 0.0
            for f in (0.0, 0.3):
                for gm in (None, Gm):
                    args = (grid, scheme, 9.81, f, hB, names, fields, gm,
                            2e-3, -1e-3)
                    Gk, nk = K.fused_sw_update(*args)
                    Gp, np_ = K.fused_sw_update_plain(*args)
                    err, rel = worst_rel(
                        list(Gk) + [nk[c][ints] for c in names],
                        list(Gp) + [np_[c][ints] for c in names])
                    assert rel <= 1e-12, ("fused_sw_update tile edges", n,
                                          ntr, f, gm is not None, rel)
                    worst = max(worst, rel)
            print(f"  fused_sw_update tile edges {n} float64, {ntr} tracers,"
                  f" f = 0 and 0.3, both variants: worst rel {worst:.3e}")
    torch.cuda.synchronize()


def sw_model(n, dtype, device, seed=0, scheme=None, coriolis=None,
             bathymetry=0.0, tracers=(), architecture=None, state=None):
    """The shallow-water row of bench_extra.py (:179-207) on the port: an
    n² periodic grid of extent 1x1, WENO(5), g = 9.81, h = 1 + 0.01·N(0, 1),
    uh and vh 0.01·N(0, 1) from np.random.default_rng(seed); or, given
    ``state`` (a model state on the host), that state instead of set()."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=(n, n), extent=(1.0, 1.0),
                              topology=SW_TOPOLOGY, dtype=dtype, device=device)
    model = ot.ShallowWaterModel(
        grid, advection=scheme if scheme is not None else ot.WENO(5),
        gravitational_acceleration=9.81, coriolis=coriolis,
        bathymetry=bathymetry, tracers=tracers, architecture=architecture)
    if state is not None:
        model.state = to_device(state, grid.device)
        return model
    rng = np.random.default_rng(seed)
    model.set(h=1.0 + 0.01 * rng.standard_normal((n, n)))
    model.set(uh=0.01 * rng.standard_normal((n, n)))
    model.set(vh=0.01 * rng.standard_normal((n, n)))
    return model


def sw_phase_shares(model, dt, steps, card):
    """Per-step CUDA-event times of the shallow-water step: the fused stage
    kernel, the halo fills, and the rest (host gaps, allocations)."""
    import oceananigans_tpu_torch.models.shallow_water as sw
    timer = PhaseTimer()
    saved = (sw.fused_sw_update, sw.fill_all_halo_regions)
    sw.fused_sw_update = timer.wrap("kernel", saved[0])
    sw.fill_all_halo_regions = timer.wrap("fills", saved[1])
    model.time_step = timer.wrap("step", model.time_step)
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        sw.fused_sw_update, sw.fill_all_halo_regions = saved
        del model.time_step
    shares = {"fused_sw_update": t["kernel"], "halo fills": t["fills"]}
    shares["rest (host gaps, allocations)"] = \
        t["step"] - sum(shares.values())
    print(f"shallow-water step phases, ms per step over {steps} steps "
          f"(CUDA events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.2f}%)")
    print(f"  step: {t['step']:.4f} ms")
    return shares


def sw_path_phase(card, n):
    """The shallow-water path at n² float32: counters reset after set() and
    read just after the timed steps."""
    from oceananigans_tpu_torch import kernels as K
    dt = 1e-5
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = sw_model(n, torch.float32, "cuda")
    torch.cuda.synchronize()
    print(f"shallow water: model and set() at {n}^2: "
          f"{time.perf_counter() - t0:.1f} s")
    ints = model.grid.interior_slices
    mass0 = model.state["fields"]["h"][ints].double().sum().item()
    state0 = to_device(model.state, "cpu")
    K.reset_counters()
    for _ in range(3):
        model.time_step(dt)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    print(f"shallow-water path launches over {steps} steps: {launches}; "
          f"plain calls on CUDA: {plain_cuda}")
    for name in SW_KERNELS:
        assert launches[name] == 3 * steps, (name, launches[name], steps)
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    peak = torch.cuda.max_memory_allocated()
    for name in SW_NAMES:
        a = model.field(name).interior
        assert a.shape == (n, n, 1), (name, a.shape)
        assert torch.isfinite(a).all().item(), f"{name} is not finite"
    mass = model.state["fields"]["h"][ints].double().sum().item()
    drift = abs(mass - mass0) / mass0
    # each stage rounds every h to float32, at most half an ulp (6e-8
    # relative at h ≈ 1); unbiased, the N² roundings of a stage move Σh/Σh₀
    # by about 3.4e-8/N, and 39 stages by √39 times that, 1.3e-11 at 16384².
    # The bound leaves a margin of about 80 over that estimate; a tendency
    # of h that is not conservative by more than 1e-9 relative fails it.
    print(f"shallow water: |Σh − Σh₀|/Σh₀ after {steps} steps: {drift:.3e} "
          f"(bound 1e-9)")
    assert drift < 1e-9, ("mass not conserved", drift)
    step_ms = statistics.median(times) * 1e3
    print(f"shallow-water path: {n}^2 WENO5 float32 RK3 step median "
          f"{step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n * n / (step_ms / 1e3):.4e} cell-updates/s [{card}]")
    print(f"peak device memory (model, set() and steps): "
          f"{peak / 2 ** 30:.2f} GiB")
    sw_phase_shares(model, dt, 3, card)
    return launches, step_ms, model, state0


# -- hydrostatic ------------------------------------------------------------------

HYDRO_N = (512, 256, 32)
HYDRO_KERNELS = ("fused_vi_tendency", "fill_halos")


def weno_flop(K, n_smooth):
    """Operations of one WENO reconstruction of buffer K (WENO-(2K-1)) whose
    smoothness is summed over ``n_smooth`` arrays (0: the field itself), as
    the port's tables give them: K stencil values of K products and K-1
    sums; per array and stencil, each Jiang–Shu factor m of K products, K-1
    sums and a square, summed (the factor counts of
    advection/reconstruction.py smoothness_factors: K-1 or K); τ over the
    nonzero coefficients, its magnitude; per stencil ε, the division, the
    saturation, the square, 1 +, γ·, the product with the value and two
    sums (9), and the final division."""
    from oceananigans_tpu_torch.advection.reconstruction import \
        smoothness_factors
    from oceananigans_tpu_torch.advection.schemes import TAU_COEFFS
    arrays = max(n_smooth, 1)
    values = K * (2 * K - 1)
    smooth = 0
    for st in range(K):
        m = len(smoothness_factors(K, st))
        smooth += arrays * (m * 2 * K + (m - 1)) + (arrays - 1)
    tau = 2 * (sum(1 for t in TAU_COEFFS[K] if t) - 1) + 1
    return values + smooth + tau + 9 * K + 1


# The fused hydrostatic tendency, per interior cell, by configuration (its
# sites' families and buffers, ``vi_config``): each derived field, face
# flux and reconstruction once, whatever implements them.
# - derived fields: ζ (2 products, 2 differences, a difference, a division:
#   6), û and v̂ (a product, two means of 2 operations, a division: 6 each);
#   the velocity stencil's ℑy u and ℑx v (2 each); a self-upwinded
#   Bernoulli head's u²/2 and v²/2 (2 each), their four differences (4) and
#   ℑx u, ℑy v (2 each), or the energy form's K (7); a scheme's vertical
#   term's δx(Ax u) and δy(Ay v) (2 each) and their sum (1), two more
#   products on a stretched z (Ax·Δz, Ay·Δz). The hydro_row's: 39.
# - per momentum component: the vorticity flux (a scheme's reconstruction
#   with its product and sign, 2; energy 8; enstrophy 5); the Bernoulli head
#   (the cross Centered(2b) 4b − 1, the reconstruction with one smoothness
#   array, a sum, a division and a sign, 3; or the energy form's difference,
#   division and sign, 3); the vertical term (Φᵟ: the cross Centered, the
#   reconstruction, a sum and a product, 2, or CROSS_AND_SELF's
#   reconstruction and product; one z face flux: A·w 1, the symmetric ŵ, the
#   z reconstruction, the product 1; the difference, the sum and the
#   division, 3; one more product for V on a stretched z; or the energy
#   form's ℑx(Az w) 3, δz/Δz 2, the product, ℑz 2, the division and the
#   sign: 10); Coriolis 7; −δph/Δ and its sum 3 with pₕ′; the three sums of
#   the phases (3);
# - per tracer: three face fluxes of (A·u 1, the reconstruction of the
#   axis's site, the product 1; one more product for Ax, Ay on a stretched
#   z), three differences, two sums, a division and a sign (7; one more
#   product for V on a stretched z). Centered(2): 22.
# - the multi-dimensional stencil: per momentum component, MD_FILTER_FLOP
#   for each filtered value (the vorticity reconstruction, the Bernoulli
#   head's cross interpolation and reconstruction, the ONLY_SELF
#   divergence flux's sum).
def vi_recon_flop(cfg, site, n_smooth=0):
    """Operations of one reconstruction at a site of ``cfg`` at its own
    buffer K: WENO-(2K-1) (``weno_flop``), a selected UpwindBiased(2K-1)
    (2K-1 products, 2K-2 sums) or Centered(2K) (2K products, 2K-1 sums)."""
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    fam, K = cfg["sites"][site]
    if fam == fvi.WENO_FAMILY:
        return weno_flop(K, n_smooth)
    return 2 * (2 * K if fam == fvi.CENTERED else 2 * K - 1) - 1


def vi_sym_flop(cfg, site):
    """Operations of a symmetric site's Centered(2b) at its top level."""
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    return 4 * fvi.sym_buffer(cfg["sites"][site]) - 1


def vi_flop(cfg, n_tracers, with_ph=False):
    """Operations of the hydrostatic tendency per interior cell for the
    configuration ``cfg`` (``vi_config``) with ``n_tracers`` tracers (the
    accounting above)."""
    zs = int(cfg["zs"])
    two = cfg["vort"] == 2 and cfg["vort_sm"] == 2
    derived = 6 + 12 + (4 if two else 0)
    derived += 12 if cfg["ke"] else 7
    derived += (5 + 2 * zs) if cfg["vert"] else 0
    per = 0
    for ax in ("x", "y"):
        if cfg["vort"] == 2:
            per += vi_recon_flop(cfg, "vort_" + ax, 2 if two else 0) + 2
        else:
            per += 8 if cfg["vort"] == 1 else 5
        if cfg["ke"]:
            per += vi_sym_flop(cfg, "kc_" + ax) + vi_recon_flop(
                cfg, "ke_" + ax, 1) + 3
        else:
            per += 3
        if cfg["vert"]:
            if cfg["upw"]:
                per += vi_recon_flop(cfg, "div_" + ax) + 1
            else:
                per += vi_sym_flop(cfg, "dc_" + ax) + vi_recon_flop(
                    cfg, "div_" + ax, 1) + 2
            per += 1 + vi_sym_flop(cfg, "vs_" + ax) + vi_recon_flop(
                cfg, "vz") + 1 + 3 + zs
        else:
            per += 10
        per += (7 if cfg["cor"] else 0) + (3 if with_ph else 0) + 3
        if cfg.get("md"):
            # the multi-dimensional stencil's filters of this component
            per += MD_FILTER_FLOP * (int(cfg["vort"] == 2) + 2 * cfg["ke"]
                                     + int(cfg["vert"] and not cfg["upw"]))
    tracer = 0
    if cfg["tracers"]:
        tracer = sum(2 + vi_recon_flop(cfg, "t_" + ax)
                     for ax in ("x", "y", "z")) + 2 * zs + 7 + zs
    return derived + per + n_tracers * tracer


def vi_bound(grid, cfg, n_tracers, with_ph=False):
    """(bound_ms, bound_by) of the hydrostatic tendency on ``grid``: read u,
    v, w, the tracers (and pₕ′) padded, write Gu, Gv and the Gc (the
    interiors); the operations of ``vi_flop``."""
    cells = grid.N[0] * grid.N[1] * grid.N[2]
    padded = int(np.prod(grid.padded_shape))
    esize = torch.empty((), dtype=grid.dtype).element_size()
    nbytes = esize * ((3 + n_tracers + int(with_ph)) * padded
                      + (2 + n_tracers) * cells)
    return bound(nbytes, cells * vi_flop(cfg, n_tracers, with_ph))


def hydro_bounds(N, H, esize, n_tracers=1):
    """Bounds of the hydrostatic path's tendency kernel at interior N, halo
    H for the hydro_row configuration (WENO-9 vorticity with the velocity
    stencil, WENO-5 vertical, divergence and Bernoulli schemes, spherical
    energy-conserving Coriolis, Centered(2) tracers, no pₕ′; ``vi_bound``)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    dt = torch.float32 if esize == 4 else torch.float64
    grid = ot.LatitudeLongitudeGrid(size=N, longitude=(0, 60),
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    halo=H, dtype=dt, device="cpu")
    cfg = fvi.vi_config(grid, ot.WENOVectorInvariant(smoothness_dtype=dt),
                        ot.Centered(2), n_tracers,
                        ot.HydrostaticSphericalCoriolis())
    return {"fused_vi_tendency": vi_bound(grid, cfg, n_tracers)}


def hydro_model(N, dtype, device, seed=0, smoothness=torch.float32,
                substeps=30, fused_tendencies="auto",
                multi_dimensional_stencil=False):
    """bench_extra.py's hydro_row on the port: a lat-lon grid of 60° x 60°
    (15°N-75°N), 1800 m deep, WENOVectorInvariant() (with the
    multi-dimensional stencil on request: H = 8), HydrostaticSpherical-
    Coriolis(), SplitExplicitFreeSurface(substeps=30), tracer T, quasi-AB2;
    u = 0.05·N(0, 1) from np.random.default_rng(seed), T = 12 + 8e-3 z +
    2e-2 φ."""
    import oceananigans_tpu_torch as ot
    grid = ot.LatitudeLongitudeGrid(size=N, longitude=(0, 60),
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    dtype=dtype, device=device)
    model = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.WENOVectorInvariant(
            smoothness_dtype=smoothness,
            multi_dimensional_stencil=multi_dimensional_stencil),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=ot.SplitExplicitFreeSurface(substeps=substeps),
        tracers=("T",), fused_tendencies=fused_tendencies)
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    model.set(u=0.05 * rng.standard_normal(N).astype(npdt),
              T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi)
    return model


OCEAN_DT = 120.0


def ocean_drag(x, y, t, u, v):
    """The quadratic bottom drag of the ocean row and the golden:
    -2.5e-3·√(u² + v²)·u."""
    return -2.5e-3 * (u ** 2 + v ** 2) ** 0.5 * u


def ocean_ridge(lam, phi):
    """The ocean row's immersed ridge: the golden's, scaled from its 0-36°
    strip to the 0-60° one."""
    return -1800.0 + 900.0 * np.exp(-((lam - 30.0) / 10.0) ** 2)


def ocean_model(N, dtype, device, immersed=False, seed=0,
                smoothness=torch.float32, fused_tendencies="auto",
                longitude=(0, 60), latitude=(15, 75),
                momentum_advection=None, free_surface=None,
                timestepper="QuasiAdamsBashforth2", top_u=-1e-4,
                reference_datetime=None, z=(-1800.0, 0.0)):
    """The CATKE ocean row: the ocean_catke_windstress golden's
    configuration at the hydro_row's size. A lat-lon grid 1800 m deep,
    WENOVectorInvariant(), tracer_advection=WENO(5),
    HydrostaticSphericalCoriolis(), SplitExplicitFreeSurface(cfl=0.7),
    SeawaterBuoyancy(LinearEquationOfState()), CATKEVerticalDiffusivity(),
    T and S; on u a top flux of -1e-4 and the quadratic bottom drag
    (field dependencies u, v); T = 12 + 8e-3 z + 2 cos φ, S = 35,
    u = 0.05·N(0, 1) from np.random.default_rng(seed); with ``immersed``
    the grid carries ``ocean_ridge`` as a GridFittedBottom;
    ``momentum_advection``, ``free_surface`` and ``timestepper`` replace
    the row's; ``top_u`` (a number or callable for a FluxBoundaryCondition,
    or a boundary condition) replaces u's top flux; ``z`` the grid's
    vertical coordinate (the stretched row's ExponentialDiscretization)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.boundary_conditions import BoundaryCondition
    from oceananigans_tpu_torch.closures import CATKEVerticalDiffusivity
    from oceananigans_tpu_torch.immersed import (GridFittedBottom,
                                                 ImmersedBoundaryGrid)
    grid = ot.LatitudeLongitudeGrid(size=N, longitude=longitude,
                                    latitude=latitude, z=z,
                                    dtype=dtype, device=device)
    if immersed:
        grid = ImmersedBoundaryGrid(grid, GridFittedBottom(ocean_ridge))
    buoyancy = ot.SeawaterBuoyancy(
        equation_of_state=ot.LinearEquationOfState())
    model = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=momentum_advection
        or ot.WENOVectorInvariant(smoothness_dtype=smoothness),
        tracer_advection=ot.WENO(5, smoothness_dtype=smoothness),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=free_surface or ot.SplitExplicitFreeSurface(cfl=0.7),
        buoyancy=buoyancy, closure=CATKEVerticalDiffusivity(),
        tracers=("T", "S"), fused_tendencies=fused_tendencies,
        timestepper=timestepper, reference_datetime=reference_datetime,
        boundary_conditions={"u": ot.FieldBoundaryConditions(
            top=(top_u if isinstance(top_u, BoundaryCondition)
                 else ot.FluxBoundaryCondition(top_u)),
            bottom=ot.FluxBoundaryCondition(
                ocean_drag, field_dependencies=("u", "v")))})
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    model.set(T=lambda lam, phi, z: 12 + 8e-3 * z
              + 2 * np.cos(np.radians(phi)),
              S=35.0, u=0.05 * rng.standard_normal(N).astype(npdt))
    return model


def ocean_catke_windstress_model(dtype, device):
    """tests/test_regression.py ocean_catke_windstress_model in the port: a
    12x10x6 lat-lon strip (0-36°E, 20-60°N, 1800 m) with an immersed ridge,
    VectorInvariant(), WENO(5) tracers, spherical Coriolis,
    SplitExplicitFreeSurface(cfl=0.7, fixed_dt=600, grid=), linear
    SeawaterBuoyancy, CATKE, T and S, wind stress and the field-dependent
    drag on u; Δt = 600 s, 8 steps."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.boundary_conditions import BoundaryCondition
    from oceananigans_tpu_torch.closures import CATKEVerticalDiffusivity
    from oceananigans_tpu_torch.immersed import (GridFittedBottom,
                                                 ImmersedBoundaryGrid)
    under = ot.LatitudeLongitudeGrid(size=(12, 10, 6), longitude=(0, 36),
                                     latitude=(20, 60), z=(-1800.0, 0.0),
                                     dtype=dtype, device=device)
    grid = ImmersedBoundaryGrid(under, GridFittedBottom(
        lambda lam, phi: -1800.0 + 900.0 * np.exp(-((lam - 18.0) / 6.0)
                                                  ** 2)))
    buoyancy = ot.SeawaterBuoyancy(
        equation_of_state=ot.LinearEquationOfState())
    model = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.VectorInvariant(),
        tracer_advection=ot.WENO(5, smoothness_dtype=dtype),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=ot.SplitExplicitFreeSurface(cfl=0.7, fixed_dt=600.0,
                                                 grid=under),
        buoyancy=buoyancy,
        closure=CATKEVerticalDiffusivity(buoyancy=buoyancy),
        tracers=("T", "S"),
        boundary_conditions={"u": ot.FieldBoundaryConditions(
            top=ot.FluxBoundaryCondition(-1e-4),
            bottom=ot.FluxBoundaryCondition(
                ocean_drag, field_dependencies=("u", "v")))})
    rng = np.random.default_rng(3)
    model.set(T=lambda lam, phi, z: 12 + 8e-3 * z
              + 2 * np.cos(np.radians(phi)),
              S=35.0, u=0.05 * rng.standard_normal((12, 10, 6)))
    return model, 600.0, 8


def hydro_kernel_inputs(lon, seed, grid=None, tracers=("c",)):
    """u, v, w, ph and ``tracers`` on ``grid`` (default: a 16x12x8 float64
    lat-lon grid over ``lon`` with H = 6), halos filled with the default
    conditions."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.boundary_conditions import (
        fill_halo_regions, regularize_field_boundary_conditions)
    if grid is None:
        grid = ot.LatitudeLongitudeGrid(size=(16, 12, 8), longitude=lon,
                                        latitude=(15, 75), z=(-1800.0, 0.0),
                                        halo=(6, 6, 6), dtype=torch.float64,
                                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    locs = {"u": ("f", "c", "c"), "v": ("c", "f", "c"), "w": ("c", "c", "f"),
            "ph": ("c", "c", "c")}
    locs.update({n: ("c", "c", "c") for n in tracers})
    f = {}
    for name, loc in locs.items():
        a = torch.randn(grid.padded_shape, generator=gen, dtype=torch.float64,
                        device="cuda") * (0.1 if name in "uvw" else 1.0)
        f[name] = fill_halo_regions(a, grid, loc,
                                    regularize_field_boundary_conditions(
                                        None, grid, loc))
    return grid, f


def hydro_vi_cases():
    """(label, grid, vi, tracer scheme, tracer names, coriolis, with ph) of
    the float64 checks: the three VI configurations on the bounded-x
    (0-60°) and periodic-x (0-360°) lat-lon grids with the default
    spherical Coriolis; every other Coriolis branch; three tracers; a
    regular RectilinearGrid (constant metric rows) bounded and periodic in
    x. Every WENO has float64 smoothness."""
    import oceananigans_tpu_torch as ot
    f64 = torch.float64
    vis = {
        "WENOVectorInvariant()": (
            lambda: ot.WENOVectorInvariant(smoothness_dtype=f64),
            lambda: ot.WENO(5, smoothness_dtype=f64), False),
        "WENOVectorInvariant(order=5), BuoyancyTracer": (
            lambda: ot.WENOVectorInvariant(order=5, smoothness_dtype=f64),
            lambda: ot.Centered(2), True),
        "VectorInvariant()": (ot.VectorInvariant, lambda: ot.Centered(2),
                              False),
    }
    hsc = ot.HydrostaticSphericalCoriolis
    cases = []
    for lon in ((0.0, 60.0), (0.0, 360.0)):
        for label, (mvi, mts, with_ph) in vis.items():
            cases.append((f"lon {lon} {label}", lon, None, mvi(), mts(),
                          ("c",), hsc(), with_ph))
    corio = {"no Coriolis": lambda: None,
             "FPlane": lambda: ot.FPlane(f=1e-4),
             "spherical enstrophy-conserving":
                 lambda: hsc(scheme="enstrophy_conserving")}
    for cname, make in corio.items():
        for label in ("WENOVectorInvariant()", "VectorInvariant()"):
            mvi, mts, _ = vis[label]
            cases.append((f"{label} {cname}, ph", (0.0, 60.0), None, mvi(),
                          mts(), ("c",), make(), True))
    for label in ("WENOVectorInvariant()",
                  "WENOVectorInvariant(order=5), BuoyancyTracer"):
        mvi, mts, _ = vis[label]
        cases.append((f"{label} 3 tracers", (0.0, 60.0), None, mvi(), mts(),
                      ("T", "S", "c"), hsc(), False))
    for topo in (("bounded", "bounded", "bounded"),
                 ("periodic", "bounded", "bounded")):
        for label, (mvi, mts, _) in vis.items():
            grid = ot.RectilinearGrid(size=(16, 12, 8),
                                      extent=(4e5, 2.4e5, 1800.0),
                                      halo=(6, 6, 6), topology=topo,
                                      dtype=f64, device="cuda")
            cases.append((f"RectilinearGrid {topo[0]} x {label} FPlane, ph",
                          None, grid, mvi(), mts(), ("c",),
                          ot.FPlane(f=1e-4), True))
    return cases


def hydro_kernels_phase():
    """The hydrostatic path's kernels against their plain versions. Bounds,
    each output relative to its own max|plain|:
    - fused VI tendency, float64 at 16x12x8 (``hydro_vi_cases``): 1e-12
      (FMA contraction and another association order);
    - fused VI tendency, float32 at the path's own shapes (the hydro_row
      state after set() and one step's fills, w from continuity): 2e-5,
      float32 rounding with FMA contraction where a one-ulp change of a
      float32 smoothness ratio τ/(β+ε), squared, moves a nonlinear weight by
      a few ulp (the JAX packed test holds its float32 kernel to 2e-5);
      the same on the CATKE ocean row's state after one step (T, S, e and
      pₕ′ from SeawaterBuoyancy);
    - the wrap with one periodic axis (x on the 0-360° lat-lon grid, y on a
      bounded-x RectilinearGrid), 3-D and 2-D surface fields: exact;
    - the fill at the path's shapes (``fill_check``: bit for bit): every
      location under every condition combination on the bounded
      524x268x44 lat-lon grid in float64 (16 fields, x, y and z in one
      launch); the hydro_row's u, v, T, w as the path fills them, and its
      η, U, V surfaces as the substep loop fills them, in float32, every
      halo overwritten with noise first.
    Returns ({kernel: dict(max_abs_err, ms, plain_ms)}, the model)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    for label, lon, grid, vi, ts, names, coriolis, with_ph in \
            hydro_vi_cases():
        grid, f = hydro_kernel_inputs(lon, seed=5, grid=grid, tracers=names)
        args = (grid, vi, ts, names, coriolis, f["u"], f["v"], f["w"],
                {n: f[n] for n in names}, f["ph"] if with_ph else None)
        Gk = K.fused_vi_tendency(*args)
        Gp = K.fused_vi_tendency_plain(*args)
        err, rel = worst_rel([Gk[0], Gk[1]] + [Gk[2][n] for n in names],
                             [Gp[0], Gp[1]] + [Gp[2][n] for n in names])
        print(f"  fused_vi_tendency 16x12x8 float64 {label}: max abs "
              f"{err:.3e}, rel {rel:.3e}")
        assert rel <= 1e-12, ("fused_vi_tendency", label, rel)
    vi_tile_edge_checks()
    one_axis = {
        "periodic x, bounded y (lat-lon 0-360°)": ot.LatitudeLongitudeGrid(
            size=(16, 12, 8), longitude=(0.0, 360.0), latitude=(15, 75),
            z=(-1800.0, 0.0), halo=(6, 6, 6), dtype=torch.float64,
            device="cuda"),
        "bounded x, periodic y (RectilinearGrid)": ot.RectilinearGrid(
            size=(16, 12, 8), extent=(1.0, 1.0, 1.0), halo=(6, 6, 6),
            topology=("bounded", "periodic", "bounded"), dtype=torch.float64,
            device="cuda")}
    for label, grid in one_axis.items():
        for shape in (grid.padded_shape, grid.padded_shape[:2] + (1,)):
            a = torch.randn(shape, dtype=torch.float64, device="cuda")
            b = a.clone()
            K.periodic_halo_fill(grid, [a])
            K.periodic_halo_fill_plain(grid, [b])
            err = (a - b).abs().max().item()
            print(f"  periodic_halo_fill {label} {tuple(shape)}: max abs "
                  f"{err:.3e}")
            assert err == 0.0, ("periodic_halo_fill one axis", label, err)
    torch.cuda.synchronize()
    # the path's own inputs: the hydro_row state after set(), its fills,
    # w from continuity
    model = hydro_model(HYDRO_N, torch.float32, "cuda")
    fields = model._fill_all(dict(model.state["fields"]))
    w = model._w_from_continuity(fields["u"], fields["v"])
    args = (model.grid, model.momentum_advection, model.tracer_advection,
            ("T",), model.coriolis, fields["u"], fields["v"], w,
            {"T": fields["T"]}, None)
    Gk = K.fused_vi_tendency(*args)
    Gp = K.fused_vi_tendency_plain(*args)
    err, rel = worst_rel([Gk[0], Gk[1], Gk[2]["T"]],
                         [Gp[0], Gp[1], Gp[2]["T"]])
    print(f"  fused_vi_tendency {HYDRO_N} float32 (hydro_row after set()): "
          f"max abs {err:.3e}, rel {rel:.3e} (bound 2e-5)")
    assert rel <= 2e-5, ("fused_vi_tendency float32", rel)
    del Gk, Gp
    ms = cuda_ms(lambda: K.fused_vi_tendency(*args))
    plain_ms = cuda_ms(lambda: K.fused_vi_tendency_plain(*args), reps=5)
    print(f"  time fused_vi_tendency at {model.grid.padded_shape}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    out = {"fused_vi_tendency": dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms)}
    del args
    # the CATKE ocean row's own inputs after one step (e is zero at set()):
    # T, S and e, pₕ′ from SeawaterBuoyancy
    ocean = ocean_model(HYDRO_N, torch.float32, "cuda")
    ocean.time_step(OCEAN_DT)
    ofields = ocean._fill_all(dict(ocean.state["fields"]))
    ow = ocean._w_from_continuity(ofields["u"], ofields["v"])
    ph = ocean._hydrostatic_pressure(ofields)
    names = ocean.tracer_names
    oargs = (ocean.grid, ocean.momentum_advection, ocean.tracer_advection,
             names, ocean.coriolis, ofields["u"], ofields["v"], ow,
             {n: ofields[n] for n in names}, ph)
    Gk = K.fused_vi_tendency(*oargs)
    Gp = K.fused_vi_tendency_plain(*oargs)
    oerr, orel = worst_rel([Gk[0], Gk[1]] + [Gk[2][n] for n in names],
                           [Gp[0], Gp[1]] + [Gp[2][n] for n in names])
    print(f"  fused_vi_tendency {HYDRO_N} float32 (CATKE ocean row after "
          f"one step: tracers {names}, pₕ′ from SeawaterBuoyancy): max abs "
          f"{oerr:.3e}, rel {orel:.3e} (bound 2e-5)")
    assert orel <= 2e-5, ("fused_vi_tendency ocean float32", orel)
    del Gk, Gp, oargs, ocean, ofields, ow, ph
    torch.cuda.empty_cache()
    # the fill at the path's shapes: every condition combination in float64
    grid = model.grid
    grid64 = ot.LatitudeLongitudeGrid(size=HYDRO_N, longitude=(0, 60),
                                      latitude=(15, 75), z=(-1800.0, 0.0),
                                      halo=grid.H, dtype=torch.float64,
                                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    combos = rotated_locs_bcs(16)
    fill_check("hydrostatic 524x268x44, every combination", grid64,
               [torch.randn(grid64.padded_shape, generator=gen,
                            dtype=torch.float64, device="cuda")
                for _ in combos], combos)
    del grid64
    torch.cuda.empty_cache()

    def noisy(a):
        """``a`` with every halo slot overwritten with noise."""
        b = torch.randn(a.shape, generator=gen, dtype=a.dtype, device="cuda")
        ints = tuple(slice(h, h + n) if s > 1 else slice(None)
                     for h, n, s in zip(grid.H, grid.N, a.shape))
        b[ints] = a[ints]
        return b

    # u, v, T and w as the path fills them (all three axes), and η, U, V
    # as the substep loop fills them (x and y)
    names = ("u", "v", "T", "w")
    path = [noisy(fields[n] if n != "w" else w) for n in names]
    locs_bcs = model_locs_bcs(model, names)
    err = fill_check("hydrostatic u, v, T, w", grid, path, locs_bcs)
    out["fill_halos_bounded"] = time_fill(
        "hydrostatic u, v, T, w (x, y and z)", grid, path, locs_bcs, err)
    bt = model.state["barotropic"]
    surfaces = [noisy(fields["eta"]), noisy(bt["U"]), noisy(bt["V"])]
    sbcs = [(("c", "c", "c"), model.bcs["eta"]), (("f", "c", "c"),
                                                   model.bcs["u"]),
            (("c", "f", "c"), model.bcs["v"])]
    err = fill_check("hydrostatic η, U, V surfaces", grid, surfaces, sbcs,
                     z=False)
    out["fill_halos_surfaces"] = time_fill(
        "hydrostatic η, U, V surfaces (x and y)", grid, surfaces, sbcs, err,
        z=False)
    return out, model


def hydro_phase_shares(model, dt, steps, card):
    """Per-step CUDA-event times of the hydrostatic step: the fused
    tendency kernel, the fills (one launch each, outside the substep loop),
    the split-explicit substep loop (its fills of η, U, V included), w from
    continuity (its fills excluded), and the rest."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    import oceananigans_tpu_torch.models.hydrostatic as hs
    timer = PhaseTimer()
    saved = (hs.fused_vi_tendency, hf.fill_halos)
    hs.fused_vi_tendency = timer.wrap("kernel", saved[0])
    hf.fill_halos = timer.wrap("fills", saved[1])
    fs = model.free_surface
    fs.substep = timer.wrap("substep", fs.substep)
    model._w_from_continuity = timer.wrap("w", model._w_from_continuity)
    model.time_step = timer.wrap("step", model.time_step)
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        hs.fused_vi_tendency, hf.fill_halos = saved
        del fs.substep
        for name in ("_w_from_continuity", "time_step"):
            delattr(model, name)
    g = t.get
    shares = {
        "fused_vi_tendency kernel": g("kernel", 0.0),
        "fills (outside the substep loop)":
            g("fills", 0.0) - g("fills@substep", 0.0),
        "split-explicit substep loop (its fills included)":
            g("substep", 0.0),
        "w from continuity (its fills excluded)":
            g("w", 0.0) - g("fills@w", 0.0),
    }
    shares["rest (hydrostatic pressure, AB2, corrector, allocations, "
           "host gaps)"] = t["step"] - sum(shares.values())
    print(f"hydrostatic step phases, ms per step over {steps} steps (CUDA "
          f"events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.1f}%)")
    print(f"  (fills inside the substep loop: "
          f"{g('fills@substep', 0.0):.4f} ms)")
    print(f"  step: {t['step']:.4f} ms")
    return shares


def hydro_path_phase(card, model):
    """The hydro_row at 512x256x32 float32 (``model`` as set()): counters
    reset just before the steps and read just after; 3 warm-up and 12 timed
    steps of Δt = 120 s."""
    from oceananigans_tpu_torch import kernels as K
    dt = 120.0
    assert model.uses_kernel, "the hydrostatic model does not take the kernel"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    for _ in range(3):
        model.time_step(dt)
    torch.cuda.synchronize()
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    print(f"hydrostatic path launches over {steps} steps: {launches}; plain "
          f"calls on CUDA: {plain_cuda}")
    assert launches["fused_vi_tendency"] == steps, \
        ("fused_vi_tendency launches", launches["fused_vi_tendency"], steps)
    assert launches["fill_halos"] > 0
    assert plain_cuda["fill_bounded_axis"] == 0, "a plain x/y fill ran"
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    peak = torch.cuda.max_memory_allocated()
    for name in model.prognostic_names + ("w",):
        a = model.field(name).interior
        assert torch.isfinite(a).all().item(), f"{name} is not finite"
    u = model.field("u").interior
    eta = model.field("eta").interior
    assert u.shape == (513, 256, 32) and eta.shape == (512, 256, 1)
    print(f"hydrostatic: max|u| {u.abs().max().item():.4e}, max|η| "
          f"{eta.abs().max().item():.4e} after {steps} steps")
    n = HYDRO_N[0] * HYDRO_N[1] * HYDRO_N[2]
    step_ms = statistics.median(times) * 1e3
    print(f"hydrostatic path: {HYDRO_N[0]}x{HYDRO_N[1]}x{HYDRO_N[2]} lat-lon "
          f"WENO-VI split-explicit(30) float32 QAB2 step median "
          f"{step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n / (step_ms / 1e3):.4e} cell-updates/s [{card}]")
    print(f"peak device memory (steps): {peak / 2 ** 30:.2f} GiB")
    per_step = {k: launches[k] / steps for k in HYDRO_KERNELS}
    print(f"launches per step: {per_step}")
    hydro_phase_shares(model, dt, 3, card)
    busy_share("hydrostatic path", model, dt, 3, step_ms, card)
    return launches, step_ms


# -- the mesh-sharded paths: a 2x2 mesh of the one card ---------------------------

MESH_SHAPE = (2, 2)


def card_mesh():
    """Distributed(Partition(2, 2)) over cuda:0 named four times: four blocks
    on one card, their strips moved by the exchange kernel."""
    import oceananigans_tpu_torch as ot
    return ot.Distributed(ot.Partition(*MESH_SHAPE),
                          devices=[torch.device("cuda", 0)] * 4)


def exchange_bound(block_shape, halo, n_fields, n_blocks, esize):
    """The exchange reads and writes each halo element of every block once:
    per block-field two x strips (Hx·PY·PZ) and two y strips (PX·Hy·PZ)."""
    PX, PY, PZ = block_shape
    strips = 2 * halo[0] * PY * PZ + 2 * PX * halo[1] * PZ
    return bound(esize * 2 * strips * n_fields * n_blocks, 0)


def random_blocks(shape, nl, halo, z, nf, dtype, seed, devices=None):
    """A (Sx, Sy) nested list of nf random locally padded blocks each."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bshape = (nl[0] + 2 * halo[0], nl[1] + 2 * halo[1], z)
    return [[[torch.randn(bshape, generator=gen, dtype=dtype,
                          device="cuda").to(devices[i * shape[1] + j]
                                            if devices else "cuda")
              for _ in range(nf)] for j in range(shape[1])]
            for i in range(shape[0])]


def exchange_check(mesh, blocks, halo, nl):
    """The exchange of ``blocks`` against the plain version on copies: the
    largest difference (the routes copy, so it must be 0) and the copies."""
    from oceananigans_tpu_torch.parallel import (halo_exchange_local,
                                                 halo_exchange_plain)
    copies = [[[a.clone() for a in b] for b in row] for row in blocks]
    halo_exchange_local(blocks, mesh, halo, nl)
    halo_exchange_plain(copies, mesh, halo, nl)
    err = max((a - c).abs().max().item()
              for row, crow in zip(blocks, copies) for b, cb in zip(row, crow)
              for a, c in zip(b, cb))
    return err, copies


def stitch(parts, S, halo=None):
    """One tensor on cuda:0 from per-shard tensors in rank order: their
    interiors (``halo`` (Hx, Hy) given) along the first two axes, or (nf,
    nlx, nly, nz) tendencies along the next two."""
    if halo is not None:
        parts = [p[halo[0]:p.shape[0] - halo[0], halo[1]:p.shape[1] - halo[1]]
                 for p in parts]
        ax = (0, 1)
    else:
        ax = (1, 2)
    parts = [p.to("cuda:0") for p in parts]
    return torch.cat([torch.cat(parts[i * S[1]:(i + 1) * S[1]], dim=ax[1])
                      for i in range(S[0])], dim=ax[0])


def mesh_kernels_phase(n_sw, n_conv):
    """The mesh paths' pieces against their plain versions:
    - the exchange (``halo_exchange_local``: the kernel for blocks on one
      card) against ``halo_exchange_plain`` at both paths' shapes: four
      blocks of 8200²x1 (uh, vh, h; H = (4, 4, 0)) and of 134x134x262 (u, v,
      w, b; H = (3, 3, 3), exchanged (3, 3, 0)), float32: exact (copies);
    - over distinct devices when more than one card is visible (peer copies);
    - #9 and #7 on resident blocks (``Distributed.scatter``) in float64 at
      small size, kernel route against plain route: shallow water at 128²
      (WENO(5) with float64 smoothness, FPlane(0.3), an array bathymetry, a
      tracer; both stage variants) and the convection tendency at 32³
      (WENO(5) with float64 smoothness and Centered(2)); bound 1e-12
      relative to each output's max|plain| (the per-shard kernels' FMA
      contraction and association order).
    Returns {name: dict(max_abs_err, ms, plain_ms)} of the exchange at the
    two paths' shapes (one call: the x and the y launch), timed as device
    work: the call's host work (the strip tables, about 0.4 ms) exceeds its
    device work, and on the paths it overlaps the kernels queued ahead."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.parallel import (halo_exchange_local,
                                                 halo_exchange_plain)
    arch = card_mesh()
    mesh = arch.mesh
    out = {}
    for name, n, halo, z, nf in (
            ("mesh_halo_exchange", n_sw, (4, 4, 0), 1, 3),
            ("mesh_halo_exchange_conv", n_conv, (3, 3, 0), n_conv + 6, 4)):
        nl = (n // 2, n // 2)
        blocks = random_blocks(MESH_SHAPE, nl, halo, z, nf, torch.float32, 12)
        err, copies = exchange_check(mesh, blocks, halo, nl)
        shape = tuple(blocks[0][0][0].shape)
        print(f"  halo exchange, 2x2 blocks of {shape} x {nf} fields, halo "
              f"{halo}: max abs {err:.3e} (bound 0)")
        assert err == 0.0, ("halo exchange", shape, err)
        kernel = lambda: halo_exchange_local(blocks, mesh, halo, nl)
        plain = lambda: halo_exchange_plain(copies, mesh, halo, nl)
        call_ms, plain_call_ms = cuda_ms(kernel), cuda_ms(plain, reps=5)
        ms, plain_ms = device_ms(kernel), device_ms(plain, reps=5)
        print(f"  time halo exchange at {shape} x {nf} x 4 blocks, device "
              f"work (card busy ahead): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; whole call from an idle card (host "
              f"launch work included): kernel {call_ms:.4f} ms, plain "
              f"{plain_call_ms:.4f} ms")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del blocks, copies
        torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        devices = [torch.device("cuda", k % n_cards) for k in range(4)]
        peer = ot.Distributed(ot.Partition(*MESH_SHAPE), devices=devices).mesh
        blocks = random_blocks(MESH_SHAPE, (64, 64), (3, 3, 0), 16, 2,
                               torch.float64, 13, devices)
        err, _ = exchange_check(peer, blocks, (3, 3, 0), (64, 64))
        print(f"  halo exchange over {n_cards} cards (peer copies between "
              f"them): max abs {err:.3e} (bound 0)")
        assert err == 0.0, ("peer-copy exchange", err)
    else:
        print("  the peer-copy route (strips between distinct cards) did not "
              "run: one card is visible")
    # #9 and #7 on resident blocks at small size
    grid, fields, hB, Gm = sw_kernel_inputs(128, torch.float64, ("c",), seed=14)
    names = SW_NAMES + ("c",)
    args = (grid, ot.WENO(5, smoothness_dtype=torch.float64), 9.81, 0.3, hB,
            names, mesh)
    stage = K.build_sharded_fused_sw_update(*args)
    plain = K.build_sharded_fused_sw_update_plain(*args)
    gms = [Gm[:, i * 64:(i + 1) * 64, j * 64:(j + 1) * 64].contiguous()
           for i in range(2) for j in range(2)]
    H = grid.H
    for gm in (None, gms):
        Gk, nk = stage(arch.scatter(fields, H), gm, 2e-5, -1e-5)
        Gp, np_ = plain(arch.scatter(fields, H), gm, 2e-5, -1e-5)
        err, rel = worst_rel(
            [stitch(Gk, MESH_SHAPE)] + [stitch([b[c] for b in nk], MESH_SHAPE,
                                               H) for c in names],
            [stitch(Gp, MESH_SHAPE)] + [stitch([b[c] for b in np_],
                                               MESH_SHAPE, H) for c in names])
        print(f"  #9 on resident blocks 128^2 float64 on 2x2, "
              f"Gm={gm is not None}: max abs {err:.3e}, rel {rel:.3e}")
        assert rel <= 1e-12, ("sharded shallow-water stage", rel)
    grid, cfields, specs = convection_kernel_inputs((32, 32, 32),
                                                    torch.float64, seed=15)
    K.bounded_z_fill_plain(grid, cfields, specs)
    K.periodic_halo_fill_plain(grid, cfields)
    for scheme in (ot.WENO(5, smoothness_dtype=torch.float64), ot.Centered(2)):
        Gk = K.build_sharded_fused_advection(grid, scheme, mesh)(
            arch.scatter(cfields, grid.H))
        Gp = K.build_sharded_fused_advection_plain(grid, scheme, mesh)(
            arch.scatter(cfields, grid.H))
        err, rel = worst_rel([stitch(Gk, MESH_SHAPE)],
                             [stitch(Gp, MESH_SHAPE)])
        print(f"  #7 on resident blocks 32^3 float64 on 2x2 {scheme!r}: "
              f"max abs {err:.3e}, rel {rel:.3e}")
        assert rel <= 1e-12, ("sharded advection tendency", scheme, rel)
    torch.cuda.synchronize()
    return out


def state_bytes(model):
    """The bytes of the state a sharded model holds: every shard's blocks
    (fields, pressure and G⁻ where the model keeps them)."""
    total = 0
    for m in model._shards:
        for key in ("fields", "pressure", "Gm"):
            v = m._state.get(key)
            for a in (v.values() if isinstance(v, dict) else
                      () if v is None else (v,)):
                total += a.numel() * a.element_size()
    return total


def resident_profile(label, model, dt, steps, step_ms, card, kernel_key):
    """The device's view of ``steps`` steady steps of a sharded model
    (torch.profiler): the busy share (the union of the device activities
    per step over the median step ``step_ms``), the device kernels a step,
    and the shares of the step held by the exchange kernel, by the
    per-shard stage kernel (names holding ``kernel_key``), by the fill
    kernel and by the FFTs (names holding "fft"). Returns the shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.time_step(dt)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"{label}: torch.profiler shows no device time [{card}]")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_ms = busy / 1e3 / steps
    kernels = [e for e in events
               if not e.name.startswith(("Memcpy", "Memset"))]

    def device_ms_of(*keys):
        return sum((e.time_range.end - e.time_range.start) for e in kernels
                   if any(k in e.name.lower() for k in keys)) / 1e3 / steps

    shares = {"exchange": device_ms_of("exchange"),
              "stage kernel": device_ms_of(kernel_key),
              "fill": device_ms_of("fill_halos"),
              "fft": device_ms_of("fft")}
    print(f"{label}: device kernels per step {len(kernels) / steps:.1f}, "
          f"device busy {busy_ms:.4f} ms per step: busy share "
          f"{busy_ms / step_ms:.4f} of the {step_ms:.3f} ms median step "
          f"(torch.profiler, {steps} steps) [{card}]")
    print(f"{label}: device time per step by kernel: "
          + ", ".join(f"{k} {v:.4f} ms ({100 * v / step_ms:.2f}% of the "
                      f"step)" for k, v in shares.items())
          + f"; no cut or stitch (resident blocks) [{card}]")
    shares["busy"] = busy_ms / step_ms
    shares["kernels"] = len(kernels) / steps
    return shares


def timed_steps(model, dt, warmup=3, timed=10):
    for _ in range(warmup):
        model.time_step(dt)
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def check_mesh_launches(launches, plain_cuda, expect):
    for name, count in expect.items():
        assert launches[name] == count, (name, launches[name], count)
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"


def against_serial(label, sharded, serial, names, bound_rel):
    """The worst difference of the sharded model's fields from the serial
    model's after the same steps, each relative to its max|serial|."""
    worst_abs, worst = 0.0, 0.0
    for name in names:
        a, b = sharded.field(name).interior, serial.field(name).interior
        err = (a - b).abs().max().item()
        rel = err / b.abs().max().item()
        print(f"  {label} sharded against serial after {sharded.iteration} "
              f"steps, {name}: max abs {err:.3e}, rel {rel:.3e}")
        worst_abs, worst = max(worst_abs, err), max(worst, rel)
    print(f"{label}: sharded against serial, worst relative difference "
          f"{worst:.3e} (bound {bound_rel:g}); "
          f"{'bit for bit' if worst_abs == 0.0 else 'not bit for bit'}")
    assert worst <= bound_rel, (label, "sharded against serial", worst)
    return worst


def pencil_twin_check(label, sharded, serial, builder, state0, dt, names,
                      diff):
    """Where the sharded step rounds apart from the serial one: the serial
    model rebuilt by ``builder`` from ``state0`` with the pencil solver (its
    global entry, 4 slabs of cuda:0) as its pressure solver, stepped as
    often as the sharded model with ``dt``. The sharded model against this
    twin isolates the decomposition (bound a tenth of ``diff``, the sharded
    model's difference from the serial one); the twin against the serial
    model, the pressure solver's transform order."""
    from oceananigans_tpu_torch.parallel import DistributedFFTPoissonSolver
    twin = builder(tuple(serial.grid.N), torch.float32, "cuda", state=state0,
                   pressure_solver=lambda g: DistributedFFTPoissonSolver(
                       g, [torch.device("cuda", 0)] * 4))
    for _ in range(sharded.iteration):
        twin.time_step(dt)

    def worst(a, b):
        return max((a.field(n).interior - b.field(n).interior).abs().max()
                   .item() / b.field(n).interior.abs().max().item()
                   for n in names)

    solver, decomposition = worst(twin, serial), worst(sharded, twin)
    print(f"{label}: the serial model with the pencil solver against the "
          f"serial model {solver:.3e}; the sharded model against it "
          f"{decomposition:.3e}{' (bit for bit)' if decomposition == 0 else ''}"
          f" (bound {0.1 * diff:.3e}, a tenth of the sharded model's "
          f"{diff:.3e} from the serial one): the pencil's transform order, "
          f"not the decomposition, rounds the sharded step apart")
    assert decomposition <= 0.1 * diff, (label, "decomposition", decomposition)
    del twin


def resident_report(label, model, times, base, card):
    """Step median, min and max, and peak memory against the state the
    shards hold."""
    peak = torch.cuda.max_memory_allocated() - base
    held = state_bytes(model)
    step_ms = statistics.median(times) * 1e3
    n = int(np.prod(model.grid.N))
    print(f"{label} on a 2x2 mesh of one card (resident blocks): step median "
          f"{step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n / (step_ms / 1e3):.4e} cell-updates/s [{card}]")
    print(f"{label}: peak device memory (model and steps, above what was "
          f"held before) {peak / 2 ** 30:.2f} GiB against {held / 2 ** 30:.2f}"
          f" GiB of state in the shards' blocks [{card}]")
    return step_ms


def sharded_sw_path_phase(card, n, serial, state0):
    """The shallow-water path at n² float32 on the 2x2 mesh of the card, from
    the serial path's initial state scattered into resident blocks:
    counters reset after the model is built and read after 3 warm-up and
    10 timed steps (#9 and #8 once per shard and stage, the exchange twice
    per stage, no plain version on CUDA tensors); finite fields, mass
    conservation; the device profile (busy share, kernels a step, the
    exchange's share); the fields against the serial model's after the
    same 16 steps (bound 0: the shards take the global spacing, and with no
    bathymetry every cell sees the serial operands); #9 against its plain
    route on the final blocks (float32, bound 1e-5 relative, as #8)."""
    from oceananigans_tpu_torch import kernels as K
    dt = 1e-5
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = sw_model(n, torch.float32, "cuda", architecture=card_mesh(),
                     state=state0)
    assert model._shards is not None
    mass0 = model.field("h").interior.double().sum().item()
    K.reset_counters()
    times = timed_steps(model, dt)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    print(f"sharded shallow-water path launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain_cuda.items() if v} }")
    stages = 3 * steps
    check_mesh_launches(launches, plain_cuda, {
        "build_sharded_fused_sw_update": 4 * stages,
        "fused_sw_update": 4 * stages, "mesh_halo_exchange": 2 * stages})
    step_ms = resident_report("sharded shallow-water path", model, times,
                              base, card)
    for name in SW_NAMES:
        a = model.field(name).interior
        assert a.shape == (n, n, 1), (name, a.shape)
        assert torch.isfinite(a).all().item(), f"{name} is not finite"
    mass = model.field("h").interior.double().sum().item()
    drift = abs(mass - mass0) / mass0
    print(f"sharded shallow water: |Σh − Σh₀|/Σh₀ after {steps} steps: "
          f"{drift:.3e} (bound 1e-9)")
    assert drift < 1e-9, ("mass not conserved", drift)
    resident_profile("sharded shallow-water path", model, dt, 3, step_ms,
                     card, "sw")
    against_serial("shallow water", model, serial, SW_NAMES, 0.0)
    # #9 against its plain route on the model's own blocks
    args = (model.grid, model.advection, model.g, 0.0, model.bathymetry,
            SW_NAMES, model.architecture.mesh)
    stage = K.build_sharded_fused_sw_update(*args)
    plain = K.build_sharded_fused_sw_update_plain(*args)
    blocks = [dict(m._state["fields"]) for m in model._shards]
    Gm = stage(blocks, None, 2e-5, 0.0)[0]
    run = (blocks, Gm, 2e-5, -1e-5)
    H = model.grid.H
    Gk, nk = stage(*run)
    Gp, np_ = plain(*run)
    err, rel = worst_rel(
        [stitch(Gk, MESH_SHAPE)] + [stitch([b[c] for b in nk], MESH_SHAPE, H)
                                    for c in SW_NAMES],
        [stitch(Gp, MESH_SHAPE)] + [stitch([b[c] for b in np_], MESH_SHAPE, H)
                                    for c in SW_NAMES])
    print(f"  #9 on the path's resident blocks {n}^2 float32 on 2x2 (G⁻ "
          f"variant): max abs {err:.3e}, rel {rel:.3e} (bound 1e-5)")
    assert rel <= 1e-5, ("sharded shallow-water stage float32", rel)
    del Gk, nk, Gp, np_
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: stage(*run), reps=5)
    plain_ms = cuda_ms(lambda: plain(*run), reps=3, warmup=1)
    print(f"  time #9 (G⁻ variant) on the 2x2 blocks of {n}^2: kernel route "
          f"{ms:.4f} ms, plain route {plain_ms:.4f} ms [{card}]")
    return launches, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def sharded_tendency_check(label, model, n, card):
    """#7 against its plain route on a sharded model's resident blocks,
    filled by the model's own fill (bound 2e-5 of each component's term
    scale), and its times."""
    from oceananigans_tpu_torch import kernels as K
    grid, scheme, mesh = model.grid, model.advection, model.architecture.mesh
    blocks = model._run(lambda m: [m._fill_all(dict(m._state["fields"]))[c]
                                   for c in m.prognostic_names])
    stage = K.build_sharded_fused_advection(grid, scheme, mesh)
    plain = K.build_sharded_fused_advection_plain(grid, scheme, mesh)
    Gk, Gp = stitch(stage(blocks), MESH_SHAPE), stitch(plain(blocks),
                                                       MESH_SHAPE)
    q = [model.field(c).data for c in model.prognostic_names]
    err, rel = scaled_err(list(Gk), list(Gp), term_scales(grid, scheme, q))
    print(f"  #7 on the path's resident blocks {label} float32 on 2x2: max "
          f"abs {err:.3e}, {rel:.3e} of the term scale (bound 2e-5)")
    assert rel <= 2e-5, (label, "sharded advection tendency float32", rel)
    del Gk, Gp, q
    ms = cuda_ms(lambda: stage(blocks))
    plain_ms = cuda_ms(lambda: plain(blocks), reps=5)
    print(f"  time #7 on the 2x2 blocks of {label}: kernel route {ms:.4f} "
          f"ms, plain route {plain_ms:.4f} ms [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def sharded_convection_path_phase(card, n, serial, state0):
    """The convection path at n³ float32 on the 2x2 mesh of the card, from
    the serial path's initial state scattered into resident blocks:
    counters reset after the model is built and read after 3 warm-up and
    10 timed steps (#7 and #6 once per shard and stage, the exchange kernel
    at every fill); finite fields, the divergence at roundoff; the device
    profile; the fields against the serial model's after the same 16 steps
    (bound 1e-4 relative: the pencil solver rounds apart from the serial
    one, which ``pencil_twin_check`` shows); #7 against its plain route on
    the path's own blocks (bound 2e-5 of each component's term scale: the
    b tendency cancels its flux
    differences about 100-fold, so a bound relative to max|G| would measure
    that cancellation)."""
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.models.nonhydrostatic import \
        _interior_divergence
    dt = 1e-3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = convection_model((n, n, n), torch.float32, "cuda",
                             architecture=card_mesh(), state=state0)
    assert model._sharded_advection is not None
    K.reset_counters()
    times = timed_steps(model, dt)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    print(f"sharded convection path launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain_cuda.items() if v} }")
    stages = 3 * steps
    check_mesh_launches(launches, plain_cuda, {
        "build_sharded_fused_advection": 4 * stages,
        "fused_advection_tendency": 4 * stages})
    assert launches["mesh_halo_exchange"] >= 2 * stages
    assert launches["fill_halos"] > 0
    step_ms = resident_report("sharded convection path", model, times, base,
                              card)
    state = model.state
    fields = state["fields"]
    for name in ("u", "v", "w", "b"):
        assert torch.isfinite(fields[name]).all().item(), f"{name} not finite"
    ints = model.grid.interior_slices
    u, v, w = (fields[c] for c in "uvw")
    model._fill_all(dict(u=u, v=v, w=w))
    div = _interior_divergence(model.grid, u, v, w)
    umax = max(a[ints].abs().max().item() for a in (u, v, w))
    div_rel = div.abs().max().item() * model.grid.dx(("c", "c", "c")) / umax
    print(f"sharded convection: max|div u|·Δx/max|u| after {steps} steps: "
          f"{div_rel:.3e}")
    assert div_rel < 1e-4, ("divergence not at roundoff", div_rel)
    del state, fields, u, v, w, div
    resident_profile("sharded convection path", model, dt, 3, step_ms, card,
                     "advection")
    # 1e-4: the pencil solver's float32 rounding (1.4e-6 of max|φ| against
    # the serial solve's 1.3e-6 at 256³) grows over 48 solves of a small
    # flow (max|u| 2.5e-3): 1.754e-5 after 16 steps on an H100 80GB HBM3 at
    # 700 W; the twin shows that the pencil, not the decomposition, makes it
    diff = against_serial("convection", model, serial, ("u", "v", "w", "b"),
                          1e-4)
    pencil_twin_check("convection", model, serial, convection_model, state0,
                      dt, ("u", "v", "w", "b"), diff)
    del serial
    torch.cuda.empty_cache()
    return launches, sharded_tendency_check(f"{n}^3", model, n, card)


# -- tracers and buoyancy on the z-compact layout -----------------------------------

N_TRACERS = 12
TRACER_KERNELS = ("fused_advection_update", "fused_divergence",
                  "fused_correct", "fill_halos")
BUOYANT_KERNELS = ("fused_advection_tendency", "fill_halos",
                   "fused_divergence", "fused_correct")


def compact_bounds(N, H, esize, n_tracers):
    """Bounds at interior N, halo H = (Hx, Hy, 0), of #1's corrected G⁻
    variant over u, v, w and n_tracers tracers (WENO(5)), and of the
    z-compact #6 (and #7) over u, v, w and n_tracers tracers."""
    import oceananigans_tpu_torch as ot
    cells = N[0] * N[1] * N[2]
    padded = (N[0] + 2 * H[0]) * (N[1] + 2 * H[1]) * N[2]
    nc = 3 + n_tracers
    return {
        # read u, v, w, p and the tracers (padded) and G⁻; write G and new;
        # the correction of u, v, w: 3 x (difference, product, difference)
        "fused_advection_update_tracers": bound(
            esize * ((nc + 1) * padded + 2 * nc * cells + nc * padded),
            cells * (advection_flop(ot.WENO(5), 3, n_tracers) + 9
                     + nc * UPDATE_FLOP)),
        "fused_advection_tendency_compact": bound(
            esize * nc * (padded + cells),
            cells * advection_flop(ot.WENO(5), 3, n_tracers)),
    }


def term_scales(grid, scheme, fields):
    """Per component of ``fields`` = [u, v, w, tracers...] (padded, halos
    filled), the largest of its three directional flux differences,
    max|δ(F)|/V over the interior: the size of the terms whose sum is G. A
    tendency can cancel these terms (on the convection path the b tendency
    is about 100 times smaller than its terms), so the float32 checks hold
    the kernels' rounding to a bound relative to the terms, not to max|G|."""
    from oceananigans_tpu_torch.advection import (div_Uc, div_Uu, div_Uv,
                                                  div_Uw)
    from oceananigans_tpu_torch.kernels.fused_advection import ZBC
    zbc = ZBC if grid.H[2] == 0 and grid.topology[2] == "bounded" else None
    u, v, w = fields[:3]
    ints = grid.interior_slices
    zero = torch.zeros_like(u)
    scales = [max(div(grid, scheme, u, v, w, zbc=zbc, only_axis=ax)[ints]
                  .abs().max().item() for ax in range(3))
              for div in (div_Uu, div_Uv, div_Uw)]
    for c in fields[3:]:
        scales.append(max(
            div_Uc(grid, scheme, *vel, c, zbc=zbc)[ints].abs().max().item()
            for vel in ((u, zero, zero), (zero, v, zero), (zero, zero, w))))
    return scales


def scaled_err(got, want, scales):
    """(max abs difference, the largest difference over its component's
    term scale; a component whose terms all vanish, w on a flat z, must
    agree exactly)."""
    diffs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    return max(diffs), max(d / s if s else (0.0 if d == 0 else float("inf"))
                           for d, s in zip(diffs, scales))


def tracer_kernel_inputs(N, dtype, n_tracers, seed):
    """u, v, w (0.1·N(0, 1), w's bottom face 0), p (1e-3·N(0, 1)) and
    n_tracers tracers uniform on [0, 1) on a z-compact grid with H = (4, 4,
    0), halos wrapped, and G⁻ for the 3 + n_tracers components."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import periodic_halo_fill
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=(4, 4, 0),
                              dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = grid.padded_shape
    u, v, w, p = (s * torch.randn(shape, generator=gen, dtype=dtype,
                                  device="cuda") for s in (0.1, 0.1, 0.1, 1e-3))
    w[..., 0] = 0
    tracers = {f"c{i}": torch.rand(shape, generator=gen, dtype=dtype,
                                   device="cuda") for i in range(n_tracers)}
    periodic_halo_fill(grid, [u, v, w, p] + list(tracers.values()))
    Gm = [torch.randn(N, generator=gen, dtype=dtype, device="cuda")
          for _ in range(3 + n_tracers)]
    return grid, (u, v, w), p, tracers, Gm


def tracer_kernels_phase():
    """The kernels of the z-compact routes with 12 tracers, and the lifted
    caps, against their plain versions in float64 at small size, bound 1e-12
    relative to each tensor's own max|plain| (FMA contraction and another
    association order):
    - #1 (fused_advection_update) over u, v, w and 12 tracers at 32x32x48,
      WENO(5) with float64 smoothness and Centered(2), with and without G⁻
      and the deferred correction;
    - #6 z-compact (mirrored z reads) with 12 tracers, both schemes;
    - #7 on z-compact blocks of the 2x2 mesh of the card, 12 tracers: equal
      to the serial #6 (bound 0) and within 1e-12 of its plain route;
    - a launch over 12 tracers equals 12 one-tracer launches (bound 0), for
      #1 and #6;
    - #6 padded with 12 tracers at 32³ (H = (3, 3, 3)), #8 with 12 tracers at
      256², and the wrap and bounded-z fill of 20 fields (bit for bit)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.kernels import ZFill
    arch = card_mesh()
    mesh = arch.mesh
    N = (32, 32, 48)
    grid, (u, v, w), p, tracers, Gm = tracer_kernel_inputs(
        N, torch.float64, N_TRACERS, seed=20)
    for scheme in (ot.WENO(5, smoothness_dtype=torch.float64), ot.Centered(2)):
        for gm in (None, Gm):
            for pp in (None, p):
                args = (grid, scheme, u, v, w, gm, 0.1, -0.05, pp,
                        0.07 if pp is not None else None)
                Gk, nk = K.fused_advection_update(*args, tracers=tracers)
                Gp, np_ = K.fused_advection_update_plain(*args,
                                                         tracers=tracers)
                err, rel = worst_rel(Gk + list(nk.values()),
                                     Gp + list(np_.values()))
                print(f"  fused_advection_update {N} float64 {scheme!r} "
                      f"{N_TRACERS} tracers Gm={gm is not None} "
                      f"corr={pp is not None}: max abs {err:.3e}, rel "
                      f"{rel:.3e}")
                assert rel <= 1e-12, ("fused_advection_update tracers", rel)
        args = (grid, scheme, u, v, w, Gm, 0.1, -0.05, p, 0.07)
        Gk, nk = K.fused_advection_update(*args, tracers=tracers)
        for k, (name, c) in enumerate(tracers.items()):
            G1, n1 = K.fused_advection_update(
                *args[:5], Gm[:3] + [Gm[3 + k]], *args[6:], tracers={name: c})
            assert torch.equal(G1[3], Gk[3 + k]), ("#1 batching", name)
            assert torch.equal(n1[name], nk[name]), ("#1 batching", name)
        fields = [u, v, w] + list(tracers.values())
        Gk = K.fused_advection_tendency(grid, scheme, fields)
        err, rel = worst_rel(list(Gk), list(
            K.fused_advection_tendency_plain(grid, scheme, fields)))
        print(f"  fused_advection_tendency z-compact {N} float64 {scheme!r} "
              f"{N_TRACERS} tracers: max abs {err:.3e}, rel {rel:.3e}")
        assert rel <= 1e-12, ("z-compact tendency", scheme, rel)
        for k, c in enumerate(fields[3:]):
            G1 = K.fused_advection_tendency(grid, scheme, [u, v, w, c])
            assert torch.equal(G1[3], Gk[3 + k]), ("#6 batching", k)
        Gs = stitch(K.build_sharded_fused_advection(grid, scheme, mesh)(
            arch.scatter(fields, grid.H)), MESH_SHAPE)
        assert torch.equal(Gs, Gk), ("z-compact #7 against serial #6", scheme)
        err, rel = worst_rel(list(Gs), list(stitch(
            K.build_sharded_fused_advection_plain(grid, scheme, mesh)(
                arch.scatter(fields, grid.H)), MESH_SHAPE)))
        print(f"  sharded advection tendency z-compact {N} float64 on 2x2 "
              f"{scheme!r}: equal to serial; against plain route max abs "
              f"{err:.3e}, rel {rel:.3e}")
        assert rel <= 1e-12, ("z-compact sharded tendency", scheme, rel)
    print(f"  a launch over {N_TRACERS} tracers equals {N_TRACERS} one-tracer "
          f"launches bit for bit (#1 and #6, both schemes)")
    # the padded #6 with 12 tracers
    pgrid, pfields, specs = convection_kernel_inputs((32, 32, 32),
                                                     torch.float64, seed=21)
    gen = torch.Generator(device="cuda").manual_seed(21)
    pfields += [torch.rand(pgrid.padded_shape, generator=gen,
                           dtype=torch.float64, device="cuda")
                for _ in range(N_TRACERS - 1)]
    specs += [ZFill(False, (0, 0.0), (0, 0.0))] * (N_TRACERS - 1)
    K.bounded_z_fill_plain(pgrid, pfields, specs)
    K.periodic_halo_fill_plain(pgrid, pfields)
    scheme = ot.WENO(5, smoothness_dtype=torch.float64)
    err, rel = worst_rel(
        list(K.fused_advection_tendency(pgrid, scheme, pfields)),
        list(K.fused_advection_tendency_plain(pgrid, scheme, pfields)))
    print(f"  fused_advection_tendency padded (32, 32, 32) float64 "
          f"{N_TRACERS} tracers: max abs {err:.3e}, rel {rel:.3e}")
    assert rel <= 1e-12, ("padded tendency, 12 tracers", rel)
    # #8 with 12 tracers
    names = SW_NAMES + tuple(f"c{i}" for i in range(N_TRACERS))
    sgrid, sfields, hB, sGm = sw_kernel_inputs(256, torch.float64, names[3:],
                                               seed=22)
    ints = sgrid.interior_slices
    for gm in (None, sGm):
        args = (sgrid, scheme, 9.81, 0.3, hB, names, sfields, gm, 2e-5, -1e-5)
        Gk, nk = K.fused_sw_update(*args)
        Gp, np_ = K.fused_sw_update_plain(*args)
        err, rel = worst_rel(list(Gk) + [nk[c][ints] for c in names],
                             list(Gp) + [np_[c][ints] for c in names])
        print(f"  fused_sw_update 256^2 float64 {N_TRACERS} tracers "
              f"Gm={gm is not None}: max abs {err:.3e}, rel {rel:.3e}")
        assert rel <= 1e-12, ("fused_sw_update, 12 tracers", rel)
    # a fill of 20 fields, the wrap alone and with every condition
    # combination
    base = [torch.randn(pgrid.padded_shape, generator=gen, dtype=torch.float64,
                        device="cuda") for _ in range(20)]
    fill_check("20 fields, the wrap", pgrid, base, None)
    fill_check("20 fields, wrap and bounded z", pgrid, base,
               rotated_locs_bcs(20))


def compact_phase_shares(model, dt, steps, card, label):
    """Per-step CUDA-event times of a z-compact step: the advection kernel
    (#1 with the stage update on the fused route, #6 on the tendency route),
    buoyancy (the rest of the tendencies), the halo fills, the divergence,
    the solve, the correction, and the rest (stage updates, allocations,
    host gaps)."""
    import oceananigans_tpu_torch.models.nonhydrostatic as nh
    timer = PhaseTimer()
    swaps = [("advection", "fused_advection_update"),
             ("advection", "fused_advection_tendency"),
             ("fills", "fill_all_halo_regions"), ("fills", "periodic_halo_fill"),
             ("divergence", "fused_divergence"), ("correction", "fused_correct")]
    saved = [(name, getattr(nh, name)) for _, name in swaps]
    for (phase, name), (_, fn) in zip(swaps, saved):
        setattr(nh, name, timer.wrap(phase, fn))
    solver = model.pressure_solver
    solver.solve = timer.wrap("solve", solver.solve)
    model._tendencies = timer.wrap("tendencies", model._tendencies)
    model.time_step = timer.wrap("step", model.time_step)
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        for name, fn in saved:
            setattr(nh, name, fn)
        del solver.solve, model._tendencies, model.time_step
    g = t.get
    shares = {
        "advection kernel": g("advection", 0.0),
        "buoyancy (rest of the tendencies)":
            g("tendencies", 0.0) - g("advection@tendencies", 0.0),
        "halo fills": g("fills", 0.0),
        "divergence": g("divergence", 0.0),
        "solve (torch.fft + DCT matmul)": g("solve", 0.0),
        "correction": g("correction", 0.0),
    }
    shares["rest (updates, allocations, host gaps)"] = \
        t["step"] - sum(shares.values())
    print(f"{label} step phases, ms per step over {steps} steps (CUDA "
          f"events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.1f}%)")
    print(f"  step: {t['step']:.4f} ms")
    return shares


def tracer_model(n, scheme, n_tracers, dtype, device, seed=0):
    """bench_extra.py's tracer-scaling row (:297-322) on the port: an n³ grid
    of extent 1x1x1, periodic x and y, bounded z, ``scheme`` for momentum
    and tracers, no closure and no buoyancy (the z-compact fused route);
    u = 0.1·N(0, 1) and each tracer uniform on [0, 1) from
    np.random.default_rng(seed)."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              topology=("periodic", "periodic", "bounded"),
                              dtype=dtype, device=device)
    names = tuple(f"c{i}" for i in range(n_tracers))
    model = ot.NonhydrostaticModel(grid, advection=scheme, tracers=names)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    model.set(u=0.1 * rng.standard_normal((n, n, n)).astype(npdt),
              **{c: rng.random((n, n, n), dtype=npdt) for c in names})
    return model


def tracer_sums(model):
    """{tracer: (Σc, Σ|c|)} over the interior, summed in float64."""
    out = {}
    for name in model.tracer_names:
        a = model.field(name).interior.double()
        out[name] = (a.sum().item(), a.abs().sum().item())
    return out


def check_conserved(label, model, sums0, bound_rel=1e-6):
    """|Σc − Σc₀| / Σ|c₀| of every tracer: flux-form advection with zero
    boundary-face fluxes conserves Σc up to the float32 rounding of each
    stored value (unbiased, about 3e-8·√cells relative per stage)."""
    worst = 0.0
    for name, (s0, a0) in sums0.items():
        s = model.field(name).interior.double().sum().item()
        worst = max(worst, abs(s - s0) / a0)
    print(f"  {label}: worst |Σc − Σc₀|/Σ|c₀| over {len(sums0)} tracers after "
          f"{model.iteration} steps: {worst:.3e} (bound {bound_rel:g})")
    assert worst <= bound_rel, (label, "tracer not conserved", worst)


def check_divergence(label, model):
    """max|∇·u|·Δx/max|u| of a z-compact model's state (the divergence
    kernel's plain version on host copies of the wrapped velocities: a
    check of the state, not a call of the path on the card)."""
    from oceananigans_tpu_torch import kernels as K
    u, v, w = (model.state["fields"][c].cpu() for c in "uvw")
    div = K.fused_divergence_plain(model.grid, u, v, w, 1.0)
    ints = model.grid.interior_slices
    umax = max(a[ints].abs().max().item() for a in (u, v, w))
    div_rel = div.abs().max().item() * model.grid.dx(("c", "c", "c")) / umax
    print(f"  {label}: max|div u|·Δx/max|u| after {model.iteration} steps: "
          f"{div_rel:.3e}")
    assert div_rel < 1e-4, (label, "divergence not at roundoff", div_rel)


def tracer_path_phase(card):
    """The tracer-scaling path at 256³ float32: Centered(2) and WENO(5), each
    with 0 and 12 tracers, Δt = 1e-4, 3 warm-up and 10 timed steps per run;
    counters reset just before the first model is built and read after the
    last run. Per run: the median step, the launches per step of #1-#4
    (set() included), the peak memory, the phase shares (3 more steps),
    finite fields, the divergence and tracer conservation; the WENO(5)
    runs' interiors after their 16 steps are returned on the host, for the
    bfloat16 row's comparison. Then, on the
    WENO(5) 12-tracer run's state, #1 over 15 components against its plain
    version (the corrected G⁻ variant; bound 2e-5 of each component's term
    scale for G, 2e-5 relative for new) and its CUDA-event times."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    n, dt = 256, 1e-4
    steps_ms = {}
    weno_states = {}
    K.reset_counters()
    keep = None
    for label, make in (("Centered(2)", lambda: ot.Centered(2)),
                        ("WENO(5)", lambda: ot.WENO(5))):
        for ntr in (0, N_TRACERS):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = K.counters()[0]
            model = tracer_model(n, make(), ntr, torch.float32, "cuda")
            assert model._fused_update and model.grid.H[2] == 0
            sums0 = tracer_sums(model)
            times = timed_steps(model, dt)
            after = K.counters()[0]
            peak = torch.cuda.max_memory_allocated()
            run = f"tracer path {label} {ntr} tracers"
            for name in model.prognostic_names:
                assert torch.isfinite(model.field(name).interior).all().item(), \
                    (run, name)
            check_divergence(run, model)
            if ntr:
                check_conserved(run, model, sums0)
            step_ms = statistics.median(times) * 1e3
            steps_ms[(label, ntr)] = step_ms
            per_step = {k: (after[k] - before[k]) / model.iteration
                        for k in TRACER_KERNELS}
            print(f"{run}: 256^3 float32 RK3 step median {step_ms:.3f} ms "
                  f"over {len(times)} steps (min {min(times) * 1e3:.3f}, max "
                  f"{max(times) * 1e3:.3f}); launches per step (set() "
                  f"included) {per_step}; peak device memory "
                  f"{peak / 2 ** 30:.2f} GiB [{card}]")
            compact_phase_shares(model, dt, 3, card, run)
            if label == "WENO(5)":
                weno_states[ntr] = (model.iteration, {
                    c: model.field(c).interior.cpu()
                    for c in model.prognostic_names})
                if ntr:
                    keep = model
            del model
    for label in ("Centered(2)", "WENO(5)"):
        ratio = steps_ms[(label, N_TRACERS)] / steps_ms[(label, 0)]
        print(f"tracer scaling {label}: {N_TRACERS} tracers "
              f"{steps_ms[(label, N_TRACERS)]:.3f} ms / 0 tracers "
              f"{steps_ms[(label, 0)]:.3f} ms = {ratio:.3f} [{card}]")
    launches, plain_cuda = K.counters()
    print(f"tracer path launches over its four runs: {launches}; plain calls "
          f"on CUDA: {plain_cuda}")
    for name in TRACER_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched on the path"
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    # #1 on the path's own state: the corrected G⁻ variant over 15 components
    model = keep
    grid, scheme = model.grid, model.advection
    f = model.state["fields"]
    p = model.state["pressure"]
    tracers = {c: f[c] for c in model.tracer_names}
    Gm, _ = K.fused_advection_update(grid, scheme, f["u"], f["v"], f["w"],
                                     None, 2e-5, 0.0, tracers=tracers)
    args = (grid, scheme, f["u"], f["v"], f["w"], Gm, 8e-5, -5e-5, p, 2e-5)
    Gk, nk = K.fused_advection_update(*args, tracers=tracers)
    Gp, np_ = K.fused_advection_update_plain(*args, tracers=tracers)
    q = [f["u"], f["v"], f["w"]] + list(tracers.values())
    from oceananigans_tpu_torch.kernels.fused_advection import \
        corrected_velocities
    scales = term_scales(grid, scheme, list(corrected_velocities(
        grid, f["u"], f["v"], f["w"], p, 2e-5)) + q[3:])
    err, rel = scaled_err(Gk, Gp, scales)
    err_new, rel_new = worst_rel(list(nk.values()), list(np_.values()))
    print(f"  fused_advection_update 256^3 float32 WENO(5) {N_TRACERS} "
          f"tracers on the path's state (corrected, G⁻): G max abs "
          f"{err:.3e}, {rel:.3e} of the term scale (bound 2e-5); new max abs "
          f"{err_new:.3e}, rel {rel_new:.3e} (bound 2e-5)")
    assert rel <= 2e-5 and rel_new <= 2e-5, ("#1 float32 tracers", rel,
                                             rel_new)
    del Gk, nk, Gp, np_
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: K.fused_advection_update(*args, tracers=tracers),
                 reps=5)
    plain_ms = cuda_ms(lambda: K.fused_advection_update_plain(
        *args, tracers=tracers), reps=3, warmup=1)
    print(f"  time fused_advection_update (corrected, G⁻) over u, v, w and "
          f"{N_TRACERS} tracers at {grid.padded_shape}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms [{card}]")
    return launches, dict(max_abs_err=max(err, err_new), ms=ms,
                          plain_ms=plain_ms), weno_states


def buoyant_model(N, dtype, device, smoothness=torch.float32, seed=42,
                  architecture=None, state=None, pressure_solver=None):
    """tests/test_z_compact.py's model (:22-29) at N: extent 1x1x1, WENO(5),
    BuoyancyTracer and its tracer b, no closure and no z condition (the
    z-compact layout, tendency route); u, v 0.1·N(0, 1) and b 0.01·N(0, 1)
    from np.random.default_rng(seed); or, given ``state`` (a model state on
    the host), that state instead of set(). ``pressure_solver(grid)`` makes
    the model's pressure solver."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), dtype=dtype,
                              device=device)
    kw = {} if pressure_solver is None else dict(
        pressure_solver=pressure_solver(grid))
    model = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=smoothness),
        buoyancy=ot.BuoyancyTracer(), architecture=architecture, **kw)
    if state is not None:
        model.state = to_device(state, grid.device)
        return model
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    model.set(u=0.1 * rng.standard_normal(N).astype(npdt),
              v=0.1 * rng.standard_normal(N).astype(npdt),
              b=0.01 * rng.standard_normal(N).astype(npdt))
    return model


def buoyant_path_phase(card):
    """The buoyant z-compact path at 256³ float32, Δt = 1e-3: counters reset
    just before the model is built and read after 3 warm-up and 10 timed
    steps; finite fields, the divergence, Σb conserved, peak memory, phase
    shares (3 more steps); then the z-compact #6 against its plain version
    on the path's state (u, v, w, b with wrapped halos; bound 2e-5 of each
    component's term scale) and its CUDA-event times."""
    from oceananigans_tpu_torch import kernels as K
    n, dt = 256, 1e-3
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    model = buoyant_model((n, n, n), torch.float32, "cuda")
    assert not model._fused_update and model.grid.H[2] == 0
    state0 = to_device(model.state, "cpu")
    sums0 = tracer_sums(model)
    times = timed_steps(model, dt)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    print(f"buoyant z-compact path launches over set() and {steps} steps: "
          f"{launches}; plain calls on CUDA: {plain_cuda}")
    for name in BUOYANT_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched on the path"
    assert launches["fused_advection_update"] == 0
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    peak = torch.cuda.max_memory_allocated()
    for name in model.prognostic_names:
        assert torch.isfinite(model.field(name).interior).all().item(), name
    check_divergence("buoyant z-compact", model)
    check_conserved("buoyant z-compact", model, sums0)
    step_ms = statistics.median(times) * 1e3
    per_step = {k: launches[k] / steps for k in BUOYANT_KERNELS}
    print(f"buoyant z-compact path: 256^3 WENO5 BuoyancyTracer float32 RK3 "
          f"step median {step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n ** 3 / (step_ms / 1e3):.4e} cell-updates/s; launches per step "
          f"(set() included) {per_step}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")
    compact_phase_shares(model, dt, 3, card, "buoyant z-compact")
    fields = model._fill_all(dict(model.state["fields"]))
    q = [fields[c] for c in model.prognostic_names]
    grid, scheme = model.grid, model.advection
    Gk = K.fused_advection_tendency(grid, scheme, q)
    Gp = K.fused_advection_tendency_plain(grid, scheme, q)
    err, rel = scaled_err(list(Gk), list(Gp), term_scales(grid, scheme, q))
    print(f"  fused_advection_tendency z-compact 256^3 float32 on the path's "
          f"state (u, v, w, b): max abs {err:.3e}, {rel:.3e} of the term "
          f"scale (bound 2e-5)")
    assert rel <= 2e-5, ("z-compact #6 float32", rel)
    del Gk, Gp
    ms = cuda_ms(lambda: K.fused_advection_tendency(grid, scheme, q))
    plain_ms = cuda_ms(lambda: K.fused_advection_tendency_plain(
        grid, scheme, q), reps=5)
    print(f"  time fused_advection_tendency z-compact at {grid.padded_shape} "
          f"(4 fields): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
    return launches, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms), \
        model, state0, step_ms


def sharded_buoyant_path_phase(card, n, serial, state0):
    """The buoyant z-compact path on the 2x2 mesh of the card, from the
    serial path's initial state scattered into resident blocks: counters
    reset after the model is built and read after 3 warm-up and 10 timed
    steps (#7 and #6 once per shard and stage, the exchange kernel at every
    fill, #2 and #3 on each shard's blocks, no plain version on CUDA
    tensors); finite fields, the divergence, Σb conserved; the device
    profile; the fields against the serial model's after the same 16
    steps, bound 1e-5 relative (#7 equals #6 bit for bit, and the pencil
    solver rounds apart from the serial one, which ``pencil_twin_check``
    shows); #7 against its plain route on
    the path's blocks (bound 2e-5 of each component's term scale) and its
    times."""
    from oceananigans_tpu_torch import kernels as K
    dt = 1e-3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = buoyant_model((n, n, n), torch.float32, "cuda",
                          architecture=card_mesh(), state=state0)
    assert model._sharded_advection is not None and model.grid.H[2] == 0
    sums0 = tracer_sums(model)
    K.reset_counters()
    times = timed_steps(model, dt)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    print(f"sharded buoyant z-compact path launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain_cuda.items() if v} }")
    stages = 3 * steps
    check_mesh_launches(launches, plain_cuda, {
        "build_sharded_fused_advection": 4 * stages,
        "fused_advection_tendency": 4 * stages,
        "fused_divergence": 4 * stages, "fused_correct": 4 * stages})
    assert launches["mesh_halo_exchange"] >= 2 * stages
    step_ms = resident_report("sharded buoyant z-compact path", model, times,
                              base, card)
    for name in model.prognostic_names:
        assert torch.isfinite(model.field(name).interior).all().item(), name
    check_divergence("sharded buoyant z-compact", model)
    check_conserved("sharded buoyant z-compact", model, sums0)
    resident_profile("sharded buoyant z-compact path", model, dt, 3, step_ms,
                     card, "advection")
    # 1e-5, as row A's (phase 32): the pencil's float32 rounding over 48
    # solves, 7.355e-7 on an H100 80GB HBM3 at 700 W
    diff = against_serial("buoyant z-compact", model, serial,
                          ("u", "v", "w", "b"), 1e-5)
    pencil_twin_check("buoyant z-compact", model, serial, buoyant_model,
                      state0, dt, ("u", "v", "w", "b"), diff)
    del serial
    torch.cuda.empty_cache()
    return launches, sharded_tendency_check(f"{n}^3 z-compact", model, n,
                                            card)


# -- bfloat16 WENO smoothness (#1, #6, #8) ------------------------------------------

def bf16_check(label, got, want, want_f32, scales, rel, separated):
    """Kernel against plain version, both with bfloat16 smoothness: for each
    component, max|kernel − plain| ≤ rel × its scale (float32 roundoff of
    the stencils and fluxes: the smoothness operands are the same, and both
    round each smoothness operation to bfloat16). For the components in
    ``separated`` (those a WENO reconstruction enters) that bound must also
    be at most a tenth of max|plain − plain with float32 smoothness|, so the
    check can tell the two smoothness dtypes apart. Returns (max abs
    difference, the smallest such separation over the bound)."""
    worst, used, margin = 0.0, 0.0, float("inf")
    for n, (g, w, w32, s) in enumerate(zip(got, want, want_f32, scales)):
        err = (g - w).abs().max().item()
        bound = rel * s
        if n in separated:
            sep = (w - w32).abs().max().item()
            assert bound <= 0.1 * sep, (label, n, "bound cannot tell bf16 "
                                        "from float32", bound, sep)
            margin = min(margin, sep / bound)
        assert err <= bound, (label, n, err, bound)
        worst, used = max(worst, err), max(used, err / bound)
    print(f"  {label}: max abs {worst:.3e}, at most {used:.3f} of the bound "
          f"({rel:g} of each component's scale); bf16-vs-float32 difference "
          f"at least {margin:.1f} times the bound")
    return worst


def bf16_kernels_phase():
    """#6 padded and #8 with bfloat16 smoothness against their plain
    versions on float32 inputs at the paths' shapes: #6 on the convection
    kernel check's 256³ inputs (H = (3, 3, 3), halos filled), bound 2e-5 of
    each component's max|plain|; #8 at 256² with two tracers and G⁻ (uh,
    vh 0.1·N(0, 1), h 1 + 1e-4·N(0, 1), tracers N(0, 1)), bound 1e-5 of each
    component's max|plain| for G and 1e-5 relative for the new fields. (#1
    and the z-compact #6 are held on the tracer row's states.)"""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    bf, f32 = (ot.WENO(5, smoothness_dtype=torch.bfloat16),
               ot.WENO(5, smoothness_dtype=torch.float32))
    grid, fields, specs = convection_kernel_inputs((256, 256, 256),
                                                   torch.float32, seed=2)
    K.bounded_z_fill_plain(grid, fields, specs)
    K.periodic_halo_fill_plain(grid, fields)
    Gp = list(K.fused_advection_tendency_plain(grid, bf, fields))
    err6 = bf16_check(
        "fused_advection_tendency padded 256^3 u, v, w, b bf16 smoothness",
        list(K.fused_advection_tendency(grid, bf, fields)), Gp,
        list(K.fused_advection_tendency_plain(grid, f32, fields)),
        [g.abs().max().item() for g in Gp], 2e-5, range(4))
    del grid, fields, Gp
    torch.cuda.empty_cache()
    # a nearly flat h, so that the advection the smoothness enters, and not
    # the head gradient, sets the size of the momentum tendencies
    names = SW_NAMES + ("c0", "c1")
    sgrid = ot.RectilinearGrid(size=(256, 256), extent=(1.0, 1.0),
                               halo=(4, 4, 0), topology=SW_TOPOLOGY,
                               dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(23)
    sfields = {c: o + sc * torch.randn(sgrid.padded_shape, generator=gen,
                                       device="cuda")
               for c, sc, o in zip(names, (0.1, 0.1, 1e-4, 1.0, 1.0),
                                   (0.0, 0.0, 1.0, 0.0, 0.0))}
    hB = 1e-4 * torch.randn(sgrid.padded_shape, generator=gen, device="cuda")
    K.periodic_halo_fill(sgrid, list(sfields.values()) + [hB])
    sGm = torch.randn((len(names),) + sgrid.N, generator=gen, device="cuda")
    ints = sgrid.interior_slices

    def sw(fn, scheme):
        return fn(sgrid, scheme, 9.81, 0.3, hB, names, sfields, sGm, 2e-5,
                  -1e-5)

    Gk, nk = sw(K.fused_sw_update, bf)
    Gp, np_ = sw(K.fused_sw_update_plain, bf)
    G32, _ = sw(K.fused_sw_update_plain, f32)
    err8 = bf16_check("fused_sw_update 256^2 float32, 2 tracers, bf16 "
                      "smoothness (G)", list(Gk), list(Gp), list(G32),
                      [g.abs().max().item() for g in Gp], 1e-5, (0, 1, 3, 4))
    err_new, rel_new = worst_rel([nk[c][ints] for c in names],
                                 [np_[c][ints] for c in names])
    print(f"  fused_sw_update bf16 smoothness, new fields: max abs "
          f"{err_new:.3e}, rel {rel_new:.3e} (bound 1e-5)")
    assert rel_new <= 1e-5, ("#8 bf16 new", rel_new)
    torch.cuda.synchronize()
    return {"fused_advection_tendency_bf16": dict(max_abs_err=err6),
            "fused_sw_update_bf16": dict(max_abs_err=max(err8, err_new))}


def bf16_tracer_path_phase(card, weno_states):
    """bench_extra.py's weno5_bf16smooth tracer row: 256³ float32, WENO(5,
    smoothness_dtype=bfloat16), 0 and 12 tracers, Δt = 1e-4, 3 warm-up and
    10 timed steps and 3 more for the phase shares, from the same initial
    state as the WENO(5) row; for each run the counters are reset just
    before its model is built and read after its phase shares, before the
    checks on its state, and the path's launches are the two runs' sum. Per
    run: the median step, launches per step, #1's share of the step, peak
    memory, finite fields, the divergence, tracer drift (bound 1e-6), and
    each field's largest difference from the float32-smoothness run after
    the same 16 steps. On each run's final state, #1 against its plain
    version, the G⁻ variant without and with the path's own pressure (the
    corrected variant): G bound 2e-5 of each component's term scale, held
    to a tenth of the bf16-vs-float32 difference, new 2e-5 relative; on the
    12-tracer state also the z-compact #6 (the same bounds); then #1's
    CUDA-event times (corrected, G⁻, 15 components)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    n, dt = 256, 1e-4
    steps_ms, out = {}, {}
    launches = dict.fromkeys(K.counters()[0], 0)
    plain_cuda = dict.fromkeys(K.counters()[1], 0)
    for ntr in (0, N_TRACERS):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_counters()
        model = tracer_model(n, ot.WENO(5, smoothness_dtype=torch.bfloat16),
                             ntr, torch.float32, "cuda")
        assert model._fused_update and model.grid.H[2] == 0
        sums0 = tracer_sums(model)
        times = timed_steps(model, dt)
        after = K.counters()[0]
        peak = torch.cuda.max_memory_allocated()
        run = f"bf16-smoothness tracer path WENO(5) {ntr} tracers"
        for name in model.prognostic_names:
            assert torch.isfinite(model.field(name).interior).all().item(), \
                (run, name)
        check_divergence(run, model)
        if ntr:
            check_conserved(run, model, sums0)
        step_ms = statistics.median(times) * 1e3
        steps_ms[ntr] = step_ms
        per_step = {k: after[k] / model.iteration for k in TRACER_KERNELS}
        print(f"{run}: 256^3 float32 RK3 step median {step_ms:.3f} ms over "
              f"{len(times)} steps (min {min(times) * 1e3:.3f}, max "
              f"{max(times) * 1e3:.3f}); launches per step (set() included) "
              f"{per_step}; peak device memory {peak / 2 ** 30:.2f} GiB "
              f"[{card}]")
        shares = compact_phase_shares(model, dt, 3, card, run)
        print(f"  {run}: #1's share of the step "
              f"{100 * shares['advection kernel'] / sum(shares.values()):.1f}%")
        for total, count in zip((launches, plain_cuda), K.counters()):
            for k, c in count.items():
                total[k] = total.get(k, 0) + c
        steps, f32 = weno_states[ntr]
        assert model.iteration == steps, (model.iteration, steps)
        diffs = {c: (model.field(c).interior.cpu() - f32[c]).abs().max()
                 .item() for c in model.prognostic_names}
        print(f"  {run}: bf16-vs-float32 smoothness, max|difference| per "
              f"field after {steps} steps: "
              + ", ".join(f"{c} {d:.3e}" for c, d in diffs.items()))
        out[ntr] = bf16_state_checks(model, ntr, card)
        del model, f32
        weno_states[ntr] = None
    ratio = steps_ms[N_TRACERS] / steps_ms[0]
    print(f"tracer scaling WENO(5) bf16 smoothness: {N_TRACERS} tracers "
          f"{steps_ms[N_TRACERS]:.3f} ms / 0 tracers {steps_ms[0]:.3f} ms = "
          f"{ratio:.3f} [{card}]")
    print(f"bf16 tracer path launches over its two runs: {launches}; plain "
          f"calls on CUDA: {plain_cuda}")
    for name in TRACER_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched on the path"
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    return launches, dict(max_abs_err=max(o["max_abs_err"]
                                          for o in out.values()),
                          ms=out[N_TRACERS]["ms"],
                          plain_ms=out[N_TRACERS]["plain_ms"])


def bf16_state_checks(model, ntr, card):
    """#1 (and, with tracers, the z-compact #6) with bfloat16 smoothness
    against their plain versions on a tracer-row model's state, #1 without
    and with the model's pressure; #1's times on the 12-tracer state (see
    bf16_tracer_path_phase)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    grid, bf = model.grid, model.advection
    f32 = ot.WENO(5, smoothness_dtype=torch.float32)
    f = model.state["fields"]
    tracers = {c: f[c] for c in model.tracer_names}
    q = [f["u"], f["v"], f["w"]] + list(tracers.values())
    nc = len(q)
    p = model.state["pressure"]
    Gm, _ = K.fused_advection_update(grid, bf, f["u"], f["v"], f["w"], None,
                                     2e-5, 0.0, tracers=tracers)
    scales = term_scales(grid, f32, q)
    res = dict(max_abs_err=0.0)
    for label, corr in (("G⁻", (None, None)), ("corrected, G⁻", (p, 2e-5))):
        def update(fn, scheme):
            return fn(grid, scheme, f["u"], f["v"], f["w"], Gm, 8e-5, -5e-5,
                      *corr, tracers=tracers)

        Gk, nk = update(K.fused_advection_update, bf)
        Gp, np_ = update(K.fused_advection_update_plain, bf)
        G32, _ = update(K.fused_advection_update_plain, f32)
        err = bf16_check(f"fused_advection_update 256^3 float32 bf16 "
                         f"smoothness {nc} components on the path's state "
                         f"({label}) G", Gk, Gp, G32, scales, 2e-5,
                         range(nc))
        err_new, rel_new = worst_rel(list(nk.values()), list(np_.values()))
        print(f"  fused_advection_update bf16 smoothness {nc} components "
              f"({label}), new: max abs {err_new:.3e}, rel {rel_new:.3e} "
              f"(bound 2e-5)")
        assert rel_new <= 2e-5, ("#1 bf16 new", label, rel_new)
        res["max_abs_err"] = max(res["max_abs_err"], err, err_new)
        del Gk, nk, Gp, np_, G32
    if ntr:
        err6 = bf16_check(
            f"fused_advection_tendency z-compact 256^3 bf16 smoothness {nc} "
            f"components on the path's state",
            list(K.fused_advection_tendency(grid, bf, q)),
            list(K.fused_advection_tendency_plain(grid, bf, q)),
            list(K.fused_advection_tendency_plain(grid, f32, q)), scales,
            2e-5, range(nc))
        res["max_abs_err"] = max(res["max_abs_err"], err6)
        torch.cuda.empty_cache()
        args = (grid, bf, f["u"], f["v"], f["w"], Gm, 8e-5, -5e-5, p, 2e-5)
        res["ms"] = cuda_ms(lambda: K.fused_advection_update(
            *args, tracers=tracers), reps=5)
        res["plain_ms"] = cuda_ms(lambda: K.fused_advection_update_plain(
            *args, tracers=tracers), reps=3, warmup=1)
        print(f"  time fused_advection_update bf16 smoothness (corrected, "
              f"G⁻) over u, v, w and {ntr} tracers at {grid.padded_shape}: "
              f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms "
              f"[{card}]")
    torch.cuda.synchronize()
    return res


# -- the vector-unit probes (#12) ----------------------------------------------------

PROBE_KERNELS = ("weno_microbench", "vpu_mix", "bf16_smoothness")
PROBE_REL = 1e-5


def probe_kernels_phase(card):
    """Each probe kernel against its plain version on the scripts' 256×256
    slab of default_rng(0) normals (0.01 times it for the FMA chain, whose
    powers of the slab stay finite over the passes only there), with the
    fold-back factor 1.0 and 3 passes, bound 1e-5 relative to max|plain| (float32 roundoff of FMA
    contraction; the approximate reciprocal's ~1 ulp in the weights); the
    repro in bfloat16 also at most a tenth of its bf16-vs-float32
    difference. Then CUDA-event times of kernel and plain version at the
    entry points' settings: weno_microbench at K = 32 and 200 passes,
    vpu_mix summed over its five bodies at 2000 passes each, and the repro
    in bfloat16."""
    from oceananigans_tpu_torch.kernels import vpu_probes as V
    from oceananigans_tpu_torch.tools import probe_common as pc
    dev = torch.device("cuda")
    x, x001 = pc.slab(V.SLAB, dev), pc.slab(V.SLAB, dev, 0.01)
    errs = {name: 0.0 for name in PROBE_KERNELS}

    def check(name, label, got, want):
        assert torch.isfinite(want).all().item(), label
        err, rel = max_err(got, want)
        print(f"  {name} {label}: max abs {err:.3e}, rel {rel:.3e} (bound "
              f"{PROBE_REL:g})")
        assert rel <= PROBE_REL, (name, label, rel)
        errs[name] = max(errs[name], err)

    for k in V.MICROBENCH_K:
        check("weno_microbench", f"K={k}, 3 passes, fold 1.0",
              V.weno_microbench(x, k, 3, 1.0),
              V.weno_microbench_plain(x, k, 3, 1.0))
    for body in V.BODIES:
        xb = x001 if body == "fma_chain" else x
        check("vpu_mix", f"{body}, 3 passes, fold 1.0",
              V.vpu_mix(xb, body, 3, 1.0), V.vpu_mix_plain(xb, body, 3, 1.0))
    for dtype in (torch.bfloat16, torch.float32):
        want = V.bf16_smoothness_plain(x, dtype)
        check("bf16_smoothness", f"{dtype}", V.bf16_smoothness(x, dtype),
              want)
        if dtype == torch.bfloat16:
            sep = (want - V.bf16_smoothness_plain(x, torch.float32)).abs() \
                .max().item()
            assert PROBE_REL * want.abs().max().item() <= 0.1 * sep, sep
    torch.cuda.synchronize()
    out = {}
    out["weno_microbench"] = dict(
        ms=cuda_ms(lambda: V.weno_microbench(x, 32), reps=5),
        plain_ms=cuda_ms(lambda: V.weno_microbench_plain(x, 32), reps=1,
                         warmup=0))
    out["vpu_mix"] = dict(
        ms=sum(cuda_ms(lambda: V.vpu_mix(x, b), reps=5) for b in V.BODIES),
        plain_ms=sum(cuda_ms(lambda: V.vpu_mix_plain(x, b), reps=1, warmup=0)
                     for b in V.BODIES))
    out["bf16_smoothness"] = dict(
        ms=cuda_ms(lambda: V.bf16_smoothness(x)),
        plain_ms=cuda_ms(lambda: V.bf16_smoothness_plain(x), reps=5))
    for name, t in out.items():
        t["max_abs_err"] = errs[name]
        print(f"  time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms [{card}]")
    return out


def probe_bounds(peak_tflops):
    """Bounds of the probe rows at the timed settings, the operations over
    the card's float32 peak (SMs × 128 × 2 × its maximum SM clock): the
    microbench at K = 32 ((87 + 3) per body), the mix summed over its bodies
    ((flop + 7) a pass), the repro (87 per element); the slab read and
    written once."""
    from oceananigans_tpu_torch.kernels import vpu_probes as V
    cells = V.SLAB[0] * V.SLAB[1]

    def b(nbytes, flop):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flop = flop / (peak_tflops * 1e12) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_flop \
            else (t_flop, "operations")

    return {
        "weno_microbench": b(8 * cells, cells * V.MICROBENCH_REPS * 32
                             * (V.WENO_FLOP + V.DERIVE_FLOP)),
        "vpu_mix": b(8 * cells * len(V.BODIES), sum(
            cells * V.MIX_REPS * (f + V.MIX_LOOP_FLOP)
            for _, f, _ in V.BODIES.values())),
        "bf16_smoothness": b(8 * cells, cells * V.WENO_FLOP),
    }


def probe_path_phase(card):
    """The three probe entry points (oceananigans_tpu_torch/tools), as a
    user runs them, on the card: the microbench and the mix on the scripts'
    256×256 slab and on a slab that fills every SM (--slab full), the repro
    on its slab. Counters reset just before and read just after; every
    probe kernel must have launched and no plain version run on CUDA
    tensors. Prints each entry point's JSON lines; returns the launches and
    the card's float32 peak."""
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.tools import (probe_common, repro_bf16_smoothness,
                                              vpu_mix_probe, weno_vpu_microbench)
    dev = torch.device("cuda")
    full = probe_common.slab_shape("full", dev)
    K.reset_counters()
    micro = [weno_vpu_microbench.run(dev), weno_vpu_microbench.run(dev, full)]
    mix = vpu_mix_probe.run(dev) + vpu_mix_probe.run(dev, full)
    repro = repro_bf16_smoothness.run(dev)
    launches, plain_cuda = K.counters()
    for line in micro + mix + [repro]:
        print(json.dumps(line))
    peak = micro[0]["fma_peak"]
    print(f"card float32 peak: {peak['sms']} SMs x {peak['fp32_lanes_per_sm']} "
          f"lanes x 2 x {peak['max_sm_clock_mhz']:.0f} MHz = "
          f"{peak['tflops']:.3f} Tflop/s (the bounds' table: "
          f"{FP32_FLOP_PER_S / 1e12:.0f}) [{card}]")
    for m in micro:
        print(f"weno5 body marginal rate on a {m['slab']} slab: "
              f"{m['value']:.3f} Tflop/s = {m['fraction_of_fma_peak']:.3f} of "
              f"peak; ms at K = {m['k_points']}: {m['ms_points']}; fit "
              f"residuals {m['fit_residual_ms']} ms")
    # the plain version's difference on the CPU, where tests/test_torch_bf16.py
    # holds it to the JAX repro run without excess precision
    assert abs(repro["max_abs_bf16_vs_float32"] - 0.0354) < 0.005, repro
    print(f"probe launches: { {k: launches[k] for k in PROBE_KERNELS} }; "
          f"plain calls on CUDA: {plain_cuda}")
    for name in PROBE_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched on the path"
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    return launches, peak


# -- the LES path (phase 21) ----------------------------------------------------

LES_N = 128
LES_KERNELS = ("fused_advection_tendency", "fill_halos")


def les_closures():
    """bench_extra.py's LES row's closures (:259-289), built anew for each
    model (a model hands its buoyancy to the closure)."""
    import oceananigans_tpu_torch as ot
    return {"SmagorinskyLilly": ot.SmagorinskyLilly,
            "AnisotropicMinimumDissipation":
                ot.AnisotropicMinimumDissipation}


def les_model(n, closure, dtype, device, smoothness=torch.float32, seed=0):
    """bench_extra.py's LES row (:259-289) at n³: extent 1x1x1, periodic x
    and y, bounded z, WENO(5), BuoyancyTracer and its tracer b, ``closure``;
    u = 0.1·N(0, 1), then b = 1e-4·N(0, 1) from
    np.random.default_rng(seed)."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              topology=("periodic", "periodic", "bounded"),
                              dtype=dtype, device=device)
    model = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=smoothness),
        tracers=("b",), buoyancy=ot.BuoyancyTracer(), closure=closure)
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    model.set(u=0.1 * rng.standard_normal((n, n, n)).astype(npdt),
              b=1e-4 * rng.standard_normal((n, n, n)).astype(npdt))
    return model


def vitd_model(n, dtype, device, smoothness=torch.float32, seed=0):
    """The LES row's configuration with a vertically implicit
    VerticalScalarDiffusivity (ν = κ = 1e-3) in place of the LES closure."""
    import oceananigans_tpu_torch as ot
    return les_model(n, ot.VerticalScalarDiffusivity(
        ot.VerticallyImplicitTimeDiscretization(), nu=1e-3, kappa=1e-3),
        dtype, device, smoothness=smoothness, seed=seed)


def les_phase_shares(model, dt, steps, card, label):
    """Per-step CUDA-event times of a padded tendency-route step: the
    advection kernel, the closure (its diffusivities, momentum and tracer
    terms), the rest of the tendencies (buoyancy, boundary fluxes), the
    implicit vertical solve, the halo fills, the projection (its fills
    excluded) and the rest (stage updates, allocations, host gaps)."""
    import oceananigans_tpu_torch.models.nonhydrostatic as nh
    timer = PhaseTimer()
    saved = (nh.fused_advection_tendency, nh.fill_all_halo_regions)
    nh.fused_advection_tendency = timer.wrap("advection", saved[0])
    nh.fill_all_halo_regions = timer.wrap("fills", saved[1])
    closure = model.closure
    methods = ("compute_diffusivities", "momentum_tendencies",
               "tracer_tendency")
    for name in methods:
        setattr(closure, name, timer.wrap("closure", getattr(closure, name)))
    wrapped = ("_tendencies", "_implicit_step", "_project", "time_step")
    for name in wrapped:
        setattr(model, name, timer.wrap(name.strip("_"), getattr(model,
                                                                name)))
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        nh.fused_advection_tendency, nh.fill_all_halo_regions = saved
        for name in methods:
            delattr(closure, name)
        for name in wrapped:
            delattr(model, name)
    g = t.get
    shares = {
        "advection kernel": g("advection", 0.0),
        "closure (diffusivities, momentum and tracer terms)":
            g("closure", 0.0),
        "rest of the tendencies (buoyancy, boundary fluxes)":
            g("tendencies", 0.0) - g("advection@tendencies", 0.0)
            - g("closure@tendencies", 0.0),
        "implicit vertical solve": g("implicit_step", 0.0),
        "halo fills": g("fills", 0.0),
        "projection (divergence, solve, correction)":
            g("project", 0.0) - g("fills@project", 0.0),
    }
    shares["rest (updates, allocations, host gaps)"] = \
        t["time_step"] - sum(shares.values())
    print(f"{label} step phases, ms per step over {steps} steps (CUDA "
          f"events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['time_step']:.1f}%)")
    print(f"  step: {t['time_step']:.4f} ms")
    return shares, t["time_step"]


def padded_divergence(label, model):
    """max|∇·u|·Δx/max|u| of a padded-layout model's state."""
    from oceananigans_tpu_torch.models.nonhydrostatic import \
        _interior_divergence
    fields = model.state["fields"]
    u, v, w = (fields[c] for c in "uvw")
    model._fill_all(dict(u=u, v=v, w=w))
    ints = model.grid.interior_slices
    div = _interior_divergence(model.grid, u, v, w)
    umax = max(a[ints].abs().max().item() for a in (u, v, w))
    div_rel = div.abs().max().item() * model.grid.dx(("c", "c", "c")) / umax
    print(f"  {label}: max|div u|·Δx/max|u| after {model.iteration} steps: "
          f"{div_rel:.3e}; max|u| {umax:.3e}")
    assert div_rel < 1e-4, (label, "divergence not at roundoff", div_rel)


def les_run(card, label, make, dt):
    """One LES-row run at 128³ float32: counters reset just before the model
    is built and read after 3 warm-up and 10 timed steps; #6 three times a
    step, the fill kernel, no plain version on CUDA tensors; finite fields,
    the divergence, Σb conserved, peak memory; then the phase shares (3
    more steps) and the busy share (3 more). Returns the launches and the
    median step."""
    from oceananigans_tpu_torch import kernels as K
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    model = make()
    assert not model._z_compact and model.grid.H == (3, 3, 3)
    sums0 = tracer_sums(model)
    times = timed_steps(model, dt)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    print(f"{label} launches over set() and {steps} steps: {launches}; "
          f"plain calls on CUDA: {plain_cuda}")
    for name in LES_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched on the path"
    assert launches["fused_advection_tendency"] == 3 * steps, launches
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    peak = torch.cuda.max_memory_allocated()
    for name in model.state["fields"]:
        assert torch.isfinite(model.field(name).interior).all().item(), name
    padded_divergence(label, model)
    check_conserved(label, model, sums0)
    step_ms = statistics.median(times) * 1e3
    n = model.grid.N[0]
    per_step = {k: launches[k] / steps for k in LES_KERNELS}
    print(f"{label}: {n}^3 WENO5 BuoyancyTracer float32 RK3 step median "
          f"{step_ms:.3f} ms over {len(times)} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n ** 3 / (step_ms / 1e3):.4e} cell-updates/s; launches per step "
          f"(set() included) {per_step}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB [{card}]")
    shares, events_ms = les_phase_shares(model, dt, 3, card, label)
    closure_ms = shares["closure (diffusivities, momentum and tracer terms)"]
    print(f"{label}: closure share {closure_ms / events_ms:.4f} of the "
          f"event-timed step, implicit solve "
          f"{shares['implicit vertical solve']:.4f} ms per step [{card}]")
    # the vertically implicit row's 17,000 kernels a step make its
    # profiled steps slow: one, to fit phase 32 in the script's time
    busy_share(label, model, dt, 1 if "implicit" in label else 3, step_ms,
               card)
    return launches, step_ms


def les_path_phase(card):
    """Phase 21: bench_extra.py's 128³ LES row, float32, Δt = 1e-4, with
    SmagorinskyLilly() and then AnisotropicMinimumDissipation(); then the
    same configuration with a vertically implicit VerticalScalarDiffusivity
    (the implicit solve's time)."""
    out = {}
    for cname, make_closure in les_closures().items():
        out[cname] = les_run(
            card, f"LES path, {cname}",
            lambda: les_model(LES_N, make_closure(), torch.float32, "cuda"),
            1e-4)
    out["vitd"] = les_run(
        card, "LES configuration, vertically implicit "
        "VerticalScalarDiffusivity",
        lambda: vitd_model(LES_N, torch.float32, "cuda"), 1e-4)
    return out


KERNEL_SOURCES = {
    "fused_advection_update": (
        "oceananigans_tpu_torch/csrc/advection_kernel.cuh",
        "oceananigans_tpu/kernels/fused_advection.py:269"),
    "fused_divergence": (
        "oceananigans_tpu_torch/csrc/fused_projection.cu",
        "oceananigans_tpu/kernels/fused_projection.py:56"),
    "fused_correct": (
        "oceananigans_tpu_torch/csrc/fused_projection.cu",
        "oceananigans_tpu/kernels/fused_projection.py:160"),
    "fill_halos": (
        "oceananigans_tpu_torch/csrc/halo_fill.cu",
        "oceananigans_tpu/kernels/pallas_fill.py:265"),
    "fused_advection_tendency": (
        "oceananigans_tpu_torch/csrc/advection_kernel.cuh",
        "oceananigans_tpu/kernels/fused_advection.py:149"),
    "fill_halos_bounded": (
        "oceananigans_tpu_torch/csrc/halo_fill.cu",
        "oceananigans_tpu/kernels/pallas_fill.py:87"),
    "fused_sw_update": (
        "oceananigans_tpu_torch/csrc/sw_kernel.cuh",
        "oceananigans_tpu/kernels/fused_shallow_water.py:43"),
    "fused_vi_tendency": (
        "oceananigans_tpu_torch/csrc/vi_kernel.cuh",
        "oceananigans_tpu/kernels/fused_vector_invariant.py:262"),
    "build_sharded_fused_advection": (
        "oceananigans_tpu_torch/kernels/fused_advection.py",
        "oceananigans_tpu/kernels/fused_advection.py:795"),
    "build_sharded_fused_sw_update": (
        "oceananigans_tpu_torch/kernels/fused_shallow_water.py",
        "oceananigans_tpu/kernels/fused_shallow_water.py:214"),
    "mesh_halo_exchange": (
        "oceananigans_tpu_torch/csrc/halo_exchange.cu",
        "oceananigans_tpu/parallel/halo_exchange.py:25"),
    "fused_advection_update_tracers": (
        "oceananigans_tpu_torch/csrc/advection_kernel.cuh",
        "oceananigans_tpu/kernels/fused_advection.py:269"),
    "fused_advection_tendency_compact": (
        "oceananigans_tpu_torch/csrc/advection_kernel.cuh",
        "oceananigans_tpu/kernels/fused_advection.py:149"),
    "build_sharded_fused_advection_compact": (
        "oceananigans_tpu_torch/kernels/fused_advection.py",
        "oceananigans_tpu/kernels/fused_advection.py:795"),
    "build_sharded_fused_advection_zperiodic": (
        "oceananigans_tpu_torch/kernels/fused_advection.py",
        "oceananigans_tpu/kernels/fused_advection.py:795"),
    "fused_advection_update_bf16": (
        "oceananigans_tpu_torch/csrc/advection_kernel.cuh",
        "oceananigans_tpu/kernels/fused_advection.py:269"),
    "weno_microbench": (
        "oceananigans_tpu_torch/csrc/vpu_probes.cu",
        "scripts/weno_vpu_microbench.py:77"),
    "vpu_mix": (
        "oceananigans_tpu_torch/csrc/vpu_probes.cu",
        "scripts/vpu_mix_probe.py:100"),
    "bf16_smoothness": (
        "oceananigans_tpu_torch/csrc/vpu_probes.cu",
        "scripts/repro_bf16_smoothness.py:38"),
    "fill_halos_fold": (
        "oceananigans_tpu_torch/csrc/halo_fill.cu",
        "oceananigans_tpu/kernels/pallas_fill.py:87"),
    "fill_halos_fold_surfaces": (
        "oceananigans_tpu_torch/csrc/halo_fill.cu",
        "oceananigans_tpu/kernels/pallas_fill.py:87"),
    "fill_halos_polar": (
        "oceananigans_tpu_torch/csrc/halo_fill.cu",
        "oceananigans_tpu/kernels/pallas_fill.py:87"),
}

# the variant rows of a kernel: its counter's name
COUNTER = {"fill_halos_bounded": "fill_halos_3d",
           "fill_halos_fold": "fill_halos_3d",
           "fill_halos_fold_surfaces": "fill_halos_2d",
           "fill_halos_polar": "fill_halos_3d",
           "fused_advection_update_tracers": "fused_advection_update",
           "fused_advection_tendency_compact": "fused_advection_tendency",
           "build_sharded_fused_advection_compact":
               "build_sharded_fused_advection",
           "build_sharded_fused_advection_zperiodic":
               "build_sharded_fused_advection_weno5_zperiodic",
           "fused_advection_update_bf16": "fused_advection_update"}


# -- the CATKE ocean row (phase 22) ---------------------------------------------

OCEAN_VARIANTS = {"flat bottom": False, "immersed ridge": True}


def ocean_phase_shares(model, dt, steps, card, label):
    """Per-step CUDA-event times of the ocean step: the tendency (#10, or
    the plain tendency on the immersed grid), CATKE's diffusivities at the
    tendencies, the implicit vertical solve of u, v, T and S,
    step_turbulence (its diffusivity refreshes and e solves included), the
    split-explicit substep loop (its fills included), the fills outside it
    and the rest (pₕ′, w, the closure's other terms, the boundary fluxes,
    AB2, the corrector, the masks, allocations, host gaps)."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    import oceananigans_tpu_torch.models.hydrostatic as hs
    timer = PhaseTimer()
    saved = (hs.fused_vi_tendency, hs.fused_vi_tendency_plain,
             hf.fill_halos)
    hs.fused_vi_tendency = timer.wrap("tendency", saved[0])
    hs.fused_vi_tendency_plain = timer.wrap("tendency", saved[1])
    hf.fill_halos = timer.wrap("fills", saved[2])
    closure, fs = model.closure, model.free_surface
    closure.compute_diffusivities = timer.wrap(
        "catke", closure.compute_diffusivities)
    closure.step_turbulence = timer.wrap("turbulence",
                                         closure.step_turbulence)
    fs.substep = timer.wrap("substep", fs.substep)
    model._implicit_solve = timer.wrap("implicit", model._implicit_solve)
    model.time_step = timer.wrap("step", model.time_step)
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        hs.fused_vi_tendency, hs.fused_vi_tendency_plain, hf.fill_halos = \
            saved
        for obj, names in ((closure, ("compute_diffusivities",
                                      "step_turbulence")),
                           (fs, ("substep",)),
                           (model, ("_implicit_solve", "time_step"))):
            for name in names:
                delattr(obj, name)
    g = t.get
    tendency = ("fused_vi_tendency kernel (#10)" if model.uses_kernel
                else "plain vector-invariant tendency")
    shares = {
        tendency: g("tendency", 0.0),
        "CATKE diffusivities at the tendencies":
            g("catke", 0.0) - g("catke@turbulence", 0.0),
        "implicit vertical solve (u, v, T, S)": g("implicit", 0.0),
        "step_turbulence (TKE substeps, their diffusivities and e solves)":
            g("turbulence", 0.0),
        "split-explicit substep loop (its fills included)":
            g("substep", 0.0),
        "fills (outside the substep loop)":
            g("fills", 0.0) - g("fills@substep", 0.0),
    }
    shares["rest (pₕ′, w, closure terms, boundary fluxes, AB2, corrector, "
           "masks, allocations, host gaps)"] = \
        t["step"] - sum(shares.values())
    print(f"{label} step phases, ms per step over {steps} steps (CUDA "
          f"events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.1f}%)")
    print(f"  step: {t['step']:.4f} ms")
    return shares


def fluid_volume_sum(model, name):
    """Σ q·V over the fluid cells, in float64."""
    grid = model.grid
    V = torch.as_tensor(grid.V(("c", "c", "c")), dtype=torch.float64,
                        device="cuda")
    q = model.state["fields"][name].to(torch.float64)
    if hasattr(grid, "fluid_mask"):
        q = q * grid.fluid_mask(("c", "c", "c"), torch.float64)
    ints = grid.interior_slices
    qv = (q * V)[ints]
    return qv.sum().item(), qv.abs().sum().item()


def ocean_path_phase(card):
    """Phase 22: the CATKE ocean row at 512x256x32 float32 (``ocean_model``)
    with a flat bottom (the fused tendency #10) and with the immersed ridge
    (the plain tendency, as in JAX), Δt = 120 s: counters reset just before
    3 warm-up and 10 timed steps and read just after; #10 once a step on
    the flat bottom and never on the ridge, the fill kernel, no plain fill
    of a bounded axis, no plain tendency on CUDA tensors on the flat bottom;
    finite fields; |Σ(T·V) − Σ(T₀·V)|/Σ|T₀·V| < 1e-6 over the fluid cells
    across the timed steps; the ridge's solid cells zero; the cfl's substep
    count; then the phase shares (3 steps), the device-busy share and the
    device kernels per step (3 steps), and peak memory."""
    from oceananigans_tpu_torch import kernels as K
    dt = OCEAN_DT
    out = {}
    for label, immersed in OCEAN_VARIANTS.items():
        label = f"CATKE ocean row, {label}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = ocean_model(HYDRO_N, torch.float32, "cuda",
                            immersed=immersed)
        assert model.uses_kernel != immersed, (label, model.uses_kernel)
        fs = model.free_surface
        frac, weights = fs.settings(dt)
        print(f"{label}: SplitExplicitFreeSurface(cfl=0.7) Δτ "
              f"{fs.substepping.dt_barotropic:.4f} s, {round(2 / frac)} "
              f"substeps for Δt = {dt} s ({len(weights)} weighted), TKE "
              f"substeps {model.tke_substeps(dt)} [{card}]")
        K.reset_counters()
        for _ in range(3):
            model.time_step(dt)
        torch.cuda.synchronize()
        T0, T0abs = fluid_volume_sum(model, "T")
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            model.time_step(dt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches, plain_cuda = K.counters()
        steps = model.iteration
        print(f"{label} launches over {steps} steps: {launches}; plain "
              f"calls on CUDA: {plain_cuda}")
        expect = steps if not immersed else 0
        assert launches["fused_vi_tendency"] == expect, \
            (label, launches["fused_vi_tendency"], expect)
        assert launches["fill_halos"] > 0
        assert plain_cuda["fill_bounded_axis"] == 0, "a plain x/y fill ran"
        for name, count in plain_cuda.items():
            if immersed and name == "fused_vi_tendency_plain":
                continue
            assert count == 0, f"plain {name} ran on CUDA tensors"
        peak = torch.cuda.max_memory_allocated()
        for name in model.prognostic_names + ("w",):
            a = model.field(name).interior
            assert torch.isfinite(a).all().item(), f"{name} is not finite"
        T1, _ = fluid_volume_sum(model, "T")
        drift = abs(T1 - T0) / T0abs
        print(f"{label}: |Σ(T·V) − Σ(T₀·V)|/Σ|T₀·V| over the 10 timed "
              f"steps {drift:.3e} (bound 1e-6)")
        assert drift < 1e-6, (label, "T drift", drift)
        if immersed:
            grid = model.grid
            for name in ("T", "S", "e", "u", "v"):
                loc = model.loc(name)
                solid = ~grid.fluid_mask(loc, torch.bool)
                nz = model.state["fields"][name][solid].abs().max().item()
                assert nz == 0.0, (label, name, "solid cells", nz)
            print(f"{label}: {int(grid.solid_ccc.sum())} solid cells "
                  f"(halos included) hold zero in T, S, e, u and v")
        u = model.field("u").interior
        e = model.field("e").interior
        print(f"{label}: max|u| {u.abs().max().item():.4e}, max e "
              f"{e.max().item():.4e} after {steps} steps")
        step_ms = statistics.median(times) * 1e3
        n = HYDRO_N[0] * HYDRO_N[1] * HYDRO_N[2]
        print(f"{label}: {HYDRO_N[0]}x{HYDRO_N[1]}x{HYDRO_N[2]} lat-lon "
              f"WENO-VI CATKE split-explicit(cfl=0.7) float32 QAB2 step "
              f"median {step_ms:.3f} ms over {len(times)} steps (min "
              f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
              f"{n / (step_ms / 1e3):.4e} cell-updates/s [{card}]")
        print(f"{label}: peak device memory (steps): {peak / 2 ** 30:.2f} "
              f"GiB [{card}]")
        per_step = {k: launches[k] / steps for k in HYDRO_KERNELS}
        print(f"{label}: launches per step: {per_step}")
        ocean_phase_shares(model, dt, 3, card, label)
        busy_share(label, model, dt, 3, step_ms, card)
        out[label] = (launches, step_ms)
        del model
    torch.cuda.empty_cache()
    return out


# -- the global tripolar ocean (phase 24) ------------------------------------------

GLOBAL_N = (360, 170, 32)
POLAR_N = (360, 180, 32)
# the pole-to-pole piece's step: at 600 s the polar rows of a 1° grid blow
# up within three steps in both packages (u 0.07 → 16 → 431 m/s at
# 360x180x4 in float64, the JAX model to 7 digits), so the piece steps at
# the JAX polar test's 60 s
POLAR_DT = 60.0
GLOBAL_DT = 600.0
GLOBAL_POLES = ((70.0, 55.0), (250.0, 55.0))   # the grid's two north poles
GLOBAL_KERNELS = ("fill_halos",)


def global_z(nz):
    """The row's stretched z: 4000 m in ``nz`` exponentially stretched
    levels (9.9 m at the top and 479 m at the bottom for 32)."""
    from oceananigans_tpu_torch.grids import ExponentialDiscretization
    return ExponentialDiscretization(nz, -4000.0, 0.0, scale=1000.0)


def _degrees_apart(lam1, phi1, lam2, phi2):
    """The great-circle angle between two points, in degrees."""
    p1, p2 = np.radians(phi1), np.radians(phi2)
    c = (np.sin(p1) * np.sin(p2)
         + np.cos(p1) * np.cos(p2) * np.cos(np.radians(lam1 - lam2)))
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def global_bottom(lam, phi):
    """The row's bottom height (m) at the given (λ, φ), numpy: land (200 m)
    within 12° of both north poles (70°E and 250°E at 55°N) and on the two
    meridional barriers of examples/near_global_ocean.py's ``bottom``
    (-60°E south to 55°S, with the 1500 m Drake-like sill in the gap, and
    20°E south to 35°S), 4000 m deep elsewhere."""
    lam = np.asarray(lam, float)
    phi = np.asarray(phi, float)
    east = lambda c: (lam - c + 180.0) % 360.0 - 180.0    # noqa: E731
    depth = np.full(np.broadcast_shapes(lam.shape, phi.shape), -4000.0)
    barrier1 = (np.abs(east(-60.0)) < 12.0) & (phi > -55.0)
    barrier2 = (np.abs(east(20.0)) < 15.0) & (phi > -35.0)
    depth = np.where(barrier1 | barrier2, 200.0, depth)
    depth = np.where((np.abs(east(-60.0)) < 12.0) & (phi <= -55.0),
                     -1500.0, depth)
    for plam, pphi in GLOBAL_POLES:
        depth = np.where(_degrees_apart(lam, phi, plam, pphi) < 12.0, 200.0,
                         depth)
    return depth


def global_wind_stress(lam, phi, t):
    """u's top flux: the trades, westerlies and polar easterlies of
    examples/near_global_ocean.py (the negative of the eastward stress,
    kinematic), of tensors or numpy arrays."""
    xp = torch if isinstance(phi, torch.Tensor) else np
    phi_r = phi * (np.pi / 180.0)
    return -1.2e-4 * (-xp.cos(3.0 * phi_r)) * xp.cos(phi_r) ** 2


def global_initial_state(lam, phi, zc, seed=0):
    """(T, u, v) interior arrays from the true centre nodes (λ, φ) (Nx, Ny)
    and the centre depths ``zc``: T = 2 + 25 cos²φ e^{z/1000}, and small
    random geographic east and north velocities (0.01·N(0, 1)) from
    np.random.default_rng(seed)."""
    T = 2.0 + 25.0 * (np.cos(np.radians(phi)) ** 2)[:, :, None] \
        * np.exp(np.asarray(zc)[None, None, :] / 1000.0)
    rng = np.random.default_rng(seed)
    shape = T.shape
    return T, 0.01 * rng.standard_normal(shape), \
        0.01 * rng.standard_normal(shape)


def global_model(N, dtype, device, smoothness=torch.float32):
    """The global tripolar ocean row: ``TripolarGrid(N,
    southernmost_latitude=-80, north_poles_latitude=55,
    first_pole_longitude=70)`` with the stretched ``global_z``, an
    ImmersedBoundaryGrid with ``GridFittedBottom`` of the array
    ``global_bottom`` at the true centre nodes; WENOVectorInvariant(),
    WENO(5) T and S, linear SeawaterBuoyancy, CATKE,
    HydrostaticSphericalCoriolis(), SplitExplicitFreeSurface(cfl=0.7),
    ``global_wind_stress`` on u's top and the quadratic bottom drag; T,
    S = 35 and geographic (u, v) from ``global_initial_state`` (seed 0),
    which ``set`` rotates into the grid."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.closures import CATKEVerticalDiffusivity
    from oceananigans_tpu_torch.grids import TripolarGrid
    from oceananigans_tpu_torch.immersed import (GridFittedBottom,
                                                 ImmersedBoundaryGrid)
    under = TripolarGrid(N, southernmost_latitude=-80.0,
                         north_poles_latitude=55.0, first_pole_longitude=70.0,
                         z=global_z(N[2]), dtype=dtype, device=device)
    lam, phi = under.nodes2d(("c", "c"))
    grid = ImmersedBoundaryGrid(under, GridFittedBottom(
        global_bottom(lam, phi)))
    model = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.WENOVectorInvariant(
            smoothness_dtype=smoothness),
        tracer_advection=ot.WENO(5, smoothness_dtype=smoothness),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=ot.SplitExplicitFreeSurface(cfl=0.7),
        buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=ot.LinearEquationOfState()),
        closure=CATKEVerticalDiffusivity(), tracers=("T", "S"),
        boundary_conditions={"u": ot.FieldBoundaryConditions(
            top=ot.FluxBoundaryCondition(global_wind_stress),
            bottom=ot.FluxBoundaryCondition(
                ocean_drag, field_dependencies=("u", "v")))})
    npdt = np.float32 if dtype == torch.float32 else np.float64
    T, u, v = (a.astype(npdt) for a in global_initial_state(
        lam, phi, under.znodes("c"), seed=0))
    model.set(T=T, S=35.0, u=u, v=v)
    return model


# the bound on |Σ(T·V) − Σ(T₀·V)|/Σ|T₀·V| over the fluid cells across the
# timed steps, the CATKE ocean row's (phase 22): float32 rounding over 20
# steps of ~1.6M wet cells; a leak through the fold or the immersed bottom
# would pass it within a few steps
GLOBAL_DRIFT_BOUND = 1e-6


def halo_noise(grid, fields, seed):
    """Copies of ``fields`` with every halo slot replaced by seeded noise
    (the interiors kept), so that a fill check writes every slot anew."""
    gen = torch.Generator(device=fields[0].device).manual_seed(seed)
    out = []
    for f in fields:
        a = torch.randn(f.shape, generator=gen, device=f.device,
                        dtype=f.dtype)
        ints = tuple(s if f.shape[ax] > 1 else slice(None)
                     for ax, s in enumerate(grid.interior_slices))
        a[ints] = f[ints]
        out.append(a)
    return out


def global_fill_phase(label, model, card, seed):
    """The fill kernel against fill_halos_plain on the model's own state,
    halos overwritten with noise first, bit for bit (``fill_check``): the
    3-D batch (u, v, w, T, S, e; every axis) and the 2-D one (η, U, V; x and
    y, as the substep loop fills them); times, bytes and sector floors."""
    grid = model.grid
    names3 = ("u", "v", "w") + tuple(model.tracer_names)
    f3 = halo_noise(grid, [model.state["w"] if n == "w"
                           else model.state["fields"][n] for n in names3],
                    seed)
    lb3 = model_locs_bcs(model, names3)
    bt = model.state["barotropic"]
    f2 = halo_noise(grid, [model.state["fields"]["eta"], bt["U"], bt["V"]],
                    seed + 1)
    lb2 = [(("c", "c", "c"), model.bcs["eta"]),
           (("f", "c", "c"), model.bcs["u"]), (("c", "f", "c"), model.bcs["v"])]
    out = {}
    for key, fields, lbs, z, what in (
            ("3d", f3, lb3, True, f"{', '.join(names3)}"),
            ("2d", f2, lb2, False, "η, U, V")):
        err = fill_check(f"{label} ({what})", grid, fields, lbs, z=z)
        out[key] = time_fill(f"{label} ({what})", grid, fields, lbs, err,
                             z=z)
    return out


def pole_to_pole_piece(card):
    """A LatitudeLongitudeGrid(POLAR_N, latitude=(-90, 90)) with the row's
    stretched z: 3 steps of ``POLAR_DT`` of a model on it (CATKE, WENO,
    float32), finite; the POLAR caps against the plain fill on the card
    (every location, and the model's own state with noisy halos)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.boundary_conditions import \
        regularize_field_boundary_conditions
    from oceananigans_tpu_torch.closures import CATKEVerticalDiffusivity
    grid = ot.LatitudeLongitudeGrid(size=POLAR_N, longitude=(0, 360),
                                    latitude=(-90, 90), z=global_z(POLAR_N[2]),
                                    dtype=torch.float32, device="cuda")
    assert grid.polar_south and grid.polar_north
    model = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.WENOVectorInvariant(),
        tracer_advection=ot.WENO(5),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        buoyancy=ot.SeawaterBuoyancy(
            equation_of_state=ot.LinearEquationOfState()),
        closure=CATKEVerticalDiffusivity(), tracers=("T", "S"),
        boundary_conditions={"u": ot.FieldBoundaryConditions(
            top=ot.FluxBoundaryCondition(global_wind_stress))})
    assert not model.uses_kernel
    lam, phi = grid.nodes1d(0, "c"), grid.nodes1d(1, "c")
    lam2, phi2 = np.meshgrid(lam, phi, indexing="ij")
    T, u, v = (a.astype(np.float32) for a in global_initial_state(
        lam2, phi2, grid.znodes("c"), seed=1))
    model.set(T=T, S=35.0, u=u, v=v)
    from oceananigans_tpu_torch import kernels as K
    K.reset_counters()
    t0 = time.perf_counter()
    for _ in range(3):
        model.time_step(POLAR_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_cuda = K.counters()
    for name in model.prognostic_names + ("w",):
        a = model.field(name).interior
        assert torch.isfinite(a).all().item(), f"pole to pole: {name}"
    assert plain_cuda["fill_halos_plain"] == 0 and \
        plain_cuda["fill_bounded_axis"] == 0, "a plain fill ran"
    print(f"pole-to-pole {POLAR_N} lat-lon (polar caps, stretched z, CATKE, "
          f"WENO, float32): 3 steps of {POLAR_DT} s in {wall:.3f} s, "
          f"{launches['fill_halos']} fill launches, finite; max|u| "
          f"{model.field('u').interior.abs().max().item():.4e} [{card}]")
    a = [torch.randn(grid.padded_shape, device="cuda", dtype=torch.float32)
         for _ in FILL_LOCS]
    lbs = [(loc, regularize_field_boundary_conditions(None, grid, loc))
           for loc in FILL_LOCS]
    fill_check("pole to pole, every location (POLAR caps)", grid, a, lbs)
    measured = global_fill_phase("pole to pole", model, card, 7)
    measured["launches"] = launches
    del model
    torch.cuda.empty_cache()
    return measured


def global_path_phase(card):
    """Phase 24: the global tripolar ocean (``global_model``) at 360x170x32
    float32, Δt = 600 s: counters reset just before 3 warm-up and 20 timed
    steps and read just after: the fill kernel, no plain fill and no fused
    VI kernel (shell grids take the plain tendency, as in JAX), no plain
    version on CUDA tensors but the tendency; finite fields; T's content
    over the wet cells within ``GLOBAL_DRIFT_BOUND`` across the timed
    steps; step median, min and max, peak memory, the phase shares, the
    busy share and device kernels per step; the fill kernel against its
    plain version on the row's own state (bit for bit), timed; then the
    pole-to-pole piece."""
    from oceananigans_tpu_torch import kernels as K
    dt = GLOBAL_DT
    label = "global tripolar row"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = global_model(GLOBAL_N, torch.float32, "cuda")
    build_s = time.perf_counter() - t0
    assert not model.uses_kernel
    grid = model.grid
    fs = model.free_surface
    frac, weights = fs.settings(dt)
    wet = int((~grid.solid_ccc[grid.interior_slices]).sum())
    print(f"{label}: {GLOBAL_N} TripolarGrid (poles 70°E/250°E at 55°N), "
          f"stretched z {float(np.min(np.diff(grid.znodes('f')))):.2f}-"
          f"{float(np.max(np.diff(grid.znodes('f')))):.2f} m, {wet} wet of "
          f"{int(np.prod(GLOBAL_N))} cells, halo {grid.H}; built and set in "
          f"{build_s:.2f} s; SplitExplicitFreeSurface(cfl=0.7) Δτ "
          f"{fs.substepping.dt_barotropic:.4f} s, {round(2 / frac)} substeps "
          f"for Δt = {dt} s; TKE substeps {model.tke_substeps(dt)} [{card}]")
    K.reset_counters()
    for _ in range(3):
        model.time_step(dt)
    torch.cuda.synchronize()
    T0, T0abs = fluid_volume_sum(model, "T")
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    print(f"{label} launches over {steps} steps: {launches}; plain calls on "
          f"CUDA: {plain_cuda}")
    assert launches["fill_halos"] > 0 and launches["fused_vi_tendency"] == 0
    for name, count in plain_cuda.items():
        if name != "fused_vi_tendency_plain":
            assert count == 0, f"plain {name} ran on CUDA tensors"
    peak = torch.cuda.max_memory_allocated()
    for name in model.prognostic_names + ("w",):
        a = model.field(name).interior
        assert torch.isfinite(a).all().item(), f"{name} is not finite"
    T1, _ = fluid_volume_sum(model, "T")
    drift = abs(T1 - T0) / T0abs
    print(f"{label}: |Σ(T·V) − Σ(T₀·V)|/Σ|T₀·V| over the wet cells across "
          f"the 20 timed steps {drift:.3e} (bound {GLOBAL_DRIFT_BOUND:g})")
    assert drift < GLOBAL_DRIFT_BOUND, (label, "T drift", drift)
    step_ms = statistics.median(times) * 1e3
    n = int(np.prod(GLOBAL_N))
    print(f"{label}: step median {step_ms:.3f} ms over {len(times)} steps "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n / (step_ms / 1e3):.4e} cell-updates/s, "
          f"{GLOBAL_DT / (step_ms / 1e3) / 86400:.2f} simulated days per "
          f"wall-clock second [{card}]")
    print(f"{label}: peak device memory (steps): {peak / 2 ** 30:.2f} GiB "
          f"[{card}]")
    print(f"{label}: max|u| {model.field('u').interior.abs().max().item():.4e}"
          f", max e {model.field('e').interior.max().item():.4e}, max|η| "
          f"{model.field('eta').interior.abs().max().item():.4e}")
    print(f"{label}: fill launches per step {launches['fill_halos'] / steps:.1f}")
    ocean_phase_shares(model, dt, 3, card, label)
    busy_share(label, model, dt, 3, step_ms, card)
    measured = global_fill_phase(label, model, card, 5)
    measured["launches"] = launches
    measured["step_ms"] = step_ms
    del model
    torch.cuda.empty_cache()
    measured["polar"] = pole_to_pole_piece(card)
    return measured


# -- the run loop (phase 23) ------------------------------------------------------

FLAGSHIP_SIM_DT = 1e-4
SIM_STEPS = 20
HOOK_N = 64
TAU_SNAPSHOTS = 4
TAU_SPACING = 6 * 3600.0
SIM_START = datetime.datetime(2024, 1, 1)


def flat_state(state, prefix=""):
    """A model's state as {"fields/u": tensor, "clock/time": scalar, ...}."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(flat_state(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def check_same_state(label, a, b):
    """Every tensor of two models' states bit for bit (max |a − b| printed)
    and their clocks equal."""
    sa, sb = flat_state(a.state), flat_state(b.state)
    assert set(sa) == set(sb), (label, sorted(set(sa) ^ set(sb)))
    worst, n = 0.0, 0
    for key, x in sa.items():
        y = sb[key]
        if isinstance(x, torch.Tensor):
            assert x.shape == y.shape and x.dtype == y.dtype, (label, key)
            assert torch.isfinite(x).all().item(), (label, key, "not finite")
            worst = max(worst, (x - y).abs().max().item())
            assert torch.equal(x, y), (label, key, "differs")
            n += 1
        else:
            assert x == y, (label, key, x, y)
    print(f"{label}: picked up at iteration 10 and run to "
          f"{a.iteration}: max |diff| {worst:.1e} over {n} state tensors "
          f"(bit for bit), clocks equal")


class StepClock:
    """A callback on every iteration: synchronize the card and read the
    host clock, so that consecutive readings time the loop's steps."""

    def __init__(self):
        self.stamps = []

    def __call__(self, sim):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())


def loop_overhead(label, model, dt, steps, card, rounds=3):
    """Same-call A/B of the bare ``time_step`` loop and ``Simulation.run``
    with no writers (its default NaN check only), alternated ``rounds``
    times over ``steps`` steps each: the median step of each side, host
    clock from one synchronize to the next."""
    import oceananigans_tpu_torch as ot
    bare, loop = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        for _ in range(steps):
            t0 = time.perf_counter()
            model.time_step(dt)
            torch.cuda.synchronize()
            bare.append(time.perf_counter() - t0)
        sim = ot.Simulation(model, dt=dt,
                            stop_iteration=model.iteration + steps)
        clock = StepClock()
        sim.add_callback(clock, name="clock")
        torch.cuda.synchronize()
        start = time.perf_counter()
        sim.run()
        stamps = [start] + clock.stamps
        loop.extend(b - a for a, b in zip(stamps, stamps[1:]))
    b_ms = statistics.median(bare) * 1e3
    s_ms = statistics.median(loop) * 1e3
    print(f"{label}: bare time_step loop median {b_ms:.3f} ms (min "
          f"{min(bare) * 1e3:.3f}, max {max(bare) * 1e3:.3f}), Simulation.run "
          f"median {s_ms:.3f} ms (min {min(loop) * 1e3:.3f}, max "
          f"{max(loop) * 1e3:.3f}), difference {s_ms - b_ms:+.3f} ms "
          f"({100 * (s_ms - b_ms) / b_ms:+.2f}%), {rounds} alternated runs "
          f"of {steps} steps each [{card}]")
    return b_ms, s_ms


def path_bytes(path):
    """The bytes of a file, or of every file under a directory."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


class WriteLog:
    """Times a writer's writes (host clock, the card synchronized before and
    after) and the bytes each adds to its file or directory."""

    def __init__(self):
        self.ms, self.bytes = {}, {}

    def wrap(self, label, obj, method, path):
        fn = getattr(obj, method)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            before = path_bytes(path) if os.path.exists(path) else 0
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms.setdefault(label, []).append(
                (time.perf_counter() - t0) * 1e3)
            self.bytes.setdefault(label, []).append(path_bytes(path) - before)
            return out
        setattr(obj, method, timed)

    def report(self, label, card):
        for name, ms in self.ms.items():
            nbytes = self.bytes[name]
            rate = statistics.median(nbytes) / 1e3 / statistics.median(ms)
            print(f"{label}: {name}: {len(ms)} calls, median "
                  f"{statistics.median(ms):.3f} ms (min {min(ms):.3f}, max "
                  f"{max(ms):.3f}), {statistics.median(nbytes):,.0f} bytes a "
                  f"call, {rate:.1f} MB/s at the median [{card}]")


def timed_wizard(wizard, log):
    """The wizard as a callback whose calls are timed (host clock, the
    card's queued work finished first, the wizard's own sync inside)."""
    def call(sim):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wizard(sim)
        log.append((time.perf_counter() - t0) * 1e3)
    return call


def expected_average(samples, t_out, window, tol):
    """The time average over [t_out − window, t_out] of (t, u) samples, as
    WindowedTimeAverage weighs them: each sample by the time since the
    previous one inside the window (left Riemann), in float64."""
    start = t_out - window
    acc, wsum, last = None, 0.0, None
    for t, u in samples:
        if t < start - tol or t > t_out + tol:
            continue
        w = max(t - start, 0.0) if last is None or last < start else t - last
        last = t
        if w <= 0:
            continue
        acc = w * u.double() if acc is None else acc + w * u.double()
        wsum += w
    return acc / wsum


def flagship_simulation_phase(card, tmp):
    """Phase 23 (a): the 256³ flagship through Simulation.run (see the
    module docstring)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.simulation.output_writers import field_output
    label = "flagship Simulation"
    n = 256
    model = bench_model(n, torch.float32, "cuda")
    for _ in range(3):
        model.time_step(FLAGSHIP_SIM_DT)
    loop_overhead(label, model, FLAGSHIP_SIM_DT, 10, card)
    del model
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = bench_model(n, torch.float32, "cuda")
    ints = model.grid.interior_slices
    sim = ot.Simulation(model, dt=FLAGSHIP_SIM_DT, stop_iteration=SIM_STEPS)
    wizard_ms = []
    sim.add_callback(timed_wizard(ot.TimeStepWizard(cfl=0.5), wizard_ms),
                     ot.IterationInterval(5), name="wizard")
    sim.add_callback(lambda s: print(
        f"{label}: iteration {s.model.iteration}, t = {s.model.time:.6e}, "
        f"Δt = {s.dt:.6e}"), ot.IterationInterval(5), name="progress")
    # the record the files are checked against, taken from the state
    u_samples = [(model.time, model.state["fields"]["u"][ints].clone())]
    slices = {0: model.state["fields"]["u"][ints][:, :, n // 2].clone()}
    dts = {}

    def record(s):
        m = s.model
        dts[m.iteration] = float(m.state["clock"]["last_dt"])
        u = m.state["fields"]["u"][ints]
        u_samples.append((m.time, u.clone()))
        if m.iteration % 5 == 0:
            slices[m.iteration] = u[:, :, n // 2].clone()
    sim.add_callback(record, name="record")
    surface_path = os.path.join(tmp, "flagship_surface")
    surface = ot.FieldWriter(model, {"u": "u", "w": "w"}, surface_path,
                             schedule=ot.TimeInterval(5.5e-4),
                             indices=(slice(None), slice(None), -1))
    average_path = os.path.join(tmp, "flagship_average")
    average = ot.FieldWriter(model, {"u": "u"}, average_path,
                             schedule=ot.AveragedTimeInterval(
                                 1e-3, window=5e-4))
    nc_path = os.path.join(tmp, "flagship_slice.nc")
    netcdf = ot.NetCDFWriter(model, {"u_mid": lambda m: m.field(
        "u").interior[:, :, n // 2]}, nc_path, schedule=ot.IterationInterval(5))
    ckpt_dir = os.path.join(tmp, "flagship_checkpoints")
    checkpointer = ot.Checkpointer(model, ot.IterationInterval(10),
                                   dir=ckpt_dir)
    log = WriteLog()
    written = {}

    def stash_surface(m):
        # the state at the write, for the read-back check
        u = m.state["fields"]["u"][ints][:, :, -1].clone()
        w = field_output(m.field("w"))[:, :, -1].clone()
        written[m.iteration] = (u, w)
    orig_surface = surface._write_arrays

    def surface_write(m, arrays):
        stash_surface(m)
        return orig_surface(m, arrays)
    surface._write_arrays = surface_write
    log.wrap("FieldWriter surface u, w (TimeInterval 5.5e-4)", surface,
             "_write_arrays", surface_path)
    log.wrap("FieldWriter u average (AveragedTimeInterval 1e-3, window "
             "5e-4): the write", average, "_write_arrays", average_path)
    log.wrap("FieldWriter u average: collect a step", average, "maybe_write",
             average_path)
    log.wrap("NetCDFWriter u slice (IterationInterval 5)", netcdf, "write",
             nc_path)
    log.wrap("Checkpointer (IterationInterval 10)", checkpointer, "write",
             ckpt_dir)
    for name, w in (("surface", surface), ("average", average),
                    ("netcdf", netcdf), ("checkpointer", checkpointer)):
        sim.add_output_writer(w, name=name)

    K.reset_counters()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_cuda = K.counters()
    netcdf.close()
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} launches over {model.iteration} steps of run(): "
          f"{launches}; plain calls on CUDA: {plain_cuda}")
    for name in FLAGSHIP_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched in run()"
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    assert model.iteration == SIM_STEPS
    for key, a in flat_state(model.state).items():
        if isinstance(a, torch.Tensor):
            assert torch.isfinite(a).all().item(), f"{key} is not finite"
    dt_seq = [dts[i] for i in sorted(dts)]
    print(f"{label}: Δt sequence {dt_seq}")
    # a float32 clock that missed a schedule time would step the remainder,
    # tens of picoseconds
    assert min(dt_seq) > 1e-3 * FLAGSHIP_SIM_DT, "a vanishing aligned Δt"
    print(f"{label}: run() wall {wall:.3f} s ({sim.run_wall_time:.3f} s "
          f"inside the loop) for {SIM_STEPS} steps with the writers, peak "
          f"device memory {peak / 2 ** 30:.2f} GiB [{card}]")
    print(f"{label}: TimeStepWizard(cfl=0.5) {len(wizard_ms)} calls, median "
          f"{statistics.median(wizard_ms):.3f} ms (max {max(wizard_ms):.3f}) "
          f"[{card}]")
    log.report(label, card)

    # the files read back through the port's own readers
    fts = {k: ot.FieldTimeSeries(surface_path, k, device="cuda")
           for k in ("u", "w")}
    assert fts["u"].iterations == sorted(written), (fts["u"].iterations,
                                                    sorted(written))
    for i, it in enumerate(fts["u"].iterations):
        u, w = written[it]
        assert torch.equal(fts["u"][i], u) and torch.equal(fts["w"][i], w), it
        assert not w.any(), "w at the lid is not 0"
    avg = ot.FieldTimeSeries(average_path, "u", device="cuda")
    assert len(avg) >= 3, avg.iterations
    assert torch.equal(avg[0], u_samples[0][1]), "the run-start output"
    tol = 1e-9 * 1e-3
    worst = 0.0
    for i in range(1, len(avg)):
        want = expected_average(u_samples, avg.times[i], 5e-4, tol)
        err = ((avg[i].double() - want).abs().max()
               / want.abs().max()).item()
        worst = max(worst, err)
    print(f"{label}: averages at t = {list(avg.times[1:])} against the "
          f"recorded states: max rel {worst:.3e} (bound 1e-6)")
    assert worst < 1e-6, ("time average", worst)
    with netcdf_file(nc_path, "r", mmap=False) as f:
        data = torch.as_tensor(f.variables["u_mid"][:].astype(np.float32),
                               device="cuda")
    assert data.shape[0] == len(slices), (data.shape, sorted(slices))
    for i, it in enumerate(sorted(slices)):
        assert torch.equal(data[i], slices[it]), ("netcdf", it)
    print(f"{label}: the surface FieldWriter ({len(fts['u'])} writes), the "
          f"averaged FieldWriter ({len(avg)}) and the NetCDF slices "
          f"({len(slices)}) read back equal to the state")

    # the pickup from the iteration-10 checkpoint, with the same Δt (dts[k]
    # is the step that ended at iteration k; the wizard's Δt is not in a
    # checkpoint)
    model2 = bench_model(n, torch.float32, "cuda", seed=1)
    sim2 = ot.Simulation(model2, dt=dts[11], stop_iteration=SIM_STEPS)
    sim2.add_callback(lambda s: setattr(s, "dt", dts.get(
        s.model.iteration + 1, s.dt)), name="replay")
    sim2.run(pickup=checkpointer.path(10))
    check_same_state(label, model, model2)
    del model, model2, u_samples, slices, written, sim, sim2
    torch.cuda.empty_cache()


def tendency_hook_check(card):
    """Phase 23 (a): at 64³ a no-op TendencyCallsite hook takes the flagship
    model from #1 to #6; 3 steps equal the hook-free model on the tendency
    route bit for bit and the fused route to float32 roundoff."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    dt = 1e-3
    hooked = bench_model(HOOK_N, torch.float32, "cuda")
    sim = ot.Simulation(hooked, dt=dt, stop_iteration=3)
    sim.add_callback(lambda grid, fields, G, time: G,
                     callsite=ot.TendencyCallsite)
    assert not hooked._fused_update
    K.reset_counters()
    sim.run()
    launches, plain_cuda = K.counters()
    print(f"{HOOK_N}^3 with a tendency hook, launches over 3 steps: "
          f"{launches}; plain calls on CUDA: {plain_cuda}")
    assert launches["fused_advection_update"] == 0, "#1 ran with a hook"
    for name in ("fused_advection_tendency", "fused_divergence",
                 "fused_correct", "fill_halos"):
        assert launches[name] > 0, (name, "not launched with a hook")
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    route = bench_model(HOOK_N, torch.float32, "cuda")
    route._fused_update = route.fuse_correction = False
    fused = bench_model(HOOK_N, torch.float32, "cuda")
    for _ in range(3):
        route.time_step(dt)
        fused.time_step(dt)
    worst_route = worst_fused = 0.0
    for c in ("u", "v", "w"):
        a = hooked.field(c).interior
        worst_route = max(worst_route,
                          (a - route.field(c).interior).abs().max().item())
        scale = fused.field(c).interior.abs().max().item()
        worst_fused = max(worst_fused, (a - fused.field(
            c).interior).abs().max().item() / scale)
    print(f"{HOOK_N}^3 tendency hook: against the hook-free tendency route "
          f"max |diff| {worst_route:.3e} (bit for bit), against the fused "
          f"route max rel {worst_fused:.3e} (bound 1e-5) [{card}]")
    assert worst_route == 0.0
    assert worst_fused < 1e-5


def tau_snapshots(grid_n, seed=23):
    """The wind stress τx at 4 times 6 h apart over 512x256: the golden's
    -1e-4 times a seeded pattern (zonal waves whose phase moves with time
    and a random amplitude a snapshot), float32."""
    rng = np.random.default_rng(seed)
    nx, ny = grid_n[:2]
    x = np.arange(nx)[:, None] / nx
    y = np.arange(ny)[None, :] / ny
    snaps = []
    for k in range(TAU_SNAPSHOTS):
        amp = rng.uniform(0.2, 0.5)
        pattern = 1 + amp * np.sin(2 * np.pi * (2 * x + k / TAU_SNAPSHOTS)) \
            * np.cos(np.pi * (y - 0.5))
        snaps.append((-1e-4 * pattern).astype(np.float32))
    return snaps


class SnapshotClock:
    """A stand-in model for writing a series: a grid, an iteration, a
    time."""

    def __init__(self, grid):
        self.grid = grid
        self.iteration, self.time = 0, 0.0


def write_tau_series(path, grid, snaps):
    import oceananigans_tpu_torch as ot
    stub = SnapshotClock(grid)
    writer = ot.FieldWriter(stub, {"tau_x": lambda m: snaps[m.iteration]},
                            path)
    for k in range(len(snaps)):
        stub.iteration, stub.time = k, k * TAU_SPACING
        writer.write(type("Run", (), {"model": stub})())


def ocean_simulation_phase(card, tmp):
    """Phase 23 (b): the CATKE ocean row through Simulation.run (see the
    module docstring)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    label = "CATKE ocean Simulation"
    snaps = tau_snapshots(HYDRO_N)
    tau_path = os.path.join(tmp, "tau")
    write_tau_series(tau_path, ot.LatitudeLongitudeGrid(
        size=HYDRO_N, longitude=(0, 60), latitude=(15, 75),
        z=(-1800.0, 0.0), dtype=torch.float32, device="cuda"), snaps)
    series = ot.FieldTimeSeries(tau_path, "tau_x", device="cuda")
    assert len(series) == TAU_SNAPSHOTS

    def make():
        return ocean_model(HYDRO_N, torch.float32, "cuda",
                           top_u=ot.FieldTimeSeriesBoundaryCondition(series),
                           reference_datetime=SIM_START)

    # the interpolated stress at a mid-snapshot time against the snapshots
    # lerped by hand, and through the boundary condition's padded plane
    t_mid = 1.3 * TAU_SPACING
    w = (t_mid - TAU_SPACING) / TAU_SPACING
    hand = (1 - w) * torch.as_tensor(snaps[1], device="cuda") \
        + w * torch.as_tensor(snaps[2], device="cuda")
    assert torch.equal(series.at_time(t_mid), hand), "series interpolation"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = make()
    cond = model.bcs["u"].top.condition
    plane = cond.evaluate_padded(model.grid, t_mid)
    H = model.grid.H
    assert torch.equal(plane[H[0]:H[0] + HYDRO_N[0], H[1]:H[1] + HYDRO_N[1],
                             0], hand), "the boundary condition's plane"
    print(f"{label}: τx at t = {t_mid} s (series, and the condition's padded "
          f"plane) equals the hand-lerped snapshots bit for bit")

    stop = SIM_START + datetime.timedelta(seconds=SIM_STEPS * OCEAN_DT)
    sim = ot.Simulation(model, dt=OCEAN_DT, stop_time=stop)
    wizard_ms = []
    sim.add_callback(timed_wizard(ot.TimeStepWizard(cfl=0.5,
                                                    max_dt=OCEAN_DT),
                                  wizard_ms),
                     ot.IterationInterval(5), name="wizard")
    sim.add_callback(lambda s: print(
        f"{label}: iteration {s.model.iteration}, {s.model.datetime}, "
        f"Δt = {s.dt}"), ot.IterationInterval(5), name="progress")
    surfaces, dts = {}, []

    def record(s):
        m = s.model
        dts.append(float(m.state["clock"]["last_dt"]))
        if m.iteration % 5 == 0:
            surfaces[m.iteration] = surface_planes(m)
    surfaces[0] = surface_planes(model)
    sim.add_callback(record, name="record")
    nc_path = os.path.join(tmp, "ocean_surface.nc")
    netcdf = ot.NetCDFWriter(
        model, {"T_surface": lambda m: m.field("T").interior[:, :, -1],
                "S_surface": lambda m: m.field("S").interior[:, :, -1],
                "eta": lambda m: m.field("eta").interior[:, :, 0]},
        nc_path, schedule=ot.TimeInterval(5 * OCEAN_DT))
    ckpt_dir = os.path.join(tmp, "ocean_checkpoints")
    checkpointer = ot.Checkpointer(model, ot.IterationInterval(10),
                                   dir=ckpt_dir)
    log = WriteLog()
    log.wrap("NetCDFWriter surface T, S, η (TimeInterval 600 s)", netcdf,
             "write", nc_path)
    log.wrap("Checkpointer (IterationInterval 10)", checkpointer, "write",
             ckpt_dir)
    sim.add_output_writer(netcdf, name="netcdf")
    sim.add_output_writer(checkpointer, name="checkpointer")

    K.reset_counters()
    torch.cuda.synchronize()
    T0, T0abs = fluid_volume_sum(model, "T")
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_cuda = K.counters()
    netcdf.close()
    peak = torch.cuda.max_memory_allocated()
    steps = model.iteration
    print(f"{label} launches over {steps} steps of run(): {launches}; plain "
          f"calls on CUDA: {plain_cuda}")
    assert steps == SIM_STEPS, steps
    assert model.datetime == np.datetime64(stop, "ns"), model.datetime
    # the wizard, capped at the row's Δt, kept it: the pickup replays it
    assert dts == [OCEAN_DT] * steps, dts
    assert launches["fused_vi_tendency"] == steps, launches
    assert launches["fill_halos"] > 0
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    for key, a in flat_state(model.state).items():
        if isinstance(a, torch.Tensor):
            assert torch.isfinite(a).all().item(), f"{key} is not finite"
    T1, _ = fluid_volume_sum(model, "T")
    drift = abs(T1 - T0) / T0abs
    print(f"{label}: |Σ(T·V) − Σ(T₀·V)|/Σ|T₀·V| over the {steps} steps "
          f"{drift:.3e} (bound 1e-6)")
    assert drift < 1e-6, ("T drift", drift)
    print(f"{label}: run() wall {wall:.3f} s ({sim.run_wall_time:.3f} s "
          f"inside the loop) for {steps} steps to {model.datetime}, peak "
          f"device memory {peak / 2 ** 30:.2f} GiB [{card}]")
    print(f"{label}: TimeStepWizard(cfl=0.5, max_dt={OCEAN_DT}) "
          f"{len(wizard_ms)} calls, median {statistics.median(wizard_ms):.3f}"
          f" ms (max {max(wizard_ms):.3f}) [{card}]")
    log.report(label, card)
    with netcdf_file(nc_path, "r", mmap=False) as f:
        got = {k: torch.as_tensor(f.variables[k][:].astype(np.float32),
                                  device="cuda")
               for k in ("T_surface", "S_surface", "eta")}
        times = list(f.variables["time"][:])
    assert times == [float(i * OCEAN_DT) for i in sorted(surfaces)], times
    for i, it in enumerate(sorted(surfaces)):
        for k, want in zip(("T_surface", "S_surface", "eta"), surfaces[it]):
            assert torch.equal(got[k][i], want), ("netcdf", k, it)
    print(f"{label}: the NetCDF surface T, S and η ({len(times)} writes) read "
          f"back equal to the state")

    model2 = make()
    sim2 = ot.Simulation(model2, dt=OCEAN_DT, stop_time=stop)
    sim2.run(pickup=checkpointer.path(10))
    check_same_state(label, model, model2)
    del model
    torch.cuda.empty_cache()
    loop_overhead(label, model2, OCEAN_DT, 10, card)
    del model2
    torch.cuda.empty_cache()


def surface_planes(model):
    """Surface T, S and η of the model's state (copies)."""
    ints = model.grid.interior_slices
    f = model.state["fields"]
    return (f["T"][ints][:, :, -1].clone(), f["S"][ints][:, :, -1].clone(),
            f["eta"][ints[0], ints[1], 0].clone())


def simulation_phase(card):
    """Phase 23: both full-width rows through Simulation.run, with every
    file in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        flagship_simulation_phase(card, tmp)
        tendency_hook_check(card)
        ocean_simulation_phase(card, tmp)


# -- every advection scheme in the advection kernels (phase 25) --------------------

SCHEME_CHECK_N = (70, 44, 36)   # no tile divides x, y or z; both z walls
SCHEME_TIMED = ("WENO(3)", "WENO(7)", "WENO(9)", "WENO(11)", "UpwindBiased(3)",
                "UpwindBiased(5)", "Centered(4)")
SCHEME_SW_N = 16384


def scheme_label(scheme):
    """Centered(4), UpwindBiased(5), WENO(9): the scheme by family and order."""
    return f"{type(scheme).__name__}({scheme.order})"


def all_schemes(smoothness=torch.float32):
    """The 17 schemes the advection kernels take, by label: Centered(2-12),
    UpwindBiased(1-11), WENO(3-11) (the WENO smoothness in
    ``smoothness``)."""
    import oceananigans_tpu_torch as ot
    out = [ot.Centered(o) for o in range(2, 13, 2)]
    out += [ot.UpwindBiased(o) for o in range(1, 12, 2)]
    out += [ot.WENO(o, smoothness_dtype=smoothness) for o in range(3, 12, 2)]
    return {scheme_label(s): s for s in out}


def scheme_inputs(N, dtype, halo, n_tracers, seed):
    """u, v, w (0.1·N(0, 1)), p (1e-3·N(0, 1)) and n_tracers tracers
    (uniform on [0, 1)) on a grid of interior N and ``halo``, x and y
    wrapped; with a z halo, the z halos filled as the convection path's
    (default conditions for u, v, w, b's Value conditions for the
    tracers); in the z-compact layout w's bottom face 0. Returns the grid,
    the fields [u, v, w, tracers...], p and a G⁻ for every field."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 2.0, 1.5), halo=halo,
                              dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = grid.padded_shape
    f = [sc * torch.randn(shape, generator=gen, dtype=dtype, device="cuda")
         for sc in (0.1, 0.1, 0.1)]
    f += [torch.rand(shape, generator=gen, dtype=dtype, device="cuda")
          for _ in range(n_tracers)]
    p = 1e-3 * torch.randn(shape, generator=gen, dtype=dtype, device="cuda")
    K.periodic_halo_fill(grid, f + [p])
    if halo[2] == 0:
        f[2][..., 0] = 0
    else:
        ZF = K.ZFill
        K.bounded_z_fill_plain(grid, f, [ZF(False, (0, 0.0), (0, 0.0))] * 2
                               + [ZF(True, (1, 0.0), (1, 0.0))]
                               + [ZF(False, (2, 0.5), (2, -0.5))] * n_tracers)
    Gm = [torch.randn(N, generator=gen, dtype=dtype, device="cuda")
          for _ in f]
    return grid, f, p, Gm


def sw_scheme_inputs(n, dtype, H, tracers, seed):
    """sw_kernel_inputs' fields on an n² grid with H = (H, H, 0)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import periodic_halo_fill
    grid = ot.RectilinearGrid(size=(n, n), extent=(1.0, 1.0), halo=(H, H, 0),
                              topology=SW_TOPOLOGY, dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(shape, scale, offset=0.0):
        return offset + scale * torch.randn(shape, generator=gen, dtype=dtype,
                                            device="cuda")

    shape = grid.padded_shape
    fields = dict(uh=randn(shape, 0.01), vh=randn(shape, 0.01),
                  h=randn(shape, 0.01, 1.0))
    fields.update({name: randn(shape, 1.0) for name in tracers})
    hB = randn(shape, 0.01)
    periodic_halo_fill(grid, list(fields.values()) + [hB])
    Gm = randn((len(fields),) + grid.N, 1.0)
    return grid, fields, hB, Gm


def update_scales(grid, scheme, f, p, cdt):
    """The term scales of #1's corrected variant: those of the corrected
    velocities and the tracers."""
    from oceananigans_tpu_torch.kernels.fused_advection import \
        corrected_velocities
    return term_scales(grid, scheme, list(corrected_velocities(
        grid, f[0], f[1], f[2], p, cdt)) + f[3:])


def scheme_kernel_checks():
    """#1 (z-compact: the first-stage variant, G⁻ without and with the
    deferred correction, and the correction alone), #6 (z-compact and
    padded) and #8 against their plain versions for each of the 17 schemes,
    at SCHEME_CHECK_N (x, y and z no tile's multiple, so partial tiles and
    both z walls with every cascade level) with two tracers, and #8 at
    70x44 with a tracer:
    - float64 with float64 smoothness, bound 1e-12 relative to each
      tensor's max|plain| (the tile-edge checks' bound of phases 3 and 7:
      FMA contraction and another association order);
    - float32 with float32 smoothness (#1's first-stage and corrected G⁻
      variants, #6 in both layouts): G within 2e-5 of each component's term
      scale (term_scales: a tendency can cancel its terms), #1's new fields
      within 2e-5 relative, #8 within 1e-5 of each tensor's max|plain| (the
      float32 bounds of phases 3, 7 and 16)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    N = SCHEME_CHECK_N
    gdt, zdt, cdt = 0.1, -0.05, 0.07
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        for label, scheme in all_schemes(dtype).items():
            Kb = scheme.required_halo
            grid, f, p, Gm = scheme_inputs(N, dtype, (Kb + 1, Kb + 1, 0), 2,
                                           50)
            tracers = {"c0": f[3], "c1": f[4]}
            worst = [0.0, 0.0, 0.0, 0.0]   # #1, #6 compact, #6 padded, #8
            variants = ((None, None), (Gm, None), (None, p), (Gm, p))
            for gm, pp in variants if f64 else variants[::3]:
                args = (grid, scheme, f[0], f[1], f[2], gm, gdt, zdt, pp,
                        cdt if pp is not None else None)
                Gk, nk = K.fused_advection_update(*args, tracers=tracers)
                Gp, np_ = K.fused_advection_update_plain(*args,
                                                         tracers=tracers)
                if f64:
                    _, rel = worst_rel(Gk + list(nk.values()),
                                       Gp + list(np_.values()))
                else:
                    scales = (update_scales(grid, scheme, f, pp, cdt)
                              if pp is not None
                              else term_scales(grid, scheme, f))
                    _, rel = scaled_err(Gk, Gp, scales)
                    rel = max(rel, worst_rel(list(nk.values()),
                                             list(np_.values()))[1])
                worst[0] = max(worst[0], rel)
            for n, layout in ((1, "compact"), (2, "padded")):
                halo = (Kb, Kb, 0 if layout == "compact" else Kb)
                grid, f, _, _ = scheme_inputs(N, dtype, halo, 2, 51)
                Gk = list(K.fused_advection_tendency(grid, scheme, f))
                Gp = list(K.fused_advection_tendency_plain(grid, scheme, f))
                worst[n] = (worst_rel(Gk, Gp)[1] if f64 else
                            scaled_err(Gk, Gp,
                                       term_scales(grid, scheme, f))[1])
            sgrid, sf, hB, sGm = sw_scheme_inputs(N[0], dtype, Kb + 1, ("c",),
                                                  52)
            names = SW_NAMES + ("c",)
            ints = sgrid.interior_slices
            for gm in (None, sGm):
                args = (sgrid, scheme, 9.81, 0.3, hB, names, sf, gm, 2e-5,
                        -1e-5)
                Gk, nk = K.fused_sw_update(*args)
                Gp, np_ = K.fused_sw_update_plain(*args)
                worst[3] = max(worst[3], worst_rel(
                    list(Gk) + [nk[c][ints] for c in names],
                    list(Gp) + [np_[c][ints] for c in names])[1])
            bounds = (1e-12,) * 4 if f64 else (2e-5, 2e-5, 2e-5, 1e-5)
            print(f"  {label} {str(dtype)[6:]}: #1 {worst[0]:.2e}, #6 "
                  f"compact {worst[1]:.2e}, padded {worst[2]:.2e}, #8 "
                  f"{worst[3]:.2e} (bounds {bounds[0]:g}, {bounds[3]:g}; "
                  f"float32 #1 and #6 of the term scale)")
            for w, b, what in zip(worst, bounds, ("#1", "#6 compact",
                                                  "#6 padded", "#8")):
                assert w <= b, (label, dtype, what, w, b)
        torch.cuda.synchronize()


def scheme_bf16_checks():
    """WENO(7) and WENO(9) with bfloat16 smoothness (float32 fields) against
    their plain versions at SCHEME_CHECK_N (#8 at 70x44), as bf16_check
    holds WENO(5): #1's corrected G⁻ variant (u, v, w, two tracers; G
    within 2e-5 of each component's term scale), #6 padded (2e-5 of each
    component's max|plain|) and #8 (1e-5), each bound at most a tenth of
    the bf16-vs-float32 difference."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    N = SCHEME_CHECK_N
    out = 0.0
    for order in (7, 9):
        bf = ot.WENO(order, smoothness_dtype=torch.bfloat16)
        f32 = ot.WENO(order, smoothness_dtype=torch.float32)
        Kb = bf.required_halo
        grid, f, p, Gm = scheme_inputs(N, torch.float32, (Kb + 1, Kb + 1, 0),
                                       2, 53)
        tracers = {"c0": f[3], "c1": f[4]}

        def upd(fn, scheme):
            return fn(grid, scheme, f[0], f[1], f[2], Gm, 0.1, -0.05, p, 0.07,
                      tracers=tracers)[0]

        Gp = upd(K.fused_advection_update_plain, bf)
        out = max(out, bf16_check(
            f"fused_advection_update WENO({order}) {N} bf16 smoothness "
            f"(corrected, G⁻)", upd(K.fused_advection_update, bf), Gp,
            upd(K.fused_advection_update_plain, f32),
            update_scales(grid, bf, f, p, 0.07), 2e-5, range(5)))
        grid, f, _, _ = scheme_inputs(N, torch.float32, (Kb,) * 3, 1, 54)
        Gp = list(K.fused_advection_tendency_plain(grid, bf, f))
        out = max(out, bf16_check(
            f"fused_advection_tendency padded WENO({order}) {N} bf16 "
            f"smoothness", list(K.fused_advection_tendency(grid, bf, f)), Gp,
            list(K.fused_advection_tendency_plain(grid, f32, f)),
            [g.abs().max().item() for g in Gp], 2e-5, range(4)))
        sgrid, sf, hB, sGm = sw_scheme_inputs(N[0], torch.float32, Kb + 1,
                                              ("c",), 55)
        sf["h"] = 1.0 + 1e-4 * (sf["h"] - 1.0) / 0.01
        names = SW_NAMES + ("c",)

        def sw(fn, scheme):
            return fn(sgrid, scheme, 9.81, 0.3, hB * 1e-2, names, sf, sGm,
                      2e-5, -1e-5)[0]

        Gp = sw(K.fused_sw_update_plain, bf)
        out = max(out, bf16_check(
            f"fused_sw_update WENO({order}) {N[0]}^2 bf16 smoothness (G)",
            list(sw(K.fused_sw_update, bf)), list(Gp),
            list(sw(K.fused_sw_update_plain, f32)),
            [g.abs().max().item() for g in Gp], 1e-5, (0, 1, 3)))
    torch.cuda.synchronize()
    return out


def scheme_mesh_checks():
    """#7 and #9 with WENO(9) (float64 smoothness) on the 2x2 mesh of cuda:0
    against the serial kernels: #7 in both layouts at SCHEME_CHECK_N (blocks
    of 35x22, tiles unlike the serial grid's), #9 at 128² with a tracer
    and bathymetry whose halos are periodic images; bit for bit."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    arch = card_mesh()
    mesh = arch.mesh
    s = ot.WENO(9, smoothness_dtype=torch.float64)
    for layout in ("compact", "padded"):
        halo = (5, 5, 0 if layout == "compact" else 5)
        grid, f, _, _ = scheme_inputs(SCHEME_CHECK_N, torch.float64, halo, 1,
                                      56)
        G = stitch(K.build_sharded_fused_advection(grid, s, mesh)(
            arch.scatter(f, grid.H)), MESH_SHAPE)
        assert torch.equal(G, K.fused_advection_tendency(grid, s, f)), \
            ("sharded WENO(9) tendency", layout)
        print(f"  sharded tendency WENO(9) {layout} {SCHEME_CHECK_N} on 2x2: "
              f"equal to the serial kernel bit for bit")
    names = SW_NAMES + ("c",)
    sgrid, sf, hB, _ = sw_scheme_inputs(128, torch.float64, 6, ("c",), 57)
    stage = K.build_sharded_fused_sw_update(sgrid, s, 9.81, 0.3, hB, names,
                                            mesh)
    G, new = stage(arch.scatter(sf, sgrid.H), None, 2e-5, -1e-5)
    Gs, news = K.fused_sw_update(sgrid, s, 9.81, 0.3, hB, names, sf, None,
                                 2e-5, -1e-5)
    ints = sgrid.interior_slices
    same = all(torch.equal(stitch([b[c] for b in new], MESH_SHAPE, sgrid.H),
                           news[c][ints]) for c in names)
    for k, (i, j) in enumerate((i, j) for i in range(2) for j in range(2)):
        same = same and torch.equal(
            G[k], Gs[:, i * 64:(i + 1) * 64, j * 64:(j + 1) * 64])
    assert same, "sharded WENO(9) shallow-water stage"
    print("  sharded shallow-water stage WENO(9) 128^2 on 2x2: equal to the "
          "serial kernel bit for bit")
    torch.cuda.synchronize()


def scheme_projection_checks(card):
    """#2 (the divergence), #3 (the correction) and #4 (the periodic fill)
    against their plain versions in the WENO(9) flagship's layout, H = (6,
    6, 0): float64 at SCHEME_CHECK_N (bound 1e-12 relative to max|plain|)
    and float32 at 256³ (the path's shapes: 1e-5), the fill exact in both,
    as phase 3 holds them at H = (4, 4, 0); with the kernels' times at
    256³."""
    from oceananigans_tpu_torch import kernels as K
    for N, dtype, bound in ((SCHEME_CHECK_N, torch.float64, 1e-12),
                            ((256, 256, 256), torch.float32, 1e-5)):
        grid, u, v, w, p, _ = kernel_inputs(N, dtype, 63, halo=(6, 6, 0))
        _, rel_div = max_err(K.fused_divergence(grid, u, v, w, 3.0),
                             K.fused_divergence_plain(grid, u, v, w, 3.0))
        _, rel_cor = max_err(list(K.fused_correct(grid, p, u, v, w, 0.2)),
                             list(K.fused_correct_plain(grid, p, u, v, w,
                                                        0.2)))
        a = torch.randn(grid.padded_shape, dtype=dtype, device="cuda")
        b = a.clone()
        K.periodic_halo_fill(grid, [a])
        K.periodic_halo_fill_plain(grid, [b])
        err_fill = (a - b).abs().max().item()
        print(f"  H = (6, 6, 0), {N} {str(dtype)[6:]}: fused_divergence rel "
              f"{rel_div:.3e}, fused_correct rel {rel_cor:.3e} (bound "
              f"{bound:g}), periodic_halo_fill max abs {err_fill:.3e} "
              f"(bound 0)")
        assert rel_div <= bound, ("fused_divergence at H = 6", N, rel_div)
        assert rel_cor <= bound, ("fused_correct at H = 6", N, rel_cor)
        assert err_fill == 0.0, ("periodic_halo_fill at H = 6", N, err_fill)
        if dtype == torch.float32:
            ms = [cuda_ms(lambda: K.fused_divergence(grid, u, v, w, 3.0)),
                  cuda_ms(lambda: K.fused_correct(grid, p, u, v, w, 0.2)),
                  device_ms(lambda: K.periodic_halo_fill(grid, [u, v, w,
                                                                p]))]
            print(f"  time at {grid.padded_shape}: fused_divergence "
                  f"{ms[0]:.4f} ms, fused_correct {ms[1]:.4f} ms, "
                  f"periodic_halo_fill of u, v, w, p {ms[2]:.4f} ms (behind "
                  f"a busy card) [{card}]")
        del grid, u, v, w, p, a, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def scheme_plans_report():
    """For each reach (buffer K = 1..6, at float32 and float64, with and
    without tracers): the tile launch_plan picks, its shared memory and the
    blocks an SM holds (#1 corrected and #6 padded), and #8's at 16384²."""
    import ctypes
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.kernels import build
    from oceananigans_tpu_torch.kernels import fused_advection as fa
    from oceananigans_tpu_torch.kernels import fused_shallow_water as fsw
    lib = build.library()
    codes = {torch.float32: 0, torch.float64: 1}
    for Kb in range(1, 7):
        scheme = ot.WENO(2 * Kb - 1) if Kb > 1 else ot.Centered(2)
        for dt in (torch.float32, torch.float64):
            grid = ot.RectilinearGrid(size=(256, 256, 256),
                                      extent=(1.0, 1.0, 1.0),
                                      halo=(Kb + 1, Kb + 1, 0), dtype=dt,
                                      device="cuda")
            for nc in (3, 15):
                plan = fa.launch_plan(grid, scheme, dt, nc)
                smem = plan["launches"][0][2]
                per = []
                for kind in (1, 3):
                    per_sm = ctypes.c_int(0)
                    build.check(lib.oc_advection_blocks_per_sm(
                        *fa.scheme_code(scheme), codes[dt], codes[dt], kind,
                        int(nc > 3), *plan["tile"], plan["threads"], smem,
                        ctypes.byref(per_sm)), lib)
                    per.append(per_sm.value)
                print(f"  reach {Kb} ({scheme_label(scheme)}) {str(dt)[6:]} "
                      f"{nc} components: tile {plan['tile']}, {smem} B "
                      f"shared, blocks per SM #1 {per[0]}, #6 padded "
                      f"{per[1]}")
        grid = ot.RectilinearGrid(size=(SCHEME_SW_N, SCHEME_SW_N),
                                  extent=(1.0, 1.0), halo=(Kb + 1, Kb + 1, 0),
                                  topology=SW_TOPOLOGY, dtype=torch.float32,
                                  device="cuda")
        plan = fsw.launch_plan(grid, scheme, torch.float32, 3)
        per_sm = ctypes.c_int(0)
        build.check(lib.oc_fused_sw_update_blocks_per_sm(
            *fa.scheme_code(scheme), 0, 0, *plan["tile"], plan["threads"],
            plan["smem"], ctypes.byref(per_sm)), lib)
        print(f"  reach {Kb} #8 {SCHEME_SW_N}^2 float32: tile {plan['tile']}, "
              f"{plan['smem']} B shared, {per_sm.value} blocks per SM")


def scheme_times(card):
    """CUDA-event medians of each kernel beside its plain version at the
    paths' shapes, float32: #1's corrected G⁻ variant over u, v, w at 256³
    (H = K + 1, the flagship's layout) and #6 padded over u, v, w, b at
    256³ (H = K, z halos filled, the convection path's layout) for
    SCHEME_TIMED, and #8's G⁻ variant at SCHEME_SW_N² (H = 6, f = 0, no
    tracer) with WENO(9); each with its bound (bytes and operations,
    flagship_bounds, convection_bounds, sw_bounds) and its max difference
    from the plain version on the timed inputs (G within 2e-5 of each
    component's term scale, #8 within 1e-5 of each tensor's max|plain|).
    Returns {row name: dict(max_abs_err, ms, plain_ms, bound)}."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    schemes = all_schemes()
    out = {}
    N = (256, 256, 256)
    for label in SCHEME_TIMED:
        scheme = schemes[label]
        Kb = scheme.required_halo
        key = label.lower().replace("(", "").replace(")", "")
        key = key.replace("upwindbiased", "upwind")
        grid, f, p, Gm = scheme_inputs(N, torch.float32, (Kb + 1, Kb + 1, 0),
                                       0, 60)
        args = (grid, scheme, f[0], f[1], f[2], Gm, 0.1, -0.05, p, 0.07)
        ms = cuda_ms(lambda: K.fused_advection_update(*args))
        plain_ms = cuda_ms(lambda: K.fused_advection_update_plain(*args),
                           reps=3, warmup=1)
        Gk, _ = K.fused_advection_update(*args)
        Gp, _ = K.fused_advection_update_plain(*args)
        err, rel = scaled_err(Gk, Gp, update_scales(grid, scheme, f, p, 0.07))
        assert rel <= 2e-5, ("#1 at 256^3", label, rel)
        b = flagship_bounds(N, grid.H, 4, scheme)["fused_advection_update"]
        out[f"fused_advection_update_{key}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)
        print(f"  time fused_advection_update {label} (corrected, G⁻) at "
              f"{grid.padded_shape}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), G max abs "
              f"{err:.3e} ({rel:.2e} of the term scale) [{card}]")
        del grid, f, p, Gm, Gk, Gp, args
        torch.cuda.empty_cache()
        grid, f, _, _ = scheme_inputs(N, torch.float32, (Kb,) * 3, 1, 61)
        ms = cuda_ms(lambda: K.fused_advection_tendency(grid, scheme, f))
        plain_ms = cuda_ms(
            lambda: K.fused_advection_tendency_plain(grid, scheme, f),
            reps=3, warmup=1)
        Gk = list(K.fused_advection_tendency(grid, scheme, f))
        Gp = list(K.fused_advection_tendency_plain(grid, scheme, f))
        err, rel = scaled_err(Gk, Gp, term_scales(grid, scheme, f))
        assert rel <= 2e-5, ("#6 at 256^3", label, rel)
        b = convection_bounds(N, grid.H, 4, 1, scheme)[
            "fused_advection_tendency"]
        out[f"fused_advection_tendency_{key}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)
        print(f"  time fused_advection_tendency padded {label} (u, v, w, b) "
              f"at {grid.padded_shape}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), max abs "
              f"{err:.3e} ({rel:.2e} of the term scale) [{card}]")
        del grid, f, Gk, Gp
        torch.cuda.empty_cache()
    scheme = schemes["WENO(9)"]
    grid, sf, hB, sGm = sw_scheme_inputs(SCHEME_SW_N, torch.float32, 6, (),
                                         62)
    args = (grid, scheme, 9.81, 0.0, hB, SW_NAMES, sf, sGm, 2e-5, -1e-5)
    ms = cuda_ms(lambda: K.fused_sw_update(*args))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plain_ms = cuda_ms(lambda: K.fused_sw_update_plain(*args), reps=3,
                       warmup=1)
    plain_peak = torch.cuda.max_memory_allocated() - base
    Gk, nk = K.fused_sw_update(*args)
    Gp, np_ = K.fused_sw_update_plain(*args)
    ints = grid.interior_slices
    err, rel = worst_rel(list(Gk) + [nk[c][ints] for c in SW_NAMES],
                         list(Gp) + [np_[c][ints] for c in SW_NAMES])
    assert rel <= 1e-5, ("#8 WENO(9) at the path's shape", rel)
    b = sw_bounds(SCHEME_SW_N, grid.H, 4, 0, scheme)["fused_sw_update"]
    out["fused_sw_update_weno9"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound=b)
    print(f"  time fused_sw_update WENO(9) (G⁻) at {grid.padded_shape}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (plain peak "
          f"{plain_peak / 2 ** 30:.2f} GiB above its inputs), bound "
          f"{b[0]:.4f} ms ({b[1]}), max abs {err:.3e}, rel {rel:.2e} "
          f"[{card}]")
    del grid, sf, hB, sGm, Gk, nk, Gp, np_, args
    torch.cuda.empty_cache()
    return out


def schemes_phase(card):
    """Phase 25: every scheme of the advection kernels. The kernel checks
    of the 17 schemes, bf16 smoothness at WENO(7) and WENO(9), #7 and #9
    with WENO(9) on the 2x2 mesh, #2, #3 and #4 in the WENO(9) flagship's
    layout (H = 6), the launch plans by reach, the times and
    bounds at the paths' shapes, then the two paths, each with its counters
    reset just before its model is built and read just after its timed
    steps: the 256³ WENO(9) flagship (z-compact, #1 with the deferred
    correction, 3 warm-up and 20 timed steps) and the 256³ UpwindBiased(5)
    convection row (padded, #6 and the bounded-z fill, 13 steps, Σb
    conserved). Returns the rows' measurements and each path's
    launches."""
    import oceananigans_tpu_torch as ot
    t0 = time.perf_counter()
    print("every scheme, kernels against plain versions (float64 at the "
          "tile-edge bound, float32 at the term-scale bound):")
    scheme_kernel_checks()
    print("bfloat16 smoothness at WENO(7) and WENO(9):")
    scheme_bf16_checks()
    print("WENO(9) on the 2x2 mesh of the card:")
    scheme_mesh_checks()
    print("the divergence, the correction and the fill in the WENO(9) "
          "flagship's layout:")
    scheme_projection_checks(card)
    print("launch plans by reach:")
    scheme_plans_report()
    print("times at the paths' shapes:")
    out = scheme_times(card)
    torch.cuda.empty_cache()
    print("the 256^3 WENO(9) flagship:")
    flagship, _ = flagship_path_phase(card, scheme=ot.WENO(order=9))
    assert flagship["fused_advection_update_weno9"] > 0, \
        "the WENO(9) flagship never launched #1's WENO(9) variant"
    torch.cuda.empty_cache()
    print("the 256^3 UpwindBiased(5) convection row:")
    convection, step_ms, model, _ = convection_path_phase(
        card, scheme=ot.UpwindBiased(order=5))
    assert convection["fused_advection_tendency_upwind5"] > 0, \
        "the UpwindBiased(5) row never launched #6's UpwindBiased(5) variant"
    busy_share("convection path UpwindBiased(5)", model, 1e-3, 3, step_ms,
               card)
    print(f"UpwindBiased(5) convection fill launches on the path: "
          f"{convection['fill_halos']} ({convection['fill_halos_3d']} on 3-D "
          f"fields, {convection['fill_halos_2d']} on 2-D surfaces); WENO(9) "
          f"flagship: {flagship['fill_halos']} ({flagship['fill_halos_3d']} "
          f"3-D, {flagship['fill_halos_2d']} 2-D)")
    del model
    torch.cuda.empty_cache()
    print(f"phase 25 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    return out, flagship, convection


# -- every configuration of #10 (phase 26) ----------------------------------------

VI_CHECK_N = (16, 12, 8)
# the stretched row's levels: the tripolar row's stretching (a scale of a
# quarter of the depth) at the ocean row's depth
STRETCHED_SCALE = 450.0
# JAX's stretched-z test grid (tests/test_fused_vector_invariant.py:109-120)
JAX_TEST_Z = tuple(-500.0 * np.linspace(1, 0, 9) ** 1.5)


def stretched_z(nz):
    import oceananigans_tpu_torch as ot
    return ot.ExponentialDiscretization(nz, -1800.0, 0.0,
                                        scale=STRETCHED_SCALE)


def vi_coverage_cases():
    """(label, grid, vi, tracer scheme, tracer names, coriolis, with ph) of
    the float64 coverage checks at 16x12x8: a stretched z (JAX's test grid
    and an ExponentialDiscretization) and a stretched y (a RectilinearGrid,
    and a lat-lon grid with a latitude array); WENOVectorInvariant(order=3,
    7, 9, 11), CROSS_AND_SELF, DEFAULT_STENCIL, an UpwindBiased and a
    Centered VI and mixed vertical, divergence and kinetic-energy schemes;
    the tracer schemes Centered(4), Centered(12), UpwindBiased(1, 3), WENO(7,
    9, 11) and a per-axis FluxFormAdvection, 9, 17 and 40 tracers (two
    launches); each Coriolis. Every WENO has float64 smoothness."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.advection.schemes import FluxFormAdvection
    f64 = torch.float64
    sd = dict(smoothness_dtype=f64)
    hsc = ot.HydrostaticSphericalCoriolis
    N = VI_CHECK_N

    def ll(lon=(0.0, 60.0), latitude=(15, 75), z=(-1800.0, 0.0)):
        return ot.LatitudeLongitudeGrid(size=N, longitude=lon,
                                        latitude=latitude, z=z,
                                        halo=(7, 7, 7), dtype=f64,
                                        device="cuda")

    def rect(topo=("bounded", "bounded", "bounded"), y=(0.0, 2.4e5),
             z=(-1800.0, 0.0)):
        return ot.RectilinearGrid(size=N, x=(0.0, 4e5), y=y, z=z,
                                  halo=(7, 7, 7), topology=topo, dtype=f64,
                                  device="cuda")

    lat = tuple(15 + 60 * np.linspace(0, 1, N[1] + 1) ** 1.3)
    yf = tuple(2.4e5 * np.linspace(0, 1, N[1] + 1) ** 1.4)
    grids = {"stretched z (JAX's test grid)": ll(z=JAX_TEST_Z),
             "stretched z (ExponentialDiscretization)":
                 ll(z=stretched_z(N[2])),
             "stretched latitude": ll(latitude=lat),
             "RectilinearGrid stretched y, periodic x":
                 rect(("periodic", "bounded", "bounded"), y=yf),
             "RectilinearGrid stretched y and z": rect(y=yf, z=JAX_TEST_Z)}
    vis = {
        "WENOVectorInvariant(order=3)": ot.WENOVectorInvariant(order=3, **sd),
        "WENOVectorInvariant()": ot.WENOVectorInvariant(**sd),
        "WENOVectorInvariant(order=7)": ot.WENOVectorInvariant(order=7, **sd),
        "WENOVectorInvariant(order=9)": ot.WENOVectorInvariant(order=9, **sd),
        "WENOVectorInvariant(order=11)":
            ot.WENOVectorInvariant(order=11, **sd),
        "cross_and_self": ot.WENOVectorInvariant(upwinding="cross_and_self",
                                                 **sd),
        "DEFAULT_STENCIL": ot.WENOVectorInvariant(vorticity_stencil="default",
                                                  **sd),
        "UpwindBiased VI": ot.VectorInvariant(
            vorticity_scheme=ot.UpwindBiased(5),
            vertical_advection_scheme=ot.UpwindBiased(3)),
        "Centered VI": ot.VectorInvariant(
            vorticity_scheme=ot.Centered(4),
            vertical_advection_scheme=ot.Centered(4)),
        "mixed (WENO(7) ζ, WENO(3) vertical, UpwindBiased(5) divergence, "
        "WENO(9) Bernoulli)": ot.VectorInvariant(
            vorticity_scheme=ot.WENO(7, **sd),
            vertical_advection_scheme=ot.WENO(3, **sd),
            divergence_scheme=ot.UpwindBiased(5),
            kinetic_energy_gradient_scheme=ot.WENO(9, **sd)),
        "VectorInvariant(), WENO(5) Bernoulli only": ot.VectorInvariant(
            kinetic_energy_gradient_scheme=ot.WENO(5, **sd)),
    }
    tracer_schemes = {
        "Centered(4)": ot.Centered(4), "Centered(12)": ot.Centered(12),
        "UpwindBiased(1)": ot.UpwindBiased(1),
        "UpwindBiased(3)": ot.UpwindBiased(3), "WENO(7)": ot.WENO(7, **sd),
        "WENO(9)": ot.WENO(9, **sd), "WENO(11)": ot.WENO(11, **sd),
        "FluxFormAdvection(WENO(5), UpwindBiased(3), Centered(4))":
            FluxFormAdvection(ot.WENO(5, **sd), ot.UpwindBiased(3),
                                 ot.Centered(4))}
    coriolis = {"no Coriolis": lambda g: None,
                "FPlane": lambda g: ot.FPlane(f=1e-4),
                "BetaPlane": lambda g: ot.BetaPlane(f0=1e-4, beta=1e-11),
                "ConstantCartesianCoriolis": lambda g:
                    ot.ConstantCartesianCoriolis(fx=1e-5, fy=2e-5, fz=1e-4),
                "NonTraditionalBetaPlane": lambda g:
                    ot.NonTraditionalBetaPlane(fz0=1e-4, beta=1e-11,
                                               fy0=5e-5, gamma=-1e-11),
                "spherical energy-conserving": lambda g: hsc(),
                "spherical enstrophy-conserving": lambda g:
                    hsc(scheme="enstrophy_conserving")}
    cases = []
    for gname, grid in grids.items():
        planar = isinstance(grid, ot.RectilinearGrid)
        cor = ot.FPlane(f=1e-4) if planar else hsc()
        for vname, vi in vis.items():
            cases.append((f"{gname}, {vname}, WENO(5) tracer", grid, vi,
                          ot.WENO(5, **sd), ("c",), cor, True))
        for tname, ts in tracer_schemes.items():
            cases.append((f"{gname}, WENOVectorInvariant(order=5), {tname} "
                          f"tracers", grid,
                          ot.WENOVectorInvariant(order=5, **sd), ts,
                          ("a", "b"), cor, False))
        for cname, make in coriolis.items():
            if planar and cname.startswith("spherical"):
                continue
            cases.append((f"{gname}, VectorInvariant(), {cname}", grid,
                          ot.VectorInvariant(), ot.Centered(2), ("c",),
                          make(grid), True))
            cases.append((f"{gname}, WENOVectorInvariant(), {cname}", grid,
                          ot.WENOVectorInvariant(**sd), ot.WENO(5, **sd),
                          ("c",), make(grid), False))
    grid = grids["stretched z (JAX's test grid)"]
    for ntr in (9, 17, 40):
        cases.append((f"stretched z, WENOVectorInvariant(), WENO(7), {ntr} "
                      f"tracers", grid, ot.WENOVectorInvariant(**sd),
                      ot.WENO(7, **sd), tuple(f"c{i}" for i in range(ntr)),
                      hsc(), True))
    return cases


def vi_coverage_checks():
    """#10 against its plain version for every case of
    ``vi_coverage_cases`` in float64: 1e-12 relative to each output's own
    max|plain| (FMA contraction and another association order)."""
    from oceananigans_tpu_torch import kernels as K
    worst = 0.0
    for label, grid, vi, ts, names, coriolis, with_ph in vi_coverage_cases():
        grid, f = hydro_kernel_inputs(None, seed=8, grid=grid, tracers=names)
        args = (grid, vi, ts, names, coriolis, f["u"], f["v"], f["w"],
                {n: f[n] for n in names}, f["ph"] if with_ph else None)
        Gk = K.fused_vi_tendency(*args)
        Gp = K.fused_vi_tendency_plain(*args)
        err, rel = worst_rel([Gk[0], Gk[1]] + [Gk[2][n] for n in names],
                             [Gp[0], Gp[1]] + [Gp[2][n] for n in names])
        print(f"  fused_vi_tendency {VI_CHECK_N} float64 {label}: max abs "
              f"{err:.3e}, rel {rel:.3e}")
        assert rel <= 1e-12, ("fused_vi_tendency coverage", label, rel)
        worst = max(worst, rel)
    torch.cuda.synchronize()
    return worst


def vi_bf16_checks(md=False):
    """#10 with bfloat16 smoothness on float32 fields against its plain
    version, as phase 19 holds #1 (``bf16_check``: 2e-5 of each output's
    max|plain|, at most a tenth of the bf16-vs-float32 difference) at
    64x48x16 on the hydro_row's lat-lon grid, regular and stretched z,
    WENOVectorInvariant() and WENO(5) T and S with pₕ′; ``md``: with the
    multi-dimensional stencil (its family's bf16 variant, H = 8)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    worst = 0.0
    for zlabel, z in (("regular z", (-1800.0, 0.0)),
                      ("stretched z", stretched_z(16))):
        h = 8 if md else 7
        grid = ot.LatitudeLongitudeGrid(size=(64, 48, 16), longitude=(0, 60),
                                        latitude=(15, 75), z=z,
                                        halo=(h, h, h), dtype=torch.float32,
                                        device="cuda")
        if md:
            zlabel += ", multi-dimensional stencil"
        names = ("T", "S")
        grid, f = hydro_kernel_inputs(None, seed=9, grid=grid, tracers=names)
        f = {k: v.to(torch.float32) for k, v in f.items()}
        hsc = ot.HydrostaticSphericalCoriolis()

        def run(fn, sdt):
            vi = ot.WENOVectorInvariant(smoothness_dtype=sdt,
                                        multi_dimensional_stencil=md)
            G = fn(grid, vi, ot.WENO(5, smoothness_dtype=sdt), names, hsc,
                   f["u"], f["v"], f["w"], {n: f[n] for n in names}, f["ph"])
            return [G[0], G[1]] + [G[2][n] for n in names]

        Gk = run(K.fused_vi_tendency, torch.bfloat16)
        Gp = run(K.fused_vi_tendency_plain, torch.bfloat16)
        G32 = run(K.fused_vi_tendency_plain, torch.float32)
        worst = max(worst, bf16_check(
            f"fused_vi_tendency 64x48x16 float32 bf16 smoothness, {zlabel}",
            Gk, Gp, G32, [g.abs().max().item() for g in Gp], 2e-5,
            range(4)))
    torch.cuda.synchronize()
    return worst


def stretched_row_state(model):
    """The inputs #10 takes in ``model``'s next step: its fields filled, w
    from continuity and pₕ′."""
    fields = model._fill_all(dict(model.state["fields"]))
    w = model._w_from_continuity(fields["u"], fields["v"])
    ph = model._hydrostatic_pressure(fields)
    names = model.tracer_names
    return (model.grid, model.momentum_advection, model.tracer_advection,
            names, model.coriolis, fields["u"], fields["v"], w,
            {n: fields[n] for n in names}, ph)


def vi_row_kernel(label, args):
    """#10 against its plain version on a row's own float32 state (bound 2e-5
    of each output's max|plain|, phase 9's), the CUDA-event times of kernel
    and plain version, and the bound: a measured row."""
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    grid, vi, ts, names, cor = args[:5]
    Gk = K.fused_vi_tendency(*args)
    Gp = K.fused_vi_tendency_plain(*args)
    err, rel = worst_rel([Gk[0], Gk[1]] + [Gk[2][n] for n in names],
                         [Gp[0], Gp[1]] + [Gp[2][n] for n in names])
    print(f"  fused_vi_tendency {label} float32: max abs {err:.3e}, rel "
          f"{rel:.3e} (bound 2e-5)")
    assert rel <= 2e-5, ("fused_vi_tendency", label, rel)
    del Gk, Gp
    ms = cuda_ms(lambda: K.fused_vi_tendency(*args))
    plain_ms = cuda_ms(lambda: K.fused_vi_tendency_plain(*args), reps=5)
    cfg = fvi.vi_config(grid, vi, ts, len(names), cor)
    b = vi_bound(grid, cfg, len(names), args[-1] is not None)
    print(f"  time fused_vi_tendency {label} at {grid.padded_shape}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]}; {vi_flop(cfg, len(names), args[-1] is not None)} "
          f"operations a cell), variant {fvi.variant_name(cfg)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b)


def stretched_ocean_model(fused_tendencies="auto"):
    """The stretched CATKE ocean row: ``ocean_model`` at 512x256x32 float32
    with a flat bottom and 32 levels of ExponentialDiscretization(32, -1800,
    0, scale=450)."""
    return ocean_model(HYDRO_N, torch.float32, "cuda",
                       fused_tendencies=fused_tendencies,
                       z=stretched_z(HYDRO_N[2]))


def stretched_steps(label, model, card, warmup=3, timed=10):
    """Counters reset just before ``warmup`` + ``timed`` steps of Δt = 120
    s and read just after; finite fields; T conserved over the cells
    (1e-6); step median, min and max, peak memory, the phase shares (CUDA
    events, 3 steps) and the busy share (3 steps). Returns (launches,
    plain calls on CUDA, the counted steps, step median ms)."""
    from oceananigans_tpu_torch import kernels as K
    dt = OCEAN_DT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    for _ in range(warmup):
        model.time_step(dt)
    torch.cuda.synchronize()
    T0, T0abs = fluid_volume_sum(model, "T")
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain_cuda = K.counters()
    steps = model.iteration
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain_cuda.items() if v} }")
    for name in model.prognostic_names + ("w",):
        a = model.field(name).interior
        assert torch.isfinite(a).all().item(), (label, f"{name} is not finite")
    T1, _ = fluid_volume_sum(model, "T")
    drift = abs(T1 - T0) / T0abs
    print(f"{label}: |Σ(T·V) − Σ(T₀·V)|/Σ|T₀·V| over the {timed} timed steps "
          f"{drift:.3e} (bound 1e-6)")
    assert drift < 1e-6, (label, "T drift", drift)
    step_ms = statistics.median(times) * 1e3
    n = HYDRO_N[0] * HYDRO_N[1] * HYDRO_N[2]
    print(f"{label}: step median {step_ms:.3f} ms over {timed} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{n / (step_ms / 1e3):.4e} cell-updates/s; peak device memory "
          f"(steps) {peak / 2 ** 30:.2f} GiB [{card}]")
    ocean_phase_shares(model, dt, 3, card, label)
    busy_share(label, model, dt, 3, step_ms, card)
    return launches, plain_cuda, steps, step_ms


def stretched_ocean_phase(card):
    """The 512x256x32 stretched-z CATKE ocean row under "auto": #10 against
    its plain version on the row's state after one step, timed; then the
    counters over 13 steps (#10 once a step in its k5_z variant, no plain
    tendency on CUDA tensors, no plain fill), and the same row with
    fused_tendencies=False for the plain route's step in the same call."""
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    label = "stretched CATKE ocean row"
    model = stretched_ocean_model()
    assert model.uses_kernel, "the stretched ocean row does not take #10"
    assert model.grid.stretched_axes == (2,), model.grid.stretched_axes
    dz = np.asarray(model.grid.dz(("c", "c", "c")).cpu()).reshape(-1)
    Hz, Nz = model.grid.H[2], model.grid.N[2]
    print(f"{label}: Δz from {dz[Hz + Nz - 1]:.2f} m at the top to "
          f"{dz[Hz]:.2f} m at the bottom ({HYDRO_N}, halo {model.grid.H}) "
          f"[{card}]")
    vi_plan_report(f"#10 {label} float32", model.grid,
                   model.momentum_advection, model.tracer_advection,
                   len(model.tracer_names), model.coriolis)
    model.time_step(OCEAN_DT)
    measured = vi_row_kernel(f"{label} (after one step: T, S, e, pₕ′)",
                             stretched_row_state(model))
    del model
    torch.cuda.empty_cache()
    model = stretched_ocean_model()
    launches, plain_cuda, steps, step_ms = stretched_steps(f"{label}, #10",
                                                           model, card)
    cfg = fvi.vi_config(model.grid, model.momentum_advection,
                        model.tracer_advection, len(model.tracer_names),
                        model.coriolis)
    variant = "fused_vi_tendency_" + fvi.variant_name(cfg)
    assert variant == "fused_vi_tendency_k5_z", variant
    assert launches["fused_vi_tendency"] == steps, \
        (label, launches["fused_vi_tendency"], steps)
    assert launches[variant] == steps, (label, variant, launches[variant])
    assert launches["fill_halos"] > 0, (label, "no fill launch")
    for name, count in plain_cuda.items():
        assert count == 0, f"plain {name} ran on CUDA tensors ({label})"
    del model
    torch.cuda.empty_cache()
    plain_model = stretched_ocean_model(fused_tendencies=False)
    assert not plain_model.uses_kernel
    plain_launches, plain_calls, plain_steps, plain_step_ms = \
        stretched_steps(f"{label}, plain tendency (fused_tendencies=False)",
                        plain_model, card)
    assert plain_launches["fused_vi_tendency"] == 0
    assert plain_calls["fused_vi_tendency_plain"] == plain_steps
    print(f"{label}: step {step_ms:.3f} ms on #10 against {plain_step_ms:.3f} "
          f"ms on the plain tendency ({plain_step_ms / step_ms:.2f}x) "
          f"[{card}]")
    del plain_model
    torch.cuda.empty_cache()
    return measured, launches, step_ms, plain_step_ms


def high_order_vi_phase(card):
    """#10 alone on ``hydro_model``'s 512x256x32 float32 lat-lon grid with
    WENOVectorInvariant(order=9) and WENO(9) T: reach 5 in every direction.
    Checked against its plain version on the state after set() and timed."""
    import oceananigans_tpu_torch as ot
    grid = ot.LatitudeLongitudeGrid(size=HYDRO_N, longitude=(0, 60),
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    dtype=torch.float32, device="cuda")
    model = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.WENOVectorInvariant(order=9),
        tracer_advection=ot.WENO(9),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        free_surface=ot.SplitExplicitFreeSurface(substeps=30),
        tracers=("T",))
    rng = np.random.default_rng(0)
    model.set(u=0.05 * rng.standard_normal(HYDRO_N).astype(np.float32),
              T=lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi)
    assert model.uses_kernel
    vi_plan_report("#10 WENOVectorInvariant(order=9), WENO(9) T float32",
                   model.grid, model.momentum_advection,
                   model.tracer_advection, 1, model.coriolis)
    fields = model._fill_all(dict(model.state["fields"]))
    w = model._w_from_continuity(fields["u"], fields["v"])
    args = (model.grid, model.momentum_advection, model.tracer_advection,
            ("T",), model.coriolis, fields["u"], fields["v"], w,
            {"T": fields["T"]}, None)
    measured = vi_row_kernel("WENOVectorInvariant(order=9), WENO(9) T "
                             f"{HYDRO_N} (after set())", args)
    del model, fields, w, args
    torch.cuda.empty_cache()
    return measured


def vi_coverage_phase(card):
    """Phase 26: every configuration of #10. The float64 coverage checks,
    bf16 smoothness, the tile edges at the new reaches (WENO(11) and a
    stretched y and z, 3 and 40 tracers), the 512x256x32 stretched CATKE
    ocean row on #10 and on the plain tendency, and #10 with WENO(9)
    everywhere on the hydro_row's grid. Returns ({row: measured}, the
    stretched row's launches)."""
    import oceananigans_tpu_torch as ot
    t0 = time.perf_counter()
    f64 = torch.float64
    print("every configuration of #10 against its plain version (float64, "
          "1e-12):")
    worst = vi_coverage_checks()
    print(f"  worst rel over the coverage cases {worst:.3e}")
    print("bf16 smoothness in #10:")
    vi_bf16_checks()
    print("#10 at the tile edges at the new reaches:")
    vi_tile_edge_checks(
        {"WENOVectorInvariant(order=11), WENO(11)": (
            lambda: ot.WENOVectorInvariant(order=11, smoothness_dtype=f64),
            lambda: ot.WENO(11, smoothness_dtype=f64)),
         "cross_and_self, UpwindBiased(5)": (
            lambda: ot.WENOVectorInvariant(upwinding="cross_and_self",
                                           smoothness_dtype=f64),
            lambda: ot.UpwindBiased(5))},
        tracer_counts=(3, 40),
        y=lambda n: tuple(2.4e5 * np.linspace(0, 1, n + 1) ** 1.4),
        z=lambda n: tuple(-1800.0 * np.linspace(1, 0, n + 1) ** 1.5),
        label="WENO(11) and cross_and_self on a stretched y and z")
    out = {}
    print("the 512x256x32 stretched-z CATKE ocean row:")
    out["fused_vi_tendency_k5_z"], launches, step_ms, plain_ms = \
        stretched_ocean_phase(card)
    print("#10 with WENO(9) everywhere at 512x256x32:")
    out["fused_vi_tendency_weno9"] = high_order_vi_phase(card)
    print(f"phase 26 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    return out, launches


# -- every topology and one stretched axis (phase 27) -----------------------------

P_, B_, F_ = "periodic", "bounded", "flat"
TOPO_A_N = 256                 # row A: triply periodic n³, extent 2π
TOPO_B_N = 8192                # row B: two-dimensional turbulence n², 2π
TOPO_C_N = (2048, 512)         # row C: the tilted bottom boundary layer
TOPO_STEPS = (3, 10)           # warm-up and timed steps of each row
Z_MODE_SCHEMES = ("WENO(5)", "WENO(9)", "UpwindBiased(5)", "Centered(2)")
# #6 in float64 on each z mode: the phase's shapes (32x32x1 and 32³) and
# interiors no tile divides (the flat z's 32x32x1 tile, the periodic z's
# 8x8x8 float64 tile), the latter with 1 and 37 tracers
Z_MODE_CHECKS = {"flat": ((P_, P_, F_), ((32, 32, 1), (45, 37, 1))),
                 "periodic": ((P_, P_, P_), ((32, 32, 32), (19, 13, 30)))}
# the fill in float64: every location under every condition on the bounded
# sides, on these topologies
FILL_TOPOLOGIES = ((P_, P_, P_), (P_, F_, P_), (B_, B_, B_), (B_, P_, B_),
                   (P_, F_, B_), (F_, F_, B_))


def topo_scheme(name, smoothness=torch.float64):
    import oceananigans_tpu_torch as ot
    return {"WENO(5)": lambda: ot.WENO(5, smoothness_dtype=smoothness),
            "WENO(9)": lambda: ot.WENO(9, smoothness_dtype=smoothness),
            "UpwindBiased(5)": lambda: ot.UpwindBiased(5),
            "Centered(2)": lambda: ot.Centered(2)}[name]()


def topo_grid(topology, n, halo, dtype, device="cuda", extent=(1.0, 2.0, 0.5),
              **coords):
    """A RectilinearGrid from the full (x, y, z) size and halo (the flat
    axes' entries dropped), over ``extent`` or the given coordinates."""
    import oceananigans_tpu_torch as ot
    keep = [ax for ax in range(3) if topology[ax] != F_]
    kw = dict(size=tuple(n[ax] for ax in keep),
              halo=tuple(halo[ax] for ax in keep), topology=topology,
              dtype=dtype, device=device)
    if not coords:
        kw["extent"] = tuple(extent[ax] for ax in keep)
    return ot.RectilinearGrid(**kw, **coords)


def wrapped_fields(grid, n, dtype, seed, scale=0.1):
    """``n`` seeded fields on the grid, their periodic halos (z included)
    filled by the fill kernel."""
    from oceananigans_tpu_torch import kernels as K
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = [scale * torch.randn(grid.padded_shape, generator=gen, dtype=dtype,
                             device="cuda") for _ in range(n)]
    K.fill_halos(grid, f)
    return f


def z_mode_kernel_checks():
    """#6 against its plain version in float64 on a flat z and a periodic
    z, the four schemes with a tracer (1e-12 relative to each component's
    max|plain|), and on interiors the tiles do not divide with 1 and 37
    tracers (two launches)."""
    from oceananigans_tpu_torch import kernels as K
    f64 = torch.float64
    worst = 0.0
    for zmode, (topology, shapes) in Z_MODE_CHECKS.items():
        for N in shapes:
            tracer_counts = (1,) if N[0] == 32 else (1, 37)
            line = 0.0
            for ntr in tracer_counts:
                for name in Z_MODE_SCHEMES:
                    s = topo_scheme(name)
                    r = s.required_halo
                    grid = topo_grid(topology, N, (r, r, 0 if zmode == "flat"
                                                   else r), f64)
                    f = wrapped_fields(grid, 3 + ntr, f64, seed=41 + ntr)
                    err, rel = worst_rel(
                        list(K.fused_advection_tendency(grid, s, f)),
                        list(K.fused_advection_tendency_plain(grid, s, f)))
                    assert rel <= 1e-12, ("#6", zmode, N, ntr, name, rel)
                    line = max(line, rel)
            worst = max(worst, line)
            print(f"  fused_advection_tendency {zmode} z {N} float64, "
                  f"{', '.join(Z_MODE_SCHEMES)}, {tracer_counts} tracers: "
                  f"worst rel {line:.3e} (bound 1e-12)")
    torch.cuda.synchronize()
    return worst


def topology_locs_bcs(topology, n):
    """``n`` (location, conditions): the four locations, each under four
    rotations of Flux, Open, Value and Gradient over the bounded sides
    (nonzero values), periodic conditions on the periodic sides."""
    from oceananigans_tpu_torch.boundary_conditions import (
        BoundaryCondition, FieldBoundaryConditions)
    from oceananigans_tpu_torch.boundary_conditions import \
        boundary_condition as bcm
    classes = (bcm.FLUX, bcm.OPEN, bcm.VALUE, bcm.GRADIENT)
    out = []
    for k in range(n):
        kw = {}
        for s, side in enumerate(FILL_SIDES):
            topo = topology[s // 2]
            if topo == B_:
                kw[side] = BoundaryCondition(classes[(s + k // 4) % 4],
                                             0.1 * (s + 1) * (-1) ** s)
            elif topo == P_:
                kw[side] = bcm.PeriodicBoundaryCondition()
        out.append((FILL_LOCS[k % 4], FieldBoundaryConditions(**kw)))
    return out


def topology_fill_checks():
    """The fill kernel against fill_halos_plain in float64, bit for bit, on
    each topology of FILL_TOPOLOGIES (a periodic z wraps in the launch that
    fills x and y; flat axes have no halo), 16 fields: every location under
    every condition on the bounded sides; and the wrap alone."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    for topology in FILL_TOPOLOGIES:
        grid = topo_grid(topology, tuple(1 if t == F_ else n for t, n in
                                         zip(topology, (37, 29, 23))),
                         (3, 2, 4), torch.float64)
        lbs = topology_locs_bcs(topology, 16)
        fields = [torch.randn(grid.padded_shape, generator=gen,
                              dtype=torch.float64, device="cuda")
                  for _ in lbs]
        fill_check(f"{'-'.join(topology)} {grid.N}, every combination", grid,
                   fields, lbs)
        fill_check(f"{'-'.join(topology)} {grid.N}, the wrap alone", grid,
                   fields[:4], None)


def topology_models(device, dtype=torch.float64):
    """The small models of phase 27's card-against-CPU check: each
    topology the model opens and a stretched x and z, WENO(5) with a tracer
    (float64 smoothness), u, v, w and c from a seeded generator."""
    import oceananigans_tpu_torch as ot
    sx = tuple(np.cumsum(np.r_[0.0, np.random.default_rng(1).uniform(
        0.5, 1.5, 12)]) / 12)
    sz = tuple(-1.0 + np.cumsum(np.r_[0.0, np.random.default_rng(2).uniform(
        0.5, 1.5, 12)]) / 12 * 1.0)
    configs = {
        "(P, P, P)": dict(topology=(P_, P_, P_), n=(16, 16, 16)),
        "(P, P, Flat)": dict(topology=(P_, P_, F_), n=(32, 32, 1)),
        "(P, Flat, P)": dict(topology=(P_, F_, P_), n=(24, 1, 16)),
        "(B, B, B)": dict(topology=(B_, B_, B_), n=(12, 10, 8)),
        "(B, P, B)": dict(topology=(B_, P_, B_), n=(12, 10, 8)),
        "(P, B, B)": dict(topology=(P_, B_, B_), n=(12, 10, 8)),
        "(P, Flat, B)": dict(topology=(P_, F_, B_), n=(24, 1, 16)),
        "(Flat, Flat, B)": dict(topology=(F_, F_, B_), n=(1, 1, 32)),
        "stretched x (B, P, B)": dict(topology=(B_, P_, B_), n=(12, 10, 8),
                                      x=sx, y=(0.0, 2.0), z=(-0.5, 0.0)),
        "stretched z (P, Flat, B)": dict(topology=(P_, F_, B_),
                                         n=(16, 1, 12), x=(0.0, 1.0), z=sz),
    }
    out = {}
    for label, c in configs.items():
        c = dict(c)
        topology, n = c.pop("topology"), c.pop("n")
        halo = tuple(0 if t == F_ else 3 for t in topology)
        grid = topo_grid(topology, n, halo, dtype, device, **c)
        m = ot.NonhydrostaticModel(grid, advection=ot.WENO(
            5, smoothness_dtype=dtype), tracers=("c",))
        rng = np.random.default_rng(0)
        m.set(**{k: 0.1 * rng.standard_normal(n) for k in ("u", "v", "w",
                                                          "c")})
        out[label] = m
    return out


def topology_model_checks():
    """Each small model on the card (float64; #6 where the JAX model takes
    its kernel, the fill kernel everywhere) over 3 steps against the same
    model on the CPU (the plain route): 1e-10 relative to each field's
    largest value, the velocity scale at least for u, v, w and p. No plain
    version runs on CUDA tensors; #6 launches exactly where its route is
    taken."""
    from oceananigans_tpu_torch import kernels as K
    K.reset_counters()
    card = topology_models("cuda")
    cpu = topology_models("cpu")
    worst = 0.0
    for label in card:
        a, b = card[label], cpu[label]
        K.reset_counters()
        for _ in range(3):
            a.time_step(1e-2)
            b.time_step(1e-2)
        launches, plain = K.counters()
        assert all(v == 0 for v in plain.values()), (label, plain)
        assert launches["fill_halos"] > 0, (label, "no fill launch")
        assert (launches["fused_advection_tendency"] > 0) == \
            a._kernel_tendency, (label, launches["fused_advection_tendency"])
        scale = max(b.field(c).interior.abs().max().item() for c in "uvw")
        line = 0.0
        for name in ("u", "v", "w", "c", "p"):
            x = a.field(name).interior.cpu()
            y = b.field(name).interior
            err = (x - y).abs().max().item()
            ref = y.abs().max().item()
            if name in "uvwp":
                ref = max(ref, scale)
            rel = 0.0 if err == 0 else err / ref
            assert rel <= 1e-10, (label, name, rel)
            line = max(line, rel)
        worst = max(worst, line)
        variants = {k[len("fused_advection_tendency_"):]: v
                    for k, v in launches.items()
                    if k.startswith("fused_advection_tendency_") and v}
        print(f"  model {label} {a.grid.N} float64, 3 steps on the card "
              f"against the CPU: worst rel {line:.3e} (bound 1e-10); "
              f"solver {type(a.pressure_solver).__name__}, #6 "
              f"{variants or 'not taken (plain flux divergences)'}, fill "
              f"launches {launches['fill_halos']}")
    return worst


def padded_laplacian(grid, phi_int):
    """∇²φ over the interior: φ's halos filled with the default conditions
    (Neumann on bounded axes, periodic wrap), the flux form of the
    operators; a flat axis adds no term."""
    from oceananigans_tpu_torch.boundary_conditions import (
        fill_all_halo_regions, regularize_field_boundary_conditions)
    from oceananigans_tpu_torch.operators.operators import (ddx, ddy, ddz,
                                                            dx_c, dy_c, dz_c)
    ccc = ("c", "c", "c")
    phi = torch.zeros(grid.padded_shape, dtype=phi_int.dtype,
                      device=phi_int.device)
    phi[grid.interior_slices] = phi_int
    fill_all_halo_regions([phi], grid, [(ccc, regularize_field_boundary_conditions(
        None, grid, ccc))])
    total = torch.zeros_like(phi)
    for ax, (d, delta, A) in enumerate(((ddx, dx_c, grid.Ax),
                                        (ddy, dy_c, grid.Ay),
                                        (ddz, dz_c, grid.Az))):
        if grid.is_flat(ax):
            continue
        loc = tuple("f" if a == ax else "c" for a in range(3))
        total = total + delta(grid, A(loc) * d(grid, phi, loc))
    V = grid.V(ccc)
    return (total / V)[grid.interior_slices]


def pressure_residual(label, grid):
    """The model's pressure solver (select_pressure_solver) on the row's
    grid in float64 on the card: |∇²φ − b| over max|b| for a seeded b with
    zero volume-weighted mean; bound 1e-8 (roundoff amplified by the
    eigenvalue range, about (N/π)² = 6.8e6 at 8192²)."""
    from oceananigans_tpu_torch.models.nonhydrostatic import \
        select_pressure_solver
    grid = grid.to(dtype=torch.float64)
    solver = select_pressure_solver(grid)
    gen = torch.Generator(device="cuda").manual_seed(44)
    b = torch.randn(grid.N, generator=gen, dtype=torch.float64, device="cuda")
    V = torch.as_tensor(grid.V(("c", "c", "c")), dtype=torch.float64,
                        device="cuda").broadcast_to(grid.padded_shape)[
                            grid.interior_slices]
    b = b - (b * V).sum() / V.sum()
    t0 = time.perf_counter()
    phi = solver.solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    res = (padded_laplacian(grid, phi) - b).abs().max().item() \
        / b.abs().max().item()
    print(f"  pressure residual {label} {grid.N} float64 "
          f"({type(solver).__name__}): max|∇²φ − b|/max|b| {res:.3e} (bound "
          f"1e-8), solve {solve_s * 1e3:.1f} ms with its first call")
    assert res < 1e-8, (label, "pressure residual", res)
    del phi, b, V
    torch.cuda.empty_cache()


def topology_phase_shares(model, dt, steps, card, label):
    """Per-step CUDA-event times of a step's phases: the advection (#6,
    or the plain flux divergences), the pressure solve (the tridiagonal
    sweep within it), the halo fills and the rest (the other tendencies,
    updates, the divergence and correction, allocations, host gaps)."""
    import oceananigans_tpu_torch.models.nonhydrostatic as nh
    import oceananigans_tpu_torch.solvers.fourier_tridiagonal as ftm
    timer = PhaseTimer()
    saved = (nh.fused_advection_tendency, nh.fill_all_halo_regions,
             nh.periodic_halo_fill, ftm.solve_batched_tridiagonal)
    nh.fused_advection_tendency = timer.wrap("#6", saved[0])
    nh.fill_all_halo_regions = timer.wrap("fills", saved[1])
    nh.periodic_halo_fill = timer.wrap("fills", saved[2])
    ftm.solve_batched_tridiagonal = timer.wrap("tridiagonal", saved[3])
    solver = model.pressure_solver
    solver.solve = timer.wrap("solve", solver.solve)
    model._advection = timer.wrap("advection", model._advection)
    model.time_step = timer.wrap("step", model.time_step)
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        (nh.fused_advection_tendency, nh.fill_all_halo_regions,
         nh.periodic_halo_fill, ftm.solve_batched_tridiagonal) = saved
        del solver.solve, model._advection, model.time_step
    g = t.get
    shares = {
        "#6 (fused_advection_tendency)": g("#6", 0.0),
        "plain flux divergences": g("advection", 0.0) - g("#6@advection",
                                                          0.0),
        "pressure solve": g("solve", 0.0),
        "halo fills": g("fills", 0.0),
    }
    shares["rest (other tendencies, updates, divergence, correction, host "
           "gaps)"] = t["step"] - sum(shares.values())
    print(f"{label} step phases, ms per step over {steps} steps (CUDA "
          f"events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.1f}%)")
    if g("tridiagonal") is not None:
        print(f"    of the solve, the tridiagonal sweep: "
              f"{g('tridiagonal'):.4f} ms ({100 * g('tridiagonal') / t['step']:.1f}% "
              f"of the step)")
    print(f"  step: {t['step']:.4f} ms")
    return shares, t["step"]


def topology_row_a(architecture=None):
    """Row A: triply periodic n³ over (0, 2π)³, WENO(5), no closure, H = 3;
    u, v, w from np.random.default_rng(0), projected by set()."""
    import oceananigans_tpu_torch as ot
    n = TOPO_A_N
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(2 * np.pi,) * 3,
                              topology=(P_, P_, P_), halo=3, dtype=torch.float32,
                              device="cuda")
    m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5),
                               architecture=architecture)
    rng = np.random.default_rng(0)
    m.set(**{c: rng.standard_normal((n, n, n), dtype=np.float32)
             for c in "uvw"})
    return m


def topology_row_b():
    """Row B: two-dimensional turbulence at n² over (0, 2π)²
    (examples/two_dimensional_turbulence.py at research size), WENO(5);
    u, v from np.random.default_rng(0)."""
    import oceananigans_tpu_torch as ot
    n = TOPO_B_N
    grid = ot.RectilinearGrid(size=(n, n), x=(0, 2 * np.pi),
                              y=(0, 2 * np.pi), topology=(P_, P_, F_),
                              dtype=torch.float32, device="cuda")
    m = ot.NonhydrostaticModel(grid, advection=ot.WENO(5))
    rng = np.random.default_rng(0)
    m.set(**{c: rng.standard_normal((n, n, 1), dtype=np.float32)
             for c in "uv"})
    return m


def tilted_faces(nz, Lz=100.0, refinement=1.8, stretching=10.0):
    """examples/tilted_bottom_boundary_layer.py's z faces (0 at the bottom,
    refined there)."""
    h = (nz - np.arange(nz + 1)) / nz
    zeta = 1 + (h - 1) / refinement
    Sig = (1 - np.exp(-stretching * h)) / (1 - np.exp(-stretching))
    return -Lz * (zeta * Sig - 1)


def topology_row_c():
    """Row C: examples/tilted_bottom_boundary_layer.py at nx x 1 x nz (Lx =
    200, Lz = 100, refinement 1.8, stretching 10): UpwindBiased(5),
    ScalarDiffusivity(1e-4, 1e-4), ConstantCartesianCoriolis, the tilted
    BuoyancyForce, background b and v, the quadratic drag on the bottom of
    u and v, N² on b's bottom; u and w noise from np.random.default_rng(7).
    Returns (model, Δt: the example's first Δt)."""
    import oceananigans_tpu_torch as ot
    nx, nz = TOPO_C_N
    Lx, Lz = 200.0, 100.0
    z_faces = tilted_faces(nz, Lz)
    grid = ot.RectilinearGrid(size=(nx, 1, nz), x=(0, Lx), y=(0, 1.0),
                              z=tuple(z_faces), topology=(P_, F_, B_),
                              dtype=torch.float32, device="cuda")
    zhat = (np.sin(np.radians(3.0)), 0.0, np.cos(np.radians(3.0)))
    N2, V_inf = 1e-5, 0.1
    z1 = float(0.5 * (z_faces[0] + z_faces[1]))
    cD = (0.4 / np.log(z1 / 0.1)) ** 2

    def drag_u(x, y, t, u, v):
        return -cD * (u ** 2 + (v + V_inf) ** 2) ** 0.5 * u

    def drag_v(x, y, t, u, v):
        return -cD * (u ** 2 + (v + V_inf) ** 2) ** 0.5 * (v + V_inf)

    bcs = {
        "u": ot.FieldBoundaryConditions(bottom=ot.FluxBoundaryCondition(
            drag_u, field_dependencies=("u", "v"))),
        "v": ot.FieldBoundaryConditions(bottom=ot.FluxBoundaryCondition(
            drag_v, field_dependencies=("u", "v"))),
        "b": ot.FieldBoundaryConditions(bottom=ot.GradientBoundaryCondition(
            -N2 * zhat[2]))}
    m = ot.NonhydrostaticModel(
        grid, buoyancy=ot.BuoyancyForce(ot.BuoyancyTracer(),
                                        gravity_unit_vector=tuple(
                                            -g for g in zhat)),
        coriolis=ot.ConstantCartesianCoriolis(f=1e-4, rotation_axis=zhat),
        closure=ot.ScalarDiffusivity(nu=1e-4, kappa=1e-4),
        advection=ot.UpwindBiased(5), tracers=("b",),
        boundary_conditions=bcs,
        background_fields={
            "b": ot.BackgroundField(
                lambda x, y, z, t, p: p["N2"] * (x * p["z1"] + z * p["z3"]),
                parameters={"N2": N2, "z1": zhat[0], "z3": zhat[2]}),
            "v": ot.BackgroundField(V_inf)})
    rng = np.random.default_rng(7)

    def noise(x, y, z):
        return 1e-3 * rng.standard_normal(np.broadcast_shapes(
            np.shape(x), np.shape(y), np.shape(z))) * np.exp(
                -(10 * z) ** 2 / Lz ** 2)

    m.set(u=noise, w=noise)
    min_dz = float(np.diff(z_faces).min())
    return m, 0.5 * min(min_dz / V_inf, min_dz ** 2 / 1e-4)


def cfl_dt(model, cfl=0.5):
    """Δt at the given advective CFL of the model's state (regular x)."""
    umax = max(model.field(c).interior.abs().max().item() for c in "uvw")
    return cfl * model.grid.minimum_spacing(0) / umax


def topology_row(card, label, model, dt, variant):
    """3 warm-up and 10 timed steps with the counters reset just before and
    read just after: #6 (``variant``, three launches a step; None: the
    plain flux divergences), the fill kernel, no plain version on CUDA
    tensors; finite fields, the divergence; step median, min and max, peak
    memory, the phase shares, the busy share and device kernels per step.
    Returns (launches, step median ms)."""
    from oceananigans_tpu_torch import kernels as K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    warmup, timed = TOPO_STEPS
    times = timed_steps(model, dt, warmup, timed)
    launches, plain = K.counters()
    steps = warmup + timed
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain.items() if v} }")
    for name, count in plain.items():
        assert count == 0, f"plain {name} ran on CUDA tensors ({label})"
    assert plain["fused_advection_tendency_plain"] == 0
    assert launches["fill_halos"] > 0, (label, "no fill launch")
    if variant is None:
        assert launches["fused_advection_tendency"] == 0, label
    else:
        assert launches["fused_advection_tendency"] == 3 * steps, \
            (label, launches["fused_advection_tendency"])
        assert launches[f"fused_advection_tendency_{variant}"] == 3 * steps, \
            (label, variant, launches)
    for name in model.prognostic_names:
        assert torch.isfinite(model.field(name).interior).all().item(), \
            (label, f"{name} is not finite")
    padded_divergence(label, model)
    step_ms = statistics.median(times) * 1e3
    n = int(np.prod(model.grid.N))
    print(f"{label}: step median {step_ms:.3f} ms over {timed} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), Δt {dt:.4e}, "
          f"{n / (step_ms / 1e3):.4e} cell-updates/s; peak device memory "
          f"(steps) {peak / 2 ** 30:.2f} GiB [{card}]")
    topology_phase_shares(model, dt, 3, card, label)
    busy_share(label, model, dt, 3, step_ms, card)
    return launches, step_ms


def circular_pad3_ms(grid, fields):
    """torch.nn.functional.pad(mode="circular") along x, y and z of the
    fields' interiors stacked as channels: the one PyTorch call that
    computes the triply periodic wrap (out of place); checked against the
    filled fields."""
    import torch.nn.functional as F
    Hx, Hy, Hz = grid.H
    x = torch.stack([f[grid.interior_slices] for f in fields])[None]
    pad = (Hz, Hz, Hy, Hy, Hx, Hx)
    got = F.pad(x, pad, mode="circular")[0]
    assert all(torch.equal(g, f) for g, f in zip(got, fields)), \
        "circular pad differs from the filled fields"
    ms = device_ms(lambda: F.pad(x, pad, mode="circular"))
    print(f"  time torch.nn.functional.pad(mode='circular') of "
          f"{tuple(x.shape)} along x, y and z: {ms:.4f} ms")
    return ms


def row_kernel_check(label, model, variant_label, bound_pair, zmode):
    """#6 on the row's own state (u, v, w, halos filled) against its plain
    version in float32, within 2e-5 of each component's term scale (phase
    25's bound), timed with its bound; then the fill on u, v, w, p bit for
    bit, timed with its bound and sector floor and F.pad(mode="circular").
    Returns ({kernel: measured})."""
    from oceananigans_tpu_torch import kernels as K
    grid = model.grid
    fields = dict(model.state["fields"])
    model._fill_all(fields)
    f = [fields[c] for c in "uvw"]
    scheme = model.advection
    Gk = K.fused_advection_tendency(grid, scheme, f)
    Gp = K.fused_advection_tendency_plain(grid, scheme, f)
    scales = term_scales(grid, scheme, f)
    err, rel = scaled_err(list(Gk), list(Gp), scales)
    print(f"  fused_advection_tendency {zmode} z on {label}'s state "
          f"{grid.N} float32: max abs {err:.3e}, over the term scale "
          f"{rel:.3e} (bound 2e-5)")
    assert rel <= 2e-5, ("#6", label, rel)
    del Gk, Gp
    ms = cuda_ms(lambda: K.fused_advection_tendency(grid, scheme, f))
    plain_ms = cuda_ms(lambda: K.fused_advection_tendency_plain(
        grid, scheme, f), reps=3, warmup=1)
    print(f"  time fused_advection_tendency {zmode} z at "
          f"{grid.padded_shape} (u, v, w): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_pair[0]:.4f} ms "
          f"({bound_pair[1]}) [{variant_label}]")
    out = {f"fused_advection_tendency_z{zmode}": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=bound_pair,
        library_ms=None)}
    names = ["u", "v", "w", "p"]
    arrays = [fields[c] for c in "uvw"] + [model.state["pressure"]]
    lbs = model_locs_bcs(model, names[:3]) + [((
        "c", "c", "c"), model.bcs["p"])]
    ferr = fill_check(f"{label} u, v, w, p", grid, arrays, lbs)
    fill = time_fill(f"{label} u, v, w, p ({zmode} z)", grid, arrays, lbs,
                     ferr)
    fill["library_ms"] = (circular_pad3_ms(grid, arrays) if zmode ==
                          "periodic" else circular_pad_ms(grid, arrays))
    out[f"fill_halos_z{zmode}"] = fill
    return out


# phase 27's kernel rows: (its row, the counter of its launches there, the
# kernel whose source and TPU kernel it takes)
TOPOLOGY_ROWS = {
    "fused_advection_tendency_zperiodic": (
        "A", "fused_advection_tendency_weno5_zperiodic",
        "fused_advection_tendency"),
    "fill_halos_zperiodic": ("A", "fill_halos", "fill_halos"),
    "fused_advection_tendency_zflat": (
        "B", "fused_advection_tendency_weno5_zflat",
        "fused_advection_tendency"),
    "fill_halos_zflat": ("B", "fill_halos", "fill_halos"),
    "fill_halos_stretched": ("C", "fill_halos", "fill_halos_bounded"),
}


def topology_phase(card):
    """Phase 27: the NonhydrostaticModel on every topology and on one
    stretched axis. Returns ({kernel row: measured}, {row: launches})."""
    t0 = time.perf_counter()
    out, launches = {}, {}
    print("#6 on a flat and a periodic z against its plain version (float64, "
          "1e-12):")
    z_mode_kernel_checks()
    print("the fill on every topology against its plain version (float64, "
          "bit for bit):")
    topology_fill_checks()
    print("each topology's model on the card against the CPU (float64, 3 "
          "steps, 1e-10):")
    topology_model_checks()
    torch.cuda.empty_cache()

    label = f"row A, triply periodic {TOPO_A_N}^3 WENO(5)"
    print(f"{label}:")
    model = topology_row_a()
    n = TOPO_A_N
    bound_a = convection_bounds((n, n, n), (3, 3, 3), 4, n_tracers=0)[
        "fused_advection_tendency"]
    out.update(row_kernel_check(label, model, "weno5_zperiodic", bound_a,
                                "periodic"))
    pressure_residual(label, model.grid)
    launches["A"], step_a = topology_row(card, label, model, cfl_dt(model),
                                         "weno5_zperiodic")
    del model
    torch.cuda.empty_cache()

    label = f"row B, two-dimensional turbulence {TOPO_B_N}^2 WENO(5)"
    print(f"{label}:")
    model = topology_row_b()
    n = TOPO_B_N
    padded = (n + 6) ** 2
    bound_b = bound(4 * 3 * (padded + n * n),
                    n * n * advection_flop(model.advection, 3, 0, flat_z=True))
    out.update(row_kernel_check(label, model, "weno5_zflat", bound_b,
                                "flat"))
    pressure_residual(label, model.grid)
    launches["B"], step_b = topology_row(card, label, model, cfl_dt(model),
                                         "weno5_zflat")
    del model
    torch.cuda.empty_cache()

    label = (f"row C, tilted bottom boundary layer {TOPO_C_N[0]}x1x"
             f"{TOPO_C_N[1]} stretched z")
    print(f"{label}:")
    model, dt = topology_row_c()
    assert model.grid.stretched_axes == (2,), model.grid.stretched_axes
    assert not model._kernel_tendency
    print(f"  Δz from {model.grid.minimum_spacing(2):.4f} m (bottom) up; "
          f"solver {type(model.pressure_solver).__name__} along z")
    pressure_residual(label, model.grid)
    launches["C"], step_c = topology_row(card, label, model, dt, None)
    fields = dict(model.state["fields"])
    names = ["u", "v", "w", "b"]
    arrays = [fields[c] for c in names]
    lbs = model_locs_bcs(model, names)
    ferr = fill_check(f"{label} u, v, w, b", model.grid, arrays, lbs)
    out["fill_halos_stretched"] = time_fill(
        f"{label} u, v, w, b (bounded z, flat y)", model.grid, arrays, lbs,
        ferr)
    del model, fields, arrays
    torch.cuda.empty_cache()
    print(f"phase 27 rows: A {step_a:.3f} ms, B {step_b:.3f} ms, C "
          f"{step_c:.3f} ms a step [{card}]")
    print(f"phase 27 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    return out, launches



# -- phase 28: immersed, multiply stretched and curvilinear grids, open and
# per-point conditions ----------------------------------------------------------

SEAMOUNT_N = (2048, 512)       # row D: tidal flow over a seamount, nx × nz
HILL_N = (256, 256, 128)       # row E: stratified flow over a 3-D hill
CG_STEPS = (3, 5)              # warm-up and timed steps of each row
CG_TIGHT = 1e-14               # the card-against-CPU models' solver tolerance
SEAMOUNT_DT = 20.0             # the example's Δt cap
WITNESS_MAXITER = 20000        # the witnesses' CG iterations at most
OPEN_TIMESCALES = ((0.0, np.inf), (60.0, 0.5), (np.inf, 0.0), (2.0, 3.0),
                   (0.0, 0.0), (1.0, np.inf))


def open_side_bcs(classes, kinds, N, topology, seed):
    """The port's FieldBoundaryConditions for phase 28's fill checks: side
    s takes ``classes[s]`` ("value", "gradient", "open" with
    PerturbationAdvection of ``OPEN_TIMESCALES[s]``, "flux") with a
    ``kinds[s]`` condition ("callable" of the transverse coordinates and
    the time, "array" of the plane's interior, "scalar"); periodic sides
    keep their defaults."""
    import oceananigans_tpu_torch as ot
    rng = np.random.default_rng(seed)
    sides = {}
    for s, side in enumerate(FILL_SIDES):
        if topology[s // 2] != B_:
            continue
        k = 0.3 * (s + 1)
        t_axes = [ax for ax in range(3) if ax != s // 2]
        cond = {"callable": lambda a, b, t, k=k: k * torch.cos(a)
                * torch.sin(2 * b) + 0.1 * t,
                "array": rng.standard_normal(tuple(N[ax] for ax in t_axes)),
                "scalar": 0.1 * (s + 1) * (-1) ** s}[kinds[s]]
        if classes[s] == "open":
            sides[side] = ot.OpenBoundaryCondition(
                cond, scheme=ot.PerturbationAdvection(*OPEN_TIMESCALES[s]))
        else:
            sides[side] = {"value": ot.ValueBoundaryCondition,
                           "gradient": ot.GradientBoundaryCondition,
                           "flux": ot.FluxBoundaryCondition}[classes[s]](cond)
    return ot.FieldBoundaryConditions(**sides)


def open_fill_checks():
    """The fill kernel against fill_halos_plain, bit for bit, on small cases
    of every new map on every side: planes (callable and array values) under
    Value, Gradient and Open on x, y and z of the four locations (w's
    included), the PerturbationAdvection face with Δt (inflow and outflow
    sides, τ = 0, finite and ∞), array conditions wrapping along a periodic
    transverse axis, bounded and periodic x and y, N from below H to larger,
    float32 and float64; 3 fields a launch. Returns the cases checked."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.boundary_conditions import \
        regularize_field_boundary_conditions
    K.reset_counters()
    rng = np.random.default_rng(28)
    cases = 0
    for N in ((9, 7, 6), (3, 2, 4)):
        for topology in ((B_, B_, B_), (P_, B_, B_), (B_, P_, B_),
                         (P_, P_, B_)):
            if P_ in topology[:2] and min(N[ax] for ax in range(2)
                                          if topology[ax] == P_) < 3:
                continue
            for dtype in (torch.float32, torch.float64):
                grid = topo_grid(topology, N, (3, 2, 3), dtype, "cuda",
                                 extent=(2.0, 2.0, 3.0))
                for loc in FILL_LOCS:
                    for cls in ("value", "gradient", "open", "mixed"):
                        classes = [cls if cls != "mixed" else
                                   ("value", "gradient", "open",
                                    "flux")[rng.integers(4)]
                                   for _ in FILL_SIDES]
                        kinds = [("callable", "array", "scalar")[
                            rng.integers(3)] for _ in FILL_SIDES]
                        bcs = regularize_field_boundary_conditions(
                            open_side_bcs(classes, kinds, N, topology,
                                          int(rng.integers(1000))),
                            grid, loc)
                        for dt in (None, 0.3):
                            fields = [torch.randn(grid.padded_shape,
                                                  dtype=dtype, device="cuda")
                                      for _ in range(3)]
                            lbs = [(loc, bcs)] * 3
                            a = K.fill_halos(grid, [f.clone() for f in fields],
                                             lbs, time=0.7, dt=dt)
                            b = K.fill_halos_plain(
                                grid, [f.clone() for f in fields], lbs,
                                time=0.7, dt=dt)
                            for x, y in zip(a, b):
                                assert torch.equal(x, y), (
                                    "fill with planes", N, topology, dtype,
                                    loc, classes, kinds, dt)
                            cases += 1
    launches, _ = K.counters()
    print(f"  fill_halos with planes and the perturbation face against "
          f"fill_halos_plain: {cases} cases of 3 fields, every slot bit for "
          f"bit; launches {launches['fill_halos']} (planes "
          f"{launches['fill_halos_planes']}, perturbation faces "
          f"{launches['fill_halos_perturbation']})")
    assert launches["fill_halos_perturbation"] > 0
    return cases


def seamount_model(nx, nz, dtype, device, smoothness=torch.float32,
                   pressure_solver=None, seed=0):
    """``examples/tidal_flow_over_seamount.py`` at (nx, nz): 8 km × 200 m,
    a PartialCellBottom Gaussian seamount, the tide on both x sides as Open
    + PerturbationAdvection(60, ∞), WENO(5), BuoyancyTracer with N² = 1e-5,
    the immersed CG with its DCT-x/DCT-z preconditioner (or
    ``pressure_solver(grid)`` at the model's halos); b = N²z and a seeded
    u of 0.01 m/s, projected by set()."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.immersed import (ImmersedBoundaryGrid,
                                                 PartialCellBottom)
    Lx, Lz, U0, omega, N2 = 8000.0, 200.0, 0.1, 1.4e-3, 1e-5
    under = ot.RectilinearGrid(size=(nx, 1, nz), x=(0.0, Lx), z=(-Lz, 0.0),
                               topology=(B_, F_, B_), dtype=dtype,
                               device=device)
    grid = ImmersedBoundaryGrid(under, PartialCellBottom(
        lambda x, y: -Lz + 100.0 * np.exp(-((x - Lx / 2) / 800.0) ** 2)))
    pa = ot.PerturbationAdvection(inflow_timescale=60.0,
                                  outflow_timescale=np.inf)

    def tide(y, z, t):
        return U0 * np.sin(omega * t) * torch.ones_like(z)

    u_bcs = ot.FieldBoundaryConditions(
        west=ot.OpenBoundaryCondition(tide, scheme=pa),
        east=ot.OpenBoundaryCondition(tide, scheme=pa))
    kw = {} if pressure_solver is None else dict(
        pressure_solver=pressure_solver(grid.with_halo((3, 0, 3))))
    m = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=smoothness),
        buoyancy=ot.BuoyancyTracer(), boundary_conditions={"u": u_bcs}, **kw)
    rng = np.random.default_rng(seed)
    m.set(b=lambda x, y, z: N2 * z,
          u=0.01 * rng.standard_normal((nx, 1, nz)))
    return m


def hill_model(N, dtype, device, smoothness=torch.float32,
               pressure_solver=None, seed=0, architecture=None, initial=True):
    """Row E: periodic x and y over (0, 4000 m)², z in (−200, 0) m, a
    GridFittedBottom Gaussian hill −200 + 100·exp(−r²/800²) at the centre,
    WENO(5), BuoyancyTracer with N² = 1e-5, u = 0.1 m/s with a seeded
    perturbation of 0.01 m/s, the immersed CG with its FFT-x/FFT-y/DCT-z
    preconditioner (or ``pressure_solver(grid)`` at the model's halos);
    ``initial=False``: the model as built, its state zero."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.immersed import (GridFittedBottom,
                                                 ImmersedBoundaryGrid)
    L, Lz, N2 = 4000.0, 200.0, 1e-5
    under = ot.RectilinearGrid(size=N, x=(0.0, L), y=(0.0, L), z=(-Lz, 0.0),
                               topology=(P_, P_, B_), dtype=dtype,
                               device=device)
    grid = ImmersedBoundaryGrid(under, GridFittedBottom(
        lambda x, y: -Lz + 100.0 * np.exp(
            -((x - L / 2) ** 2 + (y - L / 2) ** 2) / 800.0 ** 2)))
    kw = {} if pressure_solver is None else dict(
        pressure_solver=pressure_solver(grid.with_halo((3, 3, 3))))
    m = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=smoothness),
        buoyancy=ot.BuoyancyTracer(), architecture=architecture, **kw)
    if not initial:
        return m
    rng = np.random.default_rng(seed)
    m.set(b=lambda x, y, z: N2 * z,
          u=0.1 + 0.01 * rng.standard_normal(N),
          v=0.01 * rng.standard_normal(N))
    return m


def tight_immersed_solver(grid):
    """The immersed CG at ``CG_TIGHT`` on ``grid`` (the model's halos),
    preconditioned by the underlying grid's FFT solver."""
    from oceananigans_tpu_torch.boundary_conditions import (
        fill_all_halo_regions, regularize_field_boundary_conditions)
    from oceananigans_tpu_torch.solvers import (FFTPoissonSolver,
                                                make_immersed_poisson_solver)
    ccc = ("c", "c", "c")
    bcs = regularize_field_boundary_conditions(None, grid, ccc)
    under = grid.underlying_grid
    return make_immersed_poisson_solver(
        grid, lambda p: fill_all_halo_regions([p], grid, [(ccc, bcs)]),
        FFTPoissonSolver(under) if under.all_regular else None,
        reltol=CG_TIGHT, maxiter=800)


def tight_variable_solver(grid):
    """The variable-spacing CG at ``CG_TIGHT`` (1e-12 on a lat-lon grid,
    whose CG stalls above 1e-13) on ``grid`` (the model's halos)."""
    from oceananigans_tpu_torch.boundary_conditions import (
        fill_all_halo_regions, regularize_field_boundary_conditions)
    from oceananigans_tpu_torch.solvers import \
        make_variable_spacing_poisson_solver
    ccc = ("c", "c", "c")
    bcs = regularize_field_boundary_conditions(None, grid, ccc)
    return make_variable_spacing_poisson_solver(
        grid, lambda p: fill_all_halo_regions([p], grid, [(ccc, bcs)]),
        reltol=1e-12 if hasattr(grid, "radius") else CG_TIGHT, maxiter=3000)


def horizontal_convection_model(nx, nz, dtype, device, seed=3):
    """``examples/horizontal_convection.py`` at (nx, nz), Ra = 1e8: a
    callable Value condition b = −cos(2πx/Lx) on b's top, WENO(5) (float64
    smoothness), ScalarDiffusivity; b = 0.1z and a seeded u of 1e-3."""
    import oceananigans_tpu_torch as ot
    Lx, H, Ra = 2.0, 1.0, 1e8
    nu = kappa = float(np.sqrt(Lx ** 3 / Ra))
    grid = ot.RectilinearGrid(size=(nx, nz), x=(-Lx / 2, Lx / 2), z=(-H, 0),
                              topology=(B_, F_, B_), dtype=dtype,
                              device=device)
    b_bcs = ot.FieldBoundaryConditions(top=ot.ValueBoundaryCondition(
        lambda x, y, t: -torch.cos(2 * np.pi * x / Lx)))
    m = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=dtype),
        buoyancy=ot.BuoyancyTracer(), tracers=("b",),
        closure=ot.ScalarDiffusivity(nu=nu, kappa={"b": kappa}),
        boundary_conditions={"b": b_bcs})
    rng = np.random.default_rng(seed)
    m.set(u=1e-3 * rng.standard_normal((nx, 1, nz)),
          b=lambda x, y, z: 0.1 * z)
    return m


def open_channel_model(device):
    """A (P, B, B) 8×6×8 channel with PerturbationAdvection sides on y and
    z: v's north Open (a callable of x, z and t; τ 2 and 3) and w's top
    Open (a callable of x, y and t; τ 0.5 and ∞), both balanced by the
    mass balance, a callable Value on b's bottom and an array Gradient on
    its top; Centered(2), ScalarDiffusivity, float64. Its PA faces on y and
    z are formed from copies filled along the earlier axes."""
    import oceananigans_tpu_torch as ot
    rng = np.random.default_rng(9)
    N = (8, 6, 8)
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                              topology=(P_, B_, B_), dtype=torch.float64,
                              device=device)
    bcs = {"v": ot.FieldBoundaryConditions(north=ot.OpenBoundaryCondition(
        lambda x, z, t: 0.01 * torch.cos(2 * np.pi * x) * (1 + t) + 0 * z,
        scheme=ot.PerturbationAdvection(2.0, 3.0))),
        "w": ot.FieldBoundaryConditions(top=ot.OpenBoundaryCondition(
            lambda x, y, t: 0.01 * torch.sin(2 * np.pi * x) * (1 + t) + 0 * y,
            scheme=ot.PerturbationAdvection(0.5, np.inf))),
        "b": ot.FieldBoundaryConditions(
            bottom=ot.ValueBoundaryCondition(
                lambda x, y, t: 0.1 * torch.cos(2 * np.pi * x) + 0 * y),
            top=ot.GradientBoundaryCondition(
                0.01 * rng.standard_normal(N[:2])))}
    m = ot.NonhydrostaticModel(
        grid, advection=ot.Centered(2), buoyancy=ot.BuoyancyTracer(),
        tracers=("b",), closure=ot.ScalarDiffusivity(nu=1e-3, kappa=1e-3),
        boundary_conditions=bcs)
    m.set(u=0.05 * rng.standard_normal(N), b=lambda x, y, z: 0.2 * z)
    return m


def cg_small_models(device):
    """Phase 28's card-against-CPU models in float64: the immersed hill at
    24×20×12, a grid stretched along x, y and z, the lat-lon NH model, the
    seamount example at 64×16, horizontal_convection at 32×16 and a channel
    with PerturbationAdvection sides on y and z, each CG model given
    ``pressure_solver=`` at reltol 1e-14 (1e-12 on the lat-lon grid)."""
    import oceananigans_tpu_torch as ot
    f64 = torch.float64
    faces = np.cumsum(np.r_[0.0, 1.0 + 0.3 * np.sin(np.arange(10))])
    out = {"immersed hill": (hill_model((24, 20, 12), f64, device, f64,
                                        tight_immersed_solver), 2.0)}
    stretched = ot.RectilinearGrid(size=(10, 10, 10), x=tuple(faces),
                                   y=tuple(faces), z=tuple(faces - faces[-1]),
                                   topology=(B_, B_, B_), dtype=f64,
                                   device=device)
    latlon = ot.LatitudeLongitudeGrid(size=(12, 10, 6), longitude=(0, 60),
                                      latitude=(10, 50), z=(-100, 0),
                                      dtype=f64, device=device)
    for label, grid, dt in (("stretched x, y, z", stretched, 1e-2),
                            ("lat-lon", latlon, 60.0)):
        m = ot.NonhydrostaticModel(
            grid, advection=ot.WENO(5, smoothness_dtype=f64), tracers=("c",),
            pressure_solver=tight_variable_solver(grid.with_halo((3, 3, 3))))
        rng = np.random.default_rng(1)
        m.set(**{k: 0.1 * rng.standard_normal(grid.N) for k in "uvc"})
        out[label] = (m, dt)
    out["seamount 64x16"] = (seamount_model(64, 16, f64, device, f64,
                                            tight_immersed_solver), 20.0)
    out["horizontal_convection 32x16"] = (
        horizontal_convection_model(32, 16, f64, device), 1e-2)
    out["open channel, PA on y and z"] = (open_channel_model(device), 5e-2)
    return out


def cg_model_checks():
    """Each small model on the card over 3 steps against the same model on
    the CPU, float64: every field within 1e-12 of
    its scale (the velocity scale at least for u, v, w and p), an immersed
    model's p over its fluid cells with their mean removed (the immersed
    CG, as JAX's, leaves p's constant over the fluid, which no correction
    reads, where its roundoff puts it); the lat-lon model's fields within
    1e-10 (its CG
    stops at 1e-12 of a Laplacian whose condition number is about 2e7: its
    u, v and c read 4.04e-12, 4.56e-12 and 1.21e-11, PERF.md).
    A CG model's divergence at roundoff. No plain version runs on CUDA
    tensors; the fill kernel launches. Every model is compared before a
    miss fails the check."""
    from oceananigans_tpu_torch import kernels as K
    card = cg_small_models("cuda")
    cpu = cg_small_models("cpu")
    worst, misses = 0.0, []
    for label, (a, dt) in card.items():
        b = cpu[label][0]
        bound = 1e-10 if label == "lat-lon" else 1e-12
        steps = 3
        K.reset_counters()
        for _ in range(steps):
            a.time_step(dt)
            b.time_step(dt)
        launches, plain = K.counters()
        assert all(v == 0 for v in plain.values()), (label, plain)
        assert launches["fill_halos"] > 0, (label, "no fill launch")
        scale = max(b.field(c).interior.abs().max().item() for c in "uvw")
        line, errs = 0.0, {}
        for name in list(b.state["fields"]) + ["p"]:
            x = a.field(name).interior.cpu()
            y = b.field(name).interior
            if name == "p" and b.immersed:
                fluid = b.grid.fluid_mask(("c", "c", "c")).bool()[
                    b.grid.interior_slices]
                x, y = x[fluid] - x[fluid].mean(), y[fluid] - y[fluid].mean()
            err = (x - y).abs().max().item()
            ref = y.abs().max().item()
            if name in "uvwp":
                ref = max(ref, scale)
            rel = 0.0 if err == 0 else err / ref
            errs[name] = rel
            if not rel <= bound:
                misses.append((label, name, rel, bound))
            line = max(line, rel)
        worst = max(worst, line)
        if hasattr(a.pressure_solver, "operator"):
            # a CG solved to 1e-14 (1e-12): the divergence is at roundoff
            fluid_divergence(f"model {label}", a, bound_rel=1e-8)
        print(f"  model {label} {a.grid.N} float64, {steps} steps on the card "
              f"against the CPU: worst rel {line:.3e} (bound {bound:.0e}; "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"); fill launches {launches['fill_halos']} (planes "
              f"{launches['fill_halos_planes']}, perturbation faces "
              f"{launches['fill_halos_perturbation']})")
    assert not misses, ("card against CPU", misses)
    return worst


def open_radiation_golden():
    """``tests/test_regression.py``'s open_boundary_radiation channel in
    float64 on the card, 10 steps, against its golden file: 1e-9."""
    import oceananigans_tpu_torch as ot
    U0 = 0.3
    grid = ot.RectilinearGrid(size=(32, 1, 8), x=(0, 4.0), z=(-1.0, 0.0),
                              topology=(B_, F_, B_), dtype=torch.float64,
                              device="cuda")
    u_bcs = ot.FieldBoundaryConditions(
        west=ot.OpenBoundaryCondition(U0),
        east=ot.OpenBoundaryCondition(U0, scheme=ot.PerturbationAdvection(
            inflow_timescale=0.1)))
    m = ot.NonhydrostaticModel(grid, advection=ot.Centered(2),
                               boundary_conditions={"u": u_bcs},
                               tracers=("c",))
    m.set(u=U0, c=lambda x, y, z: np.exp(-(x - 1.0) ** 2 / 0.05))
    for _ in range(10):
        m.time_step(0.01)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "regression_open_boundary_radiation.npz")
    worst = 0.0
    with np.load(path) as ref:
        for field in ref.files:
            got = m.field(field).interior.cpu().numpy()
            want = ref[field]
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
            assert err < 1e-9, ("open_boundary_radiation", field, err)
            worst = max(worst, err)
    print(f"  golden open_boundary_radiation on the card (float64, 10 steps): "
          f"worst rel {worst:.3e} (bound 1e-9)")


def cg_dt(model, cap=None, cfl=0.5):
    """Δt at the advective CFL over every axis that is not flat (each
    velocity component over its axis's smallest spacing), capped."""
    dt = np.inf
    for ax, c in enumerate("uvw"):
        if model.grid.is_flat(ax):
            continue
        umax = model.field(c).interior.abs().max().item()
        if umax > 0:
            dt = min(dt, cfl * model.grid.minimum_spacing(ax) / umax)
    return dt if cap is None else min(dt, cap)


def cg_phase_shares(model, dt, steps, card, label):
    """Per-step CUDA-event times of the step's phases: the CG solve (its
    fills within it), the plain flux divergences, the fills outside the
    solve, the open sides' mass balance and the rest (the other tendencies,
    updates, masks, divergence and correction, host gaps)."""
    import oceananigans_tpu_torch.models.nonhydrostatic as nh
    timer = PhaseTimer()
    saved = nh.fill_all_halo_regions
    nh.fill_all_halo_regions = timer.wrap("fills", saved)
    solver = model.pressure_solver
    solver.solve = timer.wrap("solve", solver.solve)
    model._advection = timer.wrap("advection", model._advection)
    model._balance_open_mass = timer.wrap("balance", model._balance_open_mass)
    model.time_step = timer.wrap("step", model.time_step)
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        nh.fill_all_halo_regions = saved
        del solver.solve, model._advection, model._balance_open_mass
        del model.time_step
    g = t.get
    shares = {
        "CG solve": g("solve", 0.0),
        "plain flux divergences": g("advection", 0.0),
        "fills (outside the solve)": g("fills", 0.0) - g("fills@solve", 0.0),
        "mass balance": g("balance", 0.0),
    }
    shares["rest (other tendencies, updates, masks, divergence, correction, "
           "host gaps)"] = t["step"] - sum(shares.values())
    print(f"{label} step phases, ms per step over {steps} steps (CUDA "
          f"events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.1f}%)")
    print(f"    of the solve, the p fills: {g('fills@solve', 0.0):.4f} ms")
    print(f"  step: {t['step']:.4f} ms")
    return shares, t["step"]


def fluid_divergence(label, model, bound_rel=1e-4, required=True):
    """max|∇·u|·Δx/max|u| over the fluid cells of the model's state (the
    periodic halos wrapped on copies; the boundary faces as the state holds
    them), with its bound. ``required``: the bound is asserted; otherwise
    (a float32 row whose CG, as JAX's, stops at maxiter above its
    tolerance) whether it is met is printed beside the value, which must be
    finite."""
    from oceananigans_tpu_torch.kernels import periodic_halo_fill
    from oceananigans_tpu_torch.models.nonhydrostatic import \
        _interior_divergence
    grid = model.grid
    u, v, w = (model.state["fields"][c].clone() for c in "uvw")
    periodic_halo_fill(grid, [u, v, w])
    ints = grid.interior_slices
    div = _interior_divergence(grid, u, v, w)
    if hasattr(grid, "fluid_mask"):
        div = div[grid.fluid_mask(("c", "c", "c")).bool()[ints]]
    umax = max(a[ints].abs().max().item() for a in (u, v, w))
    rel = div.abs().max().item() * grid.minimum_spacing(0) / umax
    met = rel < bound_rel
    print(f"  {label}: max|div u|·Δx/max|u| over the fluid cells after "
          f"{model.iteration} steps: {rel:.3e} (bound {bound_rel:.0e}: "
          f"{'met' if met else 'NOT met'}); max|u| {umax:.3e}")
    assert np.isfinite(rel), (label, "divergence", rel)
    if required:
        assert met, (label, "divergence", rel)
    return rel


def open_boundary_flux(label, model):
    """The net volume flux through the open x sides over the boundary flux
    scale Σ|u·A| (float64 sums of the state's boundary faces), bound 1e-6."""
    grid = model.grid
    H, N = grid.H[0], grid.N[0]
    u = model.state["fields"]["u"].double()
    A = torch.as_tensor(grid.Ax(("f", "c", "c")), device=u.device).double()
    A = A.broadcast_to(grid.padded_shape)
    sl = list(grid.interior_slices)
    west = sl.copy()
    west[0] = slice(H, H + 1)
    east = sl.copy()
    east[0] = slice(H + N, H + N + 1)
    qw = (u[tuple(west)] * A[tuple(west)])
    qe = (u[tuple(east)] * A[tuple(east)])
    net = (qw.sum() - qe.sum()).item()
    scale = (qw.abs().sum() + qe.abs().sum()).item()
    rel = abs(net) / scale
    print(f"  {label}: net open-boundary volume flux {net:.4e} m³/s over the "
          f"boundary flux scale {scale:.4e} m³/s: {rel:.3e} (bound 1e-6)")
    assert rel < 1e-6, (label, "open-boundary flux", rel)
    return rel


def adaptive_steps(model, cap, warmup, timed):
    """``warmup`` and ``timed`` steps, each of Δt = ``cg_dt`` (min(cap, CFL
    0.5)) of the state it starts from, taken before its timer starts (a
    wizard's rule: the rows' vertical velocities grow from their noise).
    Returns (the timed steps' host-clock seconds, their Δt)."""
    for _ in range(warmup):
        model.time_step(cg_dt(model, cap))
    torch.cuda.synchronize()
    times, dts = [], []
    for _ in range(timed):
        dt = cg_dt(model, cap)
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        dts.append(dt)
    return times, dts


def cg_row(card, label, model, cap=None):
    """3 warm-up and ``CG_STEPS[1]`` timed steps of Δt = min(``cap``, CFL
    0.5) (``adaptive_steps``) with the counters reset just before and read
    just after: the fill kernel launches (with planes and perturbation
    faces where the row has them), no plain version on CUDA tensors; CG
    iterations per solve and host syncs per step; finite fields, the
    divergence; step median, min and max, peak memory, the phase shares,
    the busy share and device kernels per step. Returns (launches, step
    median ms, the last Δt)."""
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.solvers.conjugate_gradient import \
        conjugate_gradient as cg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    cg.iterations.clear()
    cg.residuals.clear()
    syncs0 = cg.syncs
    warmup, timed = CG_STEPS
    times, dts = adaptive_steps(model, cap, warmup, timed)
    launches, plain = K.counters()
    steps = warmup + timed
    iters = list(cg.iterations)
    syncs = (cg.syncs - syncs0) / steps
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain.items() if v} }")
    for name, count in plain.items():
        assert count == 0, f"plain {name} ran on CUDA tensors ({label})"
    assert launches["fill_halos"] > 0, (label, "no fill launch")
    assert len(iters) == 3 * steps, (label, len(iters))
    res = list(cg.residuals)
    print(f"{label}: CG iterations per solve over {len(iters)} solves: min "
          f"{min(iters)}, median {statistics.median(iters)}, max "
          f"{max(iters)} (maxiter {model.pressure_solver.maxiter}, reltol "
          f"{model.pressure_solver.reltol}); final residual over |b| min "
          f"{min(res):.3e}, median {statistics.median(res):.3e}, max "
          f"{max(res):.3e}; host syncs per step {syncs:.1f}")
    for name in model.prognostic_names:
        assert torch.isfinite(model.field(name).interior).all().item(), \
            (label, f"{name} is not finite")
    # the bound holds where the CG reaches its tolerance; a float32 CG that
    # stops at maxiter (as JAX's) leaves the divergence its residual allows
    converged = max(iters) < model.pressure_solver.maxiter
    div = fluid_divergence(label, model, required=converged)
    step_ms = statistics.median(times) * 1e3
    n = int(np.prod(model.grid.N))
    print(f"{label}: step median {step_ms:.3f} ms over {timed} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), Δt "
          f"{min(dts):.4e}-{max(dts):.4e} s, "
          f"{n / (step_ms / 1e3):.4e} cell-updates/s; peak device memory "
          f"(steps) {peak / 2 ** 30:.2f} GiB [{card}]")
    dt = cg_dt(model, cap)
    cg_phase_shares(model, dt, 2, card, label)
    # one profiled step (two took 24 s on row D and 36 s on row E, the
    # profiler's own processing, which the hill of phase 32 (c) needs)
    busy_share(label, model, cg_dt(model, cap), 1, step_ms, card)
    launches["divergence"] = div
    return launches, step_ms, cg_dt(model, cap)


def cg_witness(label, model, cap, steps=2, maxiter=WITNESS_MAXITER):
    """``steps`` steps of a row's model (Δt = min(``cap``, CFL 0.5)) with
    its CG as the row takes it, then one with ``maxiter``: each solve's
    iterations and final residual over ‖b‖, and after each step
    max|∇·u|·Δx/max|u| on the fluid and max|u|. Whether the CG reaches its
    tolerance on the row's own right-hand side given the iterations (the
    partial cells and the open sides' mass balance consistent) and where
    the row's maxiter leaves it; after a step whose every solve converged
    the divergence bound (1e-4) is asserted. Returns the divergence after
    each step."""
    from oceananigans_tpu_torch.solvers.conjugate_gradient import \
        conjugate_gradient as cg
    solver = model.pressure_solver
    row_maxiter = solver.maxiter
    out = []
    try:
        for k in range(steps + 1):
            solver.maxiter = row_maxiter if k < steps else maxiter
            cg.iterations.clear()
            cg.residuals.clear()
            t0 = time.perf_counter()
            model.time_step(cg_dt(model, cap))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            iters, res = list(cg.iterations), list(cg.residuals)
            print(f"  {label} step {model.iteration} (maxiter "
                  f"{solver.maxiter}, reltol {solver.reltol}, {wall:.2f} s): "
                  f"CG iterations {iters}, residual over |b| "
                  + ", ".join(f"{r:.3e}" for r in res))
            out.append(fluid_divergence(
                f"{label} step {model.iteration}", model,
                required=max(iters) < solver.maxiter))
    finally:
        solver.maxiter = row_maxiter
    return out


def profiled_kernel_ms(fn, name, calls=10):
    """The median device duration of the launches of the kernels whose name
    holds ``name`` over ``calls`` calls of ``fn`` (torch.profiler), or None
    where the profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ts = [(e.time_range.end - e.time_range.start) / 1e3
          for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return statistics.median(ts) if ts else None


# phase 28's kernel rows: (its row, the counter of its launches there)
CG_ROWS = {"fill_halos_perturbation": ("D", "fill_halos_perturbation"),
           "fill_halos_immersed": ("E", "fill_halos")}


def cg_phase(card):
    """Phase 28: the NonhydrostaticModel on immersed, multiply stretched and
    curvilinear grids, with open and per-point conditions: the fill checks,
    the small models against the CPU, the golden, rows D and E, and
    witnesses of the rows' CG (``cg_witness``: row D's float32 state given
    5000 iterations, each row's seeded state in float64 given
    ``WITNESS_MAXITER``; row D's witnesses take 1000 and 2000 iterations,
    to fit phase 32 in the script's time). Returns ({kernel
    row: measured}, {row:
    launches})."""
    t0 = time.perf_counter()
    out, launches = {}, {}
    print("the fill with planes and perturbation faces against its plain "
          "version (bit for bit):")
    open_fill_checks()
    print("small models on the card against the CPU (float64, 3 steps, "
          "solvers at reltol 1e-14, 1e-12):")
    cg_model_checks()
    open_radiation_golden()
    torch.cuda.empty_cache()

    nx, nz = SEAMOUNT_N
    label = f"row D, tidal flow over a seamount {nx}x1x{nz}"
    print(f"{label}:")
    model = seamount_model(nx, nz, torch.float32, "cuda")
    assert model.immersed and not model._kernel_tendency
    solver = model.pressure_solver
    print(f"  partial cells, PerturbationAdvection(60, ∞) on both x sides; "
          f"solver immersed CG (maxiter {solver.maxiter}, reltol "
          f"{solver.reltol}), preconditioner "
          f"{'FFT/DCT' if solver.preconditioner else 'none'}")
    launches["D"], step_d, dt = cg_row(card, label, model, SEAMOUNT_DT)
    assert launches["D"]["fill_halos_perturbation"] > 0, "no PA fill launch"
    assert launches["D"]["fill_halos_planes"] > 0, "no plane fill launch"
    open_boundary_flux(label, model)
    fields = dict(model.state["fields"])
    names = ["u", "v", "w", "b"]
    arrays = [fields[c].clone() for c in names]
    lbs = model_locs_bcs(model, names)
    t_d = model.time
    ferr = fill_check(f"{label} u, v, w, b", model.grid, arrays, lbs,
                      time_=t_d, dt=dt / 3)
    out["fill_halos_perturbation"] = time_fill(
        f"{label} u, v, w, b (planes, PA faces)", model.grid, arrays, lbs,
        ferr, time_=t_d, dt=dt / 3)
    # whether more iterations move the float32 solve off its residual
    cg_witness("row D float32", model, SEAMOUNT_DT, steps=0, maxiter=1000)
    del model, fields, arrays
    torch.cuda.empty_cache()
    print(f"{label}: the same seeded state in float64 (a witness of the "
          f"row's solve):")
    model = seamount_model(nx, nz, torch.float64, "cuda",
                           smoothness=torch.float64)
    cg_witness("row D float64", model, SEAMOUNT_DT, steps=1, maxiter=2000)
    del model
    torch.cuda.empty_cache()

    label = f"row E, stratified flow over a hill {HILL_N}"
    print(f"{label}:")
    model = hill_model(HILL_N, torch.float32, "cuda")
    solver = model.pressure_solver
    print(f"  GridFittedBottom; solver immersed CG (maxiter "
          f"{solver.maxiter}, reltol {solver.reltol}), preconditioner "
          f"{'FFT/DCT' if solver.preconditioner else 'none'}")
    launches["E"], step_e, dt = cg_row(card, label, model)
    fields = dict(model.state["fields"])
    names = ["u", "v", "w", "b"]
    arrays = [fields[c].clone() for c in names] + [
        model.state["pressure"].clone()]
    lbs = model_locs_bcs(model, names) + [(("c", "c", "c"), model.bcs["p"])]
    ferr = fill_check(f"{label} u, v, w, b, p", model.grid, arrays, lbs,
                      time_=model.time, dt=dt / 3)
    out["fill_halos_immersed"] = time_fill(
        f"{label} u, v, w, b, p (wrap, bounded z)", model.grid, arrays, lbs,
        ferr, time_=model.time, dt=dt / 3)
    del model, fields, arrays
    torch.cuda.empty_cache()
    print(f"{label}: the same seeded state in float64 (a witness of the "
          f"row's solve):")
    model = hill_model(HILL_N, torch.float64, "cuda",
                       smoothness=torch.float64)
    cg_witness("row E float64", model, None, steps=1)
    del model
    torch.cuda.empty_cache()
    print(f"phase 28 rows: D {step_d:.3f} ms, E {step_e:.3f} ms a step "
          f"[{card}]")
    print(f"phase 28 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    return out, launches


# -- the rest of the single-grid hydrostatic model (phase 29) -----------------------

NEAR_GLOBAL_N = (360, 180, 24)  # row F: examples/near_global_ocean.py at 1°
NEAR_GLOBAL_DT = 1800.0
TIDE_N = (2048, 512)            # row G: examples/internal_tide.py, nx × nz
# the example's Δt = 300 s at its 256 columns, scaled to 2048 (its
# first-mode internal-wave CFL c₁Δt/Δx ≈ 0.2 with c₁ = NH/π): 300 s and
# 60 s grow without bound within 10 and 50 steps at 2048x512, in the JAX
# package as in the port
TIDE_DT = 30.0
TIDE_SMALL_DT = 300.0
HYDRO29_STEPS = (3, 10)         # warm-up and timed steps of each row
# operations of one multi-dimensional filter (advection/multidimensional.py):
# the three smoothness indicators 33, their ε and squares 6, four weighted
# points of 13 (three weights of a division each, their sum 2, three
# divisions, the weighted sum 5), the three stencils' values at the three
# points, 15 a point (the σ± halves of the centre weight the same A2
# values), the σ-split centre 3, the final combination 6
MD_FILTER_FLOP = 145


def near_global_bottom(lam, phi):
    """The example's idealized continents (float64 numpy): two meridional
    barriers rising to land at -60° (north of -55°) and 20° (north of
    -35°), a 1500 m sill in the gap south of -55°, polar shelves of 500 m
    poleward of 71°, 3000 m elsewhere."""
    lam = np.asarray(lam, float)
    phi = np.asarray(phi, float)
    depth = np.full(np.broadcast_shapes(lam.shape, phi.shape), -3000.0)
    barrier1 = (np.abs(lam + 60.0) < 12.0) & (phi > -55.0)
    barrier2 = (np.abs(lam - 20.0) < 15.0) & (phi > -35.0)
    depth = np.where(barrier1 | barrier2, 200.0, depth)
    sill = (np.abs(lam + 60.0) < 12.0) & (phi <= -55.0)
    depth = np.where(sill, -1500.0, depth)
    return np.where(np.abs(phi) > 71.0, np.maximum(depth, -500.0), depth)


def near_global_model(N, dtype, device, smoothness=torch.float32, seed=0,
                      substeps=30):
    """``examples/near_global_ocean.py`` ``build_model`` on the port at N:
    longitude -180..180, latitude -75..75, 3000 m, the idealized continents
    as a GridFittedBottom; WENOVectorInvariant(order=5), WENO(5) b,
    spherical Coriolis, BuoyancyTracer; ClosureTuple(CATKE, horizontal ν =
    1e5, triad GM/Redi κ = 1000, 1000); SplitExplicitFreeSurface(substeps);
    the zonal wind stress, quadratic bottom drag and 30-day buoyancy
    restoring as callable flux conditions. b as the example sets it, u =
    0.02·N(0, 1) from np.random.default_rng(seed)."""
    import math

    import oceananigans_tpu_torch as ot
    H0 = 3000.0
    grid = ot.LatitudeLongitudeGrid(size=N, longitude=(-180, 180),
                                    latitude=(-75, 75), z=(-H0, 0.0),
                                    dtype=dtype, device=device)
    ibg = ot.ImmersedBoundaryGrid(grid, ot.GridFittedBottom(
        near_global_bottom))
    rad = math.pi / 180.0
    dz_top = H0 / N[2]

    def tau_x(lam, phi, t):
        return -1.2e-4 * (-torch.cos(3.0 * (phi * rad))) \
            * torch.cos(phi * rad) ** 2

    def b_flux(lam, phi, t, b):
        b_star = 6.0e-2 * torch.cos(phi * rad) ** 2
        return (1.0 / (86400.0 * 30)) * dz_top * (b - b_star)

    u_bcs = ot.FieldBoundaryConditions(
        top=ot.FluxBoundaryCondition(tau_x),
        bottom=ot.FluxBoundaryCondition(
            lambda lam, phi, t, u: -3e-3 * u * abs(u),
            field_dependencies="u"))
    b_bcs = ot.FieldBoundaryConditions(
        top=ot.FluxBoundaryCondition(b_flux, field_dependencies="b"))
    model = ot.HydrostaticFreeSurfaceModel(
        ibg, tracers=("b",),
        momentum_advection=ot.WENOVectorInvariant(
            order=5, smoothness_dtype=smoothness),
        tracer_advection=ot.WENO(5, smoothness_dtype=smoothness),
        coriolis=ot.HydrostaticSphericalCoriolis(),
        buoyancy=ot.BuoyancyTracer(),
        closure=(ot.CATKEVerticalDiffusivity(buoyancy=ot.BuoyancyTracer()),
                 ot.ScalarDiffusivity(nu=1.0e5, formulation="horizontal"),
                 ot.TriadIsopycnalSkewSymmetricDiffusivity(
                     kappa_skew=1000.0, kappa_symmetric=1000.0,
                     buoyancy=ot.BuoyancyTracer())),
        free_surface=ot.SplitExplicitFreeSurface(substeps=substeps),
        boundary_conditions={"u": u_bcs, "b": b_bcs})
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    model.set(b=lambda lam, phi, z: 6.0e-2 * np.cos(np.deg2rad(phi)) ** 2
              * np.exp(z / 800.0),
              u=0.02 * rng.standard_normal(N).astype(npdt))
    return model


def internal_tide_model(nx, nz, dtype, device, vertical_coordinate="zstar",
                        smoothness=torch.float32, seed=0):
    """``examples/internal_tide.py`` ``main``'s model on the port at nx × 1 ×
    nz: periodic x over ±1000 km, flat y, 2 km deep, a PartialCellBottom
    Gaussian hill (250 m, 20 km), FPlane(latitude=-45), the M2 body force
    on u, BuoyancyTracer b, WENO(5) flux-form momentum and WENO(5) b, the
    default free surface (split-explicit with cfl=0.7: the grid is
    immersed), ``vertical_coordinate``; u = U2 and b = N²z with N² = 1e-4,
    plus 1e-3 U2·N(0, 1) on u from np.random.default_rng(seed)."""
    import math

    import oceananigans_tpu_torch as ot
    H, L, HOUR = 2000.0, 1.0e6, 3600.0
    under = ot.RectilinearGrid(size=(nx, 1, nz), x=(-L, L), y=(0, 1.0),
                               z=(-H, 0.0),
                               topology=("periodic", "flat", "bounded"),
                               dtype=dtype, device=device)
    h0, width = 250.0, 2.0e4
    grid = ot.ImmersedBoundaryGrid(under, ot.PartialCellBottom(
        lambda x, y: -H + h0 * np.exp(-x ** 2 / (2 * width ** 2))))
    coriolis = ot.FPlane(latitude=-45.0)
    omega2 = 2 * math.pi / (12.421 * HOUR)
    U2 = 0.1 * omega2 * width
    A2 = U2 * (omega2 ** 2 - coriolis.f ** 2) / omega2
    forcing = ot.ContinuousForcing(
        lambda x, y, z, t: A2 * math.sin(omega2 * t), loc=("f", "c", "c"))
    model = ot.HydrostaticFreeSurfaceModel(
        grid, coriolis=coriolis, buoyancy=ot.BuoyancyTracer(),
        tracers=("b",),
        momentum_advection=ot.WENO(5, smoothness_dtype=smoothness),
        tracer_advection=ot.WENO(5, smoothness_dtype=smoothness),
        forcing={"u": forcing}, vertical_coordinate=vertical_coordinate)
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    model.set(u=U2 * (1 + 1e-3 * rng.standard_normal((nx, 1, nz))).astype(
        npdt), b=lambda x, y, z: 1e-4 * z)
    return model


def prescribed_model(device, stepper="QuasiAdamsBashforth2"):
    """A tracer-only model over prescribed callable velocities (float64,
    16x8x8, WENO(5) tracers, a vertically implicit diffusivity)."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=(16, 8, 8), x=(0, 1e5), y=(0, 5e4),
                              z=(-1000.0, 0.0),
                              topology=("periodic", "bounded", "bounded"),
                              dtype=torch.float64, device=device)
    vel = ot.PrescribedVelocityFields(
        u=lambda x, y, z, t: 0.1 * (1 + z / 1000.0) + 0 * x,
        v=lambda x, y, z, t: 0.05 * (x / 1e5) + 1e-6 * t + 0 * y,
        w=lambda x, y, z, t: 1e-5 * (x / 1e5) * (z + 1000.0) / 1000.0
        * (-z) / 1000.0 + 0 * y)
    model = ot.HydrostaticFreeSurfaceModel(
        grid, velocities=vel, tracers=("c", "d"), timestepper=stepper,
        tracer_advection=ot.WENO(5, smoothness_dtype=torch.float64),
        closure=ot.VerticalScalarDiffusivity(
            ot.VerticallyImplicitTimeDiscretization(), kappa=1e-3))
    rng = np.random.default_rng(5)
    model.set(c=rng.standard_normal((16, 8, 8)),
              d=lambda x, y, z: np.sin(2 * np.pi * x / 1e5) * z)
    return model


def per_tracer_model(device):
    """A 12x10x6 lat-lon model whose tracers take WENO(5), Centered(4) and
    the dict's default UpwindBiased(3) (float64, split RK3)."""
    import oceananigans_tpu_torch as ot
    grid = ot.LatitudeLongitudeGrid(size=(12, 10, 6), longitude=(0, 60),
                                    latitude=(15, 75), z=(-1800.0, 0.0),
                                    dtype=torch.float64, device=device)
    model = ot.HydrostaticFreeSurfaceModel(
        grid, momentum_advection=ot.VectorInvariant(),
        tracer_advection={"T": ot.WENO(5, smoothness_dtype=torch.float64),
                          "S": ot.Centered(4),
                          "default": ot.UpwindBiased(3)},
        tracers=("T", "S", "c"), timestepper="SplitRungeKutta3",
        free_surface=ot.SplitExplicitFreeSurface(substeps=10))
    rng = np.random.default_rng(3)
    model.set(**{n: rng.standard_normal((12, 10, 6))
                 for n in ("T", "S", "c")},
              u=0.1 * rng.standard_normal((12, 10, 6)))
    return model


def gm_nonhydrostatic_model(device):
    """The NonhydrostaticModel with the advective GM form (float64, 16³,
    WENO(5), b and a tracer c)."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=(16, 16, 16), x=(0, 8e3), y=(0, 8e3),
                              z=(-400.0, 0.0), dtype=torch.float64,
                              device=device)
    model = ot.NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=torch.float64),
        buoyancy=ot.BuoyancyTracer(), tracers=("b", "c"),
        closure=ot.IsopycnalSkewSymmetricDiffusivity(
            kappa_redi=20.0, kappa_gm=40.0,
            skew_flux_formulation="advective"))
    rng = np.random.default_rng(4)
    model.set(b=lambda x, y, z: 1e-4 * z + 1e-6 * x + 1e-7 * y,
              c=rng.standard_normal((16, 16, 16)),
              u=0.01 * rng.standard_normal((16, 16, 16)))
    return model


HYDRO29_SMALL = {
    "row F's construction 48x24x8": (
        lambda d: near_global_model((48, 24, 8), torch.float64, d,
                                    smoothness=torch.float64),
        NEAR_GLOBAL_DT),
    "row G's construction 64x1x32 on z*": (
        lambda d: internal_tide_model(64, 32, torch.float64, d,
                                      smoothness=torch.float64),
        TIDE_SMALL_DT),
    "row G's construction 64x1x32 on z": (
        lambda d: internal_tide_model(64, 32, torch.float64, d, "z",
                                      smoothness=torch.float64),
        TIDE_SMALL_DT),
    "prescribed velocities (quasi-AB2)": (prescribed_model, 900.0),
    "prescribed velocities (split RK3)": (
        lambda d: prescribed_model(d, "SplitRungeKutta3"), 900.0),
    "per-tracer schemes": (per_tracer_model, 600.0),
    "NonhydrostaticModel, advective GM": (gm_nonhydrostatic_model, 10.0),
}


def hydro29_small_checks():
    """Each small float64 model of HYDRO29_SMALL on the card against the
    same model on the CPU over 3 steps: every prognostic field and w within
    1e-10 of its scale; the fill kernel launches on the card and no plain
    fill runs there."""
    from oceananigans_tpu_torch import kernels as K
    for label, (make, dt) in HYDRO29_SMALL.items():
        K.reset_counters()
        card_model, cpu_model = make("cuda"), make("cpu")
        for _ in range(3):
            card_model.time_step(dt)
            cpu_model.time_step(dt)
        launches, plain = K.counters()
        worst = 0.0
        for name in tuple(card_model.prognostic_names) + ("w",):
            a = card_model.field(name).interior.cpu()
            b = cpu_model.field(name).interior
            scale = b.abs().max().item()
            rel = (a - b).abs().max().item() / max(scale, 1e-300)
            assert rel <= 1e-10, (label, name, rel)
            worst = max(worst, rel)
        fills = {k: v for k, v in plain.items() if "fill" in k and v}
        assert launches["fill_halos"] > 0 and not fills, (label, fills)
        print(f"  {label}: card against CPU after 3 steps, worst rel "
              f"{worst:.3e} (bound 1e-10); fill launches "
              f"{launches['fill_halos']}, no plain fill")
        del card_model, cpu_model
    torch.cuda.empty_cache()


def hydro29_shares(model, dt, steps, card, label):
    """Per-step CUDA-event times of a phase-29 step: the closure (its
    diffusivities and terms at the tendencies), z*'s σ work (σ, the
    barotropic transports and ∂t_σ), the tendency (#10 or its plain
    version, which also takes z*, flux-form momentum and per-tracer
    schemes), the
    split-explicit substep loop (its fills included), the implicit
    vertical solve, step_turbulence, the fills outside the substep loop,
    and the rest (pₕ′, w, forcing, the boundary fluxes, AB2 and the
    σ-weighted update, the corrector, the masks, allocations, host
    gaps)."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    import oceananigans_tpu_torch.models.hydrostatic as hs
    timer = PhaseTimer()
    saved = (hs.fused_vi_tendency, hs.fused_vi_tendency_plain,
             hf.fill_halos)
    hs.fused_vi_tendency = timer.wrap("tendency", saved[0])
    hs.fused_vi_tendency_plain = timer.wrap("tendency", saved[1])
    hf.fill_halos = timer.wrap("fills", saved[2])
    wrapped = [(model.free_surface, "substep", "substep"),
               (model, "_implicit_solve", "implicit")]
    if model.closure is not None:
        wrapped += [(model.closure, n, "closure") for n in (
            "compute_diffusivities", "momentum_tendencies",
            "tracer_tendency", "tracer_tendency_excluding_tke")
            if hasattr(model.closure, n)]
        if getattr(model.closure, "substepped_tke", False):
            wrapped.append((model.closure, "step_turbulence", "turbulence"))
    if model.vertical_coordinate == "zstar":
        wrapped += [(model, n, "zstar") for n in (
            "_sigma_fields", "_zstar_transports", "_grid_motion_rate")]
    wrapped.append((model, "time_step", "step"))
    for obj, name, phase in wrapped:
        setattr(obj, name, timer.wrap(phase, getattr(obj, name)))
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        hs.fused_vi_tendency, hs.fused_vi_tendency_plain, hf.fill_halos = \
            saved
        for obj, name, _ in wrapped:
            delattr(obj, name)
    g = t.get
    tendency = ("fused_vi_tendency kernel (#10)" if model.uses_kernel
                else "plain tendency (advection, Coriolis, ∂pₕ′)")
    outside = lambda k: g(k, 0.0) - sum(
        g(f"{k}@{o}", 0.0) for o in ("turbulence", "substep", "implicit"))
    shares = {
        tendency: g("tendency", 0.0),
        "closure (diffusivities and terms at the tendencies)":
            outside("closure"),
        "z* σ work (σ, barotropic transports, ∂t_σ)": outside("zstar"),
        "split-explicit substep loop (its fills included)":
            g("substep", 0.0),
        "implicit vertical solve": g("implicit", 0.0),
        "step_turbulence (TKE substeps)": g("turbulence", 0.0),
        "fills (outside the substep loop)":
            g("fills", 0.0) - g("fills@substep", 0.0)
            - g("fills@zstar", 0.0),
    }
    shares["rest (pₕ′, w, forcing, boundary fluxes, AB2, the σ-weighted "
           "update, corrector, masks, allocations, host gaps)"] = \
        t["step"] - sum(shares.values())
    print(f"{label} step phases, ms per step over {steps} steps (CUDA "
          f"events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.1f}%)")
    print(f"  step: {t['step']:.4f} ms")
    return shares


def hydro29_row(card, label, model, dt, expect_kernel):
    """``HYDRO29_STEPS`` warm-up and timed steps of Δt with the counters
    reset just before and read just after: #10 once a step where the row
    takes it (else the plain tendency once a step), the fill kernel, no
    other plain function on CUDA tensors; finite fields; the step
    median, min and max, peak memory, the phase shares (3 steps), the busy
    share and the device kernels per step (3 steps). Returns (launches,
    plain calls on CUDA, step median ms)."""
    from oceananigans_tpu_torch import kernels as K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    warmup, timed = HYDRO29_STEPS
    for _ in range(warmup):
        model.time_step(dt)
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain = K.counters()
    steps = warmup + timed
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} launches over {steps} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain.items() if v} }")
    assert launches["fused_vi_tendency"] == (steps if expect_kernel else 0), \
        (label, launches["fused_vi_tendency"])
    assert launches["fill_halos"] > 0, (label, "no fill launch")
    for name, count in plain.items():
        want = steps if (name == "fused_vi_tendency_plain"
                         and not expect_kernel) else 0
        assert count == want, (f"plain {name} ran {count} times on CUDA "
                               f"tensors, not {want} ({label})")
    for name in tuple(model.prognostic_names) + ("w",):
        assert torch.isfinite(model.field(name).interior).all().item(), \
            (label, f"{name} is not finite")
    step_ms = statistics.median(times) * 1e3
    n = int(np.prod(model.grid.N))
    print(f"{label}: step median {step_ms:.3f} ms over {timed} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), Δt {dt} s, "
          f"{n / (step_ms / 1e3):.4e} cell-updates/s; peak device memory "
          f"(steps) {peak / 2 ** 30:.2f} GiB [{card}]")
    print(f"{label}: launches per step "
          f"{ {k: v / steps for k, v in launches.items() if v} }")
    hydro29_shares(model, dt, 3, card, label)
    busy_share(label, model, dt, 3, step_ms, card)
    return launches, plain, step_ms


def hydro29_fill(label, model, names):
    """The fill against its plain version on a row's own fields (bit for
    bit), timed: a measured row."""
    fields = dict(model.state["fields"])
    arrays = [fields[n].clone() for n in names]
    lbs = model_locs_bcs(model, names)
    err = fill_check(f"{label} {', '.join(names)}", model.grid, arrays, lbs)
    return time_fill(f"{label} {', '.join(names)}", model.grid, arrays, lbs,
                     err)


def hydro29_phase(card):
    """Phase 29: the rest of the single-grid hydrostatic model. The small
    float64 models on the card against the CPU; row F, the near-global
    ocean at 1° (the plain tendency on its immersed grid, triads and CATKE,
    the substep loop, the fill on 3-D fields and η, U, V); row G, the
    internal tide on z* at 2048x1x512 (flux-form momentum, σ updates, the
    fill on a bounded z with a flat y); row H, the hydro_row with the
    multi-dimensional stencil (#10's md variant, H = 8). Returns ({kernel
    row: measured}, {row: launches})."""
    from oceananigans_tpu_torch.kernels import build
    from oceananigans_tpu_torch.kernels import fused_vector_invariant as fvi
    t0 = time.perf_counter()
    out, launches = {}, {}
    print("small float64 models on the card against the CPU (3 steps, "
          "1e-10):")
    hydro29_small_checks()

    label = f"row F, near-global ocean {NEAR_GLOBAL_N}"
    print(f"{label}:")
    model = near_global_model(NEAR_GLOBAL_N, torch.float32, "cuda")
    assert not model.uses_kernel and model._immersed
    print(f"  halo {model.grid.H}, {int(model.grid.solid_ccc.sum())} solid "
          f"cells (halos included), closure {model.closure!r}, "
          f"SplitExplicitFreeSurface(substeps=30), Δt {NEAR_GLOBAL_DT} s")
    launches["F"], _, step_f = hydro29_row(card, label, model,
                                           NEAR_GLOBAL_DT, False)
    b = model.field("b").interior
    print(f"{label}: max|u| {model.field('u').interior.abs().max().item():.4e}"
          f", b in [{b.min().item():.4e}, {b.max().item():.4e}], max|η| "
          f"{model.field('eta').interior.abs().max().item():.4e} after "
          f"{model.iteration} steps")
    out["fill_halos_near_global"] = hydro29_fill(label, model,
                                                 ["u", "v", "b", "e"])
    del model
    torch.cuda.empty_cache()

    nx, nz = TIDE_N
    label = f"row G, internal tide on z* {nx}x1x{nz}"
    print(f"{label}:")
    model = internal_tide_model(nx, nz, torch.float32, "cuda")
    assert not model.uses_kernel and model.vertical_coordinate == "zstar"
    fs = model.free_surface
    frac, weights = fs.settings(TIDE_DT)
    print(f"  halo {model.grid.H}, default free surface "
          f"{type(fs).__name__}(cfl=0.7): {round(2 / frac)} substeps for Δt "
          f"= {TIDE_DT} s")
    launches["G"], _, step_g = hydro29_row(card, label, model, TIDE_DT,
                                           False)
    eta_g = model.state["eta_grid"]
    sig = model._sigma_fields(eta_g)[("c", "c")]
    w = model.field("w").interior
    print(f"{label}: σ in [{sig.min().item():.6f}, {sig.max().item():.6f}], "
          f"max|w| {w.abs().max().item():.4e} after {model.iteration} steps")
    out["fill_halos_internal_tide"] = hydro29_fill(label, model,
                                                   ["u", "v", "b"])
    del model
    torch.cuda.empty_cache()

    print("bf16 smoothness in #10's multi-dimensional stencil family:")
    vi_bf16_checks(md=True)
    label = f"row H, hydro_row with the multi-dimensional stencil {HYDRO_N}"
    print(f"{label}:")
    model = hydro_model(HYDRO_N, torch.float32, "cuda",
                        multi_dimensional_stencil=True)
    assert model.uses_kernel and model.grid.H[0] == 8, model.grid.H
    vi_plan_report(f"#10 {label} float32", model.grid,
                   model.momentum_advection, model.tracer_advection, 1,
                   model.coriolis)
    # the stencil's family (MD true: its lean and full variants) at the
    # configuration's KM
    entries = ptxas_entries(build.compile_log, ("vi_tendency_kernel",))
    names = demangle(list(entries))
    cfg = fvi.vi_config(model.grid, model.momentum_advection,
                        model.tracer_advection, 1, model.coriolis)
    for mangled, (regs, st, ld) in entries.items():
        if any(f"<float, float, {cfg['KM']}, {full}, true>" in names[mangled]
               for full in ("false", "true")):
            print(f"  ptxas {names[mangled][:110]}: {regs} registers, "
                  f"spills {st} / {ld} B")
    model.time_step(120.0)
    out["fused_vi_tendency_md"] = vi_row_kernel(
        f"{label} (after one step: T, no pₕ′)", stretched_row_state(model))
    del model
    torch.cuda.empty_cache()
    model = hydro_model(HYDRO_N, torch.float32, "cuda",
                        multi_dimensional_stencil=True)
    launches["H"], _, step_h = hydro29_row(card, label, model, 120.0, True)
    variant = "fused_vi_tendency_" + fvi.variant_name(cfg)
    assert variant == "fused_vi_tendency_k5_md", variant
    assert launches["H"][variant] == launches["H"]["fused_vi_tendency"], \
        (label, variant, launches["H"][variant])
    del model
    torch.cuda.empty_cache()
    print(f"phase 29 rows: F {step_f:.3f} ms, G {step_g:.3f} ms, H "
          f"{step_h:.3f} ms a step [{card}]")
    print(f"phase 29 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    return out, launches


# -- the cubed sphere and the rest of shallow water (phase 30) ----------------------

CS_ROW_N = (64, 32)       # row I: bench_extra.py cs_row, 6×64×64×32
CS_ROW_DT = 600.0
CS_GLOBAL_N = (96, 32)    # row J: examples/global_cubed_sphere_ocean.py at C96
BICKLEY_N = (1024, 2048)  # row K: examples/shallow_water_bickley_jet.py
# gravity waves of speed √(gH) = √10 cross Δx = 2π/1024 in 1.9e-3 s
BICKLEY_DT = 5e-4
CS_SW_N = 256             # row L: Williamson test case 2 on 6×256×256
CS30_STEPS = {"I": (3, 20), "J": (2, 5), "K": (3, 20), "L": (3, 20)}
R_EARTH, OMEGA_EARTH = 6.371e6, 7.292e-5


def cs_row_model(N, nz, dtype, device, **kw):
    """bench_extra.py ``cs_row``'s configuration: 6×N×N×nz to 3000 m, b,
    rotation, split-explicit with 20 substeps (keywords override)."""
    import oceananigans_tpu_torch as ot
    kw = {"free_surface": "split_explicit", "substeps": 20, **kw}
    if kw["free_surface"] != "split_explicit":
        kw.pop("substeps")
    grid = ot.ConformalCubedSphereGrid((N, N, nz), z=(-3000.0, 0.0),
                                       radius=R_EARTH, dtype=dtype,
                                       device=device)
    m = ot.CubedSphereHydrostaticModel(grid, tracers=("b",),
                                       rotation_rate=OMEGA_EARTH, **kw)
    m.set(b=lambda lam, phi, z: 1e-5 * z
          + 1e-4 * np.exp(-(lam ** 2 + phi ** 2) / 0.2))
    m.set_geographic(u_east=lambda lam, phi: 5.0 * np.cos(phi))
    return m


def cs_global_bottom(lam, phi):
    """The example's idealized continent and mid-ocean ridge (radians)."""
    continent = 2800.0 * np.exp(-((lam - 1.2) ** 2 + (phi - 0.3) ** 2) / 0.18)
    ridge = 1200.0 * np.exp(-(lam + 1.8) ** 2 / 0.05)
    return -3000.0 + continent + ridge


def cs_global_model(N, nz, dtype, device, smoothness=torch.float32):
    """examples/global_cubed_sphere_ocean.py's configuration: halo 4,
    WENOVectorInvariant(order=5), WENO(5) tracers b and c, CATKE + GM/Redi
    triads, the continent-and-ridge GridFittedBottom, wind stress and a
    buoyancy flux (callables of the panels' (λ°, φ°)), split-explicit with
    20 substeps; the balanced jet, stratification and a tracer blob."""
    import oceananigans_tpu_torch as ot
    H0, U = 3000.0, 5.0
    grid = ot.ConformalCubedSphereGrid((N, N, nz), z=(-H0, 0.0),
                                       radius=R_EARTH, halo=4, dtype=dtype,
                                       device=device)
    closure = ot.closures.ClosureTuple(
        ot.CATKEVerticalDiffusivity(buoyancy=ot.BuoyancyTracer()),
        ot.TriadIsopycnalSkewSymmetricDiffusivity(
            kappa_skew=1000.0, kappa_symmetric=1000.0,
            buoyancy=ot.BuoyancyTracer()))
    bcs = {"u": ot.FieldBoundaryConditions(top=ot.FluxBoundaryCondition(
        lambda lam, phi, t: -1e-4 * torch.cos(3.0 * phi))),
        "b": ot.FieldBoundaryConditions(top=ot.FluxBoundaryCondition(
            lambda lam, phi, t: 3e-9 * torch.cos(phi)))}
    m = ot.CubedSphereHydrostaticModel(
        grid, tracers=("b", "c"), rotation_rate=OMEGA_EARTH, gravity=9.81,
        momentum_advection=ot.WENOVectorInvariant(
            order=5, smoothness_dtype=smoothness),
        tracer_advection=ot.WENO(5, smoothness_dtype=smoothness),
        closure=closure, bottom_height=cs_global_bottom,
        free_surface="split_explicit", substeps=20, boundary_conditions=bcs)
    m.set_geographic(u_east=lambda lam, phi: U * np.cos(phi),
                     v_north=lambda lam, phi: 0.0 * lam)
    m.set(eta=lambda lam, phi: -(R_EARTH * OMEGA_EARTH * U + 0.5 * U * U)
          * np.sin(phi) ** 2 / 9.81,
          b=lambda lam, phi, z: 1e-5 * z + 2e-4
          * np.exp(-((lam - np.pi / 4) ** 2 + phi ** 2) / 0.1)
          * np.exp(-((z + H0 / 2) / (H0 / 4)) ** 2),
          c=lambda lam, phi, z: np.exp(-((lam + np.pi / 2) ** 2
                                         + phi ** 2) / 0.15))
    return m


def cs_global_dt(N):
    """The example's Δt: 0.02 Δx_min/U, at most 1200 s."""
    return min(0.02 * (2 * np.pi * R_EARTH / (4 * N) * 0.6) / 5.0, 1200.0)


def bickley_model(nx, ny, dtype, device, smoothness=torch.float32, **kw):
    """examples/shallow_water_bickley_jet.py's configuration at nx×ny:
    periodic x on [0, 2π], bounded y on [-10, 10], WENO(5), FPlane(1),
    g = 1; the balanced jet ū = sech²y, h̄ = 10 - tanh y with seeded
    noise."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=(nx, ny), x=(0, 2 * np.pi), y=(-10, 10),
                              topology=("periodic", "bounded", "flat"),
                              dtype=dtype, device=device)
    m = ot.ShallowWaterModel(grid, coriolis=ot.FPlane(f=1.0),
                             gravitational_acceleration=1.0,
                             advection=ot.WENO(5,
                                               smoothness_dtype=smoothness),
                             **kw)
    rng = np.random.default_rng(42)
    Y = np.broadcast_to(-10 + (np.arange(ny) + 0.5) * 20.0 / ny, (nx, ny))
    hbar = 10.0 - np.tanh(Y)
    ubar = 1.0 / np.cosh(Y) ** 2
    noise = 1e-4 * np.exp(-Y ** 2) * rng.standard_normal((nx, ny))
    init = dict(uh=(ubar + noise) * hbar, h=hbar)
    if "c" in m.tracer_names:
        init["c"] = np.exp(-Y ** 2)
    m.set(**init)
    return m


def cs_sw_model(N, dtype, device):
    """Williamson et al. (1992) test case 2 on 6×N×N (U = 2πa/12 days,
    gh₀ = 2.94e4 m²/s²)."""
    import oceananigans_tpu_torch as ot
    a, g = 6.37122e6, 9.80616
    U, H0 = 2 * np.pi * a / (12 * 86400.0), 2.94e4 / 9.80616
    grid = ot.ConformalCubedSphereGrid((N, N), radius=a, dtype=dtype,
                                       device=device)
    m = ot.CubedSphereShallowWaterModel(grid, gravity=g,
                                        rotation_rate=OMEGA_EARTH)
    m.set_geographic(
        h=lambda lam, phi: H0 - (a * OMEGA_EARTH * U + 0.5 * U ** 2)
        * np.sin(phi) ** 2 / g,
        u_east=lambda lam, phi: U * np.cos(phi),
        v_north=lambda lam, phi: 0.0 * lam)
    return m


def cs_sw_dt(N):
    a, g, H0 = 6.37122e6, 9.80616, 2.94e4 / 9.80616
    return 0.3 * (2 * np.pi * a / (4 * N) * 0.6) / np.sqrt(g * H0)


def cs30_small_configs():
    """{label: (a function of the device that makes the model, Δt)} of
    the float64 card-against-CPU checks."""
    import oceananigans_tpu_torch as ot
    f64 = torch.float64
    out = {}
    for fs, stepper in (("explicit", "WickerSkamarockRK3"),
                        ("explicit", "QuasiAdamsBashforth2"),
                        ("implicit", "WickerSkamarockRK3"),
                        ("implicit", "QuasiAdamsBashforth2"),
                        ("split_explicit", "QuasiAdamsBashforth2")):
        for batch in (True, False):
            kw = dict(free_surface=fs, timestepper=stepper,
                      batch_panels=batch)
            if fs == "implicit":
                kw["implicit_solver_tol"] = 1e-13
            label = (f"6x12x12x4 {fs} {stepper} "
                     f"{'batched' if batch else 'per panel'}")
            out[label] = (lambda d, _kw=kw: cs_row_model(12, 4, f64, d,
                                                         **_kw), 600.0)
    out["6x12x12x4 immersed, CATKE + triads (the example at C12)"] = (
        lambda d: cs_global_model(12, 4, f64, d, smoothness=f64),
        cs_global_dt(12))
    out["6x12x12x4 z*"] = (lambda d: cs_row_model(
        12, 4, f64, d, vertical_coordinate="zstar"), 600.0)
    out["shallow water 6x12x12 (TC2)"] = (
        lambda d: cs_sw_model(12, f64, d), cs_sw_dt(12))
    forcing = {"uh": ot.ContinuousForcing(
        lambda x, y, z, t: 1e-3 * torch.sin(x))}
    bcs = {"c": ot.FieldBoundaryConditions(
        south=ot.ValueBoundaryCondition(0.5))}
    out["Bickley jet 64x96, closure, forcing, Value condition"] = (
        lambda d: bickley_model(64, 96, f64, d, smoothness=f64,
                                tracers=("c",),
                                closure=ot.ScalarDiffusivity(nu=1e-3,
                                                             kappa=1e-3),
                                forcing=forcing, boundary_conditions=bcs),
        1e-2)
    return out


def cs30_fields(model):
    """{name: interior tensor} of a phase-30 model's outputs (w too on the
    hydrostatic model)."""
    names = (("u", "v", "eta") + model.tracer_names + ("w",)
             if hasattr(model, "diagnose_w") else model.prognostic_names)
    return {n: model.field(n).interior for n in names}


def zstar_w_scale(model):
    """The scale of a z* model's w: its divergence part, the continuity
    integral without the grid's motion. The grid-relative w is the
    difference of that part and the motion, about 1e4 times smaller than
    either on the 6×12×12×4 model (8.7e-8 against 9.0e-4 m/s after 3
    steps on the CPU), so its roundoff is measured against that part."""
    L, f = model._L, model.state["fields"]
    sf = model._filled({n: L(f[n]) for n in ("u", "v", "eta")
                        + model.tracer_names}, model.state["clock"]["time"])
    sig = model._sigma_all(model.exchange.centers(
        L(model.state["eta_grid"])))
    w = model._P(model._w(sf, sigma=sig))
    H, N = model.grid.H[0], model.grid.N[0]
    g0 = model.grid.panel_grids[0]
    return w[:, H:H + N, H:H + N, g0.H[2]:g0.H[2] + g0.N[2]].abs().max()


def cs30_small_checks():
    """Each small float64 model on the card against the same model on the
    CPU over 3 steps: every output within 1e-10 of its scale (a z* model's
    w of its divergence part's, ``zstar_w_scale``); no plain fill on the
    card, and the fill kernel launched wherever the model fills."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    for label, (make, dt) in cs30_small_configs().items():
        K.reset_counters()
        card_model, cpu_model = make("cuda"), make("cpu")
        for _ in range(3):
            card_model.time_step(dt)
            cpu_model.time_step(dt)
        launches, plain = K.counters()
        worst = 0.0
        card, cpu = cs30_fields(card_model), cs30_fields(cpu_model)
        for name, b in cpu.items():
            a = card[name].cpu()
            scale = b.abs().max().item()
            if name == "w" and getattr(cpu_model, "vertical_coordinate",
                                       "z") == "zstar":
                scale = zstar_w_scale(cpu_model).item()
                print(f"  {label}: w's scale {b.abs().max().item():.3e}, "
                      f"its divergence part's {scale:.3e} (the check's)")
            rel = (a - b).abs().max().item() / max(scale, 1e-300)
            assert rel <= 1e-10, (label, name, rel)
            worst = max(worst, rel)
        fills = {k: v for k, v in plain.items() if "fill" in k and v}
        assert not fills, (label, fills)
        # the cubed-sphere shallow water (flat z) fills nothing
        assert launches["fill_halos"] > 0 or isinstance(
            card_model, ot.CubedSphereShallowWaterModel), label
        print(f"  {label}: card against CPU after 3 steps, worst rel "
              f"{worst:.3e} (bound 1e-10); fill launches "
              f"{launches['fill_halos']}, no plain fill")
        del card_model, cpu_model
    torch.cuda.empty_cache()


def cs30_shares(model, dt, steps, card, label):
    """Per-step CUDA-event times of a phase-30 step's pieces: the tendency
    (the plain tendency call, its closure part apart), the panel exchange
    (gathers), the fills (the fill kernel: z halos on the cubed sphere,
    x and y on the Bickley jet), the split-explicit substep loop (its
    exchanges included), the implicit solves (vertical diffusion, the
    CG free surface), the substepped TKE, and the rest."""
    import oceananigans_tpu_torch.kernels.halo_fill as hf
    timer = PhaseTimer()
    saved = hf.fill_halos
    hf.fill_halos = timer.wrap("fills", saved)
    tend = "_tendencies" if hasattr(model, "_tendencies") \
        else "_compute_tendencies"
    wrapped = [(model, tend, "tendency"), (model, "time_step", "step")]
    ex = getattr(model.grid, "exchange", None)
    if ex is not None:
        wrapped += [(ex, n, "exchange") for n in ("centers", "velocities",
                                                  "sync")]
    for name, phase in (("_split_explicit_substep", "substep"),
                        ("_implicit_all", "implicit"),
                        ("_implicit_eta_step", "implicit"),
                        ("_step_turbulence", "turbulence")):
        if hasattr(model, name):
            wrapped.append((model, name, phase))
    closure = getattr(model, "closure", None)
    if closure is not None:
        wrapped += [(closure, n, "closure") for n in (
            "compute_diffusivities", "momentum_tendencies",
            "tracer_tendency", "tracer_tendency_excluding_tke")
            if hasattr(closure, n)]
    for obj, name, phase in wrapped:
        setattr(obj, name, timer.wrap(phase, getattr(obj, name)))
    try:
        for _ in range(steps):
            model.time_step(dt)
        t = {k: v / steps for k, v in timer.totals().items()}
    finally:
        hf.fill_halos = saved
        for obj, name, _ in wrapped:
            delattr(obj, name)
    g = lambda k: t.get(k, 0.0)  # noqa: E731
    shares = {
        "tendency (plain: advection, Coriolis, ∂pₕ′, forcing, fluxes)":
            g("tendency") - g("closure@tendency") - g("exchange@tendency")
            - g("fills@tendency"),
        "closure (diffusivities and terms at the tendencies)":
            g("closure@tendency"),
        "panel exchange (outside the substep loop)":
            g("exchange") - g("exchange@substep"),
        "fills (the fill kernel)": g("fills") - g("fills@substep"),
        "split-explicit substep loop (its exchanges included)":
            g("substep"),
        "implicit solves (vertical diffusion, CG free surface)":
            g("implicit") - g("exchange@implicit") - g("fills@implicit"),
        "step_turbulence (TKE substeps)": g("turbulence")
            - g("exchange@turbulence") - g("fills@turbulence"),
    }
    shares["rest (w, pₕ′, vertex fix, AB2/RK3 updates, corrector, masks, "
           "allocations, host gaps)"] = t["step"] - sum(shares.values())
    print(f"{label} step phases, ms per step over {steps} steps (CUDA "
          f"events) [{card}]:")
    for phase, ms in shares.items():
        print(f"  {phase}: {ms:.4f} ms ({100 * ms / t['step']:.1f}%)")
    print(f"  step: {t['step']:.4f} ms")
    return shares


def cs30_row(card, label, model, dt, steps, expect_fill=True):
    """Warm-up and timed steps of Δt with the counters reset just before
    and read just after: the fill kernel launched (where the model fills),
    no plain fill on CUDA tensors; finite outputs; the step median, min and
    max, peak memory, launches per step, the shares (3 steps) and the busy
    share (3 steps). Returns (launches, step median ms)."""
    from oceananigans_tpu_torch import kernels as K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    warmup, timed = steps
    for _ in range(warmup):
        model.time_step(dt)
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain = K.counters()
    n = warmup + timed
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} launches over {n} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain.items() if v} }")
    if expect_fill:
        assert launches["fill_halos"] > 0, (label, "no fill launch")
    fills = {k: v for k, v in plain.items() if "fill" in k and v}
    assert not fills, (label, "plain fill on CUDA tensors", fills)
    for name, a in cs30_fields(model).items():
        assert torch.isfinite(a).all().item(), (label, f"{name} not finite")
    step_ms = statistics.median(times) * 1e3
    ex = getattr(getattr(model, "grid", None), "exchange", None)
    print(f"{label}: step median {step_ms:.3f} ms over {timed} steps (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), Δt {dt} s; "
          f"peak device memory (steps) {peak / 2 ** 30:.2f} GiB [{card}]")
    print(f"{label}: launches per step "
          f"{ {k: v / n for k, v in launches.items() if v} }"
          + (f"; exchange gathers per step {ex.gathers / n:.1f}"
             if ex is not None else ""))
    if ex is not None:
        ex.gathers = 0
    cs30_shares(model, dt, 3, card, label)
    busy_share(label, model, dt, 3, step_ms, card)
    return launches, step_ms


def cs30_fill(label, grid, fields, lbs):
    """The fill against its plain version on a row's own fields (bit for
    bit), timed, with its bound."""
    arrays = [f.clone() for f in fields]
    err = fill_check(label, grid, arrays, lbs)
    return time_fill(label, grid, arrays, lbs, err)


def cs30_phase(card):
    """Phase 30: the cubed sphere and the rest of shallow water. The small
    float64 models on the card against the CPU; row I, bench_extra.py's
    cs_row (6×64×64×32, split-explicit); row J, the global cubed-sphere
    ocean at C96 with 32 levels; row K, the Bickley jet at 1024×2048
    (bounded y: the plain tendency, the fill's wrap and bounded y); row L,
    the cubed-sphere shallow water (TC2) at 6×256×256. Returns ({kernel
    row: measured}, {row: launches})."""
    t0 = time.perf_counter()
    out, launches, steps_ms = {}, {}, {}
    print("small float64 models on the card against the CPU (3 steps, "
          "1e-10):")
    cs30_small_checks()

    def hydro_fill(label, model, names):
        cp = model._catp
        fields = [model._c(model.state["fields"][n]) for n in names]
        return cs30_fill(f"{label} (z halos of the concatenated panels)",
                         cp.grid, fields,
                         [(cp.loc(n), cp.bcs[n]) for n in names])

    N, nz = CS_ROW_N
    label = f"row I, cs_row 6x{N}x{N}x{nz}"
    print(f"{label}:")
    model = cs_row_model(N, nz, torch.float32, "cuda")
    print(f"  halo {model.grid.H}, concatenated grid "
          f"{model._catp.grid.padded_shape}, {model.timestepper}, "
          f"SplitExplicitFreeSurface(substeps=20), Δt {CS_ROW_DT} s")
    launches["I"], steps_ms["I"] = cs30_row(card, label, model, CS_ROW_DT,
                                            CS30_STEPS["I"])
    out["fill_halos_cs_row"] = hydro_fill(label, model, ["u", "v", "b"])
    del model
    torch.cuda.empty_cache()

    N, nz = CS_GLOBAL_N
    label = f"row J, global cubed-sphere ocean 6x{N}x{N}x{nz}"
    print(f"{label}:")
    model = cs_global_model(N, nz, torch.float32, "cuda")
    dt = cs_global_dt(N)
    print(f"  halo {model.grid.H}, {int(model._catp.grid.solid_ccc.sum())} "
          f"solid cells (halos included), closures "
          f"{[type(c).__name__ for c in model.closure.closures]}, "
          f"SplitExplicitFreeSurface(substeps=20), Δt {dt:.1f} s")
    launches["J"], steps_ms["J"] = cs30_row(card, label, model, dt,
                                            CS30_STEPS["J"])
    u = model.field("u").interior
    e = model.field("e").interior
    print(f"{label}: max|u| {u.abs().max().item():.4e}, max e "
          f"{e.max().item():.4e} after {model.iteration} steps")
    out["fill_halos_cs_global"] = hydro_fill(label, model,
                                             ["u", "v", "b", "c", "e"])
    del model
    torch.cuda.empty_cache()

    nx, ny = BICKLEY_N
    label = f"row K, Bickley jet {nx}x{ny}"
    print(f"{label}:")
    model = bickley_model(nx, ny, torch.float32, "cuda")
    assert not model.fused
    print(f"  halo {model.grid.H}, topology {model.grid.topology}, the plain "
          f"tendency (the fused stage refuses the bounded y), Δt "
          f"{BICKLEY_DT}")
    launches["K"], steps_ms["K"] = cs30_row(card, label, model, BICKLEY_DT,
                                            CS30_STEPS["K"])
    names = list(model.prognostic_names)
    out["fill_halos_bickley"] = cs30_fill(
        f"{label} ({', '.join(names)}: the x wrap and the bounded y)",
        model.grid, [model.state["fields"][n] for n in names],
        [(model.loc(n), model.bcs[n]) for n in names])
    del model
    torch.cuda.empty_cache()

    label = f"row L, cubed-sphere shallow water 6x{CS_SW_N}x{CS_SW_N}"
    print(f"{label}:")
    model = cs_sw_model(CS_SW_N, torch.float32, "cuda")
    print(f"  halo {model.grid.H}, {model.pv_scheme} PV flux, Wicker-"
          f"Skamarock RK3, Δt {cs_sw_dt(CS_SW_N):.1f} s")
    m0 = model.total_mass()
    launches["L"], steps_ms["L"] = cs30_row(card, label, model,
                                            cs_sw_dt(CS_SW_N),
                                            CS30_STEPS["L"],
                                            expect_fill=False)
    print(f"{label}: relative mass change "
          f"{(model.total_mass() - m0) / m0:.3e} after {model.iteration} "
          f"steps (float32)")
    del model
    torch.cuda.empty_cache()
    print("phase 30 rows: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in steps_ms.items()) + f" a step [{card}]")
    print(f"phase 30 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    return out, launches


# -- phase 31: the long tail (operations, the bounded #6, particles, ensembles) --

P31_STEPS = (2, 5)           # warm-up and timed steps of paths (a), (c), (d)
EXAMPLE_N = 8192             # (a) examples/two_dimensional_turbulence.py, n²
BOUNDED_N = 256              # (b) the bounded tracer, n³
BOUNDED_SMALL_N = 24         # (b) the float64 checks, n³
BOUNDED_STEPS = (5, 15)      # (b) warm-up and timed: 20 steps in all
BOUNDED_CFL = 0.1            # (b) Σ|u|Δt/Δ over the three axes
PARTICLES_N = 256            # (c) the flagship, n³
N_PARTICLES = 2 ** 20        # (c)
ENSEMBLE_MEMBERS = 4         # (d) members of the 512x256x32 hydrostatic row
ENSEMBLE_DT = 120.0
# The limiter's operations per tracer cell and axis, counted from
# csrc/bounded_limiter.cuh: θ (p̃: 2 products, 2 differences, a division;
# M and m: 4 comparisons; each ratio: 2 differences, a sum, a division, an
# absolute value; 2 minima) = 21 beside the cell's two reconstructions, and
# the face's limited flux (its upwind limited value: a difference, a
# product, a sum; A·u and the product) = 5. The kernel forms both limited
# values of a cell (3 more), of which the face's velocity takes one: the
# bound counts what the function needs.
LIMITER_FLOP = 21
LIMITED_FLUX_FLOP = 5


def bounded_flop(scheme, n_tracers):
    """Operations the bounded #6's function needs per interior cell: u, v,
    w as the unlimited scheme (advection_flop), and per tracer and axis the
    cell's two reconstructions, its θ (LIMITER_FLOP) and its face's limited
    flux (LIMITED_FLUX_FLOP), then the differences, sums and the division
    (2 per axis + 1). WENO(5): 3 x (2 x 85 + 26) + 7 = 595 per tracer
    cell."""
    recon = recon_flop(scheme)
    tracer = 3 * (2 * recon + LIMITER_FLOP + LIMITED_FLUX_FLOP) + 7
    return advection_flop(scheme, 3, 0) + n_tracers * tracer


def bounded_bounds(N, H, esize, scheme, n_tracers=1):
    """The bounded #6's bound at interior N, halo H: each padded input read
    once and each interior output written once, and bounded_flop."""
    cells = N[0] * N[1] * N[2]
    padded = int(np.prod([n + 2 * h for n, h in zip(N, H)]))
    nf = 3 + n_tracers
    return bound(esize * nf * (padded + cells),
                 cells * bounded_flop(scheme, n_tracers))


def p31_run(label, model, dt, card, steps=P31_STEPS, shares=None):
    """Warm-up and timed steps with the counters reset just before them and
    read just after: (launches, plain calls on CUDA, step median ms); step
    median, min and max, peak memory, launches per step; then the step's
    shares (``shares(model, dt, steps, card, label)``, CUDA events) and the
    busy share and device kernels per step (torch.profiler)."""
    from oceananigans_tpu_torch import kernels as K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counters()
    times = timed_steps(model, dt, *steps)
    launches, plain = K.counters()
    peak = torch.cuda.max_memory_allocated()
    n = sum(steps)
    step_ms = statistics.median(times) * 1e3
    print(f"{label}: step median {step_ms:.3f} ms over {steps[1]} steps "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), Δt "
          f"{dt:.4e}; peak device memory (steps) {peak / 2 ** 30:.2f} GiB "
          f"[{card}]")
    print(f"{label}: launches per step "
          f"{ {k: v / n for k, v in launches.items() if v} }; plain calls "
          f"on CUDA { {k: v for k, v in plain.items() if v} }")
    if shares is not None:
        shares(model, dt, 2, card, label)
    busy_share(label, model, dt, 2, step_ms, card)
    return launches, plain, step_ms


def example_vorticity(model):
    """The example's vorticity KernelFunctionOperation at (f, f, c), over
    the model's u and v as they are when it is built (the example builds it
    once, so that it reads the initial fields at every write: here it is
    built at each write)."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch.operators.operators import zeta3_ffc
    return ot.KernelFunctionOperation(lambda g, u, v: zeta3_ffc(g, u, v),
                                      model.grid, model.field("u"),
                                      model.field("v"), loc=("f", "f", "c"))


def example_path(card, n=None):
    """(a) examples/two_dimensional_turbulence.py at n² (WENO(5), #6 on a
    flat z, the fill's wrap) through Simulation with the TimeStepWizard,
    its vorticity written by a FieldWriter; an Integral of ½(u² + v²) and
    an Average over x. Checks: the written and computed vorticity equal
    zeta3_ffc of the same fields bit for bit; the Integral equals a float64
    sum to 1e-6; the Average equals the mean over x. Returns the path's
    launches."""
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.operators.operators import zeta3_ffc
    n = n or EXAMPLE_N
    t0 = time.perf_counter()
    grid = ot.RectilinearGrid(size=(n, n), x=(0, 2 * np.pi),
                              y=(0, 2 * np.pi), topology=(P_, P_, F_),
                              dtype=torch.float32, device="cuda")
    model = ot.NonhydrostaticModel(grid, advection=ot.WENO(5))
    rng = np.random.default_rng(123)
    model.set(u=rng.standard_normal((n, n), dtype=np.float32),
              v=rng.standard_normal((n, n), dtype=np.float32))
    steps = sum(P31_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        # the example's Δt = 0.01 is its 128²'s (an advective CFL near
        # 0.7); at n² the run starts from the wizard's CFL of 0.7
        sim = ot.Simulation(model, dt=cfl_dt(model, 0.7),
                            stop_iteration=steps)
        sim.add_callback(ot.TimeStepWizard(cfl=0.7), ot.IterationInterval(2))
        path = os.path.join(tmp, "zeta")
        sim.add_output_writer(ot.FieldWriter(
            model, {"zeta": lambda m: example_vorticity(m).compute()}, path,
            schedule=ot.IterationInterval(steps)))
        torch.cuda.synchronize()
        K.reset_counters()
        t1 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches, plain = K.counters()
        written = ot.FieldTimeSeries(path, "zeta", device="cuda")
        zeta_written = written[-1]
    print(f"(a) example at {n}²: set-up {t1 - t0:.2f} s, Simulation.run of "
          f"{steps} steps {run_s:.3f} s, Δt {sim.dt:.4e}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    assert launches["fused_advection_tendency_weno5_zflat"] == 3 * steps, \
        launches
    assert launches["fill_halos"] > 0
    for name, count in plain.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    u, v = model.state["fields"]["u"], model.state["fields"]["v"]
    assert torch.isfinite(u).all().item() and torch.isfinite(v).all().item()
    want = zeta3_ffc(grid, u, v)
    op = example_vorticity(model)
    got = op.compute()
    ffc = got.interior_slices
    assert torch.equal(got.data[ffc], want[ffc]), "vorticity differs"
    zw = zeta_written if isinstance(zeta_written, torch.Tensor) \
        else zeta_written.interior
    assert torch.equal(zw.reshape(-1), want[ffc].reshape(-1)), \
        "written vorticity differs"
    uf, vf = model.field("u"), model.field("v")
    ke = ot.Integral(0.5 * (uf * uf + vf * vf))
    avg = ot.Average(uf, dims=0)
    ke_got = ke.compute().item()
    # the float64 sum of the same integrand, ½(u² + ℑxℑy(v²)) at (f, c, c)
    # (the operation interpolates v·v, the second operand, to u's
    # location), from the same float32 fields
    from oceananigans_tpu_torch.operators.operators import interp_to
    v2 = interp_to(grid, v.double() ** 2, ("c", "f", "c"), ("f", "c", "c"))
    ii = grid.interior_slices
    ke_want = (0.5 * (u[ii].double() ** 2 + v2[ii])).sum().item() \
        * grid.dx(("f", "c", "c")) * grid.dy(("f", "c", "c"))
    ke_rel = abs(ke_got - ke_want) / abs(ke_want)
    avg_err = (avg.compute() - u[ii].mean(dim=0, keepdim=True)).abs().max() \
        .item()
    print(f"(a) Integral of ½(u² + v²): {ke_got:.9e} against the float64 sum "
          f"{ke_want:.9e}, relative {ke_rel:.3e} (bound 1e-6); Average over "
          f"x: shape {tuple(avg.compute().shape)}, max abs against the mean "
          f"{avg_err:.3e}")
    assert ke_rel <= 1e-6 and avg_err <= 1e-6
    for name, fn in (("vorticity KernelFunctionOperation", op.compute),
                     ("Integral", ke.compute), ("Average over x",
                                                avg.compute)):
        print(f"(a) time {name}.compute() at {n}²: {cuda_ms(fn):.4f} ms "
              f"[{card}]")
    launches, _, step_ms = p31_run("(a) two-dimensional turbulence",
                                   model, sim.dt, card,
                                   shares=topology_phase_shares)
    return launches


def bounded_fields(grid, seed=0):
    """(b)'s initial u, v, w and c as callables: the velocities of a
    horizontal streamfunction ψ(x, y)·(1 + ½ sin 2πz) and of a vector
    potential A(y, z) along x, from np.random.default_rng(seed)'s modes
    (∇·u = 0; w = 0 at the walls), and c a step function: 1 in a box, 0
    outside."""
    rng = np.random.default_rng(seed)
    modes = [(m, k, rng.standard_normal(), rng.uniform(0, 2 * np.pi))
             for m in range(1, 4) for k in range(1, 4)]
    amp = 0.05

    def psi_terms(x, y, d):
        out = 0.0
        for m, k, a, phase in modes:
            arg = 2 * np.pi * (m * x + k * y) + phase
            out = out + a * 2 * np.pi * (k if d == "y" else m) * np.cos(arg)
        return out

    def u(x, y, z):
        return amp * psi_terms(x, y, "y") * (1 + 0.5 * np.sin(2 * np.pi * z))

    def v(x, y, z):
        return (-amp * psi_terms(x, y, "x") * (1 + 0.5 * np.sin(2 * np.pi * z))
                + amp * np.pi * np.cos(np.pi * z) * np.sin(2 * np.pi * y))

    def w(x, y, z):
        return -amp * 2 * np.pi * np.sin(np.pi * z) * np.cos(2 * np.pi * y) \
            + 0 * x

    def c(x, y, z):
        inside = ((np.abs(x - 0.5) < 0.25) & (np.abs(y - 0.5) < 0.3)
                  & (z > -0.7) & (z < -0.3))
        return inside.astype(np.float64)

    return dict(u=u, v=v, w=w, c=c)


def bounded_tracer_model(n, dtype, device, topology=(P_, P_, B_),
                         smoothness=torch.float32):
    """(b): n³ over (0, 1)² x (-1, 0), WENO(5, bounds=(0, 1)), the tracer c;
    the padded layout (a bounded scheme keeps the model off the z-compact
    one). A flat z: n² over (0, 1)², u and v from
    np.random.default_rng(1) (projected by set()), c a step function."""
    import oceananigans_tpu_torch as ot
    flat = topology[2] == F_
    scheme = ot.WENO(5, smoothness_dtype=smoothness, bounds=(0.0, 1.0))
    if flat:
        grid = ot.RectilinearGrid(size=(n, n), x=(0, 1), y=(0, 1),
                                  topology=topology, dtype=dtype,
                                  device=device)
    else:
        grid = ot.RectilinearGrid(size=(n, n, n), x=(0, 1), y=(0, 1),
                                  z=(-1, 0), topology=topology, dtype=dtype,
                                  device=device)
    model = ot.NonhydrostaticModel(grid, advection=scheme, tracers=("c",))
    assert not model._z_compact and model._kernel_tendency
    if flat:
        rng = np.random.default_rng(1)
        c = np.zeros((n, n, 1))
        c[n // 4:3 * n // 4, n // 3:2 * n // 3] = 1.0
        model.set(u=0.1 * rng.standard_normal((n, n, 1)),
                  v=0.1 * rng.standard_normal((n, n, 1)), c=c)
    else:
        model.set(**bounded_fields(grid))
    return model


def bounded_check(label, model, bound_rel, rel_to="max"):
    """The bounded #6 against its plain version on the model's state (u, v,
    w, c, halos filled): (max abs, relative) with the relative error over
    max|plain| per component (``rel_to="max"``) or over each component's
    term scale (``"terms"``, float32: term_scales)."""
    from oceananigans_tpu_torch import kernels as K
    grid, scheme = model.grid, model.advection
    fields = dict(model.state["fields"])
    model._fill_all(fields)
    f = [fields[c] for c in ("u", "v", "w", "c")]
    Gk = K.fused_advection_tendency(grid, scheme, f)
    Gp = K.fused_advection_tendency_plain(grid, scheme, f)
    assert torch.isfinite(Gk).all().item(), (label, "not finite")
    errs = [(Gk[k] - Gp[k]).abs().max().item() for k in range(4)]
    err = max(errs)
    # (a component that is zero throughout, w on a flat z, by its error)
    by_max = [e / (Gp[k].abs().max().item() or 1.0)
              for k, e in enumerate(errs)]
    if rel_to == "terms":
        scales = term_scales(grid, scheme, f)
        by_terms = [e / s for e, s in zip(errs, scales)]
        rel = max(by_terms)
    else:
        rel = max(by_max)
    print(f"  bounded #6 ({label}, {grid.N}, {grid.topology[2]} z, "
          f"{grid.dtype}): max abs {err:.3e}, relative {rel:.3e} "
          f"({'term scale' if rel_to == 'terms' else 'max|plain|'}, bound "
          f"{bound_rel:g}); u, v, w, c over max|plain| "
          + ", ".join(f"{r:.3e}" for r in by_max)
          + ("" if rel_to != "terms" else "; over the term scales "
             + ", ".join(f"{r:.3e}" for r in by_terms)))
    assert rel <= bound_rel, (label, rel)
    return err, f


def bounded_path(card, n=None, small=None):
    """(b) the bounded tracer: the bounded #6 against its plain version on
    small grids (a bounded, periodic and flat z; float64 at 1e-12, float32
    and float64 fields with float32 smoothness at 1e-5) and at the path's
    shape in float32 (1e-5 of the term scales), timed with its bound;
    then 20 steps with the counters reset just before: three launches of
    the bounded variant a step, c within [-1e-6, 1 + 1e-6]. Returns
    (launches, the kernel's measured row)."""
    from oceananigans_tpu_torch import kernels as K
    n, small = n or BOUNDED_N, small or BOUNDED_SMALL_N
    # every instantiation kind of WENO(5) on small grids: a bounded, a
    # periodic and a flat z; float64 (1e-12), float32 and float64 fields
    # with WENO's default float32 smoothness (1e-5: the smoothness rounds in
    # float32), each through a model that takes the kernel
    for topo in ((P_, P_, B_), (P_, P_, P_), (P_, P_, F_)):
        for dtype, smooth, tol in ((torch.float64, torch.float64, 1e-12),
                                   (torch.float32, torch.float32, 1e-5),
                                   (torch.float64, torch.float32, 1e-5)):
            m = bounded_tracer_model(small, dtype, "cuda", topology=topo,
                                     smoothness=smooth)
            bounded_check(f"{dtype} fields, {smooth} smoothness", m, tol)
    model = bounded_tracer_model(n, torch.float32, "cuda")
    err, f = bounded_check("the path's state", model, 1e-5, rel_to="terms")
    grid, scheme = model.grid, model.advection
    ms = cuda_ms(lambda: K.fused_advection_tendency(grid, scheme, f))
    plain_ms = cuda_ms(lambda: K.fused_advection_tendency_plain(
        grid, scheme, f), reps=3, warmup=1)
    bnd = bounded_bounds(grid.N, grid.H, 4, scheme)
    plan = K.fused_advection.launch_plan(grid, scheme, torch.float32, 4)
    per_sm = ctypes.c_int(0)
    if grid.device.type == "cuda":
        from oceananigans_tpu_torch.kernels import build
        lib = build.library()
        build.check(lib.oc_advection_bounded_blocks_per_sm(
            scheme.buffer, 0, 0, 0, 1, *plan["tile"], plan["threads"],
            plan["launches"][0][2], ctypes.byref(per_sm)), lib)
        # ptxas's report of the bounded instantiations (the process that
        # built the library holds it)
        entries = ptxas_entries(build.compile_log, ("advection_bounded",))
        for mangled, name in demangle(list(entries)).items():
            regs, st, ld = entries[mangled]
            print(f"  {name.split('advection_kernel')[-1][:70]}: {regs} "
                  f"registers, spills {st} / {ld} B")
    print(f"  time bounded #6 at {grid.padded_shape} (u, v, w, c): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]}; {bounded_flop(scheme, 1)} operations a cell); tile "
          f"{plan['tile']}, {plan['blocks']} blocks, shared memory "
          f"{plan['launches'][0][2]} B, {per_sm.value} blocks an SM "
          f"[{card}]")
    del f
    umax = max(model.field(c).interior.abs().max().item() for c in "uvw")
    dt = BOUNDED_CFL / (3 * umax * n)
    launches, plain, _ = p31_run("(b) bounded tracer", model, dt, card,
                                 steps=BOUNDED_STEPS,
                                 shares=topology_phase_shares)
    steps = sum(BOUNDED_STEPS)
    assert launches["fused_advection_tendency_weno5_bounded"] == 3 * steps, \
        launches
    for name, count in plain.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    c = model.field("c").interior
    cmin, cmax = c.min().item(), c.max().item()
    print(f"(b) after {steps} steps: min c {cmin:.6e}, max c {cmax:.6e} "
          f"(bounds [0, 1] within 1e-6), total {c.double().sum().item():.9e}")
    assert cmin >= -1e-6 and cmax <= 1 + 1e-6, (cmin, cmax)
    padded_divergence("(b) bounded tracer", model)
    return launches, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound=bnd)


def particles_path(card, n=None, n_particles=None):
    """(c) the 256³ WENO(5) flagship with 2²⁰ LagrangianParticles (the
    padded route: particles leave the z-compact one, as in JAX), tracking
    w: the particle step's ms and share of the step; no particle leaves
    the domain. Returns the path's launches."""
    import oceananigans_tpu_torch as ot
    n = n or PARTICLES_N
    n_particles = n_particles or N_PARTICLES
    rng = np.random.default_rng(7)
    parts = ot.LagrangianParticles(
        x=rng.uniform(0, 1, n_particles), y=rng.uniform(0, 1, n_particles),
        z=rng.uniform(-1, 0, n_particles), tracked_fields=("w",))
    grid = ot.RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                              topology=(P_, P_, B_), dtype=torch.float32,
                              device="cuda")
    model = ot.NonhydrostaticModel(grid, advection=ot.WENO(5),
                                   particles=parts)
    assert not model._z_compact
    rng = np.random.default_rng(0)
    model.set(u=0.1 * rng.standard_normal((n, n, n), dtype=np.float32),
              v=0.1 * rng.standard_normal((n, n, n), dtype=np.float32))
    dt = cfl_dt(model, 0.5)

    def shares(model, dt, steps, card, label):
        timer = PhaseTimer()
        step, particles = model.time_step, model._step_particles
        model.time_step = timer.wrap("step", step)
        model._step_particles = timer.wrap("particles", particles)
        try:
            for _ in range(steps):
                model.time_step(dt)
            t = {k: v / steps for k, v in timer.totals().items()}
        finally:
            del model.time_step, model._step_particles
        print(f"{label}: particle step {t['particles']:.4f} ms of the "
              f"{t['step']:.4f} ms step ({100 * t['particles'] / t['step']:.1f}"
              f"%), {n_particles} particles (CUDA events) [{card}]")

    launches, plain, _ = p31_run("(c) flagship with particles", model, dt,
                                 card, shares=shares)
    assert launches["fused_advection_tendency_weno5"] == 3 * sum(P31_STEPS)
    for name, count in plain.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    p = model.state["particles"]
    inside = ((p["x"] >= 0) & (p["x"] < 1) & (p["y"] >= 0) & (p["y"] < 1)
              & (p["z"] >= -1) & (p["z"] <= 0)).all().item()
    moved = (p["x"] - torch.as_tensor(parts.initial["x"], dtype=p["x"].dtype,
                                      device=p["x"].device)).abs()
    moved = torch.minimum(moved, 1 - moved).max().item()   # across the wrap
    print(f"(c) particles inside the domain: {inside}; largest x move "
          f"{moved:.4e}; tracked w finite: "
          f"{torch.isfinite(p['w']).all().item()}")
    assert inside and torch.isfinite(p["w"]).all().item()
    return launches


def ensemble_path(card, N=None):
    """(d) an EnsembleModel of 4 members of the 512x256x32 hydrostatic row
    (#10 and the fill), member m's T shifted by 0.1·m: the ensemble step
    against 4 solo steps; member 2 against its solo run, bit for bit.
    Returns the path's launches."""
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.models.ensemble import EnsembleModel
    N = N or HYDRO_N

    def temperature(m):
        return lambda lam, phi, z: 12 + 8e-3 * z + 2e-2 * phi + 0.1 * m

    ens = EnsembleModel(hydro_model(N, torch.float32, "cuda"),
                        ENSEMBLE_MEMBERS)
    ens.set_all(lambda m: dict(T=temperature(m)))

    def shares(ens, dt, steps, card, label):
        timer = PhaseTimer()
        ens.model.time_step = timer.wrap("members", ens.model.time_step)
        ens.time_step = timer.wrap("step", ens.time_step)
        try:
            for _ in range(steps):
                ens.time_step(dt)
            t = {k: v / steps for k, v in timer.totals().items()}
        finally:
            del ens.model.time_step, ens.time_step
        print(f"{label}: the members' steps {t['members']:.4f} ms of the "
              f"{t['step']:.4f} ms ensemble step "
              f"({100 * t['members'] / t['step']:.1f}%; the rest swaps the "
              f"members' states) (CUDA events) [{card}]")

    launches, plain, ens_ms = p31_run("(d) ensemble of 4", ens, ENSEMBLE_DT,
                                      card, shares=shares)
    steps = ens.member_state(2)["clock"]["iteration"]
    assert launches["fused_vi_tendency"] == ENSEMBLE_MEMBERS * sum(P31_STEPS)
    for name, count in plain.items():
        assert count == 0, f"plain {name} ran on CUDA tensors"
    solo = hydro_model(N, torch.float32, "cuda")
    solo.set(T=temperature(2))
    K.reset_counters()
    times = timed_steps(solo, ENSEMBLE_DT, 2, steps - 2)
    solo_ms = statistics.median(times) * 1e3
    sa, sb = flat_state(ens.member_state(2)), flat_state(solo.state)
    assert set(sa) == set(sb), sorted(set(sa) ^ set(sb))
    for key, x in sa.items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, sb[key]), ("(d) member 2", key, "differs")
        else:
            assert x == sb[key], ("(d) member 2", key, x, sb[key])
    same = True
    hydro_phase_shares(solo, ENSEMBLE_DT, 2, card)
    print(f"(d) ensemble step {ens_ms:.3f} ms against {ENSEMBLE_MEMBERS} solo "
          f"steps {ENSEMBLE_MEMBERS * solo_ms:.3f} ms (solo {solo_ms:.3f} "
          f"ms); member 2 bit for bit: {same} [{card}]")
    return launches


def long_tail_phase(card):
    """Phase 31: paths (a)-(d). Returns ({path: launches}, the bounded #6's
    measured row)."""
    t0 = time.perf_counter()
    out = {"a": example_path(card)}
    torch.cuda.empty_cache()
    out["b"], row = bounded_path(card)
    torch.cuda.empty_cache()
    out["c"] = particles_path(card)
    torch.cuda.empty_cache()
    out["d"] = ensemble_path(card)
    torch.cuda.empty_cache()
    print(f"phase 31 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    return out, row


# -- resident blocks and the pencil solvers (phase 32) ------------------------------

RES_SMALL_N = (64, 64, 64)          # (a) float64 against the serial solver
RES_PENCIL_N = (256, 256, 256)      # (a) float32 at size, a DCT z
RES_STRETCHED_N = (256, 256, 128)   # (a) float32 at size, a stretched z
RES_HILL_SMALL = (64, 64, 32)       # (c) float64, 3 steps against serial
RES_HILL_N = (128, 128, 64)         # (c) float32, timed
RES_AUX_N = (64, 64, 64)            # (d)
RES_STEPS = 3
RES_HILL_STEPS = 1                  # (c) float32 timed steps


def pencil_grid(n, dtype, stretched):
    """A (periodic, periodic, bounded) grid on the card: the unit cube, or
    z faces -1 + s^1.5 (JAX's test grid) for a stretched z."""
    import oceananigans_tpu_torch as ot
    kw = (dict(x=(0.0, 1.0), y=(0.0, 1.0),
               z=-1.0 + np.linspace(0.0, 1.0, n[2] + 1) ** 1.5)
          if stretched else dict(extent=(1.0, 1.0, 1.0)))
    return ot.RectilinearGrid(size=n, topology=(P_, P_, B_), dtype=dtype,
                              device="cuda", **kw)


def pencil_compare(label, g, stretched, bound_rel, seed=31):
    """The pencil solver on 4 slabs of the card against the serial solver
    (FFT/DCT, or Fourier-tridiagonal on a stretched z, compared with the
    means removed: the serial solver removes its Δz-weighted mean after
    the pin): max |φ_pencil − φ_serial| over max|φ_serial|, with its bound.
    A float32 grid holds both against the serial solve in float64 instead:
    the pencil's error within ``bound_rel`` and, on a stretched z, within
    1.25 times the serial float32 solve's own (both sweep the same
    float64-formed coefficients, so the pencil adds no error of its own),
    beside a control that must fail the bound: the right-hand side rounded
    to bfloat16 and solved in float64."""
    from oceananigans_tpu_torch.parallel import DistributedFFTPoissonSolver
    from oceananigans_tpu_torch.solvers.fft_poisson import FFTPoissonSolver
    from oceananigans_tpu_torch.solvers.fourier_tridiagonal import \
        FourierTridiagonalPoissonSolver

    def serial_of(grid):
        return (FourierTridiagonalPoissonSolver(grid, 2) if stretched
                else FFTPoissonSolver(grid))

    def centred(a):
        return a - a.mean() if stretched else a

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.randn(g.N, generator=gen, dtype=torch.float64, device="cuda")
    b -= b.mean()
    serial = serial_of(g)
    pencil = DistributedFFTPoissonSolver(g, [torch.device("cuda", 0)] * 4)
    bg = b.to(g.dtype)
    got = centred(pencil.solve(bg).double())
    want = centred(serial.solve(bg).double())
    if g.dtype == torch.float64:
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"  {label}: pencil ({pencil.z_kind} z, 4 slabs of cuda:0) "
              f"against the serial solver: {rel:.3e} of max|φ| (bound "
              f"{bound_rel:g})")
        assert rel <= bound_rel, (label, "pencil against serial", rel)
        return serial, pencil, bg
    exact_solver = serial_of(g.to(dtype=torch.float64))
    exact = centred(exact_solver.solve(b))
    scale = exact.abs().max()
    rel = ((got - exact).abs().max() / scale).item()
    own = ((want - exact).abs().max() / scale).item()
    control = ((centred(exact_solver.solve(b.to(torch.bfloat16).double()))
                - exact).abs().max() / scale).item()
    tie = 1.25 if stretched else float("inf")
    print(f"  {label}: pencil ({pencil.z_kind} z, 4 slabs of cuda:0) "
          f"against the serial float64 solve: {rel:.3e} of max|φ|, "
          f"{rel / own:.3f} times the serial float32 solve's {own:.3e} "
          f"(bound {bound_rel:g}"
          + (", and 1.25 times the serial's" if stretched else "")
          + f"); control, b rounded to bfloat16 and solved in float64: "
          f"{control:.3e}")
    assert rel <= bound_rel and rel <= tie * own, (label, "pencil float32",
                                                   rel, own)
    assert control > bound_rel, (label, "control within the bound", control)
    return serial, pencil, bg


def pencil_checks(card):
    """(a) The pencil solver: float64 at 64³ (DCT z) and 64×64×32 (stretched
    z) against the serial solvers within 1e-12 of max|φ|; float32 at 256³
    (DCT z) and 256×256×128 (stretched z) against the serial float64 solve
    within 1e-5 and 1.25 times the serial float32 solve's error, with the
    time per solve beside the serial solve's, and the block entry the
    models call on
    a 2x2 mesh of resident (128, 128, nz) blocks (re-blocked into 4 x-slabs
    and back)."""
    for stretched, n in ((False, RES_SMALL_N),
                         (True, RES_SMALL_N[:2] + (RES_SMALL_N[2] // 2,))):
        pencil_compare(f"pencil {n} float64", pencil_grid(
            n, torch.float64, stretched), stretched, 1e-12)
    out = {}
    # float32 against the float64 serial solve: 1e-5 with either z (on an
    # H100 80GB HBM3 at 700 W the stretched z's serial float32 solve reads
    # 9.74e-6 of max|φ|, the grid's float32 floor: the sweep of its
    # near-singular modes amplifies rounding)
    for stretched, n, bound_rel in ((False, RES_PENCIL_N, 1e-5),
                                    (True, RES_STRETCHED_N, 1e-5)):
        label = f"pencil {n} float32"
        g = pencil_grid(n, torch.float32, stretched)
        serial, pencil, b = pencil_compare(label, g, stretched, bound_rel)
        serial_ms = cuda_ms(lambda: serial.solve(b), reps=3, warmup=1)
        pencil_ms = cuda_ms(lambda: pencil.solve(b), reps=3, warmup=1)
        arch = card_mesh()
        from oceananigans_tpu_torch.parallel import \
            DistributedFFTPoissonSolver
        blockwise = DistributedFFTPoissonSolver(g, arch)
        h = (n[0] // 2, n[1] // 2)
        blocks = [b[i * h[0]:(i + 1) * h[0], j * h[1]:(j + 1) * h[1]]
                  .contiguous() for i in range(2) for j in range(2)]
        comm = arch.communicator
        phi = comm.run(lambda r: blockwise.solve_block(r, blocks[r]))
        full = stitch(phi, MESH_SHAPE, (0, 0))
        want = pencil.solve(b)
        rel = ((full - want).abs().max() / want.abs().max()).item()
        print(f"  {label}: the block entry on 2x2 resident blocks against "
              f"the pencil's global entry: {rel:.3e} of max|φ| (bound 0: "
              f"the same slabs and transforms)")
        assert rel == 0.0, (label, "block entry", rel)
        block_ms = cuda_ms(lambda: comm.run(
            lambda r: blockwise.solve_block(r, blocks[r])), reps=3, warmup=1)
        print(f"  {label}: time per solve, serial {serial_ms:.4f} ms, pencil "
              f"on 4 slabs {pencil_ms:.4f} ms, block entry on 2x2 "
              f"{block_ms:.4f} ms (CUDA events around the call) [{card}]")
        out[label] = (serial_ms, pencil_ms, block_ms)
        del serial, pencil, blockwise, b, blocks, phi, full, want
        torch.cuda.empty_cache()
    return out


def resident_row_a(card):
    """(b) Row A (triply periodic 256³, WENO(5), float32) on the 2x2 mesh of
    the card from the serial row's initial state: 3 steps of each with the
    counters reset before the sharded steps and read after (#7 in its
    zperiodic variant once per shard and stage, the exchange, the fill's z
    wrap, no plain version on CUDA tensors), each field against the serial
    model's within 1e-5 of its max|·| (float32; the pencil solver rounds
    apart from the serial one), step ms, peak memory against the state
    held, the device profile and #7 against its plain route on the row's
    blocks. Returns (launches, #7's measured row)."""
    from oceananigans_tpu_torch import kernels as K
    serial = topology_row_a()
    state0 = to_device(serial.state, "cpu")
    dt = cfl_dt(serial)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = topology_row_a(card_mesh())
    model.state = to_device(state0, "cuda")
    del state0
    K.reset_counters()
    times = []
    for _ in range(RES_STEPS):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        serial.time_step(dt)
    launches, plain_cuda = K.counters()
    label = "row A, triply periodic 256^3 WENO(5)"
    print(f"{label} on 2x2 launches over {RES_STEPS} steps: "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls on "
          f"CUDA: { {k: v for k, v in plain_cuda.items() if v} }")
    stages = 3 * RES_STEPS
    check_mesh_launches(launches, plain_cuda, {
        "build_sharded_fused_advection": 4 * stages,
        "build_sharded_fused_advection_weno5_zperiodic": 4 * stages})
    assert launches["mesh_halo_exchange"] >= 2 * stages
    assert launches["fill_halos"] > 0
    step_ms = resident_report(label, model, times, base, card)
    against_serial(label, model, serial, ("u", "v", "w"), 1e-5)
    del serial
    torch.cuda.empty_cache()
    resident_profile(label, model, dt, 2, step_ms, card, "advection")
    return launches, sharded_tendency_check("row A 256^3", model,
                                            RES_PENCIL_N[0], card)


def resident_hill(card):
    """(c) Row E's immersed hill on the 2x2 mesh (the CG with its sums over
    the mesh and the pencil preconditioner, as JAX's takes the FFT one),
    each sharded model from its serial twin's state: in float64 at
    64×64×32, both CGs at reltol 1e-13 (about 538 iterations a solve),
    3 steps against the serial model within 1e-10 of each field's max|·|,
    with their wall time;
    in float32 at 128×128×64, one timed step with each solve's iterations
    and final residual (a solve that stops at maxiter is marked
    unconverged, as rows D and E) and the time an iteration (the sharded
    CG meets 8 times an iteration and reads its norm on the host)."""
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.solvers.conjugate_gradient import \
        conjugate_gradient as cg
    serial = hill_model(RES_HILL_SMALL, torch.float64, "cuda",
                        smoothness=torch.float64)
    model = hill_model(RES_HILL_SMALL, torch.float64, "cuda",
                       smoothness=torch.float64, architecture=card_mesh(),
                       initial=False)
    model.state = to_device(serial.state, "cuda")
    # both CGs to 1e-13: at the row's 1e-7 the two stop on either side of
    # the tolerance as their sums round apart (1e-6 after 3 steps); a fixed
    # iteration count does not help, since unconverged iterates round apart
    # too (1e-4 after 64 iterations a solve)
    for solver in [serial.pressure_solver] + [
            m.pressure_solver for m in model._shards]:
        solver.reltol, solver.maxiter = 1e-13, 1000
    dt = cg_dt(serial)
    t0 = time.perf_counter()
    for _ in range(RES_STEPS):
        serial.time_step(dt)
    t1 = time.perf_counter()
    cg.iterations.clear()
    for _ in range(RES_STEPS):
        model.time_step(dt)
    t2 = time.perf_counter()
    iters = list(cg.iterations)
    print(f"hill {RES_HILL_SMALL} float64: {RES_STEPS} steps, serial "
          f"{t1 - t0:.1f} s, on 2x2 {t2 - t1:.1f} s ({sum(iters)} CG "
          f"iterations, {(t2 - t1) * 1e3 / sum(iters):.3f} ms an iteration) "
          f"[{card}]")
    against_serial(f"hill {RES_HILL_SMALL} float64", model, serial,
                   ("u", "v", "w", "b"), 1e-10)
    del serial, model
    torch.cuda.empty_cache()
    label = f"hill {RES_HILL_N} float32 on 2x2"
    serial = hill_model(RES_HILL_N, torch.float32, "cuda")
    model = hill_model(RES_HILL_N, torch.float32, "cuda",
                       architecture=card_mesh(), initial=False)
    model.state = to_device(serial.state, "cuda")
    dt = cg_dt(serial)
    del serial
    maxiter = model._shards[0].pressure_solver.maxiter
    torch.cuda.synchronize()
    K.reset_counters()
    cg.iterations.clear()
    cg.residuals.clear()
    times = []
    for _ in range(RES_HILL_STEPS):
        t0 = time.perf_counter()
        model.time_step(dt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        dt = cg_dt(model)
    step_ms = statistics.median(times) * 1e3
    launches, plain_cuda = K.counters()
    check_mesh_launches(launches, plain_cuda, {})
    assert launches["mesh_halo_exchange"] > 0 and launches["fill_halos"] > 0
    iters, res = list(cg.iterations), list(cg.residuals)
    assert len(iters) == 3 * RES_HILL_STEPS, (label, len(iters))
    marks = ["unconverged" if i >= maxiter else "converged" for i in iters]
    print(f"{label}: CG iterations per solve {iters} (maxiter {maxiter}), "
          f"final residual over |b| " + ", ".join(f"{r:.3e}" for r in res)
          + f"; {marks.count('unconverged')} of {len(iters)} solves stopped "
          f"at maxiter (unconverged, as rows D and E)")
    for name in model.prognostic_names:
        assert torch.isfinite(model.field(name).interior).all().item(), name
    # printed, not asserted: a float32 CG at reltol 1e-7 of |b| leaves
    # max|∇·u|·Δx/max|u| near 1e-4 serially too (1.3e-4 and 2.2e-4 at
    # 16×16×8 and 32×32×16 on the CPU, sharded or not)
    fluid_divergence(label, model, required=False)
    print(f"{label}: step median {step_ms:.3f} ms over {RES_HILL_STEPS} "
          f"steps (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{sum(iters)} CG iterations "
          f"({sum(times) * 1e3 / sum(iters):.3f} ms an iteration) [{card}]")
    return launches


def resident_aux(card):
    """(d) tests/test_parallel.py:557 at 64³ on the 2x2 mesh: a forcing that
    reads an auxiliary field; the host's A.set(4.0) between two steps of
    0.1 reaches every shard on the next step (mean c 0.2, then 0.4 more)."""
    import oceananigans_tpu_torch as ot
    grid = ot.RectilinearGrid(size=RES_AUX_N, extent=(1.0, 1.0, 1.0),
                              dtype=torch.float32, device="cuda")
    A = ot.CenterField(grid).set(2.0)
    model = ot.NonhydrostaticModel(
        grid, advection=None, tracers=("c",),
        forcing={"c": ot.ContinuousForcing(lambda x, y, z, t, A: A,
                                           field_dependencies=("A",))},
        auxiliary_fields={"A": A}, architecture=card_mesh())
    model.time_step(0.1)
    c1 = model.field("c").interior.double().mean().item()
    A.set(4.0)
    model.time_step(0.1)
    c2 = model.field("c").interior.double().mean().item()
    print(f"  auxiliary-field forcing on 2x2 at {RES_AUX_N}: mean c {c1:.7f} "
          f"after one step (0.2), {c2 - c1:.7f} more after A.set(4.0) (0.4)"
          f" [{card}]")
    assert abs(c1 - 0.2) <= 1e-5 * 0.2 and abs(c2 - c1 - 0.4) <= 1e-4 * 0.4


def release():
    """Free what the last phase dropped: the sharded models hold reference
    cycles (a shard's grid names its shard), which only the collector
    frees, and their blocks go back to the card with them."""
    gc.collect()
    torch.cuda.empty_cache()


def resident_phase(card):
    """Phase 32 (item 16a): (a) the pencil solver, (b) row A on the 2x2
    mesh, (c) row E's hill on it, (d) an auxiliary-field forcing. Returns
    ({"A": launches, "E": launches}, #7's zperiodic row)."""
    t0 = time.perf_counter()
    print("(a) the pencil solver on 4 slabs of the card:")
    pencil_checks(card)
    release()
    print("(b) row A on the 2x2 mesh of the card:")
    launches_a, row = resident_row_a(card)
    release()
    print("(c) row E's immersed hill on the 2x2 mesh of the card:")
    launches_e = resident_hill(card)
    release()
    print("(d) an auxiliary-field forcing on the 2x2 mesh of the card:")
    resident_aux(card)
    print(f"phase 32 wall time {time.perf_counter() - t0:.1f} s [{card}]")
    return {"A": launches_a, "E": launches_e}, row


def main():
    t_start = time.perf_counter()
    name, card = device_phase()
    build_phase()
    print("kernels against plain versions:")
    measured = kernels_phase()
    measured.update(convection_kernels_phase())
    bounds = flagship_bounds((256, 256, 256), (4, 4, 0), 4)
    bounds.update(convection_bounds((256, 256, 256), (3, 3, 3), 4))
    flagship_launches, _ = flagship_path_phase(card)
    convection_launches, conv_step_ms, conv_serial, conv_state0 = \
        convection_path_phase(card)
    print("shallow-water kernels against plain versions:")
    n_sw = 16384
    measured.update(sw_kernels_phase(n_sw))
    bounds.update(sw_bounds(n_sw, (4, 4, 0), 4))
    sw_launches, sw_step_ms, sw_serial, sw_state0 = sw_path_phase(card,
                                                                   n_sw)
    release()
    print("mesh pieces against plain versions (2x2 mesh of one card):")
    measured.update(mesh_kernels_phase(n_sw, 256))
    release()
    sharded_sw_launches, measured["build_sharded_fused_sw_update"] = \
        sharded_sw_path_phase(card, n_sw, sw_serial, sw_state0)
    # the serial model's steady steps, after the sharded path compared
    # with it
    busy_share("shallow-water path", sw_serial, 1e-5, 3, sw_step_ms, card)
    del sw_serial, sw_state0
    release()
    sharded_conv_launches, measured["build_sharded_fused_advection"] = \
        sharded_convection_path_phase(card, 256, conv_serial, conv_state0)
    busy_share("convection path", conv_serial, 1e-3, 3, conv_step_ms, card)
    del conv_serial, conv_state0
    release()
    print("z-compact kernels with tracers, and the lifted caps, against plain "
          "versions:")
    tracer_kernels_phase()
    release()
    tracer_launches, measured["fused_advection_update_tracers"], \
        weno_states = tracer_path_phase(card)
    release()
    print("bfloat16 WENO smoothness: kernels against plain versions, and the "
          "256^3 weno5_bf16smooth tracer row:")
    measured.update(bf16_kernels_phase())
    release()
    bf16_launches, measured["fused_advection_update_bf16"] = \
        bf16_tracer_path_phase(card, weno_states)
    del weno_states
    release()
    buoyant_launches, measured["fused_advection_tendency_compact"], \
        b_serial, b_state0, b_step_ms = buoyant_path_phase(card)
    release()
    sharded_b_launches, measured["build_sharded_fused_advection_compact"] = \
        sharded_buoyant_path_phase(card, 256, b_serial, b_state0)
    busy_share("buoyant z-compact path", b_serial, 1e-3, 3, b_step_ms, card)
    del b_serial, b_state0
    release()
    bounds.update(compact_bounds((256, 256, 256), (4, 4, 0), 4, N_TRACERS))
    bounds["fused_advection_tendency_compact"] = compact_bounds(
        (256, 256, 256), (4, 4, 0), 4, 1)["fused_advection_tendency_compact"]
    bounds["build_sharded_fused_advection_compact"] = \
        bounds["fused_advection_tendency_compact"]
    bounds["build_sharded_fused_sw_update"] = bounds["fused_sw_update"]
    bounds["build_sharded_fused_advection"] = \
        bounds["fused_advection_tendency"]
    bounds["mesh_halo_exchange"] = exchange_bound(
        (n_sw // 2 + 8, n_sw // 2 + 8, 1), (4, 4), 3, 4, 4)
    bounds["mesh_halo_exchange_conv"] = exchange_bound(
        (128 + 6, 128 + 6, 262), (3, 3), 4, 4, 4)
    print("hydrostatic kernels against plain versions:")
    measured_vi, hmodel = hydro_kernels_phase()
    measured.update(measured_vi)
    hydro_H = hmodel.grid.H
    bounds.update(hydro_bounds(HYDRO_N, hydro_H, 4))
    hydro_launches, _ = hydro_path_phase(card, hmodel)
    del hmodel
    release()
    print("goldens on the card:")
    goldens_phase()
    print("whole step, kernels against plain versions:")
    whole_step_phase()
    print("vector-unit probes (#12) against plain versions:")
    measured.update(probe_kernels_phase(card))
    print("vector-unit probes (#12), the entry points:")
    probe_launches, peak = probe_path_phase(card)
    bounds.update(probe_bounds(peak["tflops"]))
    print("the 128^3 LES row (SmagorinskyLilly, AMD) and a vertically implicit "
          "diffusivity:")
    les = les_path_phase(card)
    for cname, (launches, step_ms) in les.items():
        print(f"LES {cname}: step {step_ms:.3f} ms; launches "
              f"{ {k: launches[k] for k in LES_KERNELS} } [{card}]")
    print("the 512x256x32 CATKE ocean row (flat bottom, immersed ridge):")
    ocean = ocean_path_phase(card)
    for cname, (launches, step_ms) in ocean.items():
        print(f"{cname}: step {step_ms:.3f} ms; launches "
              f"{ {k: launches[k] for k in HYDRO_KERNELS} } [{card}]")
    print("the run loop: the flagship and the CATKE ocean row through "
          "Simulation.run:")
    simulation_phase(card)
    print("the global tripolar ocean (360x170x32, stretched z, the fold) and "
          "the pole-to-pole piece:")
    glob = global_path_phase(card)
    measured["fill_halos_fold"] = glob["3d"]
    measured["fill_halos_fold_surfaces"] = glob["2d"]
    measured["fill_halos_polar"] = glob["polar"]["3d"]
    global_launches = glob["launches"]
    polar_launches = glob["polar"]["launches"]
    print("every advection scheme in the advection kernels (phase 25):")
    scheme_rows, scheme_flagship, scheme_convection = schemes_phase(card)
    print("every configuration of the hydrostatic tendency #10 (phase 26):")
    vi_rows, stretched_launches = vi_coverage_phase(card)
    print("the nonhydrostatic model on every topology and one stretched axis "
          "(phase 27):")
    topo_rows, topo_launches = topology_phase(card)
    print("the nonhydrostatic model on immersed, multiply stretched and "
          "curvilinear grids with open and per-point conditions (phase 28):")
    cg_rows, cg_launches = cg_phase(card)
    print("the rest of the single-grid hydrostatic model: the isopycnal "
          "closures, z*, flux-form momentum and the multi-dimensional "
          "stencil (phase 29):")
    h29_rows, h29_launches = hydro29_phase(card)
    print("the cubed sphere (grid, exchange, both models) and the rest of "
          "shallow water (phase 30):")
    cs_rows, cs_launches = cs30_phase(card)
    print("the long tail: the operations on the two-dimensional turbulence "
          "example, the bounded tracer, particles and an ensemble (phase "
          "31):")
    p31_launches, bounded_row = long_tail_phase(card)
    print("resident shard blocks and the pencil solvers (phase 32):")
    res_launches, measured["build_sharded_fused_advection_zperiodic"] = \
        resident_phase(card)
    bounds["build_sharded_fused_advection_zperiodic"] = convection_bounds(
        RES_PENCIL_N, (3, 3, 3), 4, n_tracers=0)["fused_advection_tendency"]
    bounds["fused_advection_update_bf16"] = \
        bounds["fused_advection_update_tracers"]
    for fname in ("fill_halos", "fill_halos_bounded", "fill_halos_fold",
                  "fill_halos_fold_surfaces", "fill_halos_polar"):
        bounds[fname] = measured[fname]["bound"]
    rows = []
    for kname, (source, replaces) in KERNEL_SOURCES.items():
        # the fill's #4 row is at the flagship's shapes (the wrap, where it
        # replaces get_batched_fill), its #5 row at the hydrostatic path's
        # (x, y and z), each with its path's launches
        launches = (flagship_launches if kname in FLAGSHIP_KERNELS
                    else sw_launches if kname == "fused_sw_update"
                    else hydro_launches if kname in ("fused_vi_tendency",
                                                     "fill_halos_bounded")
                    else sharded_sw_launches if kname in (
                        "build_sharded_fused_sw_update", "mesh_halo_exchange")
                    else sharded_conv_launches
                    if kname == "build_sharded_fused_advection"
                    else tracer_launches
                    if kname == "fused_advection_update_tracers"
                    else buoyant_launches
                    if kname == "fused_advection_tendency_compact"
                    else sharded_b_launches
                    if kname == "build_sharded_fused_advection_compact"
                    else res_launches["A"]
                    if kname == "build_sharded_fused_advection_zperiodic"
                    else bf16_launches
                    if kname == "fused_advection_update_bf16"
                    else probe_launches if kname in PROBE_KERNELS
                    else global_launches if kname in (
                        "fill_halos_fold", "fill_halos_fold_surfaces")
                    else polar_launches if kname == "fill_halos_polar"
                    else convection_launches)[COUNTER.get(kname, kname)]
        bound_ms, bound_by = bounds[kname]
        m = measured[kname]
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=launches,
                         max_abs_err=m["max_abs_err"], ms=m["ms"],
                         plain_ms=m["plain_ms"], bound_ms=bound_ms,
                         bound_by=bound_by,
                         library_ms=m.get("library_ms")))
    # phase 25's rows: each scheme's variant of #1, #6 and #8 at its path's
    # shape, with that variant's own launches on the path its kernel runs
    # (#1 on the WENO(9) flagship, #6 on the UpwindBiased(5) convection row,
    # #8 on the WENO(5) shallow-water path of phase 8): 0 for a variant no
    # path runs, which only the checks and the times of phase 25 launch
    for kname, m in scheme_rows.items():
        kernel = kname.rsplit("_", 1)[0]
        launches = (scheme_flagship if kernel == "fused_advection_update"
                    else scheme_convection
                    if kernel == "fused_advection_tendency"
                    else sw_launches).get(kname, 0)
        source, replaces = KERNEL_SOURCES[kernel]
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=launches,
                         max_abs_err=m["max_abs_err"], ms=m["ms"],
                         plain_ms=m["plain_ms"], bound_ms=m["bound"][0],
                         bound_by=m["bound"][1], library_ms=None))
    # phase 26's rows: #10 on the stretched ocean row (its k5_z variant's
    # launches on that path) and with WENO(9) everywhere (its checks and
    # times only: no path runs it)
    for kname, m in vi_rows.items():
        source, replaces = KERNEL_SOURCES["fused_vi_tendency"]
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces,
                         launches=stretched_launches.get(kname, 0),
                         max_abs_err=m["max_abs_err"], ms=m["ms"],
                         plain_ms=m["plain_ms"], bound_ms=m["bound"][0],
                         bound_by=m["bound"][1], library_ms=None))
    # phase 27's rows: #6 and the fill on row A (periodic z) and row B (flat
    # z), the fill on row C (bounded z, flat y), each with its row's
    # launches
    for kname, (row, counter, kernel) in TOPOLOGY_ROWS.items():
        m = topo_rows[kname]
        source, replaces = KERNEL_SOURCES[kernel]
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces,
                         launches=topo_launches[row][counter],
                         max_abs_err=m["max_abs_err"], ms=m["ms"],
                         plain_ms=m["plain_ms"], bound_ms=m["bound"][0],
                         bound_by=m["bound"][1],
                         library_ms=m.get("library_ms")))
    # phase 28's rows: the fill with planes and perturbation faces on row D
    # (its launches with a PA face), and on row E's immersed hill
    for kname, (row, counter) in CG_ROWS.items():
        m = cg_rows[kname]
        source, replaces = KERNEL_SOURCES["fill_halos_bounded"]
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces,
                         launches=cg_launches[row][counter],
                         max_abs_err=m["max_abs_err"], ms=m["ms"],
                         plain_ms=m["plain_ms"], bound_ms=m["bound"][0],
                         bound_by=m["bound"][1], library_ms=None))
    # phase 29's rows: #10's multi-dimensional variant on row H, the fill
    # on row F (periodic x, bounded y and z, η, U, V) and on row G (flat y,
    # bounded z), each with its row's launches
    for kname, row, counter, kernel in (
            ("fused_vi_tendency_md", "H", "fused_vi_tendency",
             "fused_vi_tendency"),
            ("fill_halos_near_global", "F", "fill_halos",
             "fill_halos_bounded"),
            ("fill_halos_internal_tide", "G", "fill_halos",
             "fill_halos_bounded")):
        m = h29_rows[kname]
        source, replaces = KERNEL_SOURCES[kernel]
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces,
                         launches=h29_launches[row][counter],
                         max_abs_err=m["max_abs_err"], ms=m["ms"],
                         plain_ms=m["plain_ms"], bound_ms=m["bound"][0],
                         bound_by=m["bound"][1],
                         library_ms=m.get("library_ms")))
    # phase 30's rows: the fill on row I's and row J's concatenated panels
    # (z halos; x and y kept) and on row K's Bickley jet (the wrap of x and
    # the bounded y), each with its row's launches
    for kname, row in (("fill_halos_cs_row", "I"),
                       ("fill_halos_cs_global", "J"),
                       ("fill_halos_bickley", "K")):
        m = cs_rows[kname]
        source, replaces = KERNEL_SOURCES["fill_halos_bounded"]
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces,
                         launches=cs_launches[row]["fill_halos"],
                         max_abs_err=m["max_abs_err"], ms=m["ms"],
                         plain_ms=m["plain_ms"], bound_ms=m["bound"][0],
                         bound_by=m["bound"][1], library_ms=None))
    # phase 31's row: the bounded #6 (WENO(5), bounds (0, 1)) on path (b),
    # with its launches there
    source, replaces = KERNEL_SOURCES["fused_advection_tendency"]
    rows.append(dict(name="fused_advection_tendency_weno5_bounded",
                     route="cuda",
                     source="oceananigans_tpu_torch/csrc/bounded_limiter.cuh",
                     replaces=replaces,
                     launches=p31_launches["b"][
                         "fused_advection_tendency_weno5_bounded"],
                     max_abs_err=bounded_row["max_abs_err"],
                     ms=bounded_row["ms"], plain_ms=bounded_row["plain_ms"],
                     bound_ms=bounded_row["bound"][0],
                     bound_by=bounded_row["bound"][1], library_ms=None))
    for fname, label, path_launches in (
            ("fill_halos", "the flagship path (u, v, w, p of 264x264x256, "
             "the wrap)", flagship_launches),
            ("fill_halos_convection", "the convection path (u, v, w, b of "
             "262^3, wrap and bounded z)", convection_launches),
            ("fill_halos_sw", "the shallow-water path (3 fields of 16392^2)",
             sw_launches),
            ("fill_halos_bounded", f"the hydrostatic path (u, v, T, w of "
             f"{HYDRO_N}, H = {hydro_H}, x, y and z)", hydro_launches),
            ("fill_halos_surfaces", "the hydrostatic substep loop (η, U, V "
             "surfaces, x and y)", hydro_launches),
            ("fill_halos_fold", f"the global tripolar row (u, v, w, T, S, e "
             f"of {GLOBAL_N}, the fold)", global_launches),
            ("fill_halos_fold_surfaces", "the global row's substep loop (η, "
             "U, V, the fold)", global_launches),
            ("fill_halos_polar", f"the pole-to-pole piece (u, v, w, T, S, e "
             f"of {POLAR_N}, the polar caps)", polar_launches)):
        m = measured[fname]
        print(f"fill_halos on {label}: kernel {m['ms']:.4f} ms (call from an "
              f"idle card {m['call_ms']:.4f}), plain {m['plain_ms']:.4f} ms, "
              f"bound {m['bound'][0]:.4f} ms, sector floor "
              f"{m['sector_ms']:.4f} ms, library "
              f"{m.get('library_ms')}, max abs err {m['max_abs_err']:.3e}; "
              f"fill launches on the path {path_launches['fill_halos']} "
              f"({path_launches['fill_halos_3d']} on 3-D fields, "
              f"{path_launches['fill_halos_2d']} on 2-D surfaces)")
    exchange_conv = dict(measured["mesh_halo_exchange_conv"],
                         launches=sharded_conv_launches["mesh_halo_exchange"])
    print(f"mesh_halo_exchange on the sharded convection path (u, v, w, b in "
          f"4 blocks of 134x134x262, halo (3, 3)): {exchange_conv}, bound "
          f"{bounds['mesh_halo_exchange_conv']}")
    print(f"per-shard launches on the sharded paths: fused_sw_update "
          f"{sharded_sw_launches['fused_sw_update']}, fused_advection_tendency "
          f"{sharded_conv_launches['fused_advection_tendency']} (convection), "
          f"{sharded_b_launches['fused_advection_tendency']} (buoyant "
          f"z-compact)")
    print(f"bfloat16 smoothness, the other kernels against their plain "
          f"versions (max abs): #6 padded "
          f"{measured['fused_advection_tendency_bf16']['max_abs_err']:.3e}, "
          f"#8 {measured['fused_sw_update_bf16']['max_abs_err']:.3e}")
    print(f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s, "
          f"the build included [{card}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
