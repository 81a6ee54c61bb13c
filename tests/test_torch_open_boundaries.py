"""Open and per-point boundary conditions in the port, against the JAX
package, on the CPU in float64.

- the fill kernel's maps with planes: ``evaluate_planes`` mirrors
  ``csrc/halo_fill.cu`` (each slot from one load of the untouched input
  through the x, y and z maps; a plane side's value read at the slot's
  transverse source: an x side at the y and z sources, a y side at the x
  and the z source, a z side at the x and y; the ``PA_FACE`` side pins
  its face and halo to its plane) and is held bit for bit against the
  sequential plain fill ``fill_halos_plain``, float32 and float64, bounded
  and periodic x and y, the four locations, callable, array and scalar
  Value, Gradient, Flux and Open conditions with and without
  PerturbationAdvection, with and without Δt, N from below H to larger.
- the port's fill against the JAX ``fill_halo_regions`` with time and Δt:
  1e-14 relative, for callable and array conditions (an array of the
  plane's interior wraps along a periodic transverse axis and extends by
  edge along the others) as Value, Gradient and Open, and the
  perturbation-advection face on every side for inflow and outflow with
  τ = 0, finite and ∞.
- callable Flux conditions with field dependencies on the x and y sides
  (``apply_flux_bcs``) and the open sides' mass balance: 1e-14.
- the models over 3 steps from the JAX state at 1e-10 (``pressure_solver=``
  at reltol 1e-13 where a CG solver runs): the ``tidal_flow_over_seamount``
  example at 64×16 (and with its default solver at 1e-6), the
  ``horizontal_convection`` example at 32×16, w with an Open top condition
  under PerturbationAdvection and a callable Value condition on b's
  bottom, a FieldTimeSeries Value condition on c's top, and the
  hydrostatic model's lateral Open conditions (``tests/test_hydrostatic_
  model.py``'s channel at Ny = 4: the port's periodic fill needs N ≥ H).
- the seamount's immersed CG at 128×32 against JAX's on one right-hand
  side: both stop at the default maxiter of 200 with residuals within a
  factor of 2, and both converge given 1000 iterations (1e-6).
- the ``open_boundary_radiation`` golden of ``tests/test_regression.py``
  at 1e-9.
- what stays refused raises.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
import oceananigans_tpu.advection as ja
import oceananigans_tpu.boundary_conditions as jbc
import oceananigans_tpu.buoyancy as jb
import oceananigans_tpu.closures as jc
from oceananigans_tpu.boundary_conditions.fill_halos import \
    apply_flux_bcs as j_apply_flux_bcs
from oceananigans_tpu.immersed import (ImmersedBoundaryGrid as JIBG,
                                       PartialCellBottom as JPCB)
from oceananigans_tpu.models import NonhydrostaticModel as JModel
from oceananigans_tpu.models import HydrostaticFreeSurfaceModel as JHydro
from oceananigans_tpu.models.free_surfaces import ExplicitFreeSurface as JEFS
from oceananigans_tpu.solvers import conjugate_gradient as jcg
from oceananigans_tpu.solvers.fft_poisson import FFTPoissonSolver as JFFT
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.boundary_conditions as tbc
from oceananigans_tpu_torch.boundary_conditions import (
    apply_flux_bcs, fill_halo_regions as t_fill,
    regularize_field_boundary_conditions as t_reg)
from oceananigans_tpu_torch.immersed import (ImmersedBoundaryGrid as TIBG,
                                             PartialCellBottom as TPCB)
from oceananigans_tpu_torch.kernels import halo_fill as hf
from oceananigans_tpu_torch.models import NonhydrostaticModel, state_from_jax
from oceananigans_tpu_torch.solvers import (FFTPoissonSolver,
                                            make_immersed_poisson_solver)
from test_torch_halo_fill import apply as apply_maps, map_at as base_map_at
from test_torch_halo_fill import (COPY, ODD, PIN)

torch.set_num_threads(1)

F64 = torch.float64
P, B, F = "periodic", "bounded", "flat"
CCC = ("c", "c", "c")
LOCS = {"u": ("f", "c", "c"), "v": ("c", "f", "c"), "w": ("c", "c", "f"),
        "c": ("c", "c", "c")}
SIDES = ("west", "east", "south", "north", "bottom", "top")
TIMESCALES = [(0.0, np.inf), (60.0, 0.5), (np.inf, 0.0), (2.0, 3.0),
              (0.0, 0.0), (1.0, np.inf)]
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def rel(got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    return np.abs(got - want).max() / max(scale, 1e-300)


def transverse(s, N):
    return tuple(N[ax] for ax in range(3) if ax != s // 2)


def condition(kind, s, N, J, rng):
    """Side ``s``'s condition of ``kind``: a callable of the transverse
    coordinates and the time (jnp or torch), an array of the plane's
    interior, or a scalar."""
    k = 0.3 * (s + 1)
    if kind == "callable":
        m = jnp if J else torch
        return lambda a, b, t: k * m.cos(a) * m.sin(2 * b) + 0.1 * t
    if kind == "array":
        return rng.standard_normal(transverse(s, N))
    return 0.1 * (s + 1) * (-1) ** s


def side_bcs(lib, classes, kinds, N, topology, J, seed, pa=True):
    """FieldBoundaryConditions of the JAX package (``J``) or the port: side
    s takes ``classes[s]`` with a ``kinds[s]`` condition; an Open side
    carries PerturbationAdvection with the timescales of ``TIMESCALES``
    when ``pa``. Periodic sides are left to the defaults."""
    rng = np.random.default_rng(seed)
    sides = {}
    for s, side in enumerate(SIDES):
        if topology[s // 2] != B:
            continue
        cond = condition(kinds[s], s, N, J, rng)
        cls = classes[s]
        if cls == "open":
            scheme = lib.PerturbationAdvection(*TIMESCALES[s]) if pa else None
            sides[side] = lib.OpenBoundaryCondition(cond, scheme=scheme)
        else:
            sides[side] = {"value": lib.ValueBoundaryCondition,
                           "gradient": lib.GradientBoundaryCondition,
                           "flux": lib.FluxBoundaryCondition}[cls](cond)
    return lib.FieldBoundaryConditions(**sides)


# -- the kernel's maps with planes ----------------------------------------------

def evaluate_planes(grid, a, loc, bcs, planes, z=True, pa=False):
    """The kernel's result for one field with the planes ``planes``
    ({(axis, side): plane}, ``side_planes``): each slot from one load
    through the x, y and z maps; a plane side's v is its plane at the
    slot's transverse position in the sequential fill (x: the y and z
    sources; y: the x and the z source; z: the x and y), twice it for the
    odd reflection; a ``PA_FACE`` side pins its face and halo."""
    codes = hf.fill_codes(grid, a.shape, [(loc, bcs)], z=z, pa=pa)[0]
    geom = hf.axis_geometry(grid, a.shape)
    maps, sides = [], []
    for ax, (N, Hh, Pp, half, dist) in enumerate(geom):
        lo, hi = hf.kept_range(codes[ax], N, Hh, Pp)
        axis_maps, axis_sides = [], []
        for n in range(Pp):
            side = 0 if n < lo else (1 if n >= hi else None)
            if side is not None and codes[ax][2 * side] == hf.PA_FACE:
                axis_maps.append((n, PIN, 0.0, 1.0, 0.0, None))
            else:
                axis_maps.append(base_map_at(codes[ax], N, Hh, Pp, half,
                                             dist, n))
            m = axis_maps[-1]
            axis_sides.append(side if (side is not None and (ax, side) in
                                       planes and m[1] != COPY) else None)
        maps.append(axis_maps)
        sides.append(axis_sides)
    PX, PY, PZ = (g[2] for g in geom)
    sx = torch.tensor([m[0] for m in maps[0]])
    sy = torch.tensor([m[0] for m in maps[1]])
    sz = torch.tensor([m[0] for m in maps[2]])
    r = a[sx[:, None, None], sy[None, :, None], sz[None, None, :]]
    for ax, ms in enumerate(maps):
        shape = [1, 1, 1]
        shape[ax] = len(ms)
        op = torch.tensor([m[1] for m in ms]).reshape(shape)
        v, hv, dv = (torch.tensor([m[k] for m in ms],
                                  dtype=a.dtype).reshape(shape)
                     for k in (2, 3, 4))
        v = v.expand(PX, PY, PZ).clone()
        for n, side in enumerate(sides[ax]):
            if side is None:
                continue
            plane = planes[(ax, side)]
            if ax == 0:
                val = plane[0][sy[:, None], sz[None, :]]
            elif ax == 1:
                val = plane[:, 0][:, sz]
            else:
                val = plane[..., 0]
            val = 2 * val if ms[n][1] == ODD else val
            v.narrow(ax, n, 1).copy_(val.unsqueeze(ax))
        r = apply_maps(r, op, v, hv, dv)
    return r


MAP_CASES = [(cls, kind) for cls in ("value", "gradient", "open", "mixed")
             for kind in ("callable", "array", "mixed")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("size", ["larger", "n_eq_h", "n_lt_h"])
@pytest.mark.parametrize("topo", ["BB", "PB", "BP"])
def test_plane_maps_match_sequential_fill(topo, size, dtype):
    H = (3, 2, 3)
    N = {"larger": (9, 7, 6), "n_eq_h": H,
         "n_lt_h": tuple(h if t == "P" else h - 1
                         for h, t in zip(H, topo + "B"))}[size]
    topology = tuple(P if t == "P" else B for t in topo) + (B,)
    grid = ot.RectilinearGrid(size=N, x=(0.0, 2.0), y=(-1.0, 1.0),
                              z=(-3.0, 0.0), topology=topology, halo=H,
                              dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(2)
    for loc in LOCS.values():
        for cls, kind in MAP_CASES:
            classes = [cls if cls != "mixed" else
                       ("value", "gradient", "open", "flux")[rng.integers(4)]
                       for _ in SIDES]
            kinds = [kind if kind != "mixed" else
                     ("callable", "array", "scalar")[rng.integers(3)]
                     for _ in SIDES]
            bcs = t_reg(side_bcs(tbc, classes, kinds, N, topology, False,
                                 int(rng.integers(100))), grid, loc)
            for dt in (None, 0.3):
                a = torch.randn(grid.padded_shape, generator=gen,
                                dtype=dtype)
                planes = hf.side_planes(grid, [a], [(loc, bcs)], True, 0.7,
                                        dt)[0]
                want = hf.fill_halos_plain(grid, [a.clone()], [(loc, bcs)],
                                           time=0.7, dt=dt)[0]
                got = evaluate_planes(grid, a, loc, bcs, planes,
                                      pa=dt is not None)
                assert torch.equal(got, want), (loc, cls, kind, dt)


# -- the fill against JAX ---------------------------------------------------------

def fill_pair(topology, loc, classes, kinds, dt, seed=0, pa=True,
              N=(7, 6, 5)):
    kw = dict(size=N, x=(0, 2.0), y=(-1, 1.0), z=(-3, 0.0), halo=(3, 2, 3),
              topology=topology)
    jg = jo.RectilinearGrid(dtype=np.float64, **kw)
    tg = ot.RectilinearGrid(dtype=F64, device="cpu", **kw)
    jb_ = jbc.regularize_field_boundary_conditions(
        side_bcs(jbc, classes, kinds, N, topology, True, seed, pa), jg, loc)
    tb = t_reg(side_bcs(tbc, classes, kinds, N, topology, False, seed, pa),
               tg, loc)
    a = np.random.default_rng(seed + 1).standard_normal(tg.padded_shape)
    want = np.asarray(jbc.fill_halo_regions(jnp.asarray(a), jg, loc, jb_,
                                            0.7, dt=dt))
    got = t_fill(torch.as_tensor(a.copy()), tg, loc, tb, 0.7, dt=dt).numpy()
    return got, want


@pytest.mark.parametrize("dt", [None, 0.3], ids=["no_dt", "dt"])
@pytest.mark.parametrize("kind", ["callable", "array"])
@pytest.mark.parametrize("cls", ["value", "gradient", "open"])
@pytest.mark.parametrize("topo", [(B, B, B), (P, B, B), (B, P, B)],
                         ids=["BBB", "PBB", "BPB"])
def test_fill_against_jax(topo, cls, kind, dt):
    for name, loc in LOCS.items():
        got, want = fill_pair(topo, loc, [cls] * 6, [kind] * 6, dt)
        assert rel(got, want) <= 1e-14, name


@pytest.mark.parametrize("flow", ["inflow", "outflow"])
def test_perturbation_advection_face_against_jax(flow):
    """The face of each side under PerturbationAdvection, with the
    exterior value's sign making the side an inflow or an outflow, for
    τ = 0, finite and ∞ on both timescales."""
    for timescales in ((0.0, 0.0), (60.0, 0.5), (np.inf, np.inf),
                       (0.0, np.inf), (np.inf, 0.0)):
        for name, axis in (("u", 0), ("v", 1), ("w", 2)):
            sign = 1.0 if flow == "inflow" else -1.0
            kw = dict(size=(7, 6, 5), x=(0, 2.0), y=(-1, 1.0),
                      z=(-3, 0.0), halo=(3, 2, 3), topology=(B, B, B))
            out = []
            for J, lib, grid in ((True, jbc, jo.RectilinearGrid(
                    dtype=np.float64, **kw)), (False, tbc, ot.RectilinearGrid(
                        dtype=F64, device="cpu", **kw))):
                pa = lib.PerturbationAdvection(*timescales)
                # inflow: the exterior flow enters (positive at the low
                # side, negative at the high side)
                sides = {SIDES[2 * axis]: lib.OpenBoundaryCondition(
                    0.4 * sign, scheme=pa),
                    SIDES[2 * axis + 1]: lib.OpenBoundaryCondition(
                        -0.4 * sign, scheme=pa)}
                loc = LOCS[name]
                reg = (jbc.regularize_field_boundary_conditions if J
                       else t_reg)(lib.FieldBoundaryConditions(**sides),
                                   grid, loc)
                a = np.random.default_rng(3).standard_normal(
                    grid.padded_shape)
                if J:
                    out.append(np.asarray(jbc.fill_halo_regions(
                        jnp.asarray(a), grid, loc, reg, 0.0, dt=0.7)))
                else:
                    out.append(t_fill(torch.as_tensor(a), grid, loc, reg,
                                      0.0, dt=0.7).numpy())
            assert rel(out[1], out[0]) <= 1e-14, (name, timescales)


def test_array_condition_wraps_periodic_axis():
    """An array of the plane's interior on the z sides of a field on a
    grid periodic in x: its halo columns wrap (the corner halos read the
    opposite side), bounded y extends the edge."""
    got, want = fill_pair((P, B, B), CCC, ["value"] * 6, ["array"] * 6,
                          None)
    assert rel(got, want) <= 1e-14
    tg = ot.RectilinearGrid(size=(7, 6, 5), extent=(2.0, 2.0, 3.0),
                            halo=(3, 2, 3), topology=(P, B, B), dtype=F64,
                            device="cpu")
    arr = np.random.default_rng(0).standard_normal((7, 6))
    plane = hf.boundary_plane(tbc.ValueBoundaryCondition(arr), tg, CCC, 2,
                              tg.padded_shape, F64, "cpu")
    assert plane.shape == (13, 10, 1)
    assert np.array_equal(plane[:3, 2:8, 0].numpy(), arr[4:])
    assert np.array_equal(plane[5, :2, 0].numpy(), [arr[2, 0]] * 2)


def test_flux_callables_on_x_and_y_against_jax():
    """Callable Flux conditions with field dependencies on the x and y
    sides (a quadratic drag on the walls) through ``apply_flux_bcs``."""
    kw = dict(size=(6, 5, 4), extent=(1.0, 2.0, 3.0), halo=(3, 3, 3),
              topology=(B, B, B))
    jg = jo.RectilinearGrid(dtype=np.float64, **kw)
    tg = ot.RectilinearGrid(dtype=F64, device="cpu", **kw)
    rng = np.random.default_rng(8)
    arrays = {n: rng.standard_normal(tg.padded_shape) for n in "uvwc"}

    def drag(m):
        return lambda a, b, t, u, c: -0.1 * m.abs(u) * c + 0.01 * a * b

    for name in ("c", "u"):
        loc = LOCS[name]
        jbcs = jbc.regularize_field_boundary_conditions(
            jbc.FieldBoundaryConditions(**{
                s: jbc.FluxBoundaryCondition(drag(jnp),
                                             field_dependencies=("u", "c"))
                for s in SIDES[:4] if not (name == "u" and s in SIDES[:2])}),
            jg, loc)
        tbcs = t_reg(tbc.FieldBoundaryConditions(**{
            s: tbc.FluxBoundaryCondition(drag(torch),
                                         field_dependencies=("u", "c"))
            for s in SIDES[:4] if not (name == "u" and s in SIDES[:2])}),
            tg, loc)
        G = rng.standard_normal(tg.N)
        jG = jnp.zeros(jg.padded_shape).at[jg.interior_slices].set(G)
        want = np.asarray(j_apply_flux_bcs(
            jG, jg, loc, jbcs, 0.3,
            fields={n: jnp.asarray(a) for n, a in arrays.items()},
            locs=LOCS))[jg.interior_slices]
        got = apply_flux_bcs(torch.as_tensor(G.copy()), tg, loc, tbcs, 0.3,
                             fields={n: torch.as_tensor(a)
                                     for n, a in arrays.items()},
                             locs=LOCS).numpy()
        assert rel(got, want) <= 1e-14, name


def test_open_mass_balance_against_jax():
    """The uniform shift of the PerturbationAdvection sides' normal
    velocity that zeroes the net volume flux (an Open side with a value and
    no scheme counts in the flux, is not shifted)."""
    kw = dict(size=(8, 6, 5), x=(0, 2.0), y=(0, 1.0),
              z=tuple(-np.cumsum(np.r_[0.0, 0.5 + 0.1 * np.arange(5)])[::-1]),
              topology=(B, B, B))
    out = []
    vel = None
    for J in (True, False):
        lib = jbc if J else ot
        bcs = {"u": lib.FieldBoundaryConditions(
            west=lib.OpenBoundaryCondition(
                0.1, scheme=lib.PerturbationAdvection(10.0)),
            east=lib.OpenBoundaryCondition(
                0.1, scheme=lib.PerturbationAdvection(10.0))),
            "v": lib.FieldBoundaryConditions(
                north=lib.OpenBoundaryCondition(-0.05))}
        if J:
            m = JModel(grid=jo.RectilinearGrid(dtype=np.float64, **kw),
                       boundary_conditions=bcs)
            vel = {n: np.random.default_rng(4).standard_normal(
                m.grid.padded_shape) for n in "uvw"}
            H = m.grid.H
            res = m._balance_open_mass({n: jnp.asarray(a)
                                        for n, a in vel.items()})
            out.append({n: np.asarray(a) for n, a in res.items()})
        else:
            m = NonhydrostaticModel(ot.RectilinearGrid(dtype=F64,
                                                       device="cpu", **kw),
                                    boundary_conditions=bcs)
            # the JAX arrays cropped to the port's halos
            crop = tuple(slice(h - t, h - t + p) for h, t, p in zip(
                H, m.grid.H, m.grid.padded_shape))
            res = {n: torch.as_tensor(a[crop].copy())
                   for n, a in vel.items()}
            assert m._balance_open_mass(res) is not None
            out.append({n: a.numpy() for n, a in res.items()})
    for n in "uvw":
        assert rel(out[1][n], out[0][n][crop]) <= 1e-14, n


# -- the models -----------------------------------------------------------------

def numpy_state(state):
    return {k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


def compare(jm, tm, tol):
    scale = max(np.abs(np.asarray(jm.field(c).interior)).max() for c in "uvw")
    for name in list(tm.state["fields"]) + ["p"]:
        got = tm.field(name).interior.numpy()
        want = np.asarray(jm.field(name).interior)
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        err = rel(got, want, max(scale, np.abs(want).max()) if name == "p"
                  else scale if name in "uvw" else None)
        assert err <= tol, (name, err)


def seamount(lib, J, nx=64, nz=16):
    """``examples/tidal_flow_over_seamount.py``'s model at (nx, nz)."""
    Lx, Lz, U0, omega = 8000.0, 200.0, 0.1, 1.4e-3
    kw = dict(size=(nx, 1, nz), x=(0.0, Lx), z=(-Lz, 0.0),
              topology=(B, F, B))
    mount = lambda x, y: -Lz + 100.0 * np.exp(-((x - Lx / 2) / 800.0) ** 2)
    if J:
        grid = JIBG(jo.RectilinearGrid(dtype=np.float64, **kw),
                    JPCB(mount))
        tide = lambda y, z, t: U0 * jnp.sin(omega * t) * jnp.ones_like(z)
    else:
        grid = TIBG(ot.RectilinearGrid(dtype=F64, device="cpu", **kw),
                    TPCB(mount))
        tide = lambda y, z, t: U0 * np.sin(omega * t) * torch.ones_like(z)
    pa = lib.PerturbationAdvection(inflow_timescale=60.0,
                                   outflow_timescale=np.inf)
    u_bcs = lib.FieldBoundaryConditions(
        west=lib.OpenBoundaryCondition(tide, scheme=pa),
        east=lib.OpenBoundaryCondition(tide, scheme=pa))
    weno = (ja.WENO(5, smoothness_dtype=jnp.float64) if J
            else ot.WENO(5, smoothness_dtype=F64))
    return grid, dict(advection=weno,
                      buoyancy=jb.BuoyancyTracer() if J
                      else ot.BuoyancyTracer(),
                      boundary_conditions={"u": u_bcs})


def immersed_tight(jgrid, tgrid):
    jbcs = jbc.regularize_field_boundary_conditions(None, jgrid, CCC)
    tbcs = t_reg(None, tgrid, CCC)
    return (jcg.make_immersed_poisson_solver(
        jgrid, lambda p: jbc.fill_halo_regions(p, jgrid, CCC, jbcs),
        JFFT(jgrid.underlying_grid), reltol=1e-13, maxiter=500),
        make_immersed_poisson_solver(
            tgrid, lambda p: t_fill(p, tgrid, CCC, tbcs),
            FFTPoissonSolver(tgrid.underlying_grid), reltol=1e-13,
            maxiter=500))


@pytest.mark.parametrize("tight", [True, False], ids=["tight", "default"])
def test_seamount_against_jax(tight):
    jgrid, jkw = seamount(jbc, True)
    tgrid, tkw = seamount(ot, False)
    if tight:
        jsol, tsol = immersed_tight(JModel(grid=jgrid, **jkw).grid,
                                    tgrid.with_halo((3, 0, 3)))
        jkw, tkw = dict(jkw, pressure_solver=jsol), dict(
            tkw, pressure_solver=tsol)
    jm = JModel(grid=jgrid, **jkw)
    tm = NonhydrostaticModel(tgrid, **tkw)
    assert tm.grid.H == (3, 0, 3)
    assert [s[:3] for s in tm._open_sides] == [("u", 0, True),
                                               ("u", 0, False)]
    rng = np.random.default_rng(0)
    jm.set(b=lambda x, y, z: 1e-5 * z, u=0.05 * rng.standard_normal(
        (64, 1, 16)))
    state_from_jax(numpy_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(20.0)
        tm.time_step(20.0)
    compare(jm, tm, 1e-10 if tight else 1e-6)


def test_seamount_solver_at_128x32_against_jax():
    """Each package's immersed CG for the seamount at 128×32 (the default
    reltol 1e-7) on one right-hand side, the divergence of a seeded flow
    through the fluid faces: at the default maxiter of 200 both stop short
    of the tolerance, as the research-size rows do, with residuals within
    a factor of 2 of each other (their iterates differ there by more than
    the roundoff of a converged solve); given 1000 iterations both
    converge and their solutions agree to 1e-6."""
    from oceananigans_tpu_torch.models.nonhydrostatic import \
        _interior_divergence
    from oceananigans_tpu_torch.solvers.conjugate_gradient import \
        conjugate_gradient
    jgrid, jkw = seamount(jbc, True, 128, 32)
    tgrid, tkw = seamount(ot, False, 128, 32)
    jm = JModel(grid=jgrid, **jkw)
    tm = NonhydrostaticModel(tgrid, **tkw)
    g = tm.grid
    rng = np.random.default_rng(4)
    u, v, w = (torch.zeros(g.padded_shape, dtype=F64) for _ in range(3))
    u[g.interior_slices] = torch.as_tensor(rng.standard_normal(g.N))
    w[g.interior_slices] = torch.as_tensor(rng.standard_normal(g.N))
    u *= g.fluid_mask(("f", "c", "c"))
    w *= g.fluid_mask(("c", "c", "f"))
    u[g.H[0]] = u[g.H[0] + g.N[0]] = 0
    w[..., g.H[2]] = w[..., g.H[2] + g.N[2]] = 0
    b = _interior_divergence(g, u, v, w)
    jbcs = jbc.regularize_field_boundary_conditions(None, jm.grid, CCC)
    tbcs = t_reg(None, g, CCC)
    for maxiter in (200, 1000):
        js = jcg.make_immersed_poisson_solver(
            jm.grid, lambda p: jbc.fill_halo_regions(p, jm.grid, CCC, jbcs),
            JFFT(jm.grid.underlying_grid), maxiter=maxiter)
        ts = make_immersed_poisson_solver(
            g, lambda p: t_fill(p, g, CCC, tbcs),
            FFTPoissonSolver(g.underlying_grid), maxiter=maxiter)
        conjugate_gradient.iterations.clear()
        xt = ts.solve(b)
        xj = torch.as_tensor(np.asarray(js.solve(jnp.asarray(b.numpy()))))
        bm = torch.where(ts.solid, torch.zeros((), dtype=F64), -b * ts.V)
        res_t, res_j = (float((bm - ts.operator(x)).norm() / bm.norm())
                        for x in (xt, xj))
        if maxiter == 200:
            assert list(conjugate_gradient.iterations) == [200]
            assert 1e-7 < res_t and 0.5 < res_t / res_j < 2, (res_t, res_j)
        else:
            assert list(conjugate_gradient.iterations)[0] < 1000
            assert max(res_t, res_j) <= 1e-7, (res_t, res_j)
            assert rel(xt.numpy(), xj.numpy()) <= 1e-6


def horizontal_convection(lib, J, nx=32, nz=16):
    """``examples/horizontal_convection.py``'s model at (nx, nz)."""
    Lx, H, Ra = 2.0, 1.0, 1e8
    nu = kappa = np.sqrt(Lx ** 3 / Ra)
    kw = dict(size=(nx, nz), x=(-Lx / 2, Lx / 2), z=(-H, 0),
              topology=(B, F, B))
    m = jnp if J else torch
    b_bcs = lib.FieldBoundaryConditions(top=lib.ValueBoundaryCondition(
        lambda x, y, t: -m.cos(2 * np.pi * x / Lx)))
    grid = (jo.RectilinearGrid(dtype=np.float64, **kw) if J
            else ot.RectilinearGrid(dtype=F64, device="cpu", **kw))
    return grid, dict(
        advection=(ja.WENO(5, smoothness_dtype=jnp.float64) if J
                   else ot.WENO(5, smoothness_dtype=F64)),
        buoyancy=jb.BuoyancyTracer() if J else ot.BuoyancyTracer(),
        tracers=("b",),
        closure=(jc.ScalarDiffusivity if J else ot.ScalarDiffusivity)(
            nu=nu, kappa={"b": kappa}),
        boundary_conditions={"b": b_bcs})


def test_horizontal_convection_against_jax():
    jgrid, jkw = horizontal_convection(jbc, True)
    tgrid, tkw = horizontal_convection(ot, False)
    jm = JModel(grid=jgrid, **jkw)
    tm = NonhydrostaticModel(tgrid, fuse_correction=False, **tkw)
    rng = np.random.default_rng(3)
    jm.set(u=1e-3 * rng.standard_normal((32, 1, 16)),
           b=lambda x, y, z: 0.1 * z)
    state_from_jax(numpy_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(1e-2)
        tm.time_step(1e-2)
    compare(jm, tm, 1e-10)


def test_w_and_per_point_conditions_against_jax():
    """w with an Open top condition under PerturbationAdvection (its value
    a callable of x, y and t; the mass balance shifts it), b with a
    callable Value bottom and an array Gradient top, u with an array Value
    on the bottom, on (P, B, B)."""
    N = (8, 6, 8)
    kw = dict(size=N, extent=(1.0, 1.0, 1.0), topology=(P, B, B))
    rng = np.random.default_rng(9)
    grad_top = 0.01 * rng.standard_normal((8, 6))
    u_bottom = 0.02 * rng.standard_normal((8, 6))
    built = []
    for J in (True, False):
        lib = jbc if J else ot
        m = jnp if J else torch
        bcs = {"w": lib.FieldBoundaryConditions(top=lib.OpenBoundaryCondition(
            lambda x, y, t, m=m: 0.01 * m.sin(2 * np.pi * x) * (1 + t),
            scheme=lib.PerturbationAdvection(0.5, np.inf))),
            "b": lib.FieldBoundaryConditions(
                bottom=lib.ValueBoundaryCondition(
                    lambda x, y, t, m=m: 0.1 * m.cos(2 * np.pi * x) + 0 * y),
                top=lib.GradientBoundaryCondition(grad_top)),
            "u": lib.FieldBoundaryConditions(
                bottom=lib.ValueBoundaryCondition(u_bottom))}
        physics = dict(advection=ja.Centered(2) if J else ot.Centered(2),
                       buoyancy=jb.BuoyancyTracer() if J
                       else ot.BuoyancyTracer(), tracers=("b",),
                       closure=(jc.ScalarDiffusivity if J
                                else ot.ScalarDiffusivity)(nu=1e-3,
                                                           kappa=1e-3),
                       boundary_conditions=bcs)
        if J:
            built.append(JModel(grid=jo.RectilinearGrid(dtype=np.float64,
                                                         **kw), **physics))
        else:
            built.append(NonhydrostaticModel(ot.RectilinearGrid(
                dtype=F64, device="cpu", **kw), fuse_correction=False,
                **physics))
    jm, tm = built
    assert tm.bcs["w"].top.scheme is not None and not tm._z_compact
    assert tm._regions["w"][2] == slice(3, 3 + 8 + 1)
    jm.set(u=0.05 * rng.standard_normal(N), b=lambda x, y, z: 0.2 * z)
    state_from_jax(numpy_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(5e-2)
        tm.time_step(5e-2)
    compare(jm, tm, 1e-10)


def test_field_time_series_value_condition_against_jax(tmp_path):
    """A FieldTimeSeries as a Value condition on c's top (the port took it
    as a Flux condition only)."""
    from oceananigans_tpu.simulation.output_readers import \
        FieldTimeSeries as JFTS
    from test_torch_simulation import N as SIM_N, _nh_pair, _snapshot_dataset
    path = str(tmp_path / "value")
    _snapshot_dataset(path, SIM_N[:2], [0.0, 1.5e-3, 3e-3], seed=9)
    jfts = jo.FieldTimeSeriesBoundaryCondition(JFTS(path, "q"),
                                               classification="value")
    tfts = ot.FieldTimeSeriesBoundaryCondition(
        ot.FieldTimeSeries(path, "q", device="cpu"), classification="value")
    jm, tm = _nh_pair(
        jkw=dict(boundary_conditions={"c": jo.FieldBoundaryConditions(
            top=jfts)}),
        tkw=dict(boundary_conditions={"c": ot.FieldBoundaryConditions(
            top=tfts)}))
    for _ in range(3):
        jm.time_step(1e-3)
        tm.time_step(1e-3)
    for name in ("u", "v", "w", "c"):
        got = tm.field(name).interior.numpy()
        want = np.asarray(jm.field(name).interior)
        assert rel(got, want) <= 1e-10, name


def test_hydrostatic_lateral_open_against_jax():
    """``tests/test_hydrostatic_model.py``'s channel: an Open inflow and a
    PerturbationAdvection outflow on u, which the hydrostatic model fills
    without Δt (a pinned face, as in JAX), 3 steps from a perturbed
    through-flow."""
    U0 = 0.2
    N = (32, 4, 8)
    built = []
    for J in (True, False):
        lib = jbc if J else ot
        kw = dict(size=N, x=(0, 4.0), y=(0, 1.0), z=(-1.0, 0.0),
                  topology=(B, P, B))
        u_bcs = lib.FieldBoundaryConditions(
            west=lib.OpenBoundaryCondition(U0),
            east=lib.OpenBoundaryCondition(U0, scheme=lib.PerturbationAdvection(
                inflow_timescale=0.1)))
        if J:
            built.append(JHydro(grid=jo.RectilinearGrid(dtype=np.float64,
                                                         **kw),
                                tracers=("c",), free_surface=JEFS(),
                                boundary_conditions={"u": u_bcs}))
        else:
            built.append(ot.HydrostaticFreeSurfaceModel(
                ot.RectilinearGrid(dtype=F64, device="cpu", **kw),
                tracers=("c",), free_surface=ot.ExplicitFreeSurface(),
                boundary_conditions={"u": u_bcs}))
    u0 = U0 + 0.01 * np.random.default_rng(0).standard_normal(N)
    c0 = lambda x, y, z: np.exp(-(x - 1.0) ** 2 / 0.05)
    for m in built:
        m.set(u=u0, c=c0)
    for _ in range(3):
        for m in built:
            m.time_step(0.005)
    jm, tm = built
    for name in ("u", "v", "c", "eta", "w"):
        assert rel(tm.field(name).interior.numpy(),
                   np.asarray(jm.field(name).interior)) <= 1e-10, name


def test_open_boundary_radiation_golden():
    """``tests/test_regression.py``'s channel with a PerturbationAdvection
    outflow, 10 steps, against its golden file at 1e-9."""
    U0 = 0.3
    grid = ot.RectilinearGrid(size=(32, 1, 8), x=(0, 4.0), z=(-1.0, 0.0),
                              topology=(B, F, B), dtype=F64, device="cpu")
    u_bcs = ot.FieldBoundaryConditions(
        west=ot.OpenBoundaryCondition(U0),
        east=ot.OpenBoundaryCondition(U0, scheme=ot.PerturbationAdvection(
            inflow_timescale=0.1)))
    model = NonhydrostaticModel(grid, advection=ot.Centered(2),
                                boundary_conditions={"u": u_bcs},
                                tracers=("c",))
    model.set(u=U0, c=lambda x, y, z: np.exp(-(x - 1.0) ** 2 / 0.05))
    for _ in range(10):
        model.time_step(0.01)
    with np.load(os.path.join(
            DATA, "regression_open_boundary_radiation.npz")) as ref:
        for field in ref.files:
            got = model.field(field).interior.numpy()
            want = ref[field]
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
            assert err < 1e-9, (field, err)


# -- what stays refused -----------------------------------------------------------

def test_refused_conditions_raise():
    """A FieldTimeSeries condition on an x or y side (JAX pads its
    snapshots as z planes), field dependencies on a Value condition and a
    scheme on a Flux condition raise; a callable immersed condition,
    refused before item 3 was closed, deposits its flux (the model's case
    against JAX is in tests/test_torch_long_tail.py)."""
    from oceananigans_tpu_torch.boundary_conditions.boundary_condition \
        import BoundaryCondition, FieldTimeSeriesBoundaryCondition
    grid = ot.RectilinearGrid(size=(6, 5, 4), extent=(1.0, 1.0, 1.0),
                              topology=(B, B, B), dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match="z-normal"):
        t_reg(ot.FieldBoundaryConditions(
            west=FieldTimeSeriesBoundaryCondition(None)), grid, CCC)
    with pytest.raises(ValueError, match="field dependencies"):
        t_reg(ot.FieldBoundaryConditions(top=BoundaryCondition(
            "value", lambda x, y, t, u: u, field_dependencies=("u",))),
            grid, CCC)
    with pytest.raises(ValueError, match="scheme"):
        t_reg(ot.FieldBoundaryConditions(top=BoundaryCondition(
            "flux", 1.0, scheme=ot.PerturbationAdvection())), grid, CCC)
    from oceananigans_tpu_torch.boundary_conditions.fill_halos import \
        apply_immersed_flux_bcs
    ig = TIBG(grid, ot.GridFittedBottom(-0.5))
    G = apply_immersed_flux_bcs(
        torch.zeros(grid.padded_shape, dtype=F64), ig, CCC,
        ot.ImmersedBoundaryCondition(bottom=ot.FluxBoundaryCondition(
            lambda x, y, t: 1.0 + x)))
    assert torch.isfinite(G).all() and G.abs().max() > 0
