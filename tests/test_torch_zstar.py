"""The z* coordinate of the port's hydrostatic model against the JAX
package's, on the CPU in float64.

- ``models/zstar.py``: ``ZStarGrid``'s metrics and ``sigma_from_eta``, exact;
- the model over 3 steps at 1e-10 of each field's scale (the prognostic
  fields, w, and the z* state: the grid's η, ∂t_σ and the AB2 memory of
  δh_U): a RectilinearGrid with a stretched z, a lat-lon grid and an
  immersed grid, under the split-explicit and the implicit free surfaces,
  quasi-AB2 and the split RK3, CATKE with its substepped TKE, and
  ``examples/internal_tide.py``'s construction on z*;
- the invariants of ``tests/test_zstar_coordinate.py`` in the port over 20
  steps at 1e-12: a uniform tracer stays uniform, the σ-weighted tracer
  totals (the volume) are conserved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
from oceananigans_tpu.buoyancy import BuoyancyTracer as JBuoy
from oceananigans_tpu.closures.catke import CATKEVerticalDiffusivity as JCATKE
from oceananigans_tpu.immersed import (GridFittedBottom as JGFB,
                                       ImmersedBoundaryGrid as JIBG)
from oceananigans_tpu.models.free_surfaces import (
    ImplicitFreeSurface as JImplicit, SplitExplicitFreeSurface as JSplit)
from oceananigans_tpu.models.hydrostatic import \
    HydrostaticFreeSurfaceModel as JModel
from oceananigans_tpu.models.zstar import (ZStarGrid as JZStarGrid,
                                           sigma_from_eta as j_sigma)
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.models.hydrostatic import (
    ZSTAR_STATE, HydrostaticFreeSurfaceModel, state_from_jax)
from oceananigans_tpu_torch.models.zstar import ZStarGrid, sigma_from_eta
from test_torch_hydrostatic_options import (compare, internal_tide,
                                            np_state, weno)

torch.set_num_threads(1)

F64 = torch.float64
_rng = np.random.default_rng(1234)
Z_FACES = np.array([i + (0.0 if i in (-20, 0) else float(_rng.random()))
                    for i in range(-20, 1)], float)
Z_FACES[0], Z_FACES[-1] = -20.0, 0.0
BOTTOM = -10.0 + 4.0 * np.random.default_rng(7).random((8, 8))


def _grid(kind, J, nz=20):
    lib = jo if J else ot
    kw = dict(dtype=np.float64) if J else dict(dtype=F64, device="cpu")
    z = Z_FACES if nz == 20 else (-20.0, 0.0)
    if kind == "latlon":
        return lib.LatitudeLongitudeGrid(
            size=(8, 8, nz), longitude=(0, 1), latitude=(0, 1), z=z,
            topology=("periodic", "bounded", "bounded"), **kw)
    g = lib.RectilinearGrid(size=(8, 8, nz), x=(0, 100e3), y=(-10e3, 10e3),
                            z=z, topology=("periodic", "periodic", "bounded"),
                            **kw)
    if kind == "immersed":
        return (JIBG if J else ot.ImmersedBoundaryGrid)(
            g, (JGFB if J else ot.GridFittedBottom)(BOTTOM))
    return g


def _eta(kind):
    if kind == "latlon":
        return lambda x, y, z: 0.3 * np.sin(2 * np.pi * (x - 0.5)) + 0 * y
    return lambda x, y, z: 0.3 * np.sin(2 * np.pi * (x - 5e4) / 1e5) + 0 * y


def _model(kind, fs, stepper, J):
    free_surface = {"split": (JSplit if J else ot.SplitExplicitFreeSurface)(
        substeps=20), "implicit": (JImplicit if J else
                                   ot.ImplicitFreeSurface)()}[fs]
    return (JModel if J else HydrostaticFreeSurfaceModel)(
        _grid(kind, J), free_surface=free_surface, timestepper=stepper,
        tracers=("b", "c", "constant"), vertical_coordinate="zstar",
        momentum_advection=(jo if J else ot).VectorInvariant())


def _set(m, kind):
    Nx, Ny, Nz = m.grid.N
    rng = np.random.default_rng(1234)
    xs = np.asarray(m.grid.coord_padded(0, "c"))
    xmid = 0.5 * (xs.min() + xs.max())
    m.set(b=lambda x, y, z: np.where(x < xmid, 0.06, 0.01) + 0 * z,
          c=rng.random((Nx, Ny, Nz)), constant=1.0,
          u=0.01 * rng.standard_normal((Nx, Ny, Nz)))
    m.set(eta=_eta(kind))


def _compare_w(jm, tm, tol=1e-10):
    """w on z* is the small residual of the divergence and the grid motion
    -Δr·∂t_σ that nearly cancel it: its error is held to the scale of the
    grid motion, max|∂t_σ|·H, as tests/test_zstar_coordinate.py holds the
    surface residual."""
    a = np.asarray(jm.field("w").interior)
    b = tm.field("w").interior.numpy()
    scale = max(np.abs(a).max(), np.abs(np.asarray(
        jm.state["dt_sigma"])).max() * abs(tm.grid.extent[2]))
    assert np.abs(a - b).max() <= tol * scale


def _compare_all(jm, tm, tol=1e-10, names=None):
    compare(jm, tm, names or tuple(tm.prognostic_names), tol)
    _compare_w(jm, tm, tol)
    for key in ZSTAR_STATE:
        a = np.asarray(jm.state[key])
        b = tm.state[key].numpy()
        sl = tuple(slice((x - y) // 2, (x - y) // 2 + y)
                   for x, y in zip(a.shape, b.shape))
        ints = tm.grid.interior_slices[:2] + (slice(None),)
        a, b = a[sl][ints], b[ints]
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert err <= tol, (key, err)


def test_zstar_grid_metrics():
    """ZStarGrid's Δz, Ax, Ay, V and Az and σ at each staggering, from one
    σ at the centres (faces interpolated) and from a per-staggering dict,
    on a stretched RectilinearGrid: exact against JAX."""
    jg, tg = _grid("rect", True), _grid("rect", False)
    shape = tg.padded_shape[:2] + (1,)
    rng = np.random.default_rng(0)
    s = 1.0 + 0.01 * rng.standard_normal(shape)
    sd = {k: 1.0 + 0.01 * rng.standard_normal(shape)
          for k in (("c", "c"), ("f", "c"), ("c", "f"))}
    for sig in (s, sd):
        js = ({k: jnp.asarray(v) for k, v in sig.items()}
              if isinstance(sig, dict) else jnp.asarray(sig))
        ts = ({k: torch.as_tensor(v) for k, v in sig.items()}
              if isinstance(sig, dict) else torch.as_tensor(sig))
        jz, tz = JZStarGrid(jg, js), ZStarGrid(tg, ts)
        for loc in (("c", "c", "c"), ("f", "c", "c"), ("c", "f", "c"),
                    ("f", "f", "c"), ("c", "c", "f")):
            for name in ("dz", "Ax", "Ay", "V", "Az"):
                a = np.broadcast_to(np.asarray(getattr(jz, name)(loc)),
                                    tg.padded_shape)
                b = torch.as_tensor(getattr(tz, name)(loc)).broadcast_to(
                    tg.padded_shape).numpy()
                assert np.array_equal(a, b), (name, loc)
    eta = rng.standard_normal(shape)
    wet = eta > 0
    assert np.array_equal(
        np.asarray(j_sigma(jg, jnp.asarray(eta), 20.0, jnp.asarray(wet))),
        sigma_from_eta(torch.as_tensor(eta), 20.0,
                       torch.as_tensor(wet)).numpy())


CASES = {
    "rect_split_qab2": ("rect", "split", "QuasiAdamsBashforth2"),
    "rect_implicit_rk3": ("rect", "implicit", "SplitRungeKutta3"),
    "latlon_split_rk3": ("latlon", "split", "SplitRungeKutta3"),
    "latlon_split_qab2": ("latlon", "split", "QuasiAdamsBashforth2"),
    "immersed_split_qab2": ("immersed", "split", "QuasiAdamsBashforth2"),
    "immersed_implicit_qab2": ("immersed", "implicit",
                               "QuasiAdamsBashforth2"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_zstar_model_against_jax(case):
    kind, fs, stepper = CASES[case]
    jm, tm = _model(kind, fs, stepper, True), _model(kind, fs, stepper, False)
    assert not tm.uses_kernel
    _set(jm, kind)
    state_from_jax(np_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(60.0)
        tm.time_step(60.0)
    _compare_all(jm, tm)


def _catke(J, vertical_coordinate="zstar"):
    lib = jo if J else ot
    kw = dict(dtype=np.float64) if J else dict(dtype=F64, device="cpu")
    g = lib.RectilinearGrid(size=(16, 4, 8), x=(0, 1e4), y=(0, 4e3),
                            z=(-100.0, 0.0),
                            topology=("periodic", "periodic", "bounded"), **kw)
    return (JModel if J else HydrostaticFreeSurfaceModel)(
        g, free_surface=(JSplit if J else ot.SplitExplicitFreeSurface)(
            substeps=20), tracers=("b", "e", "c"),
        buoyancy=JBuoy() if J else ot.BuoyancyTracer(),
        closure=(JCATKE if J else ot.CATKEVerticalDiffusivity)(),
        vertical_coordinate=vertical_coordinate, coriolis=lib.FPlane(f=1e-4),
        momentum_advection=lib.VectorInvariant(),
        boundary_conditions={"u": lib.FieldBoundaryConditions(
            top=lib.FluxBoundaryCondition(-1e-4))})


def _set_catke(m):
    m.set(b=lambda x, y, z: 1e-5 * z, c=1.0, e=1e-6,
          u=lambda x, y, z: 0.05 * np.cos(2 * np.pi * x / 1e4)
          * (1 + np.sin(2 * np.pi * y / 4e3)) + 0 * z,
          eta=lambda x, y, z: 0.3 * np.sin(2 * np.pi * x / 1e4) + 0 * z)


def _catke_pair(vertical_coordinate):
    jm = _catke(True, vertical_coordinate)
    tm = _catke(False, vertical_coordinate)
    _set_catke(jm)
    state_from_jax(np_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(30.0)
        tm.time_step(30.0)
    return jm, tm


def _rel_err(jm, tm, name):
    a = np.asarray(jm.field(name).interior)
    return np.abs(a - tm.field(name).interior.numpy()).max() \
        / np.abs(a).max()


def test_zstar_catke_against_jax():
    """CATKE with its substepped TKE on z*: e is left out of the σ-form
    update and advanced by step_turbulence; 3 steps, every field but e at
    1e-10. e carries the port's one known CATKE difference (the TKE
    substep's N² reads the AB2-updated tracers' halos in JAX, zero-
    tendency halos in the port: ROADMAP.md queue 3), about 1.2e-10 here on
    the static z as well; z* adds nothing to it."""
    jm, tm = _catke_pair("zstar")
    _compare_all(jm, tm, names=("u", "v", "b", "c", "eta"))
    jz, tz = _catke_pair("z")
    assert _rel_err(jm, tm, "e") <= max(1e-10, 1.1 * _rel_err(jz, tz, "e"))


def test_internal_tide_zstar_against_jax():
    """``examples/internal_tide.py`` on z*: WENO(5) flux-form momentum over
    the PartialCellBottom hill (σ from the fluid column depths, land
    columns at σ = 1), the split-explicit default free surface."""
    jm = internal_tide(True, vertical_coordinate="zstar")
    tm = internal_tide(False, vertical_coordinate="zstar")
    state_from_jax(np_state(jm.state), tm)
    for _ in range(3):
        jm.time_step(300.0)
        tm.time_step(300.0)
    _compare_all(jm, tm)


# -- the invariants in the port ------------------------------------------------------

def sigma_weighted_totals(m):
    """∫ c σ dV of each tracer, σ from the grid's η."""
    grid = m.grid
    sig = m._sigma_fields(m.state["eta_grid"])[("c", "c")]
    sx, sy, sz = grid.interior_slices
    V = torch.as_tensor(grid.V(("c", "c", "c"))).broadcast_to(
        grid.padded_shape)[sx, sy, sz]
    wet = 1.0
    if hasattr(grid, "fluid_mask"):
        wet = grid.fluid_mask(("c", "c", "c"), F64)[sx, sy, sz]
    return {n: float((m.field(n).interior * sig[sx, sy] * V * wet).sum())
            for n in m.tracer_names}


@pytest.mark.parametrize("kind,stepper", [
    ("rect", "QuasiAdamsBashforth2"), ("latlon", "SplitRungeKutta3"),
    ("immersed", "QuasiAdamsBashforth2")])
def test_zstar_invariants(kind, stepper):
    """Over 20 steps of 60 s: the σ-weighted totals of b and c conserved
    and the uniform tracer at 1, both to 1e-12; the surface moved."""
    m = _model(kind, "split", stepper, False)
    _set(m, kind)
    tot0 = sigma_weighted_totals(m)
    for _ in range(20):
        m.time_step(60.0)
    tot = sigma_weighted_totals(m)
    for name in ("b", "c"):
        assert abs(tot[name] - tot0[name]) <= 1e-12 * abs(tot0[name]), name
    const = m.field("constant").interior
    if kind == "immersed":
        const = const[m.grid.fluid_mask(("c", "c", "c"), torch.bool)[
            m.grid.interior_slices]]
    assert float((const - 1.0).abs().max()) <= 1e-12
    assert float(m.field("eta").interior.abs().max()) > 1e-3


def test_zstar_catke_constancy():
    """CATKE's substepped TKE beside the σ-form update: a uniform tracer
    stays at 1 to 1e-12 over 20 steps."""
    m = _catke(False)
    _set_catke(m)
    for _ in range(20):
        m.time_step(30.0)
    assert float((m.field("c").interior - 1.0).abs().max()) <= 1e-12
    assert torch.isfinite(m.field("e").interior).all()
