"""The multi-dimensional vector-invariant stencil of the port against the JAX
package's, on the CPU in float64.

- ``advection/multidimensional.py`` ``centered_weno5_filter`` along each
  axis of seeded padded arrays, every slot: 1e-14 of the scale;
- its constant preservation and convergence (the checks of
  ``tests/test_hydrostatic_model.py``'s multi-dimensional test);
- the VectorInvariant terms with ``multi_dimensional_stencil=True``
  (vorticity, Bernoulli head, vertical with the divergence flux) on
  bounded and periodic lat-lon grids: 1e-12;
- #10's plain version (``fused_vi_tendency_plain``) with the stencil
  against the JAX Pallas kernel in interpret mode: the hydro_row
  configuration (WENO-9 vorticity, spherical Coriolis, WENO(5) tracer and
  pₕ′) at H = 8 and a WENO-5 one at H = 6, 1e-12;
- the 24×24×2 model of that test over 5 steps: 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.advection.multidimensional import \
    centered_weno5_filter as j_filter
from oceananigans_tpu.advection.vector_invariant import \
    WENOVectorInvariant as JWVI
from oceananigans_tpu.coriolis import HydrostaticSphericalCoriolis as JHSC
from oceananigans_tpu.kernels.fused_vector_invariant import (
    build_fused_hydrostatic_tendency, eligible_hydrostatic)
from oceananigans_tpu.models.free_surfaces import \
    ExplicitFreeSurface as JExplicit
from oceananigans_tpu.models.hydrostatic import \
    HydrostaticFreeSurfaceModel as JModel
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.advection.multidimensional import \
    centered_weno5_filter
from oceananigans_tpu_torch.kernels.fused_vector_invariant import (
    fused_vi_tendency_plain, kept_slices, vi_config)
from oceananigans_tpu_torch.models.hydrostatic import (
    HydrostaticFreeSurfaceModel, state_from_jax)
from test_torch_hydrostatic import (BOUNDED_X, PERIODIC_X, _crop, _fields,
                                    _grids, _rel)

torch.set_num_threads(1)

F64 = torch.float64


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_filter_against_jax(axis):
    rng = np.random.default_rng(axis)
    a = rng.standard_normal((14, 11, 9))
    a[3:6] *= 1e-3     # a smooth and a rough region
    got = centered_weno5_filter(torch.as_tensor(a), axis).numpy()
    want = np.asarray(j_filter(jnp.asarray(a), axis))
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


def test_filter_constant_and_convergence():
    """Constants pass exactly (Σ weights·coefficients = 1); on point samples
    of sin x the filter deviates from the identity at O(Δ²) and converges."""
    out = centered_weno5_filter(torch.full((12, 12, 4), 3.7, dtype=F64), 0)
    assert float((out[3:-3] - 3.7).abs().max()) < 1e-12

    def err(n):
        x = np.linspace(0, 2 * np.pi, n, endpoint=False)
        f = torch.as_tensor(np.broadcast_to(np.sin(x)[:, None, None],
                                            (n, 4, 4)).copy())
        return float((centered_weno5_filter(f, 0) - f)[3:-3].abs().max())
    e32, e64 = err(32), err(64)
    assert e32 < 2e-3 and e64 < 0.3 * e32


def _vis(order, upwinding="only_self"):
    kw = dict(multi_dimensional_stencil=True, upwinding=upwinding)
    return (JWVI(order=order, smoothness_dtype=jnp.float64, **kw),
            ot.WENOVectorInvariant(order=order, smoothness_dtype=F64, **kw))


@pytest.mark.parametrize("lon", [BOUNDED_X, PERIODIC_X],
                         ids=["bounded_x", "periodic_x"])
@pytest.mark.parametrize("order,upwinding", [(5, "only_self"), (None,
                                                               "only_self"),
                                             (5, "cross_and_self")])
def test_vector_invariant_terms(lon, order, upwinding):
    jv, tv = _vis(order, upwinding)
    H = tv.required_halo
    assert H == jv.required_halo == (6 if order == 5 else 8)
    jg, tg = _grids(lon, jhalo=(H, H, H), thalo=(H, H, H))
    J, T = _fields(jg, tg, 7)
    su, sv, _ = kept_slices(tg)
    for term, args in (("_horizontal", ("u", "v")),
                       ("_bernoulli", ("u", "v")),
                       ("_vertical", ("u", "v", "w")),
                       ("momentum_tendencies", ("u", "v", "w"))):
        ja = getattr(jv, term)(jg, *[J[a] for a in args])
        ta = getattr(tv, term)(tg, *[T[a] for a in args])
        for j, t, sl in zip(ja, ta, (su, sv)):
            assert _rel(t.numpy()[sl], np.asarray(j)[sl]) < 1e-12, term


@pytest.mark.parametrize("order", [None, 5], ids=["weno9_h8", "weno5_h6"])
def test_plain_against_pallas(order):
    """#10's plain version with the stencil against the JAX Pallas kernel
    in interpret mode (JAX's eligible_hydrostatic takes the stencil)."""
    jv, tv = _vis(order)
    H = tv.required_halo
    # the JAX kernel wants Hy a multiple of 8
    jg, tg = _grids(BOUNDED_X, jhalo=(H, 8, H), thalo=(H, H, H))
    J, T = _fields(jg, tg, 3)
    js = JWENO(5, smoothness_dtype=jnp.float64)
    ts = ot.WENO(5, smoothness_dtype=F64)
    assert eligible_hydrostatic(jg, jv, js, ("T",))
    assert vi_config(tg, tv, ts, 1, ot.HydrostaticSphericalCoriolis())["md"]
    fn = build_fused_hydrostatic_tendency(jg, jv, js, ("T",), coriolis=JHSC(),
                                          with_ph=True)
    jGu, jGv, jGc = fn(J["u"], J["v"], J["w"], {"T": J["T"]}, J["ph"])
    Gu, Gv, Gc = fused_vi_tendency_plain(
        tg, tv, ts, ("T",), ot.HydrostaticSphericalCoriolis(), T["u"],
        T["v"], T["w"], {"T": T["T"]}, T["ph"])
    for j, t, sl in zip((jGu, jGv, jGc["T"]), (Gu, Gv, Gc["T"]),
                        kept_slices(tg)):
        assert _rel(t.numpy()[sl], _crop(j, tg.padded_shape)[sl]) < 1e-12


def test_model_against_jax():
    """The 24×24×2 WENOVectorInvariant(order=5) model with the stencil and
    an explicit free surface, 5 steps at 1e-10."""
    def make(J):
        lib = jo if J else ot
        kw = dict(size=(24, 24, 2), extent=(1, 1, 1),
                  topology=("periodic", "periodic", "bounded"))
        g = (jo.RectilinearGrid(dtype=np.float64, **kw) if J else
             ot.RectilinearGrid(dtype=F64, device="cpu", **kw))
        adv = (JWVI if J else ot.WENOVectorInvariant)(
            order=5, multi_dimensional_stencil=True,
            smoothness_dtype=jnp.float64 if J else F64)
        m = (JModel if J else HydrostaticFreeSurfaceModel)(
            g, momentum_advection=adv,
            free_surface=(JExplicit if J else ot.ExplicitFreeSurface)(
                gravitational_acceleration=0.1))
        if J:
            m.set(u=lambda x, y, z: np.tanh(8 * (y - 0.5))
                  + 0.05 * np.sin(2 * np.pi * x))
        return m

    jm, tm = make(True), make(False)
    state_from_jax({k: ({n: np.asarray(a) for n, a in v.items()}
                        if isinstance(v, dict) else np.asarray(v))
                    for k, v in jm.state.items()}, tm)
    for _ in range(5):
        jm.time_step(2e-3)
        tm.time_step(2e-3)
    for name in ("u", "v", "eta", "w"):
        a = np.asarray(jm.field(name).interior)
        b = tm.field(name).interior.numpy()
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max(), name
    assert np.isfinite(tm.field("u").interior.numpy()).all()


def test_kernel_filter_constants():
    """csrc/vi_kernel.cuh's md_filter reads the plain version's constants:
    its tables (OC_MD_CONSTANTS) hold FILTER_CONSTANTS' float64 values
    exactly."""
    import os
    import re
    from oceananigans_tpu_torch.advection.multidimensional import \
        FILTER_CONSTANTS
    path = os.path.join(os.path.dirname(ot.__file__), "csrc",
                        "vi_kernel.cuh")
    src = open(path).read()
    body = re.search(r"#define OC_MD_CONSTANTS \\\n((?:.*\\\n)*.*)\n",
                     src).group(1)
    values = tuple(float(x) for x in body.replace("\\", " ").split(","))
    assert values == FILTER_CONSTANTS


def test_kernel_takes_the_stencil_in_the_fields_dtype():
    """#10's stencil family is built for the smoothness in the fields'
    dtype (or bfloat16 with float32 fields): vi_config refuses another
    pair, naming item 13, and "auto" then takes the plain tendency."""
    _, tg = _grids(BOUNDED_X, thalo=(8, 8, 8))
    hsc = ot.HydrostaticSphericalCoriolis()
    for sdt in (F64, None):
        kw = {} if sdt is None else dict(smoothness_dtype=sdt)
        vi = ot.WENOVectorInvariant(multi_dimensional_stencil=True, **kw)
        if sdt is None:   # float32 smoothness on float64 fields
            with pytest.raises(NotImplementedError, match="item 13"):
                vi_config(tg, vi, ot.Centered(2), 1, hsc)
        else:
            assert vi_config(tg, vi, ot.Centered(2), 1, hsc)["md"] == 1
    m = HydrostaticFreeSurfaceModel(
        tg, momentum_advection=ot.WENOVectorInvariant(
            multi_dimensional_stencil=True), tracers=("T",))
    assert not m.uses_kernel
