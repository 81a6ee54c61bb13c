"""The port's momentum flux divergences against the JAX package's, at
(8, 8, 16) on random float64 fields, in the z-compact layout (no z halo, z
boundary conditions inside the stencil reads) and in the padded layout.

Bounds, relative to max|G|:
- WENO with float64 smoothness on both sides, and the linear schemes:
  1e-12. Both sides evaluate the same stencils in float64; only the
  association of a few sums differs, which is roundoff.
- WENO with the default float32 smoothness: 1e-6. The smoothness
  indicators β are rounded to float32 on both sides; a one-ulp difference
  in one β (from float64 roundoff upstream of the cast) moves a nonlinear
  weight by about 2·2⁻²⁴ relative through (τ/(β+ε))², which bounds the
  change of the reconstruction well below 1e-6 of max|G|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import (Centered as JCentered,
                                        UpwindBiased as JUpwind,
                                        WENO as JWENO)
from oceananigans_tpu.advection.fluxes import div_Uu as j_div_Uu
from oceananigans_tpu.advection.fluxes import div_Uv as j_div_Uv
from oceananigans_tpu.advection.fluxes import div_Uw as j_div_Uw
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu_torch.advection import (Centered, UpwindBiased, WENO,
                                              div_Uu, div_Uv, div_Uw)
from oceananigans_tpu_torch.grids import RectilinearGrid as TGrid

torch.set_num_threads(1)

N = (8, 8, 16)
ZBC = {"u": "even", "v": "even", "w": "odd_face"}
LAYOUTS = {"compact": (4, 4, 0), "padded": (3, 3, 3)}

SCHEMES = {
    "weno5_f64": (lambda: JWENO(5, smoothness_dtype=jnp.float64),
                  lambda: WENO(5, smoothness_dtype=torch.float64), 1e-12),
    "weno5_f32": (lambda: JWENO(5), lambda: WENO(5), 1e-6),
    "weno3_f64": (lambda: JWENO(3, smoothness_dtype=jnp.float64),
                  lambda: WENO(3, smoothness_dtype=torch.float64), 1e-12),
    "upwind3": (lambda: JUpwind(3), lambda: UpwindBiased(3), 1e-12),
    "centered4": (lambda: JCentered(4), lambda: Centered(4), 1e-12),
}


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    arrays = [0.1 * rng.standard_normal(shape) for _ in range(3)]
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_momentum_flux_divergences(layout, scheme):
    halo = LAYOUTS[layout]
    jg = JGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo, dtype=np.float64)
    tg = TGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo, dtype=torch.float64,
               device="cpu")
    jmake, tmake, tol = SCHEMES[scheme]
    js, ts = jmake(), tmake()
    zbc = ZBC if layout == "compact" else None
    (ju, jv, jw), (tu, tv, tw) = _fields(jg.padded_shape, seed=7)
    ints = jg.interior_slices
    for jdiv, tdiv in ((j_div_Uu, div_Uu), (j_div_Uv, div_Uv),
                       (j_div_Uw, div_Uw)):
        want = np.asarray(jdiv(jg, js, ju, jv, jw, zbc=zbc))[ints]
        got = tdiv(tg, ts, tu, tv, tw, zbc=zbc)[ints].numpy()
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= tol, (jdiv.__name__, err)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_single_axis_terms(axis):
    """``only_axis`` evaluates one directional term; float64 smoothness,
    bound 1e-12 relative."""
    halo = LAYOUTS["compact"]
    jg = JGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo, dtype=np.float64)
    tg = TGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo, dtype=torch.float64,
               device="cpu")
    js = JWENO(5, smoothness_dtype=jnp.float64)
    ts = WENO(5, smoothness_dtype=torch.float64)
    (ju, jv, jw), (tu, tv, tw) = _fields(jg.padded_shape, seed=8)
    ints = jg.interior_slices
    want = np.asarray(j_div_Uw(jg, js, ju, jv, jw, zbc=ZBC,
                               only_axis=axis))[ints]
    got = div_Uw(tg, ts, tu, tv, tw, zbc=ZBC, only_axis=axis)[ints].numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("scheme", ["weno5_f64", "weno3_f64", "upwind3",
                                    "centered4"])
def test_biased_pair(scheme, beta, axis):
    """Left- and right-biased reconstructions on the padded layout (z is
    bounded, so the near-wall cascade applies along it); bound as above."""
    halo = LAYOUTS["padded"]
    jg = JGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo, dtype=np.float64)
    tg = TGrid(size=N, extent=(1.0, 1.0, 1.0), halo=halo, dtype=torch.float64,
               device="cpu")
    jmake, tmake, tol = SCHEMES[scheme]
    (ja, _, _), (ta, _, _) = _fields(jg.padded_shape, seed=9)
    ints = jg.interior_slices
    for want, got in zip(jmake().biased_pair(jg, ja, axis, beta),
                         tmake().biased_pair(tg, ta, axis, beta)):
        want = np.asarray(want)[ints]
        got = got[ints].numpy()
        assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


# -- WENO(7/9), smooth= and the bounded x/y cascade --------------------------------

@pytest.mark.parametrize("smooth", [False, True], ids=["own", "smooth"])
@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("order", [7, 9])
def test_weno_high_order_biased_by(order, axis, beta, smooth):
    """WENO(7) and WENO(9) ``biased_by`` and ``biased_pair`` along a bounded
    x or y (the 9 → 7 → 5 → 3 → 1 cascade near the walls), with the
    smoothness summed over two other arrays (``smooth=``, the velocity
    stencil) or from the field itself, against JAX: 1e-13 relative. One
    array is metric-scaled (about 1e5) so that r = τ/(β+ε) reaches its 1e12
    saturation in some cells."""
    from oceananigans_tpu.grids.latlon import LatitudeLongitudeGrid as JLL
    from oceananigans_tpu_torch.grids import LatitudeLongitudeGrid as TLL
    cfg = dict(size=(14, 12, 3), longitude=(0, 60), latitude=(15, 75),
               z=(-10.0, 0.0), halo=(6, 6, 3))
    jg = JLL(dtype=np.float64, **cfg)
    tg = TLL(dtype=torch.float64, device="cpu", **cfg)
    rng = np.random.default_rng(order + axis)
    a, q, s1, s2 = (rng.standard_normal(jg.padded_shape) for _ in range(4))
    s2 = 1e5 * s2
    s2[:, :, 1] = 0.0          # a smooth plane: β = 0 there
    js = JWENO(order, smoothness_dtype=jnp.float64)
    ts = WENO(order, smoothness_dtype=torch.float64)
    jsm = [jnp.asarray(s1), jnp.asarray(s2)] if smooth else None
    tsm = [torch.as_tensor(s1), torch.as_tensor(s2)] if smooth else None
    want = js.biased_by(jg, jnp.asarray(a), axis, beta, jnp.asarray(q),
                        smooth=jsm)
    got = ts.biased_by(tg, torch.as_tensor(a), axis, beta,
                       torch.as_tensor(q), smooth=tsm)
    sl = tuple(slice(h, h + n + 1) for h, n in zip(tg.H, tg.N))
    scale = np.abs(np.asarray(want)[sl]).max()
    assert np.abs(got.numpy()[sl] - np.asarray(want)[sl]).max() / scale \
        < 1e-13
    jl, jr = js.biased_pair(jg, jnp.asarray(a), axis, beta, smooth=jsm)
    tl, tr = ts.biased_pair(tg, torch.as_tensor(a), axis, beta, smooth=tsm)
    for j, t in ((jl, tl), (jr, tr)):
        assert np.abs(t.numpy()[sl] - np.asarray(j)[sl]).max() / scale \
            < 1e-13
