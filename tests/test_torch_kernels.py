"""The plain PyTorch version of each of the port's four kernels against the
JAX package's Pallas kernel it replaces, run in interpret mode on the CPU.

The JAX kernels run on a grid with H = (4, 8, 0) at (16, 16, 128), the
port's on H = (4, 4, 0): interiors are compared, and halo slots wherever
both layouts have them (x fully, y within the port's four rings).

Float64 fields with float64 WENO smoothness; bound 1e-12 relative to
max|reference| (the same stencils in another association order). The CUDA
kernels themselves are compared with these plain versions on the card by
chip_smoke.py and by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.boundary_conditions import \
    regularize_field_boundary_conditions
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.kernels.fused_advection import \
    build_fused_advection_update
from oceananigans_tpu.kernels.fused_projection import (build_fused_correct,
                                                       build_fused_divergence)
from oceananigans_tpu.kernels.pallas_fill import get_batched_fill
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K

torch.set_num_threads(1)

N = (16, 16, 128)
JH, TH = (4, 8, 0), (4, 4, 0)
TOL = 1e-12
LOCS = (("f", "c", "c"), ("c", "f", "c"), ("c", "c", "f"))


@pytest.fixture(scope="module")
def setup():
    jgrid = JGrid(size=N, extent=(1.0, 1.0, 1.0), halo=JH, dtype=np.float64)
    tgrid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=TH,
                               dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(11)
    interiors = [0.1 * rng.standard_normal(N) for _ in range(3)]
    interiors.append(1e-2 * rng.standard_normal(N))          # p
    gm = [rng.standard_normal(N) for _ in range(3)]

    def wrap(a, H):
        return np.pad(a, ((H[0], H[0]), (H[1], H[1]), (0, 0)), mode="wrap")

    jax_in = [jnp.asarray(wrap(a, JH)) for a in interiors]
    torch_in = [torch.as_tensor(wrap(a, TH)) for a in interiors]
    return dict(jgrid=jgrid, tgrid=tgrid, jax_in=jax_in, torch_in=torch_in,
                gm=gm, interiors=interiors)


def _padded_close(jarr, tarr):
    """Compare a JAX padded array (H = JH) with a port one (H = TH) on the
    slots both define; relative to max|JAX|."""
    j = np.asarray(jarr)[:, JH[1] - TH[1]:JH[1] + N[1] + TH[1]]
    t = tarr.numpy()
    assert j.shape == t.shape
    return np.max(np.abs(j - t)) / np.max(np.abs(j))


@pytest.fixture(scope="module")
def jax_update(setup):
    scheme = JWENO(5, smoothness_dtype=jnp.float64)
    return build_fused_advection_update(setup["jgrid"], scheme, (),
                                        with_corr=True)


@pytest.mark.parametrize("with_gm", [False, True])
@pytest.mark.parametrize("with_corr", [False, True])
def test_fused_advection_update(setup, jax_update, with_gm, with_corr):
    ju, jv, jw, jp = setup["jax_in"]
    tu, tv, tw, tp = setup["torch_in"]
    gdt, zdt, cdt = 0.1, -0.05, 0.07
    jgm = [jnp.asarray(g) for g in setup["gm"]] if with_gm else None
    tgm = [torch.as_tensor(g) for g in setup["gm"]] if with_gm else None
    jkw = dict(p=jp, corr_dt=cdt) if with_corr else {}
    tkw = dict(p=tp, corr_dt=cdt) if with_corr else {}
    jG, jnew = jax_update(ju, jv, jw, {}, jgm, gdt, zdt, **jkw)
    tG, tnew = K.fused_advection_update(
        setup["tgrid"], ot.WENO(5, smoothness_dtype=torch.float64),
        tu, tv, tw, tgm, gdt, zdt, **tkw)
    for k, name in enumerate("uvw"):
        want = np.asarray(jG[k])
        err = np.max(np.abs(tG[k].numpy() - want)) / np.max(np.abs(want))
        assert err <= TOL, ("G", name, err)
        assert _padded_close(jnew[name], tnew[name]) <= TOL, ("new", name)


def test_fused_divergence(setup):
    jfn = build_fused_divergence(setup["jgrid"])
    ju, jv, jw, _ = setup["jax_in"]
    tu, tv, tw, _ = setup["torch_in"]
    want = np.asarray(jfn(ju, jv, jw, 3.0))
    got = K.fused_divergence(setup["tgrid"], tu, tv, tw, 3.0).numpy()
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


def test_fused_correct(setup):
    jfn = build_fused_correct(setup["jgrid"])
    ju, jv, jw, jp = setup["jax_in"]
    tu, tv, tw, tp = setup["torch_in"]
    want = jfn(jp, ju, jv, jw, 0.2)
    got = K.fused_correct(setup["tgrid"], tp, tu, tv, tw, 0.2)
    for j, t in zip(want, got):
        assert _padded_close(j, t) <= TOL
    assert np.all(got[2].numpy()[..., 0] == 0.0)


def test_batched_halo_fill(setup):
    jgrid, tgrid = setup["jgrid"], setup["tgrid"]
    bcs = tuple((loc, regularize_field_boundary_conditions(None, jgrid, loc))
                for loc in LOCS)
    jfill = get_batched_fill(jgrid, bcs, interpret=True)
    assert jfill is not None
    rng = np.random.default_rng(12)
    jarrs, tarrs = [], []
    for a in setup["interiors"][:3]:
        jp = rng.standard_normal(jgrid.padded_shape)     # garbage halos
        jp[JH[0]:JH[0] + N[0], JH[1]:JH[1] + N[1]] = a
        tp = rng.standard_normal(tgrid.padded_shape)
        tp[TH[0]:TH[0] + N[0], TH[1]:TH[1] + N[1]] = a
        jarrs.append(jnp.asarray(jp))
        tarrs.append(torch.as_tensor(tp))
    jout = jfill(*jarrs)
    tout = K.periodic_halo_fill(tgrid, tarrs)
    for j, t in zip(jout, tout):
        assert _padded_close(j, t) == 0.0

