"""#1's plain version against the JAX Pallas kernel in interpret mode, for
the schemes of tests/test_torch_schemes.py (WENO(9), WENO(11),
UpwindBiased(5), Centered(4), Centered(12)), on the CPU: the z-compact
update with G⁻ and the deferred correction over u, v, w and a tracer,
float64 with float64 smoothness, bound 1e-12 relative to max|JAX|. A file of
its own so that each file stays near a minute and a half on one worker
(the JAX side compiles an interpreted kernel per scheme)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.kernels.fused_advection import \
    build_fused_advection_update
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K
from test_torch_schemes import F64, H8, JAX_SCHEMES, TOL_JAX, _rel, _wrap_xy

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(JAX_SCHEMES))
def test_update_against_jax(name):
    """#1 (z-compact) with G⁻ and the deferred correction, u, v, w and one
    tracer at (8, 8, 128) (the JAX z-compact layout takes Nz % 128 == 0):
    G and the new fields, halos included."""
    tscheme, jscheme = (f() for f in JAX_SCHEMES[name])
    N, halo = (8, 8, 128), H8 + (0,)
    jgrid = JGrid(size=N, extent=(1.0, 2.0, 1.5), halo=halo, dtype=np.float64)
    tgrid = ot.RectilinearGrid(size=N, extent=(1.0, 2.0, 1.5), halo=halo,
                               dtype=F64, device="cpu")
    rng = np.random.default_rng(50)
    ints = [0.1 * rng.standard_normal(N) for _ in range(3)]
    ints[2][..., 0] = 0.0
    ints.append(1e-2 * rng.standard_normal(N))                   # p
    ints.append(rng.random(N))                                    # c
    padded = [_wrap_xy(a, H8) for a in ints]
    gm = [rng.standard_normal(N) for _ in range(4)]
    gdt, zdt, cdt = 0.1, -0.05, 0.07
    fn = build_fused_advection_update(jgrid, jscheme, ("c",), with_corr=True)
    j = [jnp.asarray(a) for a in padded]
    jG, jnew = fn(j[0], j[1], j[2], {"c": j[4]}, [jnp.asarray(g) for g in gm],
                  gdt, zdt, p=j[3], corr_dt=cdt)
    t = [torch.as_tensor(a) for a in padded]
    tG, tnew = K.fused_advection_update(
        tgrid, tscheme, t[0], t[1], t[2], [torch.as_tensor(g) for g in gm],
        gdt, zdt, p=t[3], corr_dt=cdt, tracers={"c": t[4]})
    for k, fname in enumerate(("u", "v", "w", "c")):
        assert _rel(tG[k].numpy(), jG[k]) <= TOL_JAX, (name, "G", fname)
        assert _rel(tnew[fname].numpy(), jnew[fname]) <= TOL_JAX, \
            (name, "new", fname)
