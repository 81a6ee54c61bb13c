"""The bounds-preserving WENO of the PyTorch port against the JAX package,
on the CPU.

- the plain ``_div_Uc_bounded`` (``advection/fluxes.py``) against JAX's at
  16 x 16 x 16, a bounded and a periodic z, float64: 1e-12 relative to
  max|JAX|;
- the JAX package's own cases (``tests/test_advection.py``): the 1-D step
  function stays inside its bounds over 100 steps (and the port's model
  equals JAX's there, 1e-12), ``FluxFormAdvection`` carries the bounds,
  and members of different bounds raise;
- the padded tendency (#6's plain version, ``fused_advection_tendency`` on
  CPU tensors) with the limiter against the JAX Pallas #6 in interpret
  mode, a bounded and a periodic z: 1e-12;
- the z-compact layout and the per-axis call refuse the limiter with JAX's
  message, the model leaves the z-compact route, and #1 refuses the
  bounded family.

The CUDA kernel of the bounded #6 is held against the plain version on the
card by chip_smoke.py (phase 31) and tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu import RectilinearGrid as JGrid
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.advection.fluxes import div_Uc as jdiv_Uc
from oceananigans_tpu.advection.schemes import \
    FluxFormAdvection as JFluxForm
from oceananigans_tpu.kernels.fused_advection import build_fused_advection
from oceananigans_tpu.models import NonhydrostaticModel as JNH
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.advection.fluxes import div_Uc
from oceananigans_tpu_torch.advection.fluxes import BOUNDED_REFUSAL
from oceananigans_tpu_torch.kernels.fused_advection import (
    BOUNDED_WENO_FAMILY, bounded_refusal, scheme_code)

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12
TOPOLOGIES = {"bounded_z": ("periodic", "periodic", "bounded"),
              "periodic_z": ("periodic", "periodic", "periodic")}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _step_tracer(rng, shape):
    """A tracer in [0, 1]: a step function with noise inside its bounds."""
    c = (rng.random(shape) > 0.5).astype(float)
    return np.clip(c + 0.2 * rng.standard_normal(shape), 0.0, 1.0)


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_plain_bounded_divergence_against_jax(topo):
    """``div_Uc`` with WENO(5, bounds=(0, 1)) on padded 16³ arrays (random
    velocities, a step-function tracer), every padded cell of the
    interior."""
    N, H = (16, 16, 16), (4, 4, 4)
    kw = dict(size=N, extent=(1.0, 2.0, 1.5), halo=H,
              topology=TOPOLOGIES[topo])
    jgrid = JGrid(**kw, dtype=np.float64)
    tgrid = ot.RectilinearGrid(**kw, dtype=F64, device="cpu")
    rng = np.random.default_rng(3)
    shape = tgrid.padded_shape
    u, v, w = (0.3 * rng.standard_normal(shape) for _ in range(3))
    c = _step_tracer(rng, shape)
    jscheme = JWENO(5, smoothness_dtype=jnp.float64, bounds=(0.0, 1.0))
    tscheme = ot.WENO(5, smoothness_dtype=F64, bounds=(0.0, 1.0))
    want = np.asarray(jdiv_Uc(jgrid, jscheme, *(jnp.asarray(a) for a in
                                                (u, v, w, c))))
    got = div_Uc(tgrid, tscheme, *(torch.as_tensor(a) for a in (u, v, w, c)))
    ii = tgrid.interior_slices
    assert _rel(got.numpy()[ii], want[ii]) <= TOL


def _one_dimensional(pkg, scheme, steps=100):
    grid = pkg.RectilinearGrid(size=(64,), extent=(1.0,),
                               topology=("periodic", "flat", "flat"),
                               **({"device": "cpu", "dtype": F64}
                                  if pkg is ot else {}))
    Model = ot.NonhydrostaticModel if pkg is ot else JNH
    m = Model(grid=grid, advection=scheme, tracers=("c",))
    m.set(u=1.0, c=lambda x, y, z: np.where((x > 0.25) & (x < 0.5), 1.0, 0.0),
          enforce_incompressibility=False)
    for _ in range(steps):
        m.time_step(1e-3)
    return np.asarray(m.field("c").interior)


def test_one_dimensional_step_stays_bounded():
    """The JAX case: the limited WENO keeps a step function in [0, 1] over
    100 steps, conserves it and keeps its peak; the port's model equals
    JAX's."""
    import oceananigans_tpu as J
    c_plain = _one_dimensional(ot, ot.WENO(5))
    c_lim = _one_dimensional(ot, ot.WENO(5, bounds=(0.0, 1.0)))
    eps = 1e-10
    assert c_lim.min() >= -eps and c_lim.max() <= 1 + eps
    assert abs(c_lim.sum() - c_plain.sum()) < 1e-6
    assert c_lim.max() > 0.9
    # float64 smoothness on both sides: JAX's float32 smoothness rounds
    # differently under jit than operation by operation
    got = _one_dimensional(ot, ot.WENO(5, smoothness_dtype=F64,
                                       bounds=(0.0, 1.0)))
    want = _one_dimensional(J, JWENO(5, smoothness_dtype=jnp.float64,
                                     bounds=(0.0, 1.0)))
    assert _rel(got, want) <= TOL


def test_bounds_carry_through_flux_form_wrapping():
    """FluxFormAdvection takes its members' bounds; the wrapped scheme
    stays bounded; members of different bounds raise JAX's error."""
    ff = ot.FluxFormAdvection(ot.WENO(5, bounds=(0.0, 1.0)))
    assert ff.bounds == (0.0, 1.0)
    assert JFluxForm(JWENO(5, bounds=(0.0, 1.0))).bounds == ff.bounds
    c = _one_dimensional(ot, ff)
    assert c.min() >= -1e-10 and c.max() <= 1 + 1e-10
    for FF, W in ((ot.FluxFormAdvection, ot.WENO),
                  (JFluxForm, JWENO)):
        with pytest.raises(ValueError, match="different bounds"):
            FF(W(5, bounds=(0.0, 1.0)), W(5, bounds=(0.0, 2.0)))


def _wrap_xy(a, H):
    return np.pad(a, ((H[0], H[0]), (H[1], H[1])) + ((0, 0),) * (a.ndim - 2),
                  mode="wrap")


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_padded_tendency_against_jax_kernel(topo):
    """#6 on the padded layout with the limiter: u, v, w and two tracers
    (H = (8, 8, 8), as the JAX kernel's alignment asks), the plain version
    against the JAX Pallas kernel in interpret mode."""
    N, halo = (16, 16, 12), (8, 8, 8)
    kw = dict(size=N, extent=(1.0, 2.0, 1.5), halo=halo,
              topology=TOPOLOGIES[topo])
    jgrid = JGrid(**kw, dtype=np.float64)
    tgrid = ot.RectilinearGrid(**kw, dtype=F64, device="cpu")
    rng = np.random.default_rng(17)
    shape = (N[0], N[1], N[2] + 2 * halo[2])
    padded = [_wrap_xy(0.1 * rng.standard_normal(shape), halo)
              for _ in range(3)]
    padded += [_wrap_xy(_step_tracer(rng, shape), halo) for _ in range(2)]
    jscheme = JWENO(5, smoothness_dtype=jnp.float64, bounds=(0.0, 1.0))
    tscheme = ot.WENO(5, smoothness_dtype=F64, bounds=(0.0, 1.0))
    fn = build_fused_advection(jgrid, jscheme, ("a", "b"))
    j = [jnp.asarray(a) for a in padded]
    Gu, Gv, Gw, Gc = fn(j[0], j[1], j[2], {"a": j[3], "b": j[4]})
    got = K.fused_advection_tendency(tgrid, tscheme,
                                     [torch.as_tensor(a) for a in padded])
    for k, want in enumerate((Gu, Gv, Gw, Gc["a"], Gc["b"])):
        want = np.asarray(want)[tgrid.interior_slices]
        assert _rel(got[k].numpy(), want) <= TOL, k


def test_compact_and_per_axis_refuse_the_limiter():
    """JAX refuses the limiter on the z-compact layout and per axis; so
    does the port, with its message. A bounded scheme keeps the model off
    the z-compact route, and the z-compact #6 refuses it
    (``bounded_refusal``); the padded #6 takes every z and the dtype pairs
    it is built for, and names the others."""
    scheme = ot.WENO(5, bounds=(0.0, 1.0))
    grid = ot.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1), halo=(3, 3, 0),
                              dtype=F64, device="cpu")
    a = torch.zeros(grid.padded_shape, dtype=F64)
    msg = "not supported on the z-compact / per-axis kernel path"
    with pytest.raises(NotImplementedError, match=msg):
        div_Uc(grid, scheme, a, a, a, a, zbc=K.fused_advection.ZBC)
    with pytest.raises(NotImplementedError, match=msg):
        div_Uc(grid, scheme, a, a, a, a, only_axis=0)
    jgrid = JGrid(size=(8, 8, 8), extent=(1, 1, 1), halo=(3, 3, 0))
    ja = jnp.zeros(jgrid.padded_shape)
    with pytest.raises(NotImplementedError, match=msg):
        jdiv_Uc(jgrid, JWENO(5, bounds=(0.0, 1.0)), ja, ja, ja, ja,
                zbc={"c": "even"})
    m = ot.NonhydrostaticModel(
        ot.RectilinearGrid(size=(8, 8, 8), extent=(1, 1, 1), dtype=F64,
                           device="cpu"), advection=scheme, tracers=("c",))
    assert not m._z_compact and m.grid.H[2] >= 3
    assert scheme_code(scheme) == (BOUNDED_WENO_FAMILY, 3)
    assert bounded_refusal(grid, scheme, F64) == BOUNDED_REFUSAL
    assert msg in BOUNDED_REFUSAL
    # the padded layout: every z, float32 smoothness with either field
    # dtype and float64 throughout; float32 fields with float64 or
    # bfloat16 smoothness are refused by name
    for topology in (("periodic", "periodic", "bounded"),
                     ("periodic", "periodic", "periodic"),
                     ("periodic", "periodic", "flat")):
        n = 2 if topology[2] == "flat" else 3
        g = ot.RectilinearGrid(size=(8,) * n, extent=(1,) * n,
                               topology=topology, halo=(3,) * n, dtype=F64,
                               device="cpu")
        for fields, smooth, why in (
                (F64, torch.float32, None), (F64, F64, None),
                (torch.float32, torch.float32, None),
                (torch.float32, F64, "float64 smoothness"),
                (torch.float32, torch.bfloat16, "bfloat16 smoothness")):
            got = bounded_refusal(
                g, ot.WENO(5, smoothness_dtype=smooth, bounds=(0, 1)),
                fields)
            assert (got is None) if why is None else why in got, \
                (topology, fields, smooth, got)
