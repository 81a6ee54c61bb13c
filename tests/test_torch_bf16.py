"""bfloat16 WENO smoothness: the port's plain path against the JAX package,
on the CPU.

JAX rounds a weakly typed Python constant to the dtype of the array it
meets, so in bfloat16 smoothness arithmetic every factor, τ coefficient, ε,
saturation and optimal weight is a bfloat16 value; the port gives each the
same rounding (``advection.reconstruction.typed_constants``). XLA on the CPU
keeps float32 intermediates inside a fusion unless
``--xla_allow_excess_precision=false``, and ``tests/conftest.py`` sets
``XLA_FLAGS`` once for the process, so the JAX references come from one
subprocess that runs with that flag and hands back an ``.npz``:

- ``scripts/repro_bf16_smoothness.py``'s ``kernel`` in interpret mode on its
  256×256 slab of ``default_rng(0)`` normals, in bfloat16 and in the
  script's float32 control, against ``kernels.vpu_probes``'
  ``bf16_smoothness_plain``: 1e-6 relative to max|JAX| (the same
  roundings; with unrounded constants the difference is of the size of the
  whole bfloat16 effect);
- one RK3 step (Δt = 1e-3) of the z-compact (16, 16, 128) float32 model with
  WENO(5, smoothness_dtype=bfloat16) and two tracers, the JAX fused update in
  interpret mode against the port's plain fused route: 2e-6 absolute on u,
  v, w and the tracers (float32 roundoff of one step; unrounded constants
  fail it on the tracers by more than an order of magnitude).

Also: the kernels' bfloat16 coefficient table holds exactly the roundings
the plain version and JAX make, and the constants the repro kernel rounds on
the card from float32 round as from float64.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.advection.schemes import WENO_EPSILON, WENO_R_MAX
from oceananigans_tpu_torch.kernels import vpu_probes as V
from oceananigans_tpu_torch.kernels.fused_advection import (
    coefficient_table, smoothness_code, table_layout)
from oceananigans_tpu_torch.models import NonhydrostaticModel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = (16, 16, 128)
DT = 1e-3
TRACERS = ("c0", "c1")
REPRO_REL = 1e-6
MODEL_ABS = 2e-6

# The JAX references, run in a process of their own; argv[1] is the .npz.
REFERENCE = r"""
import importlib.util, os, sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from jax.experimental import pallas as pl
from oceananigans_tpu.defaults import defaults
defaults.FloatType = np.float64
from oceananigans_tpu.advection import WENO
from oceananigans_tpu.grids import RectilinearGrid
from oceananigans_tpu.models import NonhydrostaticModel

out = {}
spec = importlib.util.spec_from_file_location(
    "repro_bf16_smoothness", os.path.join("scripts", "repro_bf16_smoothness.py"))
repro = importlib.util.module_from_spec(spec)
spec.loader.exec_module(repro)
x = jnp.asarray(np.random.default_rng(0).normal(size=(256, 256)), jnp.float32)
for name in ("bfloat16", "float32"):
    repro.CDT = getattr(jnp, name)
    out["repro_" + name] = np.asarray(pl.pallas_call(
        repro.kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(x))

N = (16, 16, 128)
m = NonhydrostaticModel(
    grid=RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), dtype=np.float32),
    advection=WENO(5, smoothness_dtype=jnp.bfloat16), tracers=("c0", "c1"))
assert m._z_compact and m._fused_update is not None
rng = np.random.default_rng(0)
m.set(u=0.1 * rng.standard_normal(N).astype(np.float32),
      v=0.1 * rng.standard_normal(N).astype(np.float32),
      c0=rng.random(N, dtype=np.float32), c1=rng.random(N, dtype=np.float32))
m.time_step(1e-3)
for name, a in m.state["fields"].items():
    out["model_" + name] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    path = tmp_path_factory.mktemp("bf16") / "refs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    subprocess.run([sys.executable, "-c", REFERENCE, str(path)], cwd=REPO,
                   env=env, check=True, timeout=600)
    with np.load(path) as refs:
        return dict(refs)


def _slab():
    return torch.as_tensor(np.random.default_rng(0).normal(size=(256, 256))
                           .astype(np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_repro_against_jax(jax_refs, dtype):
    """The repro's plain version in bfloat16 and in the float32 control."""
    want = jax_refs["repro_" + dtype]
    got = V.bf16_smoothness_plain(_slab(), getattr(torch, dtype)).numpy()
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= REPRO_REL, (dtype, err)


def test_compact_model_bf16_smoothness_against_jax(jax_refs):
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0),
                              dtype=torch.float32, device="cpu")
    model = NonhydrostaticModel(
        grid, advection=ot.WENO(5, smoothness_dtype=torch.bfloat16),
        tracers=TRACERS)
    assert model.grid.H[2] == 0 and model._fused_update
    rng = np.random.default_rng(0)
    model.set(u=0.1 * rng.standard_normal(N).astype(np.float32),
              v=0.1 * rng.standard_normal(N).astype(np.float32),
              c0=rng.random(N, dtype=np.float32),
              c1=rng.random(N, dtype=np.float32))
    model.time_step(DT)
    for name in ("u", "v", "w") + TRACERS:
        a = jax_refs["model_" + name]
        h = [(a.shape[ax] - N[ax]) // 2 for ax in range(3)]
        want = a[h[0]:h[0] + N[0], h[1]:h[1] + N[1], h[2]:h[2] + N[2]]
        err = np.max(np.abs(model.field(name).interior.numpy() - want))
        assert err <= MODEL_ABS, (name, err)


def test_bf16_coefficient_table():
    """The kernels' bfloat16 table: the entries that meet the smoothness
    arithmetic are torch's and JAX's bfloat16 roundings (so the card's
    conversion of them is exact), the stencil coefficients are not rounded,
    and the float32 table is untouched."""
    for order in (5, 9):
        scheme = ot.WENO(order, smoothness_dtype=torch.bfloat16)
        table = list(coefficient_table(scheme))
        plain = list(coefficient_table(ot.WENO(order)))
        lay = table_layout(scheme.buffer)
        # the factors, optimal weights, τ coefficients, ε and the saturation
        smooth = range(lay["lin"], lay["size"])
        for n, (t, p) in enumerate(zip(table, plain)):
            if n in smooth:
                rounded = torch.tensor(p, dtype=torch.bfloat16)
                assert t == rounded.item(), (n, t, p)
                assert t == float(jnp.asarray(p, jnp.bfloat16)), (n, t, p)
            else:
                assert t == p, n
        eps = lay["eps"]
        assert table[eps] != WENO_EPSILON and table[eps + 1] != WENO_R_MAX


def test_probe_constants_round_as_from_float64():
    """The repro kernel rounds 13/12 and ε to bfloat16 from their float32
    values on the card; that gives the roundings from float64 (no tie)."""
    for c in (13.0 / 12.0, 1e-8, 0.25, 2.0, 3.0, 4.0):
        via_f32 = torch.tensor(np.float32(c)).to(torch.bfloat16)
        assert via_f32 == torch.tensor(c, dtype=torch.bfloat16), c


def test_bf16_smoothness_with_float64_fields_raises():
    """The card takes bfloat16 smoothness with float32 fields only; the
    plain version takes any pair."""
    scheme = ot.WENO(5, smoothness_dtype=torch.bfloat16)
    assert smoothness_code(scheme, torch.float32) == 2
    with pytest.raises(TypeError, match="float32 fields"):
        smoothness_code(scheme, torch.float64)
    assert smoothness_code(ot.Centered(2), torch.float64) == 1
