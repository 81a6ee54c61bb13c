"""The vector-unit probes (#12) of the port against the TPU scripts, on the
CPU.

The plain versions of ``kernels/vpu_probes.py`` against the scripts' own
``jnp`` functions (loaded from ``scripts/`` by path, the files untouched), on
a 32×32 float32 slab of ``default_rng(0)`` normals:

- each body (``fma_chain``, ``weno_nodiv``, ``weno_true``, ``weno_recip`` of
  ``vpu_mix_probe.py`` and ``weno5_body`` of ``weno_vpu_microbench.py``) on
  the five scaled copies of the slab;
- the looped versions against a ``jax.lax.fori_loop`` around the same body,
  as the scripts' kernels loop, at R = 3 passes, K = 2 bodies a pass and a
  fold-back factor of 1.0 (the scripts' 1e-20 would hide the bodies); the FMA
  chain on 0.01 times the slab, where its powers of the slab stay finite.

Bound: 1e-6 relative to max|JAX|, float32 roundoff in another fusion of the
same operations (the bodies come out bit for bit here). The entry points of
``oceananigans_tpu_torch/tools`` run on the CPU and print their JSON lines.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu_torch.kernels import vpu_probes as V
from oceananigans_tpu_torch.tools import (repro_bf16_smoothness,
                                          vpu_mix_probe, weno_vpu_microbench)

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
REL = 1e-6
R, K = 3, 2


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _script("weno_vpu_microbench"), _script("vpu_mix_probe")


def _slab(scale=1.0):
    return (scale * np.random.default_rng(0).normal(size=(32, 32))
            ).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))


def _jax_body(scripts, name):
    micro, mix = scripts
    return {"weno5_body": micro.weno5_body, "fma_chain": mix.fma_chain,
            "weno_nodiv": mix.weno_nodiv, "weno_true": mix.weno_true,
            "weno_recip": mix.weno_recip}[name]


PAIRS = [("weno5_body", "weno_true"), ("fma_chain", "fma_chain"),
         ("weno_nodiv", "weno_nodiv"), ("weno_true", "weno_true"),
         ("weno_recip", "weno_recip")]


@pytest.mark.parametrize("jname,name", PAIRS)
def test_body_against_script(scripts, jname, name):
    x = _slab()
    c = [np.float32(x * s) for s in (1.0, 1.0001, 0.9999, 1.0002, 0.9998)]
    want = _jax_body(scripts, jname)(*[jnp.asarray(a) for a in c],
                                     jnp.float32(1e-8))
    got = V.BODIES[name][0](*[torch.as_tensor(a) for a in c])
    assert _rel(got, want) <= REL, (name, _rel(got, want))


def test_approx_recip_plain_is_exact_recip():
    assert V.BODIES["weno_approx_recip"][0] is V.weno_recip


def test_microbench_loop_against_fori_loop(scripts):
    micro = scripts[0]

    def loop(i, x):
        fi = x + 1e-7 * i.astype(jnp.float32)
        acc = x
        for s in range(K):
            f = fi * (1.0 + 1e-4 * s)
            acc = acc + 1.0 * micro.weno5_body(f, f * 1.0001, f * 0.9999,
                                               f * 1.0002, f * 0.9998,
                                               jnp.float32(1e-8))
        return acc

    x = _slab()
    want = jax.jit(lambda x: jax.lax.fori_loop(0, R, loop, x))(jnp.asarray(x))
    got = V.weno_microbench(torch.as_tensor(x), K, reps=R, fold=1.0)
    assert _rel(got, want) <= REL, _rel(got, want)


@pytest.mark.parametrize("name", ["fma_chain", "weno_nodiv", "weno_true",
                                  "weno_recip"])
def test_mix_loop_against_fori_loop(scripts, name):
    body = _jax_body(scripts, name)

    def loop(i, x):
        fi = x * (1.0 + 1e-7 * i.astype(jnp.float32))
        return x + 1.0 * body(fi, fi * 1.0001, fi * 0.9999, fi * 1.0002,
                              fi * 0.9998, jnp.float32(1e-8))

    x = _slab(0.01 if name == "fma_chain" else 1.0)
    want = jax.jit(lambda x: jax.lax.fori_loop(0, R, loop, x))(jnp.asarray(x))
    got = V.vpu_mix(torch.as_tensor(x), name, reps=R, fold=1.0)
    assert _rel(got, want) <= REL, (name, _rel(got, want))


def test_entry_points_on_cpu(capsys):
    """Each entry point runs its plain version with --device cpu and prints
    the script's JSON fields, with no card's peak."""
    weno_vpu_microbench.main(["--device", "cpu", "--slab", "8x8",
                              "--reps", "1"])
    vpu_mix_probe.main(["--device", "cpu", "--slab", "8x8", "--reps", "1"])
    repro_bf16_smoothness.main(["--device", "cpu", "--slab", "16x8"])
    lines = capsys.readouterr().out.splitlines()
    micro = json.loads(lines[0])
    assert micro["k_points"] == [8, 16, 32] and micro["device"] == "cpu"
    assert micro["fma_peak_tflops"] is None and micro["reps"] == 1
    mix = [json.loads(s) for s in lines[1:6]]
    assert [m["variant"] for m in mix] == list(V.BODIES)
    assert lines[6].startswith("OK dtype=bfloat16: checksum")
    assert lines[7].startswith("OK dtype=float32: checksum")
    repro = json.loads(lines[8])
    assert repro["slab"] == [16, 8] and repro["max_abs_bf16_vs_float32"] > 0


def test_sass_counts_parser(monkeypatch):
    """``tools/sass_counts`` counts each probe kernel's opcodes in
    ``cuobjdump -sass`` output (a sample here; the tool runs on the card's
    build)."""
    import subprocess
    from oceananigans_tpu_torch.tools import sass_counts
    sample = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN46_GLOBAL__N__0_13_vpu_probes_cu_10mix_kernelILi2EEEvPKfPfiif",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */",
        "        /*0010*/                   FFMA R5, R2, R3, R4 ;   /* 0x0000000302057223 */",
        "        /*0020*/              @!P0 MUFU.RCP R6, R5 ;       /* 0x0000000500068308 */",
        "        /*0030*/                   FFMA R7, R6, R5, -1 ;   /* 0x0000000506077423 */",
        "\t\tFunction : _ZN51_GLOBAL__N__0_18_fused_advection_cu_kernel",
        "        /*0000*/                   FADD R1, R2, R3 ;        /* 0x0000000302017221 */",
    ])

    def fake_run(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 0, stdout=sample, stderr="")

    monkeypatch.setattr(sass_counts.subprocess, "run", fake_run)
    monkeypatch.setattr(sass_counts, "cuobjdump", lambda: "cuobjdump")
    got = sass_counts.counts("lib.so")
    assert list(got) == [
        "_ZN46_GLOBAL__N__0_13_vpu_probes_cu_10mix_kernelILi2EEEvPKfPfiif"]
    assert dict(next(iter(got.values()))) == {"LDC": 1, "FFMA": 2, "MUFU": 1}
