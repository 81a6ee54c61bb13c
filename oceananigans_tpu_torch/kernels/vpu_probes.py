"""The TPU's vector-unit probes (kernel #12) as CUDA kernels on the H100,
with their plain PyTorch versions.

Each replaces one TPU script's Pallas kernel, body for body and loop for
loop (``csrc/vpu_probes.cu``):

- ``weno_microbench`` replaces ``scripts/weno_vpu_microbench.py``
  ``time_for_k``: ``reps`` passes over a float32 slab, each pass ``k``
  independent WENO-5 bodies (87 operations each, plus 3 to derive their
  inputs) folded back into the slab. The time's slope over k gives the
  marginal rate of the WENO body.
- ``vpu_mix`` replaces ``scripts/vpu_mix_probe.py`` ``measure``: the same
  protocol with one body a pass, for the bodies of ``BODIES``.
  ``weno_approx_recip`` is the JAX TPU kernels' approximate weight
  reciprocal (``oceananigans_tpu/advection/schemes.py`` ``WENO._biased``,
  ``fast_reciprocal``) as ``rcp.approx.ftz.f32``: a measurement only, which
  no model path takes. Its plain version divides exactly.
- ``bf16_smoothness`` replaces ``scripts/repro_bf16_smoothness.py``
  ``kernel``: one WENO-5 reconstruction per element of a (rows, cols) slab
  from the row shifts −2..2 (zero beyond the first and last rows), with β
  and τ/(β+ε) in bfloat16 (or float32) and the rest in float32.

The fold-back factor ``fold`` is an argument: the scripts' 1e-20 leaves the
slab equal to its input to float32 resolution, so the checks against the
plain versions pass 1.0. Constants are rounded as JAX rounds its weakly
typed Python floats, to the dtype of the array they meet.

Bound on the H100: operations (the slab is read and written once). Wrappers
take their plain version for a CPU tensor and launch the kernel for a CUDA
tensor, counting launches in ``launches``; the plain versions count their
calls on CUDA tensors in ``cuda_calls``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..advection.reconstruction import typed_constants
from . import build
from .fused_advection import _SMOOTHNESS_CODES

# The scripts' protocol (weno_vpu_microbench.py and vpu_mix_probe.py).
MICROBENCH_REPS = 200
MICROBENCH_K = (8, 16, 32)
MIX_REPS = 2000
SLAB = (256, 256)
WENO_FLOP = 87           # roofline.py frecon(3): one WENO-5 reconstruction
DERIVE_FLOP = 3          # per microbench body: the stream-decorrelation ops
MIX_LOOP_FLOP = 7        # per mix pass: the loop's derive and fold-back
FOLD = 1e-20             # the scripts' fold-back factor

EPS = 1e-8


def _sq(x):
    return x * x


def _smoothness(c0, c1, c2, c3, c4):
    """β0, β1, β2 and τ = |β0 − β2| of the scripts' WENO-5 body, with the
    constants in the values' dtype."""
    k, q, two, three, four = typed_constants((13.0 / 12.0, 0.25, 2.0, 3.0, 4.0),
                                             c0.dtype)
    b0 = k * _sq(c0 - two * c1 + c2) + q * _sq(c0 - four * c1 + three * c2)
    b1 = k * _sq(c1 - two * c2 + c3) + q * _sq(c1 - c3)
    b2 = k * _sq(c2 - two * c3 + c4) + q * _sq(three * c2 - four * c3 + c4)
    return b0, b1, b2, (b0 - b2).abs()


def _combine(a0, a1, a2, inv, c0, c1, c2, c3, c4):
    p0 = (2.0 * c0 - 7.0 * c1 + 11.0 * c2) * (1.0 / 6.0)
    p1 = (-c1 + 5.0 * c2 + 2.0 * c3) * (1.0 / 6.0)
    p2 = (2.0 * c2 + 5.0 * c3 - c4) * (1.0 / 6.0)
    return (a0 * p0 + a1 * p1 + a2 * p2) * inv


def fma_chain(c0, c1, c2, c3, c4):
    """16 dependent multiply-adds (32 operations)."""
    r = c0
    for _ in range(4):
        r = r * c1 + c2
        r = r * c3 + c4
        r = r * c1 + c0
        r = r * c2 + c3
    return r


def _weno(c, weights, inv):
    b0, b1, b2, tau = _smoothness(*c)
    a = [g * (1.0 + weights(tau, b + EPS)) for g, b in
         ((0.1, b0), (0.6, b1), (0.3, b2))]
    return _combine(*a, inv(a[0] + a[1] + a[2]), *c)


def weno_nodiv(c0, c1, c2, c3, c4):
    """The WENO-5 body with every division replaced by a product."""
    return _weno((c0, c1, c2, c3, c4), lambda t, d: t * d,
                 lambda s: 1e-6 * s)


def weno_true(c0, c1, c2, c3, c4):
    """The WENO-5 body (``weno5_body`` of the microbench): four exact
    divisions."""
    return _weno((c0, c1, c2, c3, c4), lambda t, d: t / d, lambda s: 1.0 / s)


def weno_recip(c0, c1, c2, c3, c4):
    """The WENO-5 body with x/y as x·(1/y), the reciprocal exact."""
    return _weno((c0, c1, c2, c3, c4), lambda t, d: t * torch.reciprocal(d),
                 torch.reciprocal)


# The plain version of the approximate reciprocal is the exact one.
weno_approx_recip = weno_recip

# name: (plain body, operations a pass, kernel code)
BODIES = {
    "fma_chain": (fma_chain, 32, 0),
    "weno_nodiv": (weno_nodiv, WENO_FLOP, 1),
    "weno_true": (weno_true, WENO_FLOP, 2),
    "weno_recip": (weno_recip, WENO_FLOP, 3),
    "weno_approx_recip": (weno_approx_recip, WENO_FLOP, 4),
}


def _mul_f32(a, b):
    """a·b in float32, as a Python float: JAX's ``1e-7 * i.astype(f32)``."""
    return float(np.float32(a) * np.float32(b))


def _check(x):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("the probes take a contiguous float32 slab")


# -- 12a: the marginal WENO-body rate --------------------------------------------

def weno_microbench_plain(x, k, reps=MICROBENCH_REPS, fold=FOLD):
    """Plain PyTorch version of ``time_for_k``'s loop."""
    if x.is_cuda:
        weno_microbench_plain.cuda_calls += 1
    for i in range(reps):
        fi = x + _mul_f32(1e-7, i)
        acc = x
        for s in range(k):
            f = fi * (1.0 + 1e-4 * s)
            acc = acc + fold * weno_true(f, f * 1.0001, f * 0.9999,
                                         f * 1.0002, f * 0.9998)
        x = acc
    return x


weno_microbench_plain.cuda_calls = 0


def weno_microbench(x, k, reps=MICROBENCH_REPS, fold=FOLD):
    """``reps`` passes of ``k`` WENO-5 bodies (k in ``MICROBENCH_K`` on the
    card) over the float32 slab ``x``; returns the slab after the passes."""
    _check(x)
    if x.device.type == "cpu":
        return weno_microbench_plain(x, k, reps, fold)
    if k not in MICROBENCH_K:
        raise ValueError(f"the kernel is built for k in {MICROBENCH_K}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        lib = build.library()
        build.check(lib.oc_weno_microbench(k, build.ptr(x), build.ptr(out),
                                           x.numel(), reps, float(fold),
                                           build.stream_of(x)), lib)
    weno_microbench.launches += 1
    return out


weno_microbench.launches = 0


# -- 12b: the operation mix ----------------------------------------------------------

def vpu_mix_plain(x, body, reps=MIX_REPS, fold=FOLD):
    """Plain PyTorch version of ``measure``'s loop for the body named
    ``body``."""
    if x.is_cuda:
        vpu_mix_plain.cuda_calls += 1
    fn = BODIES[body][0]
    for i in range(reps):
        fi = x * float(np.float32(1.0) + np.float32(_mul_f32(1e-7, i)))
        x = x + fold * fn(fi, fi * 1.0001, fi * 0.9999, fi * 1.0002,
                          fi * 0.9998)
    return x


vpu_mix_plain.cuda_calls = 0


def vpu_mix(x, body, reps=MIX_REPS, fold=FOLD):
    """``reps`` passes of one ``body`` (a name of ``BODIES``) over the
    float32 slab ``x``; returns the slab after the passes."""
    _check(x)
    code = BODIES[body][2]
    if x.device.type == "cpu":
        return vpu_mix_plain(x, body, reps, fold)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        lib = build.library()
        build.check(lib.oc_vpu_mix(code, build.ptr(x), build.ptr(out),
                                   x.numel(), reps, float(fold),
                                   build.stream_of(x)), lib)
    vpu_mix.launches += 1
    return out


vpu_mix.launches = 0


# -- 12c: bf16 smoothness ------------------------------------------------------------

def _row_shift(x, s):
    """x[r + s] at row r, zero where r + s leaves the slab."""
    zeros = torch.zeros((abs(s),) + x.shape[1:], dtype=x.dtype,
                        device=x.device)
    if s > 0:
        return torch.cat([x[s:], zeros])
    return torch.cat([zeros, x[:s]])


def bf16_smoothness_plain(x, dtype=torch.bfloat16):
    """Plain PyTorch version of the repro's kernel."""
    if x.is_cuda:
        bf16_smoothness_plain.cuda_calls += 1
    c = (_row_shift(x, -2), _row_shift(x, -1), x, _row_shift(x, 1),
         _row_shift(x, 2))
    b0, b1, b2, tau = _smoothness(*(v.to(dtype) for v in c))
    eps, = typed_constants((EPS,), dtype)
    a = [g * (1.0 + (tau / (b + eps)).to(torch.float32))
         for g, b in ((0.1, b0), (0.6, b1), (0.3, b2))]
    return _combine(*a, 1.0 / (a[0] + a[1] + a[2]), *c)


bf16_smoothness_plain.cuda_calls = 0


def bf16_smoothness(x, dtype=torch.bfloat16):
    """The repro's WENO-5 reconstruction over the float32 (rows, cols) slab
    ``x``, with the smoothness in ``dtype`` (bfloat16 or float32)."""
    _check(x)
    if x.dim() != 2:
        raise ValueError("the repro takes a (rows, cols) slab")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported smoothness dtype {dtype}")
    if x.device.type == "cpu":
        return bf16_smoothness_plain(x, dtype)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        lib = build.library()
        build.check(lib.oc_bf16_smoothness(_SMOOTHNESS_CODES[dtype],
                                           build.ptr(x), build.ptr(out),
                                           x.shape[0], x.shape[1],
                                           build.stream_of(x)), lib)
    bf16_smoothness.launches += 1
    return out


bf16_smoothness.launches = 0
