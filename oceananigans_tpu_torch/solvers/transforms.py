"""Discrete cosine transforms for the eigenfunction Poisson solvers.

Counterpart of ``oceananigans_tpu/solvers/transforms.py`` (matmul DCT):
FFTW REDFT10 (DCT-II) along Bounded dimensions and its exact inverse, as
float64 numpy matrices. The solvers apply them along any axis with a
full-precision ``torch.matmul`` (``apply_matrix_along``, JAX's
``_apply_matrix_along``; TF32 stays off on the card, ``disable_tf32``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def dct2_matrix(N):
    """Unnormalized DCT-II matrix (FFTW REDFT10 convention):
    X[k] = 2 Σ_n x[n] cos(π k (2n+1) / (2N))."""
    k = np.arange(N)[:, None]
    n = np.arange(N)[None, :]
    return 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2 * N))


@functools.lru_cache(maxsize=None)
def idct2_matrix(N):
    """Exact inverse of :func:`dct2_matrix` (≡ scaled DCT-III)."""
    return np.linalg.inv(dct2_matrix(N))


def apply_along_last(a, M):
    """out[..., k] = Σ_n M[k, n] a[..., n]: a matrix along the contiguous
    (last) axis. ``M`` is a tensor in ``a``'s dtype and on its device."""
    return torch.matmul(a, M.transpose(0, 1))


def apply_matrix_along(a, M, axis):
    """out = M @ a along ``axis`` of a real or complex tensor (a complex one
    takes the real matrix on its real and imaginary parts): the last axis by
    one matmul, the first as M times ``a`` seen as (N, rest), any other
    through a move to the last axis and back."""
    if a.is_complex():
        return torch.complex(apply_matrix_along(a.real, M, axis),
                             apply_matrix_along(a.imag, M, axis))
    axis = axis % a.ndim
    if axis == a.ndim - 1:
        return apply_along_last(a, M)
    if axis == 0:
        out = torch.matmul(M, a.reshape(a.shape[0], -1))
        return out.reshape((M.shape[0],) + tuple(a.shape[1:]))
    return apply_along_last(a.movedim(axis, -1), M).movedim(-1, axis)
