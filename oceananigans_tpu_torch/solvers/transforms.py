"""Discrete cosine transforms for the eigenfunction Poisson solver.

Counterpart of ``oceananigans_tpu/solvers/transforms.py`` (matmul DCT):
FFTW REDFT10 (DCT-II) along Bounded dimensions and its exact inverse, as
float64 numpy matrices. The solver applies them along z with a full-precision
``torch.matmul``.
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
