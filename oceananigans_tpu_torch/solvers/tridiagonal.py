"""Batched tridiagonal (Thomas) solver along z.

Counterpart of ``oceananigans_tpu/solvers/tridiagonal.py``: for every column
(i, j), solve

    b[0] φ[0] + c[0] φ[1]                   = d[0]
    a[k] φ[k-1] + b[k] φ[k] + c[k] φ[k+1]   = d[k],  k = 1 … N-2
    a[N-1] φ[N-2] + b[N-1] φ[N-1]           = d[N-1]

The recurrence is sequential in z and parallel over the (x, y) plane: the
JAX function scans z with plane-shaped carries; here a Python loop over z
runs batched tensor operations on whole planes (two per level forward, one
back).
"""

from __future__ import annotations

import torch


def _column(coef, d):
    """A scalar, a 1D (z) or a d-shaped coefficient as a d-shaped view."""
    c = torch.as_tensor(coef, dtype=d.dtype, device=d.device)
    if c.ndim == 1:
        c = c.reshape((1,) * (d.ndim - 1) + (-1,))
    return c.broadcast_to(d.shape)


def solve_batched_tridiagonal(a, b, c, d):
    """Solve the batched tridiagonal system along the LAST axis of ``d``.

    ``a`` (sub-diagonal; a[0] unused), ``b`` (diagonal) and ``c``
    (super-diagonal; c[N-1] unused) are scalars, 1D tensors along z, or
    tensors of d's shape. Returns φ with d's shape."""
    nz = d.shape[-1]
    a, b, c = (_column(x, d) for x in (a, b, c))
    cp = torch.empty_like(d)
    dp = torch.empty_like(d)
    cp_prev = dp_prev = torch.zeros_like(d[..., 0])
    for k in range(nz):
        ak, bk, ck = a[..., k], b[..., k], c[..., k]
        denom = bk - ak * cp_prev
        cp_prev = cp[..., k] = ck / denom
        dp_prev = dp[..., k] = (d[..., k] - ak * dp_prev) / denom
    phi = torch.empty_like(d)
    nxt = torch.zeros_like(d[..., 0])
    for k in range(nz - 1, -1, -1):
        nxt = phi[..., k] = dp[..., k] - cp[..., k] * nxt
    return phi
