"""Batched tridiagonal (Thomas) solver along any axis.

Counterpart of ``oceananigans_tpu/solvers/tridiagonal.py``: for every line
along the solve axis, solve

    b[0] φ[0] + c[0] φ[1]                   = d[0]
    a[k] φ[k-1] + b[k] φ[k] + c[k] φ[k+1]   = d[k],  k = 1 … N-2
    a[N-1] φ[N-2] + b[N-1] φ[N-1]           = d[N-1]

The recurrence is sequential along the axis and parallel over the others:
the JAX function scans the last axis with plane-shaped carries; here a
Python loop over the levels runs batched tensor operations on whole planes
(two per level forward, one back). Another axis is moved last first, and a
complex right-hand side with real coefficients is solved as its real and
imaginary parts, as the JAX Fourier-tridiagonal solver does, stacked into
one batch.
"""

from __future__ import annotations

import torch


def _column(coef, d):
    """A scalar, a 1D (along the solve axis) or a d-shaped coefficient as a
    d-shaped view."""
    c = torch.as_tensor(coef, dtype=d.dtype, device=d.device)
    if c.ndim == 1:
        c = c.reshape((1,) * (d.ndim - 1) + (-1,))
    return c.broadcast_to(d.shape)


def solve_batched_tridiagonal(a, b, c, d, axis=-1):
    """Solve the batched tridiagonal system along ``axis`` of ``d`` (the
    last by default).

    ``a`` (sub-diagonal; a[0] unused), ``b`` (diagonal) and ``c``
    (super-diagonal; c[N-1] unused) are scalars, 1D tensors along the axis,
    or tensors of d's shape. Returns φ with d's shape."""
    axis = axis % d.ndim
    if axis != d.ndim - 1:
        def last(x):
            return x.movedim(axis, -1) if isinstance(
                x, torch.Tensor) and x.ndim == d.ndim else x
        return solve_batched_tridiagonal(
            last(a), last(b), last(c), d.movedim(axis, -1)).movedim(-1, axis)
    if d.is_complex():
        # the real and imaginary parts as one batch of real lines: one sweep
        # of plane operations for both, each part's arithmetic as alone
        out = solve_batched_tridiagonal(a, b, c, torch.stack([d.real,
                                                              d.imag]))
        return torch.complex(out[0], out[1])
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
