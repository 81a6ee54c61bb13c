"""Preconditioned conjugate-gradient solver.

Counterpart of ``oceananigans_tpu/solvers/conjugate_gradient.py``'s
``conjugate_gradient``: the same iteration on tensors. The JAX loop is a
``lax.while_loop`` on the residual norm; here a Python loop reads the norm on
the host each iteration (one device-to-host copy of a scalar an iteration).
"""

from __future__ import annotations

import math

import torch


def conjugate_gradient(A, b, x0=None, preconditioner=None, reltol=1e-7,
                       abstol=0.0, maxiter=500):
    """Solve A(x) = b. ``A`` and ``preconditioner`` are callables from a
    tensor to a tensor of its shape. Returns (x, iterations, the residual
    norm as a float)."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = preconditioner if preconditioner is not None else (lambda r: r)

    def dot(u, v):
        return torch.sum(u * v)

    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    tol = max(reltol * math.sqrt(dot(b, b).item()), abstol)
    it = 0
    while it < maxiter and math.sqrt(dot(r, r).item()) > tol:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it, math.sqrt(dot(r, r).item())
