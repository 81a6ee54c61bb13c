"""Krylov solvers (GMRES, BiCGStab, CG) over linear operators on tensors.

Counterpart of ``oceananigans_tpu/solvers/krylov.py`` ``KrylovSolver``,
which calls ``jax.scipy.sparse.linalg``'s ``gmres`` (restarted),
``bicgstab`` and ``cg``: the same three methods written as plain tensor
iterations, with the same stopping rule, ‖r‖ ≤ max(reltol·‖b‖, abstol), and
the preconditioner applied as JAX applies it (GMRES on the left, BiCGStab
and CG inside the iteration). Each test of the rule reads one norm on the
host.
"""

from __future__ import annotations

import math

import torch


def _norm(r):
    return math.sqrt(torch.sum(r * r).item())


def _dot(u, v):
    return torch.sum(u * v)


def cg(A, b, x0, M, tol, maxiter):
    x = x0
    r = b - A(x)
    z = M(r)
    p = z
    rz = _dot(r, z)
    it = 0
    while it < maxiter and _norm(r) > tol:
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x


def bicgstab(A, b, x0, M, tol, maxiter):
    x = x0
    r = b - A(x)
    rhat = r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    it = 0
    while it < maxiter and _norm(r) > tol:
        rho_new = _dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _dot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        omega = _dot(t, s) / _dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        it += 1
    return x


def gmres(A, b, x0, M, tol, maxiter, restart):
    """Restarted GMRES on the left-preconditioned system M A x = M b: each
    cycle builds an Arnoldi basis of up to ``restart`` vectors (modified
    Gram-Schmidt), solves the small least-squares problem and updates x;
    the cycles stop when the unpreconditioned residual meets ``tol`` or
    after ``maxiter`` of them."""
    x = x0
    shape = b.shape
    for _ in range(maxiter):
        r = b - A(x)
        if _norm(r) <= tol:
            break
        z = M(r).reshape(-1)
        beta = torch.linalg.vector_norm(z)
        if beta.item() == 0.0:
            break
        Q = [z / beta]
        Hm = torch.zeros(restart + 1, restart, dtype=b.dtype,
                         device=b.device)
        k = 0
        for k in range(restart):
            w = M(A(Q[k].reshape(shape))).reshape(-1)
            for i in range(k + 1):
                Hm[i, k] = _dot(Q[i], w)
                w = w - Hm[i, k] * Q[i]
            Hm[k + 1, k] = torch.linalg.vector_norm(w)
            if Hm[k + 1, k].item() <= 1e-300:
                k += 1
                break
            Q.append(w / Hm[k + 1, k])
        else:
            k = restart
        e1 = torch.zeros(k + 1, dtype=b.dtype, device=b.device)
        e1[0] = beta
        y = torch.linalg.lstsq(Hm[:k + 1, :k], e1[:, None]).solution[:, 0]
        x = x + (torch.stack(Q[:k], 1) @ y).reshape(shape)
    return x


class KrylovSolver:
    """Matrix-free Krylov solver.

    Parameters
    ----------
    linear_operator : callable(x) -> Ax on tensors
    method : "gmres" | "bicgstab" | "cg"
    preconditioner : callable(r) -> approx A⁻¹r, or None
    reltol, abstol, maxiter, restart : the Krylov knobs (``maxiter`` counts
        GMRES's restart cycles, as in ``jax.scipy.sparse.linalg.gmres``)
    """

    def __init__(self, linear_operator, method="gmres", preconditioner=None,
                 reltol=1e-7, abstol=0.0, maxiter=100, restart=20):
        if method not in ("gmres", "bicgstab", "cg"):
            raise ValueError(f"unknown Krylov method {method!r} "
                             "(gmres, bicgstab, cg)")
        self.A = linear_operator
        self.method = method
        self.M = preconditioner
        self.reltol = float(reltol)
        self.abstol = float(abstol)
        self.maxiter = int(maxiter)
        self.restart = int(restart)

    def solve(self, b, x0=None):
        x0 = torch.zeros_like(b) if x0 is None else x0
        M = self.M if self.M is not None else (lambda r: r)
        tol = max(self.reltol * _norm(b), self.abstol)
        if self.method == "gmres":
            return gmres(self.A, b, x0, M, tol, self.maxiter,
                         min(self.restart, b.numel()))
        if self.method == "bicgstab":
            return bicgstab(self.A, b, x0, M, tol, self.maxiter)
        return cg(self.A, b, x0, M, tol, self.maxiter)
