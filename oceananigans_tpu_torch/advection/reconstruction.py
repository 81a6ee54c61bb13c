"""Reconstruction coefficient machinery for Centered / UpwindBiased / WENO.

Counterpart of ``oceananigans_tpu/advection/reconstruction.py``. Every
coefficient is derived with numpy polynomial algebra, in float64 (the
uniform ones when a scheme is built, the nonuniform ones of a stretched axis
from its face positions when a grid first needs them):

* ENO reconstruction coefficients via the primitive-function trick;
* optimal ("linear") WENO weights by matching the union-stencil
  reconstruction;
* Jiang–Shu smoothness indicators as quadratic forms β_s = uᵀ B_s u, factored
  into sums of squared linear stencils;
* on a stretched axis, per-slot ENO coefficients (and optimal weights) from
  the actual face positions (``eno_coefficients_nonuniform``).

Stencil/shift conventions: reconstruction happens at the interface between
cell L0 and R0. With base offset β (0 for center→face output, 1 for
face→center output), left-biased stencil s covers the cells at shifts
β-1-s … β-1-s+k-1; the right-biased stencil is its mirror across the
interface (shift ↦ 2β-1-shift).
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch
from numpy.polynomial import Polynomial

from ..operators.shifts import shift, shift_zbc


def _rationalize(x):
    """Snap a nearly-rational float to its exact rational value."""
    return float(Fraction(x).limit_denominator(10**6))


@functools.lru_cache(maxsize=None)
def _basis_polys(k):
    """Reconstruction basis polynomials p_j(ξ) for a stencil of k cells, where
    cell m occupies [m, m+1] in stencil-local coordinates."""
    polys = []
    xs = np.arange(k + 1, dtype=np.float64)
    for j in range(k):
        coef = np.polynomial.polynomial.polyfit(xs, (xs > j).astype(np.float64),
                                                deg=k)
        polys.append(Polynomial(coef).deriv())
    return polys


@functools.lru_cache(maxsize=None)
def eno_coefficients(k, s):
    """c[j] with p(interface) = Σ_j c[j] ū_j for left-biased stencil s."""
    polys = _basis_polys(k)
    return tuple(_rationalize(p(s + 1.0)) for p in polys)


@functools.lru_cache(maxsize=None)
def optimal_weights(k):
    """Optimal linear weights γ_s reproducing the (2k-1)-order union-stencil
    reconstruction from the k ENO stencils."""
    full = eno_coefficients(2 * k - 1, k - 1)
    A = np.zeros((2 * k - 1, k))
    for s in range(k):
        c = eno_coefficients(k, s)
        for j in range(k):
            A[k - 1 - s + j, s] = c[j]
    gamma, *_ = np.linalg.lstsq(A, np.asarray(full), rcond=None)
    assert np.all(gamma > 0) and abs(gamma.sum() - 1) < 1e-10, gamma
    return tuple(_rationalize(g) for g in gamma)


@functools.lru_cache(maxsize=None)
def smoothness_matrix(k, s):
    """Symmetric matrix B with β_s = Σ_{j,l} B[j,l] u_j u_l (Jiang–Shu)."""
    polys = _basis_polys(k)
    B = np.zeros((k, k))
    for d in range(1, k):
        ders = [p.deriv(d) for p in polys]
        for j in range(k):
            for l in range(k):
                integ = (ders[j] * ders[l]).integ()
                B[j, l] += integ(s + 1.0) - integ(float(s))
    return B


@functools.lru_cache(maxsize=None)
def smoothness_factors(k, s):
    """Factor the PSD smoothness quadratic form B = Σ_m w_m w_mᵀ so that
    β = Σ_m (w_mᵀ u)²."""
    lam, V = np.linalg.eigh(smoothness_matrix(k, s))
    return tuple(tuple(float(x) for x in np.sqrt(lam[m]) * V[:, m])
                 for m in range(k) if lam[m] > 1e-12)


# -- stencil evaluation on padded tensors --------------------------------------

class _ShiftCache:
    """Cache shifted views of one tensor so each distinct offset is built
    once. ``zbc`` activates halo-free boundary-aware reads."""

    def __init__(self, a, axis, zbc=None):
        self.a, self.axis, self.zbc = a, axis, zbc
        self.cache = {}

    def __call__(self, off):
        if off not in self.cache:
            if self.zbc is not None:
                self.cache[off] = shift_zbc(self.a, off, self.axis, self.zbc)
            else:
                self.cache[off] = shift(self.a, off, self.axis)
        return self.cache[off]


def left_shifts(k, s, beta):
    """Padded-array shifts of the cells of left-biased stencil s."""
    return tuple(beta - 1 - s + j for j in range(k))


def mirror(shifts, beta):
    """Right-biased stencil = mirror across the interface."""
    return tuple(2 * beta - 1 - o for o in shifts)


def stencil_value(sc, shifts, coeffs):
    out = None
    for off, c in zip(shifts, coeffs):
        term = c * sc(off)
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def typed_constants(values, dtype):
    """``values`` (a tuple of floats, or of such tuples) as 0-d CPU tensors
    of ``dtype``. The JAX package's constants are weakly typed Python
    floats, which JAX rounds to the dtype of the array they meet before the
    operation; PyTorch computes a bfloat16 operation with a Python float in
    float32 and the float unrounded. A 0-d tensor of the array's dtype gives
    JAX's rounding in PyTorch, and for float32 and float64 the same bits as
    the Python float."""
    if isinstance(values[0], tuple):
        return tuple(typed_constants(v, dtype) for v in values)
    return tuple(torch.tensor(v, dtype=dtype) for v in values)


def smoothness_value(sc, shifts, factors, compute_dtype=None):
    """β = Σ_m (w_mᵀ u)² from shifted reads, optionally in a lower-precision
    ``compute_dtype`` (the reference's WENO FT2 = Float32 inner weights).
    The factors meet the values in the values' dtype, as in JAX."""
    vals = [sc(o) for o in shifts]
    if compute_dtype is not None:
        vals = [v.to(compute_dtype) for v in vals]
    typed = typed_constants(factors, vals[0].dtype)
    beta = None
    for w, tw in zip(factors, typed):
        lin = None
        for c, tc, v in zip(w, tw, vals):
            if abs(c) < 1e-14:
                continue
            term = tc * v
            lin = term if lin is None else lin + term
        sq = lin * lin
        beta = sq if beta is None else beta + sq
    return beta


# -- stretched (nonuniform) axis coefficients ----------------------------------
# the same derivation as the uniform path above, with the actual face
# positions

def _cells_for(faces, beta):
    """(left_edge, right_edge) arrays of the reconstruction 'cells' for data
    at centers (beta=0: cell m = [xF[m], xF[m+1]]) or at faces (beta=1: dual
    cell m = [xC[m-1], xC[m]])."""
    faces = np.asarray(faces, np.float64)
    if beta == 0:
        return faces[:-1], faces[1:]
    xc = 0.5 * (faces[:-1] + faces[1:])
    left = np.concatenate([[xc[0] - (xc[1] - xc[0])], xc[:-1]])
    return left, xc


def eno_coefficients_nonuniform(faces, k, s, beta, npad):
    """Per-output-index ENO coefficients on a nonuniform axis: for output slot
    i, reconstruct from cells at shifts (beta-1-s+j), evaluating the
    derivative of the primitive's Lagrange interpolant at the output position
    (face xF[i] for beta=0, center xC[i] for beta=1). Returns a list of k
    numpy arrays of length ``npad`` (edge-clamped where stencils exit the
    padded range — those slots are halo-only)."""
    faces = np.asarray(faces, np.float64)
    lo, hi = _cells_for(faces, beta)
    n_cells = len(lo)
    xc_eval = 0.5 * (faces[:-1] + faces[1:])
    out = np.zeros((npad, k))
    uni = eno_coefficients(k, s)
    for i in range(npad):
        cells = [min(max(i + beta - 1 - s + j, 0), n_cells - 1)
                 for j in range(k)]
        if len(set(cells)) < k:
            out[i] = uni     # stencil exits the padded range: halo-only slot
            continue
        # strictly increasing edge positions of the union stencil
        edges = [lo[cells[0]]] + [hi[m] for m in cells]
        if np.any(np.diff(edges) <= 0):
            out[i] = uni     # degenerate slots: halo-only
            continue
        x_eval = faces[min(i, len(faces) - 1)] if beta == 0 \
            else xc_eval[min(i, len(xc_eval) - 1)]
        # primitive-function trick: U(edges) with unit jump in cell j;
        # normalized exactly-determined Vandermonde solve (stable for any
        # coordinate magnitude)
        e = np.asarray(edges)
        scale = e[-1] - e[0]
        en = (e - e[0]) / scale
        xn = (x_eval - e[0]) / scale
        V = np.vander(en, k + 1, increasing=True)
        for j in range(k):
            prim = np.zeros(k + 1)
            width = edges[j + 1] - edges[j]
            prim[j + 1:] = 1.0
            coef = np.linalg.solve(V, prim)
            dpoly = Polynomial(coef).deriv()
            out[i, j] = dpoly(xn) / scale * width
    return [out[:, j].copy() for j in range(k)]


def optimal_weights_nonuniform(faces, k, beta, npad):
    """Per-index optimal WENO weights γ_s(i) matching the (2k-1)-cell
    union-stencil reconstruction on the nonuniform axis. Falls back to the
    uniform weights where the least-squares system is degenerate. (The
    schemes keep the uniform weights on a stretched axis, as the JAX package
    and the reference do.)"""
    full = eno_coefficients_nonuniform(faces, 2 * k - 1, k - 1, beta, npad)
    per_s = [eno_coefficients_nonuniform(faces, k, s, beta, npad)
             for s in range(k)]
    uni = optimal_weights(k)
    gammas = np.zeros((npad, k))
    for i in range(npad):
        A = np.zeros((2 * k - 1, k))
        for s in range(k):
            for j in range(k):
                t = k - 1 - s + j
                A[t, s] = per_s[s][j][i]
        b = np.asarray([full[j][i] for j in range(2 * k - 1)])
        g, res, rank, _ = np.linalg.lstsq(A, b, rcond=None)
        if rank < k or np.any(g <= 0) or abs(g.sum() - 1) > 1e-6:
            g = np.asarray(uni)
        gammas[i] = g
    return [gammas[:, s].copy() for s in range(k)]
