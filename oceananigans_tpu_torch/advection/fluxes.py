"""Advective flux divergences for tracers and momentum (flux form).

Counterpart of ``oceananigans_tpu/advection/fluxes.py`` (no slab
trimming): the advecting velocity is the scheme's
symmetric interpolation of A·q (the face velocity itself for tracers), the
advected quantity the upwind reconstruction selected by the advecting
velocity's sign.

``zbc``: halo-free z-boundary mode (the z-compact layout). The dict gives each
velocity's z-mirror parity (even for u/v, odd-face for w); the flux deltas
need no fix-ups because boundary-face fluxes vanish and the out-of-range
shift zero-fill reproduces exactly that. With ``zbc=None`` (the padded
layout) every stencil reads the z halos as they were filled.
"""

from __future__ import annotations

import torch

from ..operators.operators import (LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC,
                                   _delta_c, _delta_f)
from ..operators.shifts import shift

X, Y, Z = 0, 1, 2

# JAX's refusal of the bounds-preserving limiter off the padded layout or
# per axis (the kernels' wrappers refuse it with the same words)
BOUNDED_REFUSAL = ("bounds-preserving advection is not supported on the "
                   "z-compact / per-axis kernel path")


def _biased_by(scheme, grid, a, axis, beta, q, zbc=None):
    return scheme.biased_by(grid, a, axis, beta, q, zbc=zbc)


def _transports(grid, u, v, w):
    return (grid.Ax(LOC_FCC) * u, grid.Ay(LOC_CFC) * v, grid.Az(LOC_CCF) * w)


def _sum_terms(terms, like, V):
    if not terms:
        return torch.zeros_like(like)
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total / V


def div_Uc(grid, scheme, u, v, w, c, zbc=None, only_axis=None):
    """Tracer advective flux divergence ∇·(𝐯 c) at ccc (``only_axis``: the
    one flux axis's term). A scheme with ``bounds`` takes the
    bounds-preserving limiter (``_div_Uc_bounded``), on the padded layout
    and over all axes at once only, as in the JAX package."""
    if scheme is None:
        return torch.zeros_like(c)
    if getattr(scheme, "bounds", None) is not None:
        if zbc is not None or only_axis is not None:
            # the limiter couples each axis's two reconstructions through
            # θ; the z-compact layout lacks the parity shifts it needs
            raise NotImplementedError(BOUNDED_REFUSAL)
        return _div_Uc_bounded(grid, scheme, u, v, w, c)
    total = None
    for axis, vel, A in ((X, u, grid.Ax(LOC_FCC)), (Y, v, grid.Ay(LOC_CFC)),
                         (Z, w, grid.Az(LOC_CCF))):
        if grid.is_flat(axis) or only_axis not in (None, axis):
            continue
        kind = zbc["c"] if (zbc is not None and axis == Z) else None
        chat = scheme.biased_by(grid, c, axis, 0, vel, zbc=kind)
        term = _delta_c(grid, A * vel * chat, axis)
        total = term if total is None else total + term
    if total is None:
        return torch.zeros_like(c)
    return total / grid.V(LOC_CCC)


# The limiter's constants: ω̂ = 5/18 (the reconstruction weight of the end
# points) and ε₂, which keeps the ratios finite.
OMEGA_HAT = 5.0 / 18.0
EPS2 = 1e-20


def _div_Uc_bounded(grid, scheme, u, v, w, c):
    """The bounds-preserving WENO tracer flux divergence: per axis and
    cell, a factor θ ≤ 1 pulls the cell's two outward reconstructions
    toward its mean, so that the updated tracer stays inside
    ``scheme.bounds``. Face i takes θ of cell i - 1 for its left-biased
    value and θ of cell i for its right-biased one, the upwind one by the
    face velocity's sign."""
    lo, hi = scheme.bounds
    total = None
    for axis, vel, A in ((X, u, grid.Ax(LOC_FCC)), (Y, v, grid.Ay(LOC_CFC)),
                         (Z, w, grid.Az(LOC_CCF))):
        if grid.is_flat(axis):
            continue
        # both biased reconstructions at every face (face i is the left
        # face of cell i)
        cl, cr = scheme.biased_pair(grid, c, axis, 0)
        # cell i's outward reconstructions: right-biased at its left face,
        # left-biased at its right face (face i + 1)
        c_minus_R = cr
        c_plus_L = shift(cl, +1, axis)
        p_tilde = (c - OMEGA_HAT * c_minus_R - OMEGA_HAT * c_plus_L) \
            / (1 - 2 * OMEGA_HAT)
        M = torch.maximum(torch.maximum(p_tilde, c_plus_L), c_minus_R)
        m = torch.minimum(torch.minimum(p_tilde, c_plus_L), c_minus_R)
        theta = torch.minimum(
            torch.minimum(torch.abs((hi - c) / (M - c + EPS2)),
                          torch.abs((lo - c) / (m - c + EPS2))),
            torch.ones_like(c))
        # the limited face values: the left-biased one belongs to cell
        # i - 1, the right-biased one to cell i
        c_prev = shift(c, -1, axis)
        c_left_lim = shift(theta, -1, axis) * (cl - c_prev) + c_prev
        c_right_lim = theta * (cr - c) + c
        flux = A * vel * torch.where(vel > 0, c_left_lim, c_right_lim)
        term = _delta_c(grid, flux, axis)
        total = term if total is None else total + term
    if total is None:
        return torch.zeros_like(c)
    return total / grid.V(LOC_CCC)


def div_Uu(grid, scheme, u, v, w, zbc=None, only_axis=None,
           advected=None):
    """∇·(𝐯 u) at fcc. ``advected``: reconstruct this field instead of u
    (the background fields' cross terms); (u, v, w) still build the
    advecting transports."""
    if scheme is None:
        return torch.zeros_like(u)
    au = u if advected is None else advected
    Ax_u, Ay_v, Az_w = _transports(grid, u, v, w)
    terms = []
    if not grid.is_flat(X) and only_axis in (None, X):
        ut = scheme.symmetric(grid, Ax_u, X, 1)                # fcc → ccc
        uhat = scheme.biased_by(grid, au, X, 1, ut)
        terms.append(_delta_f(grid, ut * uhat, X))             # ccc → fcc
    if not grid.is_flat(Y) and only_axis in (None, Y):
        vt = scheme.symmetric(grid, Ay_v, X, 0)                # cfc → ffc
        uhat = scheme.biased_by(grid, au, Y, 0, vt)
        terms.append(_delta_c(grid, vt * uhat, Y))             # ffc → fcc
    if not grid.is_flat(Z) and only_axis in (None, Z):
        wt = scheme.symmetric(grid, Az_w, X, 0)                # ccf → fcf
        uhat = scheme.biased_by(grid, au, Z, 0, wt,
                                zbc=zbc["u"] if zbc else None)
        terms.append(_delta_c(grid, wt * uhat, Z))             # fcf → fcc
    return _sum_terms(terms, u, grid.V(LOC_FCC))


def div_Uv(grid, scheme, u, v, w, zbc=None, only_axis=None,
           advected=None):
    """∇·(𝐯 v) at cfc; ``advected`` as in :func:`div_Uu`."""
    if scheme is None:
        return torch.zeros_like(v)
    av = v if advected is None else advected
    Ax_u, Ay_v, Az_w = _transports(grid, u, v, w)
    terms = []
    if not grid.is_flat(X) and only_axis in (None, X):
        ut = scheme.symmetric(grid, Ax_u, Y, 0)                # fcc → ffc
        vhat = scheme.biased_by(grid, av, X, 0, ut)
        terms.append(_delta_c(grid, ut * vhat, X))             # ffc → cfc
    if not grid.is_flat(Y) and only_axis in (None, Y):
        vt = scheme.symmetric(grid, Ay_v, Y, 1)                # cfc → ccc
        vhat = scheme.biased_by(grid, av, Y, 1, vt)
        terms.append(_delta_f(grid, vt * vhat, Y))             # ccc → cfc
    if not grid.is_flat(Z) and only_axis in (None, Z):
        wt = scheme.symmetric(grid, Az_w, Y, 0)                # ccf → cff
        vhat = scheme.biased_by(grid, av, Z, 0, wt,
                                zbc=zbc["v"] if zbc else None)
        terms.append(_delta_c(grid, wt * vhat, Z))             # cff → cfc
    return _sum_terms(terms, v, grid.V(LOC_CFC))


def div_Uw(grid, scheme, u, v, w, zbc=None, only_axis=None,
           advected=None):
    """∇·(𝐯 w) at ccf; ``advected`` as in :func:`div_Uu`."""
    if scheme is None:
        return torch.zeros_like(w)
    aw = w if advected is None else advected
    Ax_u, Ay_v, Az_w = _transports(grid, u, v, w)
    zw = zbc["w"] if zbc else None
    terms = []
    if not grid.is_flat(X) and only_axis in (None, X):
        # the advected quantity is w, the z-interpolated advecting velocity u
        ut = scheme.symmetric(grid, Ax_u, Z, 0,
                              zbc=zbc["u"] if zbc else None)   # fcc → fcf
        what = scheme.biased_by(grid, aw, X, 0, ut)
        terms.append(_delta_c(grid, ut * what, X))             # fcf → ccf
    if not grid.is_flat(Y) and only_axis in (None, Y):
        vt = scheme.symmetric(grid, Ay_v, Z, 0,
                              zbc=zbc["v"] if zbc else None)   # cfc → cff
        what = scheme.biased_by(grid, aw, Y, 0, vt)
        terms.append(_delta_c(grid, vt * what, Y))             # cff → ccf
    if not grid.is_flat(Z) and only_axis in (None, Z):
        wt = scheme.symmetric(grid, Az_w, Z, 1, zbc=zw)        # ccf → ccc
        what = scheme.biased_by(grid, aw, Z, 1, wt, zbc=zw)
        terms.append(_delta_f(grid, wt * what, Z))             # ccc → ccf
    return _sum_terms(terms, w, grid.V(LOC_CCF))


def cell_advection_timescale(grid, u, v, w):
    """min over the interior cells of min(Δx/|u|, Δy/|v|, Δz/|w|), a 0-d
    tensor on the fields' device (one reduction; the CFL diagnostics and
    the time-step wizard read it)."""
    eps = 1e-20
    ints = grid.interior_slices
    terms = []
    for axis, (vel, spacing) in enumerate(((u, grid.dx), (v, grid.dy),
                                           (w, grid.dz))):
        if not grid.is_flat(axis):
            terms.append((spacing(LOC_CCC) / (vel.abs() + eps))[ints].min())
    return torch.stack(terms).min()
