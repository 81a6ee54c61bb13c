"""Advective flux divergences for tracers and momentum (flux form).

Counterpart of ``oceananigans_tpu/advection/fluxes.py`` (no slab trimming,
no bounds-preserving branch): the advecting velocity is the scheme's
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

X, Y, Z = 0, 1, 2


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


def div_Uc(grid, scheme, u, v, w, c, zbc=None):
    """Tracer advective flux divergence ∇·(𝐯 c) at ccc."""
    if scheme is None:
        return torch.zeros_like(c)
    total = None
    for axis, vel, A in ((X, u, grid.Ax(LOC_FCC)), (Y, v, grid.Ay(LOC_CFC)),
                         (Z, w, grid.Az(LOC_CCF))):
        if grid.is_flat(axis):
            continue
        kind = zbc["c"] if (zbc is not None and axis == Z) else None
        chat = scheme.biased_by(grid, c, axis, 0, vel, zbc=kind)
        term = _delta_c(grid, A * vel * chat, axis)
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
