"""Diffusive flux divergences shared by the closures.

Counterpart of ``oceananigans_tpu/closures/diffusion_operators.py`` on
regular grids without immersed boundaries: the closure adds -∂ⱼτᵢⱼ
(momentum) and -∇·q (tracers) to the tendencies, with

    isotropic viscous stress   τᵢⱼ = -2 ν Σᵢⱼ   (the full strain tensor)
    tracer flux                q = -κ ∇c

and the strain-rate components at their C-grid locations. Every function
takes and returns full padded tensors. ν and κ are Python scalars or padded
tensors: the strain forms take each at the location they name, and
``div_kappa_grad`` interpolates a cell-centred κ to each flux location.
``vitd_explicit_z_term`` is the explicit z-flux remainder that a vertically
implicit closure keeps. On an immersed grid every flux is zeroed where its
location touches a solid cell (``fluid_mask_at``): no diffusive transport
through or inside the topography.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.topology import BOUNDED, CENTER, FACE, PERIODIC
from ..operators.operators import (LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC,
                                   _delta_c, _delta_f, ddx, ddy, ddz, delta,
                                   interp)

X, Y, Z = 0, 1, 2
LOC_FFC = (FACE, FACE, CENTER)
LOC_FCF = (FACE, CENTER, FACE)
LOC_CFF = (CENTER, FACE, FACE)


def _flip(loc, axis):
    out = list(loc)
    out[axis] = FACE if loc[axis] == CENTER else CENTER
    return tuple(out)


def _area(grid, loc, axis):
    return (grid.Ax(loc), grid.Ay(loc), grid.Az(loc))[axis]


def _dd(grid, a, axis, out_loc):
    return (ddx, ddy, ddz)[axis](grid, a, out_loc)


def _fm(grid, floc, flux):
    """Zero the flux at immersed faces; other grids pass it unchanged."""
    fmat = getattr(grid, "fluid_mask_at", None)
    if fmat is None:
        return flux
    return flux * fmat(floc, flux.dtype)


def _interp_kappa(grid, kappa, axis, floc):
    """κ at the flux location: a scalar passes through, a cell-centred
    tensor is interpolated along ``axis``."""
    if not isinstance(kappa, torch.Tensor) or kappa.ndim == 0:
        return kappa
    return interp(grid, kappa, axis, floc[axis])


def div_kappa_grad(grid, q, loc, kappa, axes=(0, 1, 2)):
    """∇·(κ ∇q) at ``loc`` over the selected axes (ADDED to G)."""
    total = None
    for axis in axes:
        if grid.is_flat(axis):
            continue
        floc = _flip(loc, axis)
        grad = _dd(grid, q, axis, floc)
        k = _interp_kappa(grid, kappa, axis, floc)
        flux = _fm(grid, floc, _area(grid, floc, axis) * k * grad)
        term = delta(grid, flux, axis, loc[axis])
        total = term if total is None else total + term
    if total is None:
        return torch.zeros_like(q)
    return total / grid.V(loc)


def vitd_explicit_z_term(grid, q, loc, kappa, cross_grad=None):
    """The explicit z-flux remainder under the vertically implicit time
    discretization: the implicit tridiagonal solve owns κ ∂z q on the
    interior z faces and drops the boundary faces, so the explicit tendency
    keeps the full flux on the two boundary faces (where Value and Gradient
    conditions act) and ``cross_grad``, the part of the flux the
    tridiagonal cannot represent (ν ∂x w for the strain form), everywhere.

    Returns the tendency contribution (ADDED to G), or None when z has no
    halo, is flat or is not bounded; raises on a periodic z."""
    if not grid.is_flat(Z) and grid.topology[2] == PERIODIC:
        raise ValueError(
            "VerticallyImplicitTimeDiscretization needs a Bounded z "
            "direction; use ExplicitTimeDiscretization on z-periodic grids")
    if grid.is_flat(Z) or grid.topology[2] != BOUNDED or grid.H[2] < 1:
        return None
    floc = _flip(loc, Z)
    h, n = grid.H[2], grid.N[2]
    bmask = np.zeros(q.shape[2])
    bmask[h] = 1.0          # bottom boundary face (face k lies below cell k)
    bmask[h + n] = 1.0      # top boundary face
    bmask = torch.as_tensor(bmask.reshape(1, 1, -1), dtype=q.dtype,
                            device=q.device)
    grad = _dd(grid, q, Z, floc) * bmask
    if cross_grad is not None:
        grad = grad + cross_grad
    k = _interp_kappa(grid, kappa, Z, floc)
    flux = _fm(grid, floc, _area(grid, floc, Z) * k * grad)
    return delta(grid, flux, Z, loc[2]) / grid.V(loc)


# -- strain-rate tensor components --------------------------------------------

def Sxx_ccc(grid, u):
    return ddx(grid, u, LOC_CCC)


def Syy_ccc(grid, v):
    return ddy(grid, v, LOC_CCC)


def Szz_ccc(grid, w):
    return ddz(grid, w, LOC_CCC)


def Sxy_ffc(grid, u, v):
    return 0.5 * (ddy(grid, u, LOC_FFC) + ddx(grid, v, LOC_FFC))


def Sxz_fcf(grid, u, w):
    return 0.5 * (ddz(grid, u, LOC_FCF) + ddx(grid, w, LOC_FCF))


def Syz_cff(grid, v, w):
    return 0.5 * (ddz(grid, v, LOC_CFF) + ddy(grid, w, LOC_CFF))


def _sum_over_volume(terms, like, V):
    if not terms:
        return torch.zeros_like(like)
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total / V


def div_2nu_strain_u(grid, u, v, w, nu_ccc, nu_ffc, nu_fcf, axes=(0, 1, 2)):
    """-∂ⱼτ₁ⱼ with τ₁ⱼ = -2νΣ₁ⱼ: the isotropic viscous tendency for u at fcc."""
    terms = []
    if X in axes and not grid.is_flat(X):
        flux = _fm(grid, LOC_CCC,
                   grid.Ax(LOC_CCC) * 2 * nu_ccc * Sxx_ccc(grid, u))
        terms.append(_delta_f(grid, flux, X))
    if Y in axes and not grid.is_flat(Y):
        flux = _fm(grid, LOC_FFC,
                   grid.Ay(LOC_FFC) * 2 * nu_ffc * Sxy_ffc(grid, u, v))
        terms.append(_delta_c(grid, flux, Y))
    if Z in axes and not grid.is_flat(Z):
        flux = _fm(grid, LOC_FCF,
                   grid.Az(LOC_FCF) * 2 * nu_fcf * Sxz_fcf(grid, u, w))
        terms.append(_delta_c(grid, flux, Z))
    return _sum_over_volume(terms, u, grid.V(LOC_FCC))


def div_2nu_strain_v(grid, u, v, w, nu_ccc, nu_ffc, nu_cff, axes=(0, 1, 2)):
    terms = []
    if X in axes and not grid.is_flat(X):
        flux = _fm(grid, LOC_FFC,
                   grid.Ax(LOC_FFC) * 2 * nu_ffc * Sxy_ffc(grid, u, v))
        terms.append(_delta_c(grid, flux, X))
    if Y in axes and not grid.is_flat(Y):
        flux = _fm(grid, LOC_CCC,
                   grid.Ay(LOC_CCC) * 2 * nu_ccc * Syy_ccc(grid, v))
        terms.append(_delta_f(grid, flux, Y))
    if Z in axes and not grid.is_flat(Z):
        flux = _fm(grid, LOC_CFF,
                   grid.Az(LOC_CFF) * 2 * nu_cff * Syz_cff(grid, v, w))
        terms.append(_delta_c(grid, flux, Z))
    return _sum_over_volume(terms, v, grid.V(LOC_CFC))


def div_2nu_strain_w(grid, u, v, w, nu_ccc, nu_fcf, nu_cff, axes=(0, 1, 2)):
    terms = []
    if X in axes and not grid.is_flat(X):
        flux = _fm(grid, LOC_FCF,
                   grid.Ax(LOC_FCF) * 2 * nu_fcf * Sxz_fcf(grid, u, w))
        terms.append(_delta_c(grid, flux, X))
    if Y in axes and not grid.is_flat(Y):
        flux = _fm(grid, LOC_CFF,
                   grid.Ay(LOC_CFF) * 2 * nu_cff * Syz_cff(grid, v, w))
        terms.append(_delta_c(grid, flux, Y))
    if Z in axes and not grid.is_flat(Z):
        flux = _fm(grid, LOC_CCC,
                   grid.Az(LOC_CCC) * 2 * nu_ccc * Szz_ccc(grid, w))
        terms.append(_delta_f(grid, flux, Z))
    return _sum_over_volume(terms, w, grid.V(LOC_CCF))
