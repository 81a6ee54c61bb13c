"""Finite-volume stencil micro-operators on halo-padded tensors.

Counterpart of ``oceananigans_tpu/operators/operators.py``: the differences,
interpolations, metric-aware derivatives and the divergence that the
pressure projection, buoyancy and the closures use. Arakawa C conventions:
face ``i`` is the LEFT face of cell ``i``, so ``δxᶠ(c)[i] = c[i] - c[i-1]``
and ``δxᶜ(f)[i] = f[i+1] - f[i]``.
Flat directions give exact zeros (differences) or the identity
(interpolations).
"""

from __future__ import annotations

import torch

from ..grids.topology import CENTER, FACE, LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from .shifts import shift

X, Y, Z = 0, 1, 2

LOC_FFC = (FACE, FACE, CENTER)


def _metric(m, like):
    """A grid metric (Python scalar or broadcastable numpy array) in the
    dtype and on the device of ``like``."""
    if isinstance(m, (int, float)):
        return m
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


# -- differences δ -------------------------------------------------------------

def _delta_f(grid, a, axis):
    if grid.is_flat(axis):
        return torch.zeros_like(a)
    return a - shift(a, -1, axis)


def _delta_c(grid, a, axis):
    if grid.is_flat(axis):
        return torch.zeros_like(a)
    return shift(a, +1, axis) - a


def dx_f(grid, c): return _delta_f(grid, c, X)
def dx_c(grid, f): return _delta_c(grid, f, X)
def dy_f(grid, c): return _delta_f(grid, c, Y)
def dy_c(grid, f): return _delta_c(grid, f, Y)
def dz_f(grid, c): return _delta_f(grid, c, Z)
def dz_c(grid, f): return _delta_c(grid, f, Z)


def delta(grid, a, axis, out_loc_axis):
    return _delta_f(grid, a, axis) if out_loc_axis == FACE else _delta_c(grid, a, axis)


# -- interpolations ℑ ----------------------------------------------------------

def _interp_f(grid, a, axis):
    if grid.is_flat(axis):
        return a
    return 0.5 * (a + shift(a, -1, axis))


def _interp_c(grid, a, axis):
    if grid.is_flat(axis):
        return a
    return 0.5 * (shift(a, +1, axis) + a)


def ix_f(grid, c): return _interp_f(grid, c, X)
def ix_c(grid, f): return _interp_c(grid, f, X)
def iy_f(grid, c): return _interp_f(grid, c, Y)
def iy_c(grid, f): return _interp_c(grid, f, Y)
def iz_f(grid, c): return _interp_f(grid, c, Z)
def iz_c(grid, f): return _interp_c(grid, f, Z)


def interp(grid, a, axis, out_loc_axis):
    return _interp_f(grid, a, axis) if out_loc_axis == FACE else _interp_c(grid, a, axis)


def interp_to(grid, a, from_loc, to_loc):
    """Interpolate ``a`` from ``from_loc`` to ``to_loc`` with 2-point means
    along each direction that moves."""
    out = a
    for axis in range(3):
        if from_loc[axis] != to_loc[axis]:
            out = interp(grid, out, axis, to_loc[axis])
    return out


# -- metric-aware derivatives ∂ ------------------------------------------------
# ∂xᶠ(c) = δxᶠ(c)/Δxᶠ with the spacing evaluated at the OUTPUT location.

def ddx(grid, a, out_loc):
    return delta(grid, a, X, out_loc[0]) / _metric(grid.dx(out_loc), a)


def ddy(grid, a, out_loc):
    return delta(grid, a, Y, out_loc[1]) / _metric(grid.dy(out_loc), a)


def ddz(grid, a, out_loc):
    return delta(grid, a, Z, out_loc[2]) / _metric(grid.dz(out_loc), a)


# -- divergence ----------------------------------------------------------------
# divᶜᶜᶜ(u,v,w) = V⁻¹ [δxᶜ(Ax u) + δyᶜ(Ay v) + δzᶜ(Az w)]

def div_ccc(grid, u, v, w):
    return (dx_c(grid, _metric(grid.Ax(LOC_FCC), u) * u)
            + dy_c(grid, _metric(grid.Ay(LOC_CFC), v) * v)
            + dz_c(grid, _metric(grid.Az(LOC_CCF), w) * w)) \
        / _metric(grid.V(LOC_CCC), u)


def div_xy_ccc(grid, u, v):
    """Horizontal divergence V⁻¹ [δxᶜ(Ax u) + δyᶜ(Ay v)]."""
    return (dx_c(grid, _metric(grid.Ax(LOC_FCC), u) * u)
            + dy_c(grid, _metric(grid.Ay(LOC_CFC), v) * v)) \
        / _metric(grid.V(LOC_CCC), u)


# -- vorticity -----------------------------------------------------------------
# vertical vorticity at ffc by the circulation theorem:
# ζ = (δxᶠ(Δyᶜᶠᶜ v) - δyᶠ(Δxᶠᶜᶜ u)) / Az_ffc

def zeta3_ffc(grid, u, v):
    return (dx_f(grid, _metric(grid.dy(LOC_CFC), v) * v)
            - dy_f(grid, _metric(grid.dx(LOC_FCC), u) * u)) \
        / _metric(grid.Az(LOC_FFC), u)
