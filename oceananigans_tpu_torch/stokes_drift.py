"""Stokes drift: the Craik-Leibovich wave-averaged forcing.

Counterpart of ``oceananigans_tpu/stokes_drift.py``. ``UniformStokesDrift``
takes horizontally uniform profiles through ∂z uˢ, ∂z vˢ, ∂t uˢ, ∂t vˢ as
callables of (z, t):

    Gu += ∂t uˢ + w̃ ∂z uˢ,   Gv += ∂t vˢ + w̃ ∂z vˢ,
    Gw += -ũ ∂z uˢ - ṽ ∂z vˢ;

``StokesDrift`` takes the nine gradients of a varying drift as callables of
(x, y, z, t), and the full pseudovorticity enters the vortex force:

    Gu += ∂t uˢ + w̃ᶠᶜᶜ (∂z uˢ - ∂x wˢ) - ṽᶠᶜᶜ (∂x vˢ - ∂y uˢ)
    Gv += ∂t vˢ + ũᶜᶠᶜ (∂x vˢ - ∂y uˢ) - w̃ᶜᶠᶜ (∂y wˢ - ∂z vˢ)
    Gw += ∂t wˢ + ṽᶜᶜᶠ (∂y wˢ - ∂z vˢ) - ũᶜᶜᶠ (∂z uˢ - ∂x wˢ)

The callables receive the padded coordinates as broadcastable tensors of the
grid's dtype and device and the time as a Python float; a callable left as
None counts as zero.
"""

from __future__ import annotations

import torch

from .fields.field import coordinates
from .operators.operators import ix_c, ix_f, iy_c, iy_f, iz_c, iz_f


class UniformStokesDrift:
    """Horizontally uniform Stokes drift profiles."""

    def __init__(self, grad_z_us=None, grad_z_vs=None, grad_t_us=None,
                 grad_t_vs=None):
        self.grad_z_us = grad_z_us
        self.grad_z_vs = grad_z_vs
        self.grad_t_us = grad_t_us
        self.grad_t_vs = grad_t_vs

    def _fp(self):
        return ("UniformStokesDrift", id(self.grad_z_us), id(self.grad_z_vs),
                id(self.grad_t_us), id(self.grad_t_vs))

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def _eval(self, f, grid, zloc, t):
        if f is None:
            return 0.0
        z = coordinates(grid, ("c", "c", zloc))[2]
        return f(z, float(t))

    def x_tendency(self, grid, u, v, w, time):
        """∂t uˢ + w̃ᶠᶜᶜ ∂z uˢ at (f, c, c)."""
        dzus = self._eval(self.grad_z_us, grid, "c", time)
        dtus = self._eval(self.grad_t_us, grid, "c", time)
        return dtus + ix_f(grid, iz_c(grid, w)) * dzus

    def y_tendency(self, grid, u, v, w, time):
        dzvs = self._eval(self.grad_z_vs, grid, "c", time)
        dtvs = self._eval(self.grad_t_vs, grid, "c", time)
        return dtvs + iy_f(grid, iz_c(grid, w)) * dzvs

    def z_tendency(self, grid, u, v, w, time):
        """-ũᶜᶜᶠ ∂z uˢ - ṽᶜᶜᶠ ∂z vˢ at (c, c, f)."""
        out = 0.0
        if self.grad_z_us is not None:
            dzus = self._eval(self.grad_z_us, grid, "f", time)
            out = out - iz_f(grid, ix_c(grid, u)) * dzus
        if self.grad_z_vs is not None:
            dzvs = self._eval(self.grad_z_vs, grid, "f", time)
            out = out - iz_f(grid, iy_c(grid, v)) * dzvs
        if isinstance(out, float):
            return torch.zeros_like(w)
        return out


class StokesDrift:
    """A horizontally varying Stokes drift, given by its gradients."""

    def __init__(self, dx_vs=None, dx_ws=None, dy_us=None, dy_ws=None,
                 dz_us=None, dz_vs=None, dt_us=None, dt_vs=None, dt_ws=None):
        self.dx_vs, self.dx_ws = dx_vs, dx_ws
        self.dy_us, self.dy_ws = dy_us, dy_ws
        self.dz_us, self.dz_vs = dz_us, dz_vs
        self.dt_us, self.dt_vs, self.dt_ws = dt_us, dt_vs, dt_ws

    def _fp(self):
        return ("StokesDrift",) + tuple(
            id(f) for f in (self.dx_vs, self.dx_ws, self.dy_us, self.dy_ws,
                            self.dz_us, self.dz_vs, self.dt_us, self.dt_vs,
                            self.dt_ws))

    __hash__ = UniformStokesDrift.__hash__
    __eq__ = UniformStokesDrift.__eq__

    def _eval(self, f, grid, loc, t):
        if f is None:
            return 0.0
        return f(*coordinates(grid, loc), float(t))

    def x_tendency(self, grid, u, v, w, time):
        loc = ("f", "c", "c")
        w_fcc = ix_f(grid, iz_c(grid, w))
        v_fcc = ix_f(grid, iy_c(grid, v))
        return (self._eval(self.dt_us, grid, loc, time)
                + w_fcc * (self._eval(self.dz_us, grid, loc, time)
                           - self._eval(self.dx_ws, grid, loc, time))
                - v_fcc * (self._eval(self.dx_vs, grid, loc, time)
                           - self._eval(self.dy_us, grid, loc, time)))

    def y_tendency(self, grid, u, v, w, time):
        loc = ("c", "f", "c")
        w_cfc = iy_f(grid, iz_c(grid, w))
        u_cfc = iy_f(grid, ix_c(grid, u))
        return (self._eval(self.dt_vs, grid, loc, time)
                + u_cfc * (self._eval(self.dx_vs, grid, loc, time)
                           - self._eval(self.dy_us, grid, loc, time))
                - w_cfc * (self._eval(self.dy_ws, grid, loc, time)
                           - self._eval(self.dz_vs, grid, loc, time)))

    def z_tendency(self, grid, u, v, w, time):
        loc = ("c", "c", "f")
        u_ccf = iz_f(grid, ix_c(grid, u))
        v_ccf = iz_f(grid, iy_c(grid, v))
        return (self._eval(self.dt_ws, grid, loc, time)
                + v_ccf * (self._eval(self.dy_ws, grid, loc, time)
                           - self._eval(self.dz_vs, grid, loc, time))
                - u_ccf * (self._eval(self.dz_us, grid, loc, time)
                           - self._eval(self.dx_ws, grid, loc, time)))
