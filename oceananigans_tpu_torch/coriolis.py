"""Coriolis forces.

Counterpart of ``oceananigans_tpu/coriolis.py`` for ``FPlane``,
``ConstantCartesianCoriolis``, ``BetaPlane`` and, on a lat-lon grid,
``HydrostaticSphericalCoriolis``. Each object is static
configuration; ``x_f_cross_U`` / ``y_f_cross_U`` / ``z_f_cross_U`` take padded
(u, v, w) tensors and return the components of f×U at the (f,c,c) / (c,f,c) /
(c,c,f) locations, built from 4-point means of the staggered transverse
velocities (the energy-conserving discretization). The tendency assembly
subtracts them.

``NonTraditionalBetaPlane`` adds the horizontal component of the rotation
(the non-traditional terms); it serves the nonhydrostatic model.
"""

from __future__ import annotations

import numpy as np
import torch

from .defaults import defaults
from .operators.operators import ix_c, ix_f, iy_c, iy_f, iz_c, iz_f

def _v_at_fcc(grid, v):
    # (c,f,c) → (f,c,c): interp x to face, y to center
    return ix_f(grid, iy_c(grid, v))


def _u_at_cfc(grid, u):
    return iy_f(grid, ix_c(grid, u))


def _w_at_fcc(grid, w):
    return ix_f(grid, iz_c(grid, w))


def _u_at_ccf(grid, u):
    return iz_f(grid, ix_c(grid, u))


def _w_at_cfc(grid, w):
    return iy_f(grid, iz_c(grid, w))


def _v_at_ccf(grid, v):
    return iz_f(grid, iy_c(grid, v))


class FPlane:
    """f-plane: f×U = (-f v, f u, 0)."""

    def __init__(self, f=None, rotation_rate=None, latitude=None):
        if f is None:
            rr = defaults.rotation_rate if rotation_rate is None else rotation_rate
            if latitude is None:
                raise ValueError("provide f or latitude")
            f = 2 * rr * np.sin(np.deg2rad(latitude))
        self.f = float(f)

    def _fp(self):
        return ("FPlane", self.f)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def x_f_cross_U(self, grid, u, v, w):
        return -self.f * _v_at_fcc(grid, v)

    def y_f_cross_U(self, grid, u, v, w):
        return self.f * _u_at_cfc(grid, u)

    def z_f_cross_U(self, grid, u, v, w):
        return torch.zeros_like(w)


class ConstantCartesianCoriolis:
    """Rotation axis in an arbitrary direction: f×U with f = (fx, fy, fz)."""

    def __init__(self, fx=0.0, fy=0.0, fz=0.0, f=None, rotation_axis=None):
        if f is not None:
            ax = np.asarray(rotation_axis if rotation_axis is not None
                            else (0, 0, 1.0), float)
            ax = ax / np.linalg.norm(ax)
            fx, fy, fz = f * ax
        self.fx, self.fy, self.fz = float(fx), float(fy), float(fz)

    def _fp(self):
        return ("ConstantCartesianCoriolis", self.fx, self.fy, self.fz)

    __hash__ = FPlane.__hash__
    __eq__ = FPlane.__eq__

    def x_f_cross_U(self, grid, u, v, w):
        return self.fy * _w_at_fcc(grid, w) - self.fz * _v_at_fcc(grid, v)

    def y_f_cross_U(self, grid, u, v, w):
        return self.fz * _u_at_cfc(grid, u) - self.fx * _w_at_cfc(grid, w)

    def z_f_cross_U(self, grid, u, v, w):
        return self.fx * _v_at_ccf(grid, v) - self.fy * _u_at_ccf(grid, u)


class BetaPlane:
    """f = f₀ + βy."""

    def __init__(self, f0=None, beta=None, rotation_rate=None, latitude=None,
                 radius=None):
        if f0 is None or beta is None:
            rr = defaults.rotation_rate if rotation_rate is None else rotation_rate
            R = defaults.planet_radius if radius is None else radius
            phi = np.deg2rad(latitude)
            f0 = 2 * rr * np.sin(phi)
            beta = 2 * rr * np.cos(phi) / R
        self.f0, self.beta = float(f0), float(beta)

    def _fp(self):
        return ("BetaPlane", self.f0, self.beta)

    __hash__ = FPlane.__hash__
    __eq__ = FPlane.__eq__

    def _f_at(self, grid, yloc, like):
        y = grid.coord_padded(1, yloc).reshape(1, -1, 1)
        return torch.as_tensor(self.f0 + self.beta * y, dtype=like.dtype,
                               device=like.device)

    def x_f_cross_U(self, grid, u, v, w):
        return -self._f_at(grid, "c", v) * _v_at_fcc(grid, v)

    def y_f_cross_U(self, grid, u, v, w):
        return self._f_at(grid, "f", u) * _u_at_cfc(grid, u)

    def z_f_cross_U(self, grid, u, v, w):
        return torch.zeros_like(w)


def constant_f(coriolis):
    """The constant vertical f of ``coriolis`` for a horizontal flow (w = 0):
    0 for None, f for ``FPlane``, fz for ``ConstantCartesianCoriolis`` (its x
    and y rows reduce to fz's when w = 0); None when f varies in space."""
    if coriolis is None:
        return 0.0
    if isinstance(coriolis, FPlane):
        return coriolis.f
    if isinstance(coriolis, ConstantCartesianCoriolis):
        return coriolis.fz
    return None


class NonTraditionalBetaPlane:
    """The full-Coriolis β-plane that keeps the horizontal rotation
    component (Dellar 2011, §5):

        2Ωʸ(y, z) = fy (1 −  z/R) + γ y
        2Ωᶻ(y, z) = fz (1 + 2z/R) + β y

    with (fz, fy, β, γ) = (2Ω sin φ, 2Ω cos φ, 2Ω cos φ/R, −4Ω sin φ/R)
    from ``latitude`` where not given."""

    def __init__(self, fz0=None, beta=None, fy0=None, gamma=None,
                 rotation_rate=None, latitude=None, radius=None):
        rr = defaults.rotation_rate if rotation_rate is None else rotation_rate
        R = defaults.planet_radius if radius is None else radius
        if latitude is not None:
            phi = np.deg2rad(latitude)
            fz0 = 2 * rr * np.sin(phi) if fz0 is None else fz0
            beta = 2 * rr * np.cos(phi) / R if beta is None else beta
            fy0 = 2 * rr * np.cos(phi) if fy0 is None else fy0
            gamma = -4 * rr * np.sin(phi) / R if gamma is None else gamma
        self.fz0, self.beta = float(fz0), float(beta)
        self.fy0, self.gamma = float(fy0), float(gamma or 0.0)
        self.R = float(R)

    def _fp(self):
        return ("NonTraditionalBetaPlane", self.fz0, self.beta, self.fy0,
                self.gamma, self.R)

    __hash__ = FPlane.__hash__
    __eq__ = FPlane.__eq__

    def _yz(self, grid, yloc, zloc):
        return (grid.coord_padded(1, yloc).reshape(1, -1, 1),
                grid.coord_padded(2, zloc).reshape(1, 1, -1))

    def _two_Oy(self, grid, yloc, zloc, like):
        y, z = self._yz(grid, yloc, zloc)
        return torch.as_tensor(self.fy0 * (1 - z / self.R) + self.gamma * y,
                               dtype=like.dtype, device=like.device)

    def _two_Oz(self, grid, yloc, zloc, like):
        y, z = self._yz(grid, yloc, zloc)
        return torch.as_tensor(
            self.fz0 * (1 + 2 * z / self.R) + self.beta * y,
            dtype=like.dtype, device=like.device)

    def x_f_cross_U(self, grid, u, v, w):
        # ℑx(2Ωʸ ℑz w − 2Ωᶻ ℑy v), the product formed at the cell centres
        Oy = self._two_Oy(grid, "c", "c", u)
        Oz = self._two_Oz(grid, "c", "c", u)
        return ix_f(grid, Oy * iz_c(grid, w) - Oz * iy_c(grid, v))

    def y_f_cross_U(self, grid, u, v, w):
        return self._two_Oz(grid, "f", "c", u) * _u_at_cfc(grid, u)

    def z_f_cross_U(self, grid, u, v, w):
        return -self._two_Oy(grid, "c", "f", u) * _u_at_ccf(grid, u)


class HydrostaticSphericalCoriolis:
    """f = 2Ω sin(φ) on a spherical grid, at the (f, f) nodes (the exact
    2-D nodes of a shell grid), in the metric-weighted Sadourny forms:
    ``energy_conserving`` (the default) takes the f-flux of the transport,
    ℑy(f ℑx(Δx v))/Δx; ``enstrophy_conserving`` takes
    ℑy(f) ℑx(ℑy(Δx v))/Δx."""

    def __init__(self, rotation_rate=None, scheme="energy_conserving"):
        self.rotation_rate = (defaults.rotation_rate if rotation_rate is None
                              else float(rotation_rate))
        if scheme not in ("energy_conserving", "enstrophy_conserving"):
            raise ValueError(scheme)
        self.scheme = scheme

    def _fp(self):
        return ("HydrostaticSphericalCoriolis", self.rotation_rate,
                self.scheme)

    __hash__ = FPlane.__hash__
    __eq__ = FPlane.__eq__

    def f_ffc_numpy(self, grid):
        """f at the (f, f) nodes, float64: (1, Ny + 2Hy, 1) on a grid with a
        1-D latitude, (Nx + 2Hx, Ny + 2Hy, 1) on a shell grid."""
        if hasattr(grid, "nodes2d_padded"):
            _, phi = grid.nodes2d_padded(("f", "f"))
            return 2 * self.rotation_rate * np.sin(np.deg2rad(phi))[..., None]
        phi = grid.coord_padded(1, "f").reshape(1, -1, 1)
        return 2 * self.rotation_rate * np.sin(np.deg2rad(
            np.clip(phi, -90, 90)))

    def _f_ffc(self, grid, like):
        key = (self.rotation_rate, like.dtype, str(like.device))
        cache = grid.__dict__.setdefault("_coriolis_f_ffc", {})
        if key not in cache:
            cache[key] = torch.as_tensor(self.f_ffc_numpy(grid),
                                         dtype=like.dtype, device=like.device)
        return cache[key]

    def x_f_cross_U(self, grid, u, v, w):
        from .grids.topology import LOC_CFC, LOC_FCC
        from .operators.operators import _metric
        f = self._f_ffc(grid, v)
        dx_cfc = _metric(grid.dx(LOC_CFC), v)
        dx_fcc = _metric(grid.dx(LOC_FCC), v)
        if self.scheme == "energy_conserving":
            return -iy_c(grid, f * ix_f(grid, dx_cfc * v)) / dx_fcc
        return -iy_c(grid, f) * ix_f(grid, iy_c(grid, dx_cfc * v)) / dx_fcc

    def y_f_cross_U(self, grid, u, v, w):
        from .grids.topology import LOC_CFC, LOC_FCC
        from .operators.operators import _metric
        f = self._f_ffc(grid, u)
        # a zonally uniform f, (1, Ny + 2Hy, 1), skips its own x
        # interpolation (an x shift of a size-1 axis would zero it); the
        # energy form's outer ℑx acts on the product, which varies in x
        fx = f if f.shape[0] == 1 else ix_c(grid, f)
        dy_fcc = _metric(grid.dy(LOC_FCC), u)
        dy_cfc = _metric(grid.dy(LOC_CFC), u)
        if self.scheme == "energy_conserving":
            return ix_c(grid, f * iy_f(grid, dy_fcc * u)) / dy_cfc
        return fx * iy_f(grid, ix_c(grid, dy_fcc * u)) / dy_cfc

    def z_f_cross_U(self, grid, u, v, w):
        return torch.zeros_like(w)
