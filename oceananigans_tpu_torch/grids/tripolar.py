"""TripolarGrid: the global ocean grid, with two northern coordinate poles
over land and a fold (the zipper) along its northern edge.

Counterpart of ``oceananigans_tpu/grids/tripolar.py``: Murray's (1996)
cofocal ellipse/hyperbola construction. With focal distance
a = tan((90 - φₚ)/2), the stereographic-plane points

    ψ = asinh(tan((90 - φ)/2) / a),
    x = a sin(λ) cosh ψ,  y = a cos(λ) sinh ψ,

map back to (λ', φ') = (-atan(y/x) ± 90 + λ₀, 90 - (360/π) atan√(x² + y²)),
which places two coordinate poles at latitude φₚ on longitudes λ₀ and
λ₀ + 180; away from them the map is close to the identity, so the southern
part is a lat-lon grid. x is periodic; the north edge folds onto itself
(``zipper_north``): the fields' north conditions are
``ZipperBoundaryCondition`` with sign −1 for velocity-like fields and +1 for
tracer-like ones.

Unlike the JAX grid, this one takes ``dtype=`` and ``device=``.
"""

from __future__ import annotations

import numpy as np

from . import topology as topo
from .orthogonal_spherical_shell import OrthogonalSphericalShellGrid

DEG = np.pi / 180.0


def _tripolar_lambda_phi(lam1d, phi1d, first_pole_longitude, focal_a, Nlam):
    lam, phi = np.meshgrid(lam1d, phi1d, indexing="ij")
    psi = np.arcsinh(np.tan((90 - phi) * DEG / 2) / focal_a)
    x = focal_a * np.sin(lam * DEG) * np.cosh(psi)
    y = focal_a * np.cos(lam * DEG) * np.sinh(psi)
    with np.errstate(divide="ignore", invalid="ignore"):
        lam2 = -np.degrees(np.arctan(y / x))
    # at the exact pole the longitude is arbitrary: keep continuity
    pole = (x == 0) & (y == 0)
    iidx = np.arange(lam.shape[0])[:, None] * np.ones_like(lam2)
    lam2 = np.where(pole, np.where(iidx == 0, -90.0, 90.0), lam2)
    # the hemisphere branch of the arctan: columns with λ < 0 take the -90
    # offset; the exact λ = 0 column (x = +0.0, arctan = +90) belongs to the
    # +90 branch
    lam2 += np.where(np.arange(lam.shape[0])[:, None] < Nlam // 2, -90.0,
                     90.0)
    lam2 += first_pole_longitude + 90.0
    lam2 = np.mod(lam2, 360.0)
    phi2 = 90 - np.degrees(2 * np.arctan(np.sqrt(x ** 2 + y ** 2)))
    return lam2, phi2


class TripolarGrid(OrthogonalSphericalShellGrid):
    zipper_north = True

    def __init__(self, size, southernmost_latitude=-80.0,
                 north_poles_latitude=55.0, first_pole_longitude=70.0,
                 z=None, radius=None, halo=None, dtype=None, device=None):
        Nx, Ny = size[0], size[1]
        a = np.tan((90 - north_poles_latitude) * DEG / 2)
        lam2, phi2 = _tripolar_lambda_phi(
            np.linspace(-180.0, 180.0, Nx + 1),
            np.linspace(southernmost_latitude, 90.0, Ny + 1),
            first_pole_longitude, a, Nx)
        super().__init__(lam2, phi2, z=z, size=size, radius=radius,
                         topology=(topo.PERIODIC, topo.BOUNDED,
                                   topo.BOUNDED if z is not None
                                   else topo.FLAT),
                         halo=halo, dtype=dtype, device=device)
        self.north_poles_latitude = float(north_poles_latitude)
        self.first_pole_longitude = float(first_pole_longitude)
        self.southernmost_latitude = float(southernmost_latitude)

    def _rebuild(self, halo, dtype, device):
        """This grid with another halo, dtype or device: still a
        TripolarGrid, so the fold stays."""
        zspec = self._zc.spec()
        return TripolarGrid(
            size=self.N if zspec is not None else self.N[:2],
            southernmost_latitude=self.southernmost_latitude,
            north_poles_latitude=self.north_poles_latitude,
            first_pole_longitude=self.first_pole_longitude,
            z=zspec, radius=self.radius, halo=halo, dtype=dtype,
            device=device)

    def _fingerprint(self):
        return ("TripolarGrid",) + super()._fingerprint()[1:]

    def __repr__(self):
        return (f"TripolarGrid(size={self.N}, halo={self.H}, poles at "
                f"{self.north_poles_latitude}N, dtype={self.dtype}, "
                f"device={self.device})")


__all__ = ["TripolarGrid"]
