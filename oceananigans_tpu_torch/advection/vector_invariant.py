"""Vector-invariant (rotational form) momentum advection, conserving forms.

Counterpart of ``oceananigans_tpu/advection/vector_invariant.py`` for the
MITgcm-style conserving discretizations: the horizontal momentum advection
is a vertical-vorticity flux plus a kinetic-energy (Bernoulli head)
gradient,

    u: -(ζ v̂) + ∂x K      (at fcc)
    v: +(ζ û) + ∂y K      (at cfc)

with the ``ENSTROPHY`` or ``ENERGY`` conserving vorticity flux and the
energy-conserving K = (ℑx(u²) + ℑy(v²))/2. The shallow-water model's
vector-invariant formulation uses these terms. Upwinded or WENO vorticity,
vertical advection or kinetic-energy schemes, the multi-dimensional stencil
and ``WENOVectorInvariant`` belong to the hydrostatic slice and raise.
"""

from __future__ import annotations

from ..operators.operators import (LOC_CFC, LOC_FCC, ddx, ddy, ix_c, ix_f,
                                   iy_c, iy_f, zeta3_ffc)

ENERGY = "energy_conserving"
ENSTROPHY = "enstrophy_conserving"

VELOCITY_STENCIL = "velocity"
ONLY_SELF = "only_self"

UPWINDED_ITEM = ("ROADMAP.md queue 1 item 13 (hydrostatic: upwinded and WENO "
                 "vector-invariant schemes)")


class VectorInvariant:
    def __init__(self, vorticity_scheme=ENSTROPHY,
                 vorticity_stencil=VELOCITY_STENCIL,
                 vertical_advection_scheme=ENERGY,
                 divergence_scheme=None,
                 kinetic_energy_gradient_scheme=None,
                 upwinding=ONLY_SELF,
                 multi_dimensional_stencil=False):
        if multi_dimensional_stencil:
            raise NotImplementedError(
                f"the multi-dimensional stencil is not ported yet: "
                f"{UPWINDED_ITEM}")
        if divergence_scheme is None:
            divergence_scheme = vertical_advection_scheme
        if kinetic_energy_gradient_scheme is None:
            kinetic_energy_gradient_scheme = divergence_scheme
        for nm, s in (("vorticity_scheme", vorticity_scheme),
                      ("vertical_advection_scheme", vertical_advection_scheme),
                      ("divergence_scheme", divergence_scheme),
                      ("kinetic_energy_gradient_scheme",
                       kinetic_energy_gradient_scheme)):
            if s not in (ENERGY, ENSTROPHY):
                raise NotImplementedError(
                    f"{nm}={s!r}: only the conserving forms (ENERGY, "
                    f"ENSTROPHY) are ported: {UPWINDED_ITEM}")
        self.vorticity_scheme = vorticity_scheme
        self.required_halo = 1
        self._config = (vorticity_scheme, vorticity_stencil,
                        vertical_advection_scheme, divergence_scheme,
                        kinetic_energy_gradient_scheme, upwinding, False)

    def _fp(self):
        return ("VectorInvariant",) + self._config

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def __repr__(self):
        return f"VectorInvariant({self.vorticity_scheme})"

    def _horizontal(self, grid, u, v):
        """The vorticity flux terms at fcc and cfc."""
        zeta = zeta3_ffc(grid, u, v)
        dx_cfc, dx_fcc = grid.dx(LOC_CFC), grid.dx(LOC_FCC)
        dy_fcc, dy_cfc = grid.dy(LOC_FCC), grid.dy(LOC_CFC)
        if self.vorticity_scheme == ENSTROPHY:
            vhat = ix_f(grid, iy_c(grid, dx_cfc * v)) / dx_fcc
            uhat = iy_f(grid, ix_c(grid, dy_fcc * u)) / dy_cfc
            return -iy_c(grid, zeta) * vhat, +ix_c(grid, zeta) * uhat
        adv_u = -iy_c(grid, zeta * ix_f(grid, dx_cfc * v)) / dx_fcc
        adv_v = +ix_c(grid, zeta * iy_f(grid, dy_fcc * u)) / dy_cfc
        return adv_u, adv_v

    def _bernoulli(self, grid, u, v):
        """∂x K and ∂y K with K = (ℑx(u²) + ℑy(v²))/2."""
        K = 0.5 * (ix_c(grid, u * u) + iy_c(grid, v * v))
        return ddx(grid, K, LOC_FCC), ddy(grid, K, LOC_CFC)


def WENOVectorInvariant(*args, **kwargs):
    raise NotImplementedError(
        f"WENOVectorInvariant is not ported yet: {UPWINDED_ITEM}")
