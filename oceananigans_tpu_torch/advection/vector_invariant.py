"""Vector-invariant (rotational form) momentum advection.

Counterpart of ``oceananigans_tpu/advection/vector_invariant.py``. The horizontal momentum advection splits into a
vertical-vorticity flux, a kinetic-energy (Bernoulli head) gradient and
vertical advection:

    u: -(ζ v̂) + ∂x K + [w ∂z u]      (at fcc)
    v: +(ζ û) + ∂y K + [w ∂z v]      (at cfc)

The vorticity flux is ``ENSTROPHY`` or ``ENERGY`` conserving, or an upwind
(WENO) reconstruction of ζ along the transport direction, whose smoothness
is measured on the velocities interpolated to the vorticity nodes
(``VELOCITY_STENCIL``) or on ζ itself. With upwind vertical and
kinetic-energy schemes the vertical term is a flux divergence plus an
upwinded horizontal-divergence flux Φᵟ, and the kinetic-energy gradient is
split into a self-upwinded part and a centered cross part
(``ONLY_SELF``; ``CROSS_AND_SELF`` upwinds the whole divergence).
``WENOVectorInvariant()`` is WENO-9 vorticity with the velocity stencil and
WENO-5 vertical advection, divergence flux and kinetic-energy gradient, with
``ONLY_SELF``.

``multi_dimensional_stencil=True`` filters each horizontal reconstruction
(the upwinded vorticity, the kinetic-energy gradient's two parts and the
ONLY_SELF divergence flux) along the other horizontal axis with the
5-point centred WENO filter of ``multidimensional.centered_weno5_filter``;
it needs two more halo cells. On a moving (z-star) grid the models pass
the grid-motion term Az·Δr·∂t_σ (``grid_motion=``), which enters the
symmetric part of the ONLY_SELF divergence flux and the whole upwinded
divergence under CROSS_AND_SELF.
"""

from __future__ import annotations

import torch

from ..operators.operators import (LOC_CFC, LOC_FCC, X, Y, Z,
                                   _metric, ddx, ddy, ddz, dx_c, dx_f, dy_c,
                                   dy_f, dz_c, ix_c, ix_f, iy_c, iy_f, iz_c,
                                   zeta3_ffc)
from .schemes import AdvectionScheme, Centered, WENO

ENERGY = "energy_conserving"
ENSTROPHY = "enstrophy_conserving"

VELOCITY_STENCIL = "velocity"
DEFAULT_STENCIL = "default"

ONLY_SELF = "only_self"
CROSS_AND_SELF = "cross_and_self"

LOC_FCF = ("f", "c", "f")
LOC_CFF = ("c", "f", "f")
LOC_CCF = ("c", "c", "f")

def _sym(scheme, grid, a, axis, beta):
    """Symmetric interpolation by a possibly-upwind scheme's centered
    counterpart; a conserving sentinel takes the 2-point mean."""
    if scheme is None or not isinstance(scheme, AdvectionScheme):
        scheme = Centered(2)
    return scheme.symmetric(grid, a, axis, beta)


class VectorInvariant:
    def __init__(self, vorticity_scheme=ENSTROPHY,
                 vorticity_stencil=VELOCITY_STENCIL,
                 vertical_advection_scheme=ENERGY,
                 divergence_scheme=None,
                 kinetic_energy_gradient_scheme=None,
                 upwinding=ONLY_SELF,
                 multi_dimensional_stencil=False):
        for nm, s in (("vorticity_scheme", vorticity_scheme),
                      ("vertical_advection_scheme", vertical_advection_scheme),
                      ("divergence_scheme", divergence_scheme),
                      ("kinetic_energy_gradient_scheme",
                       kinetic_energy_gradient_scheme)):
            if s is not None and not isinstance(s, AdvectionScheme) \
                    and s not in (ENERGY, ENSTROPHY):
                raise ValueError(
                    f"{nm} must be ENERGY/ENSTROPHY or an AdvectionScheme "
                    f"(UpwindBiased/WENO), got {s!r}")
        if upwinding not in (ONLY_SELF, CROSS_AND_SELF):
            raise ValueError(f"unknown upwinding {upwinding!r}")
        self.multi_dimensional_stencil = bool(multi_dimensional_stencil)
        self.vorticity_scheme = vorticity_scheme
        self.vorticity_stencil = vorticity_stencil
        self.vertical_advection_scheme = vertical_advection_scheme
        if divergence_scheme is None:
            divergence_scheme = vertical_advection_scheme
        if kinetic_energy_gradient_scheme is None:
            kinetic_energy_gradient_scheme = divergence_scheme
        self.divergence_scheme = divergence_scheme
        self.kinetic_energy_gradient_scheme = kinetic_energy_gradient_scheme
        self.upwinding = upwinding
        halos = [1]
        for s in (vorticity_scheme, vertical_advection_scheme,
                  divergence_scheme, kinetic_energy_gradient_scheme):
            if isinstance(s, AdvectionScheme):
                halos.append(s.required_halo)
        h = max(halos)
        # ζ needs one halo of its own, so an upwind scheme needs one more
        self.required_halo = h if h == 1 else h + 1
        if self.multi_dimensional_stencil:
            self.required_halo += 2   # the tangential 5-point filter

    def _fp(self):
        def fp(s):
            return s._fp() if isinstance(s, AdvectionScheme) else s
        return ("VectorInvariant", fp(self.vorticity_scheme),
                self.vorticity_stencil, fp(self.vertical_advection_scheme),
                fp(self.divergence_scheme),
                fp(self.kinetic_energy_gradient_scheme), self.upwinding,
                self.multi_dimensional_stencil)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def __repr__(self):
        return f"VectorInvariant({self.vorticity_scheme})"

    def _md(self, a, interp_axis):
        """The tangential filter of a reconstruction along ``interp_axis``:
        along the other horizontal axis, when the stencil is on."""
        if not self.multi_dimensional_stencil:
            return a
        from .multidimensional import centered_weno5_filter
        return centered_weno5_filter(a, 1 - interp_axis)

    # -- horizontal (vorticity) term ------------------------------------------

    def _horizontal(self, grid, u, v, zeta=None):
        """The vorticity flux terms (to be subtracted) at fcc and cfc;
        ``zeta`` replaces the curl of (u, v) when given."""
        if zeta is None:
            zeta = zeta3_ffc(grid, u, v)
        dx_cfc = _metric(grid.dx(LOC_CFC), v)
        dx_fcc = _metric(grid.dx(LOC_FCC), u)
        dy_fcc = _metric(grid.dy(LOC_FCC), u)
        dy_cfc = _metric(grid.dy(LOC_CFC), v)
        vhat = ix_f(grid, iy_c(grid, dx_cfc * v)) / dx_fcc   # fcc
        uhat = iy_f(grid, ix_c(grid, dy_fcc * u)) / dy_cfc   # cfc
        vs = self.vorticity_scheme
        if vs == ENSTROPHY:
            return -iy_c(grid, zeta) * vhat, +ix_c(grid, zeta) * uhat
        if vs == ENERGY:
            adv_u = -iy_c(grid, zeta * ix_f(grid, dx_cfc * v)) / dx_fcc
            adv_v = +ix_c(grid, zeta * iy_f(grid, dy_fcc * u)) / dy_cfc
            return adv_u, adv_v
        smooth = None
        if self.vorticity_stencil == VELOCITY_STENCIL and isinstance(vs, WENO):
            smooth = [iy_f(grid, u), ix_f(grid, v)]   # both at ffc
        adv_u = -vhat * self._md(
            vs.biased_by(grid, zeta, Y, 1, vhat, smooth=smooth), Y)
        adv_v = +uhat * self._md(
            vs.biased_by(grid, zeta, X, 1, uhat, smooth=smooth), X)
        return adv_u, adv_v

    # -- Bernoulli head (kinetic-energy gradient) -----------------------------

    def _bernoulli(self, grid, u, v):
        ks = self.kinetic_energy_gradient_scheme
        if not isinstance(ks, AdvectionScheme):
            K = 0.5 * (ix_c(grid, u * u) + iy_c(grid, v * v))
            return ddx(grid, K, LOC_FCC), ddy(grid, K, LOC_CFC)
        # self-upwinded: δx(u²/2) reconstructed along x by the sign of u,
        # the cross δx(v²/2) interpolated symmetrically, and the mirror for v
        cross = self.upwinding_cross_scheme
        du2 = dx_c(grid, 0.5 * u * u)     # ccc
        dv2 = dy_c(grid, 0.5 * v * v)     # ccc
        du2y = dy_f(grid, 0.5 * u * u)    # ffc
        dv2x = dx_f(grid, 0.5 * v * v)    # ffc
        dKvs = self._md(_sym(cross, grid, dv2x, Y, 1), Y)      # ffc → fcc
        dKur = self._md(ks.biased_by(grid, du2, X, 0, u,
                                     smooth=[ix_c(grid, u)]), X)
        bern_u = (dKur + dKvs) / _metric(grid.dx(LOC_FCC), u)
        dKus = self._md(_sym(cross, grid, du2y, X, 1), X)      # ffc → cfc
        dKvr = self._md(ks.biased_by(grid, dv2, Y, 0, v,
                                     smooth=[iy_c(grid, v)]), Y)
        bern_v = (dKvr + dKus) / _metric(grid.dy(LOC_CFC), v)
        return bern_u, bern_v

    @property
    def upwinding_cross_scheme(self):
        ds = self.divergence_scheme
        if isinstance(ds, AdvectionScheme):
            return getattr(ds, "advecting_velocity_scheme", ds)
        return Centered(2)

    # -- vertical advection + divergence flux ---------------------------------

    def _vertical(self, grid, u, v, w, grid_motion=None):
        vas = self.vertical_advection_scheme
        if grid.is_flat(Z):
            if not isinstance(vas, AdvectionScheme):
                return torch.zeros_like(u), torch.zeros_like(v)
            adv_u, adv_v = self._divergence_flux(grid, u, v, grid_motion)
            return (adv_u / _metric(grid.V(LOC_FCC), u),
                    adv_v / _metric(grid.V(LOC_CFC), v))
        Az_w = _metric(grid.Az(LOC_CCF), w) * w
        if not isinstance(vas, AdvectionScheme):
            # energy conserving: ℑz(ℑx(Az w) ∂z u) / Az
            adv_u = iz_c(grid, ix_f(grid, Az_w) * ddz(grid, u, LOC_FCF)) \
                / _metric(grid.Az(LOC_FCC), u)
            adv_v = iz_c(grid, iy_f(grid, Az_w) * ddz(grid, v, LOC_CFF)) \
                / _metric(grid.Az(LOC_CFC), v)
            return adv_u, adv_v
        # upwind: (Φᵟ + δz(Az ŵ û)) / V
        phi_u, phi_v = self._divergence_flux(grid, u, v, grid_motion)
        what_u = _sym(vas, grid, Az_w, X, 0)     # ccf → fcf
        az_u = dz_c(grid, what_u * vas.biased_by(grid, u, Z, 0, what_u))
        what_v = _sym(vas, grid, Az_w, Y, 0)     # ccf → cff
        az_v = dz_c(grid, what_v * vas.biased_by(grid, v, Z, 0, what_v))
        return ((phi_u + az_u) / _metric(grid.V(LOC_FCC), u),
                (phi_v + az_v) / _metric(grid.V(LOC_CFC), v))

    def _divergence_flux(self, grid, u, v, grid_motion=None):
        """The upwinded horizontal-divergence flux Φᵟ at fcc and cfc;
        ``grid_motion``: Az·Δr·∂t_σ at ccc on a moving grid."""
        ds = self.divergence_scheme
        cross = self.upwinding_cross_scheme
        dU = dx_c(grid, _metric(grid.Ax(LOC_FCC), u) * u)    # ccc
        dV = dy_c(grid, _metric(grid.Ay(LOC_CFC), v) * v)    # ccc
        gm = 0.0 if grid_motion is None else grid_motion
        if self.upwinding == CROSS_AND_SELF:
            div = dU + dV + gm
            return (u * ds.biased_by(grid, div, X, 0, u),
                    v * ds.biased_by(grid, div, Y, 0, v))
        div_smooth = [dU + dV]
        dvs = _sym(cross, grid, dV + gm, X, 0)
        phi_u = u * self._md(dvs + ds.biased_by(grid, dU, X, 0, u,
                                                smooth=div_smooth), X)
        dus = _sym(cross, grid, dU + gm, Y, 0)
        phi_v = v * self._md(dus + ds.biased_by(grid, dV, Y, 0, v,
                                                smooth=div_smooth), Y)
        return phi_u, phi_v

    # -- assembly --------------------------------------------------------------

    def momentum_tendencies(self, grid, u, v, w, grid_motion=None):
        """(U·∇u, U·∇v): the advection terms to be subtracted from the
        tendencies; ``grid_motion`` as in ``_divergence_flux``."""
        h_u, h_v = self._horizontal(grid, u, v)
        b_u, b_v = self._bernoulli(grid, u, v)
        z_u, z_v = self._vertical(grid, u, v, w, grid_motion)
        return h_u + b_u + z_u, h_v + b_v + z_v


def WENOVectorInvariant(order=None, vorticity_order=None, vertical_order=None,
                        divergence_order=None,
                        kinetic_energy_gradient_order=None,
                        vorticity_stencil=VELOCITY_STENCIL,
                        upwinding=ONLY_SELF, multi_dimensional_stencil=False,
                        **weno_kw):
    """WENO-9 vorticity (velocity stencil) and WENO-5 vertical, divergence
    and kinetic-energy schemes with ``ONLY_SELF`` by default; ``order`` sets
    all four. ``weno_kw`` (e.g. ``smoothness_dtype``) goes to every WENO."""
    if order is None:
        vorticity_order = vorticity_order or 9
        vertical_order = vertical_order or 5
        divergence_order = divergence_order or 5
        kinetic_energy_gradient_order = kinetic_energy_gradient_order or 5
    else:
        vorticity_order = vorticity_order or order
        vertical_order = vertical_order or order
        divergence_order = divergence_order or order
        kinetic_energy_gradient_order = kinetic_energy_gradient_order or order
    return VectorInvariant(
        vorticity_scheme=WENO(vorticity_order, **weno_kw),
        vorticity_stencil=vorticity_stencil,
        vertical_advection_scheme=WENO(vertical_order, **weno_kw),
        divergence_scheme=WENO(divergence_order, **weno_kw),
        kinetic_energy_gradient_scheme=WENO(kinetic_energy_gradient_order,
                                            **weno_kw),
        upwinding=upwinding,
        multi_dimensional_stencil=multi_dimensional_stencil)
