"""Vertical diffusivities from the local stratification and shear, and the
two-dimensional Leith viscosity.

Counterpart of ``oceananigans_tpu/closures/vertical_diffusivities.py``:

- ``ConvectiveAdjustmentVerticalDiffusivity``: a large κ and ν where the
  column is statically unstable (N² < 0), the background values elsewhere;
- ``RiBasedVerticalDiffusivity``: κ and ν a smooth decreasing function of
  the Richardson number Ri = N²/S², a convective boost where N² < 0 and,
  with a surface buoyancy flux, penetrative entrainment below a convecting
  cell;
- ``TwoDimensionalLeith``: the enstrophy-cascade viscosity
  νₑ = (C Δ)³ |∇ζ|, horizontal.

The first two give a κ at (c, c, f) that the vertically implicit solve
consumes (their explicit tendencies are zero), and need a buoyancy (the
model hands over its own).
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.base import numpy_metric
from ..grids.topology import LOC_CCC
from ..operators.operators import (ddx, ddy, ddz, ix_c, iy_c, zeta3_ffc)
from .diffusion_operators import div_kappa_grad
from .scalar_diffusivity import _ClosureBase


def _N2_ccf(grid, buoyancy, fields):
    b = buoyancy.buoyancy_ccc(grid, fields)
    return ddz(grid, b, ("c", "c", "f"))


def _shear2_ccf(grid, fields):
    """(∂z u)² + (∂z v)² at (c, c, f)."""
    du = ddz(grid, fields["u"], ("f", "c", "f"))
    dv = ddz(grid, fields["v"], ("c", "f", "f"))
    return ix_c(grid, du * du) + iy_c(grid, dv * dv)


def _const(value, like):
    """A 0-d tensor of ``like``'s dtype and device."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _zeros_momentum(fields):
    z = torch.zeros_like(fields["u"])
    return dict(u=z, v=z, w=torch.zeros_like(fields["w"]))


class ConvectiveAdjustmentVerticalDiffusivity(_ClosureBase):
    implicit_only_z = True

    def __init__(self, convective_kappa_z=1.0, convective_nu_z=None,
                 background_kappa_z=0.0, background_nu_z=0.0, buoyancy=None):
        self.convective_kappa_z = float(convective_kappa_z)
        self.convective_nu_z = float(convective_nu_z
                                     if convective_nu_z is not None
                                     else convective_kappa_z)
        self.background_kappa_z = float(background_kappa_z)
        self.background_nu_z = float(background_nu_z)
        self.buoyancy = buoyancy

    def _fp(self):
        return ("ConvectiveAdjustment", self.convective_kappa_z,
                self.convective_nu_z, self.background_kappa_z,
                self.background_nu_z)

    def compute_diffusivities(self, grid, fields, time):
        if self.buoyancy is None:
            raise ValueError("ConvectiveAdjustmentVerticalDiffusivity needs "
                             "buoyancy=<buoyancy model>")
        N2 = _N2_ccf(grid, self.buoyancy, fields)
        unstable = N2 < 0
        kz = torch.where(unstable, _const(self.convective_kappa_z, N2),
                         _const(self.background_kappa_z, N2))
        nz = torch.where(unstable, _const(self.convective_nu_z, N2),
                         _const(self.background_nu_z, N2))
        return {"kappa_z_ccf": kz, "nu_z_ccf": nz}

    def momentum_tendencies(self, grid, fields, aux):
        # the vertical diffusion is all implicit
        return _zeros_momentum(fields)

    def tracer_tendency(self, grid, name, fields, aux):
        return torch.zeros_like(fields[name])

    def vertical_implicit_kappas(self, grid, fields, aux):
        out = {"u": aux["nu_z_ccf"], "v": aux["nu_z_ccf"]}
        for name in fields:
            if name not in ("u", "v", "w", "eta"):
                out[name] = aux["kappa_z_ccf"]
        return out


class RiBasedVerticalDiffusivity(_ClosureBase):
    """κ = κ₀·step(Ri) + κᶜᵃ·(N² < 0) (+ the entrainment κ), ν = ν₀·step(Ri),
    with step(Ri) = (1 - tanh((Ri - Ri₀)/δ))/2."""

    implicit_only_z = True

    def __init__(self, nu_0=0.7, kappa_0=0.5, Ri_0=0.1, Ri_delta=0.4,
                 convective_kappa=2.8, Cen=0.1, minimum_entrainment=1e-10,
                 surface_buoyancy_flux=None, buoyancy=None):
        self.nu_0 = float(nu_0)
        self.kappa_0 = float(kappa_0)
        self.Ri_0 = float(Ri_0)
        self.Ri_delta = float(Ri_delta)
        self.convective_kappa = float(convective_kappa)
        # penetrative entrainment κᵉⁿ = Cᵉⁿ·Jᵇ/N² where N² exceeds its
        # minimum below a convecting cell under a destabilizing surface flux
        self.Cen = float(Cen)
        self.minimum_entrainment = float(minimum_entrainment)
        self.surface_buoyancy_flux = surface_buoyancy_flux
        self.buoyancy = buoyancy

    def _fp(self):
        return ("RiBased", self.nu_0, self.kappa_0, self.Ri_0,
                self.Ri_delta, self.convective_kappa, self.Cen,
                self.minimum_entrainment,
                id(self.surface_buoyancy_flux)
                if callable(self.surface_buoyancy_flux)
                else self.surface_buoyancy_flux)

    def _step(self, Ri):
        return 0.5 * (1 - torch.tanh((Ri - self.Ri_0) / self.Ri_delta))

    def _Jb(self, grid, time, fields=None):
        from .catke import surface_buoyancy_flux
        return surface_buoyancy_flux(self.surface_buoyancy_flux, grid, time,
                                     fields)

    def compute_diffusivities(self, grid, fields, time):
        if self.buoyancy is None:
            raise ValueError("RiBasedVerticalDiffusivity needs buoyancy")
        N2 = _N2_ccf(grid, self.buoyancy, fields)
        S2 = _shear2_ccf(grid, fields)
        Ri = N2 / torch.clamp_min(S2, 1e-16)
        conv = torch.where(N2 < 0, _const(self.convective_kappa, N2),
                           _const(0.0, N2))
        kz = self.kappa_0 * self._step(Ri) + conv
        if self.Cen and self.surface_buoyancy_flux is not None:
            Jb = self._Jb(grid, time, fields)
            # N² at the face above (a roll along z, as the JAX closure does)
            N2_above = torch.roll(N2, -1, dims=2)
            entraining = (N2 > self.minimum_entrainment) & (N2_above < 0)
            k_en = torch.where(entraining & (_const(Jb, N2) > 0),
                               self.Cen * Jb / torch.clamp_min(N2, 1e-30),
                               _const(0.0, N2))
            kz = kz + k_en
        nz = self.nu_0 * self._step(Ri)
        return {"kappa_z_ccf": kz, "nu_z_ccf": nz}

    momentum_tendencies = \
        ConvectiveAdjustmentVerticalDiffusivity.momentum_tendencies
    tracer_tendency = ConvectiveAdjustmentVerticalDiffusivity.tracer_tendency
    vertical_implicit_kappas = \
        ConvectiveAdjustmentVerticalDiffusivity.vertical_implicit_kappas


class TwoDimensionalLeith(_ClosureBase):
    """Leith's enstrophy-based horizontal viscosity νₑ = (C Δ)³ |∇ζ|, with
    the tracers diffused by ``C_redi``·νₑ."""

    def __init__(self, C=0.3, C_redi=1.0):
        self.C = float(C)
        self.C_redi = float(C_redi)

    def _fp(self):
        return ("Leith2D", self.C, self.C_redi)

    def compute_diffusivities(self, grid, fields, time):
        zeta = zeta3_ffc(grid, fields["u"], fields["v"])
        dzx = ddx(grid, zeta, ("c", "f", "c"))
        dzy = ddy(grid, zeta, ("f", "c", "c"))
        grad2 = iy_c(grid, dzx * dzx) + ix_c(grid, dzy * dzy)
        # Δ² in float64 on the host, as the JAX closure forms it
        delta2 = (np.asarray(numpy_metric(grid, "dx", LOC_CCC))
                  * np.asarray(numpy_metric(grid, "dy", LOC_CCC)))
        delta3 = delta2 ** 1.5
        if delta3.ndim:
            delta3 = torch.as_tensor(delta3, dtype=grad2.dtype,
                                     device=grad2.device)
        else:
            delta3 = float(delta3)
        nu = (self.C ** 3) * delta3 * torch.sqrt(grad2)
        return {"nu_e": nu}

    def momentum_tendencies(self, grid, fields, aux):
        nu = aux["nu_e"]
        return dict(
            u=div_kappa_grad(grid, fields["u"], ("f", "c", "c"), nu, (0, 1)),
            v=div_kappa_grad(grid, fields["v"], ("c", "f", "c"), nu, (0, 1)),
            w=torch.zeros_like(fields["w"]))

    def tracer_tendency(self, grid, name, fields, aux):
        return div_kappa_grad(grid, fields[name], LOC_CCC,
                              self.C_redi * aux["nu_e"], (0, 1))
