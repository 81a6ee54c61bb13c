"""Smagorinsky LES closures.

Counterpart of ``oceananigans_tpu/closures/smagorinsky.py``: the eddy
viscosity νₑ = c² Δ² √(2ΣᵢⱼΣᵢⱼ) at cell centres with the filter width
Δ = V^(1/3) and κₑ = νₑ/Pr per tracer; Lilly's buoyancy modification (the
factor max(0, 1 - N²/(Pr |Σ|²)) under the root); the dynamic coefficient
c² = max(⟨LᵢⱼMᵢⱼ⟩, min)/⟨MᵢⱼMᵢⱼ⟩ from the Germano identity, averaged over
directions of the interior or along trajectories (Lagrangian averaging,
with the JLM and JMM state fields the model carries and advances at the end
of each step).

As in the JAX package, νₑ is formed over the whole padded tensor from the
filled velocity halos and its halos are not filled: the interpolations to
the stress locations read its first halo ring, and its outermost ring holds
what the zero-filled shifts leave. ``SmagorinskyLilly(...)`` fixes
``buoyancy_modified`` when it is built (from the ``buoyancy`` it is given),
so in a buoyant model that hands its buoyancy over later it stays plain
Smagorinsky, while ``Smagorinsky(coefficient=LillyCoefficient())`` is
modified: the JAX package does both.

Every constant stays a Python float, so a float32 step stays float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..operators.operators import (LOC_CCC, ddx, ddy, ddz, interp, ix_c,
                                   iy_c, iz_c)
from ..operators.shifts import shift
from .diffusion_operators import (Sxy_ffc, Sxz_fcf, Syz_cff,
                                  div_2nu_strain_u, div_2nu_strain_v,
                                  div_2nu_strain_w, div_kappa_grad)
from .scalar_diffusivity import _ClosureBase


def _sq_interp_ccc(grid, a, from_loc):
    """a² interpolated from its location to the cell centres."""
    out = a * a
    for axis in range(3):
        if from_loc[axis] == "f":
            out = interp(grid, out, axis, "c")
    return out


def strain_rate_sq_ccc(grid, u, v, w):
    """2 ΣᵢⱼΣᵢⱼ at the cell centres."""
    diag = (ddx(grid, u, LOC_CCC) ** 2 + ddy(grid, v, LOC_CCC) ** 2
            + ddz(grid, w, LOC_CCC) ** 2)
    off = (_sq_interp_ccc(grid, Sxy_ffc(grid, u, v), ("f", "f", "c"))
           + _sq_interp_ccc(grid, Sxz_fcf(grid, u, w), ("f", "c", "f"))
           + _sq_interp_ccc(grid, Syz_cff(grid, v, w), ("c", "f", "f")))
    return 2 * (diag + 2 * off)


def filter_width_sq(grid):
    """Δ² = V^(2/3): a Python float on a regular grid, else a tensor of the
    grid's dtype."""
    V = grid.V(LOC_CCC)
    if np.isscalar(V):
        return float(V) ** (2.0 / 3.0)
    return torch.as_tensor(np.asarray(V) ** (2.0 / 3.0), dtype=grid.dtype,
                           device=grid.device)


def _eddy_momentum(grid, fields, nu):
    """The strain-form momentum tendencies with a cell-centred νₑ."""
    u, v, w = fields["u"], fields["v"], fields["w"]
    nu_ffc = interp(grid, interp(grid, nu, 0, "f"), 1, "f")
    nu_fcf = interp(grid, interp(grid, nu, 0, "f"), 2, "f")
    nu_cff = interp(grid, interp(grid, nu, 1, "f"), 2, "f")
    return dict(
        u=div_2nu_strain_u(grid, u, v, w, nu, nu_ffc, nu_fcf),
        v=div_2nu_strain_v(grid, u, v, w, nu, nu_ffc, nu_cff),
        w=div_2nu_strain_w(grid, u, v, w, nu, nu_fcf, nu_cff))


def _ratio(JLM, JMM, minimum_numerator):
    """max(JLM, min)/JMM where JMM > 0, else 0."""
    return torch.where(
        JMM > 0,
        torch.clamp(JLM, min=minimum_numerator)
        / torch.where(JMM == 0, 1.0, JMM), 0.0)


class Smagorinsky(_ClosureBase):
    """Constant-coefficient Smagorinsky (c = 0.16, Lilly's value, by
    default), optionally buoyancy-modified, or with a
    :class:`DynamicCoefficient`."""

    def __init__(self, coefficient=0.16, Pr=1.0, buoyancy_modified=False,
                 buoyancy=None):
        if isinstance(coefficient, LillyCoefficient):
            Pr = coefficient.Pr
            buoyancy_modified = True
            coefficient = coefficient.smagorinsky
        self.C = (coefficient if hasattr(coefficient, "_fp")
                  else float(coefficient))
        self.Pr = Pr
        self.buoyancy_modified = buoyancy_modified
        self.buoyancy = buoyancy

    def _fp(self):
        pr = (tuple(sorted(self.Pr.items())) if isinstance(self.Pr, dict)
              else self.Pr)
        c = self.C._fp() if hasattr(self.C, "_fp") else self.C
        return ("Smagorinsky", c, pr, self.buoyancy_modified)

    def __repr__(self):
        return (f"Smagorinsky(coefficient={self.C!r}, Pr={self.Pr!r}, "
                f"buoyancy_modified={self.buoyancy_modified})")

    def _pr_for(self, name):
        if isinstance(self.Pr, dict):
            return self.Pr.get(name, 1.0)
        return self.Pr

    def compute_diffusivities(self, grid, fields, time):
        u, v, w = fields["u"], fields["v"], fields["w"]
        S2 = strain_rate_sq_ccc(grid, u, v, w)
        if self.buoyancy_modified and self.buoyancy is not None:
            # Lilly's stability correction ς² = max(0, 1 - N²/(Pr |Σ|²))
            b = self.buoyancy.buoyancy_ccc(grid, fields)
            N2 = iz_c(grid, ddz(grid, b, ("c", "c", "f")))
            pr = self._pr_for("b")
            zeta2 = torch.clamp(
                1.0 - N2 / (pr * torch.clamp(S2, min=1e-20)), min=0.0)
            S2 = S2 * zeta2
        if isinstance(self.C, DynamicCoefficient):
            if self.C.lagrangian:
                # c² from the trajectory-relaxed JLM/JMM state fields (zero
                # until their first update)
                csq = _ratio(fields["JLM"], fields["JMM"],
                             self.C.minimum_numerator)
            else:
                csq = dynamic_coefficient_sq(grid, u, v, w, self.C.averaging,
                                             self.C.minimum_numerator)
        else:
            csq = self.C ** 2
        nu_e = csq * filter_width_sq(grid) * torch.sqrt(S2)
        return {"nu_e": nu_e}

    @property
    def state_fields(self):
        """The closure's state carried by the model: JLM and JMM under
        Lagrangian averaging."""
        if isinstance(self.C, DynamicCoefficient) and self.C.lagrangian:
            return ("JLM", "JMM")
        return ()

    def update_state_fields(self, grid, fields, dt, iteration):
        """The Lagrangian relaxation of the Germano contractions (Bou-Zeid
        et al. 2005): J ← ε·new + (1 - ε)·J(X - UΔt) with ε = (Δt/T)/(1 +
        Δt/T), T = 1.5Δ/(JLM·JMM)^(1/8); the first step (``iteration`` 0)
        starts from the interior means. ``fields`` have filled halos."""
        u, v, w = fields["u"], fields["v"], fields["w"]
        LM, MM = germano_LM_MM(grid, u, v, w)
        jmin = self.C.minimum_numerator
        JLMp, JMMp = fields["JLM"], fields["JMM"]
        ii = grid.interior_slices
        if iteration == 0:
            initL = torch.clamp(LM[ii].mean(), min=jmin)
            initM = MM[ii].mean()
            return {"JLM": initL.broadcast_to(LM.shape).clone(),
                    "JMM": initM.broadcast_to(MM.shape).clone()}
        itpL = _upstream_interp(grid, JLMp, u, v, w, dt)
        itpM = _upstream_interp(grid, JMMp, u, v, w, dt)
        delta = math.sqrt(filter_width_sq(grid))
        prod = torch.clamp(JLMp, min=jmin) * torch.clamp(JMMp, min=0.0)
        T = 1.5 * delta / torch.clamp(prod, min=1e-38) ** 0.125
        tau = dt / T
        eps = tau / (1.0 + tau)
        newM = eps * MM + (1 - eps) * itpM
        newL = torch.clamp(
            eps * LM + (1 - eps) * torch.clamp(itpL, min=jmin), min=jmin)
        return {"JLM": newL, "JMM": newM}

    def momentum_tendencies(self, grid, fields, aux):
        return _eddy_momentum(grid, fields, aux["nu_e"])

    def tracer_tendency(self, grid, name, fields, aux):
        kappa = aux["nu_e"] / self._pr_for(name)
        return div_kappa_grad(grid, fields[name], LOC_CCC, kappa)


class LillyCoefficient:
    """The coefficient that selects Lilly's buoyancy-modified Smagorinsky:
    ``Smagorinsky(coefficient=LillyCoefficient(smagorinsky=0.16,
    Pr=1.0))``."""

    def __init__(self, smagorinsky=0.16, Pr=1.0):
        self.smagorinsky = smagorinsky
        self.Pr = Pr


def SmagorinskyLilly(coefficient=0.16, Pr=1.0, buoyancy=None):
    """Smagorinsky, buoyancy-modified when ``buoyancy`` is given here (the
    flag is fixed now; see the module docstring)."""
    return Smagorinsky(coefficient=coefficient, Pr=Pr,
                       buoyancy_modified=buoyancy is not None,
                       buoyancy=buoyancy)


# -- the dynamic (Germano-Lilly) coefficient ----------------------------------

class DynamicCoefficient:
    """The Germano-identity coefficient c² = max(⟨LᵢⱼMᵢⱼ⟩, min)/⟨MᵢⱼMᵢⱼ⟩,
    averaged over the interior along ``averaging`` (0-based axes) or along
    trajectories (:class:`LagrangianAveraging`)."""

    def __init__(self, averaging=(0, 1, 2), minimum_numerator=1e-32):
        if isinstance(averaging, LagrangianAveraging) \
                or averaging is LagrangianAveraging:
            self.averaging = LagrangianAveraging()
        else:
            self.averaging = (tuple(averaging) if np.iterable(averaging)
                              else (int(averaging),))
        self.minimum_numerator = float(minimum_numerator)

    @property
    def lagrangian(self):
        return isinstance(self.averaging, LagrangianAveraging)

    def _fp(self):
        avg = "lagrangian" if self.lagrangian else self.averaging
        return ("DynamicCoefficient", avg, self.minimum_numerator)

    def __repr__(self):
        return (f"DynamicCoefficient(averaging={self.averaging!r}, "
                f"minimum_numerator={self.minimum_numerator})")


def test_filter(grid, a):
    """The 7-point box test filter of scale 2Δ: (6a + Σ₆ neighbours)/12."""
    out = 6.0 * a
    for axis in range(3):
        if grid.is_flat(axis):
            out = out + 2.0 * a
        else:
            out = out + shift(a, +1, axis) + shift(a, -1, axis)
    return out / 12.0


# not a test of pytest's, whatever its name says
test_filter.__test__ = False


def _strain_components_ccc(grid, u, v, w):
    """The six strain components at the cell centres."""
    S11 = ddx(grid, u, LOC_CCC)
    S22 = ddy(grid, v, LOC_CCC)
    S33 = ddz(grid, w, LOC_CCC)
    S12 = ix_c(grid, iy_c(grid, Sxy_ffc(grid, u, v)))
    S13 = ix_c(grid, iz_c(grid, Sxz_fcf(grid, u, w)))
    S23 = iy_c(grid, iz_c(grid, Syz_cff(grid, v, w)))
    return S11, S22, S33, S12, S13, S23


def germano_LM_MM(grid, u, v, w):
    """The padded Germano contractions (LM, MM) at the cell centres, with
    the test-to-grid filter ratio squared ᾱ²β = 4."""
    fu, fv, fw = (test_filter(grid, u), test_filter(grid, v),
                  test_filter(grid, w))
    sigma = torch.sqrt(strain_rate_sq_ccc(grid, u, v, w) / 2)
    sigma_f = torch.sqrt(strain_rate_sq_ccc(grid, fu, fv, fw) / 2)
    S = _strain_components_ccc(grid, u, v, w)
    Sf = _strain_components_ccc(grid, fu, fv, fw)
    d2 = filter_width_sq(grid)

    # the resolved (Leonard) stress at the cell centres
    uc, vc, wc = ix_c(grid, u), iy_c(grid, v), iz_c(grid, w)
    fuc, fvc, fwc = ix_c(grid, fu), iy_c(grid, fv), iz_c(grid, fw)
    L = [test_filter(grid, ix_c(grid, u * u)) - ix_c(grid, fu * fu),
         test_filter(grid, iy_c(grid, v * v)) - iy_c(grid, fv * fv),
         test_filter(grid, iz_c(grid, w * w)) - iz_c(grid, fw * fw),
         test_filter(grid, uc * vc) - fuc * fvc,
         test_filter(grid, uc * wc) - fuc * fwc,
         test_filter(grid, vc * wc) - fvc * fwc]
    M = [2 * d2 * (test_filter(grid, sigma * s) - 4.0 * sigma_f * sf)
         for s, sf in zip(S, Sf)]

    weights = (1, 1, 1, 2, 2, 2)
    LM = MM = 0
    for wgt, l, m in zip(weights, L, M):
        LM = LM + wgt * l * m
        MM = MM + wgt * m * m
    return LM, MM


def _edge_pad(grid, a):
    """An interior-shaped tensor extended to the padded shape by repeating
    its edge values."""
    out = a
    for ax in range(3):
        h, n = grid.H[ax], grid.N[ax]
        idx = (torch.arange(grid.padded_shape[ax], device=a.device) - h
               ).clamp(0, n - 1)
        out = out.index_select(ax, idx)
    return out


def dynamic_coefficient_sq(grid, u, v, w, averaging, minimum_numerator):
    """The padded c² = ⟨LM⟩/⟨MM⟩ with the means over the interior along
    ``averaging``, edge-padded back."""
    LM, MM = germano_LM_MM(grid, u, v, w)
    ii = grid.interior_slices
    JLM = LM[ii].mean(dim=tuple(averaging), keepdim=True)
    JMM = MM[ii].mean(dim=tuple(averaging), keepdim=True)
    csq_int = _ratio(JLM, JMM, minimum_numerator).broadcast_to(LM[ii].shape)
    return _edge_pad(grid, csq_int)


def DynamicSmagorinsky(averaging=(0, 1, 2), Pr=1.0, minimum_numerator=1e-32):
    """Smagorinsky with a :class:`DynamicCoefficient`; ``averaging`` is a
    tuple of axes or :class:`LagrangianAveraging`."""
    return Smagorinsky(coefficient=DynamicCoefficient(
        averaging=averaging, minimum_numerator=minimum_numerator), Pr=Pr)


# -- the Lagrangian-averaged dynamic coefficient ------------------------------

class LagrangianAveraging:
    """Selects averaging along trajectories for :class:`DynamicCoefficient`
    (Bou-Zeid, Meneveau and Parlange 2005)."""

    def __repr__(self):
        return "LagrangianAveraging()"


def _upstream_interp(grid, J, u, v, w, dt):
    """``J`` linearly interpolated at the upstream point X - U·Δt, one axis
    after another, the displacement clamped to one cell."""
    vels = (ix_c(grid, u), iy_c(grid, v), iz_c(grid, w))
    spac = (grid.dx(LOC_CCC), grid.dy(LOC_CCC), grid.dz(LOC_CCC))
    out = J
    for ax in range(3):
        if grid.is_flat(ax):
            continue
        alpha = torch.clamp(vels[ax] * dt / spac[ax], -1.0, 1.0)
        a = alpha.abs()
        upw = torch.where(alpha > 0, shift(out, -1, ax), shift(out, +1, ax))
        out = (1 - a) * out + a * upw
    return out
