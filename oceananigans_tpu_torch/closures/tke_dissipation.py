"""k-ε: a vertical diffusivity from a prognostic turbulent kinetic energy
``e`` and its dissipation ``eps``.

Counterpart of ``oceananigans_tpu/closures/tke_dissipation.py``:

- κ_u = 𝕊u·e²/ε, κ_c = 𝕊c·e²/ε, κ_e = 𝕊u/Cσe·e²/ε and κ_ε = 𝕊u/Cσϵ·e²/ε at
  (c, c, f), with the dissipation floored by the stratified displacement,
  ε ≥ 𝕊u₀³ e^{3/2} / min(Lz, Cᴺ√(e/N²⁺));
- the stability functions of Umlauf and Burchard
  (``VariableStabilityFunctions``: 𝕊u and 𝕊c rational in the
  stratification and shear numbers αᴺ = τ²N², αᴹ = τ²S², τ = e/ε, clamped
  to the free-convection and shear-anisotropy bounds; or
  ``ConstantStabilityFunctions``);
- the (e, ε) equations (``TKEDissipationEquations``), substepped by the
  model after each step (``step_turbulence``) with the sinks and the
  negative buoyancy fluxes as implicit linear dampings, and the ε surface
  flux of a Charnock roughness from the friction velocity u★, which the
  model derives from the momentum top fluxes.

Every clamp stays in the field's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.base import horizontal_nodes, numpy_metric
from ..operators.operators import iz_c, iz_f
from .catke import shear_production
from .scalar_diffusivity import _ClosureBase
from .vertical_diffusivities import _N2_ccf, _const, _shear2_ccf


class VariableStabilityFunctions:
    """The second-order closure's stability functions (the Umlauf and
    Burchard coefficients)."""

    def __init__(self, Csigma_e=1.0, Csigma_eps=1.2,
                 Cu0=0.1067, Cu1=0.0173, Cu2=-0.0001205,
                 Cc0=0.1120, Cc1=0.003766, Cc2=0.0008871,
                 Cd0=1.0, Cd1=0.2398, Cd2=0.02872, Cd3=0.005154,
                 Cd4=0.006930, Cd5=-0.0003372, Su0=None):
        self.Csigma_e, self.Csigma_eps = Csigma_e, Csigma_eps
        self.Cu = (Cu0, Cu1, Cu2)
        self.Cc = (Cc0, Cc1, Cc2)
        self.Cd = (Cd0, Cd1, Cd2, Cd3, Cd4, Cd5)
        if Su0 is None:
            # the log-layer balance
            a = Cd5 - Cu2
            b = Cd2 - Cu0
            c = Cd0
            Su0 = (2 * a / (-b - np.sqrt(b * b - 4 * a * c))) ** 0.25
        self.Su0 = float(Su0)
        self.variable = True

    def _fp(self):
        return ("VariableStabilityFunctions", self.Csigma_e, self.Csigma_eps,
                self.Cu, self.Cc, self.Cd, self.Su0)

    def minimum_stratification_number(self, safety=0.73):
        """The free-convection bound on αᴺ."""
        m0, m1, _ = self.Cc
        d0, d1, d2, d3, d4, d5 = self.Cd
        a = d4 + m1
        b = d1 + m0
        c = d0
        return safety * (-b + np.sqrt(b * b - 4 * a * c)) / (2 * a)

    def maximum_shear_number(self, aN):
        """The shear-anisotropy bound on αᴹ."""
        n0, n1, _ = self.Cu
        d0, d1, d2, d3, d4, d5 = self.Cd
        e0 = d0 * n0
        e1 = d0 * n1 + d1 * n0
        e2 = d1 * n1 + d4 * n0
        e3 = d4 * n1
        e4 = d2 * n0
        e5 = d2 * n1 + d3 * n0
        e6 = d3 * n1
        num = e0 + e1 * aN + e2 * aN ** 2 + e3 * aN ** 3
        den = e4 + e5 * aN + e6 * aN ** 2
        return num / den

    def evaluate(self, aN, aM):
        """(𝕊u, 𝕊c) on clamped (αᴺ, αᴹ)."""
        Cu0, Cu1, Cu2 = self.Cu
        Cc0, Cc1, Cc2 = self.Cc
        d0, d1, d2, d3, d4, d5 = self.Cd
        den = (d0 + d1 * aN + d2 * aM + d3 * aN * aM + d4 * aN ** 2
               + d5 * aM ** 2)
        Su = (Cu0 + Cu1 * aN + Cu2 * aM) / den
        Sc = (Cc0 + Cc1 * aN + Cc2 * aM) / den
        return Su, Sc


class ConstantStabilityFunctions(VariableStabilityFunctions):
    """The constant-coefficient limit: 𝕊u = Cu₀, 𝕊c = Cc₀."""

    def __init__(self, Csigma_e=1.0, Csigma_eps=1.2, Cu0=0.53, Cc0=0.53,
                 Su0=0.53):
        self.Csigma_e, self.Csigma_eps = Csigma_e, Csigma_eps
        self.Cu = (Cu0, 0.0, 0.0)
        self.Cc = (Cc0, 0.0, 0.0)
        self.Cd = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        self.Su0 = float(Su0)
        self.variable = False

    def _fp(self):
        return ("ConstantStabilityFunctions", self.Csigma_e, self.Csigma_eps,
                self.Cu[0], self.Cc[0], self.Su0)

    def evaluate(self, aN, aM):
        return self.Cu[0], self.Cc[0]


class TKEDissipationEquations:
    """The e and ε equations' coefficients, the surface-flux constants
    (Cᵂu★ and CᵂwΔ, 0 by default), the Charnock parameter Cᵂα, g and the
    minimum roughness length."""

    def __init__(self, Ceps_eps=1.92, CP_eps=1.44, Cb_eps_plus=-0.65,
                 Cb_eps_minus=-0.65, Cwu=0.0, CwD=0.0, Cw_alpha=0.11,
                 gravitational_acceleration=9.8065,
                 minimum_roughness_length=1e-4):
        self.Ceps_eps = Ceps_eps
        self.CP_eps = CP_eps
        self.Cb_plus = Cb_eps_plus
        self.Cb_minus = Cb_eps_minus
        self.Cwu = Cwu
        self.CwD = CwD
        self.Cw_alpha = Cw_alpha
        self.g = gravitational_acceleration
        self.min_roughness = minimum_roughness_length

    def _fp(self):
        return ("TKEDissipationEquations", self.Ceps_eps, self.CP_eps,
                self.Cb_plus, self.Cb_minus, self.Cwu, self.CwD,
                self.Cw_alpha, self.g, self.min_roughness)


class TKEDissipationVerticalDiffusivity(_ClosureBase):
    required_tracers = ("e", "eps")
    implicit_only_z = True

    # the model advances e and ε in step_turbulence
    substepped_tke = True
    substepped_tracers = ("e", "eps")

    def __init__(self, stability_functions=None,
                 tke_dissipation_equations=None, minimum_tke=1e-6, CN=0.75,
                 minimum_buoyancy_frequency=1e-14, maximum_viscosity=np.inf,
                 maximum_diffusivity=np.inf, buoyancy=None,
                 negative_tke_damping_time_scale=60.0,
                 tke_dissipation_time_step=None, friction_velocity=None):
        self.stability_functions = (stability_functions
                                    or VariableStabilityFunctions())
        self.equations = (tke_dissipation_equations
                          or TKEDissipationEquations())
        self.minimum_tke = float(minimum_tke)
        self.CN = float(CN)
        self.N2_min = float(minimum_buoyancy_frequency)
        self.max_visc = float(maximum_viscosity)
        self.max_diff = float(maximum_diffusivity)
        self.buoyancy = buoyancy
        # the rate that damps a negative e back toward 0
        self.omega_neg = 1.0 / float(negative_tke_damping_time_scale)
        # Δτ of the (e, ε) substeps: M = ceil(Δt/Δτ)
        self.tke_time_step = (None if tke_dissipation_time_step is None
                              else float(tke_dissipation_time_step))
        # u★ for the Charnock roughness: a scalar or f(x, y, t)
        self.friction_velocity = friction_velocity

    def substeps_for(self, dt):
        if self.tke_time_step is None:
            return 1
        return max(1, int(np.ceil(float(dt) / self.tke_time_step)))

    def _fp(self):
        return ("TKEDissipation", self.stability_functions._fp(),
                self.equations._fp(), self.minimum_tke, self.CN,
                self.N2_min, self.max_visc, self.max_diff,
                self.omega_neg, self.tke_time_step)

    # -- the clamped state --------------------------------------------------------

    def _estar(self, fields):
        return torch.clamp_min(fields["e"], self.minimum_tke)

    def _epsstar(self, grid, fields, N2_ccf):
        """ε floored by the stratified-displacement minimum."""
        e = self._estar(fields)
        N2p = iz_c(grid, torch.clamp_min(N2_ccf, self.N2_min))
        ell_st = self.CN * torch.sqrt(e / N2p)
        ell_min = torch.clamp_max(ell_st, abs(grid.extent[2]))
        Su0 = self.stability_functions.Su0
        eps_min = torch.clamp_min(Su0 ** 3 * e ** 1.5 / ell_min, 1e-12)
        return torch.maximum(fields["eps"], eps_min)

    # -- diffusivities ------------------------------------------------------------

    def compute_diffusivities(self, grid, fields, time):
        if self.buoyancy is None:
            raise ValueError("TKEDissipationVerticalDiffusivity needs "
                             "buoyancy=…")
        sf = self.stability_functions
        N2 = _N2_ccf(grid, self.buoyancy, fields)
        S2 = _shear2_ccf(grid, fields)
        e = self._estar(fields)
        eps = self._epsstar(grid, fields, N2)
        tau2_f = iz_f(grid, (e / eps) ** 2)
        aN = tau2_f * N2
        aM = tau2_f * S2
        if sf.variable:
            aN = torch.clamp(aN, float(sf.minimum_stratification_number()),
                             1e10)
            aM = torch.minimum(torch.clamp_min(aM, 0.0),
                               sf.maximum_shear_number(aN))
        Su, Sc = sf.evaluate(aN, aM)
        e2_over_eps = iz_f(grid, e * e) / iz_f(grid, eps)
        ku = torch.clamp_max(Su * e2_over_eps, self.max_visc)
        kc = torch.clamp_max(Sc * e2_over_eps, self.max_diff)
        ke = torch.clamp_max(Su / sf.Csigma_e * e2_over_eps, self.max_diff)
        keps = torch.clamp_max(Su / sf.Csigma_eps * e2_over_eps,
                               self.max_diff)
        return {"nu_ccf": ku, "kappa_ccf": kc, "nu_e_ccf": ke,
                "nu_eps_ccf": keps, "N2_ccf": N2}

    # -- tendencies ---------------------------------------------------------------

    def momentum_tendencies(self, grid, fields, aux):
        z = torch.zeros_like(fields["u"])
        return dict(u=z, v=z, w=torch.zeros_like(fields["w"]))

    def _Cb(self, grid, N2, like):
        eq = self.equations
        return torch.where(iz_c(grid, N2) >= 0, _const(eq.Cb_plus, like),
                           _const(eq.Cb_minus, like))

    def tracer_tendency(self, grid, name, fields, aux):
        if name not in ("e", "eps"):
            return torch.zeros_like(fields[name])
        eq = self.equations
        e = self._estar(fields)
        eps = self._epsstar(grid, fields, aux["N2_ccf"])
        S2 = _shear2_ccf(grid, fields)
        N2 = aux["N2_ccf"]
        P = iz_c(grid, aux["nu_ccf"] * S2)
        wb = iz_c(grid, -aux["kappa_ccf"] * N2)
        wb_plus = torch.clamp_min(wb, 0.0)
        if name == "e":
            # the sink -ε and wb⁻ are implicit
            return P + wb_plus
        Cb_wb_plus = torch.clamp_min(self._Cb(grid, N2, wb) * wb, 0.0)
        omega_eps = eps / e
        return omega_eps * (eq.CP_eps * P + Cb_wb_plus)

    def vertical_implicit_damping(self, grid, fields, aux):
        eq = self.equations
        e = self._estar(fields)
        eps = self._epsstar(grid, fields, aux["N2_ccf"])
        omega = eps / e
        wb = iz_c(grid, -aux["kappa_ccf"] * aux["N2_ccf"])
        wb_minus_e = torch.clamp_max(wb, 0.0) / e
        Cb_wb_minus_e = torch.clamp_max(
            self._Cb(grid, aux["N2_ccf"], wb) * wb, 0.0) / e
        return {"e": omega - wb_minus_e,
                "eps": eq.Ceps_eps * omega - Cb_wb_minus_e}

    def clip_fields(self, fields):
        out = dict(fields)
        out["e"] = torch.clamp_min(fields["e"], self.minimum_tke)
        out["eps"] = torch.clamp_min(fields["eps"], 1e-12)
        return out

    # -- the substepped (e, ε) equations --------------------------------------------

    def _friction_velocity(self, grid, time, like):
        ustar = self.friction_velocity
        if callable(ustar):
            x1, x2 = horizontal_nodes(grid, ("c", "c", "c"), like.dtype,
                                      like.device)
            ustar = ustar(x1, x2, float(time))
        return ustar

    def step_turbulence(self, grid, fields_old, fields_new, slow_G, Gm, dt,
                        chi0, euler, M, time):
        """Advance (e, ε) over one step of ``dt`` in ``M`` AB2 substeps,
        each refreshing the diffusivities and stability functions; the
        sinks (ω e, Cᵋϵ ωϵ ε) and the negative buoyancy fluxes are implicit
        linear dampings of the vertical solves. ``fields_new`` holds the
        updated (halo-filled) velocities. Returns ({e, eps}, {e, eps}: the
        stored tendencies)."""
        from ..models.nonhydrostatic import implicit_vertical_diffusion
        eq = self.equations
        e = fields_new["e"]
        eps = fields_new["eps"]
        dtau = float(dt) / M
        Gm_e, Gm_eps = Gm["e"], Gm["eps"]
        # the ε surface flux −(𝕊u₀⁴/σϵ)·e★²/(Δz_top/2 + ℓᵣ), Charnock
        # roughness ℓᵣ = max(ℓmin, Cᵂα u★²/g), as a top-cell source
        h, n = grid.H[2], grid.N[2]
        kt = h + n - 1
        dz_top = float(np.broadcast_to(
            np.asarray(numpy_metric(grid, "dz", ("c", "c", "c")), float),
            grid.padded_shape)[0, 0, kt])
        top = torch.zeros(grid.padded_shape, dtype=e.dtype, device=e.device)
        top[:, :, kt] = 1
        ustar = self._friction_velocity(grid, time, e)
        if ustar is None:
            ell_r = eq.min_roughness
        elif isinstance(ustar, torch.Tensor):
            ell_r = torch.clamp_min(eq.Cw_alpha * torch.square(ustar) / eq.g,
                                    eq.min_roughness)
        else:
            ell_r = max(eq.min_roughness,
                        eq.Cw_alpha * float(ustar) ** 2 / eq.g)
        sf = self.stability_functions
        eps_srf_coeff = (sf.Su0 ** 4 / sf.Csigma_eps
                         / (0.5 * dz_top + ell_r) / dz_top)
        for m in range(M):
            if M > 1:
                chi = -0.5 if m == 0 else chi0   # the first substep is Euler
            else:
                chi = -0.5 if euler else chi0
            fe = dict(fields_new)
            fe["e"] = e
            fe["eps"] = eps
            aux = self.compute_diffusivities(grid, fe, time)
            N2 = aux["N2_ccf"]
            estar = self._estar(fe)
            epsstar = self._epsstar(grid, fe, N2)
            # destruction rates: ω★ = ε★/e★ for e (the negative-TKE rate
            # where e < 0), ωϵ = ε/e★ for ε
            omega_star = epsstar / estar
            omega_e = torch.where(e < 0, _const(self.omega_neg, e),
                                  omega_star)
            omega_eps = eps / estar
            wb = iz_c(grid, -aux["kappa_ccf"] * N2)
            wb_plus = torch.clamp_min(wb, 0.0)
            wb_minus = torch.clamp_max(wb, 0.0)
            wb_minus_e = wb_minus / estar * (e > self.minimum_tke)
            Cb = self._Cb(grid, N2, wb)
            Cb_wb_plus = torch.clamp_min(Cb * wb, 0.0)
            Cb_wb_minus = torch.clamp_max(Cb * wb, 0.0)
            P = shear_production(grid, aux["nu_ccf"],
                                 fields_old["u"], fields_new["u"],
                                 fields_old["v"], fields_new["v"])
            fast_Ge = P + wb_plus
            fast_Geps = omega_eps * (eq.CP_eps * P + Cb_wb_plus) \
                + top * eps_srf_coeff * torch.square(estar)
            total_Ge = slow_G["e"] + fast_Ge
            total_Geps = slow_G["eps"] + fast_Geps
            alpha = 1.5 + chi
            beta = 0.5 + chi
            e_star_rhs = e + dtau * (alpha * total_Ge - beta * Gm_e)
            eps_star_rhs = eps + dtau * (alpha * total_Geps - beta * Gm_eps)
            Gm_e, Gm_eps = total_Ge, total_Geps
            # the implicit linear operators as positive damping rates
            lam_e = omega_e - wb_minus_e
            lam_eps = eq.Ceps_eps * omega_eps - Cb_wb_minus / estar
            ke = aux["nu_e_ccf"]
            keps = aux["nu_eps_ccf"]
            if hasattr(grid, "fluid_mask"):
                m_ccf = grid.fluid_mask(("c", "c", "f"), e.dtype)
                ke = ke * m_ccf
                keps = keps * m_ccf
            e = implicit_vertical_diffusion(grid, e_star_rhs, ke, dtau,
                                            damping=lam_e)
            eps = implicit_vertical_diffusion(grid, eps_star_rhs, keps, dtau,
                                              damping=lam_eps)
            e = torch.clamp_min(e, self.minimum_tke)
            eps = torch.clamp_min(eps, 1e-12)
        return {"e": e, "eps": eps}, {"e": Gm_e, "eps": Gm_eps}

    def vertical_implicit_kappas(self, grid, fields, aux):
        out = {"u": aux["nu_ccf"], "v": aux["nu_ccf"]}
        for name in fields:
            if name in ("u", "v", "w", "eta"):
                continue
            if name == "e":
                out[name] = aux["nu_e_ccf"]
            elif name == "eps":
                out[name] = aux["nu_eps_ccf"]
            else:
                out[name] = aux["kappa_ccf"]
        return out
