"""CATKE: a vertical diffusivity from a prognostic turbulent kinetic energy
``e``.

Counterpart of ``oceananigans_tpu/closures/catke.py``:

- κ_q = ℓ_q·w★ at (c, c, f), w★ = √max(e_min, e), with the per-quantity
  mixing lengths ℓ_q = min(H, max(σ_q(Ri)·ℓ★, ℓʰ_q)): ℓ★ the stable length
  min(Cˢ·depth, Cᵇ·height above the bottom, w★/√N²⁺), σ_q the stability
  function and ℓʰ_q the convective (Deardorff, with the sheared-convection
  factor) or entrainment length under a surface buoyancy flux Jᵇ
  (``CATKEMixingLength``, its 19 calibrated constants);
- the TKE equation (``CATKEEquation``): shear production, buoyancy flux and
  a dissipation e·w★/ℓᴰ treated implicitly as a linear damping;
- the substepped TKE (``step_turbulence``): the model advances ``e`` after
  each step in M = ceil(Δt/Δτ) AB2 substeps (one without
  ``tke_time_step``), each refreshing the diffusivities and solving the
  implicit operator with the dissipation, the negative buoyancy flux and
  the bottom flux as a damping.

``surface_buoyancy_flux`` is a scalar or a callable ``f(x, y, t, *values)``
of the surface-cell coordinates (broadcastable tensors of the grid's dtype
and device), the time and, with ``field_dependencies`` set on it, the named
fields' top cells; the model derives it from the T and S top fluxes under a
linear equation of state. The depths and masks are formed in float64 on the
host and held in the grid's dtype, and every clamp stays in the field's
dtype, so a float32 step stays float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.base import broadcastable_1d, horizontal_nodes
from ..grids.topology import LOC_CCC
from ..operators.operators import (_metric, ddz, iz_c, iz_f, ix_c, ix_f,
                                   iy_c, iy_f)
from ..operators.shifts import shift
from .scalar_diffusivity import _ClosureBase
from .vertical_diffusivities import _N2_ccf, _const, _shear2_ccf


def shear_production(grid, nu_ccf, u_old, u_new, v_old, v_new):
    """The 'approximately conservative' shear production at the centres:
    ℑx[ℑz(ℑx(ν)·∂z uⁿ·Δz·∂z u⁺, averaged with (u⁺, u⁺))/Δz] and the y
    analogue."""
    fcf = ("f", "c", "f")
    cff = ("c", "f", "f")

    def Px(un, up):
        nu_f = ix_f(grid, nu_ccf)
        dzn = ddz(grid, un, fcf)
        dzp = ddz(grid, up, fcf)
        return nu_f * dzn * _metric(grid.dz(fcf), un) * dzp

    def Py(vn, vp):
        nu_f = iy_f(grid, nu_ccf)
        dzn = ddz(grid, vn, cff)
        dzp = ddz(grid, vp, cff)
        return nu_f * dzn * _metric(grid.dz(cff), vn) * dzp

    Px_fcc = iz_c(grid, 0.5 * (Px(u_old, u_new) + Px(u_new, u_new))) \
        / _metric(grid.dz(("f", "c", "c")), u_old)
    Py_cfc = iz_c(grid, 0.5 * (Py(v_old, v_new) + Py(v_new, v_new))) \
        / _metric(grid.dz(("c", "f", "c")), v_old)
    return ix_c(grid, Px_fcc) + iy_c(grid, Py_cfc)


def surface_buoyancy_flux(Jb, grid, time, fields=None):
    """A surface buoyancy flux at the surface cells: 0.0 for None, a float
    for a scalar, or the callable evaluated on the padded (c, c) coordinates
    with the time and its ``field_dependencies``' top-cell planes (0.0 when
    the fields are not at hand)."""
    if Jb is None:
        return 0.0
    if not callable(Jb):
        return float(Jb)
    deps = tuple(getattr(Jb, "field_dependencies", ()))
    dep_args = ()
    if deps:
        if fields is None:
            return 0.0
        h, n = grid.H[2], grid.N[2]
        dep_args = tuple(fields[d][:, :, h + n - 1:h + n] for d in deps)
    x, y = horizontal_nodes(grid, ("c", "c", "c"))
    return Jb(x, y, float(time), *dep_args)


class CATKEMixingLength:
    """The 19 calibrated mixing-length constants."""

    def __init__(self, Cs=1.131, Cb=0.28, Csp=0.505, CRid=1.02, CRi0=0.254,
                 Chi_u=0.242, Clo_u=0.361, Cun_u=0.370, Cc_u=3.705, Ce_u=0.0,
                 Chi_c=0.098, Clo_c=0.369, Cun_c=0.572, Cc_c=4.793, Ce_c=0.112,
                 Chi_e=0.548, Clo_e=7.863, Cun_e=1.447, Cc_e=3.642, Ce_e=0.0):
        self.Cs, self.Cb, self.Csp = Cs, Cb, Csp
        self.CRid, self.CRi0 = CRid, CRi0
        self.u = (Cun_u, Clo_u, Chi_u, Cc_u, Ce_u)
        self.c = (Cun_c, Clo_c, Chi_c, Cc_c, Ce_c)
        self.e = (Cun_e, Clo_e, Chi_e, Cc_e, Ce_e)

    def _fp(self):
        return ("CATKEMixingLength", self.Cs, self.Cb, self.Csp, self.CRid,
                self.CRi0, self.u, self.c, self.e)


class CATKEEquation:
    """The dissipation and TKE-flux constants: CᵂwΔ and Cᵂu★ the surface
    convective and shear TKE flux coefficients, Cᵂϵ the near-bottom
    dissipative flux coefficient."""

    def __init__(self, Chi_D=0.579, Clo_D=1.604, Cun_D=0.923, Cc_D=3.254,
                 Ce_D=0.0, CwD=0.383, Cwu=3.179, Cweps=1.0):
        self.D = (Cun_D, Clo_D, Chi_D, Cc_D, Ce_D)
        self.CwD, self.Cwu, self.Cweps = CwD, Cwu, Cweps

    def _fp(self):
        return ("CATKEEquation",) + self.D + (self.CwD, self.Cwu,
                                              self.Cweps)


def _step(x, c, w):
    """Piecewise linear 0 → 1 over [c, c + w]."""
    return torch.clamp((x - c) / w, 0.0, 1.0)


class CATKEVerticalDiffusivity(_ClosureBase):
    required_tracers = ("e",)
    implicit_only_z = True

    # the model advances e in step_turbulence, not as an ordinary tracer
    substepped_tke = True
    substepped_tracers = ("e",)

    def __init__(self, mixing_length=None, tke_equation=None,
                 minimum_tke=1e-9, minimum_convective_buoyancy_flux=1e-11,
                 surface_buoyancy_flux=None, buoyancy=None,
                 tke_time_step=None):
        self.mixing_length = mixing_length or CATKEMixingLength()
        self.tke_equation = tke_equation or CATKEEquation()
        self.minimum_tke = float(minimum_tke)
        self.Jb_eps = float(minimum_convective_buoyancy_flux)
        self.surface_buoyancy_flux = surface_buoyancy_flux
        self.buoyancy = buoyancy
        # Δτ of the TKE substeps: M = ceil(Δt/Δτ); None is one substep
        self.tke_time_step = (None if tke_time_step is None
                              else float(tke_time_step))

    def substeps_for(self, dt):
        """The host-side substep count M for a step of ``dt``."""
        if self.tke_time_step is None:
            return 1
        return max(1, int(np.ceil(float(dt) / self.tke_time_step)))

    def _fp(self):
        return ("CATKE", self.mixing_length._fp(), self.tke_equation._fp(),
                self.minimum_tke, self.Jb_eps, self.tke_time_step,
                id(self.surface_buoyancy_flux)
                if callable(self.surface_buoyancy_flux)
                else self.surface_buoyancy_flux)

    # -- geometry ---------------------------------------------------------------

    def _depths_ccf(self, grid):
        """(depth below the surface, height above the bottom) at the z
        faces as broadcastable tensors of the grid's dtype, and the column
        depth H (a float)."""
        cache = grid.__dict__.setdefault("_catke_depths", {})
        if "depths" not in cache:
            h, n = grid.H[2], grid.N[2]
            zf = np.asarray(grid.coord_padded(2, "f"), np.float64)
            z_top, z_bot = zf[h + n], zf[h]
            kw = dict(dtype=grid.dtype, device=grid.device)
            cache["depths"] = (
                torch.as_tensor(broadcastable_1d(
                    np.maximum(z_top - zf, 0.0), 2), **kw),
                torch.as_tensor(broadcastable_1d(
                    np.maximum(zf - z_bot, 0.0), 2), **kw),
                float(z_top - z_bot))
        return cache["depths"]

    def _Jb(self, grid, time, fields=None):
        return surface_buoyancy_flux(self.surface_buoyancy_flux, grid, time,
                                     fields)

    # -- mixing lengths -----------------------------------------------------------

    def _lengths(self, grid, fields, time):
        ml = self.mixing_length
        e = torch.clamp_min(fields["e"], self.minimum_tke)
        wstar_ccc = torch.sqrt(e)
        wstar = iz_f(grid, wstar_ccc)
        wstar3 = iz_f(grid, wstar_ccc ** 3)
        N2 = _N2_ccf(grid, self.buoyancy, fields)
        S2 = _shear2_ccf(grid, fields)
        zero = _const(0.0, N2)
        Ri = torch.where(N2 == 0, zero,
                         N2 / torch.where(S2 == 0, _const(1e-30, S2), S2))

        depth, above, H = self._depths_ccf(grid)
        d = torch.minimum(ml.Cs * depth, ml.Cb * above)
        N2p = torch.clamp_min(N2, 0.0)
        ellN = torch.where(
            N2p > 0,
            wstar / torch.sqrt(torch.where(N2p > 0, N2p, _const(1.0, N2p))),
            _const(float("inf"), N2p))
        ell_stable = torch.minimum(d, ellN)

        Jb = self._Jb(grid, time, fields)
        Jbe = self.Jb_eps
        N2_above = shift(N2, +1, 2)
        hot = _const(Jb, N2) > Jbe
        convecting = hot & (N2 < 0)
        entraining = hot & (N2 > 0) & (N2_above < 0)
        Rif = depth * wstar * S2 / (Jb + Jbe)

        def length(consts):
            Cun, Clo, Chi, Cc, Ce = consts
            sigma = torch.where(Ri < 0, _const(Cun, Ri),
                                Clo + (Chi - Clo) * _step(Ri, ml.CRi0,
                                                          ml.CRid))
            lc = torch.clamp_min(
                (1.0 - ml.Csp * Rif) * Cc * wstar3 / (Jb + Jbe), 0.0)
            le = Ce * Jb / (wstar * N2 + Jbe)
            lh = torch.where(convecting, lc,
                             torch.where(entraining, le, zero))
            return torch.clamp_max(torch.maximum(sigma * ell_stable, lh), H)

        return (length(ml.u), length(ml.c), length(ml.e),
                length(self.tke_equation.D), wstar, N2)

    def compute_diffusivities(self, grid, fields, time):
        if self.buoyancy is None:
            raise ValueError("CATKEVerticalDiffusivity needs buoyancy=…")
        lu, lc, le, lD, wstar, N2 = self._lengths(grid, fields, time)
        return {"nu_z_ccf": lu * wstar, "kappa_z_ccf": lc * wstar,
                "kappa_e_ccf": le * wstar, "ell_D_ccf": lD, "N2_ccf": N2}

    # -- the TKE budget -------------------------------------------------------------

    def momentum_tendencies(self, grid, fields, aux):
        z = torch.zeros_like(fields["u"])
        return dict(u=z, v=z, w=torch.zeros_like(fields["w"]))

    def tracer_tendency(self, grid, name, fields, aux):
        if name != "e":
            return torch.zeros_like(fields[name])
        # shear production and buoyancy flux; the dissipation is implicit
        S2 = _shear2_ccf(grid, fields)
        P_shear = iz_c(grid, aux["nu_z_ccf"] * S2)
        P_buoy = iz_c(grid, -aux["kappa_z_ccf"] * aux["N2_ccf"])
        return P_shear + P_buoy

    def vertical_implicit_damping(self, grid, fields, aux):
        """λ = w★/ℓᴰ at the centres (ε = e·w★/ℓᴰ as a linear damping)."""
        e = torch.clamp_min(fields["e"], self.minimum_tke)
        ellD_c = iz_c(grid, aux["ell_D_ccf"])
        return {"e": torch.sqrt(e) / torch.clamp_min(ellD_c, 1e-10)}

    def clip_fields(self, fields):
        """Floor the TKE at 0 after the implicit step."""
        out = dict(fields)
        out["e"] = torch.clamp_min(fields["e"], 0.0)
        return out

    def vertical_implicit_kappas(self, grid, fields, aux):
        out = {"u": aux["nu_z_ccf"], "v": aux["nu_z_ccf"]}
        for name in fields:
            if name in ("u", "v", "w", "eta"):
                continue
            out[name] = (aux["kappa_e_ccf"] if name == "e"
                         else aux["kappa_z_ccf"])
        return out

    # -- the substepped TKE equation ---------------------------------------------------
    # M = ceil(Δt/Δτ) AB2 substeps, each refreshing κe and the implicit
    # operator Le = wb⁻/e − ω + δ(bottom)·Cᵂϵ√e/Δz, with the fast explicit
    # tendency P + wb⁺

    def _bottom_mask_ccc(self, grid, like):
        """1 at the bottommost active cell of each column (cached on the
        grid)."""
        cache = grid.__dict__.setdefault("_catke_depths", {})
        key = ("bottom", like.dtype)
        if key not in cache:
            mask = np.zeros(grid.padded_shape, bool)
            if hasattr(grid, "solid_ccc"):
                fluid = ~grid.solid_ccc
                below = np.ones_like(fluid)
                below[:, :, 1:] = ~fluid[:, :, :-1]
                mask = fluid & below
            else:
                mask[:, :, grid.H[2]] = True
            cache[key] = torch.as_tensor(mask, dtype=like.dtype,
                                         device=like.device)
        return cache[key]

    def step_turbulence(self, grid, fields_old, fields_new, slow_G, Gm, dt,
                        chi0, euler, M, time):
        """``step_tke`` under the model's dict interface: ({"e": e},
        {"e": the stored TKE tendency})."""
        e_new, Gm_e = self.step_tke(grid, fields_old, fields_new,
                                    slow_G["e"], Gm["e"], dt, chi0, euler,
                                    M, time)
        return {"e": e_new}, {"e": Gm_e}

    def step_tke(self, grid, fields_old, fields_new, slow_Ge, Gm_e, dt,
                 chi0, euler, M, time):
        """Advance ``e`` over one step of ``dt`` in ``M`` AB2 substeps.
        ``fields_new`` holds the updated (halo-filled) velocities,
        ``fields_old`` the state at the step's start, ``slow_Ge`` the
        advective (and boundary-flux) tendency, ``Gm_e`` the stored previous
        TKE tendency, ``euler`` whether the step is an Euler step. Returns
        (e, the new stored tendency)."""
        from ..models.nonhydrostatic import implicit_vertical_diffusion
        e = fields_new["e"]
        dtau = float(dt) / M
        bottom = self._bottom_mask_ccc(grid, e)
        dz_c = torch.as_tensor(_metric(grid.dz(LOC_CCC), e), dtype=e.dtype,
                               device=e.device).broadcast_to(e.shape)
        Cweps = self.tke_equation.Cweps
        for m in range(M):
            if M > 1:
                chi = -0.5 if m == 0 else chi0   # the first substep is Euler
            else:
                chi = -0.5 if euler else chi0
            fe = dict(fields_new)
            fe["e"] = e
            aux = self.compute_diffusivities(grid, fe, time)
            wb = iz_c(grid, -aux["kappa_z_ccf"] * aux["N2_ccf"])
            wb_plus = torch.clamp_min(wb, 0.0)
            wb_minus = torch.clamp_max(wb, 0.0)
            P = shear_production(grid, aux["nu_z_ccf"], fields_old["u"],
                                 fields_new["u"], fields_old["v"],
                                 fields_new["v"])
            fast_G = P + wb_plus
            total_G = slow_Ge + fast_G
            alpha = 1.5 + chi
            beta = 0.5 + chi
            e_star = e + dtau * (alpha * total_G - beta * Gm_e)
            Gm_e = total_G
            # the linear implicit operator -Le as a positive damping rate
            e_floor = torch.clamp_min(e, self.minimum_tke)
            wb_minus_e = wb_minus / e_floor * (e > self.minimum_tke)
            ellD_c = iz_c(grid, aux["ell_D_ccf"])
            omega = torch.sqrt(e_floor) / torch.clamp_min(ellD_c, 1e-10)
            wstar = torch.sqrt(torch.clamp_min(e, 0.0))
            lam = omega - wb_minus_e + bottom * Cweps * wstar / dz_c
            kz = aux["kappa_e_ccf"]
            if hasattr(grid, "fluid_mask"):
                kz = kz * grid.fluid_mask(("c", "c", "f"), e.dtype)
            e = implicit_vertical_diffusion(grid, e_star, kz, dtau,
                                            damping=lam)
            e = torch.clamp_min(e, 0.0)
        return e, Gm_e
