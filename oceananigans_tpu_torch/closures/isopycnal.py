"""Isopycnal skew-symmetric (Gent-McWilliams + Redi) tracer diffusivities.

Counterpart of ``oceananigans_tpu/closures/isopycnal.py``. The small-slope
Griffies (1998) combined flux of a tracer c with Redi diffusivity κ_R and GM
(skew) diffusivity κ_GM:

    Fx = -κ_R ∂x c - (κ_R - κ_GM) Sx ∂z c
    Fy = -κ_R ∂y c - (κ_R - κ_GM) Sy ∂z c
    Fz = -(κ_R + κ_GM)(Sx ∂x c + Sy ∂y c) - κ_R |S|² ∂z c

with the isopycnal slopes Sx = -∂x b / ∂z b, Sy = -∂y b / ∂z b forced to 0
where ∂z b ≤ N²min, and the whole flux at each location multiplied by the
FluxTapering factor min(1, S_max²/|S|²). The tendency is -∇·F; momentum is
untouched.

``IsopycnalSkewSymmetricDiffusivity`` takes ``skew_flux_formulation="flux"``
(the GM part inside the rotated flux) or ``"advective"`` (the GM part as
eddy transport velocities that the models add to the tracers' advecting
velocities, ``eddy_velocities``). ``TriadIsopycnalSkewSymmetricDiffusivity``
is the Griffies et al. (1998) triad discretization: four triads per cell and
horizontal direction, those touching a peripheral face dropped (the
immersed grid's ``fluid_mask_at``, or the topology's boundary faces), each
tapered at its home cell, with the R₃₃ κ|S|² part handed to the vertically
implicit solve (``vertical_implicit_kappas``).

κ may be a constant, an array over the padded grid, or a callable κ(x, y, z)
of the padded cell-centre coordinates (broadcastable tensors of the grid's
dtype and device; the true (λ, φ) nodes on a shell grid).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.field import coordinates
from ..grids.topology import LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from ..operators.operators import (_delta_c, _metric, ddx, ddy, ddz, dx_c,
                                   dy_c, dz_c, ix_c, ix_f, iy_c, iy_f, iz_c,
                                   iz_f)
from ..operators.shifts import shift
from .scalar_diffusivity import _ClosureBase

LOC_FCF = ("f", "c", "f")
LOC_CFF = ("c", "f", "f")


def _is_array(k):
    return isinstance(k, torch.Tensor) or hasattr(k, "ndim")


def _coef(k):
    """A diffusivity as given: a callable or an array kept, else a float."""
    return k if callable(k) or _is_array(k) else float(k)


def _resolve_coef(grid, k):
    """A diffusivity as a float or a padded tensor: a callable κ(x, y, z) at
    the cell centres, an array in the grid's dtype and on its device."""
    if callable(k) and not isinstance(k, torch.Tensor):
        x, y, z = coordinates(grid, LOC_CCC)
        return torch.as_tensor(k(x, y, z), dtype=grid.dtype,
                               device=grid.device).broadcast_to(
                                   grid.padded_shape)
    if _is_array(k):
        return torch.as_tensor(np.asarray(k) if not isinstance(
            k, torch.Tensor) else k, dtype=grid.dtype, device=grid.device)
    return float(k)


def _resolve_max_slope(maximum_slope, slope_limiter):
    """``slope_limiter=FluxTapering(max_slope)`` or the plain
    ``maximum_slope``."""
    if slope_limiter is not None:
        maximum_slope = getattr(slope_limiter, "max_slope", slope_limiter)
    return float(maximum_slope)


def _fp_coef(k):
    return id(k) if callable(k) or _is_array(k) else k


def _taper(S2, smax):
    """FluxTapering's min(1, S_max²/|S|²)."""
    return torch.clamp_max(smax ** 2 / torch.clamp_min(S2, 1e-30), 1.0)


def _no_momentum(fields):
    z = torch.zeros_like(fields["u"])
    return dict(u=z, v=z, w=torch.zeros_like(fields["w"]))


def _divergence(grid, Fx, Fy, Fz, like):
    return -((_delta_c(grid, _metric(grid.Ax(LOC_FCC), like) * Fx, 0)
              + _delta_c(grid, _metric(grid.Ay(LOC_CFC), like) * Fy, 1)
              + _delta_c(grid, _metric(grid.Az(LOC_CCF), like) * Fz, 2))
             / _metric(grid.V(LOC_CCC), like))


class IsopycnalSkewSymmetricDiffusivity(_ClosureBase):
    def __init__(self, kappa_redi=0.0, kappa_gm=0.0, maximum_slope=1e-2,
                 slope_limiter=None, minimum_N2=1e-11, buoyancy=None,
                 skew_flux_formulation="flux"):
        if skew_flux_formulation not in ("flux", "advective"):
            raise ValueError(skew_flux_formulation)
        self.kappa_redi = _coef(kappa_redi)
        self.kappa_gm = _coef(kappa_gm)
        self.maximum_slope = _resolve_max_slope(maximum_slope, slope_limiter)
        self.minimum_N2 = float(minimum_N2)
        self.buoyancy = buoyancy
        self.skew_flux_formulation = skew_flux_formulation

    @property
    def has_eddy_velocities(self):
        return bool(self.skew_flux_formulation == "advective"
                    and (callable(self.kappa_gm) or _is_array(self.kappa_gm)
                         or self.kappa_gm))

    @property
    def kappa_skew(self):
        return self.kappa_gm

    def eddy_velocities(self, grid, fields):
        return _skew_eddy_velocities(grid, self, fields)

    def _fp(self):
        return ("IsopycnalSkewSymmetric", _fp_coef(self.kappa_redi),
                _fp_coef(self.kappa_gm), self.maximum_slope,
                self.minimum_N2, self.skew_flux_formulation)

    def compute_diffusivities(self, grid, fields, time):
        if self.buoyancy is None:
            raise ValueError("IsopycnalSkewSymmetricDiffusivity needs "
                             "buoyancy=…")
        b = self.buoyancy.buoyancy_ccc(grid, fields)
        bz_ccf = ddz(grid, b, LOC_CCF)
        bx_fcc = ddx(grid, b, LOC_FCC)
        by_cfc = ddy(grid, b, LOC_CFC)
        minb = self.minimum_N2

        def slope(bh, bz):
            # forced to 0 where ∂z b ≤ N²min: an unstable or degenerate
            # column takes a plain-diffusive flux
            return torch.where(bz > minb, -bh / torch.clamp_min(bz, minb),
                               0.0)

        def eps(Sx, Sy):
            return _taper(Sx * Sx + Sy * Sy, self.maximum_slope)

        bz_fcc = ix_f(grid, iz_c(grid, bz_ccf))
        by_fcc = ix_f(grid, iy_c(grid, by_cfc))
        Sx_fcc = slope(bx_fcc, bz_fcc)
        eps_fcc = eps(Sx_fcc, slope(by_fcc, bz_fcc))
        bz_cfc = iy_f(grid, iz_c(grid, bz_ccf))
        bx_cfc = iy_f(grid, ix_c(grid, bx_fcc))
        Sy_cfc = slope(by_cfc, bz_cfc)
        eps_cfc = eps(slope(bx_cfc, bz_cfc), Sy_cfc)
        bx_ccf = iz_f(grid, ix_c(grid, bx_fcc))
        by_ccf = iz_f(grid, iy_c(grid, by_cfc))
        Sx_ccf = slope(bx_ccf, bz_ccf)
        Sy_ccf = slope(by_ccf, bz_ccf)
        eps_ccf = eps(Sx_ccf, Sy_ccf)
        return {"Sx_fcc": Sx_fcc, "Sy_cfc": Sy_cfc,
                "Sx_ccf": Sx_ccf, "Sy_ccf": Sy_ccf,
                "eps_fcc": eps_fcc, "eps_cfc": eps_cfc,
                "eps_ccf": eps_ccf}

    def momentum_tendencies(self, grid, fields, aux):
        return _no_momentum(fields)

    def tracer_tendency(self, grid, name, fields, aux):
        if name == "e":
            return torch.zeros_like(fields[name])
        c = fields[name]
        kR = _resolve_coef(grid, self.kappa_redi)
        # the advective form carries the skew part in the eddy velocities
        kG = 0.0 if self.skew_flux_formulation == "advective" \
            else _resolve_coef(grid, self.kappa_gm)
        cx = ddx(grid, c, LOC_FCC)
        cy = ddy(grid, c, LOC_CFC)
        cz_ccf = ddz(grid, c, LOC_CCF)
        Fx = aux["eps_fcc"] * (-kR * cx - (kR - kG) * aux["Sx_fcc"]
                               * ix_f(grid, iz_c(grid, cz_ccf)))
        Fy = aux["eps_cfc"] * (-kR * cy - (kR - kG) * aux["Sy_cfc"]
                               * iy_f(grid, iz_c(grid, cz_ccf)))
        Sx, Sy = aux["Sx_ccf"], aux["Sy_ccf"]
        S2 = Sx * Sx + Sy * Sy
        Fz = aux["eps_ccf"] * (-(kR + kG)
                               * (Sx * iz_f(grid, ix_c(grid, cx))
                                  + Sy * iz_f(grid, iy_c(grid, cy)))
                               - kR * S2 * cz_ccf)
        return _divergence(grid, Fx, Fy, Fz, c)


class TriadIsopycnalSkewSymmetricDiffusivity(_ClosureBase):
    """The triad discretization (module docstring): each tracer cell owns
    four triads per horizontal direction, the slope
    Sʰᶻ(i, k) = -∂ₕb(i + {0, 1}) / ∂z b(k + {0, 1}); a face averages the four
    triads adjacent to it."""

    def __init__(self, kappa_skew=0.0, kappa_symmetric=0.0,
                 maximum_slope=1e-2, slope_limiter=None, buoyancy=None):
        self.kappa_skew = _coef(kappa_skew)
        self.kappa_symmetric = _coef(kappa_symmetric)
        self.maximum_slope = _resolve_max_slope(maximum_slope, slope_limiter)
        self.buoyancy = buoyancy

    def _fp(self):
        return ("TriadIsopycnalSkewSymmetric", _fp_coef(self.kappa_skew),
                _fp_coef(self.kappa_symmetric), self.maximum_slope)

    def _face_masks(self, grid, dtype):
        """The (x-face, y-face, z-face) masks of the faces that are not
        peripheral, padded tensors."""
        if hasattr(grid, "fluid_mask_at"):
            return (grid.fluid_mask_at(LOC_FCC, dtype),
                    grid.fluid_mask_at(LOC_CFC, dtype),
                    grid.fluid_mask_at(LOC_CCF, dtype))

        def face_mask(axis):
            m = np.zeros(grid.padded_shape, np.float64)
            sl = [slice(None)] * 3
            H, N = grid.H[axis], grid.N[axis]
            if grid.is_flat(axis):
                m[:] = 1.0
            elif grid.topology[axis] == "bounded":
                sl[axis] = slice(H + 1, H + N)
                m[tuple(sl)] = 1.0
            else:
                sl[axis] = slice(H, H + N + 1)
                m[tuple(sl)] = 1.0
            return torch.as_tensor(m, dtype=dtype, device=grid.device)

        return face_mask(0), face_mask(1), face_mask(2)

    def _triads(self, grid, fields):
        """Per-cell triad slopes S[h][s] and weights ek[h][s] = mask · taper
        (ccc) for h ∈ (x, y) and the corners s ∈ (pp, pm, mp, mm)."""
        b = self.buoyancy.buoyancy_ccc(grid, fields)
        bx = ddx(grid, b, LOC_FCC)
        by = ddy(grid, b, LOC_CFC)
        bz = ddz(grid, b, LOC_CCF)
        mx, my, mz = self._face_masks(grid, b.dtype)

        def S_of(bh, shift_h, shift_z, axis):
            bhs = shift(bh, +1, axis) if shift_h else bh
            bzs = shift(bz, +1, 2) if shift_z else bz
            bzp = torch.clamp_min(bzs, 0.0)
            pos = bzp > 0
            return torch.where(pos, -bhs / torch.where(pos, bzp, 1.0), 0.0)

        def mask_of(mh, shift_h, shift_z, axis):
            mhs = shift(mh, +1, axis) if shift_h else mh
            mzs = shift(mz, +1, 2) if shift_z else mz
            return mhs * mzs

        corners = {"pp": (True, True), "pm": (True, False),
                   "mp": (False, True), "mm": (False, False)}
        Sx = {s: S_of(bx, h, z, 0) for s, (h, z) in corners.items()}
        Sy = {s: S_of(by, h, z, 1) for s, (h, z) in corners.items()}
        # the taper at the triad's home cell from the mean slopes
        Sx_c = 0.25 * (Sx["pp"] + Sx["pm"] + Sx["mp"] + Sx["mm"])
        Sy_c = 0.25 * (Sy["pp"] + Sy["pm"] + Sy["mp"] + Sy["mm"])
        taper = _taper(Sx_c * Sx_c + Sy_c * Sy_c, self.maximum_slope)
        ekx = {s: mask_of(mx, h, z, 0) * taper
               for s, (h, z) in corners.items()}
        eky = {s: mask_of(my, h, z, 1) * taper
               for s, (h, z) in corners.items()}
        return dict(Sx=Sx, Sy=Sy, ekx=ekx, eky=eky, bx=bx, by=by, bz=bz)

    def compute_diffusivities(self, grid, fields, time):
        if self.buoyancy is None:
            raise ValueError("TriadIsopycnalSkewSymmetricDiffusivity needs "
                             "buoyancy=…")
        tr = self._triads(grid, fields)
        k_sym = _resolve_coef(grid, self.kappa_symmetric)
        # the implicit R₃₃ at (c, c, f): face k averages the lower triads of
        # cell k and the upper triads of cell k-1, κ at each triad's home
        low = sum(tr["ekx"][s] * tr["Sx"][s] ** 2
                  + tr["eky"][s] * tr["Sy"][s] ** 2 for s in ("mm", "pm"))
        up = sum(tr["ekx"][s] * tr["Sx"][s] ** 2
                 + tr["eky"][s] * tr["Sy"][s] ** 2 for s in ("mp", "pp"))
        tr["kappa_R33_ccf"] = 0.25 * (k_sym * low
                                      + shift(k_sym * up, -1, 2))
        return tr

    def momentum_tendencies(self, grid, fields, aux):
        return _no_momentum(fields)

    def tracer_tendency(self, grid, name, fields, aux):
        if name == "e":
            return torch.zeros_like(fields[name])
        c = fields[name]
        kS = _resolve_coef(grid, self.kappa_symmetric)
        kG = _resolve_coef(grid, self.kappa_skew)
        cx = ddx(grid, c, LOC_FCC)
        cy = ddy(grid, c, LOC_CFC)
        cz = ddz(grid, c, LOC_CCF)
        czp = shift(cz, +1, 2)
        Sx, Sy = aux["Sx"], aux["Sy"]
        ekx, eky = aux["ekx"], aux["eky"]
        # the skew part enters the horizontal flux with κ_sym − κ_skew and
        # the vertical with κ_sym + κ_skew; κ rides with each triad's home
        # cell
        k_h = kS - kG
        k_v = kS + kG

        def F_h(axis, ch, S, ek):
            diag = shift(kS * sum(ek[s] for s in ("pp", "pm")), -1, axis) \
                + kS * sum(ek[s] for s in ("mp", "mm"))
            t_plus = k_h * sum(ek[s] * S[s] * (czp if s[1] == "p" else cz)
                               for s in ("pp", "pm"))
            t_minus = k_h * sum(ek[s] * S[s] * (czp if s[1] == "p" else cz)
                                for s in ("mp", "mm"))
            off = shift(t_plus, -1, axis) + t_minus
            return -0.25 * (diag * ch + off)

        Fx = F_h(0, cx, Sx, ekx)
        Fy = F_h(1, cy, Sy, eky)

        def R3h(axis, ch, S, ek):
            chp = shift(ch, +1, axis)
            low = k_v * (ek["mm"] * S["mm"] * ch + ek["pm"] * S["pm"] * chp)
            upc = k_v * (ek["mp"] * S["mp"] * ch + ek["pp"] * S["pp"] * chp)
            return 0.25 * (low + shift(upc, -1, 2))

        Fz = -(R3h(0, cx, Sx, ekx) + R3h(1, cy, Sy, eky))
        return _divergence(grid, Fx, Fy, Fz, c)

    def vertical_implicit_kappas(self, grid, fields, aux):
        return {name: aux["kappa_R33_ccf"] for name in fields
                if name not in ("u", "v", "w", "eta", "e")}


def _skew_eddy_velocities(grid, closure, fields):
    """The eddy transport velocities of the advective skew form:

        uₑ = -δz(κ ϵSx)(f,c,c)/Δz,  vₑ = -δz(κ ϵSy)(c,f,c)/Δz,
        wₑ = [δx(Δy κ ϵSx) + δy(Δx κ ϵSy)]/Az at (c,c,f)

    with ϵSx the per-direction tapered slope at (f,c,f) / (c,f,f), forced to
    0 where ∂z b ≤ N²min and on peripheral nodes of an immersed grid."""
    b = closure.buoyancy.buoyancy_ccc(grid, fields)
    bx = ddx(grid, b, LOC_FCC)
    by = ddy(grid, b, LOC_CFC)
    bz = ddz(grid, b, LOC_CCF)
    minb = getattr(closure, "minimum_N2", 1e-11)
    bx_fcf = iz_f(grid, bx)
    bz_fcf = ix_f(grid, bz)
    Sx = torch.where(bz_fcf > minb, -bx_fcf / torch.clamp_min(bz_fcf, minb),
                     0.0)
    by_cff = iz_f(grid, by)
    bz_cff = iy_f(grid, bz)
    Sy = torch.where(bz_cff > minb, -by_cff / torch.clamp_min(bz_cff, minb),
                     0.0)
    smax = closure.maximum_slope
    Sx = Sx * _taper(Sx * Sx, smax)
    Sy = Sy * _taper(Sy * Sy, smax)
    if hasattr(grid, "fluid_mask_at"):
        Sx = Sx * grid.fluid_mask_at(LOC_FCF, b.dtype)
        Sy = Sy * grid.fluid_mask_at(LOC_CFF, b.dtype)
    kskew = _resolve_coef(grid, closure.kappa_skew)
    kSx = kskew * Sx
    kSy = kskew * Sy
    ue = -dz_c(grid, kSx) / _metric(grid.dz(LOC_FCC), b)
    ve = -dz_c(grid, kSy) / _metric(grid.dz(LOC_CFC), b)
    we = (dx_c(grid, _metric(grid.dy(LOC_FCF), b) * kSx)
          + dy_c(grid, _metric(grid.dx(LOC_CFF), b) * kSy)) \
        / _metric(grid.Az(LOC_CCF), b)
    return ue, ve, we


__all__ = ["IsopycnalSkewSymmetricDiffusivity",
           "TriadIsopycnalSkewSymmetricDiffusivity"]
