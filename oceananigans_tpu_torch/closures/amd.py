"""Anisotropic Minimum Dissipation (AMD) LES closure.

Counterpart of ``oceananigans_tpu/closures/amd.py`` (Rozema et al.'s AMD as
used by Vreugdenhil and Taylor 2018):

    νₑ = max(0, -Σᵢⱼₖ Ĉ Δₖ² (∂ₖûᵢ)(∂ₖûⱼ) Σ̂ᵢⱼ / Σₗₘ (∂ₗûₘ)²) + ν_b
    κₑ = max(0, -Σᵢₖ  Ĉ Δₖ² (∂ₖûᵢ)(∂ₖĉ) ∂ᵢĉ / Σₗ (∂ₗĉ)²)   + κ_b

with every hatted quantity at the cell centres, Ĉ = 1/12 by default, and
with ``Cb`` the buoyancy term -Cb Σₖ Δₖ² (∂ₖw)(∂ₖb) in νₑ's numerator. As in
the JAX package, νₑ and κₑ are formed over the whole padded tensor and
their halos are filled only when the model was given conditions for them
(``boundary_conditions={"nu_e": ..., "kappa_e": {tracer: ...}}``).

The squared spacings are Python floats on a regular grid and the
denominators' ε = 1e-20 is added as a Python float, so a float32 step stays
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..operators.operators import LOC_CCC, ddx, ddy, ddz, interp
from .diffusion_operators import div_kappa_grad
from .scalar_diffusivity import _ClosureBase
from .smagorinsky import _eddy_momentum

EPS = 1e-20


def _grad_ccc(grid, q, loc):
    """(∂x q, ∂y q, ∂z q), each interpolated to the cell centres."""
    out = []
    for axis, dd in enumerate((ddx, ddy, ddz)):
        gloc = list(loc)
        gloc[axis] = "f" if loc[axis] == "c" else "c"
        g = dd(grid, q, tuple(gloc))
        for ax2 in range(3):
            if gloc[ax2] == "f":
                g = interp(grid, g, ax2, "c")
        out.append(g)
    return out


def _delta_sq(grid):
    """The squared spacing along each axis at the cell centres (0 on a flat
    axis): Python floats on a regular grid, else tensors of its dtype."""
    out = []
    for axis, d in enumerate((grid.dx, grid.dy, grid.dz)):
        if grid.is_flat(axis):
            out.append(0.0)
            continue
        s = d(LOC_CCC)
        out.append(float(s) * float(s) if np.isscalar(s) else torch.as_tensor(
            np.asarray(s) ** 2, dtype=grid.dtype, device=grid.device))
    return out


def _skip(d2):
    return isinstance(d2, float) and d2 == 0.0


class AnisotropicMinimumDissipation(_ClosureBase):
    def __init__(self, C=1.0 / 12.0, Cb=0.0, background_nu=1e-6,
                 background_kappa=1e-7, buoyancy=None):
        self.C = float(C)
        self.Cb = float(Cb)
        self.background_nu = float(background_nu)
        self.background_kappa = float(background_kappa)
        # the model hands its buoyancy over when this is None
        self.buoyancy = buoyancy

    def _fp(self):
        return ("AMD", self.C, self.Cb, self.background_nu,
                self.background_kappa)

    def __repr__(self):
        return (f"AnisotropicMinimumDissipation(C={self.C}, Cb={self.Cb}, "
                f"background_nu={self.background_nu}, background_kappa="
                f"{self.background_kappa})")

    def compute_diffusivities(self, grid, fields, time):
        u, v, w = fields["u"], fields["v"], fields["w"]
        du = _grad_ccc(grid, u, ("f", "c", "c"))
        dv = _grad_ccc(grid, v, ("c", "f", "c"))
        dw = _grad_ccc(grid, w, ("c", "c", "f"))
        grads = (du, dv, dw)  # grads[i][k] = ∂ₖ uᵢ at ccc
        d2 = _delta_sq(grid)

        denom = None
        for i in range(3):
            for k in range(3):
                t = grads[i][k] * grads[i][k]
                denom = t if denom is None else denom + t

        num = None
        for i in range(3):
            for j in range(3):
                Sij = 0.5 * (grads[i][j] + grads[j][i])
                for k in range(3):
                    if _skip(d2[k]):
                        continue
                    t = d2[k] * grads[i][k] * grads[j][k] * Sij
                    num = t if num is None else num + t

        if self.Cb and self.buoyancy is not None:
            b = self.buoyancy.buoyancy_ccc(grid, fields)
            db = _grad_ccc(grid, b, ("c", "c", "c"))
            num_b = None
            for k in range(3):
                if _skip(d2[k]):
                    continue
                t = d2[k] * dw[k] * db[k]
                num_b = t if num_b is None else num_b + t
            if num_b is not None:
                num = num - self.Cb * num_b
        nu_e = torch.clamp(-self.C * num / (denom + EPS), min=0.0) \
            + self.background_nu
        nu_e = self._fill_diffusivity(grid, nu_e, "nu_e")
        return {"nu_e": nu_e, "_grads": grads, "_d2": d2}

    def momentum_tendencies(self, grid, fields, aux):
        return _eddy_momentum(grid, fields, aux["nu_e"])

    def tracer_tendency(self, grid, name, fields, aux):
        grads = aux["_grads"]
        d2 = aux["_d2"]
        dc = _grad_ccc(grid, fields[name], ("c", "c", "c"))
        denom = dc[0] ** 2 + dc[1] ** 2 + dc[2] ** 2
        num = None
        for i in range(3):
            for k in range(3):
                if _skip(d2[k]):
                    continue
                t = d2[k] * grads[i][k] * dc[k] * dc[i]
                num = t if num is None else num + t
        kappa_e = torch.clamp(-self.C * num / (denom + EPS), min=0.0) \
            + self.background_kappa
        kappa_e = self._fill_diffusivity(grid, kappa_e, "kappa_e", name)
        return div_kappa_grad(grid, fields[name], LOC_CCC, kappa_e)
