"""ScalarDiffusivity: constant viscosity and tracer diffusivities.

Counterpart of ``oceananigans_tpu/closures/scalar_diffusivity.py``, cut to
the explicit time discretization with constant coefficients: ν a scalar, κ a
scalar or a per-tracer dict of scalars, in the isotropic (full strain
tensor), horizontal or vertical formulation. The vertically implicit form
and function, array or discrete-form coefficients raise.

Closure protocol (consumed by the model), on padded tensors:

    compute_diffusivities(grid, fields, time)  -> aux dict (empty here)
    momentum_tendencies(grid, fields, aux)     -> {u, v, w} contributions
    tracer_tendency(grid, name, fields, aux)   -> the tracer's contribution
"""

from __future__ import annotations

import numpy as np

from .diffusion_operators import (div_2nu_strain_u, div_2nu_strain_v,
                                  div_2nu_strain_w, div_kappa_grad)

ISO = "iso"
HORIZONTAL = "horizontal"
VERTICAL = "vertical"

CLOSURES_ITEM = "ROADMAP.md queue 1 item 9 (the rest of NH physics)"


def _scalar(k, what):
    if callable(k) or not np.isscalar(k):
        raise NotImplementedError(
            f"{what} {k!r}: only constant scalar coefficients are ported: "
            f"{CLOSURES_ITEM}")
    return float(k)


class ScalarDiffusivity:
    required_halo = 1

    def __init__(self, nu=0.0, kappa=0.0, formulation=ISO,
                 time_discretization="explicit"):
        if formulation not in (ISO, HORIZONTAL, VERTICAL):
            raise ValueError(formulation)
        td = getattr(time_discretization, "name", time_discretization)
        if td != "explicit":
            raise NotImplementedError(
                f"time discretization {td!r}: only the explicit form is "
                f"ported: {CLOSURES_ITEM}")
        self.nu = _scalar(nu, "viscosity")
        if isinstance(kappa, dict):
            self.kappa = {n: _scalar(k, f"diffusivity of {n}")
                          for n, k in kappa.items()}
        else:
            self.kappa = _scalar(kappa, "diffusivity")
        self.formulation = formulation
        self.time_discretization = td

    def _fp(self):
        k = (tuple(sorted(self.kappa.items())) if isinstance(self.kappa, dict)
             else self.kappa)
        return ("ScalarDiffusivity", self.nu, k, self.formulation,
                self.time_discretization)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def __repr__(self):
        return (f"ScalarDiffusivity(nu={self.nu}, kappa={self.kappa}, "
                f"formulation={self.formulation!r})")

    @property
    def _axes(self):
        return {ISO: (0, 1, 2), HORIZONTAL: (0, 1), VERTICAL: (2,)}[
            self.formulation]

    def kappa_of(self, name):
        if isinstance(self.kappa, dict):
            return self.kappa.get(name, 0.0)
        return self.kappa

    def compute_diffusivities(self, grid, fields, time):
        return {}

    def momentum_tendencies(self, grid, fields, aux):
        u, v, w = fields["u"], fields["v"], fields["w"]
        nu, axes = self.nu, self._axes
        if self.formulation == ISO:
            return dict(u=div_2nu_strain_u(grid, u, v, w, nu, nu, nu, axes),
                        v=div_2nu_strain_v(grid, u, v, w, nu, nu, nu, axes),
                        w=div_2nu_strain_w(grid, u, v, w, nu, nu, nu, axes))
        # horizontal / vertical formulations use the Laplacian form
        return dict(u=div_kappa_grad(grid, u, ("f", "c", "c"), nu, axes),
                    v=div_kappa_grad(grid, v, ("c", "f", "c"), nu, axes),
                    w=div_kappa_grad(grid, w, ("c", "c", "f"), nu, axes))

    def tracer_tendency(self, grid, name, fields, aux):
        return div_kappa_grad(grid, fields[name], ("c", "c", "c"),
                              self.kappa_of(name), self._axes)

