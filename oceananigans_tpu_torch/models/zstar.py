"""The z* (free-surface-following) vertical coordinate.

Counterpart of ``oceananigans_tpu/models/zstar.py``. The static grid never
changes; ``ZStarGrid`` wraps it with the scale factors σ(x, y, t) = (H + η)/H
of each horizontal staggering (σᶜᶜ from the cell-centre column depth, σᶠᶜ
and σᶜᶠ from the face columns' depths, which on an immersed grid are the
fluid depths), so that Δz, Ax, Ay and V are the moving ones and every
operator reads them unchanged. Land columns keep σ = 1. The grid-motion term
∂t_σ enters the diagnosed w and the upwinded vector-invariant divergence
flux (``HydrostaticFreeSurfaceModel``).
"""

from __future__ import annotations

import torch

from ..operators.operators import interp


class ZStarGrid:
    """A moving-grid view of ``base``: Δz scaled by σ.

    ``sigmas``: a padded (npx, npy, 1) σ at the cell centres (σ at the faces
    is then interpolated), or a dict {("c", "c"): σᶜᶜ, ("f", "c"): σᶠᶜ,
    ("c", "f"): σᶜᶠ} of the per-staggering factors."""

    def __init__(self, base, sigmas):
        self.base = base
        if not isinstance(sigmas, dict):
            sigmas = {("c", "c"): sigmas}
        self.sigmas = sigmas

    def _sigma_at(self, loc):
        key = (loc[0], loc[1])
        s = self.sigmas.get(key)
        if s is not None:
            return s
        if loc[0] == "f":
            s = self.sigmas.get(("f", "c"))
            if s is None:
                s = interp(self.base, self.sigmas[("c", "c")], 0, "f")
            if loc[1] == "f":
                s = interp(self.base, s, 1, "f")
            return s
        s = self.sigmas.get(("c", "f"))
        if s is None:
            s = interp(self.base, self.sigmas[("c", "c")], 1, "f")
        return s

    def dz(self, loc):
        return self.base.dz(loc) * self._sigma_at(loc)

    def dx(self, loc):
        return self.base.dx(loc)

    def dy(self, loc):
        return self.base.dy(loc)

    def Ax(self, loc):
        return self.base.dy(loc) * self.dz(loc)

    def Ay(self, loc):
        return self.base.dx(loc) * self.dz(loc)

    def Az(self, loc):
        return self.base.Az(loc)

    def V(self, loc):
        return self.base.Az(loc) * self.dz(loc)

    def __getattr__(self, name):
        if name.startswith("__") or name == "base":
            raise AttributeError(name)
        return getattr(self.base, name)


def sigma_from_eta(eta, depth, wet=None):
    """σ = (H + η)/H at one staggering from that staggering's depth (a float
    or a per-column tensor); columns where ``wet`` is False keep σ = 1."""
    s = 1.0 + eta / depth
    if wet is None:
        return s
    return torch.where(wet, s, torch.ones_like(s))


__all__ = ["ZStarGrid", "sigma_from_eta"]
