"""Tracer-variance budget diagnostic.

Counterpart of ``oceananigans_tpu/simulation/variance_dissipation.py``, in
plain PyTorch, as the JAX package computes it in XLA. For a tracer c with
the advective tendency G_adv = -∇·(𝐮c):

    χ_adv  = -2 Σ c G_adv V    (the scheme's implied dissipation; zero for
                                a conservative centred scheme),
    χ_diff = 2 κ Σ |∇c|² V     (the closure's, when ``kappa`` is given),

and the variance Σ c² V, over the interior cells.
"""

from __future__ import annotations

import torch

from ..advection.fluxes import div_Uc
from ..grids.topology import LOC_CCC
from ..operators.operators import ddx, ddy, ddz


class VarianceDissipation:
    """A diagnostic returning the variance-budget terms as floats::

        vd = VarianceDissipation(model, "c")
        sim.add_callback(lambda s: print(vd(s.model)), IterationInterval(10))
    """

    def __init__(self, model, tracer, kappa=None):
        self.model = model
        self.tracer = tracer
        self.kappa = kappa

    def __call__(self, model=None):
        model = model or self.model
        grid = model.grid
        # the halos filled on copies: the model's tensors stay as they are
        fields = model._fill_all({n: a.clone() for n, a in
                                  model.state["fields"].items()})
        c = fields[self.tracer]
        u, v = fields["u"], fields["v"]
        w = fields.get("w", torch.zeros_like(u))
        Gadv = -div_Uc(grid, model_tracer_scheme(model), u, v, w, c)
        ii = grid.interior_slices
        V = torch.as_tensor(grid.V(LOC_CCC), dtype=c.dtype,
                            device=c.device).broadcast_to(c.shape)[ii]
        out = {"chi_advection": -2 * ((c * Gadv)[ii] * V).sum(),
               "variance": ((c * c)[ii] * V).sum()}
        if self.kappa is not None:
            gx = ddx(grid, c, ("f", "c", "c"))
            gy = ddy(grid, c, ("c", "f", "c"))
            gz = ddz(grid, c, ("c", "c", "f"))
            if grid.H[2] == 0:
                # the z-compact layout has no halo to mirror: the bottom
                # face of a no-flux tracer carries no gradient
                gz[..., 0] = 0.0
            grad2 = (gx * gx + gy * gy + gz * gz)[ii]
            out["chi_diffusion"] = 2 * self.kappa * (grad2 * V).sum()
        return {k: float(v) for k, v in out.items()}


def model_tracer_scheme(model):
    return getattr(model, "tracer_advection", None) or model.advection
