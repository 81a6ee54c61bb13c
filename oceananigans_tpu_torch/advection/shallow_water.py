"""Shallow-water tendencies of the conservative formulation.

Counterpart of ``conservative_tendencies`` and
``advective_tracer_tendencies`` of
``oceananigans_tpu/models/shallow_water.py``. They live below both the model
(``models/shallow_water.py``) and the fused stage's plain version
(``kernels/fused_shallow_water.py``), which both call them.
"""

from __future__ import annotations

import torch

from ..grids.topology import LOC_CCC, LOC_CFC, LOC_FCC
from ..operators.operators import (LOC_FFC, _delta_c, _delta_f, ddx, ddy,
                                   div_xy_ccc, dx_c, dy_c, ix_f, iy_f)
from .fluxes import _biased_by


def advective_tracer_tendencies(grid, scheme, uh, vh, tracer_names, fields):
    """Advective-form tracer tendencies, the conservative flux divergence
    plus the c·∇·U correction, shared by both formulations."""
    out = {}
    divU = (dx_c(grid, grid.dy(LOC_FCC) * uh)
            + dy_c(grid, grid.dx(LOC_CFC) * vh)) / grid.Az(LOC_CCC)
    for name in tracer_names:
        c = fields[name]
        ct_l, ct_r = scheme.biased_pair(grid, c, 0, 0)
        chat_x = torch.where(uh > 0, ct_l, ct_r)
        fx = dx_c(grid, grid.dy(LOC_FCC) * uh * chat_x)
        ct_l, ct_r = scheme.biased_pair(grid, c, 1, 0)
        chat_y = torch.where(vh > 0, ct_l, ct_r)
        fy = dy_c(grid, grid.dx(LOC_CFC) * vh * chat_y)
        divUc = (fx + fy) / grid.Az(LOC_CCC)
        out[name] = -divUc + c * divU
    return out


def conservative_tendencies(grid, scheme, g, coriolis, hB, tracer_names,
                            fields):
    """Conservative-formulation tendencies G(uh, vh, h, tracers) on the
    padded tensors (closure, forcing and boundary fluxes excluded)."""
    h = fields["h"]
    uh, vh = fields["uh"], fields["vh"]
    u = uh / ix_f(grid, h)
    v = vh / iy_f(grid, h)
    G = {}

    # momentum flux divergence of the transports: ∇·(𝐮 uh)
    ut = scheme.symmetric(grid, uh, 0, 1)            # fcc → ccc
    uhat = _biased_by(scheme, grid, u, 0, 1, ut)
    fx = _delta_f(grid, grid.dy(LOC_CCC) * ut * uhat, 0)
    vt = scheme.symmetric(grid, vh, 0, 0)            # cfc → ffc
    uhat = _biased_by(scheme, grid, u, 1, 0, vt)
    fy = _delta_c(grid, grid.dx(LOC_FFC) * vt * uhat, 1)
    div_mom_u = (fx + fy) / grid.Az(LOC_FCC)

    ut = scheme.symmetric(grid, uh, 1, 0)            # fcc → ffc
    vhat = _biased_by(scheme, grid, v, 0, 0, ut)
    fx = _delta_c(grid, grid.dy(LOC_FFC) * ut * vhat, 0)
    vt = scheme.symmetric(grid, vh, 1, 1)            # cfc → ccc
    vhat = _biased_by(scheme, grid, v, 1, 1, vt)
    fy = _delta_f(grid, grid.dx(LOC_CCC) * vt * vhat, 1)
    div_mom_v = (fx + fy) / grid.Az(LOC_CFC)

    Gu = (-div_mom_u
          - ddx(grid, 0.5 * g * h * h, LOC_FCC)
          - g * ix_f(grid, h) * ddx(grid, hB, LOC_FCC))
    Gv = (-div_mom_v
          - ddy(grid, 0.5 * g * h * h, LOC_CFC)
          - g * iy_f(grid, h) * ddy(grid, hB, LOC_CFC))
    if coriolis is not None:
        zero = torch.zeros_like(h)
        Gu = Gu - coriolis.x_f_cross_U(grid, uh, vh, zero)
        Gv = Gv - coriolis.y_f_cross_U(grid, uh, vh, zero)
    G["uh"], G["vh"] = Gu, Gv

    G["h"] = -div_xy_ccc(grid, uh, vh) * grid.V(LOC_CCC) / grid.Az(LOC_CCC)

    G.update(advective_tracer_tendencies(grid, scheme, uh, vh, tracer_names,
                                         fields))
    return G
