"""Time steppers: 3rd-order Runge-Kutta (Le & Moin 1991) and
quasi-Adams-Bashforth-2.

Counterpart of ``oceananigans_tpu/timesteppers/steppers.py``: RK3 with γ¹=8/15, γ²=5/12, γ³=3/4, ζ²=-17/60, ζ³=-5/12, substep
Uᵐ⁺¹ = Uᵐ + Δt(γᵐGᵐ + ζᵐGᵐ⁻¹) with a pressure correction per substep; QAB2
with Uⁿ⁺¹ = Uⁿ + Δt[(3/2+χ)Gⁿ - (1/2+χ)Gⁿ⁻¹], χ = 0.1 by default and
χ = -1/2 (forward Euler) on the first step and after Δt changes; the split
RK3 of Knoth and Wensch (2014), each stage an Euler step of Δt/βᵐ from the
step's start, β = (3, 2, 1).
"""

from __future__ import annotations

import torch

RK3_GAMMAS = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RK3_ZETAS = (0.0, -17.0 / 60.0, -5.0 / 12.0)


def stage_update(grid, names, fields, G, Gm, gamma_dt, zeta_dt):
    """One RK3 substep on padded fields: ``new = q + γΔt·G + ζΔt·G⁻`` at
    the interiors (ζΔt·G⁻ only when ``Gm`` is given). ``G`` and ``Gm`` stack
    the interiors of the fields in the order of ``names``. Returns
    ``{name: new padded tensor}``, halos left unwritten."""
    ints = grid.interior_slices
    new = {}
    for k, name in enumerate(names):
        inc = float(gamma_dt) * G[k]
        if Gm is not None:
            inc = inc + float(zeta_dt) * Gm[k]
        new[name] = torch.empty_like(fields[name])
        new[name][ints] = fields[name][ints] + inc
    return new


class RungeKutta3TimeStepper:
    name = "RungeKutta3"


class QuasiAdamsBashforth2TimeStepper:
    name = "QuasiAdamsBashforth2"

    def __init__(self, chi=0.1):
        self.chi = float(chi)

    def coefficients(self, euler):
        """(3/2 + χ, 1/2 + χ, whether G⁻ enters) for one step; ``euler``
        takes χ = -1/2 and drops G⁻, as the JAX step's ``not_euler`` factor
        does."""
        chi = -0.5 if euler else self.chi
        return 1.5 + chi, 0.5 + chi, 0.0 if euler else 1.0


class SplitRungeKutta3TimeStepper:
    """Each stage an Euler step of Δt/β from the state at the step's start,
    β = (3, 2, 1)."""

    name = "SplitRungeKutta3"
    n_stages = 3
    betas = (3.0, 2.0, 1.0)


def Clock(time=0.0, iteration=0, last_dt=None, dtype=None):
    """A model clock, the ``state["clock"]`` entry::

        model.state["clock"] = Clock(time=30.0, iteration=5,
                                     dtype=model.dtype)

    ``last_dt`` defaults to +inf, so that a quasi-Adams-Bashforth-2 stepper
    takes its Euler first step; ``dtype`` (the model's field dtype, the
    package default otherwise) sets the type of the times."""
    import numpy as np
    from ..defaults import numpy_dtype
    nt = numpy_dtype(dtype)
    return dict(time=nt(time), iteration=int(iteration),
                last_dt=nt(np.inf if last_dt is None else last_dt))
