"""Time steppers: 3rd-order Runge-Kutta (Le & Moin 1991).

Counterpart of ``oceananigans_tpu/timesteppers/steppers.py`` (RK3 only):
γ¹=8/15, γ²=5/12, γ³=3/4, ζ²=-17/60, ζ³=-5/12; substep
Uᵐ⁺¹ = Uᵐ + Δt(γᵐGᵐ + ζᵐGᵐ⁻¹) with a pressure correction per substep.
"""

from __future__ import annotations

RK3_GAMMAS = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RK3_ZETAS = (0.0, -17.0 / 60.0, -5.0 / 12.0)


class RungeKutta3TimeStepper:
    name = "RungeKutta3"
