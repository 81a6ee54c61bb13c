from .steppers import RK3_GAMMAS, RK3_ZETAS, RungeKutta3TimeStepper

__all__ = ["RK3_GAMMAS", "RK3_ZETAS", "RungeKutta3TimeStepper"]
