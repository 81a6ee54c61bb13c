from .steppers import (RK3_GAMMAS, Clock, RK3_ZETAS,
                       QuasiAdamsBashforth2TimeStepper,
                       RungeKutta3TimeStepper, SplitRungeKutta3TimeStepper,
                       stage_update)

__all__ = ["Clock", "RK3_GAMMAS", "RK3_ZETAS", "QuasiAdamsBashforth2TimeStepper",
           "RungeKutta3TimeStepper", "SplitRungeKutta3TimeStepper",
           "stage_update"]
