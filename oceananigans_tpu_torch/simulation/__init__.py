from .simulation import Callback, NaNChecker, Simulation

__all__ = ["Simulation", "Callback", "NaNChecker"]
