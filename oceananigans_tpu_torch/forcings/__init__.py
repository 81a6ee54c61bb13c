from .forcings import (AdvectiveForcing, ContinuousForcing, DiscreteForcing,
                       FieldTimeSeriesForcing, Forcing, GaussianMask,
                       LinearTarget, MultipleForcings, PiecewiseLinearMask,
                       Relaxation, make_forcing, regularize_forcing)

__all__ = ["Forcing", "ContinuousForcing", "DiscreteForcing", "Relaxation",
           "AdvectiveForcing", "MultipleForcings", "FieldTimeSeriesForcing",
           "GaussianMask", "PiecewiseLinearMask", "LinearTarget",
           "make_forcing", "regularize_forcing"]
