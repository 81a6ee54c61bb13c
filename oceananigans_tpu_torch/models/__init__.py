from .nonhydrostatic import NonhydrostaticModel, state_from_jax
from .free_surfaces import (ExplicitFreeSurface, ImplicitFreeSurface,
                            SplitExplicitFreeSurface)
from .hydrostatic import (HydrostaticFreeSurfaceModel,
                          PrescribedVelocityFields, ZCoordinate,
                          ZStarCoordinate)
from .shallow_water import (CONSERVATIVE, VECTOR_INVARIANT,
                            ConservativeFormulation, ShallowWaterModel,
                            VectorInvariantFormulation)
from .cubed_sphere_shallow_water import CubedSphereShallowWaterModel
from .cubed_sphere_hydrostatic import CubedSphereHydrostaticModel
from .ensemble import EnsembleModel
from .diagnostic_operations import (BoundaryAdjacentMean,
                                    BoundaryConditionField,
                                    BoundaryConditionOperation,
                                    BuoyancyField, ForcingField,
                                    ForcingOperation, PressureField,
                                    boundary_adjacent_mean)

__all__ = ["NonhydrostaticModel", "state_from_jax", "ShallowWaterModel",
           "HydrostaticFreeSurfaceModel", "PrescribedVelocityFields",
           "ZCoordinate", "ZStarCoordinate", "ExplicitFreeSurface",
           "ImplicitFreeSurface", "SplitExplicitFreeSurface",
           "ConservativeFormulation", "VectorInvariantFormulation",
           "CONSERVATIVE", "VECTOR_INVARIANT", "CubedSphereShallowWaterModel",
           "CubedSphereHydrostaticModel", "EnsembleModel",
           "BoundaryAdjacentMean", "BoundaryConditionField",
           "BoundaryConditionOperation", "BuoyancyField", "ForcingField",
           "ForcingOperation", "PressureField", "boundary_adjacent_mean"]
