from .nonhydrostatic import NonhydrostaticModel, state_from_jax
from .free_surfaces import (ExplicitFreeSurface, ImplicitFreeSurface,
                            SplitExplicitFreeSurface)
from .hydrostatic import HydrostaticFreeSurfaceModel
from .shallow_water import (CONSERVATIVE, VECTOR_INVARIANT,
                            ConservativeFormulation, ShallowWaterModel,
                            VectorInvariantFormulation)

__all__ = ["NonhydrostaticModel", "state_from_jax", "ShallowWaterModel",
           "HydrostaticFreeSurfaceModel", "ExplicitFreeSurface",
           "ImplicitFreeSurface", "SplitExplicitFreeSurface",
           "ConservativeFormulation", "VectorInvariantFormulation",
           "CONSERVATIVE", "VECTOR_INVARIANT"]
