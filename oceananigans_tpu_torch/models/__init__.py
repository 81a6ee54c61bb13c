from .nonhydrostatic import NonhydrostaticModel, state_from_jax
from .shallow_water import (CONSERVATIVE, VECTOR_INVARIANT,
                            ConservativeFormulation, ShallowWaterModel,
                            VectorInvariantFormulation)

__all__ = ["NonhydrostaticModel", "state_from_jax", "ShallowWaterModel",
           "ConservativeFormulation", "VectorInvariantFormulation",
           "CONSERVATIVE", "VECTOR_INVARIANT"]
