from .nonhydrostatic import NonhydrostaticModel, state_from_jax

__all__ = ["NonhydrostaticModel", "state_from_jax"]
