from .boundary_condition import (
    BoundaryCondition, FieldBoundaryConditions, PeriodicBoundaryCondition,
    FluxBoundaryCondition, ImpenetrableBoundaryCondition,
    regularize_field_boundary_conditions, default_bcs,
)
from .fill_halos import fill_all_halo_regions

__all__ = [
    "BoundaryCondition", "FieldBoundaryConditions",
    "PeriodicBoundaryCondition", "FluxBoundaryCondition",
    "ImpenetrableBoundaryCondition", "regularize_field_boundary_conditions",
    "default_bcs", "fill_all_halo_regions",
]
