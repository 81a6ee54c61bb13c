from .boundary_condition import (
    BoundaryCondition, FieldBoundaryConditions, ImmersedBoundaryCondition,
    PeriodicBoundaryCondition,
    FluxBoundaryCondition, ValueBoundaryCondition, GradientBoundaryCondition,
    FieldTimeSeriesBoundaryCondition,
    ImpenetrableBoundaryCondition, OpenBoundaryCondition,
    PerturbationAdvection, regularize_field_boundary_conditions,
    default_bcs, PolarBoundaryCondition, PolarValue,
    ZipperBoundaryCondition,
)
from .fill_halos import (apply_flux_bcs, apply_flux_bcs_padded,
                         fill_all_halo_regions, fill_halo_regions,
                         fill_surface_halo_regions)

__all__ = [
    "BoundaryCondition", "FieldBoundaryConditions",
    "ImmersedBoundaryCondition",
    "PeriodicBoundaryCondition", "FluxBoundaryCondition",
    "ValueBoundaryCondition", "GradientBoundaryCondition",
    "FieldTimeSeriesBoundaryCondition",
    "ImpenetrableBoundaryCondition", "OpenBoundaryCondition",
    "PerturbationAdvection", "regularize_field_boundary_conditions",
    "default_bcs", "PolarBoundaryCondition", "PolarValue",
    "ZipperBoundaryCondition", "apply_flux_bcs", "apply_flux_bcs_padded",
    "fill_all_halo_regions", "fill_halo_regions",
    "fill_surface_halo_regions",
]
