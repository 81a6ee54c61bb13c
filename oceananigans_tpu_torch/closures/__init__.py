"""Turbulence closures: the scalar-diffusivity family, closure tuples, the
LES closures (Smagorinsky, Lilly, dynamic, AMD) and the vertical closures of
the hydrostatic model (CATKE, k-ε, Ri-based, convective adjustment,
two-dimensional Leith) and the isopycnal closures (GM/Redi and its
triad discretization)."""

from .amd import AnisotropicMinimumDissipation
from .catke import (CATKEEquation, CATKEMixingLength,
                    CATKEVerticalDiffusivity)
from .isopycnal import (IsopycnalSkewSymmetricDiffusivity,
                        TriadIsopycnalSkewSymmetricDiffusivity)
from .scalar_diffusivity import (HORIZONTAL, ISO, VERTICAL, ClosureTuple,
                                 ExplicitTimeDiscretization, FluxTapering,
                                 HorizontalDivergenceScalarBiharmonicDiffusivity,
                                 HorizontalDivergenceScalarDiffusivity,
                                 HorizontalScalarBiharmonicDiffusivity,
                                 HorizontalScalarDiffusivity,
                                 ScalarBiharmonicDiffusivity,
                                 ScalarDiffusivity,
                                 VerticallyImplicitTimeDiscretization,
                                 VerticalScalarBiharmonicDiffusivity,
                                 VerticalScalarDiffusivity, diffusivity,
                                 viscosity)
from .tke_dissipation import (ConstantStabilityFunctions,
                              TKEDissipationEquations,
                              TKEDissipationVerticalDiffusivity,
                              VariableStabilityFunctions)
from .smagorinsky import (DynamicCoefficient, DynamicSmagorinsky,
                          LagrangianAveraging, LillyCoefficient, Smagorinsky,
                          SmagorinskyLilly)
from .vertical_diffusivities import (ConvectiveAdjustmentVerticalDiffusivity,
                                     RiBasedVerticalDiffusivity,
                                     TwoDimensionalLeith)

__all__ = ["ScalarDiffusivity", "VerticalScalarDiffusivity",
           "HorizontalScalarDiffusivity", "ScalarBiharmonicDiffusivity",
           "VerticalScalarBiharmonicDiffusivity",
           "HorizontalScalarBiharmonicDiffusivity",
           "HorizontalDivergenceScalarDiffusivity",
           "HorizontalDivergenceScalarBiharmonicDiffusivity",
           "FluxTapering", "viscosity", "diffusivity",
           "ExplicitTimeDiscretization",
           "VerticallyImplicitTimeDiscretization", "ClosureTuple",
           "ISO", "HORIZONTAL", "VERTICAL", "Smagorinsky",
           "SmagorinskyLilly", "LillyCoefficient", "DynamicCoefficient",
           "DynamicSmagorinsky", "LagrangianAveraging",
           "AnisotropicMinimumDissipation", "CATKEVerticalDiffusivity",
           "CATKEMixingLength", "CATKEEquation",
           "TKEDissipationVerticalDiffusivity", "TKEDissipationEquations",
           "VariableStabilityFunctions", "ConstantStabilityFunctions",
           "RiBasedVerticalDiffusivity",
           "ConvectiveAdjustmentVerticalDiffusivity", "TwoDimensionalLeith",
           "IsopycnalSkewSymmetricDiffusivity",
           "TriadIsopycnalSkewSymmetricDiffusivity"]
