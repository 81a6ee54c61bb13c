"""Turbulence closures: the scalar-diffusivity family, closure tuples, the
LES closures (Smagorinsky, Lilly, dynamic, AMD) and the vertical closures of
the hydrostatic model (CATKE, k-ε, Ri-based, convective adjustment,
two-dimensional Leith). The isopycnal closures raise ``NotImplementedError``
naming their ROADMAP item."""

from .amd import AnisotropicMinimumDissipation
from .catke import (CATKEEquation, CATKEMixingLength,
                    CATKEVerticalDiffusivity)
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

_LONG_TAIL_ITEM = "ROADMAP.md queue 1 item 15 (the long tail)"


def _not_ported(name, item):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: {item}")
    return type(name, (), {"__init__": __init__,
                           "__doc__": f"Not ported yet: {item}."})


IsopycnalSkewSymmetricDiffusivity = _not_ported(
    "IsopycnalSkewSymmetricDiffusivity", _LONG_TAIL_ITEM)
TriadIsopycnalSkewSymmetricDiffusivity = _not_ported(
    "TriadIsopycnalSkewSymmetricDiffusivity", _LONG_TAIL_ITEM)

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
