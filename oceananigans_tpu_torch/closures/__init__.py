"""Turbulence closures: the scalar-diffusivity family, closure tuples and
the LES closures (Smagorinsky, Lilly, dynamic, AMD). The vertical
diffusivities of the hydrostatic model (CATKE, k-ε, Ri-based, convective
adjustment, two-dimensional Leith) and the isopycnal closures raise
``NotImplementedError`` naming their ROADMAP item."""

from .amd import AnisotropicMinimumDissipation
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
from .smagorinsky import (DynamicCoefficient, DynamicSmagorinsky,
                          LagrangianAveraging, LillyCoefficient, Smagorinsky,
                          SmagorinskyLilly)

_VERTICAL_ITEM = ("ROADMAP.md queue 1 item 13 (hydrostatic: vertical "
                  "diffusivities and CATKE)")
_LONG_TAIL_ITEM = "ROADMAP.md queue 1 item 15 (the long tail)"


def _not_ported(name, item):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: {item}")
    return type(name, (), {"__init__": __init__,
                           "__doc__": f"Not ported yet: {item}."})


CATKEVerticalDiffusivity = _not_ported("CATKEVerticalDiffusivity",
                                       _VERTICAL_ITEM)
TKEDissipationVerticalDiffusivity = _not_ported(
    "TKEDissipationVerticalDiffusivity", _VERTICAL_ITEM)
RiBasedVerticalDiffusivity = _not_ported("RiBasedVerticalDiffusivity",
                                         _VERTICAL_ITEM)
ConvectiveAdjustmentVerticalDiffusivity = _not_ported(
    "ConvectiveAdjustmentVerticalDiffusivity", _VERTICAL_ITEM)
TwoDimensionalLeith = _not_ported("TwoDimensionalLeith", _VERTICAL_ITEM)
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
           "TKEDissipationVerticalDiffusivity", "RiBasedVerticalDiffusivity",
           "ConvectiveAdjustmentVerticalDiffusivity", "TwoDimensionalLeith",
           "IsopycnalSkewSymmetricDiffusivity",
           "TriadIsopycnalSkewSymmetricDiffusivity"]
