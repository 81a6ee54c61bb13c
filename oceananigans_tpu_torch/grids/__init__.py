from .topology import (PERIODIC, BOUNDED, FLAT, FULLY_CONNECTED, CENTER,
                       FACE,
                       LOC_CCC, LOC_FCC, LOC_CFC, LOC_CCF)
from .base import AbstractGrid
from .rectilinear import RectilinearGrid
from .latlon import LatitudeLongitudeGrid
from .orthogonal_spherical_shell import (OrthogonalSphericalShellGrid,
                                         RotatedLatitudeLongitudeGrid)
from .tripolar import TripolarGrid
from .cubed_sphere import ConformalCubedSphereGrid, ConformalCubedSpherePanel
from .stretching import (ExponentialDiscretization, LinearStretching,
                         PowerLawStretching,
                         ReferenceToStretchedDiscretization)

__all__ = ["PERIODIC", "BOUNDED", "FLAT", "FULLY_CONNECTED", "CENTER",
           "FACE", "LOC_CCC", "LOC_FCC", "LOC_CFC", "LOC_CCF",
           "AbstractGrid", "RectilinearGrid", "LatitudeLongitudeGrid",
           "OrthogonalSphericalShellGrid", "RotatedLatitudeLongitudeGrid",
           "TripolarGrid", "ConformalCubedSphereGrid",
           "ConformalCubedSpherePanel",
           "ExponentialDiscretization", "LinearStretching",
           "PowerLawStretching", "ReferenceToStretchedDiscretization"]
