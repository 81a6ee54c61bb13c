from .topology import (PERIODIC, BOUNDED, FLAT, CENTER, FACE,
                       LOC_CCC, LOC_FCC, LOC_CFC, LOC_CCF)
from .base import AbstractGrid
from .rectilinear import RectilinearGrid
from .latlon import LatitudeLongitudeGrid

__all__ = ["PERIODIC", "BOUNDED", "FLAT", "CENTER", "FACE",
           "LOC_CCC", "LOC_FCC", "LOC_CFC", "LOC_CCF",
           "AbstractGrid", "RectilinearGrid", "LatitudeLongitudeGrid"]
