from .schemes import (AdvectionScheme, Centered, UpwindBiased, WENO,
                      FluxFormAdvection, adapt_advection_order)
from .fluxes import (cell_advection_timescale, div_Uc, div_Uu, div_Uv,
                     div_Uw)

__all__ = ["AdvectionScheme", "Centered", "UpwindBiased", "WENO",
           "FluxFormAdvection", "adapt_advection_order",
           "cell_advection_timescale", "div_Uc", "div_Uu", "div_Uv",
           "div_Uw"]
