from .schemes import (AdvectionScheme, Centered, UpwindBiased, WENO,
                      FluxFormAdvection, adapt_advection_order)
from .fluxes import div_Uu, div_Uv, div_Uw

__all__ = ["AdvectionScheme", "Centered", "UpwindBiased", "WENO",
           "FluxFormAdvection", "adapt_advection_order",
           "div_Uu", "div_Uv", "div_Uw"]
