from .shifts import shift, shift_zbc
from .operators import (dx_f, dx_c, dy_f, dy_c, dz_f, dz_c,
                        delta, interp, ddx, ddy, ddz, div_ccc)

__all__ = ["shift", "shift_zbc", "dx_f", "dx_c", "dy_f", "dy_c", "dz_f",
           "dz_c", "delta", "interp", "ddx", "ddy", "ddz", "div_ccc"]
