from .shifts import shift, shift_zbc
from .operators import (dx_f, dx_c, dy_f, dy_c, dz_f, dz_c, ix_f, ix_c,
                        iy_f, iy_c, iz_f, iz_c, delta, interp, interp_to,
                        ddx, ddy, ddz, div_ccc, div_xy_ccc,
                        zeta3_ffc, LOC_FFC)

__all__ = ["shift", "shift_zbc", "dx_f", "dx_c", "dy_f", "dy_c", "dz_f",
           "dz_c", "ix_f", "ix_c", "iy_f", "iy_c", "iz_f", "iz_c", "delta",
           "interp", "interp_to", "ddx", "ddy", "ddz", "div_ccc",
           "div_xy_ccc", "zeta3_ffc", "LOC_FFC"]
