"""Buoyancy formulations.

Counterpart of ``oceananigans_tpu/buoyancy.py``, cut to ``BuoyancyTracer``: a
prognostic tracer ``b`` is the buoyancy, and gravity acts along -z, so the
buoyancy force enters only the w tendency, as ``b`` interpolated to the
(c, c, f) faces. Seawater buoyancy, equations of state and other gravity
directions are not ported yet (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

from .operators.operators import iz_f


class BuoyancyTracer:
    """Buoyancy is the prognostic tracer ``b`` [m/s²]."""

    required_tracers = ("b",)

    def _fp(self):
        return ("BuoyancyTracer",)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def buoyancy_ccc(self, grid, tracers):
        """Buoyancy at cell centers (the hydrostatic pressure integrand)."""
        return tracers["b"]

    def z_buoyancy(self, grid, tracers):
        """Buoyancy at (c, c, f) for the Gw tendency (padded). On the
        z-compact layout (no z halo) the bottom face reads a zero below the
        first cell, as the JAX package's does; the model pins w's bottom
        face after each update, which discards that value."""
        return iz_f(grid, tracers["b"])
