"""Free surfaces of the HydrostaticFreeSurfaceModel.

Counterpart of ``oceananigans_tpu/models/free_surfaces.py``:

- ``ExplicitFreeSurface``: ∂t η = -∇·U, with -g∇η in the momentum
  tendencies;
- ``SplitExplicitFreeSurface``: forward-backward substeps of (η, U, V)
  with Δτ spanning (t, t + 2Δt), Shchepetkin's averaging-shape weights, the
  slow forcing Gᵁ = ∫G_u dz, and a filtered (η, U, V) returned for the
  barotropic corrector. ``substeps=N`` takes a fixed count
  (``FixedSubstepNumber``); ``cfl=`` takes ``FixedTimeStepSize``: Δτ =
  cfl·Δs/√(g·Lz) from the grid's minimum spacings, and ceil(2Δt/Δτ) substeps
  (at least ``MINIMUM_SUBSTEPS``) counted on the host at each step, a plain
  Python integer; ``cfl=`` with ``fixed_dt=`` and ``grid=`` becomes a fixed
  count when the surface is built.

The substep loop is a Python loop of small 2-D PyTorch operations (the JAX
package unrolls it at trace time, or scans it above 64 substeps). The halos
of (η, U, V) are refilled every substep on a grid with a bounded x or y, and
every ⌊H/2⌋ substeps on a doubly periodic one (a fill keeps ±1 stencils
valid for H/2 substeps there), as in JAX.

- ``ImplicitFreeSurface``: the configuration of a backward-Euler step of
  the barotropic mode, (1 - gHΔt²∇²)ηⁿ⁺¹ = ηⁿ - Δt∇·∫u* dz, which the model
  solves by FFT/DCT or by preconditioned conjugate gradients.
"""

from __future__ import annotations

import numpy as np

from ..defaults import defaults
from ..grids.topology import LOC_CCC, LOC_CFC, LOC_FCC, PERIODIC
from ..operators.operators import _metric, dx_c, dx_f, dy_c, dy_f



def averaging_shape_function(tau, p=2, q=4, r=0.18927):
    """Shchepetkin & McWilliams (2005) minimal-dispersion averaging kernel."""
    tau0 = (p + 2) * (p + q + 2) / (p + 1) / (p + q + 1)
    return (tau / tau0) ** p * (1 - (tau / tau0) ** q) - r * (tau / tau0)


def weights_from_substeps(substeps, kernel=averaging_shape_function):
    """The fractional substep size and the normalized averaging weights,
    truncated where the kernel goes non-positive at the tail."""
    tau_f = np.linspace(0.0, 2.0, substeps + 1)
    dtau = tau_f[1] - tau_f[0]
    w = np.array([kernel(t) for t in tau_f[1:]])
    idx = len(w)
    while idx > 1 and w[idx - 1] <= 0:
        idx -= 1
    w = w[:idx]
    w = w / w.sum()
    return float(dtau), w


class ExplicitFreeSurface:
    def __init__(self, gravitational_acceleration=None):
        self.g = (defaults.gravitational_acceleration
                  if gravitational_acceleration is None
                  else float(gravitational_acceleration))

    def _fp(self):
        return ("ExplicitFreeSurface", self.g)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()


class ImplicitFreeSurface:
    """A backward-Euler step of the barotropic mode, solved by the model:
    ``solver_method`` "FastFourierTransform" (a regular RectilinearGrid of
    constant depth), "PreconditionedConjugateGradient" (any grid; the FFT
    solve preconditions it on a regular RectilinearGrid) or "Default" (the
    first where it applies, else the second); "HeptadiagonalIterativeSolver"
    is the same operator and takes the second, as in JAX."""

    def __init__(self, gravitational_acceleration=None,
                 solver_method="Default"):
        self.g = (defaults.gravitational_acceleration
                  if gravitational_acceleration is None
                  else float(gravitational_acceleration))
        self.solver_method = solver_method

    def _fp(self):
        return ("ImplicitFreeSurface", self.g, self.solver_method)

    __hash__ = ExplicitFreeSurface.__hash__
    __eq__ = ExplicitFreeSurface.__eq__


class FixedSubstepNumber:
    """Split-explicit substepping with a fixed substep count."""

    def __init__(self, substeps, averaging_kernel=averaging_shape_function):
        self.substeps = int(substeps)
        self.fractional_step, self.weights = weights_from_substeps(
            self.substeps, averaging_kernel)

    def settings(self, dt):
        return self.fractional_step, self.weights

    def _fp(self):
        return ("FixedSubstepNumber", self.substeps)


# the averaging weights may be negative over the first substeps, so the
# count has a floor
MINIMUM_SUBSTEPS = 5


def substeps_for(dt, dt_barotropic):
    """ceil(2Δt/Δτ), at least ``MINIMUM_SUBSTEPS``."""
    return max(MINIMUM_SUBSTEPS,
               int(np.ceil(2.0 * float(dt) / dt_barotropic)))


class FixedTimeStepSize:
    """Split-explicit substepping with a fixed barotropic Δτ from a
    gravity-wave CFL: Δτ = cfl·Δs/√(g·Lz), Δs the harmonic combination of
    the grid's minimum horizontal spacings; ceil(2Δt/Δτ) substeps for each
    Δt."""

    def __init__(self, cfl, averaging_kernel=averaging_shape_function):
        self.cfl = float(cfl)
        self.averaging_kernel = averaging_kernel
        self.dt_barotropic = None   # set by materialize(grid, g)

    def materialize(self, grid, g):
        dx2 = 0.0 if grid.is_flat(0) else 1.0 / grid.minimum_spacing(0) ** 2
        dy2 = 0.0 if grid.is_flat(1) else 1.0 / grid.minimum_spacing(1) ** 2
        ds = np.sqrt(1.0 / (dx2 + dy2))
        wave_speed = np.sqrt(g * abs(grid.extent[2]))
        self.dt_barotropic = float(self.cfl * ds / wave_speed)

    def settings(self, dt):
        if self.dt_barotropic is None:
            raise RuntimeError("FixedTimeStepSize.materialize(grid, g) must "
                               "run before stepping (the model does this)")
        return weights_from_substeps(
            substeps_for(dt, self.dt_barotropic), self.averaging_kernel)

    def _fp(self):
        return ("FixedTimeStepSize", self.cfl)


class SplitExplicitFreeSurface:
    """``substeps=N`` (30 by default) takes ``FixedSubstepNumber``; ``cfl=``
    takes ``FixedTimeStepSize``, resolved against the model's grid by
    ``materialize``; ``cfl=`` with ``fixed_dt=`` and ``grid=`` becomes a
    ``FixedSubstepNumber`` at once."""

    def __init__(self, gravitational_acceleration=None, substeps=None,
                 cfl=None, fixed_dt=None, grid=None,
                 averaging_kernel=averaging_shape_function):
        self.g = (defaults.gravitational_acceleration
                  if gravitational_acceleration is None
                  else float(gravitational_acceleration))
        if cfl is not None and substeps is not None:
            raise ValueError("give either substeps= or cfl=, not both")
        self._fixed_dt = fixed_dt
        if cfl is None:
            self.substepping = FixedSubstepNumber(
                30 if substeps is None else substeps, averaging_kernel)
        else:
            self.substepping = FixedTimeStepSize(cfl, averaging_kernel)
            if grid is not None:
                self.materialize(grid)

    def materialize(self, grid):
        """Resolve a ``FixedTimeStepSize`` against ``grid`` (the model calls
        this with its grid); with ``fixed_dt`` it becomes a fixed count."""
        sub = self.substepping
        if isinstance(sub, FixedTimeStepSize) and sub.dt_barotropic is None:
            sub.materialize(grid, self.g)
            if self._fixed_dt is not None:
                self.substepping = FixedSubstepNumber(
                    substeps_for(self._fixed_dt, sub.dt_barotropic),
                    sub.averaging_kernel)

    @property
    def substeps(self):
        return self.substepping.substeps

    @property
    def weights(self):
        return self.substepping.weights

    @property
    def fractional_step(self):
        return self.substepping.fractional_step

    def settings(self, dt):
        return self.substepping.settings(dt)

    def _fp(self):
        return ("SplitExplicitFreeSurface", self.g, self.substepping._fp())

    __hash__ = ExplicitFreeSurface.__hash__
    __eq__ = ExplicitFreeSurface.__eq__

    def substep(self, grid, H_fc, H_cf, eta, U0, V0, GU, GV, dt, fill,
                settings=None):
        """Run the barotropic substep loop on 2-D (Nx + 2Hx, Ny + 2Hy, 1)
        tensors: ``eta`` the free surface, ``U0``/``V0`` the starting
        transports, ``GU``/``GV`` the depth-integrated slow tendencies,
        ``H_fc``/``H_cf`` the column depths (scalars, or 2-D tensors on an
        immersed grid). ``fill(eta, U, V)`` refreshes the three 2-D fields'
        halos in place (one fill launch on the card) and returns them.
        ``settings`` (fractional step, weights) overrides those of ``dt``
        (the split RK3 stages take the whole step's). Returns the filtered
        (η, U, V)."""
        g = self.g
        frac, weights = settings or self.settings(dt)
        dtau = frac * dt
        dy_fc = _metric(grid.dy(LOC_FCC), eta)
        dx_cf = _metric(grid.dx(LOC_CFC), eta)
        az_cc = _metric(grid.Az(LOC_CCC), eta)
        dx_fc = _metric(grid.dx(LOC_FCC), eta)
        dy_cf = _metric(grid.dy(LOC_CFC), eta)
        halos = [grid.H[ax] for ax in (0, 1) if not grid.is_flat(ax)]
        all_periodic = all(grid.topology[ax] == PERIODIC
                           for ax in (0, 1) if not grid.is_flat(ax))
        K = max(1, min(halos) // 2) if (all_periodic and halos) else 1
        if K > 1:
            # the constant forcing's halos must be ring-valid too (η's are
            # refilled with the values they hold)
            _, GU, GV = fill(eta, GU.clone(), GV.clone())
        U, V = U0, V0
        eta_f = U_f = V_f = None
        for m, w in enumerate(weights):
            if m % K == 0:
                eta, U, V = fill(eta, U, V)
            w = float(w)
            div = (dx_c(grid, dy_fc * U) + dy_c(grid, dx_cf * V)) / az_cc
            eta = eta - dtau * div
            U = U + dtau * (-g * H_fc * dx_f(grid, eta) / dx_fc + GU)
            V = V + dtau * (-g * H_cf * dy_f(grid, eta) / dy_cf + GV)
            if eta_f is None:
                eta_f, U_f, V_f = w * eta, w * U, w * V
            else:
                eta_f = eta_f + w * eta
                U_f = U_f + w * U
                V_f = V_f + w * V
        return eta_f, U_f, V_f
