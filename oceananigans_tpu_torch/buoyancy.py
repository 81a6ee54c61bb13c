"""Buoyancy formulations and equations of state.

Counterpart of ``oceananigans_tpu/buoyancy.py``: ``BuoyancyTracer`` (a
prognostic tracer ``b`` is the buoyancy), ``SeawaterBuoyancy`` (T and S
tracers and an equation of state: the linear one, b = g (α T - β S), or a
nonlinear one with a ``buoyancy(g, T, S, z)`` method: Roquet's second-order
polynomial or the 55-term TEOS-10 polynomial), ``NonlinearSeawaterBuoyancy``,
``seawater_density`` and ``BuoyancyForce`` for a gravity in any direction.

The tendency hooks take padded tensors: ``z_buoyancy`` is the force along z
at (c, c, f) for Gw (gravity along -z), and ``BuoyancyForce`` adds
``x_buoyancy`` at (f, c, c) and ``y_buoyancy`` at (c, f, c) (None where the
gravity has no such component). The depth that a nonlinear equation of state
reads is a tensor of the tracers' dtype and device, so a float32 step stays
float32. On the z-compact layout (no z halo) the bottom face reads a zero
below the first cell, as the JAX package's does; the model pins w's bottom
face after each update, which discards that value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .defaults import defaults
from .fields import Field
from .grids.base import broadcastable_1d
from .grids.topology import LOC_CCC
from .operators.operators import ix_f, iy_f, iz_f


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _z_centres(grid, like):
    """The padded z of the cell centres, broadcastable, in the dtype and on
    the device of ``like``."""
    return torch.as_tensor(broadcastable_1d(grid.coord_padded(2, "c"), 2),
                           dtype=like.dtype, device=like.device)


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
        """Buoyancy at cell centres (the hydrostatic pressure integrand)."""
        return tracers["b"]

    def z_buoyancy(self, grid, tracers):
        """Buoyancy at (c, c, f) for the Gw tendency (padded)."""
        return iz_f(grid, tracers["b"])


class LinearEquationOfState:
    """b = g (α T - β S)."""

    def __init__(self, thermal_expansion=1.67e-4, haline_contraction=7.8e-4):
        self.alpha = float(thermal_expansion)
        self.beta = float(haline_contraction)

    def _fp(self):
        return ("LinearEOS", self.alpha, self.beta)

    __hash__ = BuoyancyTracer.__hash__
    __eq__ = BuoyancyTracer.__eq__


class SeawaterBuoyancy:
    """T and S tracers and an equation of state. ``constant_temperature`` /
    ``constant_salinity`` replace the tracer by a constant."""

    def __init__(self, equation_of_state=None, gravitational_acceleration=None,
                 constant_temperature=None, constant_salinity=None):
        self.eos = equation_of_state or LinearEquationOfState()
        self.g = (defaults.gravitational_acceleration
                  if gravitational_acceleration is None
                  else float(gravitational_acceleration))
        self.constant_temperature = constant_temperature
        self.constant_salinity = constant_salinity
        names = []
        if constant_temperature is None:
            names.append("T")
        if constant_salinity is None:
            names.append("S")
        self.required_tracers = tuple(names)

    def _fp(self):
        return ("SeawaterBuoyancy", self.eos._fp(), self.g,
                self.constant_temperature, self.constant_salinity)

    __hash__ = BuoyancyTracer.__hash__
    __eq__ = BuoyancyTracer.__eq__

    def buoyancy_ccc(self, grid, tracers):
        T = (tracers["T"] if self.constant_temperature is None
             else self.constant_temperature)
        S = (tracers["S"] if self.constant_salinity is None
             else self.constant_salinity)
        if callable(getattr(self.eos, "buoyancy", None)):
            # a nonlinear equation of state reads the depth
            like = T if isinstance(T, torch.Tensor) else S
            return self.eos.buoyancy(self.g, T, S, _z_centres(grid, like))
        return self.g * (self.eos.alpha * T - self.eos.beta * S)

    def z_buoyancy(self, grid, tracers):
        return iz_f(grid, self.buoyancy_ccc(grid, tracers))


class RoquetSecondOrderEquationOfState:
    """The second-order polynomial equation of state of Roquet et al.
    (2015): the density anomaly (kg/m³) of conservative temperature Θ,
    absolute salinity S and height z (negative downward)

        ρ′ = -a₀ (1 + ½ λ₁ Θ + μ₁ d) Θ + b₀ S,   d = -z,

    with thermal expansion, cabbeling (λ₁) and thermobaricity (μ₁)."""

    def __init__(self, a0=1.6550e-1, b0=7.6554e-1, lambda1=5.9520e-2,
                 mu1=1.4970e-4, reference_density=1020.0):
        self.a0 = float(a0)
        self.b0 = float(b0)
        self.lambda1 = float(lambda1)
        self.mu1 = float(mu1)
        self.rho0 = float(reference_density)

    def _fp(self):
        return ("RoquetEOS2", self.a0, self.b0, self.lambda1, self.mu1,
                self.rho0)

    __hash__ = BuoyancyTracer.__hash__
    __eq__ = BuoyancyTracer.__eq__

    def density_anomaly(self, T, S, z):
        return -self.a0 * (1 + 0.5 * self.lambda1 * T
                           + self.mu1 * (-z)) * T + self.b0 * S

    def buoyancy(self, g, T, S, z):
        return -g * self.density_anomaly(T, S, z) / self.rho0


class TEOS10EquationOfState:
    """The 55-term polynomial TEOS-10 Boussinesq equation of state
    ("polyTEOS10-bsq", Roquet, Madec, McDougall and Barker 2015, Ocean
    Modelling 90:29-43, Appendix A.2): ρ(Θ, Sᴬ, Z) = r₀(Z) + r′(Θ, Sᴬ, Z),
    r′ a polynomial of degree (6, 4, 2, 1) in the normalized (√S, Θ, Z) and
    r₀ a quintic reference profile. The coefficients are the published
    tables."""

    # normalization constants (Roquet et al. 2015, Appendix A.2)
    _SAu = 40.0 * 35.16504 / 35.0
    _CTu = 40.0
    _Zu = 1.0e4
    _deltaS = 32.0

    # r′ coefficients R[ijk]: (√S)^i Θ^j Z^k
    _R = dict(
        R000=8.0189615746e+02, R100=8.6672408165e+02, R200=-1.7864682637e+03,
        R300=2.0375295546e+03, R400=-1.2849161071e+03, R500=4.3227585684e+02,
        R600=-6.0579916612e+01,
        R010=2.6010145068e+01, R110=-6.5281885265e+01, R210=8.1770425108e+01,
        R310=-5.6888046321e+01, R410=1.7681814114e+01, R510=-1.9193502195e+00,
        R020=-3.7074170417e+01, R120=6.1548258127e+01, R220=-6.0362551501e+01,
        R320=2.9130021253e+01, R420=-5.4723692739e+00,
        R030=2.1661789529e+01, R130=-3.3449108469e+01, R230=1.9717078466e+01,
        R330=-3.1742946532e+00,
        R040=-8.3627885467e+00, R140=1.1311538584e+01, R240=-5.3563304045e+00,
        R050=5.4048723791e-01, R150=4.8169980163e-01,
        R060=-1.9083568888e-01,
        R001=1.9681925209e+01, R101=-4.2549998214e+01, R201=5.0774768218e+01,
        R301=-3.0938076334e+01, R401=6.6051753097e+00,
        R011=-1.3336301113e+01, R111=-4.4870114575e+00, R211=5.0042598061e+00,
        R311=-6.5399043664e-01,
        R021=6.7080479603e+00, R121=3.5063081279e+00, R221=-1.8795372996e+00,
        R031=-2.4649669534e+00, R131=-5.5077101279e-01,
        R041=5.5927935970e-01,
        R002=2.0660924175e+00, R102=-4.9527603989e+00, R202=2.5019633244e+00,
        R012=2.0564311499e+00, R112=-2.1311365518e-01,
        R022=-1.2419983026e+00,
        R003=-2.3342758797e-02, R103=-1.8507636718e-02, R013=3.7969820455e-01,
    )
    # vertical reference profile r₀(Z) coefficients
    _RZ = (4.6494977072e+01, -5.2099962525e+00, 2.2601900708e-01,
           6.4326772569e-02, 1.5616995503e-02, -1.7243708991e-03)

    def __init__(self, reference_density=1020.0):
        self.rho0 = float(reference_density)

    def _fp(self):
        return ("TEOS10", self.rho0)

    __hash__ = BuoyancyTracer.__hash__
    __eq__ = BuoyancyTracer.__eq__

    def density(self, T, S, z):
        """In-situ Boussinesq density ρ(Θ, Sᴬ, Z) [kg/m³]; T is conservative
        temperature [°C], S absolute salinity [g/kg], z geopotential height
        [m] (negative below the surface)."""
        g = self._R
        ss = _sqrt((S + self._deltaS) / self._SAu)
        tt = T / self._CTu
        zz = -z / self._Zu
        rz3 = g["R013"] * tt + g["R103"] * ss + g["R003"]
        rz2 = ((g["R022"] * tt + g["R112"] * ss + g["R012"]) * tt
               + (g["R202"] * ss + g["R102"]) * ss + g["R002"])
        rz1 = ((((g["R041"] * tt + g["R131"] * ss + g["R031"]) * tt
                 + (g["R221"] * ss + g["R121"]) * ss + g["R021"]) * tt
                + ((g["R311"] * ss + g["R211"]) * ss + g["R111"]) * ss
                + g["R011"]) * tt
               + (((g["R401"] * ss + g["R301"]) * ss + g["R201"]) * ss
                  + g["R101"]) * ss + g["R001"])
        rz0 = (((((g["R060"] * tt + g["R150"] * ss + g["R050"]) * tt
                  + (g["R240"] * ss + g["R140"]) * ss + g["R040"]) * tt
                 + ((g["R330"] * ss + g["R230"]) * ss + g["R130"]) * ss
                 + g["R030"]) * tt
                + (((g["R420"] * ss + g["R320"]) * ss + g["R220"]) * ss
                   + g["R120"]) * ss + g["R020"]) * tt
               + ((((g["R510"] * ss + g["R410"]) * ss + g["R310"]) * ss
                   + g["R210"]) * ss + g["R110"]) * ss + g["R010"]) * tt \
            + (((((g["R600"] * ss + g["R500"]) * ss + g["R400"]) * ss
                 + g["R300"]) * ss + g["R200"]) * ss + g["R100"]) * ss \
            + g["R000"]
        r_prime = ((rz3 * zz + rz2) * zz + rz1) * zz + rz0
        c0, c1, c2, c3, c4, c5 = self._RZ
        r0 = zz * (c0 + zz * (c1 + zz * (c2 + zz * (c3 + zz * (c4 + zz * c5)))))
        return r0 + r_prime

    def density_anomaly(self, T, S, z):
        """ρ′ = ρ(Θ, Sᴬ, Z) − ρ₀."""
        return self.density(T, S, z) - self.rho0

    def buoyancy(self, g, T, S, z):
        return -g * self.density_anomaly(T, S, z) / self.rho0

    def thermal_expansion(self, T, S, z, dT=1e-3):
        """α = −(∂ρ/∂Θ)/ρ by a centred difference of the polynomial."""
        rho = self.density(T, S, z)
        return -(self.density(T + dT, S, z)
                 - self.density(T - dT, S, z)) / (2 * dT) / rho

    def haline_contraction(self, T, S, z, dS=1e-3):
        """β = (∂ρ/∂Sᴬ)/ρ."""
        rho = self.density(T, S, z)
        return (self.density(T, S + dS, z)
                - self.density(T, S - dS, z)) / (2 * dS) / rho


class NonlinearSeawaterBuoyancy(SeawaterBuoyancy):
    """SeawaterBuoyancy with Roquet's second-order equation of state by
    default."""

    def __init__(self, equation_of_state=None, **kw):
        eos = equation_of_state or RoquetSecondOrderEquationOfState()
        super().__init__(equation_of_state=eos, **kw)


def seawater_density(model, eos=None):
    """The density ρ = ρ₀ + ρ′(T, S, z) of the model's T and S as a lazy
    ``KernelFunctionOperation`` at (c, c, c): ``compute()`` evaluates it at
    the model's state then."""
    from .abstract_operations import KernelFunctionOperation
    eos = eos or RoquetSecondOrderEquationOfState()

    def rho(grid, T, S):
        return eos.rho0 + eos.density_anomaly(T, S, _z_centres(grid, T))

    return KernelFunctionOperation(rho, model.grid, model.field("T"),
                                   model.field("S"))


class BuoyancyForce:
    """Buoyancy with a gravity in any direction: ``gravity_unit_vector``
    points where gravity acts (default (0, 0, -1)), and the force along
    each axis is -ĝ·b."""

    def __init__(self, formulation, gravity_unit_vector=(0.0, 0.0, -1.0)):
        g = np.asarray(gravity_unit_vector, float)
        self.formulation = formulation
        self.g_unit = tuple(float(c) for c in g / np.linalg.norm(g))

    @property
    def required_tracers(self):
        return self.formulation.required_tracers

    def _fp(self):
        return ("BuoyancyForce", self.formulation._fp(), self.g_unit)

    __hash__ = BuoyancyTracer.__hash__
    __eq__ = BuoyancyTracer.__eq__

    def buoyancy_ccc(self, grid, tracers):
        return self.formulation.buoyancy_ccc(grid, tracers)

    def x_buoyancy(self, grid, tracers):
        """-ĝx·b at (f, c, c); None when gravity has no x component."""
        if self.g_unit[0] == 0.0:
            return None
        return -self.g_unit[0] * ix_f(grid, self.buoyancy_ccc(grid, tracers))

    def y_buoyancy(self, grid, tracers):
        if self.g_unit[1] == 0.0:
            return None
        return -self.g_unit[1] * iy_f(grid, self.buoyancy_ccc(grid, tracers))

    def z_buoyancy(self, grid, tracers):
        if self.g_unit[2] == 0.0:
            return None
        return -self.g_unit[2] * iz_f(grid, self.buoyancy_ccc(grid, tracers))
