"""oceananigans_tpu_torch — the PyTorch and CUDA port of oceananigans_tpu.

The JAX package ``oceananigans_tpu`` is the reference; this package mirrors
its module paths. It covers ``NonhydrostaticModel`` on a regular
RectilinearGrid with periodic x/y and bounded z: WENO(5) or Centered(2)
advection, tracers, ``BuoyancyTracer``, an explicit ``ScalarDiffusivity``,
scalar Value/Gradient/Flux boundary conditions on the z sides, RK3, and the
FFT/DCT pressure projection; and ``ShallowWaterModel`` on a regular
periodic 2D grid in both formulations, with ``FPlane``,
``ConstantCartesianCoriolis`` or ``BetaPlane`` rotation, bathymetry and
tracers. Its hot paths run hand-written CUDA kernels
(``kernels/``, sources in ``csrc/``), each beside a plain PyTorch version
that serves CPU tensors. Grids live on the CUDA card unless built with
``device="cpu"``.

Layer map:

    grids/                 topology, coordinates, metrics, halos
    operators/             finite-volume stencil micro-ops
    boundary_conditions/   BCs, halo filling, boundary fluxes
    fields/                Field wrapper and set
    advection/             Centered / UpwindBiased / WENO, flux divergences,
                           conserving VectorInvariant
    buoyancy.py            BuoyancyTracer
    coriolis.py            FPlane / ConstantCartesianCoriolis / BetaPlane
    closures/              ScalarDiffusivity and its diffusion operators
    solvers/               FFT/DCT Poisson solver
    timesteppers/          RK3 coefficients
    models/                NonhydrostaticModel, ShallowWaterModel
    kernels/, csrc/        CUDA kernels and their plain versions
"""

from .defaults import defaults
from .grids import (RectilinearGrid, PERIODIC, BOUNDED, FLAT, CENTER, FACE)
from .advection import Centered, UpwindBiased, WENO
from .advection.vector_invariant import VectorInvariant
from .boundary_conditions import (FieldBoundaryConditions,
                                  FluxBoundaryCondition,
                                  GradientBoundaryCondition,
                                  ValueBoundaryCondition)
from .buoyancy import BuoyancyTracer
from .coriolis import BetaPlane, ConstantCartesianCoriolis, FPlane
from .closures import ScalarDiffusivity
from .fields import Field
from .models import (ConservativeFormulation, NonhydrostaticModel,
                     ShallowWaterModel, VectorInvariantFormulation,
                     state_from_jax)

__all__ = ["defaults", "RectilinearGrid", "PERIODIC", "BOUNDED", "FLAT",
           "CENTER", "FACE", "Centered", "UpwindBiased", "WENO",
           "FieldBoundaryConditions", "FluxBoundaryCondition",
           "GradientBoundaryCondition", "ValueBoundaryCondition",
           "BuoyancyTracer", "ScalarDiffusivity", "Field",
           "NonhydrostaticModel", "state_from_jax", "ShallowWaterModel",
           "ConservativeFormulation", "VectorInvariantFormulation",
           "VectorInvariant", "FPlane", "ConstantCartesianCoriolis",
           "BetaPlane"]
