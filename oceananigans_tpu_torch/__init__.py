"""oceananigans_tpu_torch — the PyTorch and CUDA port of oceananigans_tpu.

The JAX package ``oceananigans_tpu`` is the reference; this package mirrors
its module paths. It covers ``NonhydrostaticModel`` on a regular
RectilinearGrid with periodic x/y and bounded z: WENO(5) or Centered(2)
advection, tracers, ``BuoyancyTracer``, an explicit ``ScalarDiffusivity``,
scalar Value/Gradient/Flux boundary conditions on the z sides, RK3, and the
FFT/DCT pressure projection; ``ShallowWaterModel`` on a regular
periodic 2D grid in both formulations, with ``FPlane``,
``ConstantCartesianCoriolis`` or ``BetaPlane`` rotation, bathymetry and
tracers; and ``HydrostaticFreeSurfaceModel`` on a ``LatitudeLongitudeGrid``
(or a regular RectilinearGrid) with bounded or periodic x and y: the
conserving and WENO vector-invariant momentum advection,
``HydrostaticSphericalCoriolis``, tracers, ``BuoyancyTracer``, quasi-AB2 and
the split-explicit or explicit free surface. Its hot paths run hand-written CUDA kernels
(``kernels/``, sources in ``csrc/``), each beside a plain PyTorch version
that serves CPU tensors. Grids live on the CUDA card unless built with
``device="cpu"``.

Layer map:

    grids/                 topology, coordinates, metrics, halos
                           (RectilinearGrid, LatitudeLongitudeGrid)
    operators/             finite-volume stencil micro-ops
    boundary_conditions/   BCs, halo filling, boundary fluxes
    fields/                Field wrapper and set
    advection/             Centered / UpwindBiased / WENO, flux divergences,
                           VectorInvariant, WENOVectorInvariant
    buoyancy.py            BuoyancyTracer
    coriolis.py            FPlane / ConstantCartesianCoriolis / BetaPlane /
                           HydrostaticSphericalCoriolis
    closures/              ScalarDiffusivity and its diffusion operators
    solvers/               FFT/DCT Poisson solver
    timesteppers/          RK3 coefficients, quasi-AB2
    models/                NonhydrostaticModel, ShallowWaterModel,
                           HydrostaticFreeSurfaceModel, free surfaces
    parallel/              device meshes (Distributed, Partition) and the
                           halo exchange between shards
    kernels/, csrc/        CUDA kernels and their plain versions
"""

from .defaults import defaults
from .grids import (RectilinearGrid, LatitudeLongitudeGrid, PERIODIC,
                    BOUNDED, FLAT, CENTER, FACE)
from .advection import Centered, UpwindBiased, WENO
from .advection.vector_invariant import (VectorInvariant,
                                         WENOVectorInvariant)
from .boundary_conditions import (FieldBoundaryConditions,
                                  FluxBoundaryCondition,
                                  GradientBoundaryCondition,
                                  ValueBoundaryCondition)
from .buoyancy import BuoyancyTracer
from .coriolis import (BetaPlane, ConstantCartesianCoriolis, FPlane,
                       HydrostaticSphericalCoriolis)
from .closures import ScalarDiffusivity
from .fields import Field
from .parallel import CPU, GPU, Distributed, Partition
from .models import (ConservativeFormulation, ExplicitFreeSurface,
                     HydrostaticFreeSurfaceModel, NonhydrostaticModel,
                     ShallowWaterModel, SplitExplicitFreeSurface,
                     VectorInvariantFormulation, state_from_jax)

__all__ = ["defaults", "RectilinearGrid", "LatitudeLongitudeGrid",
           "PERIODIC", "BOUNDED", "FLAT",
           "CENTER", "FACE", "Centered", "UpwindBiased", "WENO",
           "FieldBoundaryConditions", "FluxBoundaryCondition",
           "GradientBoundaryCondition", "ValueBoundaryCondition",
           "BuoyancyTracer", "ScalarDiffusivity", "Field",
           "NonhydrostaticModel", "state_from_jax", "ShallowWaterModel",
           "ConservativeFormulation", "VectorInvariantFormulation",
           "VectorInvariant", "WENOVectorInvariant", "FPlane",
           "ConstantCartesianCoriolis", "BetaPlane",
           "HydrostaticSphericalCoriolis", "HydrostaticFreeSurfaceModel",
           "SplitExplicitFreeSurface", "ExplicitFreeSurface", "CPU", "GPU",
           "Distributed", "Partition"]
