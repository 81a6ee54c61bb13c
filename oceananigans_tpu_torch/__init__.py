"""oceananigans_tpu_torch — the PyTorch and CUDA port of oceananigans_tpu.

The JAX package ``oceananigans_tpu`` is the reference; this package mirrors
its module paths. It covers ``NonhydrostaticModel`` on a regular
RectilinearGrid with periodic x/y and bounded z: WENO(5) or Centered(2)
advection, tracers, ``BuoyancyTracer``, ``SeawaterBuoyancy`` (linear,
Roquet and TEOS-10 equations of state) and ``BuoyancyForce``, Coriolis, the
scalar-diffusivity closures (explicit or vertically implicit, constant,
function, array or discrete-form coefficients, biharmonic and
horizontal-divergence forms, tuples) and the LES closures (Smagorinsky,
Lilly, dynamic Smagorinsky with directional or Lagrangian averaging, AMD),
forcing, Stokes drift, background fields, scalar Value/Gradient/Flux
conditions on the z sides, RK3 or quasi-AB2, and the FFT/DCT pressure
projection; ``ShallowWaterModel`` on a regular
periodic 2D grid in both formulations, with ``FPlane``,
``ConstantCartesianCoriolis`` or ``BetaPlane`` rotation, bathymetry and
tracers; and ``HydrostaticFreeSurfaceModel`` on a ``LatitudeLongitudeGrid``
(pole to pole with polar caps), a RectilinearGrid, an
``OrthogonalSphericalShellGrid``, a ``RotatedLatitudeLongitudeGrid`` or a
``TripolarGrid`` (the north fold), any of them with stretched coordinates
(``ExponentialDiscretization`` …), with bounded or periodic x and y and
immersed bottoms (``ImmersedBoundaryGrid``): the conserving and WENO
vector-invariant momentum advection (the multi-dimensional stencil too) or
flux-form momentum, ``HydrostaticSphericalCoriolis``, tracers with one
scheme or per-tracer schemes, ``BuoyancyTracer`` or ``SeawaterBuoyancy``,
the closures (CATKE, k-ε, Ri-based, convective adjustment, Leith, the
scalar diffusivities and the isopycnal GM/Redi closures), forcing, function
and field-dependent Flux conditions, the z or z* vertical coordinate,
prescribed velocities, quasi-AB2 or the split RK3, and the split-explicit
(fixed count or ``cfl=``), explicit or implicit (FFT or PCG) free surface. Its hot paths run hand-written CUDA kernels
(``kernels/``, sources in ``csrc/``), each beside a plain PyTorch version
that serves CPU tensors. Grids live on the CUDA card unless built with
``device="cpu"``.

Layer map:

    grids/                 topology, coordinates, metrics, halos
                           (RectilinearGrid, LatitudeLongitudeGrid,
                           OrthogonalSphericalShellGrid, TripolarGrid,
                           the stretchings)
    operators/             finite-volume stencil micro-ops
    boundary_conditions/   BCs, halo filling, boundary fluxes
    fields/                Field wrapper and set
    advection/             Centered / UpwindBiased / WENO, flux divergences,
                           VectorInvariant, WENOVectorInvariant
    buoyancy.py            BuoyancyTracer, SeawaterBuoyancy, equations of
                           state, BuoyancyForce
    coriolis.py            FPlane / ConstantCartesianCoriolis / BetaPlane /
                           NonTraditionalBetaPlane /
                           HydrostaticSphericalCoriolis
    closures/              scalar diffusivities, Smagorinsky, AMD, CATKE,
                           k-ε, the vertical diffusivities, the isopycnal
                           closures and their diffusion operators
    immersed.py            immersed bottoms and boundaries
    forcings/              user forcing (continuous, discrete, relaxation)
    stokes_drift.py        Craik-Leibovich forcing
    background_fields.py   background (mean-flow) fields
    solvers/               FFT/DCT Poisson solver, tridiagonal solver,
                           conjugate gradients
    timesteppers/          RK3 coefficients, quasi-AB2
    models/                NonhydrostaticModel, ShallowWaterModel,
                           HydrostaticFreeSurfaceModel, free surfaces, z*
    parallel/              device meshes (Distributed, Partition) and the
                           halo exchange between shards
    simulation/            Simulation (the run loop), callbacks, the NaN
                           check, the CFL diagnostics and time-step wizard,
                           output writers (FieldWriter, NetCDF-3; HDF5 and
                           NetCDF4 where h5py is installed), readers
                           (FieldTimeSeries), checkpoints
    utils/                 schedules, calendar clocks, units, profiling
    abstract_operations.py lazy operations, reductions, computed fields
                           (fields/function_field.py: analytic fields;
                           fields/regridding.py: conservative regridding;
                           models/diagnostic_operations.py: forcing,
                           boundary-condition, buoyancy and pressure fields)
    particles.py           Lagrangian particles
    biogeochemistry.py     reactions and drift of biogeochemical tracers
    models/ensemble.py     independent copies of a model stepped together
    api.py, logger.py      the free functions and the logger of the JAX
                           package's flat namespace, which this one mirrors
    kernels/, csrc/        CUDA kernels and their plain versions
"""

from .defaults import defaults
from .grids import (RectilinearGrid, LatitudeLongitudeGrid,
                    OrthogonalSphericalShellGrid, RotatedLatitudeLongitudeGrid,
                    TripolarGrid, ConformalCubedSphereGrid,
                    ConformalCubedSpherePanel, ExponentialDiscretization, LinearStretching,
                    PowerLawStretching, ReferenceToStretchedDiscretization,
                    PERIODIC, BOUNDED, FLAT, CENTER, FACE)
from .advection import (Centered, UpwindBiased, WENO, FluxFormAdvection,
                        cell_advection_timescale)
from .advection.vector_invariant import (VectorInvariant,
                                         WENOVectorInvariant)
from .boundary_conditions import (BoundaryCondition, FieldBoundaryConditions,
                                  FieldTimeSeriesBoundaryCondition,
                                  FluxBoundaryCondition,
                                  GradientBoundaryCondition,
                                  ImmersedBoundaryCondition,
                                  OpenBoundaryCondition,
                                  PerturbationAdvection,
                                  ValueBoundaryCondition, fill_halo_regions)
from .background_fields import BackgroundField
from .buoyancy import (BuoyancyForce, BuoyancyTracer, LinearEquationOfState,
                       NonlinearSeawaterBuoyancy,
                       RoquetSecondOrderEquationOfState, SeawaterBuoyancy,
                       TEOS10EquationOfState, seawater_density)
from .coriolis import (BetaPlane, ConstantCartesianCoriolis, FPlane,
                       HydrostaticSphericalCoriolis, NonTraditionalBetaPlane)
from .closures import (AnisotropicMinimumDissipation,
                       CATKEVerticalDiffusivity,
                       ConvectiveAdjustmentVerticalDiffusivity,
                       DynamicCoefficient, DynamicSmagorinsky,
                       ExplicitTimeDiscretization,
                       HorizontalScalarBiharmonicDiffusivity,
                       HorizontalScalarDiffusivity,
                       IsopycnalSkewSymmetricDiffusivity,
                       TriadIsopycnalSkewSymmetricDiffusivity,
                       LagrangianAveraging, LillyCoefficient,
                       RiBasedVerticalDiffusivity,
                       ScalarBiharmonicDiffusivity, ScalarDiffusivity,
                       Smagorinsky, SmagorinskyLilly,
                       TKEDissipationVerticalDiffusivity, TwoDimensionalLeith,
                       VerticallyImplicitTimeDiscretization,
                       VerticalScalarBiharmonicDiffusivity,
                       VerticalScalarDiffusivity, diffusivity, viscosity)
from .immersed import (GridFittedBottom, GridFittedBoundary,
                       ImmersedBoundaryGrid, PartialCellBottom)
from .forcings import (AdvectiveForcing, ContinuousForcing, DiscreteForcing,
                       FieldTimeSeriesForcing, Forcing, GaussianMask,
                       LinearTarget, MultipleForcings, PiecewiseLinearMask,
                       Relaxation)
from .stokes_drift import StokesDrift, UniformStokesDrift
from .fields import (CenterField, ConstantField, Field, FunctionField,
                     GridMetricOperation, OneField, TracerFields,
                     VelocityFields, XFaceField, YFaceField, ZeroField,
                     ZFaceField, interpolate)
from .fields.regridding import regrid_field as regrid
from .abstract_operations import (Accumulation, Average, ConditionalOperation,
                                  CumulativeIntegral, Derivative, Integral,
                                  KernelFunctionOperation, Reduction, at,
                                  conditional_length, partial_x, partial_y,
                                  partial_z)
from .particles import DroguedParticleDynamics, LagrangianParticles
from .parallel import (CPU, GPU, CubedSpherePartition, Distributed, Equal,
                       Fractional, Partition, Sizes, XPartition, YPartition)
from .models import (ConservativeFormulation, CubedSphereHydrostaticModel,
                     CubedSphereShallowWaterModel, ExplicitFreeSurface,
                     HydrostaticFreeSurfaceModel, ImplicitFreeSurface,
                     NonhydrostaticModel, PrescribedVelocityFields,
                     ZCoordinate, ZStarCoordinate,
                     ShallowWaterModel, SplitExplicitFreeSurface,
                     VectorInvariantFormulation, state_from_jax)
from .models.ensemble import EnsembleModel
from .models.diagnostic_operations import (BoundaryAdjacentMean,
                                           BoundaryConditionField,
                                           BoundaryConditionOperation,
                                           BuoyancyField, ForcingField,
                                           ForcingOperation, PressureField)
from .timesteppers import (Clock, QuasiAdamsBashforth2TimeStepper,
                           RungeKutta3TimeStepper,
                           SplitRungeKutta3TimeStepper)
from .logger import setup_logger as OceananigansLogger
from .simulation import Callback, NaNChecker, Simulation
from .simulation.callsites import (TendencyCallsite, TimeStepCallsite,
                                   UpdateStateCallsite)
from .simulation.diagnostics import (CFL, AdvectiveCFL, DiffusiveCFL,
                                     StateChecker, TimeStepWizard,
                                     conjure_time_step_wizard)
from .simulation.output_writers import (AveragedTimeInterval, FieldWriter,
                                        WindowedTimeAverage)
from .simulation.netcdf_writer import NetCDFWriter
from .simulation.netcdf4_writer import NetCDF4Writer
from .simulation.hdf5_writer import HDF5Writer
from .simulation.checkpointer import Checkpointer, checkpoint_grid
from .simulation.output_readers import (FieldDataset, FieldTimeSeries,
                                        InMemory, OnDisk, written_names)
from .simulation.variance_dissipation import VarianceDissipation
from .utils.schedules import (AndSchedule, FileSizeLimit, IterationInterval,
                              OrSchedule, SpecifiedTimes, TimeInterval,
                              WallTimeInterval)
from .utils.pretty import (GiB, KiB, MiB, TiB, day, days, hour, hours,
                           kilometer, kilometers, meter, meters, minute,
                           minutes, prettytime, second, seconds, year)

from .api import (nodes, xnodes, ynodes, znodes, rnodes, lambda_nodes,
                  phi_nodes, xspacings, yspacings, zspacings, rspacings,
                  lambda_spacings, phi_spacings, lambda_spacing, phi_spacing,
                  minimum_xspacing, minimum_yspacing, minimum_zspacing,
                  xspacing, yspacing, zspacing, xarea, yarea, zarea, volume,
                  interior, compute, time_step, run, iteration, set,
                  iteration_limit_exceeded, stop_time_exceeded,
                  wall_time_limit_exceeded)

# the JAX package's names of the same writers
NetCDFOutputWriter = NetCDF4Writer
JLD2Writer = FieldWriter
TEOS10 = TEOS10EquationOfState


def Center():
    """The location marker "c", so that ``xnodes(grid, Center())`` reads as
    in the JAX package."""
    return CENTER


def Face():
    return FACE


def Periodic():
    return PERIODIC


def Bounded():
    return BOUNDED


def Flat():
    return FLAT


# the Unicode spellings of the curvilinear queries
λnodes = lambda_nodes
φnodes = phi_nodes
λspacings = lambda_spacings
φspacings = phi_spacings
λspacing = lambda_spacing
φspacing = phi_spacing

__version__ = "0.2.0"

__all__ = ["defaults", "RectilinearGrid", "LatitudeLongitudeGrid",
           "OrthogonalSphericalShellGrid", "RotatedLatitudeLongitudeGrid",
           "TripolarGrid", "ConformalCubedSphereGrid",
           "ExponentialDiscretization", "LinearStretching",
           "PowerLawStretching",
           "ReferenceToStretchedDiscretization", "PERIODIC", "BOUNDED", "FLAT",
           "CENTER", "FACE", "Centered", "UpwindBiased", "WENO",
           "FieldBoundaryConditions", "FluxBoundaryCondition",
           "GradientBoundaryCondition", "ValueBoundaryCondition",
           "BuoyancyTracer", "SeawaterBuoyancy", "LinearEquationOfState",
           "RoquetSecondOrderEquationOfState", "TEOS10EquationOfState",
           "NonlinearSeawaterBuoyancy", "BuoyancyForce", "ScalarDiffusivity",
           "VerticalScalarDiffusivity", "HorizontalScalarDiffusivity",
           "ScalarBiharmonicDiffusivity",
           "VerticallyImplicitTimeDiscretization", "Smagorinsky",
           "SmagorinskyLilly", "LillyCoefficient", "DynamicSmagorinsky",
           "LagrangianAveraging", "AnisotropicMinimumDissipation",
           "ContinuousForcing", "DiscreteForcing", "Relaxation",
           "AdvectiveForcing", "GaussianMask", "LinearTarget",
           "UniformStokesDrift", "StokesDrift", "BackgroundField",
           "NonTraditionalBetaPlane", "Field",
           "NonhydrostaticModel", "state_from_jax", "ShallowWaterModel",
           "CubedSphereShallowWaterModel", "CubedSphereHydrostaticModel",
           "ConservativeFormulation", "VectorInvariantFormulation",
           "VectorInvariant", "WENOVectorInvariant", "FPlane",
           "ConstantCartesianCoriolis", "BetaPlane",
           "HydrostaticSphericalCoriolis", "HydrostaticFreeSurfaceModel",
           "SplitExplicitFreeSurface", "ExplicitFreeSurface",
           "PrescribedVelocityFields", "ZCoordinate", "ZStarCoordinate",
           "ImplicitFreeSurface", "CPU", "GPU", "Distributed", "Partition",
           "ImmersedBoundaryCondition", "ImmersedBoundaryGrid",
           "GridFittedBottom", "PartialCellBottom", "GridFittedBoundary",
           "CATKEVerticalDiffusivity", "TKEDissipationVerticalDiffusivity",
           "RiBasedVerticalDiffusivity",
           "ConvectiveAdjustmentVerticalDiffusivity", "TwoDimensionalLeith",
           "IsopycnalSkewSymmetricDiffusivity",
           "TriadIsopycnalSkewSymmetricDiffusivity", "CenterField", "XFaceField", "YFaceField", "ZFaceField",
           "VelocityFields", "TracerFields", "FieldTimeSeriesForcing",
           "FieldTimeSeriesBoundaryCondition", "OpenBoundaryCondition",
           "PerturbationAdvection", "Simulation", "Callback",
           "NaNChecker", "TimeStepCallsite", "TendencyCallsite",
           "UpdateStateCallsite", "CFL", "AdvectiveCFL", "DiffusiveCFL",
           "StateChecker", "TimeStepWizard", "conjure_time_step_wizard",
           "FieldWriter", "AveragedTimeInterval", "WindowedTimeAverage",
           "NetCDFWriter", "NetCDF4Writer", "NetCDFOutputWriter",
           "HDF5Writer", "JLD2Writer", "Checkpointer", "checkpoint_grid",
           "FieldTimeSeries", "FieldDataset", "InMemory", "OnDisk",
           "written_names", "VarianceDissipation", "TimeInterval",
           "IterationInterval", "WallTimeInterval", "SpecifiedTimes",
           "FileSizeLimit", "AndSchedule", "OrSchedule", "prettytime",
           "second", "seconds", "minute", "minutes", "hour", "hours", "day",
           "days", "year", "meter", "meters", "kilometer", "kilometers",
           "KiB", "MiB", "GiB", "TiB"]

# the rest of the JAX package's flat namespace
__all__ += ["Accumulation", "Average", "BoundaryAdjacentMean",
            "BoundaryCondition", "BoundaryConditionField",
            "BoundaryConditionOperation", "Bounded", "BuoyancyField",
            "Center", "Clock", "ConditionalOperation",
            "ConformalCubedSpherePanel", "ConstantField",
            "CubedSpherePartition", "CumulativeIntegral", "Derivative",
            "DroguedParticleDynamics", "DynamicCoefficient", "EnsembleModel",
            "Equal", "ExplicitTimeDiscretization", "Face", "Flat",
            "FluxFormAdvection", "Forcing", "ForcingField",
            "ForcingOperation", "Fractional", "FunctionField",
            "GridMetricOperation", "HorizontalScalarBiharmonicDiffusivity",
            "Integral", "KernelFunctionOperation", "LagrangianParticles",
            "MultipleForcings", "OceananigansLogger", "OneField", "Periodic",
            "PiecewiseLinearMask", "PressureField",
            "QuasiAdamsBashforth2TimeStepper", "Reduction",
            "RungeKutta3TimeStepper", "Sizes", "SplitRungeKutta3TimeStepper",
            "TEOS10", "VerticalScalarBiharmonicDiffusivity", "XPartition",
            "YPartition", "ZeroField", "at", "cell_advection_timescale",
            "compute", "conditional_length", "diffusivity",
            "fill_halo_regions", "interior", "interpolate", "iteration",
            "iteration_limit_exceeded", "lambda_nodes", "lambda_spacing",
            "lambda_spacings", "minimum_xspacing", "minimum_yspacing",
            "minimum_zspacing", "nodes", "partial_x", "partial_y",
            "partial_z", "phi_nodes", "phi_spacing", "phi_spacings", "regrid",
            "rnodes", "rspacings", "run", "seawater_density", "set",
            "stop_time_exceeded", "time_step", "viscosity", "volume",
            "wall_time_limit_exceeded", "xarea", "xnodes", "xspacing",
            "xspacings", "yarea", "ynodes", "yspacing", "yspacings", "zarea",
            "znodes", "zspacing", "zspacings", "λnodes", "λspacing",
            "λspacings", "φnodes", "φspacing", "φspacings"]
