"""oceananigans_tpu_torch — the PyTorch and CUDA port of oceananigans_tpu.

The JAX package ``oceananigans_tpu`` is the reference; this package mirrors
its module paths. It covers the flagship run so far: ``NonhydrostaticModel``
on a regular RectilinearGrid with periodic x/y and bounded z, WENO(5)
advection, RK3, and the FFT/DCT pressure projection. Its hot path runs four
hand-written CUDA kernels (``kernels/``, sources in ``csrc/``), each beside a
plain PyTorch version that serves CPU tensors.

Layer map:

    grids/                 topology, coordinates, metrics, halos
    operators/             finite-volume stencil micro-ops
    boundary_conditions/   default BCs + halo filling
    fields/                Field wrapper and set
    advection/             Centered / UpwindBiased / WENO, flux divergences
    solvers/               FFT/DCT Poisson solver
    timesteppers/          RK3 coefficients
    models/                NonhydrostaticModel
    kernels/, csrc/        CUDA kernels and their plain versions
"""

from .defaults import defaults
from .grids import (RectilinearGrid, PERIODIC, BOUNDED, FLAT, CENTER, FACE)
from .advection import Centered, UpwindBiased, WENO
from .fields import Field
from .models import NonhydrostaticModel, state_from_jax

__all__ = ["defaults", "RectilinearGrid", "PERIODIC", "BOUNDED", "FLAT",
           "CENTER", "FACE", "Centered", "UpwindBiased", "WENO", "Field",
           "NonhydrostaticModel", "state_from_jax"]
