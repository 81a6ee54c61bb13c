"""Global defaults: the dtype and device policy of the PyTorch port.

Counterpart of ``oceananigans_tpu/defaults.py``. Every grid and model takes an
explicit ``dtype=`` and ``device=``; these are only the values used when the
caller passes none. The default device is the CUDA card: a grid built without
``device=`` on a machine with no card raises (``resolve_device``) instead of
falling back to the CPU; tests and CPU runs pass ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Defaults:
    # Default element type for grids and fields. float64 is the reference
    # choice for parity runs; float32 is the speed choice on the GPU.
    FloatType: torch.dtype = torch.float32

    # Default device for grids and fields.
    device: str = "cuda"

    # Mean gravitational acceleration at Earth's surface [m/s²].
    gravitational_acceleration: float = 9.80665

    # Earth radius [m].
    planet_radius: float = 6_371_000.0

    # Earth rotation rate [s⁻¹].
    rotation_rate: float = 7.292115e-5


defaults = Defaults()


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def as_torch_dtype(dtype):
    """Normalize a torch, numpy or numpy-compatible float type to a torch
    dtype; ``None`` gives the default."""
    if dtype is None:
        return defaults.FloatType
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise ValueError(f"unsupported floating-point type {dtype!r}") from None


def numpy_dtype(dtype):
    """The numpy scalar type of a torch float dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[
        as_torch_dtype(dtype)]


def resolve_device(device):
    """The torch device for ``device`` (``None`` gives the default). A CUDA
    device on a machine without one raises: nothing falls back to the CPU."""
    dev = torch.device(device if device is not None else defaults.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default is "
            f"{defaults.device!r}) but no CUDA device is available; pass "
            "device=\"cpu\" to run on the CPU")
    return dev
