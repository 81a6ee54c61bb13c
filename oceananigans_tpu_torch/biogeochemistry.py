"""Biogeochemistry: the hooks a model calls.

Counterpart of ``oceananigans_tpu/biogeochemistry.py``. A biogeochemistry
adds its required tracers to a model, a reaction (source) term to each
tracer's tendency, a drift (sinking) velocity that advects a tracer, and
``update_state(model)``, run on the host after each step:

    required_tracers: tuple of names
    tracer_tendency(grid, name, fields, time) -> padded tensor or 0
    drift_velocity(name) -> (u, v, w) scalars or padded tensors, or None
    update_state(model) -> None
"""

from __future__ import annotations

import torch

from .grids.base import broadcastable_1d


class Biogeochemistry:
    """The base class: subclass and override."""

    required_tracers = ()

    def tracer_tendency(self, grid, name, fields, time):
        return 0.0

    def drift_velocity(self, name):
        return None

    def update_state(self, model):
        return None


class SimpleBiogeochemistry(Biogeochemistry):
    """Continuous-form reactions: ``reactions[name]`` is ``f(x, y, z, t,
    **tracers)`` of the padded cell-centre coordinates (broadcastable
    tensors of the grid's dtype and device), the time and the required
    tracers' padded tensors by name; ``drift[name]`` a sinking w."""

    def __init__(self, tracers=(), reactions=None, drift=None):
        self.required_tracers = tuple(tracers)
        self.reactions = dict(reactions or {})
        self.drift = dict(drift or {})

    def tracer_tendency(self, grid, name, fields, time):
        f = self.reactions.get(name)
        if f is None:
            return 0.0
        coords = [torch.as_tensor(broadcastable_1d(grid.coord_padded(ax, "c"),
                                                   ax),
                                  dtype=grid.dtype, device=grid.device)
                  for ax in range(3)]
        kwargs = {n: fields[n] for n in self.required_tracers if n in fields}
        return f(*coords, time, **kwargs)

    def drift_velocity(self, name):
        w = self.drift.get(name)
        if w is None:
            return None
        return (0.0, 0.0, w)


def drift_tendency(grid, scheme, drift, c):
    """-∇·(𝐮_drift c) of a tracer's padded tensor ``c`` with the model's
    advection scheme, for ``drift`` = (u, v, w) scalars or padded
    tensors."""
    from .advection import div_Uc
    du, dv, dw = [torch.full(grid.padded_shape, float(q), dtype=grid.dtype,
                             device=grid.device)
                  if not isinstance(q, torch.Tensor) else q for q in drift]
    return -div_Uc(grid, scheme, du, dv, dw, c)
