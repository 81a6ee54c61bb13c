"""Callback callsites.

Counterpart of ``oceananigans_tpu/simulation/callsites.py``.
``TimeStepCallsite`` callbacks (the default) run on the host after each
completed step, on their schedule. ``TendencyCallsite`` and
``UpdateStateCallsite`` callbacks run inside every step, as model hooks:

    TendencyCallsite:     fn(grid, fields, G, time) -> G
    UpdateStateCallsite:  fn(grid, fields, time) -> {name: padded tensor}

``fields`` are the model's padded tensors (index them through
``grid.interior_slices``); ``G`` holds the tendencies (interior-shaped in
the NonhydrostaticModel, padded in the HydrostaticFreeSurfaceModel);
``time`` is a Python float. They act at every step: a schedule does not
apply."""

from __future__ import annotations


class TimeStepCallsite:
    """Host callback after each completed time step (the default)."""


class TendencyCallsite:
    """Hook over the tendencies, after forcing and the boundary fluxes and
    before the time-stepper update."""


class UpdateStateCallsite:
    """Hook over the prognostic fields at the end of each step."""
