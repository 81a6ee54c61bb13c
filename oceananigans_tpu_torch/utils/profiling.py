"""Timing and tracing a model's step.

Counterpart of ``oceananigans_tpu/utils/profiling.py``::

    from oceananigans_tpu_torch.utils.profiling import profile_step, time_step
    time_step(model)                       # warm wall-clock seconds a step
    profile_step(model, logdir="trace")    # a torch.profiler trace

Both step a copy of the model's state and leave the state as it was. On a
CUDA grid they synchronize the card around the timed steps; on the CPU they
need no card.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from ..models.ensemble import clone_state


def _sync(model):
    device = torch.device(model.grid.device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(model, dt, steps):
    for _ in range(steps):
        model.time_step(dt)


def time_step(model, dt=None, steps=10, warmup=2):
    """Warm wall-clock seconds per step of ``model`` (``dt`` 1e-4 unless
    given), the card synchronized before the clock starts and after the
    last step."""
    dt = 1e-4 if dt is None else dt
    saved = model.state
    model.state = clone_state(saved)
    try:
        _run(model, dt, warmup)
        _sync(model)
        t0 = time.perf_counter()
        _run(model, dt, steps)
        _sync(model)
        return (time.perf_counter() - t0) / steps
    finally:
        model.state = saved


def profile_step(model, dt=None, steps=3, logdir=None):
    """A ``torch.profiler`` trace of ``steps`` steps (after one untraced
    step), written as ``trace.json`` (Chrome / Perfetto format) into
    ``logdir`` (``oceananigans_trace`` under the temporary directory by
    default); the card's kernels are traced on a CUDA grid. Returns the
    logdir."""
    from torch.profiler import ProfilerActivity, profile
    dt = 1e-4 if dt is None else dt
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "oceananigans_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(model.grid.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    saved = model.state
    model.state = clone_state(saved)
    try:
        _run(model, dt, 1)
        _sync(model)
        with profile(activities=activities) as prof:
            _run(model, dt, steps)
            _sync(model)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    finally:
        model.state = saved
    return logdir
