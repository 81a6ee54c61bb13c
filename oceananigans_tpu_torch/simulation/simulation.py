"""Simulation: the host-side run loop around the model's step.

Counterpart of ``oceananigans_tpu/simulation/simulation.py``: stop criteria
(iteration, time, wall time), Δt shrunk to land on the writers' and
callbacks' schedules and on ``stop_time``, callbacks, diagnostics and output
writers between steps, and ``run(pickup=)`` from a checkpoint.

The loop is plain Python around ``model.time_step(dt)``; the clock and the
schedules live on the host, so the loop itself waits for the device only
where something reads a tensor on the host: the NaN check (every 100
iterations by default), the time-step wizard, and the writers.

The NaN check differs from the JAX one on purpose: JAX samples about 4,096
points of the interior; the port tests every interior point with one
device reduction, as Oceananigans.jl's NaNChecker does."""

from __future__ import annotations

import time as _time

import torch

from ..utils.dateclock import interval_seconds, seconds_since
from ..utils.schedules import IterationInterval, Schedule


class Callback:
    def __init__(self, func, schedule=None):
        self.func = func
        self.schedule = schedule or IterationInterval(1)

    def maybe_call(self, sim):
        if self.schedule(sim.model):
            self.func(sim)


class NaNChecker:
    """Abort the run when a monitored field holds a NaN anywhere in its
    interior (the first prognostic field by default: u, or uh for shallow
    water)."""

    def __init__(self, fields=None):
        self.fields = fields

    def __call__(self, sim):
        names = self.fields
        if names is None:
            st = sim.model.state
            avail = st["fields"] if "fields" in st else \
                {k: v for k, v in st.items() if getattr(v, "ndim", 0) >= 2}
            names = ("u",) if "u" in avail else (next(iter(avail)),)
        for name in names:
            # the interior only: a fused step may leave its halo slots
            # stale until the next fill
            data = sim.model.field(name).interior
            if bool(torch.isnan(data).any()):
                sim.running = False
                raise RuntimeError(
                    f"time = {sim.model.time}, iteration = "
                    f"{sim.model.iteration}: NaN found in field {name!r}. "
                    "Aborting simulation.")


class Simulation:
    def __init__(self, model, dt, stop_time=None, stop_iteration=None,
                 wall_time_limit=None, verbose=False):
        self.model = model
        self.dt = interval_seconds(dt)
        if stop_time is not None:
            stop_time = seconds_since(
                stop_time, getattr(model, "reference_datetime", None))
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.wall_time_limit = wall_time_limit
        self.verbose = verbose
        self.callbacks = {}
        self.output_writers = {}
        self.diagnostics = {}
        self.running = True
        self.initialized = False
        self.run_wall_time = 0.0
        self.add_callback(NaNChecker(), IterationInterval(100),
                          name="nan_checker")

    # -- registration ---------------------------------------------------------

    def add_callback(self, func, schedule=None, name=None, callsite=None):
        from .callsites import TendencyCallsite, UpdateStateCallsite
        if callsite is not None and not isinstance(callsite, type):
            callsite = type(callsite)
        if callsite is TendencyCallsite:
            # a hook inside every step; the schedule does not apply
            self.model.add_tendency_hook(func)
            return func
        if callsite is UpdateStateCallsite:
            self.model.add_state_hook(func)
            return func
        cb = Callback(func, schedule)
        name = name or f"callback{len(self.callbacks)}"
        self.callbacks[name] = cb
        return cb

    def add_output_writer(self, writer, name=None):
        name = name or f"writer{len(self.output_writers)}"
        self.output_writers[name] = writer
        return writer

    # -- stepping -------------------------------------------------------------

    def _aligned_dt(self):
        """Δt shrunk to land on the writers' and callbacks' schedules and
        on ``stop_time``."""
        dt = self.dt
        for w in self.output_writers.values():
            sched = getattr(w, "schedule", None)
            if isinstance(sched, Schedule):
                dt = sched.aligned_time_step(self.model, dt)
        for cb in self.callbacks.values():
            dt = cb.schedule.aligned_time_step(self.model, dt)
        if self.stop_time is not None:
            remaining = self.stop_time - self.model.time
            if remaining > 1e-6 * self.dt:
                dt = min(dt, remaining)
        return dt

    def _stop_criteria(self):
        if self.stop_iteration is not None \
                and self.model.iteration >= self.stop_iteration:
            return "stop_iteration"
        if self.stop_time is not None \
                and self.model.time >= self.stop_time - 1e-6 * self.dt:
            # a tolerance relative to Δt: a float32 clock can never come
            # within an absolute 1e-12 of most stop times
            return "stop_time"
        if self.wall_time_limit is not None \
                and self.run_wall_time >= self.wall_time_limit:
            return "wall_time_limit"
        return None

    def initialize(self):
        for cb in self.callbacks.values():
            cb.schedule.initialize(self.model)
            init = getattr(cb.func, "initialize", None)
            if callable(init):
                init(self)
        for d in self.diagnostics.values():
            sched = getattr(d, "schedule", None)
            if isinstance(sched, Schedule):
                sched.initialize(self.model)
        for w in self.output_writers.values():
            sched = getattr(w, "schedule", None)
            if isinstance(sched, Schedule):
                sched.initialize(self.model)
            if hasattr(w, "initialize"):
                w.initialize(self)
            w.maybe_write(self, force=True)
        self.initialized = True

    def step(self):
        dt = self._aligned_dt()
        self.model.time_step(dt)
        for cb in self.callbacks.values():
            cb.maybe_call(self)
        # diagnostics: callables of the simulation, on their ``schedule``
        # when they carry one
        for d in self.diagnostics.values():
            if hasattr(d, "maybe_call"):
                d.maybe_call(self)
                continue
            sched = getattr(d, "schedule", None)
            if sched is None or sched(self.model):
                d(self)
        for w in self.output_writers.values():
            w.maybe_write(self)

    def run(self, pickup=False):
        """Run until a stop criterion holds. ``pickup``: True restores the
        newest checkpoint of the registered Checkpointers, a path that
        file."""
        if pickup:
            from .checkpointer import Checkpointer, restore_latest
            cps = [w for w in self.output_writers.values()
                   if isinstance(w, Checkpointer)]
            restore_latest(self.model, pickup, checkpointers=cps)
        if not self.initialized:
            self.initialize()
        self.running = True
        t0 = _time.monotonic()
        while self.running:
            reason = self._stop_criteria()
            if reason is not None:
                if self.verbose:
                    print(f"Simulation is stopping ({reason}).")
                break
            self.step()
            self.run_wall_time = _time.monotonic() - t0
        for cb in self.callbacks.values():
            fin = getattr(cb.func, "finalize", None)
            if callable(fin):
                fin(self)
        return self
