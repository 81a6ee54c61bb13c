"""Schedules: when callbacks, writers and diagnostics act.

Counterpart of ``oceananigans_tpu/utils/schedules.py``. Schedules are host
objects: they read the model's clock, which the port keeps on the host
(numpy scalars in ``state["clock"]``), so consulting one never waits for the
device.

One deliberate difference: ``TimeInterval`` and ``SpecifiedTimes`` compare
the clock with their actuation times within 1e-12 s, as in JAX, on a float64
clock, and within four float32 ulps of max(|t|, interval) on a float32
clock (``WindowedTimeAverage`` likewise, beside its 1e-9 of the interval). A
float32 clock cannot land within 1e-12 s of most times, so the JAX schedule
would miss the actuation and shrink the next Δt to the remainder (tens of
picoseconds), which the pressure projection then divides by."""

from __future__ import annotations

import os
import time as _time

import numpy as np


def time_tolerance(model, scale, slack=1e-12):
    """The slack of a comparison of the model's clock with a schedule time:
    ``slack`` (the JAX package's) on a float64 clock; on a float32 one at
    least four ulps of max(|t|, ``scale``)."""
    clock = model.state["clock"]["time"]
    if np.result_type(clock) != np.float32:
        return slack
    return max(slack, 4 * float(np.finfo(np.float32).eps)
               * max(abs(model.time), abs(scale)))


class Schedule:
    def initialize(self, model):
        return None

    def aligned_time_step(self, model, dt):
        """Optionally shrink dt so the next actuation lands exactly."""
        return dt

    def __and__(self, other):
        return AndSchedule(self, other)

    def __or__(self, other):
        return OrSchedule(self, other)


class TimeInterval(Schedule):
    """Actuates every ``interval`` of model time (a number of seconds, a
    ``datetime.timedelta`` or an ``np.timedelta64``)."""

    def __init__(self, interval):
        from .dateclock import interval_seconds
        self.interval = interval_seconds(interval)
        self.previous_actuation_time = None

    def initialize(self, model):
        self.previous_actuation_time = model.time

    def __call__(self, model):
        t = model.time
        if self.previous_actuation_time is None:
            self.previous_actuation_time = t
            return True
        if t >= self.previous_actuation_time + self.interval \
                - time_tolerance(model, self.interval):
            # align to the schedule grid
            n = round((t - self.previous_actuation_time) / self.interval)
            self.previous_actuation_time += max(n, 1) * self.interval
            return True
        return False

    def aligned_time_step(self, model, dt):
        if self.previous_actuation_time is None:
            return dt
        next_t = self.previous_actuation_time + self.interval
        return min(dt, max(next_t - model.time, 1e-12))


class IterationInterval(Schedule):
    def __init__(self, interval, offset=0):
        self.interval = int(interval)
        self.offset = offset

    def __call__(self, model):
        return (model.iteration + self.offset) % self.interval == 0


class WallTimeInterval(Schedule):
    def __init__(self, interval):
        self.interval = float(interval)
        self.previous = _time.monotonic()

    def __call__(self, model):
        now = _time.monotonic()
        if now - self.previous >= self.interval:
            self.previous = now
            return True
        return False


class SpecifiedTimes(Schedule):
    """Actuates at the given model times — numbers of seconds, or datetimes
    when the model carries a ``reference_datetime``."""

    def __init__(self, *times):
        from .dateclock import is_datetime
        if len(times) == 1 and np.iterable(times[0]) \
                and not is_datetime(times[0]):
            times = tuple(times[0])
        self._raw = times
        self.times = None
        self._next = 0

    def _resolve(self, model):
        if self.times is None:
            from .dateclock import seconds_since
            ref = getattr(model, "reference_datetime", None)
            self.times = sorted(seconds_since(t, ref) for t in self._raw)
        return self.times

    def __call__(self, model):
        times = self._resolve(model)
        if self._next >= len(times):
            return False
        if model.time >= times[self._next] - time_tolerance(
                model, times[self._next]):
            self._next += 1
            return True
        return False

    def aligned_time_step(self, model, dt):
        times = self._resolve(model)
        if self._next >= len(times):
            return dt
        return min(dt, max(times[self._next] - model.time, 1e-12))


class FileSizeLimit(Schedule):
    """Actuates when the file at ``path`` reaches ``size_limit`` bytes (the
    writer sets ``path``; also taken as a writer's ``file_splitting``)."""

    def __init__(self, size_limit, path=""):
        self.size_limit = float(size_limit)
        self.path = path

    def __call__(self, model):
        return (bool(self.path) and os.path.exists(self.path)
                and os.path.getsize(self.path) >= self.size_limit)


class AndSchedule(Schedule):
    def __init__(self, *schedules):
        self.schedules = schedules

    def initialize(self, model):
        for s in self.schedules:
            s.initialize(model)

    def __call__(self, model):
        return all(s(model) for s in self.schedules)


class OrSchedule(Schedule):
    def __init__(self, *schedules):
        self.schedules = schedules

    def initialize(self, model):
        for s in self.schedules:
            s.initialize(model)

    def __call__(self, model):
        return any(s(model) for s in self.schedules)

    def aligned_time_step(self, model, dt):
        return min(s.aligned_time_step(model, dt) for s in self.schedules)
