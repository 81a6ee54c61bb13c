"""Calendar-time clocks.

Counterpart of ``oceananigans_tpu/utils/dateclock.py``. The model clock is a
host scalar of seconds; a model built with ``reference_datetime=`` exposes
``model.datetime`` = reference + seconds. Schedules, ``Simulation(stop_time=
...)`` and ``SpecifiedTimes`` take datetimes and timedeltas and convert them
against the model's reference."""

from __future__ import annotations

import datetime as _dt

import numpy as np

_DATETIME_TYPES = (_dt.datetime, _dt.date, np.datetime64)
_TIMEDELTA_TYPES = (_dt.timedelta, np.timedelta64)


def is_datetime(t):
    return isinstance(t, _DATETIME_TYPES)


def as_datetime64(t):
    """Normalize datetime/date/np.datetime64 to np.datetime64[ns]."""
    return np.datetime64(t, "ns")


def interval_seconds(interval):
    """A schedule interval as float seconds (accepts numbers, timedelta,
    np.timedelta64)."""
    if isinstance(interval, _TIMEDELTA_TYPES):
        return float(np.timedelta64(interval, "ns")
                     / np.timedelta64(1, "s"))
    return float(interval)


def seconds_since(t, reference_datetime):
    """``t`` as float model-seconds. Datetimes require the model to have a
    ``reference_datetime``; numbers pass through."""
    if is_datetime(t):
        if reference_datetime is None:
            raise ValueError(
                "a datetime was given but the model has no "
                "reference_datetime; construct the model with "
                "reference_datetime=... to use calendar times")
        delta = as_datetime64(t) - as_datetime64(reference_datetime)
        return float(delta / np.timedelta64(1, "s"))
    if isinstance(t, _TIMEDELTA_TYPES):
        return interval_seconds(t)
    return float(t)


def datetime_of(seconds, reference_datetime):
    """Model seconds -> np.datetime64 (None if no reference is set)."""
    if reference_datetime is None:
        return None
    return as_datetime64(reference_datetime) + np.timedelta64(
        int(round(float(seconds) * 1e9)), "ns")
