"""Pretty-printing utilities and unit constants.

Counterpart of ``oceananigans_tpu/utils/pretty.py`` (host-side, no tensors)."""

from __future__ import annotations

# Time units in seconds (reference: src/Units.jl)
second = 1.0
minute = 60.0
hour = 3600.0
day = 86400.0
year = 365 * day

KiB, MiB, GiB, TiB = 2.0 ** 10, 2.0 ** 20, 2.0 ** 30, 2.0 ** 40

seconds = second
minutes = minute
hours = hour
days = day

# Length units in meters (reference: src/Units.jl meters/kilometers)
meter = 1.0
meters = meter
kilometer = 1000.0
kilometers = kilometer


def prettytime(t):
    """Human-readable time, e.g. '1.500 days' (reference: prettytime)."""
    t = float(t)
    if t < 1e-6:
        return f"{t * 1e9:.3f} ns"
    if t < 1e-3:
        return f"{t * 1e6:.3f} μs"
    if t < 1:
        return f"{t * 1e3:.3f} ms"
    if t < minute:
        return f"{t:.3f} seconds"
    if t < hour:
        return f"{t / minute:.3f} minutes"
    if t < day:
        return f"{t / hour:.3f} hours"
    if t < year:
        return f"{t / day:.3f} days"
    return f"{t / year:.3f} years"


def pretty_filesize(s):
    for unit, name in ((TiB, "TiB"), (GiB, "GiB"), (MiB, "MiB"),
                       (KiB, "KiB")):
        if s >= unit:
            return f"{s / unit:.3f} {name}"
    return f"{s:.0f} bytes"
