"""Output writers.

Counterpart of ``oceananigans_tpu/simulation/output_writers.py``, in its
file format, so either package reads what the other wrote: a ``FieldWriter``
directory holds one ``<name>_<iteration>.npy`` per output and write, a
``series.json`` index (times, iterations, outputs) and a ``grid.json``.

An output is a Field, a prognostic field's name, or a callable of the model
returning a Field, a tensor, an array or a number. A writer copies each
output to the host when it writes (a window of it when ``indices`` is
given: the slice is cut on the device first). ``WindowedTimeAverage``
accumulates on the device and copies to the host once per output; the
weights follow JAX, so the averages agree to roundoff.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..fields.field import Field
from ..grids.topology import BOUNDED, FACE
from ..utils.dateclock import interval_seconds
from ..utils.schedules import (IterationInterval, TimeInterval,
                               time_tolerance)


def field_output(field):
    """A Field's interior as the JAX package writes it: N + 1 points along
    a face axis of a bounded direction. The z-compact layout keeps no slot
    for w's top boundary face, where w is 0; that face is appended."""
    a = field.interior
    grid = field.grid
    for ax in range(3):
        if (field.loc[ax] == FACE and grid.topology[ax] == BOUNDED
                and field.data.shape[ax] > 1 and a.shape[ax] == grid.N[ax]):
            a = torch.cat([a, torch.zeros_like(a.narrow(ax, 0, 1))], dim=ax)
    return a


def fetch_output_tensor(output, model):
    """One output as the model holds it (a tensor on its device, or what a
    callable returned); a Field's interior as ``field_output`` gives it."""
    if callable(output) and not hasattr(output, "interior"):
        output = output(model)
    if isinstance(output, Field):
        return field_output(output)
    if hasattr(output, "interior"):
        return output.interior
    return output


def is_shell_grid(grid):
    """Whether the horizontal nodes of ``grid`` (or of the grid under an
    immersed one) are 2-D: a shell grid."""
    return hasattr(getattr(grid, "underlying_grid", grid), "nodes2d_padded")


def shell_node_tables(grid, sizes=None):
    """The 2-D (λ, φ) degrees of a shell grid at the four horizontal
    staggerings, ``{"lambda_cc": (Nx, Ny), "phi_cc": ..., "lambda_fc": ...}``
    over the interior (N + 1 along a bounded face axis), or {} for a grid
    whose horizontal coordinates are 1-D. ``sizes`` = (nx, ny) keeps only
    the staggerings an output of that size can have."""
    if not is_shell_grid(grid):
        return {}
    base = getattr(grid, "underlying_grid", grid)
    out = {}
    for lx in "cf":
        for ly in "cf":
            n = [base.N[a] + (loc == "f" and base.topology[a] == "bounded")
                 for a, loc in enumerate((lx, ly))]
            if sizes is not None and tuple(n) != tuple(sizes):
                continue
            lam, phi = base.nodes2d_padded((lx, ly))
            sl = (slice(base.H[0], base.H[0] + n[0]),
                  slice(base.H[1], base.H[1] + n[1]))
            out[f"lambda_{lx}{ly}"] = lam[sl]
            out[f"phi_{lx}{ly}"] = phi[sl]
    return out


def to_host(a):
    """A tensor, array or number as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def fetch_output(output, model):
    """One output as a numpy array on the host."""
    return to_host(fetch_output_tensor(output, model))


class FieldWriter:
    """Append-only snapshot writer. ``outputs``: {name: Field, prognostic
    name or callable(model)}; ``indices``: a 3-tuple of slices and integers
    cutting each output of three or more dimensions (e.g. ``(slice(None),
    slice(None), -1)`` for the surface). ``with_halos`` is taken and
    ignored, as by the JAX writer: the interiors are written."""

    def __init__(self, model, outputs, path, schedule=None, overwrite=True,
                 with_halos=False, indices=None):
        self.model = model
        self.outputs = dict(outputs)
        self.path = path
        self.schedule = schedule or IterationInterval(1)
        self.with_halos = with_halos
        self.indices = tuple(indices) if indices is not None else None
        self._wta = None
        if isinstance(self.schedule, AveragedTimeInterval):
            self._wta = {
                name: WindowedTimeAverage(
                    (lambda m, s=spec: self._fetch(s, m)),
                    self.schedule.interval, self.schedule.window,
                    self.schedule.stride)
                for name, spec in self.outputs.items()}
        os.makedirs(path, exist_ok=True)
        self.index_file = os.path.join(path, "series.json")
        if overwrite or not os.path.exists(self.index_file):
            self.index = {"times": [], "iterations": [],
                          "outputs": list(self.outputs)}
            self._grid_metadata()
        else:
            with open(self.index_file) as f:
                self.index = json.load(f)

    def _grid_metadata(self):
        g = self.model.grid
        meta = dict(size=list(g.N), halo=list(g.H),
                    topology=list(getattr(g, "topology", ())),
                    extent=[float(e) for e in getattr(g, "extent", ())])
        with open(os.path.join(self.path, "grid.json"), "w") as f:
            json.dump(meta, f)
        tables = shell_node_tables(g)
        if tables:
            # a shell grid's horizontal coordinates are 2-D
            np.savez(os.path.join(self.path, "grid_nodes.npz"), **tables)

    def _resolve(self, spec):
        if isinstance(spec, str):
            return self.model.field(spec)
        return spec

    def _fetch(self, spec, model):
        """An output on the device, cut by ``indices``."""
        a = fetch_output_tensor(self._resolve(spec), model)
        if self.indices is not None and getattr(a, "ndim", 0) >= 3:
            a = a[self.indices]
        return a

    def _write_arrays(self, model, arrays):
        it = model.iteration
        wrote = False
        for name, arr in arrays.items():
            if arr is None:
                continue
            np.save(os.path.join(self.path, f"{name}_{it}.npy"),
                    to_host(arr))
            wrote = True
        if wrote:
            self.index["times"].append(model.time)
            self.index["iterations"].append(it)
            with open(self.index_file, "w") as f:
                json.dump(self.index, f)

    def write(self, sim):
        model = sim.model
        self._write_arrays(model, {name: self._fetch(spec, model)
                                   for name, spec in self.outputs.items()})

    def maybe_write(self, sim, force=False):
        if self._wta is not None:
            for w in self._wta.values():
                w.collect(sim.model)
            if self.schedule(sim.model):
                self._write_arrays(sim.model, {name: w.result()
                                               for name, w in
                                               self._wta.items()})
            elif force:
                # a forced (run-start) output of an averaging writer is
                # instantaneous and leaves the windows alone
                self.write(sim)
            return
        if force or self.schedule(sim.model):
            self.write(sim)


class AveragedTimeInterval(TimeInterval):
    """A TimeInterval whose outputs are time averages over the ``window``
    before each actuation: a writer given it as ``schedule=`` wraps every
    output in a :class:`WindowedTimeAverage`."""

    def __init__(self, interval, window=None, stride=1):
        super().__init__(interval)
        self.window = (self.interval if window is None
                       else interval_seconds(window))
        self.stride = int(stride)


class WindowedTimeAverage:
    """On-line time average of an output over the ``window`` before each
    output time, on the device: each sample weighs the model time since the
    previous one inside the window (left Riemann sum)."""

    def __init__(self, output, interval, window=None, stride=1):
        self.output = output
        self.interval = float(interval)
        self.window = float(window if window is not None else interval)
        self.stride = int(stride)
        self._accum = None
        self._wsum = 0.0
        self._calls = 0
        self._last_t = None
        self._next_output = None

    def _value(self, model):
        val = fetch_output_tensor(self.output, model)
        return val if isinstance(val, torch.Tensor) else torch.as_tensor(
            np.asarray(val))

    def collect(self, model):
        t = model.time
        tol = time_tolerance(model, self.interval, 1e-9 * self.interval)
        if self._next_output is None:
            self._next_output = t + self.interval
        # re-anchor after missed or forced actuations, so that the windows
        # stay on the schedule's grid
        while t > self._next_output + tol:
            self._next_output += self.interval
        window_start = self._next_output - self.window
        if t >= window_start - tol:
            self._calls += 1
            if (self._calls - 1) % self.stride:
                return          # every stride-th collection
            if self._last_t is None or self._last_t < window_start:
                w = max(t - window_start, 0.0)
            else:
                w = t - self._last_t
            self._last_t = t
            if w <= 0.0:
                # the sample at the window's start anchors it, with no
                # weight
                if self._accum is None:
                    self._accum = torch.zeros_like(self._value(model))
                return
            val = self._value(model)
            if self._accum is None:
                self._accum = torch.zeros_like(val)
            self._accum = self._accum + w * val
            self._wsum += w

    def result(self):
        """The average since the last result (a tensor on the device), or
        None if nothing was collected; starts the next window."""
        if not self._wsum:
            return None
        out = self._accum / self._wsum
        self._accum = None
        self._wsum = 0.0
        self._calls = 0
        self._last_t = None
        self._next_output += self.interval
        return out


# the NetCDF-3 writer lives in .netcdf_writer; one NetCDFWriter symbol
from .netcdf_writer import NetCDFWriter  # noqa: E402,F401
