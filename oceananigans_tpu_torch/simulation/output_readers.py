"""Output readers: FieldTimeSeries and FieldDataset.

Counterpart of ``oceananigans_tpu/simulation/output_readers.py``. A
``FieldTimeSeries`` reads one output of a FieldWriter directory (either
package's) or of a NetCDF4Writer file, with the ``InMemory`` backend (every
snapshot loaded at once, on ``device``) or ``OnDisk`` (each snapshot loaded
when first asked for, then kept on ``device``).

``at_time(t)`` interpolates linearly between the two snapshots around ``t``
(clamped to the first and last): the model time is a host float in the
port, so the two indices and the weight are picked on the host and only the
interpolation runs on the device. ``FieldTimeSeriesForcing`` and
``FieldTimeSeriesBoundaryCondition`` call it at each stage's time.

Reading a NetCDF4 file needs ``h5py``, imported on use; the card's machine
has none, so read a FieldWriter dataset there.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..defaults import resolve_device


def InMemory():
    """Backend marker: every snapshot loaded when the series is built."""
    return "in_memory"


def OnDisk():
    """Backend marker: each snapshot loaded when first needed."""
    return "on_disk"


def _is_netcdf(path):
    return os.path.isfile(path) and not path.endswith(".json")


class FieldTimeSeries:
    """Snapshots of one output (``name``) at the times the writer recorded,
    as tensors on ``device`` (the default device when None)."""

    def __init__(self, path, name, backend="in_memory", device=None):
        if callable(backend):
            backend = backend()
        self.path = path
        self.name = name
        self.backend = backend
        self.device = resolve_device(device)
        self._cache = {}
        self.coordinates = None
        self.attributes = {}
        self._nc = None
        if _is_netcdf(path):
            self._init_netcdf(path, name, backend)
            return
        with open(os.path.join(path, "series.json")) as f:
            index = json.load(f)
        if name not in index["outputs"]:
            raise KeyError(f"{name!r} not among outputs {index['outputs']}")
        self.times = np.asarray(index["times"], float)
        self.iterations = list(index["iterations"])
        self._data = (self._tensor(np.stack([
            self._load(i) for i in range(len(self.iterations))]))
            if backend == "in_memory" else None)
        try:
            with open(os.path.join(path, "grid.json")) as f:
                self.grid_meta = json.load(f)
        except FileNotFoundError:
            self.grid_meta = None

    def _tensor(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _init_netcdf(self, path, name, backend):
        from .hdf5_writer import import_h5py
        h5py = import_h5py("FieldTimeSeries of a NetCDF4 file")
        f = h5py.File(path, "r")
        if name not in f:
            avail = [k for k in f.keys() if k != "time"]
            f.close()
            raise KeyError(f"{name!r} not among outputs {avail}")
        self.times = np.asarray(f["time"][:], float)
        self.iterations = list(range(len(self.times)))
        var = f[name]
        self.attributes = {k: v for k, v in var.attrs.items()}
        # the coordinates of the attached dimension scales (axis 0: time)
        coords = []
        for axis in range(1, var.ndim):
            scales = var.dims[axis]
            coords.append(np.asarray(scales[0][:], float)
                          if len(scales) else None)
        self.coordinates = coords
        self.grid_meta = {k: v for k, v in f.attrs.items()
                          if not k.startswith("_")}
        if backend == "in_memory":
            self._data = self._tensor(var[:])
            f.close()
        else:
            self._data = None
            self._nc = f         # per-snapshot reads keep the file open

    def _load(self, idx):
        if self._nc is not None:
            return np.asarray(self._nc[self.name][idx])
        it = self.iterations[idx]
        return np.load(os.path.join(self.path, f"{self.name}_{it}.npy"))

    def __len__(self):
        return len(self.iterations)

    def __getitem__(self, idx):
        """The snapshot at time index ``idx``, a tensor on ``device``."""
        if self._data is not None:
            return self._data[idx]
        idx = range(len(self))[idx]
        if idx not in self._cache:
            self._cache[idx] = self._tensor(self._load(idx))
        return self._cache[idx]

    def at_time(self, t):
        """The series linearly interpolated to time ``t`` (a host float),
        clamped to the first and last snapshots."""
        times = self.times
        nt = len(times)
        if nt == 1:
            return self[0]
        t = min(max(float(t), times[0]), times[-1])
        j = int(np.clip(np.searchsorted(times, t), 1, nt - 1))
        i = j - 1
        w = float((t - times[i]) / (times[j] - times[i]))
        return (1 - w) * self[i] + w * self[j]

    # the JAX package's name for the interpolation inside a step
    traced = at_time

    def __call__(self, t):
        return self.at_time(t)


def written_names(path):
    """The output names of a FieldWriter dataset or a NetCDF4Writer file."""
    if _is_netcdf(path):
        from .hdf5_writer import import_h5py
        h5py = import_h5py("written_names of a NetCDF4 file")
        with h5py.File(path, "r") as f:
            return [k for k in f
                    if f[k].attrs.get("CLASS") != b"DIMENSION_SCALE"]
    with open(os.path.join(path, "series.json")) as f:
        return list(json.load(f)["outputs"])


class FieldDataset(dict):
    """Every output of a dataset as {name: FieldTimeSeries}, by item or by
    attribute."""

    def __init__(self, path, backend="in_memory", device=None):
        super().__init__()
        for name in written_names(path):
            self[name] = FieldTimeSeries(path, name, backend=backend,
                                         device=device)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e
