"""NetCDF4 output writer on h5py.

Counterpart of ``oceananigans_tpu/simulation/netcdf4_writer.py``, in its file
layout: a netCDF-4 file is an HDF5 file that follows the netCDF-4
conventions, so h5py writes it without libnetcdf. Dimensions are HDF5
dimension scales, the unlimited time axis a resizable dataset; each output
carries units and a long name, the file its global attributes. Appends on
pickup (``overwrite_existing=False``), windows outputs (``indices``) and
splits files (``file_splitting``) as the JAX writer does.

``h5py`` is imported when a writer is built, never when the package is: a
machine without it (the CUDA card's) raises ``ImportError`` there."""

from __future__ import annotations

import os
import shutil

import numpy as np

from ..utils.schedules import IterationInterval
from .hdf5_writer import import_h5py
from .output_writers import (fetch_output_tensor, is_shell_grid,
                             shell_node_tables, to_host)

# the default attributes of the common outputs
DEFAULT_ATTRIBUTES = {
    "u": {"long_name": "Velocity in the +x-direction", "units": "m/s"},
    "v": {"long_name": "Velocity in the +y-direction", "units": "m/s"},
    "w": {"long_name": "Velocity in the +z-direction", "units": "m/s"},
    "b": {"long_name": "Buoyancy", "units": "m/s²"},
    "T": {"long_name": "Conservative temperature", "units": "°C"},
    "S": {"long_name": "Absolute salinity", "units": "g/kg"},
    "e": {"long_name": "Turbulent kinetic energy", "units": "m²/s²"},
    "eta": {"long_name": "Free-surface displacement", "units": "m"},
    "p": {"long_name": "Pressure", "units": "m²/s²"},
    "c": {"long_name": "Passive tracer", "units": ""},
}

_AXIS = "xyz"


class NetCDF4Writer:
    """Scheduled NetCDF4 (HDF5) output of model fields.

    ``outputs`` maps variable names to field names, Fields or callables of
    the model; ``schedule`` gates the writes; ``overwrite_existing=False``
    appends to an existing file (the time axis continues from its length);
    ``indices`` ({name: tuple of slices}) cuts an output's interior;
    ``global_attributes`` and ``output_attributes`` merge over the
    defaults."""

    def __init__(self, model, outputs, filename, schedule=None,
                 overwrite_existing=True, global_attributes=None,
                 output_attributes=None, indices=None,
                 array_type=np.float32, file_splitting=None):
        self._h5py = import_h5py("NetCDF4Writer")
        if not filename.endswith(".nc"):
            filename = filename + ".nc"
        self.model = model
        self.outputs = dict(outputs)
        self.filename = filename
        self.schedule = schedule or IterationInterval(1)
        self.indices = indices or {}
        self.array_type = array_type
        # file splitting: a schedule (FileSizeLimit) checked after each
        # write; it closes the file and continues into <stem>_part<N>.nc
        self.file_splitting = file_splitting
        self._part = 1
        self._global_attributes = global_attributes
        attrs = dict(DEFAULT_ATTRIBUTES)
        for k, v in (output_attributes or {}).items():
            attrs[k] = {**attrs.get(k, {}), **v}
        self._out_attrs = attrs

        appending = (not overwrite_existing) and os.path.exists(filename)
        if appending:
            f = self._f = self._h5py.File(filename, "a", track_order=True)
            self._time = f["time"]
            self._n = self._time.shape[0]
            self._vars = {name: f[name] for name in self.outputs}
            if hasattr(self.file_splitting, "path"):
                self.file_splitting.path = filename
            return
        self._create_file(filename)

    def _create_file(self, filename):
        global_attributes = self._global_attributes
        self._f = self._h5py.File(filename, "w", track_order=True)
        f = self._f
        if hasattr(self.file_splitting, "path"):
            self.file_splitting.path = filename
        # netcdf-c's provenance attribute: tools recognize netCDF-4 by it
        f.attrs["_NCProperties"] = np.bytes_(
            b"version=2,netcdf=oceananigans_tpu_torch,hdf5=h5py")
        ga = {
            "Conventions": "CF-1.8",
            "source": "oceananigans_tpu_torch "
                      + type(self.model).__name__,
            "grid_type": type(self.model.grid).__name__,
            "schedule": type(self.schedule).__name__,
        }
        ga.update(global_attributes or {})
        for k, v in ga.items():
            f.attrs[k] = v

        self._time = f.create_dataset("time", shape=(0,), maxshape=(None,),
                                      chunks=(256,), dtype="f8")
        self._time.attrs["units"] = "seconds"
        self._time.attrs["long_name"] = "Time"
        self._time.make_scale("time")
        self._n = 0
        self._dims_cache = {}
        self._vars = {}
        for name, spec in self.outputs.items():
            sample = self._sample(name, spec)
            space_dims = self._space_dims(name, spec, sample)
            var = f.create_dataset(
                name, shape=(0,) + sample.shape,
                maxshape=(None,) + sample.shape,
                chunks=(1,) + sample.shape, dtype=self.array_type)
            var.dims[0].attach_scale(self._time)
            for axis, dname in enumerate(space_dims):
                if dname is not None:
                    var.dims[axis + 1].attach_scale(f[dname])
            for k, v in self._out_attrs.get(name, {}).items():
                var.attrs[k] = v
            self._vars[name] = var
            self._shell_coordinates(spec, sample, space_dims)

    # -- construction helpers -------------------------------------------------

    def _shell_coordinates(self, spec, sample, space_dims):
        """On a shell grid, the 2-D λ and φ (degrees) of the output's
        staggering, ``lambda_<xy>`` and ``phi_<xy>`` over its (x, y)
        dimensions."""
        if len(sample.shape) < 2 or self.indices:
            return
        loc = (self.model.loc(spec) if isinstance(spec, str)
               else getattr(spec, "loc", None)) or ("c", "c")
        key = f"{loc[0]}{loc[1]}"
        f = self._f
        for tname, table in shell_node_tables(self.model.grid,
                                              sample.shape[:2]).items():
            if not tname.endswith("_" + key) or tname in f:
                continue
            d = f.create_dataset(tname, data=table)
            d.attrs["units"] = "degrees"
            for axis in (0, 1):
                d.dims[axis].attach_scale(f[space_dims[axis]])

    def _resolve(self, spec):
        if isinstance(spec, str):
            return self.model.field(spec)
        return spec

    def _sample(self, name, spec):
        """The output on the host, cut by its ``indices`` on the device."""
        a = fetch_output_tensor(self._resolve(spec), self.model)
        idx = self.indices.get(name)
        return to_host(a[idx] if idx is not None else a)

    def _space_dims(self, name, spec, sample):
        """Create (or reuse) coordinate dimension-scale datasets matching
        the output's staggering; returns one dimension name per axis."""
        grid = self.model.grid
        loc = self.model.loc(spec) if isinstance(spec, str) else None
        loc = getattr(spec, "loc", None) or loc
        dims = []
        idx = self.indices.get(name)
        for axis, size in enumerate(sample.shape):
            lax = loc[axis] if loc is not None and axis < 3 else "c"
            dname = f"{_AXIS[axis % 3]}{'f' if lax == 'f' else 'c'}_{size}"
            if dname not in self._dims_cache:
                units = "m"
                if axis >= 3:
                    coords = np.arange(size, dtype=float)
                elif axis < 2 and is_shell_grid(grid):
                    # a shell grid's horizontal nodes are 2-D (the
                    # lambda_/phi_ datasets): x and y carry indices
                    coords, units = np.arange(size, dtype=float), "1"
                else:
                    coords = np.asarray(grid.nodes1d(axis, lax), float)
                if idx is not None and axis < len(idx):
                    coords = coords[idx[axis]]
                coords = np.asarray(coords, float)
                if coords.shape[0] < size:
                    coords = np.arange(size, dtype=float)
                d = self._f.create_dataset(dname, data=coords[:size])
                d.attrs["units"] = units
                d.attrs["long_name"] = (
                    f"{_AXIS[axis % 3]} location of "
                    f"{'cell faces' if lax == 'f' else 'cell centers'}")
                d.make_scale(dname)
                self._dims_cache[dname] = d
            dims.append(dname)
        return dims

    # -- writing ----------------------------------------------------------------

    def write(self, sim):
        model = sim.model
        i = self._n
        self._time.resize((i + 1,))
        self._time[i] = float(model.time)
        for name, spec in self.outputs.items():
            arr = self._sample(name, spec)
            var = self._vars[name]
            var.resize((i + 1,) + var.shape[1:])
            var[i] = arr.astype(self.array_type)
        self._n += 1
        self._f.flush()
        if self.file_splitting is not None \
                and self.file_splitting(model):
            self._split()

    def _split(self):
        """Close the current file and continue into the next part."""
        self._f.close()
        self._part += 1
        stem = self.filename[:-3]
        if self._part == 2:
            part1 = f"{stem}_part1.nc"
            shutil.move(self.filename, part1)
        self._dims_cache = {}
        self._create_file(f"{stem}_part{self._part}.nc")
        self._n = 0

    def maybe_write(self, sim, force=False):
        if force or self.schedule(sim.model):
            self.write(sim)

    def close(self):
        self._f.close()
