"""NetCDF output writer.

Counterpart of ``oceananigans_tpu/simulation/netcdf_writer.py``: a NetCDF-3
(classic) file through ``scipy.io.netcdf_file``, an unlimited time
dimension, and per output the dimensions (time, x, y, z) with the grid's
node coordinates at the output's staggering. The same file as the JAX
writer's for the same outputs; on a shell grid, whose horizontal nodes are
2-D, x and y carry their indices and each output's staggering adds the
variables ``lambda_<xy>`` and ``phi_<xy>`` (degrees, dimensions (x, y))."""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from ..utils.schedules import IterationInterval
from .output_writers import fetch_output, shell_node_tables


class NetCDFWriter:
    def __init__(self, model, outputs, filename, schedule=None,
                 overwrite_existing=True):
        self.model = model
        self.outputs = dict(outputs)
        self.filename = filename
        self.schedule = schedule or IterationInterval(1)
        self._n = 0
        self._f = netcdf_file(filename, "w", version=2)
        f = self._f
        f.createDimension("time", None)
        grid = model.grid
        self._time = f.createVariable("time", "d", ("time",))
        self._vars = {}
        self._dims_cache = {}

        def dim_for(axis, size, loc):
            # the staggering is part of the key: face and centre outputs of
            # one size do not share coordinates
            key = (axis, size, loc)
            if key in self._dims_cache:
                return self._dims_cache[key]
            name = f"{'xyz'[axis]}_{loc}{size}"
            f.createDimension(name, size)
            var = f.createVariable(name, "d", (name,))
            try:
                var[:] = np.asarray(grid.nodes1d(axis, loc))[:size]
            except (IndexError, ValueError):
                # an output whose axes are not the grid's: its indices
                var[:] = np.arange(size, dtype=float)
            self._dims_cache[key] = name
            return name

        for name, spec in self.outputs.items():
            sample = fetch_output(self._resolve(spec), model)
            dims = ("time",)
            for axis, size in enumerate(sample.shape):
                loc = "c"
                fld = getattr(spec, "loc", None)
                if isinstance(spec, str):
                    fld = model.loc(spec)
                if fld is not None:
                    loc = fld[axis]
                dims = dims + (dim_for(axis, size, loc),)
            self._vars[name] = f.createVariable(name, "f", dims)
            if len(sample.shape) >= 2:
                locs = getattr(spec, "loc", None) or (
                    model.loc(spec) if isinstance(spec, str) else ("c", "c"))
                key = f"{locs[0]}{locs[1]}"
                for tname, table in shell_node_tables(
                        grid, sample.shape[:2]).items():
                    if tname.endswith("_" + key) and tname not in f.variables:
                        var = f.createVariable(tname, "d", dims[1:3])
                        var[:] = table

    def _resolve(self, spec):
        if isinstance(spec, str):
            return self.model.field(spec)
        return spec

    def write(self, sim):
        model = sim.model
        i = self._n
        self._time[i] = model.time
        for name, spec in self.outputs.items():
            arr = fetch_output(self._resolve(spec), model)
            self._vars[name][i] = arr.astype(np.float32)
        self._n += 1
        self._f.flush()

    def maybe_write(self, sim, force=False):
        if force or self.schedule(sim.model):
            self.write(sim)

    def close(self):
        self._f.close()
