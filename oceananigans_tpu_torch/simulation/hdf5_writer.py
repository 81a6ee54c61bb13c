"""HDF5 output writer (the JLD2Writer analogue: JLD2 is an HDF5 container).

Counterpart of ``oceananigans_tpu/simulation/hdf5_writer.py``, in its file
layout: each output under ``timeseries/<name>/<iteration>``, the times under
``timeseries/t/<iteration>``, the grid's sizes, halos, topology and face
coordinates under ``grid``, and file splitting by size (``FileSizeLimit``
or ``max_filesize``) into ``<stem>_part<N><ext>``.

``h5py`` is imported when a writer is built, never when the package is: a
machine without it (the CUDA card's) raises ``ImportError`` there."""

from __future__ import annotations

import os

import numpy as np

from ..utils.schedules import FileSizeLimit
from .output_writers import fetch_output, shell_node_tables


def import_h5py(what):
    """The ``h5py`` module, or an ImportError naming ``what`` needs it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{what} needs h5py, which is not installed here; FieldWriter "
            "and NetCDFWriter (NetCDF-3 through scipy) need no HDF5") from e
    return h5py


class HDF5Writer:
    """Schedule-driven HDF5 serializer (JLD2Writer analogue).

    outputs: {name: field-name string | callable(model) -> array}
    """

    def __init__(self, model, outputs, filename, schedule=None,
                 overwrite=True, max_filesize=None, with_grid_metadata=True,
                 file_splitting=None):
        self._h5py = import_h5py("HDF5Writer")
        self.model = model
        self.outputs = dict(outputs)
        self.filename = filename
        self.schedule = schedule
        if file_splitting is not None:
            # file_splitting=FileSizeLimit(bytes), or a number of bytes
            max_filesize = getattr(file_splitting, "size_limit",
                                   file_splitting)
        self.max_filesize = max_filesize
        if isinstance(schedule, FileSizeLimit) and not schedule.path:
            schedule.path = filename
        self.part = 0
        if overwrite and os.path.exists(filename):
            os.remove(filename)
        if with_grid_metadata:
            self._write_metadata()

    # -- file management ----------------------------------------------------------

    def _current_path(self):
        if self.part == 0:
            return self.filename
        base, ext = os.path.splitext(self.filename)
        return f"{base}_part{self.part}{ext}"

    def _maybe_split(self):
        path = self._current_path()
        if (self.max_filesize is not None and os.path.exists(path)
                and os.path.getsize(path) > self.max_filesize):
            self.part += 1
            self._write_metadata()

    def _write_metadata(self):
        grid = self.model.grid
        with self._h5py.File(self._current_path(), "a") as f:
            g = f.require_group("grid")
            for k, v in (("Nx", grid.N[0]), ("Ny", grid.N[1]),
                         ("Nz", grid.N[2]), ("Hx", grid.H[0]),
                         ("Hy", grid.H[1]), ("Hz", grid.H[2])):
                g.attrs[k] = v
            g.attrs["topology"] = ",".join(grid.topology)
            tables = shell_node_tables(grid)
            for ax, nm in enumerate("xyz"):
                if not grid.is_flat(ax) and not (tables and ax < 2):
                    key = f"{nm}_faces"
                    if key not in g:
                        g[key] = np.asarray(grid.nodes1d(ax, "f"))
            for key, table in tables.items():
                if key not in g:
                    g[key] = table

    # -- writing -----------------------------------------------------------------

    def write(self, sim):
        model = sim.model if hasattr(sim, "model") else sim
        self._maybe_split()
        it = model.iteration
        with self._h5py.File(self._current_path(), "a") as f:
            tgrp = f.require_group("timeseries/t")
            if str(it) in tgrp:
                # an iteration written again (a pickup resumes at a written
                # step and the run's start forces a write) replaces it
                del tgrp[str(it)]
            tgrp[str(it)] = float(model.time)
            for name, spec in self.outputs.items():
                if isinstance(spec, str):
                    spec = model.field(spec)
                grp = f.require_group(f"timeseries/{name}")
                if str(it) in grp:
                    del grp[str(it)]
                grp[str(it)] = np.asarray(fetch_output(spec, model))

    def maybe_write(self, sim, force=False):
        if force or self.schedule is None or self.schedule(sim.model):
            self.write(sim)
