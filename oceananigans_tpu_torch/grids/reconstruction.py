"""Grid specs: what rebuilds a grid.

Counterpart of ``oceananigans_tpu/grids/reconstruction.py``.
``constructor_arguments(grid)`` is a JSON-able spec, key for key the JAX
package's for the same grid; ``reconstruct_grid(spec, device=)`` builds the
grid again on a device. The Checkpointer stores the spec beside the state.
RectilinearGrid and LatitudeLongitudeGrid only; other classes raise
``NotImplementedError``, as in JAX.

A spec written by a JAX *model* can carry that model's inflated halo (its y
halo rounded up to 8); ``reconstruct_grid(spec, halo=...)`` takes another
one, and a port model widens a grid's halo to what it needs anyway.
"""

from __future__ import annotations

import numpy as np

from ..defaults import numpy_dtype
from . import topology as topo


def _coord_spec(grid, axis):
    c = grid._coords[axis]
    if grid.topology[axis] == topo.FLAT:
        return None
    h, n = c.H, c.N
    if c.regular:
        return {"interval": [float(c.xF[h]), float(c.xF[h + n])]}
    return {"faces": [float(v) for v in c.xF[h:h + n + 1]]}


def constructor_arguments(grid):
    """The JSON-able spec :func:`reconstruct_grid` rebuilds ``grid`` from."""
    from .latlon import LatitudeLongitudeGrid
    from .rectilinear import RectilinearGrid

    if type(grid) not in (RectilinearGrid, LatitudeLongitudeGrid):
        raise NotImplementedError(
            f"constructor_arguments not implemented for {type(grid).__name__}")
    base = {
        "size": [int(n) for n in grid.N],
        "halo": [int(h) for h in grid.H],
        "topology": [str(t) for t in grid.topology],
        "dtype": np.dtype(numpy_dtype(grid.dtype)).name,
    }
    if type(grid) is RectilinearGrid:
        return dict(base, type="RectilinearGrid",
                    x=_coord_spec(grid, 0), y=_coord_spec(grid, 1),
                    z=_coord_spec(grid, 2))
    return dict(base, type="LatitudeLongitudeGrid",
                radius=float(grid.radius),
                longitude=_coord_spec(grid, 0),
                latitude=_coord_spec(grid, 1),
                z=_coord_spec(grid, 2))


def _coord_arg(spec):
    if spec is None:
        return None
    if "interval" in spec:
        return tuple(spec["interval"])
    return np.asarray(spec["faces"], float)


def reconstruct_grid(spec, device=None, halo=None):
    """Rebuild a grid from :func:`constructor_arguments` output, on
    ``device`` (the default device when None), with ``halo`` in place of
    the spec's when given."""
    from .latlon import LatitudeLongitudeGrid
    from .rectilinear import RectilinearGrid

    kind = spec["type"]
    common = dict(size=tuple(spec["size"]),
                  halo=tuple(spec["halo"] if halo is None else halo),
                  topology=tuple(spec["topology"]),
                  dtype=np.dtype(spec["dtype"]), device=device)
    if kind == "RectilinearGrid":
        return RectilinearGrid(x=_coord_arg(spec["x"]),
                               y=_coord_arg(spec["y"]),
                               z=_coord_arg(spec["z"]), **common)
    if kind == "LatitudeLongitudeGrid":
        return LatitudeLongitudeGrid(longitude=_coord_arg(spec["longitude"]),
                                     latitude=_coord_arg(spec["latitude"]),
                                     z=_coord_arg(spec["z"]),
                                     radius=spec["radius"], **common)
    raise ValueError(f"unknown grid type {kind!r}")
