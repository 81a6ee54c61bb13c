"""LatitudeLongitudeGrid: a spherical-shell grid with exact spherical metrics.

Counterpart of ``oceananigans_tpu/grids/latlon.py``:

    Δx(λ-loc, φ-loc) = R cos(φ) Δλ          (varies with latitude)
    Δy               = R Δφ
    Az               = R² Δλ (sin φ⁺ - sin φ⁻)   (exact cell area)

Longitude λ and latitude φ are in degrees, z in meters. The metrics are
computed in numpy float64 exactly as the JAX grid computes them, then held as
tensors of the grid's dtype on its device: a metric that varies with
latitude is a (1, Ny + 2Hy, 1) tensor, a constant one a Python float. Any
coordinate may be stretched (N + 1 face positions, a callable of the face
index, or a discretization of ``grids/stretching.py``); its metrics then
vary along that axis too.

The default topology is that of the JAX grid: bounded latitude, and a
longitude that is periodic when it spans 360° and bounded otherwise. A
latitude range that ends at a pole sets ``polar_south`` or ``polar_north``:
the fields' conditions on that side become polar caps
(``boundary_conditions.PolarBoundaryCondition``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..defaults import as_torch_dtype, defaults, resolve_device
from . import topology as topo
from .base import AbstractGrid, MetricCache
from .rectilinear import _cut_coordinate, coordinate, spacing_metric

DEG = np.pi / 180.0


class LatitudeLongitudeGrid(MetricCache, AbstractGrid):
    def __init__(self, size=None, longitude=None, latitude=None, z=None,
                 radius=None, topology=None, halo=None, dtype=None,
                 device=None):
        self.radius = float(radius if radius is not None
                            else defaults.planet_radius)
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        if topology is None:
            lon_span = None
            if isinstance(longitude, tuple):
                lon_span = longitude[1] - longitude[0]
            tx = topo.PERIODIC if (lon_span is not None
                                   and np.isclose(lon_span, 360)) \
                else topo.BOUNDED
            tz = topo.BOUNDED if z is not None else topo.FLAT
            topology = (tx, topo.BOUNDED, tz)
        self.topology = topo.validate_topology(topology)

        nonflat = [i for i in range(3) if self.topology[i] != topo.FLAT]
        size = tuple(int(s) for s in (size if not np.isscalar(size)
                                      else (size,)))
        if len(size) == len(nonflat) and len(size) != 3:
            N = [1, 1, 1]
            for i, s in zip(nonflat, size):
                N[i] = s
        else:
            N = list(size)
        self.N = tuple(N)

        if halo is None:
            halo = tuple(3 if self.topology[i] != topo.FLAT else 0
                         for i in range(3))
        elif np.isscalar(halo):
            halo = tuple(int(halo) if self.topology[i] != topo.FLAT else 0
                         for i in range(3))
        else:
            halo = tuple(int(h) for h in halo)
            if len(halo) != 3:
                if len(halo) != len(nonflat):
                    raise ValueError(
                        f"halo must have 3 or {len(nonflat)} entries")
                full = [0, 0, 0]
                for i, h in zip(nonflat, halo):
                    full[i] = h
                halo = tuple(full)
        self.H = tuple(halo)

        self._coords = [coordinate(self.N[a], self.H[a], self.topology[a],
                                   spec)
                        for a, spec in enumerate((longitude, latitude, z))]
        self._lam, self._phi, self._zc = self._coords

        phi_f = np.asarray(self._phi.coord(topo.FACE))
        H1, N1 = self.H[1], self.N[1]
        if np.any(np.abs(phi_f[H1:H1 + N1 + 1]) > 90 + 1e-9):
            raise ValueError("latitude extent exceeds ±90°")
        bounded_y = self.topology[1] == topo.BOUNDED
        self.polar_south = bool(bounded_y and np.isclose(phi_f[H1], -90.0))
        self.polar_north = bool(bounded_y
                                and np.isclose(phi_f[H1 + N1], 90.0))
        self._cache = {}

    # -- coordinates (degrees for λ and φ) ------------------------------------

    def coord_padded(self, axis, loc):
        return self._coords[axis].coord(loc)

    def nodes1d(self, axis, loc):
        c = self._coords[axis]
        n, h = self.N[axis], self.H[axis]
        if loc == topo.FACE and self.topology[axis] == topo.BOUNDED:
            return c.xF[h:h + n + 1]
        return c.coord(loc)[h:h + n]

    def xnodes(self, loc="c"):
        return self.nodes1d(0, loc)

    def ynodes(self, loc="c"):
        return self.nodes1d(1, loc)

    def znodes(self, loc="c"):
        return self.nodes1d(2, loc)

    lambda_nodes = xnodes
    phi_nodes = ynodes

    def lambda_spacings(self, loc="c"):
        """The longitude spacings in degrees."""
        return self._lam.spacing(loc)

    def phi_spacings(self, loc="c"):
        """The latitude spacings in degrees."""
        return self._phi.spacing(loc)

    def nodes(self, loc=topo.LOC_CCC):
        return tuple(self.nodes1d(i, loc[i]) for i in range(3))

    @property
    def extent(self):
        return tuple(c.extent for c in self._coords)

    def regular(self, axis):
        return self._coords[axis].regular

    @property
    def all_regular(self):
        return False   # Δx varies with latitude: no FFT along y

    @property
    def stretched_axes(self):
        return tuple(i for i in range(3)
                     if not self._coords[i].regular and not self.is_flat(i))

    # -- metrics, float64 numpy as the JAX grid forms them ---------------------

    def _cosphi(self, yloc):
        phi = self._phi.coord(yloc)
        cos = np.cos(np.clip(phi, -90.0, 90.0) * DEG)
        return np.maximum(cos, 1e-12).reshape(1, -1, 1)

    def _angle_rad(self, axis, loc):
        """A longitude or latitude spacing in radians: a float, or a
        broadcastable array on a stretched axis."""
        return spacing_metric(self._coords[axis], axis, loc) * DEG

    def metric_numpy(self, name, loc):
        """The float64 value of metric ``name`` (dx, dy, dz, Ax, Ay, Az, V)
        at ``loc``: a float, or a broadcastable array (a (1, Ny + 2Hy, 1)
        one for a metric that varies with latitude alone). A shard's grid
        (``local_grid``) cuts the global grid's tables at its offset."""
        parent = getattr(self, "_metric_parent", None)
        if parent is not None:
            return self._cut_metric(parent, name, loc)
        if name == "dx":
            return self.radius * self._cosphi(loc[1]) * self._angle_rad(
                0, loc[0])
        if name == "dy":
            return self.radius * self._angle_rad(1, loc[1])
        if name == "dz":
            return spacing_metric(self._zc, 2, loc[2])
        if name == "Ax":
            return self.metric_numpy("dy", loc) * self.metric_numpy("dz", loc)
        if name == "Ay":
            return self.metric_numpy("dx", loc) * self.metric_numpy("dz", loc)
        if name == "Az":
            npad = self.N[1] + 2 * self.H[1]
            if loc[1] == topo.CENTER:
                phi_minus = self._phi.xF[:npad]
                phi_plus = self._phi.xF[1:npad + 1]
            else:
                xC = self._phi.xC
                phi_minus = np.empty(npad)
                phi_minus[1:] = xC[:npad - 1]
                phi_minus[0] = xC[0] - (xC[1] - xC[0])
                phi_plus = xC[:npad]
            sin_d = np.sin(np.clip(phi_plus, -90, 90) * DEG) \
                - np.sin(np.clip(phi_minus, -90, 90) * DEG)
            sin_d = np.maximum(sin_d, 1e-15)
            return (self.radius ** 2 * np.asarray(self._angle_rad(0, loc[0]))
                    * sin_d.reshape(1, -1, 1))
        if name == "V":
            return self.metric_numpy("Az", loc) * np.asarray(
                self.metric_numpy("dz", loc))
        raise ValueError(f"unknown metric {name!r}")

    def _cut_metric(self, parent, name, loc):
        grid, offset = parent
        m = grid.metric_numpy(name, loc)
        if np.ndim(m) == 0:
            return m
        m = np.asarray(m)
        sl = tuple(slice(o, o + n + 2 * h) if m.shape[ax] > 1 else slice(None)
                   for ax, (o, n, h) in enumerate(zip(
                       tuple(offset) + (0,), self.N, self.H)))
        return m[sl]

    def local_grid(self, size, device=None, offset=(0, 0)):
        """One shard's grid: ``size`` = (nx, ny, nz) interior cells whose
        first cell is this grid's interior cell ``offset`` = (ox, oy), with
        this grid's halo, topology and dtype, on ``device`` (default: this
        grid's). Its coordinates are this grid's cut at the offset and its
        metrics this grid's tables cut there, so every cell of the shard
        sees this grid's nodes and metrics exactly, on a stretched
        longitude or latitude too; z is carried whole. A polar cap stays
        only on the shards at its pole (``polar_south``, ``polar_north``)."""
        size = tuple(int(n) for n in size)
        if size[2] != self.N[2]:
            raise ValueError("z is never sharded: the local grid keeps Nz")
        local = copy.copy(self)
        local._cache = {}
        local.N = size
        local.device = self.device if device is None else torch.device(device)
        local._coords = [_cut_coordinate(c, n, o) for c, n, o in zip(
            self._coords, size, tuple(offset) + (0,))]
        local._lam, local._phi, local._zc = local._coords
        local._metric_parent = (self, tuple(offset))
        local.polar_south = self.polar_south and offset[1] == 0
        local.polar_north = self.polar_north and \
            offset[1] + size[1] == self.N[1]
        return local

    def minimum_spacing(self, axis):
        if self.is_flat(axis):
            return np.inf
        if axis == 0:
            h, n = self.H[1], self.N[1]
            return float(np.min(np.asarray(self.metric_numpy(
                "dx", topo.LOC_CCC))[:, h:h + n, :]))
        metric = self.metric_numpy("dy" if axis == 1 else "dz", topo.LOC_CCC)
        if np.isscalar(metric):
            return float(metric)
        h, n = self.H[axis], self.N[axis]
        return float(np.min(np.asarray(metric).reshape(-1)[h:h + n]))

    # -- copies ---------------------------------------------------------------

    def _rebuild(self, halo, dtype, device):
        return LatitudeLongitudeGrid(
            size=self.N, longitude=self._lam.spec(),
            latitude=self._phi.spec(), z=self._zc.spec(), radius=self.radius, topology=self.topology,
            halo=halo, dtype=dtype, device=device)

    def with_halo(self, halo):
        if tuple(halo) == self.H:
            return self
        return self._rebuild(halo, self.dtype, self.device)

    def to(self, device=None, dtype=None):
        device = self.device if device is None else torch.device(device)
        dtype = self.dtype if dtype is None else as_torch_dtype(dtype)
        if device == self.device and dtype == self.dtype:
            return self
        return self._rebuild(self.H, dtype, device)

    def _fingerprint(self):
        return ("LatitudeLongitudeGrid", self.N, self.H, self.topology,
                self.radius, str(self.dtype), str(self.device),
                tuple(c._fp for c in self._coords),
                getattr(self, "connected", None))

    def __repr__(self):
        return (f"LatitudeLongitudeGrid(size={self.N}, halo={self.H}, "
                f"longitude=({self._lam.origin:g}, "
                f"{self._lam.origin + self._lam.extent:g}), latitude=("
                f"{self._phi.origin:g}, {self._phi.origin + self._phi.extent:g}"
                f"), dtype={self.dtype}, device={self.device})")
