"""RectilinearGrid: Cartesian grid with regular or stretched spacing.

Counterpart of ``oceananigans_tpu/grids/rectilinear.py``. Coordinates are
numpy float64, as in the JAX package; the grid also carries the ``dtype``
and ``device`` of the fields built on it. A regular axis gives its spacing
as a Python float; a stretched one (an array of N + 1 face positions, a
callable of the face index, or a discretization of ``grids/stretching.py``)
gives a broadcastable tensor of the grid's dtype on its device, formed from
the float64 metric (``metric_numpy``), with the end spacings extrapolated
into the halos.

    RectilinearGrid(size=(64, 64, 64), extent=(1.0, 2.0, 3.0),
                    dtype=torch.float32)      # z in (-Lz, 0), on the card
    RectilinearGrid(size=(8, 8, 8), x=(0, 1), y=(0, 1),
                    z=ExponentialDiscretization(8, -100, 0), device="cpu")

``device`` defaults to ``"cuda"``; without a card, pass ``device="cpu"``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..defaults import as_torch_dtype, resolve_device
from . import topology as topo
from .base import AbstractGrid, MetricCache, broadcastable_1d

_AXES = ("x", "y", "z")


class _Coordinate:
    """One direction's discretization: regular (an interval, a scalar
    spacing) or stretched (N + 1 face positions, or a callable of the face
    index), with padded coordinate and spacing arrays covering the halo
    region; a stretched axis extrapolates its end spacings into the
    halos."""

    __slots__ = ("N", "H", "topology", "regular", "delta", "origin",
                 "xF", "xC", "dC", "dF", "_fp")

    def __init__(self, N, H, topology, interval=None, delta=None,
                 faces=None):
        self.N = int(N)
        self.H = int(H)
        self.topology = topology
        self.regular = True

        if topology == topo.FLAT:
            self.delta = 1.0
            self.origin = 0.0
            self.xF = np.zeros(2)
            self.xC = np.full(1, 0.5)
            self.dC = np.ones(1)
            self.dF = np.ones(2)
            self._fp = (N, H, topology)
            return

        Npad = self.N + 2 * self.H
        if faces is None:
            a, b = float(interval[0]), float(interval[1])
            self.delta = (b - a) / self.N if delta is None else float(delta)
            self.origin = a
            # padded faces: indices -H .. N+H (length Npad + 1)
            idx = np.arange(-self.H, self.N + self.H + 1, dtype=np.float64)
            xF = a + idx * self.delta
        else:
            self.regular = False
            self.delta = None
            if callable(faces):
                f = np.asarray([faces(k) for k in range(self.N + 1)],
                               dtype=np.float64)
            else:
                f = np.asarray(faces, dtype=np.float64)
            if f.shape != (self.N + 1,):
                raise ValueError(f"face array must have length N+1="
                                 f"{self.N + 1}, got {f.shape}")
            if np.any(np.diff(f) <= 0):
                raise ValueError("face positions must be strictly increasing")
            self.origin = float(f[0])
            dl, dr = f[1] - f[0], f[-1] - f[-2]
            xF = np.concatenate([f[0] - dl * np.arange(self.H, 0, -1), f,
                                 f[-1] + dr * np.arange(1, self.H + 1)])
        self.xF = xF
        self.xC = 0.5 * (xF[:-1] + xF[1:])
        self.dC = np.diff(xF)
        dF = np.empty(Npad + 1)
        dF[1:-1] = np.diff(self.xC)
        dF[0] = dF[1]
        dF[-1] = dF[-2]
        self.dF = dF
        self._fp = ((self.N, self.H, topology, self.delta, self.origin)
                    if self.regular else (self.N, self.H, topology,
                                          xF.tobytes()))

    def spacing(self, loc):
        """A float on a regular axis, else the padded spacings at 'c' (cell
        widths) or 'f' (centre to centre, Npad entries)."""
        if self.regular:
            return self.delta
        return self.dC if loc == topo.CENTER else self.dF[:-1]

    def spec(self):
        """The coordinate as a constructor takes it: None (flat), the
        interval, or the interior face positions."""
        if self.topology == topo.FLAT:
            return None
        if self.regular:
            return (self.origin, self.origin + self.extent)
        return self.xF[self.H:self.H + self.N + 1].copy()

    def coord(self, loc):
        """Padded coordinates at 'c' or 'f' (length Npad)."""
        return self.xC if loc == topo.CENTER else self.xF[:-1]

    @property
    def extent(self):
        if self.topology == topo.FLAT:
            return 0.0
        return float(self.xF[self.N + self.H] - self.xF[self.H])


def _is_interval(spec):
    return (isinstance(spec, tuple) and len(spec) == 2
            and np.isscalar(spec[0]) and np.isscalar(spec[1]))


def coordinate(N, H, topology, spec):
    """The ``_Coordinate`` of an interval or a stretched specification."""
    if topology == topo.FLAT:
        return _Coordinate(1, 0, topo.FLAT)
    if _is_interval(spec):
        return _Coordinate(N, H, topology, interval=spec)
    return _Coordinate(N, H, topology, faces=spec)


def _cut_coordinate(c, n, offset):
    """The coordinate of ``n`` cells of ``c`` starting at its interior cell
    ``offset``, with ``c``'s halo: its padded arrays cut from ``c``'s."""
    if c.topology == topo.FLAT or (offset == 0 and n == c.N):
        return c
    if offset < 0 or offset + n > c.N:
        raise ValueError(f"cells {offset}..{offset + n} outside 0..{c.N}")
    out = copy.copy(c)
    out.N = n
    npad = n + 2 * c.H
    out.xF = c.xF[offset:offset + npad + 1].copy()
    out.xC = c.xC[offset:offset + npad].copy()
    out.dC = c.dC[offset:offset + npad].copy()
    out.dF = c.dF[offset:offset + npad + 1].copy()
    out.origin = float(out.xF[c.H])
    out._fp = ((n, c.H, c.topology, c.delta, out.origin) if c.regular
               else (n, c.H, c.topology, out.xF.tobytes()))
    return out


def spacing_metric(c, axis, loc):
    """A coordinate's spacing at ``loc`` as the JAX grids form it: a float,
    or a float64 array broadcastable along ``axis``."""
    s = c.spacing(loc)
    return s if np.isscalar(s) else broadcastable_1d(s, axis)


class RectilinearGrid(MetricCache, AbstractGrid):
    def __init__(self, size=None, extent=None, x=None, y=None, z=None,
                 topology=None, halo=None, dtype=None, device=None):
        if topology is None:
            topology = (topo.PERIODIC, topo.PERIODIC, topo.BOUNDED)
        self.topology = topo.validate_topology(topology)
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)

        nonflat = [i for i in range(3) if self.topology[i] != topo.FLAT]
        if size is None:
            raise ValueError("RectilinearGrid requires `size`")
        if np.isscalar(size):
            size = (size,)
        size = tuple(int(s) for s in size)
        if len(size) == 3:
            N = list(size)
            for i in range(3):
                if self.topology[i] == topo.FLAT and N[i] != 1:
                    raise ValueError(f"size must be 1 along flat dimension {i}")
        elif len(size) == len(nonflat):
            N = [1, 1, 1]
            for i, s in zip(nonflat, size):
                N[i] = s
        else:
            raise ValueError(f"size {size} incompatible with topology {self.topology}")

        if halo is None:
            halo = tuple(3 if self.topology[i] != topo.FLAT else 0 for i in range(3))
        elif np.isscalar(halo):
            halo = tuple(int(halo) if self.topology[i] != topo.FLAT else 0
                         for i in range(3))
        else:
            halo = tuple(halo)
            if len(halo) == len(nonflat) and len(nonflat) != 3:
                full = [0, 0, 0]
                for i, h in zip(nonflat, halo):
                    full[i] = h
                halo = tuple(full)
        self.N = tuple(N)
        self.H = tuple(int(h) for h in halo)

        specs = {"x": x, "y": y, "z": z}
        if extent is not None:
            if any(v is not None for v in specs.values()):
                raise ValueError("pass either `extent` or `x`/`y`/`z`, not both")
            if np.isscalar(extent):
                extent = (extent,)
            if len(extent) != len(nonflat):
                raise ValueError("extent length must match number of non-flat dims")
            Ls = dict(zip([_AXES[i] for i in nonflat], extent))
            for ax, L in Ls.items():
                specs[ax] = (-L, 0.0) if ax == "z" else (0.0, L)

        self._coords = []
        for i, ax in enumerate(_AXES):
            spec = specs[ax]
            if self.topology[i] == topo.FLAT:
                self._coords.append(_Coordinate(1, 0, topo.FLAT))
                continue
            if spec is None:
                raise ValueError(f"missing coordinate spec for non-flat direction {ax}")
            self._coords.append(coordinate(self.N[i], self.H[i],
                                           self.topology[i], spec))
        self._cache = {}

    # -- regularity queries ---------------------------------------------------

    def regular(self, axis):
        return self._coords[axis].regular

    @property
    def all_regular(self):
        return all(c.regular for c in self._coords)

    @property
    def stretched_axes(self):
        return tuple(i for i in range(3)
                     if not self._coords[i].regular and not self.is_flat(i))

    # -- metrics --------------------------------------------------------------

    def metric_numpy(self, name, loc):
        """The float64 value of metric ``name`` (dx, dy, dz, Ax, Ay, Az, V)
        at ``loc``: a float, or a broadcastable array on a stretched axis."""
        if name in ("dx", "dy", "dz"):
            axis = "xyz".index(name[1])
            return spacing_metric(self._coords[axis], axis, loc[axis])
        d = {n: self.metric_numpy(n, loc) for n in ("dx", "dy", "dz")}
        if name == "Ax":
            return d["dy"] * d["dz"]
        if name == "Ay":
            return d["dx"] * d["dz"]
        if name == "Az":
            return d["dx"] * d["dy"]
        if name == "V":
            return (d["dx"] * d["dy"]) * d["dz"]
        raise ValueError(f"unknown metric {name!r}")

    # -- coordinates / nodes --------------------------------------------------

    def coord_padded(self, axis, loc):
        """Padded 1D coordinate array along ``axis`` at location ``loc``."""
        return self._coords[axis].coord(loc)

    def nodes1d(self, axis, loc):
        """Interior coordinates along ``axis``: N values at centers, N+1 at
        faces when Bounded."""
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

    @property
    def extent(self):
        return tuple(c.extent for c in self._coords)

    def minimum_spacing(self, axis):
        c = self._coords[axis]
        if c.topology == topo.FLAT:
            return np.inf
        if c.regular:
            return c.delta
        h, n = self.H[axis], self.N[axis]
        return float(np.min(c.dC[h:h + n]))

    def _rebuild(self, halo, dtype, device):
        specs = {ax: c.spec() for ax, c in zip(_AXES, self._coords)}
        return RectilinearGrid(size=self.N, x=specs["x"], y=specs["y"],
                               z=specs["z"], topology=self.topology,
                               halo=halo, dtype=dtype, device=device)

    def with_halo(self, halo):
        """This grid with a new halo size."""
        if tuple(halo) == self.H:
            return self
        return self._rebuild(halo, self.dtype, self.device)

    def local_grid(self, size, device=None, offset=(0, 0)):
        """One shard's grid: ``size`` = (nx, ny, nz) interior cells whose
        first cell is this grid's interior cell ``offset`` = (ox, oy), with
        this grid's halo, topology and dtype, on ``device`` (default: this
        grid's). Its coordinates and spacings are this grid's, cut at the
        offset, so the shard's nodes and metrics equal this grid's exactly;
        z is never sharded and is carried whole, stretched or not. A
        stretched x or y is not sharded (ROADMAP.md item 16b)."""
        size = tuple(int(n) for n in size)
        for ax in (0, 1):
            if not self._coords[ax].regular and size[ax] != self.N[ax]:
                raise NotImplementedError(
                    "a sharded stretched horizontal axis: ROADMAP.md queue "
                    "1 item 16b")
        if size[2] != self.N[2]:
            raise ValueError("z is never sharded: the local grid keeps Nz")
        local = copy.copy(self)
        local._cache = {}
        local.N = size
        local.device = self.device if device is None else torch.device(device)
        local._coords = [_cut_coordinate(c, n, o) for c, n, o in zip(
            self._coords, size, tuple(offset) + (0,))]
        return local

    def to(self, device=None, dtype=None):
        """This grid with fields on another device and/or of another dtype."""
        device = self.device if device is None else torch.device(device)
        dtype = self.dtype if dtype is None else as_torch_dtype(dtype)
        if device == self.device and dtype == self.dtype:
            return self
        return self._rebuild(self.H, dtype, device)

    # -- hashing --------------------------------------------------------------

    def _fingerprint(self):
        return ("RectilinearGrid", self.N, self.H, self.topology,
                str(self.dtype), str(self.device),
                tuple(c._fp for c in self._coords),
                getattr(self, "connected", None))

    def __repr__(self):
        topo_s = "×".join(t.capitalize() for t in self.topology)
        return (f"RectilinearGrid(size={self.N}, halo={self.H}, "
                f"topology=({topo_s}), extent={self.extent}, "
                f"dtype={self.dtype}, device={self.device})")
