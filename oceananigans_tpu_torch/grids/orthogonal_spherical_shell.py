"""OrthogonalSphericalShellGrid: a curvilinear horizontal grid on the sphere
with 2-D metrics, and the RotatedLatitudeLongitudeGrid generator.

Counterpart of ``oceananigans_tpu/grids/orthogonal_spherical_shell.py``.
The grid is built from 2-D arrays of CORNER ((f, f)-point) longitude and
latitude in degrees, shape (Nx + 1, Ny + 1), and a vertical specification
(an interval or a stretched one, as ``RectilinearGrid`` takes it). Every
horizontal metric comes from great-circle distances between adjacent
corners, edge midpoints and centres, and the z-normal areas from spherical
quadrilateral excesses, in float64 numpy exactly as the JAX grid forms
them; ``metric_numpy`` returns them, padded over the halos (wrapped on a
periodic axis, edge-replicated otherwise) as (Nx + 2Hx, Ny + 2Hy, 1)
arrays, and ``dx``, ``dy``, ``Az`` … the same as tensors of the grid's dtype
on its device. The horizontal axes are index-regular: advection
reconstructs in index space along x and y, and with the stretched
coefficients only along a stretched z.

``nodes2d`` and ``nodes2d_padded`` give the true (λ, φ) nodes at any
horizontal staggering; ``coord_padded`` along x or y gives the centre lines
of the 2-D tables, as the JAX grid does. The port evaluates every callable
of the horizontal coordinates (``set``, forcing, boundary fluxes, bottom
heights) on the true nodes.

``rotation_angle_ccc`` gives the angle between the grid's x direction and
geographic east at the cell centres; ``rotate_to_geographic`` and
``rotate_from_geographic`` turn intrinsic velocity components into
east/north ones and back. Its halo columns wrap along a periodic x (the
JAX function extends the edge columns there).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..defaults import as_torch_dtype, defaults, resolve_device
from . import topology as topo
from .base import AbstractGrid, MetricCache
from .rectilinear import coordinate, spacing_metric

DEG = np.pi / 180.0


def _sph2cart(lam, phi):
    lam, phi = np.asarray(lam) * DEG, np.asarray(phi) * DEG
    return np.stack([np.cos(phi) * np.cos(lam), np.cos(phi) * np.sin(lam),
                     np.sin(phi)], axis=-1)


def _cart2sph(xyz):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return np.rad2deg(np.arctan2(y, x)), np.rad2deg(
        np.arcsin(np.clip(z, -1, 1)))


def _gc_distance(p1, p2, radius):
    """Great-circle distance between unit vectors p1, p2."""
    dots = np.clip(np.sum(p1 * p2, axis=-1), -1.0, 1.0)
    return radius * np.arccos(dots)


def _midpoint(p1, p2):
    m = p1 + p2
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def _spherical_triangle_excess(a, b, c):
    """Solid angle of the triangle of unit vectors (a, b, c):
    E = 2 atan2(|a·(b×c)|, 1 + a·b + b·c + c·a)."""
    num = np.abs(np.einsum("...i,...i->...", a, np.cross(b, c)))
    den = (1.0 + np.einsum("...i,...i->...", a, b)
           + np.einsum("...i,...i->...", b, c)
           + np.einsum("...i,...i->...", c, a))
    return 2.0 * np.arctan2(num, den)


def _spherical_quad_area(p00, p10, p11, p01):
    """Unit-sphere area of the quad (two triangle excesses)."""
    return (_spherical_triangle_excess(p00, p10, p11)
            + _spherical_triangle_excess(p00, p11, p01))


def _expand_halo(halo, topology):
    if halo is None:
        return tuple(3 if topology[i] != topo.FLAT else 0 for i in range(3))
    if np.isscalar(halo):
        return tuple(int(halo) if topology[i] != topo.FLAT else 0
                     for i in range(3))
    halo = tuple(int(h) for h in halo)
    if len(halo) == 3:
        return halo
    nonflat = [i for i in range(3) if topology[i] != topo.FLAT]
    if len(halo) != len(nonflat):
        raise ValueError(f"halo must have 3 or {len(nonflat)} entries")
    full = [0, 0, 0]
    for i, h in zip(nonflat, halo):
        full[i] = h
    return tuple(full)


class OrthogonalSphericalShellGrid(MetricCache, AbstractGrid):
    def __init__(self, corner_longitude, corner_latitude, z=None, size=None,
                 radius=None, topology=None, halo=None, dtype=None,
                 device=None, corner_halo=0):
        """``corner_halo=h``: the corner tables are extended, covering the
        padded horizontal extent (the interior nodes and ``h`` rows of halo
        nodes on each side, taken from the surrounding mesh, e.g. the
        neighbouring cubed-sphere panels), so that every metric, lengths
        and areas at every staggering, is exact in the halos instead of
        edge-replicated."""
        self.radius = float(radius if radius is not None
                            else defaults.planet_radius)
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        lamF = np.asarray(corner_longitude, float)
        phiF = np.asarray(corner_latitude, float)
        nxp1, nyp1 = lamF.shape
        ch = self._corner_halo = int(corner_halo)
        Nx, Ny = nxp1 - 1 - 2 * ch, nyp1 - 1 - 2 * ch
        Nz = 1 if z is None else (size[2] if size else None)
        if z is not None and Nz is None:
            raise ValueError("pass size=(Nx, Ny, Nz) with a vertical spec")
        if topology is None:
            topology = (topo.BOUNDED, topo.BOUNDED,
                        topo.BOUNDED if z is not None else topo.FLAT)
        self.topology = topo.validate_topology(topology)
        self.N = (Nx, Ny, Nz if z is not None else 1)
        self.H = _expand_halo(halo, self.topology)
        if ch and (self.H[0] != ch or self.H[1] != ch):
            raise ValueError("corner_halo must equal the horizontal halos")
        self._zc = coordinate(self.N[2], self.H[2], self.topology[2], z)

        P = _sph2cart(lamF, phiF)                       # (Nx+1, Ny+1, 3)
        Pxm = _midpoint(P[:-1, :], P[1:, :])            # (c, f) (Nx, Ny+1)
        Pym = _midpoint(P[:, :-1], P[:, 1:])            # (f, c) (Nx+1, Ny)
        Pc = _midpoint(Pxm[:, :-1], Pxm[:, 1:])         # (c, c) (Nx, Ny)
        R = self.radius
        # the metric tables span the corner tables' extent: the interior,
        # or the padded extent under corner_halo
        mx, my = nxp1 - 1, nyp1 - 1
        dx_cc = _gc_distance(Pym[:-1, :], Pym[1:, :], R)
        dx_fc = np.empty((mx + 1, my))
        dx_fc[1:-1] = _gc_distance(Pc[:-1, :], Pc[1:, :], R)
        dx_fc[0] = dx_fc[1]
        dx_fc[-1] = dx_fc[-2]
        dx_cf = _gc_distance(P[:-1, :], P[1:, :], R)
        dx_ff = np.empty((mx + 1, my + 1))
        dx_ff[1:-1] = _gc_distance(Pxm[:-1, :], Pxm[1:, :], R)
        dx_ff[0] = dx_ff[1]
        dx_ff[-1] = dx_ff[-2]

        dy_cc = _gc_distance(Pxm[:, :-1], Pxm[:, 1:], R)
        dy_cf = np.empty((mx, my + 1))
        dy_cf[:, 1:-1] = _gc_distance(Pc[:, :-1], Pc[:, 1:], R)
        dy_cf[:, 0] = dy_cf[:, 1]
        dy_cf[:, -1] = dy_cf[:, -2]
        dy_fc = _gc_distance(P[:, :-1], P[:, 1:], R)
        dy_ff = np.empty((mx + 1, my + 1))
        dy_ff[:, 1:-1] = _gc_distance(Pym[:, :-1], Pym[:, 1:], R)
        dy_ff[:, 0] = dy_ff[:, 1]
        dy_ff[:, -1] = dy_ff[:, -2]

        self._dx = {("c", "c"): dx_cc, ("f", "c"): dx_fc,
                    ("c", "f"): dx_cf, ("f", "f"): dx_ff}
        self._dy = {("c", "c"): dy_cc, ("f", "c"): dy_fc,
                    ("c", "f"): dy_cf, ("f", "f"): dy_ff}
        lam_c, phi_c = _cart2sph(Pc)
        # the coordinate tables keep the interior extent
        inner = (slice(ch, ch + Nx), slice(ch, ch + Ny))
        outer = (slice(ch, ch + Nx + 1), slice(ch, ch + Ny + 1))
        self._lam = {("c", "c"): lam_c[inner], ("f", "f"): lamF[outer]}
        self._phi = {("c", "c"): phi_c[inner], ("f", "f"): phiF[outer]}
        self._ext_corners = (lamF, phiF) if ch else None

        az_cc = _spherical_quad_area(P[:-1, :-1], P[1:, :-1],
                                     P[1:, 1:], P[:-1, 1:]) * R * R
        az_fc = np.empty((mx + 1, my))
        az_fc[1:-1] = 0.5 * (az_cc[:-1] + az_cc[1:])
        az_fc[0], az_fc[-1] = az_cc[0], az_cc[-1]
        az_cf = np.empty((mx, my + 1))
        az_cf[:, 1:-1] = 0.5 * (az_cc[:, :-1] + az_cc[:, 1:])
        az_cf[:, 0], az_cf[:, -1] = az_cc[:, 0], az_cc[:, -1]
        az_ff = np.empty((mx + 1, my + 1))
        az_ff[1:-1, :] = 0.5 * (az_cf[:-1, :] + az_cf[1:, :])
        az_ff[0, :], az_ff[-1, :] = az_cf[0, :], az_cf[-1, :]
        if ch:
            # at a cube vertex (three panels meet) the diagonal halo quads
            # and edges are slivers of about zero measure: no stencil that
            # reaches an interior cell reads them; raise them to the table's
            # largest value so that whole-array divisions stay finite there
            for group in (self._dx, self._dy,
                          {("c", "c"): az_cc, ("f", "c"): az_fc,
                           ("c", "f"): az_cf, ("f", "f"): az_ff}):
                for tbl in group.values():
                    big = tbl.max()
                    np.copyto(tbl, big, where=tbl < 1e-6 * big)
        self._az = {("c", "c"): az_cc, ("f", "c"): az_fc,
                    ("c", "f"): az_cf, ("f", "f"): az_ff}
        self._pad_cache = {}
        self._cache = {}

    # -- metrics --------------------------------------------------------------

    def _padded2d(self, table, lx, ly):
        """A horizontal metric table cropped to N entries per axis (the
        uniform padded layout) and padded over the halos: wrapped on a
        periodic axis, edge-replicated otherwise; (npx, npy, 1)."""
        key = (id(table), lx, ly)
        if key not in self._pad_cache and self._corner_halo:
            # the extended tables span the padded extent already; the "+1"
            # staggered rows are cut to the uniform padded layout
            npx, npy = self.padded_shape[:2]
            self._pad_cache[key] = table[(lx, ly)][:npx, :npy, None]
        if key not in self._pad_cache:
            arr = table[(lx, ly)][:self.N[0], :self.N[1]]
            mode_x = "wrap" if self.topology[0] == topo.PERIODIC else "edge"
            mode_y = "wrap" if self.topology[1] == topo.PERIODIC else "edge"
            out = np.pad(arr, [(self.H[0],) * 2, (0, 0)], mode=mode_x)
            out = np.pad(out, [(0, 0), (self.H[1],) * 2], mode=mode_y)
            self._pad_cache[key] = out[..., None]
        return self._pad_cache[key]

    def metric_numpy(self, name, loc):
        """The float64 value of metric ``name`` (dx, dy, dz, Ax, Ay, Az, V)
        at ``loc``: (npx, npy, 1) arrays for the horizontal ones, a float or
        a (1, 1, npz) array for Δz, their products for the others. A
        shard's grid (``local_grid``) cuts the global grid's tables."""
        if self._shell_parent is not None and name in ("dx", "dy", "Az"):
            grid, _ = self._shell_parent
            return self._cut_xy(grid.metric_numpy(name, loc))
        if name == "dx":
            return self._padded2d(self._dx, loc[0], loc[1])
        if name == "dy":
            return self._padded2d(self._dy, loc[0], loc[1])
        if name == "Az":
            return self._padded2d(self._az, loc[0], loc[1])
        if name == "dz":
            return spacing_metric(self._zc, 2, loc[2])
        if name == "Ax":
            return self.metric_numpy("dy", loc) * self.metric_numpy("dz", loc)
        if name == "Ay":
            return self.metric_numpy("dx", loc) * self.metric_numpy("dz", loc)
        if name == "V":
            return self.metric_numpy("Az", loc) * self.metric_numpy("dz", loc)
        raise ValueError(f"unknown metric {name!r}")

    # -- nodes ----------------------------------------------------------------

    def coord_padded(self, axis, loc):
        """Padded coordinates along ``axis``: z, or the centre line of the
        2-D longitude (x) or latitude (y) table, as the JAX grid gives."""
        if axis == 2:
            return self._zc.coord(loc)
        if self._shell_parent is not None:
            grid, offset = self._shell_parent
            o, n, h = offset[axis], self.N[axis], self.H[axis]
            return grid.coord_padded(axis, loc)[o:o + n + 2 * h]
        table = self._lam if axis == 0 else self._phi
        arr = table[("c", "c") if loc == "c" else ("f", "f")]
        line = arr[:, arr.shape[1] // 2] if axis == 0 \
            else arr[arr.shape[0] // 2, :]
        h = self.H[axis]
        return np.pad(line[:self.N[axis]], (h, h), mode="edge")

    def nodes2d(self, loc=("c", "c")):
        """The interior (λ, φ) tables in degrees: (c, c) centres or (f, f)
        corners (the corner tables for any other staggering)."""
        key = tuple(loc[:2])
        if self._shell_parent is not None:
            grid, (ox, oy) = self._shell_parent
            e = 1 if key == ("f", "f") else 0
            return tuple(a[ox:ox + self.N[0] + e, oy:oy + self.N[1] + e]
                         for a in grid.nodes2d(loc))
        return (self._lam.get(key, self._lam[("c", "c")]),
                self._phi.get(key, self._phi[("c", "c")]))

    def nodes2d_padded(self, loc=("c", "c")):
        """The true (λ, φ) nodes in degrees at any horizontal staggering
        over the padded extent, (npx, npy) float64, from the corners padded
        by their edge values (the extended corners under corner_halo)."""
        key = ("nodes2d_padded",) + tuple(loc[:2])
        if self._shell_parent is not None:
            return tuple(self._cut_xy(a) for a in
                         self._shell_parent[0].nodes2d_padded(loc))
        if key not in self._pad_cache:
            npx, npy = self.padded_shape[:2]
            pad = [(self.H[0],) * 2, (self.H[1],) * 2]
            if self._corner_halo:
                P = _sph2cart(*self._ext_corners)
            else:
                P = _sph2cart(np.pad(self._lam[("f", "f")], pad, mode="edge"),
                              np.pad(self._phi[("f", "f")], pad, mode="edge"))
            Pxm = _midpoint(P[:-1, :], P[1:, :])
            Pym = _midpoint(P[:, :-1], P[:, 1:])
            Pc = _midpoint(Pxm[:, :-1], Pxm[:, 1:])
            pts = {("f", "f"): P, ("f", "c"): Pym,
                   ("c", "f"): Pxm, ("c", "c"): Pc}[tuple(loc[:2])]
            self._pad_cache[key] = _cart2sph(pts[:npx, :npy])
        return self._pad_cache[key]

    def nodes1d(self, axis, loc):
        """Interior coordinates along z (the horizontal ones are 2-D:
        ``nodes2d``)."""
        if axis != 2:
            raise ValueError("the horizontal nodes of a shell grid are 2-D: "
                             "use nodes2d")
        return self.znodes(loc)

    def znodes(self, loc="c"):
        c = self._zc
        n, h = self.N[2], self.H[2]
        if loc == topo.FACE and self.topology[2] == topo.BOUNDED:
            return c.xF[h:h + n + 1]
        return c.coord(loc)[h:h + n]

    def _cut_xy(self, a):
        """A shard's cut of a padded (npx, npy, ...) table of the global
        grid."""
        _, (ox, oy) = self._shell_parent
        return a[ox:ox + self.N[0] + 2 * self.H[0],
                 oy:oy + self.N[1] + 2 * self.H[1]]

    def local_grid(self, size, device=None, offset=(0, 0)):
        """One shard's grid: ``size`` = (nx, ny, nz) interior cells whose
        first cell is this grid's interior cell ``offset`` = (ox, oy), with
        this grid's halo, topology and dtype, on ``device``. Its metrics,
        nodes and rotation angles are this grid's padded tables cut at the
        offset, so every cell of the shard sees this grid's exactly; z is
        carried whole."""
        size = tuple(int(n) for n in size)
        if size[2] != self.N[2]:
            raise ValueError("z is never sharded: the local grid keeps Nz")
        if self._corner_halo:
            raise ValueError(
                "a cubed-sphere panel is not cut into (x, y) blocks: the "
                "cubed sphere shards over its panels (a panel mesh, "
                "Distributed(Mesh(devices, ('panels',))))")
        local = copy.copy(self)
        local.N = size
        local.device = self.device if device is None else torch.device(device)
        local._cache = {}
        local._pad_cache = {}
        local._shell_parent = (self, tuple(offset))
        return local

    _shell_parent = None

    @property
    def extent(self):
        if self._shell_parent is not None:
            return self._shell_parent[0].extent
        lamF, phiF = self._lam[("f", "f")], self._phi[("f", "f")]
        return (float(lamF.max() - lamF.min()),
                float(phiF.max() - phiF.min()), self._zc.extent)

    @property
    def all_regular(self):
        return False

    @property
    def stretched_axes(self):
        return tuple(ax for ax in range(3) if not self.is_flat(ax))

    def regular(self, axis):
        """x and y are index-regular; z as its coordinate is."""
        return True if axis in (0, 1) else self._zc.regular

    def minimum_spacing(self, axis):
        if self.is_flat(axis):
            return np.inf
        if axis == 2:
            return float(np.min(np.asarray(self.metric_numpy(
                "dz", topo.LOC_CCC))))
        m = self.metric_numpy("dx" if axis == 0 else "dy", topo.LOC_CCC)
        h0, h1 = self.H[0], self.H[1]
        return float(np.min(m[h0:h0 + self.N[0], h1:h1 + self.N[1], 0]))

    # -- copies ---------------------------------------------------------------

    def _rebuild(self, halo, dtype, device):
        if self._corner_halo:
            if tuple(halo) != self.H:
                raise ValueError("a panel with exchanged (corner_halo) "
                                 "metrics cannot change its halo alone; "
                                 "rebuild the cubed-sphere grid")
            return OrthogonalSphericalShellGrid(
                *self._ext_corners, z=self._zc.spec(), size=self.N,
                radius=self.radius, topology=self.topology, halo=halo,
                dtype=dtype, device=device, corner_halo=self._corner_halo)
        return OrthogonalSphericalShellGrid(
            self._lam[("f", "f")], self._phi[("f", "f")], z=self._zc.spec(),
            size=self.N, radius=self.radius, topology=self.topology,
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
        lam, phi = (self._ext_corners if self._corner_halo
                    else (self._lam[("f", "f")], self._phi[("f", "f")]))
        return ("OSSG", self.N, self.H, self.topology, self.radius,
                str(self.dtype), str(self.device), self._corner_halo,
                lam.tobytes(), phi.tobytes(), self._zc._fp,
                None if self._shell_parent is None
                else self._shell_parent[1], getattr(self, "connected", None))

    def __repr__(self):
        return (f"OrthogonalSphericalShellGrid(size={self.N}, halo={self.H}, "
                f"dtype={self.dtype}, device={self.device})")


def RotatedLatitudeLongitudeGrid(size, longitude, latitude, z=None,
                                 north_pole=(0.0, 90.0), radius=None,
                                 topology=None, halo=None, dtype=None,
                                 device=None):
    """A lat-lon grid whose coordinate north pole sits at ``north_pole`` =
    (λp, φp) in geographic coordinates."""
    Nx, Ny = size[0], size[1]
    lam2, phi2 = np.meshgrid(np.linspace(longitude[0], longitude[1], Nx + 1),
                             np.linspace(latitude[0], latitude[1], Ny + 1),
                             indexing="ij")
    P = _sph2cart(lam2, phi2)
    lp, pp = north_pole
    a = (90.0 - pp) * DEG           # Ry(90° - φp), then Rz(λp)
    b = lp * DEG
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    Rz = np.array([[np.cos(b), -np.sin(b), 0], [np.sin(b), np.cos(b), 0],
                   [0, 0, 1]])
    lamF, phiF = _cart2sph(P @ (Rz @ Ry).T)
    return OrthogonalSphericalShellGrid(lamF, phiF, z=z, size=size,
                                        radius=radius, topology=topology,
                                        halo=halo, dtype=dtype, device=device)


def rotation_angle_ccc(grid):
    """(cos θ, sin θ) of the angle between the grid's x direction and
    geographic east at the cell centres, float64 (npx, npy, 1): the halo
    columns wrap along a periodic x and extend the edge elsewhere."""
    grid = getattr(grid, "underlying_grid", grid)
    if grid._shell_parent is not None:
        return tuple(grid._cut_xy(a)
                     for a in rotation_angle_ccc(grid._shell_parent[0]))
    P = _sph2cart(grid._lam[("f", "f")], grid._phi[("f", "f")])
    # the cell centre and its +x direction (the mean of the two x edges)
    Pc = _midpoint(_midpoint(P[:-1, :-1], P[:-1, 1:]),
                   _midpoint(P[1:, :-1], P[1:, 1:]))
    ex = (_midpoint(P[1:, :-1], P[1:, 1:])
          - _midpoint(P[:-1, :-1], P[:-1, 1:]))
    ex = ex - np.sum(ex * Pc, axis=-1, keepdims=True) * Pc
    ex = ex / np.maximum(np.linalg.norm(ex, axis=-1, keepdims=True), 1e-30)
    east = np.cross(np.array([0.0, 0.0, 1.0]), Pc)
    east = east / np.maximum(np.linalg.norm(east, axis=-1, keepdims=True),
                             1e-30)
    north = np.cross(Pc, east)
    out = []
    for a in (np.sum(ex * east, axis=-1), np.sum(ex * north, axis=-1)):
        for axis in (0, 1):
            pad = [(0, 0), (0, 0)]
            pad[axis] = (grid.H[axis], grid.H[axis])
            a = np.pad(a, pad, mode="wrap" if grid.topology[axis]
                       == topo.PERIODIC else "edge")
        out.append(a[..., None])
    return tuple(out)


def _rotation(grid, like):
    key = ("rotation", like.dtype, str(like.device))
    cache = getattr(grid, "underlying_grid", grid)._pad_cache
    if key not in cache:
        cache[key] = tuple(torch.as_tensor(m, dtype=like.dtype,
                                           device=like.device)
                           for m in rotation_angle_ccc(grid))
    return cache[key]


def rotate_to_geographic(grid, u_ccc, v_ccc):
    """(u_east, v_north) from intrinsic centre-located velocity
    components."""
    cos, sin = _rotation(grid, u_ccc)
    return cos * u_ccc - sin * v_ccc, sin * u_ccc + cos * v_ccc


def rotate_from_geographic(grid, ue_ccc, vn_ccc):
    """Intrinsic centre-located components from (u_east, v_north)."""
    cos, sin = _rotation(grid, ue_ccc)
    return cos * ue_ccc + sin * vn_ccc, -sin * ue_ccc + cos * vn_ccc


__all__ = ["OrthogonalSphericalShellGrid", "RotatedLatitudeLongitudeGrid",
           "rotation_angle_ccc", "rotate_to_geographic",
           "rotate_from_geographic"]
