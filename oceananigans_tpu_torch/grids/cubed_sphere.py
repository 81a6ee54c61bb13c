"""Cubed-sphere grids: six panels composed with connectivity derived from
their geometry, the panel exchange, and the panels concatenated as one grid.

Counterpart of ``oceananigans_tpu/grids/cubed_sphere.py``. A cubed-sphere
field is one tensor with a leading panel axis, (6, NP, NP, NZ) with
NP = N + 2H; ``ConformalCubedSphereGrid`` composes six
``OrthogonalSphericalShellGrid`` panels (FULLY_CONNECTED x and y) built
from the Rančić conformal map (``conformal_map.py``; ``mesh="elliptic"``
an elliptically relaxed node set, ``mesh="equiangular"`` the gnomonic
panels) with exact halo metrics: each panel's corner nodes are extended by
the true nodes of its neighbours (``_extended_corner_nodes``). Which side
of which panel meets which, and the signed permutation that turns a
neighbour's (u, v) components into the panel's at that edge, are found by
matching corner points (``derive_connectivity``,
``derive_edge_rotations``), as in JAX.

The exchange: ``fill_cubed_sphere_halos`` (centre fields),
``fill_cubed_sphere_velocity_halos`` (the staggered pair, the components
rotated across each edge) and ``sync_shared_velocity_faces`` (the
lower-numbered panel owns each shared normal-velocity face) are the
per-panel slice copies of JAX, two passes (the second carries freshly
filled halos into the three-panel corners). Every slot they write copies
one source slot, possibly with a sign, so ``PanelExchange`` probes them once
with index-valued fields and runs each exchange as one gather a field and
pass (the JAX ``build_fast_exchange``; its concatenated-form variant
``build_concat_exchange_catform`` computes the same values, and so do the
port's maps on the concatenated view (6·NP, NP, NZ) of the same memory).

``ConcatPanelsGrid`` presents the six panels as one grid, their metric
tables concatenated along x, so that a tendency, a closure or a solver
runs once over the (6·NP, NP, NZ) view; stencil reads that cross a seam
land only in halo slots that the next exchange overwrites.
"""

from __future__ import annotations

import numpy as np
import torch

from ..defaults import as_torch_dtype, resolve_device
from .base import AbstractGrid, MetricCache
from .orthogonal_spherical_shell import (OrthogonalSphericalShellGrid,
                                         _cart2sph, _sph2cart)
from .topology import BOUNDED, FLAT, FULLY_CONNECTED

# panel rotation matrices: panel 0 is the +x face; 1..3 the other equatorial
# faces; 4 north (+z), 5 south (-z)
def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])


PANEL_ROTATIONS = [np.eye(3), _rz(np.pi / 2), _rz(np.pi), _rz(3 * np.pi / 2),
                   _ry(-np.pi / 2), _ry(np.pi / 2)]


def panel_corner_coordinates(N, panel):
    """(lon, lat) degree arrays of shape (N+1, N+1): the equiangular gnomonic
    cube face ``panel`` (0-5)."""
    xi = np.linspace(-np.pi / 4, np.pi / 4, N + 1)
    X, Y = np.tan(xi)[:, None], np.tan(xi)[None, :]
    d = np.stack(np.broadcast_arrays(np.ones_like(X * Y), X, Y), axis=-1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ PANEL_ROTATIONS[panel].T
    return _cart2sph(d)


def ConformalCubedSpherePanel(size, panel=0, z=None, radius=None, halo=None,
                              dtype=None, device=None):
    """One equiangular cube face ``panel`` (0-5) as an
    OrthogonalSphericalShellGrid of ``size`` (N, N, Nz)."""
    N = size[0]
    if size[1] != N:
        raise ValueError("cubed-sphere panels are square: Nx == Ny")
    lon, lat = panel_corner_coordinates(N, panel)
    return OrthogonalSphericalShellGrid(lon, lat, z=z, size=size,
                                        radius=radius, halo=halo, dtype=dtype,
                                        device=device)


# -- connectivity -------------------------------------------------------------

_SIDES = ("west", "east", "south", "north")


def _edge_points(lon, lat, side):
    """Ordered boundary corner points (unit vectors) of a panel side."""
    P = _sph2cart(lon, lat)
    if side == "west":
        return P[0, :]
    if side == "east":
        return P[-1, :]
    if side == "south":
        return P[:, 0]
    return P[:, -1]


def _edge_basis(P, side):
    """Unit (e_x, e_y) index-direction vectors of a panel at the midpoint
    node of ``side`` (one-sided difference into the panel for the
    edge-crossing direction)."""
    n = P.shape[0] - 1
    k = n // 2
    if side == "west":
        ex, ey = P[1, k] - P[0, k], P[0, k + 1] - P[0, k - 1]
    elif side == "east":
        ex, ey = P[n, k] - P[n - 1, k], P[n, k + 1] - P[n, k - 1]
    elif side == "south":
        ex, ey = P[k + 1, 0] - P[k - 1, 0], P[k, 1] - P[k, 0]
    else:
        ex, ey = P[k + 1, n] - P[k - 1, n], P[k, n] - P[k, n - 1]
    return ex / np.linalg.norm(ex), ey / np.linalg.norm(ey)


def derive_edge_rotations(N, conn):
    """{(panel, side): R} where R is the 2x2 signed permutation relating the
    neighbor's local (x, y) velocity components to this panel's at the shared
    edge: (u_p, v_p) = R @ (u_q, v_q). On the edge the two panels' index
    directions are exactly parallel/antiparallel or orthogonal (shared
    equiangular edge parameter), so the basis dot products snap to {0, ±1}
    (derived numerically from the panel geometry)."""
    corners = [_sph2cart(*panel_corner_coordinates(N, p)) for p in range(6)]
    rots = {}
    for (p, s), (q, t, _rev) in conn.items():
        exp_, eyp = _edge_basis(corners[p], s)
        exq, eyq = _edge_basis(corners[q], t)
        R = np.array([[exp_ @ exq, exp_ @ eyq],
                      [eyp @ exq, eyp @ eyq]])
        Rs = np.rint(R).astype(int)
        if not (np.abs(R - Rs).max() < 0.2
                and (np.abs(Rs).sum(0) == 1).all()
                and (np.abs(Rs).sum(1) == 1).all()):
            raise RuntimeError(f"edge basis did not snap: {(p, s)} -> "
                               f"{(q, t)}: {R}")
        rots[(p, s)] = Rs
    return rots


def derive_connectivity(N):
    """{(panel, side): (neighbor_panel, neighbor_side, reversed)} found by
    geometric corner matching."""
    corners = [panel_corner_coordinates(N, p) for p in range(6)]
    edges = {(p, s): _edge_points(*corners[p], s)
             for p in range(6) for s in _SIDES}
    conn = {}
    for (p, s), pts in edges.items():
        for (q, t), qts in edges.items():
            if q == p:
                continue
            if np.allclose(pts, qts, atol=1e-12):
                conn[(p, s)] = (q, t, False)
                break
            if np.allclose(pts, qts[::-1], atol=1e-12):
                conn[(p, s)] = (q, t, True)
                break
        else:
            raise RuntimeError(f"no neighbor found for panel {p} side {s}")
    return conn


def _extended_corner_nodes(N, H, conn, base=None):
    """Per-panel corner-node cartesian arrays (N+2H+1, N+2H+1, 3) whose halo
    node rows are the TRUE nodes of the neighboring panels (gathered via the
    connectivity; two passes fill the three-panel corner squares). Building
    panel grids from these makes every halo metric — length and area, all
    staggerings — exact, the analogue of the reference's inter-panel metric
    fill (src/MultiRegion/cubed_sphere_grid.jl). ``base``: interior node
    arrays (N+1, N+1, 3) per panel (default: equiangular gnomonic)."""
    if base is None:
        base = [_sph2cart(*panel_corner_coordinates(N, p)) for p in range(6)]
    E = N + 2 * H
    ext = [np.full((E + 1, E + 1, 3), np.nan) for _ in range(6)]
    for p in range(6):
        ext[p][H:H + N + 1, H:H + N + 1] = base[p]
    for _ in range(2):
        src = [e.copy() for e in ext]
        for p in range(6):
            for s in _SIDES:
                q, t, rev = conn[(p, s)]
                na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
                kmap = (E - np.arange(E + 1)) if rev else np.arange(E + 1)
                for m in range(1, H + 1):
                    di = (H - m) if _LOW_SIDE[s] else (H + N + m)
                    si = (H + m) if _LOW_SIDE[t] else (H + N - m)
                    row = np.take(src[q], si, axis=na_q)[kmap]
                    if na_p == 0:
                        ext[p][di, :, :] = row
                    else:
                        ext[p][:, di, :] = row
    for p in range(6):
        bad = np.isnan(ext[p][..., 0])
        if bad.any():
            raise RuntimeError(f"unfilled corner nodes on panel {p}")
    return ext


def _node_exchange(nodes, N, conn, H=1, passes=1):
    """One-halo node exchange (see :func:`_extended_corner_nodes`) returning
    extended (N+2H+1,)² arrays; with ``passes=1`` the diagonal corner squares
    stay NaN — fine for plus-stencil consumers."""
    E = N + 2 * H
    ext = [np.full((E + 1, E + 1, 3), np.nan) for _ in range(6)]
    for p in range(6):
        ext[p][H:H + N + 1, H:H + N + 1] = nodes[p]
    for _ in range(passes):
        src = [e.copy() for e in ext]
        for p in range(6):
            for s in _SIDES:
                q, t, rev = conn[(p, s)]
                na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
                kmap = (E - np.arange(E + 1)) if rev else np.arange(E + 1)
                for m in range(1, H + 1):
                    di = (H - m) if _LOW_SIDE[s] else (H + N + m)
                    si = (H + m) if _LOW_SIDE[t] else (H + N - m)
                    row = np.take(src[q], si, axis=na_q)[kmap]
                    if na_p == 0:
                        ext[p][di, :, :] = row
                    else:
                        ext[p][:, di, :] = row
    return ext


def _canonicalize_edges(nodes, N, conn):
    """Force bitwise equality of the duplicated edge-node rows: the
    lower-numbered panel owns each shared edge."""
    jmap_fwd = np.arange(N + 1)
    jmap_rev = N - jmap_fwd
    for (p, s), (q, t, rev) in conn.items():
        if p >= q:
            continue
        pi = (0 if _LOW_SIDE[s] else N)
        mine = (nodes[p][pi, :] if _NORMAL_AXIS[s] == 0
                else nodes[p][:, pi])
        row = mine[jmap_rev if rev else jmap_fwd]
        qi = (0 if _LOW_SIDE[t] else N)
        if _NORMAL_AXIS[t] == 0:
            nodes[q][qi, :] = row
        else:
            nodes[q][:, qi] = row
    return nodes


_VERTEX_IDX = [(0, 0), (0, -1), (-1, 0), (-1, -1)]


def _relax_level(nodes, N, conn, tol=1e-13, max_sweeps=20000):
    """Jacobi 'normalize the 4-neighbor average' relaxation of the global
    node set, cube-vertex nodes pinned. At convergence the mesh is mirror-
    symmetric about every panel-edge plane, so grid lines cross panel edges
    WITHOUT kinks — the property that makes the staggered C-grid circulation
    operators consistent (convergent) at the edges, as the conformal map
    does."""
    pinned = [[nodes[p][i, j].copy() for (i, j) in _VERTEX_IDX]
              for p in range(6)]
    for sweep in range(max_sweeps):
        ext = _node_exchange(nodes, N, conn)
        moved = 0.0
        new_nodes = []
        for p in range(6):
            e = ext[p]
            avg = e[:-2, 1:-1] + e[2:, 1:-1] + e[1:-1, :-2] + e[1:-1, 2:]
            avg = avg / np.linalg.norm(avg, axis=-1, keepdims=True)
            for k, (i, j) in enumerate(_VERTEX_IDX):
                avg[i, j] = pinned[p][k]
            moved = max(moved, np.abs(avg - nodes[p]).max())
            new_nodes.append(avg)
        nodes = new_nodes
        if moved < tol:
            break
    return _canonicalize_edges(nodes, N, conn)


def _subdivide(nodes):
    """Spherical midpoint refinement of a panel node array:
    (n+1)² → (2n+1)²."""
    n = nodes.shape[0] - 1
    out = np.empty((2 * n + 1, 2 * n + 1, 3))
    out[::2, ::2] = nodes
    out[1::2, ::2] = nodes[:-1, :] + nodes[1:, :]
    out[::2, 1::2] = nodes[:, :-1] + nodes[:, 1:]
    out[1::2, 1::2] = (nodes[:-1, :-1] + nodes[1:, :-1]
                       + nodes[:-1, 1:] + nodes[1:, 1:])
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


_ELLIPTIC_CACHE = {}


def elliptic_cubed_sphere_nodes(N):
    """Per-panel node arrays of the elliptically-relaxed cubed sphere at
    resolution N (cascade: relax at N0=4, subdivide + re-relax up to N).
    N must be a power-of-two multiple of a base in {3,4,5,7} (any N works if
    even-divisible down to ≤8; otherwise relaxed directly from gnomonic)."""
    if N in _ELLIPTIC_CACHE:
        return _ELLIPTIC_CACHE[N]
    # cascade schedule: halve while even and > 8
    sched = [N]
    while sched[-1] % 2 == 0 and sched[-1] > 8:
        sched.append(sched[-1] // 2)
    sched.reverse()
    n0 = sched[0]
    conn0 = derive_connectivity(n0)
    nodes = [_sph2cart(*panel_corner_coordinates(n0, p)) for p in range(6)]
    nodes = _relax_level(nodes, n0, conn0)
    for n in sched[1:]:
        # the connectivity dict is resolution-independent (same panel
        # topology); reuse the base-level one
        nodes = [_subdivide(a) for a in nodes]
        nodes = _relax_level(nodes, n, conn0, max_sweeps=600)
    _ELLIPTIC_CACHE[N] = nodes
    return nodes




class ConformalCubedSphereGrid:
    """Six panels; fields are (6, NP, NP, NZ) tensors. ``panel_grids[p]``
    is panel p's OrthogonalSphericalShellGrid with exchanged halo metrics
    (exact neighbour-panel lengths and areas in the halos), its x and y
    FULLY_CONNECTED. ``mesh``: "conformal" (Rančić et al. 1996, the
    default), "elliptic" (an elliptically relaxed node set: kink-free edge
    crossings, not conformal) or "equiangular" (the gnomonic panels).
    ``halo``: one horizontal halo (3 by default), or (Hx, Hy[, Hz]) with
    Hx == Hy; z takes max(Hz, 3). ``exchange`` is the panel exchange
    (``PanelExchange``). Like the port's other grids it lives on ``device``
    (the CUDA card unless given), in ``dtype``."""

    def __init__(self, panel_size, z=None, radius=None, halo=None,
                 dtype=None, mesh="conformal", device=None):
        N = panel_size[0]
        if panel_size[1] != N:
            raise ValueError("cubed-sphere panels are square: Nx == Ny")
        if z is not None and len(panel_size) < 3:
            raise ValueError("a z-structured cubed sphere needs "
                             "panel_size=(N, N, Nz)")
        if mesh not in ("conformal", "elliptic", "equiangular"):
            raise ValueError(f"mesh must be 'conformal', 'elliptic' or "
                             f"'equiangular', got {mesh!r}")
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        self.connectivity = derive_connectivity(N)
        self.edge_rotations = derive_edge_rotations(N, self.connectivity)
        self.mesh = mesh
        zh_request = None
        if halo is None:
            H = 3
        elif np.isscalar(halo):
            H = int(halo)
        else:
            halo = tuple(int(h) for h in halo)
            if len(halo) >= 2 and halo[0] != halo[1]:
                # the exchange turns x into y at some seams
                raise ValueError("cubed-sphere panels need equal horizontal "
                                 f"halos, got {halo[:2]}")
            H = halo[0]
            if len(halo) == 3:
                zh_request = halo[2]
        if mesh == "conformal":
            from .conformal_map import conformal_cubed_sphere_nodes
            base = conformal_cubed_sphere_nodes(N)
        elif mesh == "elliptic":
            base = elliptic_cubed_sphere_nodes(N)
        else:
            base = None
        self.extended_nodes = _extended_corner_nodes(N, H, self.connectivity,
                                                     base=base)
        zh = 0
        if z is not None:
            zh = max(int(zh_request if zh_request is not None else 3), 3)
        ptopo = (FULLY_CONNECTED, FULLY_CONNECTED,
                 BOUNDED if z is not None else FLAT)
        self.panel_grids = [
            OrthogonalSphericalShellGrid(
                *_cart2sph(ext), z=z, size=panel_size, radius=radius,
                topology=ptopo, halo=(H, H, zh), dtype=self.dtype,
                device=self.device, corner_halo=H)
            for ext in self.extended_nodes]
        self.N = self.panel_grids[0].N
        self.H = self.panel_grids[0].H
        self.radius = self.panel_grids[0].radius
        self.exchange = PanelExchange(self)

    @property
    def padded_shape(self):
        return (6,) + self.panel_grids[0].padded_shape

    def interior(self, a):
        return a[(slice(None),) + self.panel_grids[0].interior_slices]

    def __repr__(self):
        return (f"ConformalCubedSphereGrid(6x{self.N}, halo={self.H}, "
                f"mesh={self.mesh!r}, dtype={self.dtype}, "
                f"device={self.device})")


# -- the exchange: the per-panel slice copies ---------------------------------

# axis perpendicular to each side (0 = x, 1 = y)
_NORMAL_AXIS = {"west": 0, "east": 0, "south": 1, "north": 1}
# sides whose boundary sits at the low index end of the normal axis
_LOW_SIDE = {"west": True, "east": False, "south": True, "north": False}


def _interior_strip(a, H, N, side, depth):
    """The interior strip of width ``depth`` next to ``side`` of a padded
    panel tensor ``a`` (npx, npy, ...), ordered outward from the boundary,
    and the axis it is normal to."""
    if side == "west":
        return a[H:H + depth], 0
    if side == "east":
        return torch.flip(a[H + N - depth:H + N], [0]), 0
    if side == "south":
        return a[:, H:H + depth], 1
    return torch.flip(a[:, H + N - depth:H + N], [1]), 1


def fill_cubed_sphere_halos(a, csgrid, passes=2):
    """The exchange of a centre field (6, NP, NP, ...): each side's halo
    from the neighbour's interior strip, tangentially aligned; the second
    pass fills the three-panel corners. Returns a new tensor."""
    H, N = csgrid.H[0], csgrid.N[0]
    out = a
    for _ in range(passes):
        src, out = out, out.clone()
        for p in range(6):
            panel = out[p]
            for side in _SIDES:
                q, t, rev = csgrid.connectivity[(p, side)]
                strip, axis_q = _interior_strip(src[q], H, N, t, H)
                if axis_q == 1:
                    strip = torch.movedim(strip, 1, 0)
                if rev:
                    strip = torch.flip(strip, [1])
                if side == "west":
                    panel[:H] = torch.flip(strip, [0])
                elif side == "east":
                    panel[H + N:H + N + H] = strip
                elif side == "south":
                    panel[:, :H] = torch.flip(torch.movedim(strip, 0, 1),
                                              [1])
                else:
                    panel[:, H + N:H + N + H] = torch.movedim(strip, 0, 1)
    return out


def _tang_map(NP, rev, face):
    """The tangential index map into the neighbour panel over the padded
    range: centres mirror as j -> NP-1-j; faces as j -> NP-j, the
    out-of-range j = 0 slot clipped to its neighbour."""
    j = np.arange(NP)
    if not rev:
        return j
    return (NP - 1 - j) if not face else np.clip(NP - j, 1, NP - 1)


def _normal_indices(side_p, side_q, H, N, face):
    """(my destination slice, the neighbour's source indices) along the
    normal axes; row m = 1.. counts outward from my boundary and inward from
    the neighbour's. A face field owns its shared boundary face (not
    exchanged); on the high side its outermost halo face does not exist in
    the padded layout, so its depth there is H-1."""
    if _LOW_SIDE[side_p]:
        ms = range(H, 0, -1)
        dst = slice(0, H)
    elif face:
        ms = range(1, H)
        dst = slice(H + N + 1, H + N + H)
    else:
        ms = range(1, H + 1)
        dst = slice(H + N, H + N + H)
    if _LOW_SIDE[side_q]:
        src = [H + m - 1 + (1 if face else 0) for m in ms]
    else:
        src = [H + N - m for m in ms]
    return dst, src


def _gather(B, naxis_q, nidx, taxis_q, jmap, swap):
    dev = B.device
    T = torch.index_select(B, naxis_q, torch.as_tensor(np.asarray(nidx),
                                                       device=dev))
    T = torch.index_select(T, taxis_q, torch.as_tensor(np.asarray(jmap),
                                                       device=dev))
    return torch.swapaxes(T, 0, 1) if swap else T


def fill_cubed_sphere_velocity_halos(u, v, csgrid, passes=2):
    """The exchange of the staggered pair (u at x faces, v at y faces),
    both (6, NP, NP, ...): across an edge the neighbour's components turn
    into this panel's by the signed permutation ``csgrid.edge_rotations``;
    my normal component comes from the neighbour's normal one, my
    tangential from its tangential one (the same staggered points of the
    global mesh). Returns new tensors."""
    H, N = csgrid.H[0], csgrid.N[0]
    NP = N + 2 * H
    conn, rots = csgrid.connectivity, csgrid.edge_rotations
    for _ in range(passes):
        su, sv = u, v
        u, v = u.clone(), v.clone()
        for p in range(6):
            pu, pv = u[p], v[p]
            for s in _SIDES:
                q, t, rev = conn[(p, s)]
                R = rots[(p, s)]
                na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
                ta_p, ta_q = 1 - na_p, 1 - na_q
                qn = su[q] if na_q == 0 else sv[q]
                qt = sv[q] if na_q == 0 else su[q]
                sgn_n, sgn_t = float(R[na_p, na_q]), float(R[ta_p, ta_q])
                swap = na_p != na_q
                dst, src = _normal_indices(s, t, H, N, face=True)
                blk = sgn_n * _gather(qn, na_q, src, ta_q,
                                      _tang_map(NP, rev, False), swap)
                (pu if na_p == 0 else pv)[
                    (dst, slice(None)) if na_p == 0
                    else (slice(None), dst)] = blk
                dst, src = _normal_indices(s, t, H, N, face=False)
                blk = sgn_t * _gather(qt, na_q, src, ta_q,
                                      _tang_map(NP, rev, True), swap)
                (pv if na_p == 0 else pu)[
                    (dst, slice(None)) if na_p == 0
                    else (slice(None), dst)] = blk
    return u, v


def sync_shared_velocity_faces(u, v, csgrid):
    """Make the duplicated shared-edge normal-velocity faces equal: the
    lower-numbered panel owns each edge and the other copy is overwritten
    through the edge rotation (both panels then compute the same mass flux
    through the face). Returns new tensors."""
    H, N = csgrid.H[0], csgrid.N[0]
    NP = N + 2 * H
    u, v = u.clone(), v.clone()
    for (p, s), (q, t, rev) in csgrid.connectivity.items():
        if p >= q:
            continue
        na_p, na_q = _NORMAL_AXIS[s], _NORMAL_AXIS[t]
        sgn = float(csgrid.edge_rotations[(q, t)][na_q, na_p])
        pi = H if _LOW_SIDE[s] else H + N
        qi = H if _LOW_SIDE[t] else H + N
        src = u if na_p == 0 else v
        row = src[p, pi] if na_p == 0 else src[p, :, pi]
        # the normal velocity lives on tangential centres: mirror NP-1-j
        if rev:
            row = torch.flip(row, [0])
        row = row * sgn
        if na_q == 0:
            u[q, qi] = row
        else:
            v[q, :, qi] = row
    return u, v


# -- the exchange as gathers --------------------------------------------------

class PanelExchange:
    """The exchange of a ``ConformalCubedSphereGrid`` as precomputed index
    maps (JAX ``build_fast_exchange``): the per-panel functions above probed
    once with index-valued float64 fields, each output slot found to copy
    one source slot (times ±1). A call takes a field in the stacked
    (6, NP, NP, ...) or the concatenated (6·NP, NP, ...) layout and returns
    a new tensor of the same shape, one gather a field:

    - ``centers(a, passes=2)``: ``fill_cubed_sphere_halos``;
    - ``velocities(u, v, passes=2)``: ``sync_shared_velocity_faces`` then
      ``fill_cubed_sphere_velocity_halos`` (one pass: the straight edges
      alone, enough for the radius-1 stencils of the barotropic substeps);
    - ``sync(u, v)``: ``sync_shared_velocity_faces``.

    ``gathers`` counts the gathers made on CUDA tensors."""

    def __init__(self, csgrid):
        self.csgrid = csgrid
        H, N = csgrid.H[0], csgrid.N[0]
        self.NP = N + 2 * H
        self.n = 6 * self.NP * self.NP
        self._maps = {}
        self._device_maps = {}
        self.gathers = 0

    def _probe(self, kind):
        idx = torch.arange(1.0, self.n + 1.0, dtype=torch.float64).reshape(
            6, self.NP, self.NP, 1)
        g = self.csgrid
        if kind.startswith("c"):
            rc = fill_cubed_sphere_halos(idx, g, passes=int(kind[1]))
            rc = rc.reshape(-1).numpy()
            assert (rc > 0).all()        # the centre exchange never flips
            return np.rint(rc).astype(np.int64) - 1

        def composed(u, v):
            if kind == "sync":
                return sync_shared_velocity_faces(u, v, g)
            u, v = sync_shared_velocity_faces(u, v, g)
            return fill_cubed_sphere_velocity_halos(u, v, g,
                                                    passes=int(kind[2]))

        ruA, rvA = composed(idx, idx)
        ruB, rvB = composed(idx, -idx)
        out = []
        for rA, rB in ((ruA, ruB), (rvA, rvB)):
            rA, rB = rA.reshape(-1).numpy(), rB.reshape(-1).numpy()
            src = np.rint(np.abs(rA)).astype(np.int64) - 1
            from_u = rA == rB
            # one source table for u and v: v's slots after u's
            out.append((np.where(from_u, src, src + self.n), np.sign(rA)))
        return out

    def _map(self, kind, like):
        key = (kind, like.device, like.dtype)
        hit = self._device_maps.get(key)
        if hit is None:
            if kind not in self._maps:
                self._maps[kind] = self._probe(kind)
            maps = self._maps[kind]
            if isinstance(maps, np.ndarray):
                hit = torch.as_tensor(maps, device=like.device)
            else:
                hit = [(torch.as_tensor(src, device=like.device),
                        torch.as_tensor(sgn, dtype=like.dtype,
                                        device=like.device)[:, None])
                       for src, sgn in maps]
            self._device_maps[key] = hit
        return hit

    def _count(self, a, k):
        if a.is_cuda:
            self.gathers += k

    def centers(self, a, passes=2):
        m = self._map(f"c{passes}", a)
        self._count(a, 1)
        flat = a.reshape(self.n, -1)
        return torch.index_select(flat, 0, m).reshape(a.shape)

    def _pair(self, kind, u, v):
        maps = self._map(kind, u)
        self._count(u, 2)
        both = torch.cat([u.reshape(self.n, -1), v.reshape(self.n, -1)])
        return tuple((torch.index_select(both, 0, src) * sgn).reshape(u.shape)
                     for src, sgn in maps)

    def velocities(self, u, v, passes=2):
        return self._pair(f"uv{passes}", u, v)

    def sync(self, u, v):
        return self._pair("sync", u, v)


class ShardPanelExchange:
    """``PanelExchange`` on one shard of a panel mesh (``parallel.
    distributed.PanelShard``): the shard holds k = 6/S consecutive panels,
    (k, NP, NP, ...) (or the concatenated (k·NP, NP, ...)), and the
    exchange is one meeting of the shards (the communicator's
    ``all_to_all``). The global exchange's probed maps are split by
    destination: each slot of this shard's panels reads one source slot
    (times ±1), on its own panels or on another shard's. Each shard sends
    every other shard the slots that its panels read there, and nothing
    else, gathered into one strip buffer a destination; the receiver
    gathers its panels from its own tensor and the strips that arrived. No
    shard holds the six panels. The slots and signs are the global maps',
    so a shard's panels equal the global exchange's bit for bit.

    ``calls`` counts the exchanges and ``bytes`` the bytes this shard sent
    (the strips, every field and level)."""

    def __init__(self, exchange, shard):
        self.global_exchange = exchange
        self.shard = shard
        self.NP = exchange.NP
        S = shard.comm.size
        self.k = k = 6 // S
        self.n = k * self.NP * self.NP
        self._plans = {}
        self._device_plans = {}
        self.calls = 0
        self.bytes = 0

    def _plan(self, kind):
        """(send, maps): the local slots sent to each rank (None for
        itself or nothing), and per output field (its index into this
        shard's tensor followed by the strips received, in rank order;
        its signs, or None for the centres)."""
        if kind in self._plans:
            return self._plans[kind]
        ex = self.global_exchange
        if kind not in ex._maps:
            ex._maps[kind] = ex._probe(kind)
        maps = ex._maps[kind]
        pair = not isinstance(maps, np.ndarray)
        A, k, n6 = self.NP * self.NP, self.k, ex.n
        S = self.shard.comm.size
        nf = 2 if pair else 1
        ln = self.n

        def owner_and_local(src):
            f, g = src // n6, src % n6
            q = g // A
            return q // k, f * ln + g - (q // k) * k * A

        # every rank's needs from every other: its destination slots' sources
        needs = [[None] * S for _ in range(S)]
        for dst in range(S):
            lo, hi = dst * ln, (dst + 1) * ln
            srcs = np.concatenate([m[lo:hi] for m in
                                   ([maps] if not pair else
                                    [src for src, _ in maps])])
            own, loc = owner_and_local(srcs)
            for s in range(S):
                if s != dst:
                    needs[dst][s] = np.unique(loc[own == s])
        r = self.shard.rank
        send = [None if d == r or needs[d][r].size == 0 else needs[d][r]
                for d in range(S)]
        lo, hi = r * ln, (r + 1) * ln
        offsets, off = {}, nf * ln
        for s in range(S):
            if s != r:
                offsets[s] = off
                off += needs[r][s].size
        out = []
        for m in ([maps] if not pair else [src for src, _ in maps]):
            own, loc = owner_and_local(m[lo:hi])
            idx = loc.copy()
            for s, base in offsets.items():
                sel = own == s
                idx[sel] = base + np.searchsorted(needs[r][s], loc[sel])
            out.append(idx)
        signs = [None] if not pair else [sgn[lo:hi] for _, sgn in maps]
        plan = (send, list(zip(out, signs)) if pair else [(out[0], None)])
        self._plans[kind] = plan
        return plan

    def _device_plan(self, kind, like):
        key = (kind, like.device, like.dtype)
        hit = self._device_plans.get(key)
        if hit is None:
            send, maps = self._plan(kind)
            dev = like.device
            hit = ([None if s is None else torch.as_tensor(s, device=dev)
                    for s in send],
                   [(torch.as_tensor(i, device=dev),
                     None if g is None else torch.as_tensor(
                         g, dtype=like.dtype, device=dev)[:, None])
                    for i, g in maps])
            self._device_plans[key] = hit
        return hit

    def _run(self, kind, fields):
        send, maps = self._device_plan(kind, fields[0])
        shape = fields[0].shape
        local = torch.cat([a.reshape(self.n, -1) for a in fields]) \
            if len(fields) > 1 else fields[0].reshape(self.n, -1)
        pieces = [None if i is None else torch.index_select(local, 0, i)
                  for i in send]
        self.calls += 1
        self.bytes += sum(p.numel() * p.element_size() for p in pieces
                          if p is not None)
        if self.shard.comm.size > 1:
            got = self.shard.comm.all_to_all(self.shard.rank, pieces)
            ext = torch.cat([local] + [g for g in got if g is not None])
        else:
            ext = local
        self.global_exchange._count(local, len(maps))
        out = []
        for idx, sgn in maps:
            a = torch.index_select(ext, 0, idx)
            out.append((a if sgn is None else a * sgn).reshape(shape))
        return out

    def centers(self, a, passes=2):
        return self._run(f"c{passes}", [a])[0]

    def velocities(self, u, v, passes=2):
        return tuple(self._run(f"uv{passes}", [u, v]))

    def sync(self, u, v):
        return tuple(self._run("sync", [u, v]))


# -- the panels concatenated as one grid --------------------------------------

class _ConcatBoundary:
    """An immersed boundary holding the panels' concatenated solid mask."""

    def __init__(self, solid_cat, fingerprint):
        self._solid = solid_cat
        self._fingerprint = fingerprint

    def solid_centers(self, grid):
        return self._solid.copy()

    def _fp(self):
        return ("_ConcatBoundary", self._fingerprint)


class _ConcatPartialBoundary(_ConcatBoundary):
    """``_ConcatBoundary`` with the panels' concatenated partial-cell
    spacings."""

    def __init__(self, solid_cat, dz_eff_cat, fingerprint):
        super().__init__(solid_cat, fingerprint)
        self._dz_eff = dz_eff_cat

    def effective_dz(self, grid):
        return self._dz_eff


class ConcatPanelsGrid(MetricCache, AbstractGrid):
    """The six panels as one grid: every horizontal metric table
    concatenated along x (a table the panels share stays one), the tensor
    (6, NP, NP, NZ) seen as (6·NP, NP, NZ). Its x interior spans every
    column but the outermost halos (halo columns between panels hold
    exchanged data and their diagnostics are wanted too); y and z keep
    their interiors."""

    def __init__(self, panel_grids):
        self._panels = list(panel_grids)
        g0 = self._panels[0]
        if any(g.padded_shape != g0.padded_shape for g in self._panels):
            raise ValueError("panels must share shape")
        self.NPX = g0.padded_shape[0]
        self.H = g0.H
        self.N = (len(self._panels) * self.NPX - 2 * g0.H[0], g0.N[1],
                  g0.N[2])
        self.topology = g0.topology
        self.dtype, self.device = g0.dtype, g0.device
        self.radius = g0.radius
        self._zc = g0._zc
        self._cache = {}
        self._np = {}

    def regular(self, axis):
        return self._panels[0].regular(axis)

    @property
    def extent(self):
        return self._panels[0].extent

    def coord_padded(self, axis, loc):
        if axis == 2:
            return self._panels[0].coord_padded(2, loc)
        raise ValueError("ConcatPanelsGrid has no 1-D horizontal "
                         "coordinates (curvilinear panels): use "
                         "nodes2d_padded")

    def znodes(self, loc="c"):
        return self._panels[0].znodes(loc)

    def minimum_spacing(self, axis):
        return min(g.minimum_spacing(axis) for g in self._panels)

    def _cat2d(self, name, loc):
        key = (name, tuple(loc))
        if key not in self._np:
            parts = [g.metric_numpy(name, loc) for g in self._panels]
            if all(np.shape(p) == np.shape(parts[0])
                   and np.array_equal(p, parts[0]) for p in parts[1:]):
                out = parts[0]
            else:
                shp = self._panels[0].padded_shape
                blocks = [np.broadcast_to(
                    np.asarray(p, np.float64),
                    (shp[0], shp[1], np.shape(p)[2] if np.ndim(p) == 3
                     and np.shape(p)[2] != 1 else 1)) for p in parts]
                if len({b.shape[2] for b in blocks}) > 1:
                    blocks = [np.broadcast_to(b, shp) for b in blocks]
                out = np.ascontiguousarray(np.concatenate(blocks, axis=0))
            self._np[key] = out
        return self._np[key]

    def metric_numpy(self, name, loc):
        if name in ("dx", "dy", "dz", "Az"):
            return self._cat2d(name, loc)
        if name == "Ax":
            return self._cat2d("dy", loc) * self._cat2d("dz", loc)
        if name == "Ay":
            return self._cat2d("dx", loc) * self._cat2d("dz", loc)
        if name == "V":
            return self._cat2d("Az", loc) * self._cat2d("dz", loc)
        raise ValueError(f"unknown metric {name!r}")

    def nodes2d_padded(self, loc=("c", "c")):
        key = ("nodes", tuple(loc[:2]))
        if key not in self._np:
            parts = [g.nodes2d_padded(loc) for g in self._panels]
            self._np[key] = tuple(np.concatenate([p[k] for p in parts],
                                                 axis=0) for k in (0, 1))
        return self._np[key]

    def _fingerprint(self):
        return ("ConcatPanelsGrid",) + tuple(g._fingerprint()
                                             for g in self._panels)

    def __repr__(self):
        return f"ConcatPanelsGrid(6x{self._panels[0].N})"


def concat_panels_grid(panel_grids):
    """The panels (each possibly an ImmersedBoundaryGrid) as one grid: the
    underlying shell grids concatenate into a ``ConcatPanelsGrid``; immersed
    panels wrap it in an ImmersedBoundaryGrid whose solid mask (and
    partial-cell spacings) are the panels' concatenated."""
    from ..immersed import ImmersedBoundaryGrid
    if not isinstance(panel_grids[0], ImmersedBoundaryGrid):
        return ConcatPanelsGrid(panel_grids)
    under = ConcatPanelsGrid([g.underlying_grid for g in panel_grids])
    solid_cat = np.concatenate([g.solid_ccc for g in panel_grids], axis=0)
    fp = tuple(g._fingerprint() for g in panel_grids)
    dzs = [g._dz_eff for g in panel_grids]
    if any(d is not None for d in dzs):
        if not all(d is not None for d in dzs):
            raise ValueError("mixed PartialCell/GridFitted panels")
        shp = panel_grids[0].padded_shape
        dz_cat = {key: np.ascontiguousarray(np.concatenate(
            [np.broadcast_to(np.asarray(d[key], np.float64), shp)
             for d in dzs], axis=0)) for key in dzs[0]}
        return ImmersedBoundaryGrid(under, _ConcatPartialBoundary(
            solid_cat, dz_cat, fp))
    return ImmersedBoundaryGrid(under, _ConcatBoundary(solid_cat, fp))


__all__ = ["ConformalCubedSphereGrid", "ConcatPanelsGrid", "PanelExchange",
           "ShardPanelExchange",
           "concat_panels_grid",
           "fill_cubed_sphere_halos", "fill_cubed_sphere_velocity_halos",
           "sync_shared_velocity_faces", "derive_connectivity",
           "derive_edge_rotations", "elliptic_cubed_sphere_nodes",
           "panel_corner_coordinates", "PANEL_ROTATIONS"]
