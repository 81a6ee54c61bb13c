"""Shallow water on the six-panel cubed sphere.

Counterpart of ``oceananigans_tpu/models/cubed_sphere_shallow_water.py``:
the C-grid vector-invariant equations with the Sadourny (1975) energy- or
enstrophy-conserving potential-vorticity flux (q = (ζ + f)/h with
thickness-weighted mass fluxes), flux-form continuity and the
Wicker-Skamarock RK3 (each stage from the step's start, fractions 1/3, 1/2,
1). Global mass is conserved to roundoff: both panels of a shared face
compute its flux from the same (synced and exchanged) values.

At the eight cube vertices three panels meet and the four-term
circulation of ``zeta3_ffc`` reads a cell that does not exist; there the
vorticity is the circulation around the dual triangle through the three
adjacent cell centres (each panel sees two of its three edges, so the
members' partial circulations sum to twice it) and the thickness the mean
of the three cells (``_vertex_corner_info``, ``VertexFix``).

The state is ``fields`` h, u and v, (6, NP, NP, 1) tensors (u and v the
panels' local staggered components), and ``clock``. The tendencies run
once over the six panels concatenated along x (``ConcatPanelsGrid``), the
JAX model's per-panel formulas on the (6·NP, NP, 1) view, or with
``batch_panels=False`` panel by panel (bit for bit the same: every slot's
operands are the same); the exchange is the grid's ``PanelExchange``. On a
panel mesh (``model.state = arch.shard(model.state)``, as the hydrostatic
model's) each shard steps its panels per panel and the shards meet in the
panel exchange and the vertex vorticity. Where the JAX model evaluates the vertex fix
member by member, the port sums the three members' partial circulations in
one reduction (roundoff).
"""

from __future__ import annotations

import numpy as np
import torch

from ..defaults import defaults, numpy_dtype
from ..grids.cubed_sphere import ShardPanelExchange, concat_panels_grid
from ..grids.orthogonal_spherical_shell import _spherical_triangle_excess
from ..grids.topology import LOC_CCC, LOC_CFC, LOC_FCC
from ..parallel.distributed import MeshModel
from ..operators.operators import (ddx, ddy, dx_c, dy_c, ix_c, ix_f, iy_c,
                                   iy_f, zeta3_ffc)
from ..utils.dateclock import datetime_of


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def staggered_points_and_bases(csgrid):
    """Per panel, the padded-layout positions of the u points (x faces, y
    centres) and v points and their unit face-normal directions (the
    transport-velocity convention: u is the component normal to its face, so
    u·h̄·Δy is the true normal transport), oriented along increasing index.
    Returns (Pu, exu, Pv, eyv), lists over panels of (NP, NP, 3) arrays
    (face slot i = node i - H; outside the valid staggered range the edge
    is repeated)."""
    H, N = csgrid.H[0], csgrid.N[0]
    NP = N + 2 * H
    out = ([], [], [], [])
    for ext in csgrid.extended_nodes:
        Pxm = _unit(ext[:-1] + ext[1:])
        Pym = _unit(ext[:, :-1] + ext[:, 1:])
        Pc = _unit(Pxm[:, :-1] + Pxm[:, 1:])
        Pu = Pym[:, :]
        exu = _unit(np.cross(ext[:, 1:] - ext[:, :-1], Pu))
        cd = np.zeros_like(Pu)
        cd[1:-1] = Pc[1:] - Pc[:-1]
        cd[0], cd[-1] = cd[1], cd[-2]
        exu *= np.sign(np.sum(exu * cd, -1, keepdims=True))
        Pv = Pxm[:, :]
        eyv = _unit(np.cross(ext[1:, :] - ext[:-1, :], Pv))
        cd = np.zeros_like(Pv)
        cd[:, 1:-1] = Pc[:, 1:] - Pc[:, :-1]
        cd[:, 0], cd[:, -1] = cd[:, 1], cd[:, -2]
        eyv *= np.sign(np.sum(eyv * cd, -1, keepdims=True))
        for k, a in enumerate((Pu, exu, Pv, eyv)):
            out[k].append(a[:NP, :NP])
    return out


def _vertex_corner_info(csgrid):
    """The 8 cube vertices: for each, its 3 (panel, i0, j0) corner ffc
    slots and the spherical area of the dual triangle through the 3
    adjacent cell centres."""
    H, N = csgrid.H[0], csgrid.N[0]
    corners = [(H, H), (H, H + N), (H + N, H), (H + N, H + N)]
    groups = {}
    for p in range(6):
        ext = csgrid.extended_nodes[p]
        for (i0, j0) in corners:
            groups.setdefault(tuple(np.round(ext[i0, j0], 9)), []).append(
                (p, i0, j0))
    info = []
    for members in groups.values():
        assert len(members) == 3, members
        cs = []
        for (p, i0, j0) in members:
            ext = csgrid.extended_nodes[p]
            ci = i0 if i0 == H else i0 - 1
            cj = j0 if j0 == H else j0 - 1
            quad = (ext[ci, cj] + ext[ci + 1, cj]
                    + ext[ci, cj + 1] + ext[ci + 1, cj + 1])
            cs.append(quad / np.linalg.norm(quad))
        info.append((members, float(_spherical_triangle_excess(*cs))
                     * csgrid.radius ** 2))
    return info


class VertexFix:
    """The valence-3 vertex vorticity (and thickness) as gathers and a
    scatter on the concatenated (6·NP, NP, NZ) view: each vertex sums its 3
    members' partial circulations ±Δy·v ∓Δx·u, divides by twice the dual
    triangle's area and overwrites the 24 corner slots."""

    def __init__(self, csgrid, info):
        H = csgrid.H[0]
        NPX = csgrid.N[0] + 2 * H
        t = {k: [] for k in ("vr", "vj", "wv", "ur", "uj", "wu", "sr", "sj",
                             "hr1", "hj1", "hr2", "hj2", "hr3", "hj3")}
        areas = []
        for members, A in info:
            areas.append(A)
            for (p, i0, j0) in members:
                g = csgrid.panel_grids[p]
                dycf = g.metric_numpy("dy", LOC_CFC)
                dxfc = g.metric_numpy("dx", LOC_FCC)
                vi = i0 if i0 == H else i0 - 1
                t["vr"].append(p * NPX + vi)
                t["vj"].append(j0)
                t["wv"].append(dycf[vi, j0, 0] * (1 if i0 == H else -1))
                uj = j0 if j0 == H else j0 - 1
                t["ur"].append(p * NPX + i0)
                t["uj"].append(uj)
                t["wu"].append(dxfc[i0, uj, 0] * (-1 if j0 == H else 1))
                t["sr"].append(p * NPX + i0)
                t["sj"].append(j0)
                ci = i0 if i0 == H else i0 - 1
                cj = j0 if j0 == H else j0 - 1
                oi = i0 - 1 if i0 == H else i0
                oj = j0 - 1 if j0 == H else j0
                for k, (a, b) in enumerate(((ci, cj), (oi, cj), (ci, oj)),
                                           1):
                    t[f"hr{k}"].append(p * NPX + a)
                    t[f"hj{k}"].append(b)
        self._np = {k: np.asarray(v) for k, v in t.items()}
        self._np["two_A"] = 2.0 * np.asarray(areas)
        self.ngroups = len(info)
        self._dev = {}

    def _t(self, like):
        key = (like.device, like.dtype)
        if key not in self._dev:
            self._dev[key] = {
                k: torch.as_tensor(v, device=like.device,
                                   dtype=(like.dtype if v.dtype.kind == "f"
                                          else torch.long))
                for k, v in self._np.items()}
        return self._dev[key]

    def zeta(self, zeta, u, v):
        """``zeta`` (the concatenated curl) with its vertex slots replaced,
        in place; returns it."""
        t = self._t(u)
        tot = (t["wv"][:, None] * v[t["vr"], t["vj"]]
               + t["wu"][:, None] * u[t["ur"], t["uj"]])
        zv = tot.reshape(self.ngroups, 3, -1).sum(1) / t["two_A"][:, None]
        zeta[t["sr"], t["sj"]] = torch.repeat_interleave(zv, 3, dim=0)
        return zeta

    def thickness(self, hff, h):
        """``hff`` with its vertex slots set to the mean of the 3 cells
        around each corner, in place; returns it."""
        t = self._t(h)
        hv = (h[t["hr1"], t["hj1"]] + h[t["hr2"], t["hj2"]]
              + h[t["hr3"], t["hj3"]]) / 3.0
        hff[t["sr"], t["sj"]] = hv
        return hff


# VertexFix's tables of rows of the concatenated (6·NP, NP, NZ) view
ROW_TABLES = ("vr", "ur", "sr", "hr1", "hr2", "hr3")


class ShardVertexFix:
    """``VertexFix`` on one shard of a panel mesh, on the concatenated view
    (k·NP, NP, NZ) of its k panels: the shard computes its own members'
    partial circulations, the shards meet once (the communicator's
    ``all_to_all``, every shard's members to every shard: 24 columns in
    all) and each sums every vertex's three members in the serial order
    and writes its own corner slots. The thickness reads only the member's
    own panel (its exchanged halo cells) and needs no meeting."""

    def __init__(self, vertex, shard, NPX):
        self.shard = shard
        self.ngroups = vertex.ngroups
        t = vertex._np
        p0 = shard.panels.start
        panel = t["sr"] // NPX
        own = (panel >= p0) & (panel < shard.panels.stop)
        self._np = {}
        for key, val in t.items():
            if key == "two_A":
                self._np[key] = val
                continue
            # the row tables index the concatenated panels: local rows
            self._np[key] = val[own] - (p0 * NPX if key in ROW_TABLES
                                        else 0)
        # the members in rank order, put back into the serial order
        S = shard.comm.size
        k = len(shard.panels)
        by_rank = np.concatenate([np.nonzero((panel >= r * k)
                                             & (panel < (r + 1) * k))[0]
                                  for r in range(S)])
        self._np["order"] = np.argsort(by_rank)
        # the vertex of each of this shard's members
        self._np["group"] = np.nonzero(own)[0] // 3
        self._dev = {}
        self.bytes = 0

    _t = VertexFix._t

    def zeta(self, zeta, u, v):
        t = self._t(u)
        mine = (t["wv"][:, None] * v[t["vr"], t["vj"]]
                + t["wu"][:, None] * u[t["ur"], t["uj"]])
        comm = self.shard.comm
        if comm.size > 1:
            got = comm.all_to_all(self.shard.rank, [mine] * comm.size)
            self.bytes += (comm.size - 1) * mine.numel() * mine.element_size()
            tot = torch.index_select(torch.cat(got), 0, t["order"])
        else:
            tot = mine
        zv = tot.reshape(self.ngroups, 3, -1).sum(1) / t["two_A"][:, None]
        zeta[t["sr"], t["sj"]] = zv[t["group"]]
        return zeta

    thickness = VertexFix.thickness


class CubedSphereShallowWaterModel(MeshModel):
    """Rotating shallow water on a ``ConformalCubedSphereGrid``.

    ``fields``: ``h`` (the fluid thickness at the centres) and ``u``, ``v``
    (the staggered local components), all (6, NP, NP, 1).
    ``rotation_rate``: Ω about ẑ (f = 2Ω sin φ taken exactly at the (f, f)
    nodes). ``pv_scheme``: "energy_conserving" or "enstrophy_conserving"."""

    def _enter_mesh(self, arch):
        """Put the model on the panel mesh ``arch`` (``model.state =
        arch.shard(model.state)``): one per-panel model a shard over its
        panels; the shards meet in the panel exchange and the vertex
        vorticity. This model's own state is dropped: assign a state to
        scatter it."""
        shards = arch.panel_shards_of(self.grid)
        self.architecture = arch
        self._comm = arch.communicator
        self._shards = [CubedSphereShallowWaterModel(
            self.grid, gravity=self.gravity,
            rotation_rate=self.rotation_rate, pv_scheme=self.pv_scheme,
            reference_datetime=self.reference_datetime, batch_panels=False,
            _shard=sh) for sh in shards]
        self._state = None

    def __init__(self, grid, gravity=None, rotation_rate=0.0,
                 pv_scheme="energy_conserving", reference_datetime=None,
                 batch_panels=True, _shard=None):
        if pv_scheme not in ("energy_conserving", "enstrophy_conserving"):
            raise ValueError(pv_scheme)
        self.architecture = None
        self.pv_scheme = pv_scheme
        self.reference_datetime = reference_datetime
        self.grid = grid
        self.gravity = float(gravity if gravity is not None
                             else defaults.gravitational_acceleration)
        self.rotation_rate = float(rotation_rate)
        H, N = grid.H[0], grid.N[0]
        self._NPX = NP = N + 2 * H
        # the panels this model steps: all six, or a panel shard's
        ids = tuple(range(6) if _shard is None else _shard.panels)
        self._k = len(ids)
        self._batch = bool(batch_panels)
        kw = dict(dtype=grid.dtype, device=grid.device)
        self._panel_grids = [grid.panel_grids[p] for p in ids]
        self._cat = concat_panels_grid(self._panel_grids)
        f = np.concatenate([2.0 * self.rotation_rate * ext[:NP, :NP, 2]
                            for ext in (grid.extended_nodes[p]
                                        for p in ids)])[..., None]
        self._f = torch.as_tensor(f, **kw)
        self._nt = numpy_dtype(grid.dtype)
        shape = (self._k, NP, NP, 1)
        self.state = dict(
            fields={n: torch.zeros(shape, **kw) for n in ("h", "u", "v")},
            clock=dict(time=self._nt(0), iteration=0,
                       last_dt=self._nt(np.inf)))
        self._corner_info = _vertex_corner_info(grid)
        self._vertex = VertexFix(grid, self._corner_info)
        self.exchange = grid.exchange
        if _shard is None:
            self._geom = staggered_points_and_bases(grid)
        else:
            self._vertex = ShardVertexFix(self._vertex, _shard, NP)
            self.exchange = ShardPanelExchange(grid.exchange, _shard)

    prognostic_names = ("h", "u", "v")

    # -- initialization -------------------------------------------------------

    def set_geographic(self, h=None, u_east=None, v_north=None):
        """Set from functions of geographic (λ, φ) in radians (numpy
        arrays): ``h`` the thickness, ``u_east`` and ``v_north`` the
        velocity, projected on each panel's staggered directions."""
        out = _geographic_values(self.grid, self._geom, h, u_east, v_north)
        fields = dict(self.state["fields"])
        kw = dict(dtype=self.grid.dtype, device=self.grid.device)
        for name, arr in out.items():
            fields[name] = torch.as_tensor(arr[..., None], **kw)
        self.state = {**self.state, "fields": fields}

    # -- dynamics -------------------------------------------------------------

    def _c(self, a):
        return a.reshape((self._k * self._NPX,) + a.shape[2:])

    def _s(self, a):
        return a.reshape((self._k, self._NPX) + a.shape[1:])

    def _filled(self, h, u, v):
        ex = self.exchange
        return (ex.centers(h),) + ex.velocities(u, v)

    def _per_panel(self, fn, *args):
        """``fn(grid, *args)`` on the concatenated view (batched), or on
        each panel's grid and slices, concatenated (per panel)."""
        if self._batch:
            return fn(self._cat, *args)
        NP = self._NPX
        outs = [fn(g, *(a[p * NP:(p + 1) * NP] for a in args))
                for p, g in enumerate(self._panel_grids)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(z) for z in zip(*outs))
        return torch.cat(outs)

    def _tendencies(self, h, u, v):
        """(Gh, Gu, Gv) on the concatenated view of filled (h, u, v): the
        vorticity and the corner thickness over the panels, the vertex fix
        on the concatenated view, the rest per panel or batched."""
        P = self._per_panel
        zeta = self._vertex.zeta(P(zeta3_ffc, u, v), u, v)
        hff = self._vertex.thickness(P(lambda g, a: iy_f(g, ix_f(g, a)), h),
                                     h)
        return P(self._rest, h, u, v, zeta, hff, self._f)

    def _rest(self, g, h, u, v, zeta, hff, f):
        Uf = g.dy(LOC_FCC) * ix_f(g, h) * u
        Vf = g.dx(LOC_CFC) * iy_f(g, h) * v
        Gh = -(dx_c(g, Uf) + dy_c(g, Vf)) / g.Az(LOC_CCC)
        q = (zeta + f) / hff
        if self.pv_scheme == "energy_conserving":
            cor_u = +iy_c(g, q * ix_f(g, Vf)) / g.dx(LOC_FCC)
            cor_v = -ix_c(g, q * iy_f(g, Uf)) / g.dy(LOC_CFC)
        else:
            cor_u = +iy_c(g, q) * iy_c(g, ix_f(g, Vf)) / g.dx(LOC_FCC)
            cor_v = -ix_c(g, q) * ix_c(g, iy_f(g, Uf)) / g.dy(LOC_CFC)
        B = self.gravity * h + 0.5 * (ix_c(g, u * u) + iy_c(g, v * v))
        return Gh, cor_u - ddx(g, B, LOC_FCC), cor_v - ddy(g, B, LOC_CFC)

    def time_step(self, dt):
        """One Wicker-Skamarock RK3 step; the stored fields are filled (on
        a panel mesh every shard's panels, in the shards' threads)."""
        if self._shards is not None:
            self._run(lambda m: m.time_step(dt))
            return self
        nt = self._nt
        dt = nt(dt)
        f0 = self.state["fields"]
        h0, u0, v0 = (self._c(f0[n]) for n in ("h", "u", "v"))
        h, u, v = h0, u0, v0
        for frac in (1.0 / 3.0, 0.5, 1.0):
            Gh, Gu, Gv = self._tendencies(*self._filled(h, u, v))
            sdt = nt(frac) * dt
            h, u, v = h0 + sdt * Gh, u0 + sdt * Gu, v0 + sdt * Gv
        h, u, v = self._filled(h, u, v)
        clock = self.state["clock"]
        self.state = dict(
            fields={"h": self._s(h), "u": self._s(u), "v": self._s(v)},
            clock=dict(time=clock["time"] + dt,
                       iteration=clock["iteration"] + 1, last_dt=dt))
        return self

    @property
    def time(self):
        return float(self._clock["time"])

    @property
    def datetime(self):
        return datetime_of(self.time, self.reference_datetime)

    @property
    def iteration(self):
        return int(self._clock["iteration"])

    def field(self, name):
        """A view whose ``interior`` is the (6, N, N, 1) panel interiors
        (what the writers and the NaN checker read)."""
        return PanelFieldView(self.grid.interior(self.state["fields"][name]))

    def total_mass(self):
        """Σ h·Az over the panels' interiors (float64 on the host)."""
        H, N = self.grid.H[0], self.grid.N[0]
        h = self.state["fields"]["h"].detach().cpu().numpy()
        tot = 0.0
        for p, g in enumerate(self.grid.panel_grids):
            Az = g.metric_numpy("Az", LOC_CCC)
            tot += float((h[p, H:H + N, H:H + N]
                          * Az[H:H + N, H:H + N]).sum())
        return tot


class PanelFieldView:
    """A cubed-sphere output: ``interior`` the panels' interiors."""

    def __init__(self, interior):
        self.interior = interior


def _geographic_values(csgrid, geom, h, u_east, v_north):
    """{name: (6, NP, NP) float64}: h at the cell centres and the local
    components of the geographic velocity at the u and v points."""
    H, N = csgrid.H[0], csgrid.N[0]
    NP = N + 2 * H
    Pu, exu, Pv, eyv = geom

    def lonlat(P):
        return (np.arctan2(P[..., 1], P[..., 0]),
                np.arcsin(np.clip(P[..., 2], -1, 1)))

    def east_north(P):
        e = np.cross(np.array([0.0, 0.0, 1.0]), P)
        e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-30)
        return e, np.cross(P, e)

    def velocity(P, basis):
        lam, phi = lonlat(P)
        e, n = east_north(P)
        ue = u_east(lam, phi) if u_east is not None else 0.0
        vn = v_north(lam, phi) if v_north is not None else 0.0
        V = np.asarray(ue)[..., None] * e + np.asarray(vn)[..., None] * n
        return np.sum(V * basis, -1)

    out = {}
    if h is not None:
        hs = []
        for ext in csgrid.extended_nodes:
            Pxm = _unit(ext[:-1] + ext[1:])
            Pc = _unit(Pxm[:, :-1] + Pxm[:, 1:])[:NP, :NP]
            hs.append(np.broadcast_to(h(*lonlat(Pc)), (NP, NP)))
        out["h"] = np.stack(hs)
    if u_east is not None or v_north is not None:
        out["u"] = np.stack([velocity(Pu[p], exu[p]) for p in range(6)])
        out["v"] = np.stack([velocity(Pv[p], eyv[p]) for p in range(6)])
    return out


def state_from_jax(jax_state_numpy, model):
    """Load a JAX ``CubedSphereShallowWaterModel``'s state (its arrays as
    numpy: h, u, v of shape (6, NP, NP, 1), time, iteration) into
    ``model``."""
    kw = dict(dtype=model.grid.dtype, device=model.grid.device)
    js = jax_state_numpy
    nt = model._nt
    model.state = dict(
        fields={n: torch.as_tensor(np.array(js[n]), **kw)
                for n in ("h", "u", "v")},
        clock=dict(time=nt(js["time"]), iteration=int(js["iteration"]),
                   last_dt=nt(np.inf)))
    return model


__all__ = ["CubedSphereShallowWaterModel", "staggered_points_and_bases",
           "PanelFieldView", "state_from_jax"]
