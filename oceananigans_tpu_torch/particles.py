"""Lagrangian particle tracking.

Counterpart of ``oceananigans_tpu/particles.py``: positions are (n,)
tensors in the model state (``state["particles"]``), advected by forward
Euler with the velocities interpolated trilinearly at fractional indices
(found by linear interpolation against the padded coordinates, so
stretched grids work too); walls bounce with restitution, periodic axes
wrap, and on an immersed grid a particle advected into a solid cell
bounces back into its previous cell. Tracked fields are interpolated at
their own locations. Everything is vectorized over the particles on the
grid's device.

On a device mesh the particles are replicated, as the JAX package leaves
them (not 3-D, so not sharded): every shard holds every position. Each
shard interpolates the particles inside its block (a particle on a shared
face belongs to the higher block, so each is counted once), the others
contribute zeros, and one ``all_reduce`` a sampling adds the shards'
contributions, so that every shard reads the serial values bit for bit and
steps the same positions; the walls and the wrap are the global grid's.
"""

from __future__ import annotations

import numpy as np
import torch

from .grids.topology import BOUNDED, LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC, PERIODIC


def _interp_index(x, xp):
    """``np.interp(x, xp, arange(len(xp)))`` as the JAX ``jnp.interp``
    evaluates it: the index i - 1 + (x - xp[i-1]) / (xp[i] - xp[i-1]),
    clamped to [0, len(xp) - 1] outside xp."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    lo = xp[i - 1]
    dx = xp[i] - lo
    eps = np.spacing(np.finfo(np.dtype(str(x.dtype).split(".")[-1])).eps)
    small = dx.abs() <= eps
    f = (i - 1).to(x.dtype) + (x - lo) / torch.where(small, torch.ones_like(dx),
                                                     dx)
    f = torch.where(small, (i - 1).to(x.dtype), f)
    f = torch.where(x < xp[0], torch.zeros_like(f), f)
    return torch.where(x > xp[-1], torch.full_like(f, n - 1), f)


def fractional_index(grid, axis, loc_axis, x):
    """The continuous padded index whose integer values sit on the data
    points of ``loc_axis`` along ``axis``."""
    coords = torch.as_tensor(np.asarray(grid.coord_padded(axis, loc_axis)),
                             dtype=x.dtype, device=x.device)
    return _interp_index(x, coords)


def interpolate_field(grid, data, loc, x, y, z):
    """A padded field interpolated trilinearly at the positions (x, y,
    z)."""
    idx = []
    for axis, (pos, l) in enumerate(zip((x, y, z), loc)):
        idx.append(torch.zeros_like(pos) if grid.is_flat(axis)
                   else fractional_index(grid, axis, l, pos))
    i, j, k = idx
    n0, n1, n2 = data.shape
    i0 = torch.clamp(torch.floor(i).to(torch.int64), 0, n0 - 1)
    j0 = torch.clamp(torch.floor(j).to(torch.int64), 0, n1 - 1)
    k0 = torch.clamp(torch.floor(k).to(torch.int64), 0, n2 - 1)
    i1 = torch.clamp(i0 + 1, max=n0 - 1)
    j1 = torch.clamp(j0 + 1, max=n1 - 1)
    k1 = torch.clamp(k0 + 1, max=n2 - 1)
    fx = torch.clamp(i - i0.to(i.dtype), 0.0, 1.0)
    fy = torch.clamp(j - j0.to(j.dtype), 0.0, 1.0)
    fz = torch.clamp(k - k0.to(k.dtype), 0.0, 1.0)
    c00 = data[i0, j0, k0] * (1 - fx) + data[i1, j0, k0] * fx
    c10 = data[i0, j1, k0] * (1 - fx) + data[i1, j1, k0] * fx
    c01 = data[i0, j0, k1] * (1 - fx) + data[i1, j0, k1] * fx
    c11 = data[i0, j1, k1] * (1 - fx) + data[i1, j1, k1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _owned(grid, x, y):
    """The particles inside the interior block of a shard's ``grid``: each
    x and y range half open, closed at the global grid's high end."""
    shard = grid.shard
    mask = torch.ones_like(x, dtype=torch.bool)
    for axis, pos in ((0, x), (1, y)):
        if grid.is_flat(axis):
            continue
        H, n = grid.H[axis], grid.N[axis]
        faces = np.asarray(grid.coord_padded(axis, "f"), np.float64)
        lo, hi = float(faces[H]), float(faces[H + n])
        last = shard.offset[axis] + n == shard.global_grid.N[axis]
        mask = mask & (pos >= lo) & ((pos <= hi) if last else (pos < hi))
    return mask


def sample(grid, items, x, y, z):
    """``interpolate_field`` of each (padded data, location) of ``items``
    at the positions; on a shard's grid, each shard's own particles summed
    over the mesh (one ``all_reduce``)."""
    vals = [interpolate_field(grid, data, loc, x, y, z)
            for data, loc in items]
    shard = getattr(grid, "shard", None)
    if shard is None or not vals:
        return vals
    mask = _owned(grid, x, y)
    mine = torch.stack([torch.where(mask, v, torch.zeros_like(v))
                        for v in vals])
    return list(shard.all_reduce(mine).unbind(0))


class LagrangianParticles:
    """The particles' configuration and advection. ``properties``: {name:
    (n,) array} carried with the positions; ``dynamics``: a
    DroguedParticleDynamics, or ``dynamics(grid, fields, particles, dt) ->
    particles`` run after advection; ``tracked_fields``: names of fields
    interpolated onto the particles after each step."""

    def __init__(self, x, y, z, restitution=1.0, tracked_fields=(),
                 dynamics=None, properties=None):
        self.n = len(np.atleast_1d(x))
        self.initial = dict(x=np.atleast_1d(x), y=np.atleast_1d(y),
                            z=np.atleast_1d(z))
        for name, val in dict(properties or {}).items():
            self.initial[name] = np.atleast_1d(val)
        self.restitution = float(restitution)
        self.tracked_fields = tuple(tracked_fields)
        self.dynamics = dynamics

    def initial_state(self, grid):
        """The initial positions and properties as tensors of the grid's
        dtype on its device (tensors given are moved there)."""
        return {k: torch.as_tensor(v, dtype=grid.dtype, device=grid.device)
                for k, v in self.initial.items()}

    def _bounce(self, grid, axis, pos):
        """A periodic wrap, or a wall bounce with restitution."""
        topo = grid.topology[axis]
        c = grid.coord_padded(axis, "f")
        lo = float(c[grid.H[axis]])
        hi = lo + float(grid.extent[axis])
        if topo == PERIODIC:
            return lo + torch.remainder(pos - lo, hi - lo)
        if topo == BOUNDED:
            r = self.restitution
            over = torch.clamp(pos - hi, min=0.0)
            under = torch.clamp(lo - pos, min=0.0)
            return torch.clamp(pos - (1 + r) * over + (1 + r) * under, lo, hi)
        return pos

    def _cell_index(self, grid, axis, pos):
        """The padded index of the cell holding ``pos`` (face i is cell i's
        left face)."""
        fi = fractional_index(grid, axis, "f", pos)
        return torch.clamp(torch.floor(fi).to(torch.int64), 0,
                           grid.padded_shape[axis] - 1)

    def _bounce_immersed(self, grid, prev, pos):
        """Particles advected into a solid cell bounce back into their
        previous cell with restitution."""
        solid = torch.as_tensor(np.asarray(grid.solid_ccc),
                                device=pos[0].device)
        idx = [self._cell_index(grid, ax, p) if not grid.is_flat(ax)
               else torch.zeros_like(p, dtype=torch.int64)
               for ax, p in enumerate(pos)]
        immersed = solid[tuple(idx)]
        r = self.restitution
        out = []
        for ax, (p0, p) in enumerate(zip(prev, pos)):
            if grid.is_flat(ax):
                out.append(p)
                continue
            faces = torch.as_tensor(np.asarray(grid.coord_padded(ax, "f")),
                                    dtype=p.dtype, device=p.device)
            i_prev = self._cell_index(grid, ax, p0)
            lo = faces[i_prev]
            hi = faces[torch.clamp(i_prev + 1, max=faces.shape[0] - 1)]
            over = torch.clamp(p - hi, min=0.0)
            under = torch.clamp(lo - p, min=0.0)
            pb = torch.minimum(torch.maximum(
                p - (1 + r) * over + (1 + r) * under, lo), hi)
            out.append(torch.where(immersed, pb, p))
        return tuple(out)

    def advect(self, grid, u, v, w, particles, dt, fields=None):
        """One forward-Euler step of every particle: the velocities at the
        positions before the step; drogued particles take u and v at their
        drogue depths and keep z."""
        x0, y0, z0 = particles["x"], particles["y"], particles["z"]
        x, y, z = x0, y0, z0
        drogued = isinstance(self.dynamics, DroguedParticleDynamics)
        zs = (torch.as_tensor(self.dynamics.depths, dtype=z.dtype,
                              device=z.device).broadcast_to(z.shape)
              if drogued else z)
        shard = getattr(grid, "shard", None)
        if shard is not None and self.dynamics is not None and not drogued:
            raise NotImplementedError(
                "a particle dynamics callable on a device mesh: it reads the "
                "global fields, which no shard holds")
        if drogued:
            up, vp = sample(grid, [(u, LOC_FCC), (v, LOC_CFC)], x, y, zs)
        else:
            up, vp, wp = sample(grid, [(u, LOC_FCC), (v, LOC_CFC),
                                       (w, LOC_CCF)], x, y, z)
        # the walls, the wrap and the solid cells are the global grid's
        grid = grid if shard is None else shard.global_grid
        dt = float(dt)
        x = x + dt * up
        y = y + dt * vp
        if not drogued:
            z = z + dt * wp
            if not grid.is_flat(2):
                z = self._bounce(grid, 2, z)
        if not grid.is_flat(0):
            x = self._bounce(grid, 0, x)
        if not grid.is_flat(1):
            y = self._bounce(grid, 1, y)
        if hasattr(grid, "solid_ccc"):
            x, y, z = self._bounce_immersed(grid, (x0, y0, z0), (x, y, z))
        new = dict(particles, x=x, y=y, z=z)
        if self.dynamics is not None and not drogued \
                and callable(self.dynamics):
            new = self.dynamics(grid, fields or {}, new, dt)
        return new

    _FIELD_LOCS = {"u": LOC_FCC, "v": LOC_CFC, "w": LOC_CCF}

    def track(self, grid, fields, particles):
        """The tracked fields interpolated onto the particles, each at its
        own location."""
        out = dict(particles)
        names = self.tracked_fields
        vals = sample(grid, [(fields[n], self._FIELD_LOCS.get(n, LOC_CCC))
                             for n in names],
                      particles["x"], particles["y"], particles["z"])
        out.update(zip(names, vals))
        return out

    def step(self, grid, fields, particles, dt):
        """Advect, then track: what a model runs at the end of its step."""
        parts = self.advect(grid, fields["u"], fields["v"], fields["w"],
                            particles, dt, fields=fields)
        return self.track(grid, fields, parts)


class DroguedParticleDynamics:
    """Particles drogued at fixed ``depths``: advected horizontally by the
    velocity there, their z unchanged."""

    def __init__(self, depths):
        self.depths = np.atleast_1d(depths)
