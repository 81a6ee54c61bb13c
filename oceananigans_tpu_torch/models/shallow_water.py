"""ShallowWaterModel.

Counterpart of ``oceananigans_tpu/models/shallow_water.py`` on a
RectilinearGrid with periodic, bounded or flat x and y and a flat z. Two
formulations: the conservative one (prognostic transports uh, vh and height
h)

    ∂t uh = -∇·(𝐮 uh) - ∂x(g h²/2) - f×(uh,vh)|x - g h ∂x h_B
    ∂t h  = -∇·(uh, vh)
    ∂t c  = -∇·(𝐔 c) + c ∇·𝐔          (advective form via flux + correction)

and the vector-invariant one (u, v, h)

    ∂t u = -(ζ+f) v̂ - ∂x(g(h+h_B) + |u|²/2)

RK3, no elliptic solve. Each RK3 stage fills the halos of every field by
its boundary conditions at the stage's time (one launch of the fill kernel
on the card: the periodic wrap, and on a bounded axis each field's
conditions) and, where the configuration is eligible (conservative,
periodic x and y, constant f: ``kernels/fused_shallow_water.py``
``sw_eligible``; and, as in JAX, no closure, forcing or boundary
conditions), runs the fused shallow-water stage: one launch of the kernel
for the whole tendency and the stage update. Otherwise (a bounded axis, the
vector-invariant formulation, ``BetaPlane``, a closure, forcing or user
conditions, ``fused=False``) the tendencies are plain PyTorch, as JAX's
``_compute_tendencies``: the advective and pressure terms, the closure's
diffusivities and its momentum terms (of the velocities u = uh/ℑh, added
to the transports' tendencies as JAX adds them) and tracer terms, discrete
and continuous forcing bound to each field's location, then the boundary
fluxes of the Flux conditions; the stage updates the whole padded fields.
The vector-invariant form takes the ``VectorInvariant`` set as
``model.momentum_advection`` (JAX reads it with ``getattr``: the
upwinded and WENO vector invariants among them), else
``VectorInvariant()``.

With ``architecture=Distributed(...)`` the model is a domain decomposition
(``parallel/distributed.py``): each shard of the mesh holds its padded
blocks of every field on its own device for the whole run and steps a model
of this class on its own local grid, in threads that meet only in the halo
exchange that ends every fill. Where the serial model takes the fused stage
each shard runs #9 on its blocks (``shard_fused_sw_update``); as in the JAX
package the bathymetry's blocks then take exchanged (periodic) halos, so
with an array bathymetry the sharded step differs from the serial one near
the global edges (ROADMAP.md queue 3). The configurations the fused stage
does not take (a closure, forcing, boundary conditions, ``BetaPlane``, the
vector-invariant form, ``fused=False``) run the plain tendencies on each
shard, the bathymetry's blocks cut with the global array's halos, as JAX's
GSPMD step reads them. The mesh takes periodic x and y; a bounded one
raises, citing ROADMAP item 16b. ``model.state`` then returns a gathered
copy (writes into it do not reach the shards); ``model.state = ...`` (or
``arch.shard(...)``) scatters a global-view state into the blocks.

Against the JAX model: the TPU roundings of the halo (Hx to 8, the padded y
to 128) are dropped; the halo is the scheme's reach plus one, as the JAX
model's rule gives. As in the JAX model, the bathymetry's halos stay as
``set_on_padded`` makes them (zero for an array, the function's values at
the halo coordinates for a callable) and are never filled, so ∂x hB at the
first interior face reads that halo slot (ROADMAP.md queue 3 asks whether
they should be periodic). ``BetaPlane`` takes the plain path, which is what
the JAX ``fused=False`` path computes (its fused kernel fails on it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..advection import Centered
from ..advection.shallow_water import (advective_tracer_tendencies,
                                       conservative_tendencies)
from ..advection.vector_invariant import VectorInvariant
from ..boundary_conditions import (apply_flux_bcs_padded,
                                   fill_all_halo_regions,
                                   regularize_field_boundary_conditions)
from ..coriolis import constant_f
from ..defaults import defaults, numpy_dtype
from ..fields import Field, set_on_padded
from ..forcings.forcings import regularize_forcing
from ..grids.topology import LOC_CCC, LOC_CFC, LOC_FCC, PERIODIC
from ..kernels import fused_sw_update
from ..kernels.fused_shallow_water import (shard_fused_sw_update,
                                           sharded_bathymetry, sw_eligible)
from ..operators.operators import ddx, ddy, div_xy_ccc, ix_f, iy_f
from ..parallel.distributed import MESH_ITEM, regularize_architecture
from ..timesteppers import RK3_GAMMAS, RK3_ZETAS
from ..utils.dateclock import datetime_of
from .nonhydrostatic import padded_from_jax

CONSERVATIVE = "conservative"
VECTOR_INVARIANT = "vector_invariant"


def ConservativeFormulation():
    return CONSERVATIVE


def VectorInvariantFormulation():
    return VECTOR_INVARIANT


class ShallowWaterModel:
    def __init__(self, grid, gravitational_acceleration=None, advection=None,
                 coriolis=None, bathymetry=0.0, tracers=(), forcing=None,
                 boundary_conditions=None, formulation=CONSERVATIVE,
                 closure=None, fused="auto", architecture=None,
                 reference_datetime=None, device=None, dtype=None):
        self._shards = None
        shard_kw = dict(gravitational_acceleration=gravitational_acceleration,
                        advection=advection, coriolis=coriolis,
                        tracers=tracers, forcing=forcing,
                        boundary_conditions=boundary_conditions,
                        formulation=formulation, closure=closure,
                        reference_datetime=reference_datetime)
        if not grid.is_flat(2):
            raise ValueError("ShallowWaterModel requires a z-Flat grid")
        if formulation not in (CONSERVATIVE, VECTOR_INVARIANT):
            raise ValueError(formulation)
        if device is not None or dtype is not None:
            grid = grid.to(device=device, dtype=dtype)
        self.architecture = regularize_architecture(architecture)
        if self.architecture is not None:
            self.architecture.place(grid)
            for ax in (0, 1):
                if grid.topology[ax] != PERIODIC and not grid.is_flat(ax):
                    raise NotImplementedError(
                        f"a {grid.topology[ax]} sharded axis {'xy'[ax]}: "
                        f"{MESH_ITEM}")
        self.reference_datetime = reference_datetime
        self.g = (defaults.gravitational_acceleration
                  if gravitational_acceleration is None
                  else float(gravitational_acceleration))
        self.advection = advection if advection is not None else Centered(2)
        # +1: the advected velocity u = uh/ℑx(h) is a composed stencil;
        # reconstructing it at the innermost halo point reads h one slot
        # deeper than the scheme's own reach
        required = getattr(self.advection, "required_halo", 1) + 1
        halo = tuple(max(h, required) if not grid.is_flat(i) else 0
                     for i, h in enumerate(grid.H))
        self.grid = grid.with_halo(halo)
        if any(self.grid.topology[a] == PERIODIC
               and self.grid.N[a] < halo[a] for a in (0, 1)):
            raise ValueError("the periodic halos need Nx >= Hx and Ny >= Hy")
        self.coriolis = coriolis
        self.closure = closure
        self.formulation = formulation
        # as JAX's gate: the fused stage takes no closure, forcing or
        # boundary conditions
        eligible = (sw_eligible(self.grid, formulation, coriolis)
                    and closure is None and not forcing
                    and not boundary_conditions)
        if fused is True and not eligible:
            raise ValueError("model configuration is not eligible for the "
                             "fused shallow-water kernel")
        self.fused = fused in (True, "auto") and eligible
        if isinstance(tracers, str):
            tracers = (tracers,)
        self.tracer_names = tuple(tracers)
        self._solution = (("uh", "vh", "h") if formulation == CONSERVATIVE
                          else ("u", "v", "h"))
        self._locs = {self._solution[0]: LOC_FCC, self._solution[1]: LOC_CFC,
                      "h": LOC_CCC}
        self._locs.update({name: LOC_CCC for name in self.tracer_names})
        self.forcing = regularize_forcing(forcing)
        for name, F in self.forcing.items():
            if hasattr(F, "bind"):
                F.bind(name, self._locs.get(name, LOC_CCC), locs=self._locs)
        bcs_in = dict(boundary_conditions or {})
        unknown = set(bcs_in) - set(self._locs)
        if unknown:
            raise ValueError(f"boundary conditions for unknown fields "
                             f"{sorted(unknown)}")
        self.bcs = {name: regularize_field_boundary_conditions(
            bcs_in.get(name), self.grid, loc)
            for name, loc in self._locs.items()}
        self.bathymetry = set_on_padded(self.grid, LOC_CCC, bathymetry)
        self._nt = numpy_dtype(self.grid.dtype)
        if self.architecture is not None:
            self._build_shards(dict(shard_kw, fused=self.fused))
            return
        self.state = dict(
            fields={n: torch.zeros(self.grid.padded_shape,
                                   dtype=self.grid.dtype,
                                   device=self.grid.device)
                    for n in self.prognostic_names},
            clock=dict(time=self._nt(0), iteration=0,
                       last_dt=self._nt(np.inf)))

    # -- the shards of a model on a device mesh -----------------------------------

    def _build_shards(self, kw):
        """One model of this class per shard, on the shard's local grid."""
        arch = self.architecture
        shards = arch.shards(self.grid)
        self._comm = arch.communicator
        self._shards = [ShallowWaterModel(sh.grid, **kw) for sh in shards]
        self._scatter_bathymetry()

    def _scatter_bathymetry(self):
        """The shards' bathymetry blocks: for the fused stage with halos
        exchanged once (JAX's #9), else cut with the global array's halos
        (JAX's GSPMD step reads those)."""
        if self.fused:
            blocks = sharded_bathymetry([m.grid.shard for m in self._shards],
                                        self.bathymetry)
        else:
            blocks = self.architecture.scatter(self.bathymetry, self.grid.H)
        for m, b in zip(self._shards, blocks):
            m.bathymetry = b
        self._sharded_bathymetry = self.bathymetry

    @property
    def state(self):
        """The model state: fields and clock. On a device mesh, a gathered
        global-view copy on the mesh's first device: writes into it do not
        reach the shards (assign a state to ``model.state`` to scatter
        it)."""
        if self._shards is None:
            return self._state
        arch, H = self.architecture, self.grid.H
        return dict(fields=arch.gather([m._state["fields"]
                                        for m in self._shards], H),
                    clock=dict(self._clock))

    @state.setter
    def state(self, value):
        if self._shards is None:
            self._state = value
            return
        blocks = self.architecture.scatter(value["fields"], self.grid.H)
        for m, b in zip(self._shards, blocks):
            m._state = dict(fields=b, clock=dict(value["clock"]))

    @property
    def _clock(self):
        return (self._shards[0]._state if self._shards is not None
                else self._state)["clock"]

    @property
    def prognostic_names(self):
        return self._solution + self.tracer_names

    def loc(self, name):
        return self._locs[name]

    @property
    def time(self):
        return float(self._clock["time"])

    @property
    def datetime(self):
        """reference_datetime + the model's seconds; None without a
        reference_datetime."""
        return datetime_of(self.time, self.reference_datetime)

    @property
    def iteration(self):
        return int(self._clock["iteration"])

    def field(self, name):
        """The field ``name``, its halos refreshed at the model's time (a
        step leaves the halo slots of its last stage unwritten; interiors
        are authoritative); on a device mesh a gathered copy of the shards'
        blocks, filled on the global grid."""
        if self._shards is not None:
            data = self.architecture.gather(
                [m._state["fields"][name] for m in self._shards], self.grid.H)
        else:
            data = self.state["fields"][name]
        self._fill_all({name: data}, self.time)
        return Field(self.grid, self.loc(name), self.bcs[name], data,
                     _regularize=False)

    @property
    def fields(self):
        return {n: self.field(n) for n in self.prognostic_names}

    def set(self, **values):
        if self._shards is not None:
            for name in values:
                if name not in self.prognostic_names:
                    raise ValueError(f"unknown prognostic field {name!r}")
            blocks = self.architecture.scatter(
                {n: set_on_padded(self.grid, self.loc(n), v)
                 for n, v in values.items()}, self.grid.H)
            self._comm.run(lambda r: self._shards[r].set(**blocks[r]))
            return
        fields = dict(self.state["fields"])
        for name, value in values.items():
            if name not in fields:
                raise ValueError(f"unknown prognostic field {name!r}")
            fields[name] = set_on_padded(self.grid, self.loc(name), value)
        self._fill_all({name: fields[name] for name in values}, self.time)
        self.state = {**self.state, "fields": fields}

    # -- physics --------------------------------------------------------------

    def _velocities(self, fields):
        if self.formulation == CONSERVATIVE:
            h = fields["h"]
            return (fields["uh"] / ix_f(self.grid, h),
                    fields["vh"] / iy_f(self.grid, h))
        return fields["u"], fields["v"]

    def _transports(self, fields):
        if self.formulation == CONSERVATIVE:
            return fields["uh"], fields["vh"]
        h = fields["h"]
        return (fields["u"] * ix_f(self.grid, h),
                fields["v"] * iy_f(self.grid, h))

    def _compute_tendencies(self, fields, time=0.0):
        """The plain PyTorch tendencies of every prognostic field, padded,
        in JAX's order: advection, pressure and Coriolis; the closure;
        forcing; the boundary fluxes."""
        grid = self.grid
        u, v = self._velocities(fields)
        if self.formulation == CONSERVATIVE:
            G = conservative_tendencies(
                grid, self.advection, self.g, self.coriolis, self.bathymetry,
                self.tracer_names, fields)
        else:
            g, h, hB = self.g, fields["h"], self.bathymetry
            uh, vh = self._transports(fields)
            vi = getattr(self, "momentum_advection", None)
            if not isinstance(vi, VectorInvariant):
                vi = VectorInvariant()
            h_u, h_v = vi._horizontal(grid, u, v)
            b_u, b_v = vi._bernoulli(grid, u, v)
            Gu = -(h_u + b_u) - ddx(grid, g * (h + hB), LOC_FCC)
            Gv = -(h_v + b_v) - ddy(grid, g * (h + hB), LOC_CFC)
            if self.coriolis is not None:
                w0 = torch.zeros_like(u)
                Gu = Gu - self.coriolis.x_f_cross_U(grid, u, v, w0)
                Gv = Gv - self.coriolis.y_f_cross_U(grid, u, v, w0)
            G = {"u": Gu, "v": Gv,
                 "h": (-div_xy_ccc(grid, uh, vh) * grid.V(LOC_CCC)
                       / grid.Az(LOC_CCC))}
            G.update(advective_tracer_tendencies(
                grid, self.advection, uh, vh, self.tracer_names, fields))
        mom = self._solution[:2]
        if self.closure is not None:
            cf = dict(fields, u=u, v=v, w=torch.zeros_like(u))
            aux = self.closure.compute_diffusivities(grid, cf, time)
            mt = self.closure.momentum_tendencies(grid, cf, aux)
            G[mom[0]] = G[mom[0]] + mt["u"]
            G[mom[1]] = G[mom[1]] + mt["v"]
            for name in self.tracer_names:
                G[name] = G[name] + self.closure.tracer_tendency(
                    grid, name, fields, aux)
        for name, F in self.forcing.items():
            G[name] = G[name] + (F(grid, fields, time) if callable(F) else F)
        for name in G:
            apply_flux_bcs_padded(G[name], grid, self.loc(name),
                                  self.bcs[name], time, fields=fields,
                                  locs=self._locs)
        return G

    def _fill_all(self, fields, time=0.0):
        """Fill the halos of ``fields`` ({name: padded tensor}) in place by
        their conditions at ``time``, one fill launch for all of them."""
        fill_all_halo_regions(list(fields.values()), self.grid,
                              [(self.loc(n), self.bcs[n]) for n in fields],
                              float(time))
        return fields

    def time_step(self, dt):
        """Advance the model state by one Δt with RK3. As the JAX step
        donates its state, the step consumes the state's tensors: each stage
        writes new tensors and the previous stage's are released, so at most
        two sets of fields and two of tendencies are alive. On a device
        mesh every shard steps its own blocks, in the shards' threads."""
        if self._shards is not None:
            if self._sharded_bathymetry is not self.bathymetry:
                self._scatter_bathymetry()
            vi = getattr(self, "momentum_advection", None)
            for m in self._shards:
                if vi is not None:
                    m.momentum_advection = vi
            self._comm.run(lambda r: self._shards[r].time_step(dt))
            return self
        nt = self._nt
        dt = nt(dt)
        names = self.prognostic_names
        fields = self.state["fields"]
        clock = self.state["clock"]
        self.state = {**self.state, "fields": None}
        time = clock["time"]
        f = constant_f(self.coriolis)
        # a shard's fused stage is #9 on its blocks
        stage = (shard_fused_sw_update if getattr(self.grid, "shard", None)
                 is not None else fused_sw_update)
        Gm = None
        for gamma, zeta in zip(RK3_GAMMAS, RK3_ZETAS):
            self._fill_all(fields, time)
            if self.fused:
                Gm, fields = stage(
                    self.grid, self.advection, self.g, f, self.bathymetry,
                    names, fields, Gm, nt(gamma) * dt, nt(zeta) * dt)
            else:
                # the whole padded fields, as JAX updates them (a bounded
                # axis's far boundary face evolves until its fill)
                G = self._compute_tendencies(fields, time)
                fields = {n: fields[n] + float(dt) * (
                    float(gamma) * G[n] if Gm is None
                    else float(gamma) * G[n] + float(zeta) * Gm[n])
                    for n in names}
                Gm = G
            time = time + nt(gamma + zeta) * dt
        self.state = dict(fields=fields,
                          clock=dict(time=time,
                                     iteration=clock["iteration"] + 1,
                                     last_dt=dt))
        return self

    def __repr__(self):
        return (f"ShallowWaterModel(grid={self.grid!r}, "
                f"formulation={self.formulation})")


def state_from_jax(jax_state_numpy, model, bathymetry=None):
    """Load a JAX ``ShallowWaterModel``'s state into ``model``.

    ``jax_state_numpy`` is the JAX model's ``state`` with its arrays
    converted to numpy (``fields`` and ``clock``); ``bathymetry`` is the JAX
    model's padded bathymetry, or None to keep the model's own. The JAX
    arrays may use another halo layout: their halo widths are read off their
    shapes. The fields' interiors are written into the port's padded
    tensors and their halos refilled; the bathymetry, whose halos are never
    filled, keeps the JAX values of the slots nearest the interior."""
    fields = {n: padded_from_jax(model.grid, jax_state_numpy["fields"][n])
              for n in model.prognostic_names}
    model._fill_all(fields, float(jax_state_numpy["clock"]["time"]))
    if bathymetry is not None:
        model.bathymetry = _crop_padded(model.grid, bathymetry)
    jc = jax_state_numpy["clock"]
    nt = model._nt
    model.state = dict(fields=fields,
                       clock=dict(time=nt(jc["time"]),
                                  iteration=int(jc["iteration"]),
                                  last_dt=nt(jc["last_dt"])))
    return model


def _crop_padded(grid, arr):
    """The padded tensor of ``grid`` cut, halos included, from a numpy array
    padded in a layout with halos at least as wide (widths read off its
    shape)."""
    arr = np.asarray(arr)
    sl = []
    for axis in range(3):
        n, h = grid.N[axis], grid.H[axis]
        extra = arr.shape[axis] - n
        if extra < 2 * h or extra % 2:
            raise ValueError(f"array of shape {arr.shape} is not a padded "
                             f"layout of interior {grid.N} with halo "
                             f"{grid.H} or wider")
        sl.append(slice(extra // 2 - h, extra // 2 + n + h))
    return torch.as_tensor(np.ascontiguousarray(arr[tuple(sl)]),
                           dtype=grid.dtype, device=grid.device)
