"""ShallowWaterModel.

Counterpart of ``oceananigans_tpu/models/shallow_water.py`` on a regular
RectilinearGrid with periodic x and y and a flat z. Two formulations: the
conservative one (prognostic transports uh, vh and height h)

    ∂t uh = -∇·(𝐮 uh) - ∂x(g h²/2) - f×(uh,vh)|x - g h ∂x h_B
    ∂t h  = -∇·(uh, vh)
    ∂t c  = -∇·(𝐔 c) + c ∇·𝐔          (advective form via flux + correction)

and the vector-invariant one (u, v, h)

    ∂t u = -(ζ+f) v̂ - ∂x(g(h+h_B) + |u|²/2)

RK3, no elliptic solve. Each RK3 stage fills the periodic halos of every
field (one launch of the batched wrap) and, where the configuration is
eligible (conservative, constant f; ``kernels/fused_shallow_water.py``
``sw_eligible``), runs the fused shallow-water stage: one launch of the
kernel for the whole tendency and the stage update. Otherwise (the
vector-invariant formulation, ``BetaPlane``, ``fused=False``) the tendencies
are plain PyTorch. Closure, forcing and user boundary conditions raise.

With ``architecture=Distributed(...)`` the state stays global-view on the
mesh's first device (the grid's device) and each stage runs the sharded
fused stage (``build_sharded_fused_sw_update``): per-shard blocks, their
halos exchanged, one launch of the kernel per shard. As in the JAX package,
the bathymetry's blocks take exchanged (periodic) halos there, so with an
array bathymetry the sharded step differs from the serial one near the
global edges (ROADMAP.md queue 3). A configuration the fused stage does not
take raises under a mesh.

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
from ..boundary_conditions import (fill_all_halo_regions,
                                   regularize_field_boundary_conditions)
from ..coriolis import constant_f
from ..defaults import defaults, numpy_dtype
from ..fields import Field, set_on_padded
from ..grids.topology import FLAT, LOC_CCC, LOC_CFC, LOC_FCC, PERIODIC
from ..kernels import fused_sw_update
from ..kernels.fused_shallow_water import (build_sharded_fused_sw_update,
                                           sw_eligible)
from ..operators.operators import ddx, ddy, div_xy_ccc, ix_f, iy_f
from ..parallel.distributed import regularize_architecture
from ..timesteppers import RK3_GAMMAS, RK3_ZETAS, stage_update
from ..utils.dateclock import datetime_of
from .nonhydrostatic import padded_from_jax

CONSERVATIVE = "conservative"
VECTOR_INVARIANT = "vector_invariant"

REST_ITEM = ("ROADMAP.md queue 1 item 17 (the rest of shallow water: "
             "closure, forcing, boundary conditions and bounded x/y)")
MESH_ITEM = ("ROADMAP.md queue 1 item 16 (the GSPMD-only sharded paths: "
             "under a mesh the JAX package partitions this configuration's "
             "plain step with XLA)")


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
        for name, value in (("closure", closure), ("forcing", forcing),
                            ("boundary_conditions", boundary_conditions)):
            if value:
                raise NotImplementedError(
                    f"{name} is not ported yet: {REST_ITEM}")
        if not grid.is_flat(2):
            raise ValueError("ShallowWaterModel requires a z-Flat grid")
        if any(grid.topology[a] not in (PERIODIC, FLAT) for a in (0, 1)):
            raise NotImplementedError(
                f"bounded x/y are not ported yet: {REST_ITEM}")
        if formulation not in (CONSERVATIVE, VECTOR_INVARIANT):
            raise ValueError(formulation)
        if device is not None or dtype is not None:
            grid = grid.to(device=device, dtype=dtype)
        self.architecture = regularize_architecture(architecture)
        if self.architecture is not None:
            self.architecture.place(grid)
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
        if self.grid.N[0] < halo[0] or self.grid.N[1] < halo[1]:
            raise ValueError("the periodic halos need Nx >= Hx and Ny >= Hy")
        self.coriolis = coriolis
        self.formulation = formulation
        eligible = sw_eligible(self.grid, formulation, coriolis)
        if fused is True and not eligible:
            raise ValueError("model configuration is not eligible for the "
                             "fused shallow-water kernel")
        self.fused = fused in (True, "auto") and eligible
        if self.architecture is not None and not self.fused:
            raise NotImplementedError(
                "under a device mesh the port runs only the fused "
                f"shallow-water stage, which this configuration does not "
                f"take: {MESH_ITEM}")
        if isinstance(tracers, str):
            tracers = (tracers,)
        self.tracer_names = tuple(tracers)
        self._solution = (("uh", "vh", "h") if formulation == CONSERVATIVE
                          else ("u", "v", "h"))
        self._locs = {self._solution[0]: LOC_FCC, self._solution[1]: LOC_CFC,
                      "h": LOC_CCC}
        self._locs.update({name: LOC_CCC for name in self.tracer_names})
        self.bcs = {name: regularize_field_boundary_conditions(
            None, self.grid, loc) for name, loc in self._locs.items()}
        self.bathymetry = set_on_padded(self.grid, LOC_CCC, bathymetry)
        self._sharded = None
        if self.architecture is not None:
            self._build_sharded()
        self._nt = numpy_dtype(self.grid.dtype)
        self.state = dict(
            fields={n: torch.zeros(self.grid.padded_shape,
                                   dtype=self.grid.dtype,
                                   device=self.grid.device)
                    for n in self.prognostic_names},
            clock=dict(time=self._nt(0), iteration=0,
                       last_dt=self._nt(np.inf)))

    @property
    def prognostic_names(self):
        return self._solution + self.tracer_names

    def loc(self, name):
        return self._locs[name]

    @property
    def time(self):
        return float(self.state["clock"]["time"])

    @property
    def datetime(self):
        """reference_datetime + the model's seconds; None without a
        reference_datetime."""
        return datetime_of(self.time, self.reference_datetime)

    @property
    def iteration(self):
        return int(self.state["clock"]["iteration"])

    def field(self, name):
        """The field ``name``, its halos refreshed (a step leaves the halo
        slots of its last stage unwritten; interiors are authoritative)."""
        data = self.state["fields"][name]
        fill_all_halo_regions([data], self.grid)
        return Field(self.grid, self.loc(name), self.bcs[name], data,
                     _regularize=False)

    @property
    def fields(self):
        return {n: self.field(n) for n in self.prognostic_names}

    def set(self, **values):
        fields = dict(self.state["fields"])
        for name, value in values.items():
            if name not in fields:
                raise ValueError(f"unknown prognostic field {name!r}")
            fields[name] = set_on_padded(self.grid, self.loc(name), value)
        self._fill_all({name: fields[name] for name in values})
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

    def _compute_tendencies(self, fields):
        """The plain PyTorch tendencies of every prognostic field, padded."""
        grid = self.grid
        if self.formulation == CONSERVATIVE:
            return conservative_tendencies(
                grid, self.advection, self.g, self.coriolis, self.bathymetry,
                self.tracer_names, fields)
        g, h, hB = self.g, fields["h"], self.bathymetry
        u, v = self._velocities(fields)
        uh, vh = self._transports(fields)
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
        return G

    def _build_sharded(self):
        """The sharded stage for the current bathymetry (its blocks' halos
        are exchanged once, here)."""
        self._sharded = build_sharded_fused_sw_update(
            self.grid, self.advection, self.g, constant_f(self.coriolis),
            self.bathymetry, self.prognostic_names, self.architecture.mesh)
        self._sharded_bathymetry = self.bathymetry

    def _fill_all(self, fields):
        """Fill the periodic halos of ``fields`` ({name: padded tensor}) in
        place, one wrap launch for all of them."""
        fill_all_halo_regions(list(fields.values()), self.grid)
        return fields

    def time_step(self, dt):
        """Advance the model state by one Δt with RK3. As the JAX step
        donates its state, the step consumes the state's tensors: each stage
        writes new tensors and the previous stage's are released, so at most
        two sets of fields and two of tendencies are alive."""
        nt = self._nt
        dt = nt(dt)
        names = self.prognostic_names
        fields = self.state["fields"]
        clock = self.state["clock"]
        self.state = {**self.state, "fields": None}
        time = clock["time"]
        ints = self.grid.interior_slices
        f = constant_f(self.coriolis)
        if self._sharded is not None \
                and self._sharded_bathymetry is not self.bathymetry:
            self._build_sharded()
        Gm = None
        for gamma, zeta in zip(RK3_GAMMAS, RK3_ZETAS):
            self._fill_all(fields)
            if self._sharded is not None:
                Gm, fields = self._sharded(fields, Gm, nt(gamma) * dt,
                                           nt(zeta) * dt)
            elif self.fused:
                Gm, fields = fused_sw_update(
                    self.grid, self.advection, self.g, f, self.bathymetry,
                    names, fields, Gm, nt(gamma) * dt, nt(zeta) * dt)
            else:
                G = self._compute_tendencies(fields)
                G = torch.stack([G[name][ints] for name in names])
                fields = stage_update(self.grid, names, fields, G, Gm,
                                      nt(gamma) * dt, nt(zeta) * dt)
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
    model._fill_all(fields)
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
