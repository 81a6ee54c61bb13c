"""The hydrostatic primitive equations on the six-panel cubed sphere.

Counterpart of ``oceananigans_tpu/models/cubed_sphere_hydrostatic.py``. The
physics of a panel is the port's ``HydrostaticFreeSurfaceModel``'s own:
``_PanelPhysics`` borrows its ``_compute_tendencies`` (advection by any
``VectorInvariant`` and tracer scheme, Coriolis, the hydrostatic pressure,
every closure, forcing and the top and bottom Flux conditions, whose
callables see the panel's true (λ°, φ°) nodes), overriding only the two
column integrals, w and pₕ′, which run over every column: the halo
columns hold exchanged velocities and buoyancy, so their w and pₕ′ need no
exchange. Panels are FULLY_CONNECTED in x and y: advection keeps its full
order up to the panel edges and no lateral condition applies.

By default (``batch_panels=True``) the six panels run as one grid, their
metric tables concatenated along x (``ConcatPanelsGrid``): each step stage
makes one tendency call, one implicit solve, one TKE substep over the
(6·NP, NP, NZ) view of the state. ``batch_panels=False`` runs each stage
panel by panel. What is the cubed sphere's own stays out of the shared
path:

- the exchange (the grid's ``PanelExchange``: centres, the staggered
  (u, v) pair with its rotation and the shared-face sync) in place of the
  x and y fills; the z halos go through the fill (``fill_all_halo_regions``
  on the concatenated grid, whose x and y are kept), which on the card is
  the fill kernel;
- the valence-3 vertex vorticity (``VertexFix``), passed to the vector
  invariant in place of the curl (``_zeta_override``);
- immersed bottoms (``GridFittedBottom``, ``PartialCellBottom`` or a bare
  height: a callable of (λ, φ) in radians or a (6, N, N) / (6, NP, NP)
  array), evaluated on the exchanged panel nodes, with per-column fluid
  depths in the barotropic mode;
- z* (``vertical_coordinate="zstar"``): σ from the grid's η per
  staggering, ∂t_σ in w and the vector invariant, the σ-weighted tracer
  update;
- the free surfaces: explicit (forward-backward), implicit (backward
  Euler in increment form, conjugate gradients with the exchange inside the
  operator) and split-explicit (barotropic substeps with one exchange per
  chunk of (H - 1)//2 substeps, single-pass exchanges inside, and the
  barotropic corrector);
- the steppers: quasi-AB2 (χ = 0.1, Euler on the first step; the default
  for the split-explicit surface and a substepped TKE) and the
  Wicker-Skamarock RK3 (stages from the step's start, 1/3, 1/2, 1).

On a panel mesh (JAX's call shape ``model.state = arch.shard(model.state)``
with ``arch = Distributed(Mesh(devices, ("panels",)))``, JAX's
``P("panels")`` on every 4-D leaf) the model holds one per-panel model a
shard over its k = 6/S panels (JAX's per-panel build under panel sharding),
each stepping the code above on its panels' state; the shards meet in the
panel exchange (``ShardPanelExchange``: each sends only the slots that its
neighbours' halos read), the vertex vorticity (``ShardVertexFix``) and the
implicit free surface's dot products, and the step holds no view of the six
panels. The explicit and split-explicit steps equal the serial per-panel
model's bit for bit; the implicit one to the rounding of its sums.

State: ``fields`` u, v (the panels' local staggered components), the
tracers ((6, NP, NP, NZ)) and η ((6, NP, NP, 1)), ``clock``, and as the
configuration needs them ``Gm`` (AB2), ``barotropic`` (U, V) and the z*
``dt_sigma``, ``eta_grid`` and ``G_sigma``. Between steps the stored halos
are stale (every reader refills them or reads interiors).

Against the JAX model: JAX's chunked ``lax.scan`` of the barotropic
substeps is a plain loop; the per-panel mode runs the batched mode's
substep schedule (one exchange per chunk) panel by panel, where the JAX
per-panel body exchanges every substep (the interiors agree: the JAX tests
hold the two schedules bit for bit); w and pₕ′ are scanned with
``torch.cumsum`` where JAX contracts with triangular matrices; the vertex
fix sums its three members in one reduction (roundoff). As in JAX, the
tendencies keep their stencil values in every slot (``_cut_tendencies``:
the port's single-grid model zeroes their halos): the owning panel evolves
the shared edge faces from them, and the substepped TKE reads the
AB2-updated tracers' unfilled z halos, as JAX's does (ROADMAP.md queue 3),
so the port's e follows JAX's there too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..advection import Centered
from ..advection.vector_invariant import VectorInvariant
from ..boundary_conditions import (fill_all_halo_regions,
                                   regularize_field_boundary_conditions)
from ..buoyancy import BuoyancyTracer
from ..closures.scalar_diffusivity import (ClosureTuple,
                                           validate_implicit_closure_z_bcs)
from ..defaults import defaults, numpy_dtype
from ..forcings.forcings import regularize_forcing
from ..grids.cubed_sphere import ShardPanelExchange, concat_panels_grid
from ..grids.topology import LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from ..immersed import GridFittedBottom, ImmersedBoundaryGrid, \
    PartialCellBottom
from ..parallel.distributed import MeshModel
from ..operators.operators import (ddx, ddy, div_xy_ccc, dx_c, dy_c, iz_f,
                                   zeta3_ffc)
from ..solvers.conjugate_gradient import conjugate_gradient
from ..utils.dateclock import datetime_of
from .cubed_sphere_shallow_water import (PanelFieldView, ShardVertexFix,
                                         VertexFix, _geographic_values,
                                         _vertex_corner_info,
                                         staggered_points_and_bases)
from .free_surfaces import (ExplicitFreeSurface, ImplicitFreeSurface,
                            SplitExplicitFreeSurface)
from .hydrostatic import (HydrostaticFreeSurfaceModel, PROGNOSTIC_LOCS,
                          ZSTAR_STATE, _dz_columns, immersed_column_geometry,
                          zstar_column_geometry)
from .nonhydrostatic import implicit_vertical_diffusion
from .zstar import ZStarGrid

HFSM = HydrostaticFreeSurfaceModel


class _AllColumnsProxy:
    """A grid view whose interior spans every (x, y) column and the
    interior z: the vertically implicit solve then covers the halo columns
    (the shared-edge faces among them) too."""

    def __init__(self, g):
        self._g = g
        self.H, self.N = g.H, g.N
        self.padded_shape = g.padded_shape
        self.topology = g.topology

    def dz(self, loc):
        return self._g.dz(loc)

    def is_flat(self, axis):
        return self._g.is_flat(axis)

    @property
    def interior_slices(self):
        h, n = self._g.H[2], self._g.N[2]
        return (slice(None), slice(None), slice(h, h + n))


class _NamedBuoyancyTracer:
    """``BuoyancyTracer`` on a tracer of another name."""

    def __init__(self, name):
        self.name = name
        self.required_tracers = (name,)

    def _fp(self):
        return ("NamedBuoyancyTracer", self.name)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def buoyancy_ccc(self, grid, tracers):
        return tracers[self.name]

    def z_buoyancy(self, grid, tracers):
        return iz_f(grid, tracers[self.name])


class _PanelPhysics:
    """The tendency assembly of ``HydrostaticFreeSurfaceModel`` on one
    panel or on the concatenated panels (possibly immersed), with w and
    pₕ′ over every column."""

    _tendency_hooks = ()
    _tracer_advection_map = None
    uses_kernel = False
    _cut_tendencies = False
    prescribed_velocities = None
    biogeochemistry = None
    auxiliary_fields = {}
    _compute_tendencies = HFSM._compute_tendencies
    _moving_grid = HFSM._moving_grid
    _sigma_fields = HFSM._sigma_fields
    _grid_motion = HFSM._grid_motion
    _tracer_schemes = HFSM._tracer_schemes
    _tracer_velocities = HFSM._tracer_velocities
    _depth_integral = HFSM._depth_integral
    _mask_kz = HFSM._mask_kz
    tracer_scheme = HFSM.tracer_scheme
    loc = HFSM.loc

    def __init__(self, parent, grid, bcs):
        self.parent = parent
        self.grid = grid
        self.bcs = bcs
        self.vertical_coordinate = parent.vertical_coordinate
        self._zeta_override = None
        for name in ("momentum_advection", "tracer_advection", "coriolis",
                     "buoyancy", "closure", "forcing", "tracer_names",
                     "_substepped_names", "_substepped_tke"):
            setattr(self, name, getattr(parent, name))
        self.free_surface = parent._fs_for_tendencies
        self._immersed = isinstance(grid, ImmersedBoundaryGrid)
        kw = dict(dtype=grid.dtype, device=grid.device)
        self._dz_cols = torch.as_tensor(np.array(_dz_columns(grid)), **kw)
        Lz = abs(grid.extent[2])
        if self._immersed:
            H_fc, H_cf, fluid_int, _, _ = immersed_column_geometry(grid)
            self._H_fc_np, self._H_cf_np = H_fc, H_cf
            self._H_fc = torch.as_tensor(H_fc, **kw)
            self._H_cf = torch.as_tensor(H_cf, **kw)
            self._fluid_int = {loc: torch.as_tensor(m, **kw)
                               for loc, m in fluid_int.items()}
        else:
            self._H_fc = self._H_cf = Lz
            self._H_fc_np = self._H_cf_np = Lz
            self._fluid_int = None
        if self.vertical_coordinate == "zstar":
            geo = zstar_column_geometry(grid, self._H_fc_np, self._H_cf_np,
                                        self._immersed)
            self._zstar_geo = {
                loc: (H if isinstance(H, float) else
                      torch.as_tensor(H, **kw),
                      None if wet is None else
                      torch.as_tensor(wet, device=grid.device))
                for loc, (H, wet) in geo.items()}
            from ..grids.base import numpy_metric
            self._dz_ref = torch.as_tensor(np.array(np.broadcast_to(
                np.asarray(numpy_metric(grid, "dz", LOC_CCC), float),
                grid.padded_shape)), **kw)
        self._proxy = _AllColumnsProxy(grid)

    # -- all-column diagnostics -----------------------------------------------

    def _w_from_continuity(self, u, v, dt_sigma=None, sigma=None):
        """w at the z faces by the upward continuity integral over every
        column (moving face areas and -Δr·∂t_σ on z*); the halo columns are
        valid but for the outermost ring."""
        grid = self.grid
        h, n = grid.H[2], grid.N[2]
        if sigma is None:
            d = div_xy_ccc(grid, u, v)[:, :, h:h + n] * self._dz_cols
        else:
            d = div_xy_ccc(ZStarGrid(grid, sigma), u, v)[:, :, h:h + n] \
                * self._dz_cols * sigma[("c", "c")]
        if dt_sigma is not None:
            gm = dt_sigma * self._dz_cols
            if self._immersed:
                gm = gm * self._fluid_int[LOC_CCC]
            d = d + gm
        w = torch.zeros(grid.padded_shape, dtype=u.dtype, device=u.device)
        w[:, :, h + 1:h + n + 1] = -torch.cumsum(d, dim=2)
        return w

    def _hydrostatic_pressure(self, fields):
        """pₕ′ = -∫_z^0 b dz′ at the centres over every column; None
        without buoyancy."""
        if self.buoyancy is None:
            return None
        grid = self.grid
        h, n = grid.H[2], grid.N[2]
        b = self.buoyancy.buoyancy_ccc(grid, fields)
        bdz = b[:, :, h:h + n] * self._dz_cols
        above = torch.flip(torch.cumsum(torch.flip(bdz, [2]), 2), [2]) - bdz
        p = torch.zeros(grid.padded_shape, dtype=b.dtype, device=b.device)
        p[:, :, h:h + n] = -(0.5 * bdz + above)
        return p

    def implicit_step(self, st, aux, sdt, dampings=None):
        """The closure's vertically implicit diffusion over every column."""
        kappas = self.closure.vertical_implicit_kappas(self.grid, st, aux)
        for nm in self._substepped_names:
            kappas.pop(nm, None)
        out = dict(st)
        for name, kz in kappas.items():
            if name in ("w", "eta") or name not in out:
                continue
            out[name] = implicit_vertical_diffusion(
                self._proxy, out[name], self._mask_kz(kz), sdt,
                damping=(dampings or {}).get(name))
        return out


def _as_free_surface(fs, gravity, substeps):
    if isinstance(fs, str):
        if fs == "explicit":
            return ExplicitFreeSurface(gravity)
        if fs == "implicit":
            return ImplicitFreeSurface(gravity)
        if fs == "split_explicit":
            return SplitExplicitFreeSurface(gravity, substeps=substeps)
        raise ValueError(fs)
    if isinstance(fs, (ExplicitFreeSurface, ImplicitFreeSurface,
                       SplitExplicitFreeSurface)):
        return fs
    raise ValueError(f"unknown free surface {fs!r}")


def _pick(x, p):
    """Panel ``p`` of a stacked tensor or of each entry of a dict; numbers
    and None pass."""
    if isinstance(x, torch.Tensor):
        return x[p]
    if isinstance(x, dict):
        return {k: _pick(v, p) for k, v in x.items()}
    return x


def _stack(outs):
    """The per-panel results of ``_map`` (tensors, and dicts and tuples of
    them) stacked along a new panel axis."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(z)) for z in zip(*outs))
    return torch.stack(outs)


class CubedSphereHydrostaticModel(MeshModel):
    """The hydrostatic free-surface model on a ``ConformalCubedSphereGrid``
    built with a z coordinate (module docstring). ``rotation_rate`` builds
    a ``HydrostaticSphericalCoriolis`` unless ``coriolis`` is given;
    ``buoyancy`` defaults to ``BuoyancyTracer`` semantics on
    ``buoyancy_tracer`` when it is among the tracers; ``free_surface`` is
    "explicit", "implicit", "split_explicit" (with ``substeps``) or a free
    surface object; ``timestepper`` "WickerSkamarockRK3" or
    "QuasiAdamsBashforth2"."""

    def _enter_mesh(self, arch):
        """Put the model on the panel mesh ``arch`` (JAX's call shape
        ``model.state = arch.shard(model.state)``): one model a shard over
        its panels, built from this model's arguments with
        ``batch_panels=False`` (JAX's per-panel build under panel sharding,
        ``_state_sharded``); the shards meet in the panel exchange
        (``ShardPanelExchange``), the vertex vorticity
        (``ShardVertexFix``) and the reductions of the implicit free
        surface's CG. This model's own state is dropped: assign a state to
        scatter it."""
        shards = arch.panel_shards_of(self.grid)
        self.architecture = arch
        self._comm = arch.communicator
        self._shards = [CubedSphereHydrostaticModel(
            self.grid, **dict(self._shard_kw, batch_panels=False),
            _shard=sh) for sh in shards]
        self._state = None

    def __init__(self, grid, tracers=("b",), gravity=None, rotation_rate=0.0,
                 momentum_advection=None, tracer_advection=None,
                 coriolis=None, buoyancy=None, buoyancy_tracer="b",
                 closure=None, forcing=None, boundary_conditions=None,
                 bottom_height=None, free_surface="explicit",
                 implicit_solver_tol=1e-8, substeps=30,
                 timestepper="WickerSkamarockRK3", vertical_coordinate="z",
                 reference_datetime=None, batch_panels=True, _shard=None):
        # the arguments a shard's model is built from (``_enter_mesh``)
        self._shard_kw = dict(
            tracers=tracers, gravity=gravity, rotation_rate=rotation_rate,
            momentum_advection=momentum_advection,
            tracer_advection=tracer_advection, coriolis=coriolis,
            buoyancy=buoyancy, buoyancy_tracer=buoyancy_tracer,
            closure=closure, forcing=forcing,
            boundary_conditions=boundary_conditions,
            bottom_height=bottom_height, free_surface=free_surface,
            implicit_solver_tol=implicit_solver_tol, substeps=substeps,
            timestepper=timestepper,
            vertical_coordinate=vertical_coordinate,
            reference_datetime=reference_datetime)
        self.architecture = None
        # the panels this model steps: all six, or a panel shard's
        self._panel_shard = _shard
        self._ids = tuple(range(6) if _shard is None else _shard.panels)
        self._k = len(self._ids)
        if grid.panel_grids[0].is_flat(2):
            raise ValueError("CubedSphereHydrostaticModel needs a grid "
                             "built with z=(bottom, top)")
        if vertical_coordinate not in ("z", "zstar"):
            raise ValueError("vertical_coordinate must be 'z' or 'zstar'")
        self.vertical_coordinate = vertical_coordinate
        self.reference_datetime = reference_datetime
        self.grid = grid
        self.gravity = float(gravity if gravity is not None
                             else defaults.gravitational_acceleration)
        self.rotation_rate = float(rotation_rate)
        self.momentum_advection = (
            momentum_advection if momentum_advection is not None
            else VectorInvariant(vorticity_scheme="energy_conserving"))
        if not isinstance(self.momentum_advection, VectorInvariant):
            raise ValueError("cubed-sphere momentum advection must be a "
                             "VectorInvariant form")
        self.tracer_advection = (tracer_advection if tracer_advection
                                 is not None else Centered(2))
        if coriolis is None and rotation_rate:
            from ..coriolis import HydrostaticSphericalCoriolis
            coriolis = HydrostaticSphericalCoriolis(self.rotation_rate)
        self.coriolis = coriolis
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        if buoyancy is None and buoyancy_tracer is not None \
                and buoyancy_tracer in tracers:
            buoyancy = (BuoyancyTracer() if buoyancy_tracer == "b"
                        else _NamedBuoyancyTracer(buoyancy_tracer))
        self.buoyancy = buoyancy
        if isinstance(closure, (tuple, list)):
            closure = ClosureTuple(*closure)
        self.closure = closure
        if closure is not None:
            for name in getattr(closure, "required_tracers", ()):
                if name not in tracers:
                    tracers = tracers + (name,)
            for c in getattr(closure, "closures", (closure,)):
                if getattr(c, "buoyancy", "missing") is None:
                    c.buoyancy = buoyancy
        self.tracer_names = tracers
        self.forcing = regularize_forcing(forcing)
        for name, F in self.forcing.items():
            if hasattr(F, "bind"):
                F.bind(name, PROGNOSTIC_LOCS.get(name, LOC_CCC),
                       locs=PROGNOSTIC_LOCS)
        self._substepped_tke = bool(closure is not None and getattr(
            closure, "substepped_tke", False))
        self._substepped_names = (
            tuple(getattr(closure, "substepped_tracers", ("e",)))
            if self._substepped_tke else ())

        self.free_surface = _as_free_surface(free_surface, self.gravity,
                                             substeps)
        self.implicit_solver_tol = float(implicit_solver_tol)
        if isinstance(self.free_surface, SplitExplicitFreeSurface):
            timestepper = "QuasiAdamsBashforth2"
            self.free_surface.materialize(grid.panel_grids[0])
        # the implicit step solves for the increment δ = η¹ - η⁰, so the
        # tendencies carry the explicit -g∇η⁰; only the split-explicit
        # surface leaves the gradient to its substeps
        self._fs_for_tendencies = (
            ExplicitFreeSurface(self.gravity)
            if isinstance(self.free_surface, ImplicitFreeSurface)
            else self.free_surface)
        if self._substepped_tke:
            timestepper = "QuasiAdamsBashforth2"
        if timestepper not in ("WickerSkamarockRK3", "QuasiAdamsBashforth2"):
            raise ValueError(timestepper)
        self.timestepper = timestepper

        required = max(getattr(self.tracer_advection, "required_halo", 1),
                       getattr(self.momentum_advection, "required_halo", 1))
        if closure is not None:
            required = max(required, getattr(closure, "required_halo", 1))
        if grid.H[0] < required:
            raise ValueError(
                f"this configuration needs halo >= {required} but the grid "
                f"was built with halo={grid.H[0]}; pass halo={required} to "
                f"ConformalCubedSphereGrid")

        H, N = grid.H[0], grid.N[0]
        self._NPX = NP = N + 2 * H
        ZP = grid.panel_grids[0].padded_shape[2]
        self._immersed = bottom_height is not None
        panel_grids = list(grid.panel_grids)
        if self._immersed:
            panel_grids = self._immersed_panels(bottom_height)
        panel_grids = [panel_grids[p] for p in self._ids]

        bcs_in = dict(boundary_conditions or {})
        if self._substepped_tke:
            proto = _PanelPhysics.__new__(_PanelPhysics)
            proto.grid, proto.closure, proto.buoyancy = (panel_grids[0],
                                                         closure, buoyancy)
            bcs_in = HFSM._install_tke_surface_flux(proto, bcs_in)
        self._bcs_in = bcs_in

        self.panels = []
        for i, g in enumerate(panel_grids):
            bcs = self._panel_bcs(g)
            if i == 0:
                validate_implicit_closure_z_bcs(closure, bcs)
            self.panels.append(_PanelPhysics(self, g, bcs))
        self._catp = _PanelPhysics(self, concat_panels_grid(panel_grids),
                                   None)
        self._catp.bcs = self._panel_bcs(self._catp.grid)
        self._batch = bool(batch_panels)
        self.exchange = (grid.exchange if _shard is None
                         else ShardPanelExchange(grid.exchange, _shard))

        g0 = grid.panel_grids[0]
        self._zmask = torch.zeros(ZP, dtype=grid.dtype, device=grid.device)
        self._zmask[g0.H[2]:g0.H[2] + g0.N[2]] = 1.0
        self._nt = numpy_dtype(grid.dtype)
        kw = dict(dtype=grid.dtype, device=grid.device)
        shape3, shape2 = (self._k, NP, NP, ZP), (self._k, NP, NP, 1)
        fields = {n: torch.zeros(shape3, **kw)
                  for n in ("u", "v") + self.tracer_names}
        fields["eta"] = torch.zeros(shape2, **kw)
        nt = self._nt
        self.state = dict(fields=fields,
                          clock=dict(time=nt(0), iteration=0,
                                     last_dt=nt(np.inf)))
        if timestepper == "QuasiAdamsBashforth2":
            self.state["Gm"] = {n: torch.zeros(shape3, **kw)
                                for n in ("u", "v") + self.tracer_names}
        if isinstance(self.free_surface, SplitExplicitFreeSurface):
            self.state["barotropic"] = {"U": torch.zeros(shape2, **kw),
                                        "V": torch.zeros(shape2, **kw)}
        if vertical_coordinate == "zstar":
            for key in ZSTAR_STATE:
                self.state[key] = torch.zeros(shape2, **kw)
        self._vertex = VertexFix(grid, _vertex_corner_info(grid))
        if _shard is None:
            self._geom = staggered_points_and_bases(grid)
        else:
            self._vertex = ShardVertexFix(self._vertex, _shard, NP)

    # -- construction helpers -------------------------------------------------

    def _immersed_panels(self, bottom_height):
        """Each panel wrapped in an ImmersedBoundaryGrid, the bottom height
        evaluated on its exchanged (exact-halo) nodes."""
        grid = self.grid
        H, N = grid.H[0], grid.N[0]
        NP = N + 2 * H
        cls, kw = GridFittedBottom, {}
        if isinstance(bottom_height, PartialCellBottom):
            cls = PartialCellBottom
            kw = {"minimum_fractional_cell_height": bottom_height.epsilon}
            bottom_height = bottom_height.bottom_height
        elif isinstance(bottom_height, GridFittedBottom):
            bottom_height = bottom_height.bottom_height
        out = []
        for p, g in enumerate(grid.panel_grids):
            if p not in self._ids:
                out.append(None)
                continue
            if callable(bottom_height):
                lam, phi = g.nodes2d_padded(("c", "c"))
                zb = np.broadcast_to(np.asarray(bottom_height(
                    np.deg2rad(lam), np.deg2rad(phi)), np.float64), (NP, NP))
            else:
                zb = np.asarray(bottom_height, np.float64)
                if zb.shape[:3] == (6, N, N):
                    full = np.full((NP, NP), zb.min())
                    full[H:H + N, H:H + N] = zb[p].reshape(N, N)
                    zb = full
                elif zb.shape[:3] == (6, NP, NP):
                    zb = zb[p].reshape(NP, NP)
                else:
                    raise ValueError("bottom_height array must be "
                                     "(6, N, N) or (6, NP, NP)")
            out.append(ImmersedBoundaryGrid(g, cls(np.array(zb), **kw)))
        return out

    def _panel_bcs(self, g):
        bcs = {name: regularize_field_boundary_conditions(
            self._bcs_in.get(name), g, loc)
            for name, loc in PROGNOSTIC_LOCS.items()}
        for name in self.tracer_names:
            bcs[name] = regularize_field_boundary_conditions(
                self._bcs_in.get(name), g, LOC_CCC)
        bcs["w"] = regularize_field_boundary_conditions(None, g, LOC_CCF)
        bcs["eta"] = regularize_field_boundary_conditions(None, g, LOC_CCC)
        return bcs

    # -- layouts and per-panel maps -------------------------------------------

    def _c(self, a):
        """(k, NP, ...) -> the concatenated (k·NP, ...) view (k the six
        panels, or a panel shard's)."""
        return a.reshape((self._k * self._NPX,) + a.shape[2:])

    def _s(self, a):
        return a.reshape((self._k, self._NPX) + a.shape[1:])

    def _map(self, fn, *args):
        """``fn(physics, *args)`` once on the concatenated view (batched)
        or on each panel's slices, stacked (per panel)."""
        if self._batch:
            return fn(self._catp, *args)
        return _stack([fn(self.panels[p], *[_pick(a, p) for a in args])
                       for p in range(self._k)])

    def _L(self, a):
        """A stacked state tensor in the step's layout."""
        return self._c(a) if self._batch else a

    def _cat_view(self, a):
        """A step-layout tensor as the concatenated view."""
        return a if self._batch else self._c(a)

    def _P(self, a):
        """A step-layout tensor back to the stacked layout."""
        return self._s(a) if self._batch else a

    # -- set ------------------------------------------------------------------

    def set_geographic(self, u_east=None, v_north=None):
        """Set (u, v) from zonal and meridional velocity functions of
        geographic (λ, φ) in radians, the same at every interior level."""
        out = _geographic_values(self.grid, self._geom, None, u_east,
                                 v_north)
        fields = dict(self.state["fields"])
        kw = dict(dtype=self.grid.dtype, device=self.grid.device)
        for name, arr in out.items():
            fields[name] = torch.as_tensor(arr[..., None], **kw) \
                * self._zmask
        self.state = {**self.state, "fields": fields}
        self._post_set()

    def set(self, **values):
        """Set fields from arrays (interior (6, N, N, Nz), or padded) or
        callables of geographic (λ, φ, z) in radians (η: of (λ, φ))."""
        grid = self.grid
        H, N = grid.H[0], grid.N[0]
        g0 = grid.panel_grids[0]
        hz, nz = g0.H[2], g0.N[2]
        zc = np.asarray(g0.znodes("c"))
        fields = dict(self.state["fields"])
        for name, val in values.items():
            if name not in fields:
                raise ValueError(f"unknown prognostic field {name!r}")
            shape = tuple(fields[name].shape)
            if callable(val):
                panels = []
                for g in grid.panel_grids:
                    lam, phi = (np.deg2rad(a)
                                for a in g.nodes2d_padded(("c", "c")))
                    if name == "eta":
                        panels.append(np.broadcast_to(np.asarray(
                            val(lam, phi), np.float64), lam.shape)[..., None])
                    else:
                        panels.append(np.stack([np.broadcast_to(np.asarray(
                            val(lam, phi, z), np.float64), lam.shape)
                            for z in zc], axis=-1))
                arr = np.stack(panels)
                if name != "eta":
                    full = np.zeros(shape)
                    full[..., hz:hz + nz] = arr
                    arr = full
            else:
                arr = np.asarray(val, np.float64)
                if arr.shape != shape:
                    full = np.zeros(shape)
                    if name == "eta":
                        full[:, H:H + N, H:H + N, :] = arr.reshape(
                            (6, N, N, 1))
                    else:
                        full[:, H:H + N, H:H + N, hz:hz + nz] = arr
                    arr = full
            fields[name] = torch.as_tensor(arr, dtype=grid.dtype,
                                           device=grid.device)
        self.state = {**self.state, "fields": fields}
        self._post_set()

    def _post_set(self):
        st = dict(self.state)
        fields = dict(st["fields"])
        if self._immersed:
            for n in ("u", "v") + self.tracer_names:
                fields[n] = self._P(self._map(
                    lambda pp, a, _n=n: pp.grid.mask_immersed(a, pp.loc(_n)),
                    self._L(fields[n])))
        st["fields"] = fields
        if "Gm" in st:
            # new prognostic fields restart AB2
            st["Gm"] = {n: torch.zeros_like(v) for n, v in st["Gm"].items()}
            st["clock"] = {**st["clock"], "iteration": 0}
        if "dt_sigma" in st:
            st["dt_sigma"] = torch.zeros_like(st["dt_sigma"])
            st["eta_grid"] = fields["eta"].clone()
            st["G_sigma"] = torch.zeros_like(st["G_sigma"])
        if "barotropic" in st:
            # the transports from ∫u dz (σ·∫u dz on z*)
            sig = None
            if "eta_grid" in st:
                sig = self._sigma_all(self.exchange.centers(
                    self._L(st["eta_grid"])))
            U = self._map(lambda pp, a: pp._depth_integral(a, LOC_FCC),
                          self._L(fields["u"]))
            V = self._map(lambda pp, a: pp._depth_integral(a, LOC_CFC),
                          self._L(fields["v"]))
            if sig is not None:
                U, V = U * sig[("f", "c")], V * sig[("c", "f")]
            st["barotropic"] = {"U": self._P(U), "V": self._P(V)}
        self.state = st

    # -- halos ----------------------------------------------------------------

    def _filled(self, st, time):
        """The prognostic fields with their panel halos exchanged (the
        velocity pair rotated and its shared faces synced), their z halos
        filled by their conditions and their solid cells zeroed (new
        tensors, in the step's layout)."""
        out = dict(st)
        ex = self.exchange
        names = [n for n in ("u", "v") + self.tracer_names if n in st]
        if self._immersed:
            for n in names:
                out[n] = self._map(
                    lambda pp, a, _n=n: pp.grid.mask_immersed(a, pp.loc(_n)),
                    st[n])
        out["u"], out["v"] = ex.velocities(out["u"], out["v"])
        for n in names[2:]:
            out[n] = ex.centers(out[n])
        if "eta" in st:
            out["eta"] = ex.centers(st["eta"])
        cp = self._catp
        fill_all_halo_regions([self._cat_view(out[n]) for n in names],
                              cp.grid,
                              [(cp.loc(n), cp.bcs[n]) for n in names],
                              float(time))
        return out

    # -- pieces of the step ---------------------------------------------------

    def _zeta(self, u, v):
        """The vertical vorticity with the vertex fix, in the step's
        layout."""
        z = self._map(lambda pp, a, b: zeta3_ffc(pp.grid, a, b), u, v)
        self._vertex.zeta(*(self._cat_view(a) for a in (z, u, v)))
        return z

    def _tendencies(self, sf, w, time, dt_sigma=None):
        names = ("u", "v") + self.tracer_names
        fields = {n: sf[n] for n in names + ("eta",)}
        if "eta_grid" in sf:
            fields["eta_grid"] = sf["eta_grid"]
        zeta = self._zeta(sf["u"], sf["v"])

        def one(pp, f, w, z, dts):
            pp._zeta_override = z
            try:
                return pp._compute_tendencies(f, w, time, dt_sigma=dts)
            finally:
                pp._zeta_override = None

        if self._batch:
            return one(self._catp, fields, w, zeta, dt_sigma)
        outs = [one(self.panels[p], _pick(fields, p), w[p], zeta[p],
                    _pick(dt_sigma, p)) for p in range(self._k)]
        return (_stack([o[0] for o in outs]), [o[1] for o in outs])

    def _w(self, sf, dt_sigma=None, sigma=None):
        return self._map(lambda pp, u, v, d, s: pp._w_from_continuity(
            u, v, dt_sigma=d, sigma=s), sf["u"], sf["v"], dt_sigma, sigma)

    def _sigma_all(self, eta_grid):
        return self._map(lambda pp, e: pp._sigma_fields(e), eta_grid)

    def _grid_motion_rate(self, dhU):
        """∂t_σ = -δh_U/H over the wet columns, 0 on land."""
        def one(pp, d):
            H, wet = pp._zstar_geo[LOC_CCC]
            r = -d / H
            return r if wet is None else torch.where(wet, r,
                                                     torch.zeros_like(r))
        return self._map(one, dhU)

    def _div_transport(self, U, V, per_area=True):
        def one(pp, U, V):
            g = pp.grid
            d = (dx_c(g, g.dy(LOC_FCC)[..., :1] * U)
                 + dy_c(g, g.dx(LOC_CFC)[..., :1] * V))
            return d / g.Az(LOC_CCC)[..., :1] if per_area else d
        return self._map(one, U, V)

    def _transport_divergence(self, U, V):
        """δh_U from the exchanged barotropic transports."""
        return self._div_transport(*self.exchange.velocities(U, V))

    def _depth_integrals(self, u, v):
        return (self._map(lambda pp, a: pp._depth_integral(a, LOC_FCC), u),
                self._map(lambda pp, a: pp._depth_integral(a, LOC_CFC), v))

    def _explicit_eta(self, eta0, u, v, sdt):
        """η ← η - Δt ∇·∫u dz from the updated (synced) velocities."""
        U, V = self._depth_integrals(*self.exchange.sync(u, v))
        return eta0 - sdt * self._div_transport(U, V)

    def _column_depths(self):
        return (self._map(lambda pp: pp._H_fc) if self._immersed
                else self._catp._H_fc,
                self._map(lambda pp: pp._H_cf) if self._immersed
                else self._catp._H_cf)

    def _split_explicit_substep(self, eta, U, V, GU, GV, dt, frac, weights):
        """The barotropic substeps with per-column depths and the
        Shchepetkin-filtered averages; one exchange of (η, U, V) per chunk
        of c = (H - 1)//2 substeps (each substep consumes two halo rings),
        single-pass (the radius-1 stencils never read the corner blocks).
        Returns the filtered (η̄, Ū, V̄)."""
        ex = self.exchange
        gy = self.free_surface.g
        dtau = float(frac) * float(dt)
        Hfc, Hcf = self._column_depths()
        GU, GV = ex.velocities(GU, GV)
        Hh = self.grid.H[0]
        mid_exc = Hh < 3
        c = max(1, (Hh - 1) // 2)
        ws = torch.as_tensor(np.asarray(weights), dtype=eta.dtype,
                             device=eta.device)

        def grad(pp, e, hf, hc):
            return (-gy * hf * ddx(pp.grid, e, LOC_FCC),
                    -gy * hc * ddy(pp.grid, e, LOC_CFC))

        eta_f = torch.zeros_like(eta)
        U_f, V_f = torch.zeros_like(U), torch.zeros_like(V)
        for k in range(len(ws)):
            if k % c == 0:
                U, V = ex.velocities(U, V, passes=1)
                eta = ex.centers(eta, passes=1)
            eta = eta - dtau * self._div_transport(U, V)
            if mid_exc:
                eta = ex.centers(eta)
            gu, gv = self._map(grad, eta, Hfc, Hcf)
            U = U + dtau * (gu + GU)
            V = V + dtau * (gv + GV)
            w = ws[k]
            eta_f, U_f, V_f = eta_f + w * eta, U_f + w * U, V_f + w * V
        return eta_f, U_f, V_f

    def _barotropic_corrector(self, u, v, U_f, V_f, sigma=None):
        """(u, v) with their depth means replaced by the filtered
        transports' (σ·∫u dz pinned on z*); the z halos zeroed."""
        Ustar, Vstar = self._depth_integrals(u, v)
        hf, hc = self._column_depths()
        if sigma is not None:
            sfc, scf = sigma[("f", "c")], sigma[("c", "f")]
            Ustar, Vstar = Ustar * sfc, Vstar * scf
            hf, hc = hf * sfc, hc * scf
        up = (u + (U_f - Ustar) / hf) * self._zmask
        vp = (v + (V_f - Vstar) / hc) * self._zmask
        if self._immersed:
            up = self._map(lambda pp, a: pp.grid.mask_immersed(a, LOC_FCC),
                           up)
            vp = self._map(lambda pp, a: pp.grid.mask_immersed(a, LOC_CFC),
                           vp)
        return up, vp

    def _implicit_eta_step(self, st, sdt):
        """The backward-Euler free surface in increment form: solve
        Az·δ - gΔt² δᵢ(H A_edge ∂δ) = -Δt δᵢ(A_edge ∫u* dz) by conjugate
        gradients with the exchange inside the operator and per-column
        depths, then u ← u* - gΔt ∂δ."""
        gy = self.free_surface.g
        sdt = float(sdt)
        u, v = self.exchange.sync(st["u"], st["v"])
        eta0 = st["eta"]
        Ustar, Vstar = self._depth_integrals(u, v)
        Az = self._map(lambda pp, e: pp.grid.Az(LOC_CCC).expand(e.shape),
                       eta0)
        H, N = self.grid.H[0], self.grid.N[0]
        mask = torch.zeros((self._k, self._NPX, self._NPX, 1),
                           dtype=torch.bool, device=eta0.device)
        mask[:, H:H + N, H:H + N] = True
        mask = mask.reshape(eta0.shape)
        zero = torch.zeros((), dtype=eta0.dtype, device=eta0.device)
        rhs = torch.where(mask, -sdt * self._div_transport(
            Ustar, Vstar, per_area=False), zero)
        hf, hc = self._column_depths()
        ex = self.exchange

        def lap(pp, xf, hf, hc):
            return (hf * ddx(pp.grid, xf, LOC_FCC),
                    hc * ddy(pp.grid, xf, LOC_CFC))

        def A(x):
            xf = ex.centers(torch.where(mask, x, zero))
            gx, gyy = self._map(lap, xf, hf, hc)
            return torch.where(mask, Az * x - gy * sdt * sdt
                               * self._div_transport(gx, gyy,
                                                     per_area=False), zero)

        # on a panel shard the dot products sum over the mesh
        delta, _, _ = conjugate_gradient(A, rhs,
                                         reltol=self.implicit_solver_tol,
                                         maxiter=200,
                                         shard=self._panel_shard)
        deltaf = ex.centers(delta)

        def correct(pp, u, v, d):
            up = u - gy * sdt * ddx(pp.grid, d, LOC_FCC)
            vp = v - gy * sdt * ddy(pp.grid, d, LOC_CFC)
            if self._immersed:
                up = pp.grid.mask_immersed(up, LOC_FCC)
                vp = pp.grid.mask_immersed(vp, LOC_CFC)
            return up, vp

        out = dict(st)
        out["u"], out["v"] = self._map(correct, u, v, deltaf)
        out["eta"] = eta0 + delta
        return out

    def _mask_prognostics(self, st):
        if not self._immersed:
            return st
        out = dict(st)
        for n in ("u", "v") + self.tracer_names:
            out[n] = self._map(
                lambda pp, a, _n=n: pp.grid.mask_immersed(a, pp.loc(_n)),
                st[n])
        return out

    def _implicit_all(self, st, auxs, sdt):
        """The closure's vertically implicit solve (CATKE's damping and
        clip when its TKE is not substepped)."""
        if self.closure is None:
            return st
        prog = [n for n in ("u", "v", "eta") + self.tracer_names if n in st]
        damp = hasattr(self.closure, "vertical_implicit_damping") \
            and not self._substepped_tke

        def one(pp, stp, aux):
            d = (self.closure.vertical_implicit_damping(pp.grid, stp, aux)
                 if damp else None)
            new = pp.implicit_step(stp, aux, sdt, dampings=d)
            return {n: new[n] for n in stp if new[n] is not stp[n]}

        st_l = {n: st[n] for n in prog}
        if self._batch:
            changed = one(self._catp, st_l, auxs)
        else:
            outs = [one(self.panels[p], _pick(st_l, p), auxs[p])
                    for p in range(self._k)]
            changed = _stack(outs) if outs[0] else {}
        out = dict(st)
        out.update(changed)
        if hasattr(self.closure, "clip_fields") and not self._substepped_tke:
            out = self.closure.clip_fields(out)
        return out

    def _step_turbulence(self, sf, new, G, Gm, dt, chi, euler, M, time):
        """The substepped TKE (CATKE, k-ε) from the updated, exchanged and
        z-filled velocities."""
        prog = ("u", "v", "eta") + self.tracer_names
        nf = self._filled(new, time)
        subs = self._substepped_names

        def one(pp, sfp, newp, nfp, Gp, Gmp):
            fnew = {n: newp[n] for n in prog}
            fnew.update(u=nfp["u"], v=nfp["v"],
                        **{nm: sfp[nm] for nm in subs})
            upd, Gm_t = self.closure.step_turbulence(
                pp.grid, {n: sfp[n] for n in prog}, fnew,
                {nm: Gp[nm] for nm in subs}, {nm: Gmp[nm] for nm in subs},
                dt, chi, euler, M, time)
            if self._immersed:
                upd = {nm: pp.grid.mask_immersed(val, LOC_CCC)
                       for nm, val in upd.items()}
            return upd, {nm: Gm_t[nm] for nm in subs}

        keep = lambda d: {n: d[n] for n in prog if n in d}  # noqa: E731
        return self._map(one, keep(sf), keep(new), keep(nf),
                         {nm: G[nm] for nm in subs},
                         {nm: Gm[nm] for nm in subs})

    # -- the step -------------------------------------------------------------

    def time_step(self, dt):
        """Advance by one step of Δt (on a panel mesh every shard's panels,
        in the shards' threads)."""
        if self._shards is not None:
            self._run(lambda m: m.time_step(dt))
            return self
        if self.timestepper == "QuasiAdamsBashforth2":
            self._ab2_step(dt)
        else:
            self._rk3_step(dt)
        return self

    def tke_substeps(self, dt):
        if self._substepped_tke and getattr(self.closure, "tke_time_step",
                                            None) is not None:
            return self.closure.substeps_for(dt)
        return 1

    def _zstar_start(self, eta_grid):
        eta_g = self.exchange.centers(self._L(eta_grid))
        return eta_g, self._sigma_all(eta_g)

    def _ab2_step(self, dt):
        nt = self._nt
        dt = nt(dt)
        fdt = float(dt)
        state = self.state
        clock = state["clock"]
        time = clock["time"]
        L = self._L
        prog = ("u", "v", "eta") + self.tracer_names
        stepped = ("u", "v") + self.tracer_names
        subs = self._substepped_names
        fs = self.free_surface
        split = isinstance(fs, SplitExplicitFreeSurface)
        st0 = {n: L(state["fields"][n]) for n in prog}
        Gm = {n: L(g) for n, g in state["Gm"].items()}
        euler = clock["iteration"] == 0
        chi0 = 0.1
        chi = nt(-0.5 if euler else chi0)
        c_new, c_old = nt(1.5) + chi, nt(0.5) + chi
        sf = self._filled(st0, time)
        zstar = "dt_sigma" in state
        dts = sig_n = sig_np1 = None
        if zstar:
            eta_g, sig_n = self._zstar_start(state["eta_grid"])
            sig_cc = sig_n[("c", "c")]
            if split:
                bt_n = state["barotropic"]
                Ubt, Vbt = L(bt_n["U"]), L(bt_n["V"])
            else:
                Ubt, Vbt = self._depth_integrals(sf["u"], sf["v"])
                Ubt, Vbt = Ubt * sig_n[("f", "c")], Vbt * sig_n[("c", "f")]
            dhU = self._transport_divergence(Ubt, Vbt)
            dts = self._grid_motion_rate(dhU)
            sf["eta_grid"] = eta_g
        w = self._w(sf, dt_sigma=dts, sigma=sig_n)
        G, auxs = self._tendencies(sf, w, time, dt_sigma=dts)
        if zstar:
            for n in self.tracer_names:
                if n not in subs:
                    G[n] = G[n] * sig_cc
        if euler:
            ab2G = {n: c_new * G[n] for n in stepped}
        else:
            ab2G = {n: c_new * G[n] - c_old * Gm[n] for n in stepped}
        st = dict(st0)
        for n in stepped:
            st[n] = st0[n] + fdt * ab2G[n]
        if zstar:
            Gs = L(state["G_sigma"])
            rate = c_new * dhU if euler else c_new * dhU - c_old * Gs
            eta_g_new = self.exchange.centers(eta_g - fdt * rate)
            sig_np1 = self._sigma_all(eta_g_new)
            for n in self.tracer_names:
                if n not in subs:
                    st[n] = (sig_cc * st0[n] + fdt * ab2G[n]) \
                        / sig_np1[("c", "c")]
        st = self._implicit_all(st, auxs, fdt)
        bt = None
        if split:
            GU, GV = self._depth_integrals(ab2G["u"], ab2G["v"])
            frac, weights = fs.settings(fdt)
            bt0 = state["barotropic"]
            eta_f, U_f, V_f = self._split_explicit_substep(
                st0["eta"], L(bt0["U"]), L(bt0["V"]), GU, GV, dt, frac,
                weights)
            st["u"], st["v"] = self._barotropic_corrector(
                st["u"], st["v"], U_f, V_f, sigma=sig_np1)
            st["eta"] = eta_f
            bt = {"U": U_f, "V": V_f}
        elif isinstance(fs, ImplicitFreeSurface):
            st = self._implicit_eta_step(st, fdt)
        else:
            st["eta"] = self._explicit_eta(st0["eta"], st["u"], st["v"], fdt)
        if self._substepped_tke:
            upd, Gm_t = self._step_turbulence(
                sf, st, G, Gm, fdt, chi0, euler, self.tke_substeps(fdt),
                float(time))
            G = dict(G)
            for nm in subs:
                st[nm] = upd[nm]
                G[nm] = Gm_t[nm]
        st = self._mask_prognostics(st)
        P = self._P
        new = dict(fields={n: P(st[n]) for n in prog},
                   clock=dict(time=time + dt,
                              iteration=clock["iteration"] + 1, last_dt=dt),
                   Gm={n: P(G[n]) for n in stepped})
        if bt is not None:
            new["barotropic"] = {k: P(v) for k, v in bt.items()}
        if zstar:
            if split:
                Ub2, Vb2 = U_f, V_f
            else:
                Ub2, Vb2 = self._depth_integrals(st["u"], st["v"])
                Ub2 = Ub2 * sig_np1[("f", "c")]
                Vb2 = Vb2 * sig_np1[("c", "f")]
            new["dt_sigma"] = P(self._grid_motion_rate(
                self._transport_divergence(Ub2, Vb2)))
            new["eta_grid"] = P(eta_g_new)
            new["G_sigma"] = P(dhU)
        self.state = new

    def _rk3_step(self, dt):
        nt = self._nt
        dt = nt(dt)
        state = self.state
        clock = state["clock"]
        time = clock["time"]
        L, P = self._L, self._P
        prog = ("u", "v", "eta") + self.tracer_names
        st0 = {n: L(state["fields"][n]) for n in prog}
        st = st0
        zstar = "dt_sigma" in state
        implicit = isinstance(self.free_surface, ImplicitFreeSurface)
        dhU = None
        if zstar:
            eta_g0, sig0 = self._zstar_start(state["eta_grid"])
            sc0 = {n: sig0[("c", "c")] * st0[n] for n in self.tracer_names}
            eta_g_stage, sig_stage, eta_g_new = eta_g0, sig0, eta_g0
        for frac in (1.0 / 3.0, 0.5, 1.0):
            sdt = float(nt(frac) * dt)
            sf = self._filled(st, time)
            dts = None
            if zstar:
                Ubt, Vbt = self._depth_integrals(sf["u"], sf["v"])
                dhU = self._transport_divergence(
                    Ubt * sig_stage[("f", "c")], Vbt * sig_stage[("c", "f")])
                dts = self._grid_motion_rate(dhU)
                sf["eta_grid"] = eta_g_stage
            w = self._w(sf, dt_sigma=dts, sigma=sig_stage if zstar else None)
            G, auxs = self._tendencies(sf, w, time, dt_sigma=dts)
            st = dict(st0)
            for n in ("u", "v") + self.tracer_names:
                st[n] = st0[n] + sdt * G[n]
            if zstar:
                eta_g_new = self.exchange.centers(eta_g0 - sdt * dhU)
                sig_new = self._sigma_all(eta_g_new)
                for n in self.tracer_names:
                    st[n] = (sc0[n] + sdt * sig_stage[("c", "c")] * G[n]) \
                        / sig_new[("c", "c")]
            st = self._implicit_all(st, auxs, sdt)
            if implicit:
                st = self._implicit_eta_step(st, sdt)
            else:
                st["eta"] = self._explicit_eta(st0["eta"], st["u"], st["v"],
                                               sdt)
            st = self._mask_prognostics(st)
            if zstar:
                eta_g_stage, sig_stage = eta_g_new, sig_new
        new = dict(fields={n: P(st[n]) for n in prog},
                   clock=dict(time=time + dt,
                              iteration=clock["iteration"] + 1, last_dt=dt))
        if zstar:
            new["eta_grid"] = P(eta_g_new)
            new["G_sigma"] = P(dhU)
            new["dt_sigma"] = P(self._grid_motion_rate(dhU))
        self.state = new

    # -- diagnostics ----------------------------------------------------------

    @property
    def time(self):
        return float(self._clock["time"])

    @property
    def datetime(self):
        return datetime_of(self.time, self.reference_datetime)

    @property
    def iteration(self):
        return int(self._clock["iteration"])

    def diagnose_w(self):
        """w (6, NP, NP, NZ) from continuity, as inside the step (the
        moving face areas and the current ∂t_σ on z*)."""
        L = self._L
        f = self.state["fields"]
        sf = self._filled({n: L(f[n]) for n in ("u", "v", "eta")
                           + self.tracer_names}, self.state["clock"]["time"])
        dts = self.state.get("dt_sigma")
        sig = None
        if dts is not None:
            sig = self._sigma_all(self.exchange.centers(
                L(self.state["eta_grid"])))
            dts = L(dts)
        return self._P(self._w(sf, dt_sigma=dts, sigma=sig))

    def field(self, name):
        """A view whose ``interior`` is (6, N, N, Nz) (η: (6, N, N, 1));
        "w" is diagnosed; u and v are read through the shared-face sync."""
        g0 = self.grid.panel_grids[0]
        H, N = self.grid.H[0], self.grid.N[0]
        f = self.state["fields"]
        if name == "w":
            a = self.diagnose_w()
        elif name in ("u", "v"):
            a = self.exchange.sync(f["u"], f["v"])[name == "v"]
        else:
            a = f[name]
        zsl = (slice(g0.H[2], g0.H[2] + g0.N[2])
               if a.shape[-1] == g0.padded_shape[2] else slice(None))
        return PanelFieldView(a[:, H:H + N, H:H + N, zsl])

    @property
    def fields(self):
        return {n: self.field(n)
                for n in ("u", "v", "eta") + self.tracer_names}

    def total_tracer(self, name):
        """Σ c·Δz·Az over the panels' fluid interiors, float64 on the host
        (the effective Δz under partial cells; σ-weighted on z*)."""
        grid = self.grid
        H, N = grid.H[0], grid.N[0]
        g0 = grid.panel_grids[0]
        hz, nz = g0.H[2], g0.N[2]
        c_all = self.state["fields"][name].detach().cpu().numpy()
        eta = self.state["fields"]["eta"]
        tot = 0.0
        for p, pp in enumerate(self.panels):
            dz = np.asarray(pp._dz_cols.detach().cpu().numpy(), np.float64)
            if dz.ndim == 3:
                dz = dz[H:H + N, H:H + N]
            Az = grid.panel_grids[p].metric_numpy("Az", LOC_CCC)[..., 0]
            c = c_all[p, H:H + N, H:H + N, hz:hz + nz]
            if self._immersed:
                c = c * pp._fluid_int[LOC_CCC].cpu().numpy()[
                    H:H + N, H:H + N]
            wsum = c * dz
            if self.vertical_coordinate == "zstar":
                sig = pp._sigma_fields(eta[p])[("c", "c")]
                wsum = wsum * sig.cpu().numpy()[H:H + N, H:H + N]
            tot += float((wsum.sum(axis=-1) * Az[H:H + N, H:H + N]).sum())
        return tot

    def __repr__(self):
        return (f"CubedSphereHydrostaticModel(grid={self.grid!r}, "
                f"free_surface={type(self.free_surface).__name__}, "
                f"timestepper={self.timestepper})")


def state_from_jax(jax_state_numpy, model):
    """Load a JAX ``CubedSphereHydrostaticModel``'s state into ``model``:
    its stacked (6, NP, NP, ZP) fields, ``eta``, ``time`` and
    ``iteration`` and, as the configuration has them, ``Gm``,
    ``barotropic`` and the z* ``dt_sigma``, ``eta_grid`` and ``G_sigma``
    (arrays as numpy). The layouts are the same."""
    kw = dict(dtype=model.grid.dtype, device=model.grid.device)
    js = jax_state_numpy
    T = lambda a: torch.as_tensor(np.array(a), **kw)  # noqa: E731
    nt = model._nt
    st = dict(fields={n: T(js[n]) for n in model.state["fields"]},
              clock=dict(time=nt(js["time"]), iteration=int(js["iteration"]),
                         last_dt=nt(np.inf)))
    for key in ("Gm", "barotropic"):
        if key in model.state:
            st[key] = {n: T(a) for n, a in js[key].items()}
    for key in ZSTAR_STATE:
        if key in model.state:
            st[key] = T(js[key])
    model.state = st
    return model


__all__ = ["CubedSphereHydrostaticModel", "state_from_jax"]
