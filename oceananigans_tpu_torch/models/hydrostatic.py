"""HydrostaticFreeSurfaceModel: the primitive equations with a free surface.

Counterpart of ``oceananigans_tpu/models/hydrostatic.py``: prognostic u,
v, tracers and η; w diagnosed from continuity; the hydrostatic pressure
anomaly from the buoyancy (``BuoyancyTracer`` or ``SeawaterBuoyancy`` with
any of its equations of state); vector-invariant (with the
multi-dimensional stencil) or flux-form momentum advection, Coriolis,
tracer advection (one scheme, or a dict of per-tracer schemes with a
``"default"``); closures (the scalar diffusivities, tuples, CATKE, k-ε, the
Ri-based and convective-adjustment vertical diffusivities, two-dimensional
Leith, the isopycnal closures, whose advective GM form adds eddy velocities
to the tracers' advecting velocities) with the vertically implicit solve;
forcing; Flux conditions (scalars, functions, field-dependent);
immersed bottoms (``ImmersedBoundaryGrid``); the quasi-AB2 step (Euler on the
first step and when Δt changes) or the split RK3 (three Euler stages from
the step's start); an ``ExplicitFreeSurface``, an ``ImplicitFreeSurface``
(FFT/DCT on a regular RectilinearGrid of constant depth, preconditioned
conjugate gradients elsewhere) or a ``SplitExplicitFreeSurface`` (a fixed
substep count, or ``cfl=`` with the count taken on the host at each step,
the barotropic corrector, and (η, U, V) persisted across steps).

The step follows the JAX ``_build_step`` (its quasi-AB2 route; the split
RK3 runs the same pieces once a stage): fill the halos (zeroing the solid
cells of an immersed grid first), w, the tendencies (advection, Coriolis and ∂ₓ,ᵧ pₕ′; the closure's diffusivities
and terms; forcing; the boundary and immersed fluxes last), the AB2 update,
the closure's vertically implicit solve (with CATKE's damping and clip when
the TKE is not substepped), the free surface and the barotropic corrector,
the immersed masks, then the substepped TKE (CATKE's e, k-ε's e and ε)
from the new velocities (``step_turbulence``: they are not advanced as
ordinary tracers), and w from the new velocities. The two substep counts
that Δt sets, the split-explicit one under ``cfl=`` and the TKE's
M = ceil(Δt/Δτ), are plain Python integers taken at each ``time_step``.
CATKE's surface TKE flux −Cᵂu★·u★³ − CᵂwΔ·max(Jᵇ, 0)·Δz is installed as
e's top Flux condition, from the momentum top fluxes and Jᵇ (the b top flux, or g(αJᵀ − βJˢ) under a
linear equation of state; none under a nonlinear one, as in JAX); k-ε's
friction velocity from the momentum top fluxes.

The tendency of u, v and the tracers' advection goes through
``kernels.fused_vi_tendency`` (the port of TPU kernels #10 and #11) or its
plain PyTorch version, by ``fused_tendencies``; the closure, forcing and
boundary fluxes are added on top, as in JAX:

- ``"auto"`` (the default): on a CUDA grid the kernel where it covers the
  configuration and the plain version elsewhere; on a CPU grid the plain
  version. It never raises for coverage, as the JAX "auto" (its XLA path)
  never does. What JAX's explicit fused path refuses (prescribed
  velocities, z*, eddy-velocity closures, momentum that is not the vector
  invariant, per-tracer schemes) takes the plain version, which covers
  them (``_unfused``), and under ``True`` or ``"packed"`` raises a ValueError
  as JAX's does.
- ``True`` or ``"packed"`` (a TPU layout of the same function): the kernel
  on a CUDA grid (its plain version on a CPU grid); a configuration the
  kernel does not cover raises, on any device, as the JAX opt-in does (an
  ``ImmersedBoundaryGrid`` among them).
- ``False``: the plain version.

``uses_kernel`` says whether a model launches the kernel. Where the JAX
"auto" takes XLA, the port's takes the kernel on the card: a speed choice,
not a semantic one (the JAX fused and XLA paths agree to roundoff, and so
do the port's two paths).

With no ``free_surface`` the model takes the JAX default:
``ImplicitFreeSurface()`` on a RectilinearGrid and
``SplitExplicitFreeSurface(cfl=0.7)`` elsewhere.

Against the JAX model: the Hy-to-8 rounding of the halo (a Mosaic tile
workaround) is dropped, the halo is ``max(grid halo, required)``; z is
scanned with ``torch.cumsum`` where the JAX model contracts with a
triangular matrix (an MXU workaround); the tendencies' halos are zero where
the JAX XLA path leaves stencil values. Two readers see that ring: the
explicit and implicit free surfaces' ∇·∫u dz, for which the port wraps
∫u dz's periodic halos (the JAX ring holds their images), and the TKE
substep's N², which reads the AB2-updated tracers' halos in JAX (ROADMAP.md
queue 3). As in JAX, the stored u and v after a step are the corrected
fields before their halo fill, and w is diagnosed from the filled ones.

``vertical_coordinate="zstar"`` (``ZStarCoordinate()``): the grid
follows the free surface. The tendencies see the σ-scaled metrics of
``zstar.ZStarGrid``, σ = (H + η_grid)/H at each staggering from its column
depth (the fluid depth on an immersed grid, σ = 1 on land); the grid's η
(``eta_grid``, not the barotropic η) is stepped from the barotropic
transport divergence δh_U by the tracers' own AB2 (``G_sigma`` its memory)
or from the step's start in each RK3 stage, so that the σ-weighted tracer
update θⁿ⁺¹ = (σⁿθⁿ + Δt ∂t(σθ))/σⁿ⁺¹ keeps a uniform tracer uniform to
roundoff; ∂t_σ = -δh_U/H enters w and the vector invariant's divergence
flux; the barotropic corrector pins σ·∫u dz. The substepped TKE stays
outside the σ-weighted update, as in JAX.

``velocities=PrescribedVelocityFields(u, v, w)``: the tracer-only mode
(constants or callables of (x, y, z, t)), quasi-AB2 or the split RK3.

Biogeochemistry (reactions and drift, ``biogeochemistry.py``) adds to the
tracer tendencies; auxiliary fields are carried on the model and read by
the forcings.

On a device mesh (JAX's call shape ``model.state = arch.shard(model.state)``
with ``arch = Distributed(...)``, or ``architecture=arch`` when built) the
model is a domain decomposition on resident blocks, as the NH model's
(``parallel/distributed.py``): one model of this class a shard on its local
grid (a RectilinearGrid's, a LatitudeLongitudeGrid's or a shell grid's, the
tripolar one included: nodes, metrics and rotation angles cut from the
global grid's tables, so every block cell sees the serial operands), in
threads that meet only in the halo exchange that ends every fill (the
tripolar fold across the top row of shards included), the implicit free
surface's pencil solve over x and y (``_implicit_free_surface_solve``) and
its conjugate gradients' sums, and the reductions of the CFL, the wizard and
the NaN check. The step assembles no global view; the split-explicit and
explicit steps equal the serial step bit for bit. The updated tracers that
the substepped TKE reads unfilled take their neighbours' values across the
shards' own boundaries (``_exchange_updated``), as the serial model reads
them. A stretched x or y is cut as the lat-lon tables are (the implicit
free surface then takes its serial PCG, its sums over the mesh); polar caps
take their zonal means over the global x (a sum over the mesh in each
fill, ``kernels/halo_fill.py`` ``shard_polar_means``); array and
time-series boundary values are cut at each shard's offset
(``cut_boundary_conditions``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..advection import Centered
from ..biogeochemistry import drift_tendency
from ..advection.vector_invariant import VectorInvariant
from ..boundary_conditions import (apply_flux_bcs_padded,
                                   fill_all_halo_regions,
                                   fill_surface_halo_regions,
                                   regularize_field_boundary_conditions)
from ..boundary_conditions.boundary_condition import (
    FLUX, BoundaryCondition, FieldBoundaryConditions, ZipperBoundaryCondition)
from ..boundary_conditions.fill_halos import (apply_immersed_flux_bcs,
                                              immersed_diffusivity)
from ..buoyancy import BuoyancyTracer, SeawaterBuoyancy
from ..closures.scalar_diffusivity import (ClosureTuple, _ClosureBase,
                                           validate_implicit_closure_z_bcs)
from ..defaults import numpy_dtype
from ..fields import Field, set_on_padded
from ..forcings.forcings import regularize_forcing
from ..grids.base import numpy_metric
from ..grids.topology import LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from ..immersed import ImmersedBoundaryGrid
from ..kernels import (fused_vi_tendency, fused_vi_tendency_plain,
                       periodic_halo_fill)
from ..kernels.fused_vector_invariant import (tracer_advection_plain,
                                              vi_config)
from ..operators.operators import (_metric, ddx, ddy, div_xy_ccc, dx_c, dy_c,
                                   interp)
from ..parallel.distributed import (MeshModel, cut_boundary_conditions,
                                    regularize_architecture)
from ..timesteppers import (QuasiAdamsBashforth2TimeStepper,
                            SplitRungeKutta3TimeStepper)
from ..utils.dateclock import datetime_of
from .free_surfaces import (ExplicitFreeSurface, ImplicitFreeSurface,
                            SplitExplicitFreeSurface)
from .nonhydrostatic import (_vertical_spacings, auxiliary_data,
                             implicit_vertical_diffusion)
from .zstar import ZStarGrid, sigma_from_eta

PROGNOSTIC_LOCS = {"u": LOC_FCC, "v": LOC_CFC}
ZSTAR_STATE = ("dt_sigma", "eta_grid", "G_sigma")


def ZCoordinate():
    """The static vertical coordinate (``vertical_coordinate=``)."""
    return "z"


def ZStarCoordinate():
    """The free-surface-following z* coordinate (``vertical_coordinate=``)."""
    return "zstar"


class PrescribedVelocityFields:
    """Tracer-only mode: u, v and w are prescribed (constants or callables
    f(x, y, z, t) of broadcastable coordinate tensors and the time as a
    float) and not stepped."""

    def __init__(self, u=0.0, v=0.0, w=0.0):
        self.u, self.v, self.w = u, v, w

    def evaluate(self, grid, time):
        """Padded (u, v, w) at ``time``."""
        from ..fields.field import coordinates

        def ev(q, loc):
            if callable(q):
                out = q(*coordinates(grid, loc), float(time))
                return torch.as_tensor(out, dtype=grid.dtype,
                                       device=grid.device).broadcast_to(
                                           grid.padded_shape).contiguous()
            return torch.full(grid.padded_shape, float(q), dtype=grid.dtype,
                              device=grid.device)

        return ev(self.u, LOC_FCC), ev(self.v, LOC_CFC), ev(self.w, LOC_CCF)


def zstar_column_geometry(grid, H_fc, H_cf, immersed):
    """{location: (depth, wet)} at (c, c), (f, c) and (c, f) for σ = (H +
    η)/H: the grid's depth, or on an immersed grid each staggering's fluid
    column depth (float64 numpy) and the mask of the columns deeper than
    1e-9 of the grid's depth (σ = 1 elsewhere)."""
    Lz = abs(grid.extent[2])
    if not immersed:
        return {loc: (Lz, None) for loc in (LOC_CCC, LOC_FCC, LOC_CFC)}
    h, n = grid.H[2], grid.N[2]
    dz3 = np.broadcast_to(
        np.asarray(numpy_metric(grid, "dz", LOC_CCC), float),
        grid.padded_shape)
    H_cc = (dz3 * ~grid.solid_ccc)[:, :, h:h + n].sum(2, keepdims=True)
    thresh = 1e-9 * Lz
    return {LOC_CCC: (np.maximum(H_cc, thresh), H_cc > thresh),
            LOC_FCC: (np.asarray(H_fc), np.asarray(H_fc) > thresh),
            LOC_CFC: (np.asarray(H_cf), np.asarray(H_cf) > thresh)}


def default_free_surface(grid):
    """The JAX model's default free surface for ``grid``: implicit on a
    RectilinearGrid regular in x and y, split-explicit with ``cfl=0.7``
    elsewhere (lat-lon, shell and tripolar grids among them)."""
    from ..grids.rectilinear import RectilinearGrid
    if type(grid) is RectilinearGrid and grid.regular(0) and grid.regular(1):
        return ImplicitFreeSurface()
    return SplitExplicitFreeSurface(cfl=0.7)


def _dz_columns(grid):
    """Δz at the centres over the interior z as a float64 array: (n,) for a
    1-D spacing, or the padded-xy (npx, npy, n) block of a partial-cell
    grid."""
    h, n = grid.H[2], grid.N[2]
    dz = np.asarray(numpy_metric(grid, "dz", LOC_CCC), np.float64)
    if dz.ndim == 3 and (dz.shape[0] > 1 or dz.shape[1] > 1):
        return np.ascontiguousarray(
            np.broadcast_to(dz, grid.padded_shape)[:, :, h:h + n])
    return _vertical_spacings(grid)[0]


def immersed_column_geometry(grid):
    """(H_fc, H_cf, fluid_int, wet_fc, wet_cf) of an immersed grid, float64
    numpy: the fluid depths of the (f, c) and (c, f) columns (clamped away
    from 0), the interior-z fluid masks at fcc, cfc and ccc, and the masks
    of the columns that hold fluid (dry columns, land and solid halo
    columns, take no barotropic increment: anything divided by the clamped
    depth there is discarded)."""
    h, n = grid.H[2], grid.N[2]
    Lz = grid.extent[2]
    dz3 = np.broadcast_to(
        np.asarray(numpy_metric(grid, "dz", LOC_CCC), float),
        grid.padded_shape)

    def coldepth(solid):
        d = (dz3 * ~solid)[:, :, h:h + n].sum(2, keepdims=True)
        return np.maximum(d, 1e-12 * abs(Lz)), d > 0.0

    H_fc, wet_fc = coldepth(grid.solid_fcc)
    H_cf, wet_cf = coldepth(grid.solid_cfc)
    sl = (slice(None), slice(None), slice(h, h + n))
    fluid_int = {LOC_FCC: (~grid.solid_fcc)[sl],
                 LOC_CFC: (~grid.solid_cfc)[sl],
                 LOC_CCC: (~grid.solid_ccc)[sl]}
    return H_fc, H_cf, fluid_int, wet_fc, wet_cf


def _positive(x):
    """max(x, 0) of a tensor or a number."""
    if isinstance(x, torch.Tensor):
        return torch.clamp_min(x, 0.0)
    return max(float(x), 0.0)


class HydrostaticFreeSurfaceModel(MeshModel):
    # the cubed sphere's panel physics (models/cubed_sphere_hydrostatic.py)
    # sets the vertex-corrected vorticity and keeps the stencil values in
    # the tendencies' halos
    _zeta_override = None
    _cut_tendencies = True

    def __init__(self, grid, momentum_advection=None, tracer_advection=None,
                 free_surface=None, tracers=(), buoyancy=None, coriolis=None,
                 closure=None, forcing=None, boundary_conditions=None,
                 velocities=None, timestepper="QuasiAdamsBashforth2",
                 vertical_coordinate="z", biogeochemistry=None,
                 auxiliary_fields=None, fused_tendencies="auto",
                 reference_datetime=None, device=None, dtype=None,
                 architecture=None):
        self.architecture = None
        # the arguments a shard's model is built from (``_enter_mesh``)
        self._shard_kw = dict(
            momentum_advection=momentum_advection,
            tracer_advection=tracer_advection, free_surface=free_surface,
            tracers=tracers, buoyancy=buoyancy, coriolis=coriolis,
            closure=closure, forcing=forcing,
            boundary_conditions=boundary_conditions, velocities=velocities,
            timestepper=timestepper, vertical_coordinate=vertical_coordinate,
            biogeochemistry=biogeochemistry,
            auxiliary_fields=auxiliary_fields,
            fused_tendencies=fused_tendencies,
            reference_datetime=reference_datetime)
        if velocities is not None and not isinstance(
                velocities, PrescribedVelocityFields):
            raise ValueError(f"velocities={velocities!r}: a "
                             f"PrescribedVelocityFields or None")
        self.prescribed_velocities = velocities
        if callable(vertical_coordinate):
            vertical_coordinate = vertical_coordinate()
        if vertical_coordinate not in ("z", "zstar"):
            raise ValueError(f"vertical_coordinate={vertical_coordinate!r}")
        self.vertical_coordinate = vertical_coordinate
        if isinstance(timestepper, SplitRungeKutta3TimeStepper) or \
                timestepper in ("SplitRungeKutta3", "split_rk3"):
            timestepper = SplitRungeKutta3TimeStepper()
        elif timestepper in ("QuasiAdamsBashforth2", "ab2", "qab2"):
            timestepper = QuasiAdamsBashforth2TimeStepper()
        else:
            raise ValueError(f"unknown timestepper {timestepper!r}")
        # per-tracer schemes: {tracer: scheme}, "default" for the others
        self._tracer_advection_map = None
        if isinstance(tracer_advection, dict):
            self._tracer_advection_map = dict(tracer_advection)
            tracer_advection = self._tracer_advection_map.get(
                "default", Centered(2))
        if isinstance(closure, (tuple, list)):
            closure = ClosureTuple(*closure)
        if closure is not None and not isinstance(closure, _ClosureBase):
            raise NotImplementedError(
                f"closure {closure!r} is not one of the closures of "
                f"closures/")
        if fused_tendencies not in (True, False, "packed", "auto"):
            raise ValueError(f"fused_tendencies={fused_tendencies!r}")
        self.reference_datetime = reference_datetime
        self._tendency_hooks = []
        self._state_hooks = []
        if device is not None or dtype is not None:
            grid = grid.to(device=device, dtype=dtype)
        if free_surface is None:
            free_surface = default_free_surface(grid)
            self._shard_kw["free_surface"] = free_surface
        if not isinstance(free_surface, (ExplicitFreeSurface,
                                         ImplicitFreeSurface,
                                         SplitExplicitFreeSurface)):
            raise ValueError(f"unknown free surface {free_surface!r}")
        self.free_surface = free_surface
        self.momentum_advection = (momentum_advection if momentum_advection
                                   is not None else VectorInvariant())
        self.tracer_advection = (tracer_advection if tracer_advection
                                 is not None else Centered(2))
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        for source in (buoyancy, biogeochemistry, closure):
            for n in getattr(source, "required_tracers", ()):
                if n not in tracers:
                    tracers += (n,)
        self.tracer_names = tracers
        self.biogeochemistry = biogeochemistry
        # extra Fields carried on the model (``field``, the forcings'
        # dependencies), not stepped
        self.auxiliary_fields = dict(auxiliary_fields or {})
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.closure = closure
        # closures that read a buoyancy take the model's when given none
        for c in getattr(closure, "closures", (closure,)) if closure else ():
            if hasattr(c, "buoyancy") and c.buoyancy is None:
                c.buoyancy = buoyancy
        self.forcing = regularize_forcing(forcing)
        for name, F in self.forcing.items():
            if hasattr(F, "bind"):
                F.bind(name, self.loc(name), locs=PROGNOSTIC_LOCS)
        self.timestepper = timestepper

        required = max(getattr(self.tracer_advection, "required_halo", 1),
                       getattr(self.momentum_advection, "required_halo", 1))
        for sch in (self._tracer_advection_map or {}).values():
            required = max(required, getattr(sch, "required_halo", 1))
        if closure is not None:
            required = max(required, closure.required_halo)
        halo = tuple(max(h, required) if not grid.is_flat(i) else 0
                     for i, h in enumerate(grid.H))
        self.grid = grid.with_halo(halo)
        if not self.grid.is_bounded(2):
            raise ValueError("HydrostaticFreeSurfaceModel needs a Bounded "
                             "z direction")
        if hasattr(self.free_surface, "materialize"):
            self.free_surface.materialize(self.grid)

        # CATKE's TKE is substepped after each step, not advanced as a
        # tracer
        self._substepped_tke = bool(
            closure is not None and getattr(closure, "substepped_tke", False)
            and velocities is None)
        self._substepped_names = (tuple(closure.substepped_tracers)
                                  if self._substepped_tke else ())
        bcs_in = dict(boundary_conditions or {})
        unknown = set(bcs_in) - {"u", "v", "eta"} - set(tracers)
        if unknown:
            raise ValueError(f"boundary conditions for unknown fields "
                             f"{sorted(unknown)}")
        if self._substepped_tke:
            bcs_in = self._install_tke_surface_flux(bcs_in)
        self.bcs = {name: regularize_field_boundary_conditions(
            bcs_in.get(name), self.grid, loc)
            for name, loc in PROGNOSTIC_LOCS.items()}
        for name in self.tracer_names:
            self.bcs[name] = regularize_field_boundary_conditions(
                bcs_in.get(name), self.grid, LOC_CCC)
        self.bcs["w"] = regularize_field_boundary_conditions(
            None, self.grid, LOC_CCF)
        self.bcs["eta"] = regularize_field_boundary_conditions(
            bcs_in.get("eta"), self.grid, LOC_CCC)
        self.bcs["ph"] = regularize_field_boundary_conditions(
            None, self.grid, LOC_CCC)
        validate_implicit_closure_z_bcs(closure, self.bcs)

        self.uses_kernel = self._kernel_route(fused_tendencies, coriolis)

        kw = dict(dtype=self.grid.dtype, device=self.grid.device)
        h, n = self.grid.H[2], self.grid.N[2]
        dz = _dz_columns(self.grid)
        # Δz over the padded columns (depth integrals) and over the interior
        # ones (w and pₕ′)
        self._dz_cols = torch.as_tensor(np.array(dz), **kw)
        self._dz_int = (self._dz_cols if dz.ndim == 1 else
                        self._dz_cols[self.grid.interior_slices[:2]])
        self._immersed = isinstance(self.grid, ImmersedBoundaryGrid)
        Lz = abs(self.grid.extent[2])
        if self._immersed:
            H_fc, H_cf, fluid_int, wet_fc, wet_cf = \
                immersed_column_geometry(self.grid)
            self._H_fc = torch.as_tensor(H_fc, **kw)
            self._H_cf = torch.as_tensor(H_cf, **kw)
            self._fluid_int = {loc: torch.as_tensor(m, **kw)
                               for loc, m in fluid_int.items()}
            self._wet_fc = torch.as_tensor(wet_fc, **kw)
            self._wet_cf = torch.as_tensor(wet_cf, **kw)
        else:
            self._H_fc = self._H_cf = Lz
            self._fluid_int = None
            self._wet_fc = self._wet_cf = None
        if isinstance(self.free_surface, ImplicitFreeSurface):
            self._setup_implicit_free_surface(H_fc if self._immersed else Lz,
                                              H_cf if self._immersed else Lz)
        if vertical_coordinate == "zstar":
            geo = zstar_column_geometry(
                self.grid, H_fc if self._immersed else Lz,
                H_cf if self._immersed else Lz, self._immersed)
            self._zstar_geo = {
                loc: (H if isinstance(H, float) else torch.as_tensor(H, **kw),
                      None if wet is None else torch.as_tensor(
                          wet, device=self.grid.device))
                for loc, (H, wet) in geo.items()}
            # Δr, the static spacing at the centres, padded
            self._dz_ref = torch.as_tensor(np.array(np.broadcast_to(
                np.asarray(numpy_metric(self.grid, "dz", LOC_CCC), float),
                self.grid.padded_shape)), **kw)
        self._nt = numpy_dtype(self.grid.dtype)
        nt = self._nt
        shape = self.grid.padded_shape
        fields = {name: self._zeros() for name in self.prognostic_3d}
        fields["eta"] = self._zeros(shape[:2] + (1,))
        self.state = dict(
            fields=fields,
            clock=dict(time=nt(0), iteration=0, last_dt=nt(np.inf)),
            w=self._zeros(),
            Gm={name: self._zeros() for name in self.prognostic_3d})
        if isinstance(self.free_surface, SplitExplicitFreeSurface):
            self.state["barotropic"] = {
                "U": self._zeros(shape[:2] + (1,)),
                "V": self._zeros(shape[:2] + (1,))}
        if vertical_coordinate == "zstar":
            # ∂t_σ; the grid's own η (not the barotropic one: it is stepped
            # by the tracers' AB2 from the barotropic transport divergence
            # δh_U, so that a uniform tracer stays uniform); G_sigma, the
            # AB2 memory of δh_U
            for key in ZSTAR_STATE:
                self.state[key] = self._zeros(shape[:2] + (1,))
        architecture = regularize_architecture(architecture)
        if architecture is not None:
            self._enter_mesh(architecture)

    # -- the shards of a model on a device mesh --------------------------------

    def _enter_mesh(self, arch):
        """Put the model on the device mesh ``arch``: one model of this
        class per shard, on the shard's local grid, built from this model's
        arguments; the shards meet in the halo exchange, the pencil solver
        of the implicit free surface (x and y alone) and the reductions.
        This model's own state is dropped: assign a state to scatter it."""
        from ..parallel.pencil_fft import DistributedFFTPoissonSolver
        fs = self.free_surface
        pencil = (isinstance(fs, ImplicitFreeSurface) and (
            self._ifs_method == "FastFourierTransform"
            or self._pcg_precondition))
        arch.place(self.grid, pencil=pencil)
        shards = arch.shards(self.grid)
        if pencil:
            solver = DistributedFFTPoissonSolver(self.grid, arch,
                                                 horizontal=True)
            for sh in shards:
                sh.pencil = solver
        self.architecture = arch
        self._comm = arch.communicator
        self._shards = [HydrostaticFreeSurfaceModel(sh.grid, **dict(
            self._shard_kw, boundary_conditions=cut_boundary_conditions(
                self._shard_kw["boundary_conditions"], self.grid, sh)))
            for sh in shards]
        for m in self._shards:
            m._tendency_hooks = list(self._tendency_hooks)
            m._state_hooks = list(self._state_hooks)
        self._state = None

    def _setup_implicit_free_surface(self, H_fc, H_cf):
        """The implicit free surface's solver, chosen as in JAX: the FFT/DCT
        solve on a regular RectilinearGrid of constant depth, else
        preconditioned conjugate gradients (the FFT solve preconditions it
        on a regular RectilinearGrid). ``H_fc``, ``H_cf``: the column depths
        (float64)."""
        from ..grids.rectilinear import RectilinearGrid
        from ..solvers.fft_poisson import poisson_eigenvalues
        grid = self.grid
        base = getattr(grid, "underlying_grid", grid)
        regular = (isinstance(base, RectilinearGrid) and base.regular(0)
                   and base.regular(1))
        fft_capable = regular and not self._immersed
        method = self.free_surface.solver_method
        if method in ("Default", None):
            method = ("FastFourierTransform" if fft_capable
                      else "PreconditionedConjugateGradient")
        if method == "HeptadiagonalIterativeSolver":
            # the same operator: the matrix-free CG applies it
            method = "PreconditionedConjugateGradient"
        if method not in ("FastFourierTransform",
                          "PreconditionedConjugateGradient"):
            raise ValueError(f"unknown solver_method {method!r}")
        if method == "FastFourierTransform" and not fft_capable:
            raise ValueError("the FFT implicit free-surface solver needs a "
                             "horizontally-regular rectilinear grid with "
                             "constant depth; use solver_method='Precondition"
                             "edConjugateGradient'")
        self._ifs_method = method
        kw = dict(dtype=grid.dtype, device=grid.device)
        self._fs_plan = None
        if method == "FastFourierTransform" or regular:
            lam = np.zeros((1, 1, 1))
            self._fs_plan = []
            for axis in (0, 1):
                if grid.is_flat(axis):
                    continue
                topo = grid.topology[axis]
                sh = [1, 1, 1]
                sh[axis] = grid.N[axis]
                lam = lam + poisson_eigenvalues(
                    grid.N[axis], grid.extent[axis], topo).reshape(sh)
                self._fs_plan.append((axis, "fft" if topo == "periodic"
                                      else "dct"))
            self._fs_lam = torch.as_tensor(lam, **kw)
        if method == "PreconditionedConjugateGradient":
            def m2(name, loc):
                return np.array(np.broadcast_to(np.asarray(
                    numpy_metric(grid, name, loc), float),
                    grid.padded_shape)[:, :, :1])

            # the fluid column's lateral areas: ∫ᶻAx = Δy·H at (f, c),
            # ∫ᶻAy = Δx·H at (c, f)
            self._int_Ax = torch.as_tensor(m2("dy", LOC_FCC)
                                           * np.asarray(H_fc), **kw)
            self._int_Ay = torch.as_tensor(m2("dx", LOC_CFC)
                                           * np.asarray(H_cf), **kw)
            self._az2d = torch.as_tensor(m2("Az", LOC_CCC), **kw)
            self._pcg_metrics = {key: torch.as_tensor(m2(*key), **kw)
                                 for key in (("dx", LOC_FCC), ("dy", LOC_CFC),
                                             ("dy", LOC_FCC),
                                             ("dx", LOC_CFC))}
            self._pcg_precondition = regular

    def _unfused(self):
        """What the JAX fused path refuses and the kernel does not know:
        the reasons, empty when there are none."""
        why = []
        if self.prescribed_velocities is not None:
            why.append("prescribed velocities")
        if self.vertical_coordinate != "z":
            why.append("z* moving coordinate")
        if getattr(self.closure, "has_eddy_velocities", False):
            why.append("eddy-velocity (advective GM) closures")
        if not isinstance(self.momentum_advection, VectorInvariant):
            why.append("non-vector-invariant momentum advection")
        if self._tracer_advection_map is not None:
            why.append("per-tracer advection schemes")
        return why

    def _kernel_route(self, fused_tendencies, coriolis):
        """Whether the tendency launches the kernel (module docstring)."""
        if fused_tendencies is False:
            return False
        why = self._unfused()
        if why:
            if fused_tendencies == "auto":
                return False
            raise ValueError("fused_tendencies is not supported with: "
                             + ", ".join(why))
        on_card = self.grid.device.type == "cuda"
        if fused_tendencies == "auto" and not on_card:
            return False
        try:
            vi_config(self.grid, self.momentum_advection,
                      self.tracer_advection, len(self.tracer_names),
                      coriolis)
        except NotImplementedError:
            if fused_tendencies == "auto":
                return False
            raise
        return on_card

    def _install_tke_surface_flux(self, bcs_in):
        """The substepped closure's surface couplings from the user's
        conditions, as the JAX model derives them. k-ε: the friction
        velocity u★ = (τx² + τy²)^¼ from the u and v top fluxes. CATKE:
        ``surface_buoyancy_flux`` Jᵇ from the top flux
        of b (BuoyancyTracer) or of T and S (SeawaterBuoyancy with a linear
        equation of state: Jᵇ = g(αJᵀ − βJˢ)) unless given, and e's top
        Flux condition −Cᵂu★·u★³ − CᵂwΔ·max(Jᵇ, 0)·Δz with
        u★ = (τx² + τy²)^¼ from the u and v top fluxes, unless the user set
        one. A callable condition keeps its field dependencies, which the
        closure and the e condition read at the surface."""
        def top_flux(name):
            fb = bcs_in.get(name)
            bc = getattr(fb, "top", None) if fb is not None else None
            if bc is None or getattr(bc, "classification", None) != FLUX:
                return None
            cond = bc.condition
            deps = tuple(bc.field_dependencies)
            if hasattr(cond, "evaluate_padded"):
                # a FieldTimeSeries condition as a callable of the plane
                # (the JAX model takes it as a constant and fails on it)
                def series(x, y, t, _c=cond):
                    return _c.evaluate_padded(self.grid, t)
                return series
            if deps and callable(cond):
                def wrapped(x, y, t, *dep_vals, _c=cond):
                    return _c(x, y, t, *dep_vals)
                wrapped.field_dependencies = deps
                return wrapped
            return cond

        clo = getattr(self.closure, "tke_member", None) or self.closure
        if not hasattr(clo, "surface_buoyancy_flux"):
            # k-ε: the friction velocity u★ = (τx² + τy²)^¼ of its ε
            # roughness; its surface e and ε flux coefficients are 0 by
            # default, so no condition is installed
            tau_x, tau_y = top_flux("u"), top_flux("v")
            if clo.friction_velocity is None and (tau_x is not None
                                                  or tau_y is not None):
                if callable(tau_x) or callable(tau_y):
                    def ustar_fn(x, y, t, _tx=tau_x, _ty=tau_y):
                        tx = _tx(x, y, t) if callable(_tx) else (_tx or 0.0)
                        ty = _ty(x, y, t) if callable(_ty) else (_ty or 0.0)
                        return (tx * tx + ty * ty) ** 0.25
                    clo.friction_velocity = ustar_fn
                else:
                    tx, ty = tau_x or 0.0, tau_y or 0.0
                    clo.friction_velocity = (tx * tx + ty * ty) ** 0.25
            return bcs_in
        if clo.surface_buoyancy_flux is None:
            buoy = clo.buoyancy or self.buoyancy
            Jb = None
            if isinstance(buoy, BuoyancyTracer):
                Jb = top_flux("b")
            elif isinstance(buoy, SeawaterBuoyancy) and hasattr(buoy.eos,
                                                                "alpha"):
                JT, JS = top_flux("T"), top_flux("S")
                if JT is not None or JS is not None:
                    g, al, be = buoy.g, buoy.eos.alpha, buoy.eos.beta

                    def Jb_fn(x, y, t, _JT=JT, _JS=JS):
                        jt = (_JT(x, y, t) if callable(_JT)
                              else (_JT or 0.0))
                        js = (_JS(x, y, t) if callable(_JS)
                              else (_JS or 0.0))
                        return g * (al * jt - be * js)

                    Jb = (g * (al * (JT or 0.0) - be * (JS or 0.0))
                          if not (callable(JT) or callable(JS)) else Jb_fn)
            if Jb is not None:
                clo.surface_buoyancy_flux = Jb

        fb_e = bcs_in.get("e")
        if fb_e is not None and getattr(fb_e, "top", None) is not None:
            return bcs_in
        tau_x, tau_y = top_flux("u"), top_flux("v")
        Jb = clo.surface_buoyancy_flux
        if tau_x is None and tau_y is None and Jb is None:
            return bcs_in
        h, n = self.grid.H[2], self.grid.N[2]
        dz_top = float(np.broadcast_to(
            np.asarray(numpy_metric(self.grid, "dz", LOC_CCC), float),
            self.grid.padded_shape)[0, 0, h + n - 1])
        Cwu = clo.tke_equation.Cwu
        CwD = clo.tke_equation.CwD

        def _deps(q):
            return (tuple(getattr(q, "field_dependencies", ()))
                    if callable(q) else ())

        e_deps = _deps(tau_x) + _deps(tau_y) + _deps(Jb)

        def e_top_flux(x, y, t, *dep_vals):
            k = [0]

            def ev(q):
                if q is None:
                    return 0.0
                if callable(q):
                    nd = len(_deps(q))
                    vals = dep_vals[k[0]:k[0] + nd]
                    k[0] += nd
                    return q(x, y, t, *vals)
                return q
            tx, ty = ev(tau_x), ev(tau_y)
            ustar = (tx * tx + ty * ty) ** 0.25
            wD3 = _positive(ev(Jb)) * dz_top
            return -Cwu * ustar ** 3 - CwD * wD3

        top_bc = BoundaryCondition(FLUX, e_top_flux,
                                   field_dependencies=e_deps)
        bcs_in = dict(bcs_in)
        if fb_e is None:
            bcs_in["e"] = FieldBoundaryConditions(top=top_bc)
        else:
            bcs_in["e"] = FieldBoundaryConditions(
                west=fb_e.west, east=fb_e.east, south=fb_e.south,
                north=fb_e.north, bottom=fb_e.bottom, top=top_bc,
                immersed=fb_e.immersed)
        return bcs_in

    # -- properties -----------------------------------------------------------

    @property
    def prognostic_3d(self):
        if self.prescribed_velocities is not None:
            return self.tracer_names
        return ("u", "v") + self.tracer_names

    def tracer_scheme(self, name):
        """The advection scheme of one tracer."""
        if self._tracer_advection_map is not None:
            return self._tracer_advection_map.get(name,
                                                  self.tracer_advection)
        return self.tracer_advection

    @property
    def prognostic_names(self):
        return self.prognostic_3d + ("eta",)

    def loc(self, name):
        if name == "w":
            return LOC_CCF
        return PROGNOSTIC_LOCS.get(name, LOC_CCC)

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
        """The field ``name`` (an auxiliary field is the user's own); on a
        device mesh, a gathered copy of the shards' blocks."""
        if name in self.auxiliary_fields:
            return self.auxiliary_fields[name]
        if self._shards is not None:
            data = self.architecture.gather(
                [m._state["w"] if name == "w" else m._state["fields"][name]
                 for m in self._shards], self.grid.H)
        else:
            data = (self.state["w"] if name == "w"
                    else self.state["fields"][name])
        return Field(self.grid, self.loc(name), self.bcs[name], data,
                     _regularize=False)

    @property
    def fields(self):
        out = {n: self.field(n) for n in self.prognostic_names}
        out["w"] = self.field("w")
        return out

    def _zeros(self, shape=None):
        return torch.zeros(self.grid.padded_shape if shape is None else shape,
                           dtype=self.grid.dtype, device=self.grid.device)

    # -- halo fills and masks -------------------------------------------------

    def _fill_surface(self, a, loc, bcs, time=0.0):
        """The x/y halos of a 2-D surface field, in place."""
        return fill_surface_halo_regions([a], self.grid, [(loc, bcs)],
                                         time)[0]

    def _fill_all(self, fields, time=0.0):
        """Fill the halos of ``fields`` ({name: padded tensor}) in place,
        their conditions at ``time`` (no Δt: a PerturbationAdvection side
        is an Open condition with its value, as in the JAX model); on an
        immersed grid the prognostic fields' solid cells are zeroed first
        (into new tensors)."""
        names = [n for n in fields if n != "eta"]
        if self._immersed:
            for n in names:
                if n in self.prognostic_3d:
                    fields[n] = self.grid.mask_immersed(fields[n],
                                                        self.loc(n))
        fill_all_halo_regions([fields[n] for n in names], self.grid,
                              [(self.loc(n), self.bcs[n]) for n in names],
                              time)
        if "eta" in fields:
            self._fill_surface(fields["eta"], LOC_CCC, self.bcs["eta"], time)
        return fields

    def _mask_state(self, new):
        """Zero the prognostic fields inside the topography."""
        if self._immersed:
            for n in self.prognostic_3d:
                if n in new:
                    new[n] = self.grid.mask_immersed(new[n], self.loc(n))
        return new

    def _mask_kz(self, kz):
        """No implicit diffusive flux through a face next to a solid
        cell."""
        if not self._immersed:
            return kz
        return kz * self.grid.fluid_mask(LOC_CCF, self.grid.dtype)

    # -- set ------------------------------------------------------------------

    def set(self, intrinsic_velocities=False, **values):
        """Set prognostic fields from scalars, arrays or callables of
        (λ, φ, z); η takes a 2-D or (Nx, Ny, 1) array too. Setting u, v or η
        re-initializes the barotropic transports from ∫u dz, ∫v dz. On an
        immersed grid the solid cells are zeroed.

        On a shell grid (rotated lat-lon, tripolar) u and v are geographic
        east and north components unless ``intrinsic_velocities``: they are
        set at the cell centres (one given alone leaves the other 0),
        rotated into the grid's directions, halo-filled (with a −1 fold on a
        tripolar grid: the components are antisymmetric across the fold even
        at the centres), then interpolated to their faces, as in JAX."""
        data = self._set_data(values, intrinsic_velocities)
        if self._shards is not None:
            # evaluated on the global grid, then each shard fills its blocks
            blocks = self.architecture.scatter(data, self.grid.H)
            self._comm.run(lambda r: self._shards[r]._set_blocks(blocks[r]))
            return
        self._set_blocks(data)

    def _set_data(self, values, intrinsic_velocities):
        """{name: padded tensor} of ``set``'s values on the model's grid
        before their fills: η as a (Nx + 2Hx, Ny + 2Hy, 1) surface; u and v
        of a shell grid rotated and interpolated to their faces."""
        from ..grids.orthogonal_spherical_shell import (
            OrthogonalSphericalShellGrid, rotate_from_geographic)
        values = dict(values)
        base = getattr(self.grid, "underlying_grid", self.grid)
        if (isinstance(base, OrthogonalSphericalShellGrid)
                and not intrinsic_velocities
                and ("u" in values or "v" in values)):
            from ..operators.operators import ix_f, iy_f
            u_ccc = set_on_padded(self.grid, LOC_CCC, values.pop("u", 0.0))
            v_ccc = set_on_padded(self.grid, LOC_CCC, values.pop("v", 0.0))
            ui, vi = rotate_from_geographic(base, u_ccc, v_ccc)
            cbcs = self.bcs["ph"]
            if getattr(base, "zipper_north", False):
                cbcs = regularize_field_boundary_conditions(
                    FieldBoundaryConditions(
                        north=ZipperBoundaryCondition(-1.0)),
                    self.grid, LOC_CCC)
            fill_all_halo_regions([ui, vi], self.grid,
                                  [(LOC_CCC, cbcs), (LOC_CCC, cbcs)])
            values["u"] = ix_f(self.grid, ui)
            values["v"] = iy_f(self.grid, vi)
        data = {}
        for name, value in values.items():
            if name not in self.prognostic_names:
                raise ValueError(f"unknown prognostic field {name!r}")
            if name == "eta":
                if not callable(value) and not np.isscalar(value):
                    v2 = torch.as_tensor(np.asarray(value))
                    if v2.ndim == 2:
                        v2 = v2[:, :, None]
                    if (v2.ndim == 3 and v2.shape[2] == 1
                            and self.grid.N[2] > 1 and tuple(v2.shape[:2])
                            != self.grid.padded_shape[:2]):
                        v2 = v2.expand(tuple(v2.shape[:2])
                                       + (self.grid.N[2],))
                    value = v2
                eta = set_on_padded(self.grid, LOC_CCC, value)
                kz = self.grid.H[2] if eta.shape[2] > self.grid.H[2] else 0
                data["eta"] = eta[:, :, kz:kz + 1].clone()
                continue
            data[name] = set_on_padded(self.grid, self.loc(name), value)
        return data

    def _set_blocks(self, data):
        """The rest of ``set`` from ``_set_data``'s tensors (on a device mesh
        each shard's blocks of them): the fills, the immersed masks, the
        grid's η under z* and the barotropic transports."""
        values = data
        fields = dict(self.state["fields"])
        for name, value in data.items():
            if name == "eta":
                fields["eta"] = self._fill_surface(value, LOC_CCC,
                                                   self.bcs["eta"])
                continue
            if self._immersed:
                value = self.grid.mask_immersed(value, self.loc(name))
            fill_all_halo_regions([value], self.grid,
                                  [(self.loc(name), self.bcs[name])])
            fields[name] = value
        self.state = {**self.state, "fields": fields}
        if "eta_grid" in self.state and "eta" in values:
            # the grid's η starts from the same free surface
            self.state = {**self.state, "eta_grid": fields["eta"].clone()}
        if "barotropic" in self.state and {"u", "v", "eta"} & set(values):
            U = self._depth_integral(fields["u"], LOC_FCC)
            V = self._depth_integral(fields["v"], LOC_CFC)
            if "eta_grid" in self.state:
                # z*: the moving-thickness integrals σ·∫u dz
                sig = self._sigma_fields(self.state["eta_grid"])
                U = U * sig[("f", "c")]
                V = V * sig[("c", "f")]
            U = self._fill_surface(U, LOC_FCC, self.bcs["u"])
            V = self._fill_surface(V, LOC_CFC, self.bcs["v"])
            self.state = {**self.state, "barotropic": {"U": U, "V": V}}

    # -- diagnostics ----------------------------------------------------------

    def _depth_integral(self, q, loc):
        """∫ q dz over the fluid column, as a (Nx + 2Hx, Ny + 2Hy, 1)
        tensor."""
        h, n = self.grid.H[2], self.grid.N[2]
        integrand = q[:, :, h:h + n] * self._dz_cols
        if self._immersed:
            integrand = integrand * self._fluid_int[tuple(loc)]
        return integrand.sum(2, keepdim=True)

    def _w_from_continuity(self, u, v, dt_sigma=None, sigma=None):
        """w at the z faces by integrating continuity up from the bottom;
        halos filled. On z* (``sigma``, the per-staggering σ) the horizontal
        divergence takes the moving face areas and each layer adds
        -Δr·∂t_σ (``dt_sigma``), over the fluid cells only."""
        grid = self.grid
        h, n = grid.H[2], grid.N[2]
        sx, sy = grid.interior_slices[:2]
        if sigma is None:
            d = div_xy_ccc(grid, u, v)[sx, sy, h:h + n] * self._dz_int
        else:
            # per moving volume; × σΔr restores [δx + δy]/Az
            d = div_xy_ccc(ZStarGrid(grid, sigma), u, v)[sx, sy, h:h + n] \
                * self._dz_int * sigma[("c", "c")][sx, sy]
        if dt_sigma is not None:
            gm = dt_sigma[sx, sy] * self._dz_int
            if self._immersed:
                gm = gm * self._fluid_int[LOC_CCC][sx, sy]
            d = d + gm
        w = self._zeros()
        w[sx, sy, h + 1:h + n + 1] = -torch.cumsum(d, dim=2)
        return fill_all_halo_regions([w], grid, [(LOC_CCF, self.bcs["w"])])[0]

    def _hydrostatic_pressure(self, fields):
        """pHY′(z) = -∫_z^0 b dz′ at cell centers (centered: half the own
        cell), x/y halos filled; None without buoyancy."""
        if self.buoyancy is None:
            return None
        grid = self.grid
        h, n = grid.H[2], grid.N[2]
        sx, sy = grid.interior_slices[:2]
        bdz = self.buoyancy.buoyancy_ccc(grid, fields)[sx, sy, h:h + n] \
            * self._dz_int
        above = torch.flip(torch.cumsum(torch.flip(bdz, [2]), 2), [2]) - bdz
        p = self._zeros()
        p[sx, sy, h:h + n] = -(0.5 * bdz + above)
        fill_surface_halo_regions([p], grid, [(LOC_CCC, self.bcs["ph"])])
        return p

    # -- z* -------------------------------------------------------------------

    def _sigma_fields(self, eta):
        """σ at (c, c), (f, c) and (c, f) from each staggering's depth; land
        columns keep σ = 1."""
        out = {}
        for loc, (H, wet) in self._zstar_geo.items():
            e = eta
            if loc[0] == "f":
                e = interp(self.grid, eta, 0, "f")
            elif loc[1] == "f":
                e = interp(self.grid, eta, 1, "f")
            out[(loc[0], loc[1])] = sigma_from_eta(e, H, wet)
        return out

    def _barotropic_divergence(self, U, V):
        """δh_U = [δx(Δy U) + δy(Δx V)]/Az at the centres (padded 2-D)."""
        g = self.grid
        return (dx_c(g, _metric(g.dy(LOC_FCC), U) * U)
                + dy_c(g, _metric(g.dx(LOC_CFC), V) * V)) \
            / _metric(g.Az(LOC_CCC), U)

    def _grid_motion_rate(self, dhU):
        """∂t_σ = -δh_U/H over the wet columns, 0 on land."""
        H, wet = self._zstar_geo[LOC_CCC]
        r = -dhU / H
        if wet is not None:
            r = torch.where(wet, r, torch.zeros_like(r))
        return r

    def _moving_grid(self, fields):
        """The σ-scaled grid under z* (σ from the grid's η when the fields
        carry it), else the static grid."""
        if self.vertical_coordinate != "zstar":
            return self.grid
        eta = fields.get("eta_grid", fields["eta"])
        return ZStarGrid(self.grid, self._sigma_fields(eta))

    def _zstar_transports(self, u, v, sig, bt, time):
        """The filled barotropic transports that step the grid's η: the
        persisted (U, V) of the split-explicit free surface, else σ·∫u dz
        of the given velocities."""
        if bt is not None:
            U, V = bt["U"].clone(), bt["V"].clone()
        else:
            U = self._depth_integral(u, LOC_FCC) * sig[("f", "c")]
            V = self._depth_integral(v, LOC_CFC) * sig[("c", "f")]
        U = self._fill_surface(U, LOC_FCC, self.bcs["u"], time)
        V = self._fill_surface(V, LOC_CFC, self.bcs["v"], time)
        return U, V

    # -- tendencies -----------------------------------------------------------

    def _grid_motion(self, u, dt_sigma):
        """z*'s Az·Δr·∂t_σ at ccc in the vector invariant's divergence flux
        (Δr the static reference spacing; the grid moves over the fluid
        cells only), or None: a static grid or flux-form momentum."""
        if dt_sigma is None or not isinstance(self.momentum_advection,
                                              VectorInvariant):
            return None
        gm = _metric(self.grid.Az(LOC_CCC), u) * self._dz_ref * dt_sigma
        if self._immersed:
            gm = gm * self.grid.fluid_mask(LOC_CCC, u.dtype)
        return gm

    def _tracer_schemes(self):
        """The tracer scheme, or a {name: scheme} dict of per-tracer
        schemes."""
        if self._tracer_advection_map is None:
            return self.tracer_advection
        return {n: self.tracer_scheme(n) for n in self.tracer_names}

    def _tracer_velocities(self, grid, cf):
        """The (u, v, w) that advect the tracers: the fields' own plus an
        advective GM closure's eddy velocities."""
        u, v, w = cf["u"], cf["v"], cf["w"]
        if getattr(self.closure, "has_eddy_velocities", False):
            ue, ve, we = self.closure.eddy_velocities(grid, cf)
            u, v, w = u + ue, v + ve, w + we
        return u, v, w

    def _compute_tendencies(self, fields, w, time=0.0, dt_sigma=None):
        """The padded tendencies of u, v and the tracers and the closure's
        diffusivities, in the JAX order: advection, Coriolis and ∂ₓ,ᵧ pₕ′
        (the kernel or its plain version, which also takes z*'s moving grid,
        flux-form momentum, per-tracer schemes and an advective GM
        closure's eddy velocities), the explicit free surface's -g∇η, the
        closure's momentum and tracer terms (a substepped TKE takes only
        the other members' terms here), forcing, then the boundary and
        immersed fluxes."""
        grid = self._moving_grid(fields)
        u, v = fields["u"], fields["v"]
        ph = self._hydrostatic_pressure(fields)
        tracers = {n: fields[n] for n in self.tracer_names}
        cf = dict(fields)
        cf["w"] = w
        if self.uses_kernel:
            Gu, Gv, Gc = fused_vi_tendency(
                grid, self.momentum_advection, self.tracer_advection,
                self.tracer_names, self.coriolis, u, v, w, tracers, ph)
        else:
            Gu, Gv, Gc = fused_vi_tendency_plain(
                grid, self.momentum_advection, self._tracer_schemes(),
                self.tracer_names, self.coriolis, u, v, w, tracers, ph,
                grid_motion=self._grid_motion(u, dt_sigma),
                tracer_velocities=self._tracer_velocities(grid, cf),
                zeta=self._zeta_override, cut=self._cut_tendencies)
        G = {"u": Gu, "v": Gv}
        if isinstance(self.free_surface, ExplicitFreeSurface):
            g = self.free_surface.g
            G["u"] = G["u"] - g * ddx(grid, fields["eta"], LOC_FCC)
            G["v"] = G["v"] - g * ddy(grid, fields["eta"], LOC_CFC)
        aux = {}
        if self.closure is not None:
            aux = self.closure.compute_diffusivities(grid, cf, time)
            mt = self.closure.momentum_tendencies(grid, cf, aux)
            G["u"] = G["u"] + mt["u"]
            G["v"] = G["v"] + mt["v"]
        G.update(Gc)
        if self.closure is not None:
            for name in self.tracer_names:
                if name in self._substepped_names:
                    fn = getattr(self.closure,
                                 "tracer_tendency_excluding_tke", None)
                    if fn is not None:
                        G[name] = G[name] + fn(grid, name, cf, aux)
                else:
                    G[name] = G[name] + self.closure.tracer_tendency(
                        grid, name, cf, aux)
        bgc = self.biogeochemistry
        if bgc is not None:
            for name in self.tracer_names:
                G[name] = G[name] + bgc.tracer_tendency(grid, name, fields,
                                                        time)
                drift = bgc.drift_velocity(name)
                if drift is not None:
                    G[name] = G[name] + drift_tendency(
                        grid, self.tracer_scheme(name), drift, fields[name])
        ffields = ({**fields, **self.state["aux"]} if self.auxiliary_fields
                   else fields)
        for name, F in self.forcing.items():
            G[name] = G[name] + (F(grid, ffields, time) if callable(F)
                                 else F)
        locs = {n: self.loc(n) for n in fields}
        for name in G:
            apply_flux_bcs_padded(G[name], grid, self.loc(name),
                                  self.bcs[name], time, fields=fields,
                                  locs=locs)
            ibc = getattr(self.bcs[name], "immersed", None)
            if self._immersed and ibc is not None:
                G[name] = apply_immersed_flux_bcs(
                    G[name], grid, self.loc(name), ibc, time,
                    c=fields[name],
                    kappa=immersed_diffusivity(self.closure, name))
        for hook in self._tendency_hooks:
            G = hook(grid, fields, G, float(time))
        return G, aux

    def _prescribed_tendencies(self, fields, time):
        """The tracer tendencies, diffusivities and w of the prescribed-
        velocity mode (halos of ``fields`` filled): advection by the
        prescribed (and eddy) velocities, the closure, forcing and the
        boundary fluxes."""
        grid = self.grid
        u, v, w = self.prescribed_velocities.evaluate(grid, time)
        cf = dict(fields, u=u, v=v, w=w)
        aux = {}
        if self.closure is not None:
            aux = self.closure.compute_diffusivities(grid, cf, time)
        tracers = {n: fields[n] for n in self.tracer_names}
        G = tracer_advection_plain(grid, self._tracer_schemes(),
                                   self.tracer_names,
                                   *self._tracer_velocities(grid, cf),
                                   tracers)
        if self.closure is not None:
            for name in self.tracer_names:
                G[name] = G[name] + self.closure.tracer_tendency(
                    grid, name, cf, aux)
        for name, F in self.forcing.items():
            if name in G:
                G[name] = G[name] + (F(grid, fields, time) if callable(F)
                                     else F)
        locs = {n: self.loc(n) for n in fields}
        for name in G:
            apply_flux_bcs_padded(G[name], grid, self.loc(name),
                                  self.bcs[name], time, fields=fields,
                                  locs=locs)
        return G, aux, w

    # -- hooks ----------------------------------------------------------------

    def add_tendency_hook(self, fn):
        """Register ``fn(grid, fields, G, time) -> G``, called on the padded
        tendencies of u, v and the tracers after the boundary fluxes; the
        fused tendency kernel stays on (the hook follows it). On a device
        mesh every shard calls it on its own blocks and grid."""
        for m in self._shards or ():
            m.add_tendency_hook(fn)
        self._tendency_hooks.append(fn)
        return fn

    def add_state_hook(self, fn):
        """Register ``fn(grid, fields, time) -> {name: padded tensor}``,
        whose updates replace fields at the end of every step (on a device
        mesh, every shard's)."""
        for m in self._shards or ():
            m.add_state_hook(fn)
        self._state_hooks.append(fn)
        return fn

    def _run_state_hooks(self):
        if not self._state_hooks:
            return
        fields = dict(self.state["fields"])
        time = self.time
        for hook in self._state_hooks:
            fields.update(hook(self.grid, fields, time))
        self.state = {**self.state, "fields": fields}

    # -- step -----------------------------------------------------------------

    def _implicit_solve(self, new, aux, dt):
        """The closure's vertically implicit diffusion of the updated
        fields (the substepped TKE is left to ``step_turbulence``); CATKE
        run as an ordinary tracer closure adds its damping and the clip."""
        if self.closure is None:
            return new
        kappas = self.closure.vertical_implicit_kappas(self.grid, new, aux)
        dampings = {}
        if self._substepped_tke:
            for nm in self._substepped_names:
                kappas.pop(nm, None)
        elif hasattr(self.closure, "vertical_implicit_damping"):
            dampings = self.closure.vertical_implicit_damping(
                self.grid, new, aux)
        for name, kz in kappas.items():
            if name in new:
                new[name] = implicit_vertical_diffusion(
                    self.grid, new[name], self._mask_kz(kz), dt,
                    damping=dampings.get(name))
        if hasattr(self.closure, "clip_fields") and not self._substepped_tke:
            new = self.closure.clip_fields(new)
        return new

    def _exchange_updated(self, fnew):
        """On a shard's grid, the updated tracers that the substepped TKE
        reads unfilled (as the serial model reads them: ROADMAP.md queue 3)
        take their neighbours' updated values across the shards' own
        boundaries, the global grid's interior; at its walls, its periodic
        seam and the fold they keep the step's start, as the serial model's
        halos do."""
        shard = getattr(self.grid, "shard", None)
        if shard is not None:
            shard.exchange([fnew[n] for n in self.tracer_names
                            if n not in self._substepped_names],
                           periodic=(False, False))

    def tke_substeps(self, dt):
        """CATKE's substep count M for a step of ``dt`` (1 without a
        substepped TKE or without ``tke_time_step``)."""
        if self._substepped_tke and self.closure.tke_time_step is not None:
            return self.closure.substeps_for(dt)
        return 1

    def _fill_uv(self, new, time=0.0):
        """Halo-filled copies of the updated u and v."""
        uf, vf = new["u"].clone(), new["v"].clone()
        fill_all_halo_regions([uf, vf], self.grid,
                              [(LOC_FCC, self.bcs["u"]),
                               (LOC_CFC, self.bcs["v"])], time)
        return uf, vf

    def _stage_free_surface(self, fields0, new, G, dt, barotropic,
                            settings=None, sigma=None):
        """The free surface over a (sub)step of ``dt`` from ``fields0``'s η,
        forced by ``G`` (the AB2-weighted or the stage tendencies); returns
        (new, the barotropic state). ``sigma``: z*'s σ at the (sub)step's
        end, under which the corrector pins the moving-thickness integral
        σ·∫u dz (σ is uniform in the column)."""
        fs = self.free_surface
        if isinstance(fs, SplitExplicitFreeSurface):
            eta_f, U_f, V_f = self._step_split_explicit(
                fields0, G, dt, barotropic, settings)
            Ustar = self._depth_integral(new["u"], LOC_FCC)
            Vstar = self._depth_integral(new["v"], LOC_CFC)
            H_fc, H_cf = self._H_fc, self._H_cf
            if sigma is not None:
                sfc, scf = sigma[("f", "c")], sigma[("c", "f")]
                Ustar, Vstar = Ustar * sfc, Vstar * scf
                H_fc, H_cf = H_fc * sfc, H_cf * scf
            du = (U_f - Ustar) / H_fc
            dv = (V_f - Vstar) / H_cf
            if self._immersed:
                du = du * self._wet_fc
                dv = dv * self._wet_cf
            new["u"] = new["u"] + du
            new["v"] = new["v"] + dv
            new["eta"] = eta_f
            return new, {"U": U_f, "V": V_f}
        U, V = self._transports(new)
        if isinstance(fs, ImplicitFreeSurface):
            return self._implicit_eta_step(fields0["eta"], new, U, V,
                                           dt), None
        grid = self.grid
        div = (dx_c(grid, _metric(grid.dy(LOC_FCC), U) * U)
               + dy_c(grid, _metric(grid.dx(LOC_CFC), V) * V)) \
            / _metric(grid.Az(LOC_CCC), U)
        new["eta"] = fields0["eta"] - dt * div
        return new, None

    def time_step(self, dt):
        """Advance the model by one step of Δt (quasi-AB2 or split RK3; on
        a device mesh every shard's blocks, in the shards' threads, the
        auxiliary fields as they are now scattered first)."""
        if self._shards is not None:
            if self.auxiliary_fields:
                aux = self.architecture.scatter(auxiliary_data(
                    self.grid, self.auxiliary_fields), self.grid.H)
                for m, a in zip(self._shards, aux):
                    m._state = dict(m._state, aux=a)
            self._run(lambda m: m.time_step(dt))
            return self
        if self.auxiliary_fields:
            # the step reads the auxiliary fields as they are now
            self.state = dict(self.state, aux=auxiliary_data(
                self.grid, self.auxiliary_fields))
        rk3 = isinstance(self.timestepper, SplitRungeKutta3TimeStepper)
        if self.prescribed_velocities is not None:
            (self._prescribed_rk3_step if rk3
             else self._prescribed_ab2_step)(dt)
        elif rk3:
            self._split_rk3_step(dt)
        else:
            self._ab2_step(dt)
        self._run_state_hooks()
        if self.biogeochemistry is not None:
            self.biogeochemistry.update_state(self)
        return self

    def _ab2_step(self, dt):
        nt = self._nt
        dt = nt(dt)
        fdt = float(dt)
        state = self.state
        clock = state["clock"]
        time = float(clock["time"])
        euler = clock["iteration"] == 0 or clock["last_dt"] != dt
        c_new, c_old, keep = self.timestepper.coefficients(euler)
        fields = self._fill_all(dict(state["fields"]), time)
        bt = state.get("barotropic")
        zstar = self.vertical_coordinate == "zstar"
        sig_n = dt_sigma_n = sig_np1 = None
        if zstar:
            # ∂t_σ and the grid-η step from the barotropic transport
            # divergence δh_U at tendency time
            eta_g = self._fill_surface(state["eta_grid"].clone(), LOC_CCC,
                                       self.bcs["eta"], time)
            sig_n = self._sigma_fields(eta_g)
            dhU = self._barotropic_divergence(*self._zstar_transports(
                fields["u"], fields["v"], sig_n, bt, time))
            dt_sigma_n = self._grid_motion_rate(dhU)
            fields["eta_grid"] = eta_g
        w = self._w_from_continuity(fields["u"], fields["v"],
                                    dt_sigma=dt_sigma_n, sigma=sig_n)
        G, aux = self._compute_tendencies(fields, w, time,
                                          dt_sigma=dt_sigma_n)
        tracers = [n for n in self.tracer_names
                   if n not in self._substepped_names]
        if zstar:
            # σⁿ-scaled tracer tendencies: the AB2 memory carries them at
            # their own time levels
            for n in tracers:
                G[n] = G[n] * sig_n[("c", "c")]
        Gm = state["Gm"]
        ab2G = {n: c_new * G[n] - c_old * Gm[n] * keep
                for n in self.prognostic_3d}
        new = {n: fields[n] + fdt * ab2G[n] for n in self.prognostic_3d}
        if zstar:
            # the grid's η by the same AB2 as the tracers, so that σⁿ⁺¹
            # telescopes with the σ-weighted update
            # θⁿ⁺¹ = (σⁿθⁿ + Δt ∂t(σθ)) / σⁿ⁺¹
            eta_g_new = self._fill_surface(
                eta_g - fdt * (c_new * dhU - c_old * state["G_sigma"]
                               * keep), LOC_CCC, self.bcs["eta"], time)
            sig_np1 = self._sigma_fields(eta_g_new)
            for n in tracers:
                new[n] = (sig_n[("c", "c")] * fields[n] + fdt * ab2G[n]) \
                    / sig_np1[("c", "c")]
        new = self._implicit_solve(new, aux, fdt)
        new, bt = self._stage_free_surface(fields, new, ab2G, fdt, bt,
                                           sigma=sig_np1)
        new = self._mask_state(new)
        uf, vf = self._fill_uv(new, time)
        dt_sigma = None
        if zstar:
            # ∂t_σ for the next step's diagnostics
            dt_sigma = self._grid_motion_rate(self._barotropic_divergence(
                *self._zstar_transports(uf, vf, sig_np1, bt, time)))
        if self._substepped_tke:
            # the TKE from the updated velocities, restarting from the old e
            fnew = dict(new)
            fnew.update(u=uf, v=vf,
                        **{nm: fields[nm] for nm in self._substepped_names})
            self._exchange_updated(fnew)
            slow = {nm: G[nm] for nm in self._substepped_names}
            prev = {nm: Gm[nm] for nm in self._substepped_names}
            upd, Gm_t = self.closure.step_turbulence(
                self.grid, fields, fnew, slow, prev, fdt,
                self.timestepper.chi, euler, self.tke_substeps(fdt), time)
            G = dict(G)
            for nm, val in upd.items():
                if self._immersed:
                    val = self.grid.mask_immersed(val, LOC_CCC)
                new[nm] = val
                G[nm] = Gm_t[nm]
        w_new = self._w_from_continuity(uf, vf, dt_sigma=dt_sigma,
                                        sigma=sig_np1)
        self._advance_state(new, w_new, G, bt, dt)
        if zstar:
            self.state.update(dt_sigma=dt_sigma, eta_grid=eta_g_new,
                              G_sigma=dhU)
        return self

    def _split_rk3_step(self, dt):
        """Three stages, each an Euler step of Δt/β from the step's start
        (β = 3, 2, 1): the tendencies of the stage's fields, the implicit
        solve, the free surface (split-explicit: with the whole step's
        substep settings) and, for a substepped TKE, one Euler substep of
        the stage; the masks. The step-start fields keep their halos as
        stored (the fills work on copies), as in JAX. Under z* each stage
        restarts the grid's η and σθ from the step's start."""
        nt = self._nt
        dt = nt(dt)
        fdt = float(dt)
        state = self.state
        time = float(state["clock"]["time"])
        fields0 = state["fields"]
        bt = state.get("barotropic")
        settings = (self.free_surface.settings(fdt) if isinstance(
            self.free_surface, SplitExplicitFreeSurface) else None)
        zstar = self.vertical_coordinate == "zstar"
        tracers = [n for n in self.tracer_names
                   if n not in self._substepped_names]
        sig_stage = None
        if zstar:
            eta_g0 = self._fill_surface(state["eta_grid"].clone(), LOC_CCC,
                                        self.bcs["eta"], time)
            sig0 = self._sigma_fields(eta_g0)
            sc0 = {n: sig0[("c", "c")] * fields0[n] for n in tracers}
            eta_g_stage, sig_stage = eta_g0, sig0
            eta_g_new, dhU = eta_g0, None
        fields = fields0
        G = None
        for beta in self.timestepper.betas:
            sdt = fdt / beta
            ff = self._fill_all({n: a.clone() for n, a in fields.items()},
                                time)
            dt_sig = None
            if zstar:
                dhU = self._barotropic_divergence(*self._zstar_transports(
                    ff["u"], ff["v"], sig_stage, bt, time))
                dt_sig = self._grid_motion_rate(dhU)
                ff["eta_grid"] = eta_g_stage
            w = self._w_from_continuity(ff["u"], ff["v"], dt_sigma=dt_sig,
                                        sigma=sig_stage)
            G, aux = self._compute_tendencies(ff, w, time, dt_sigma=dt_sig)
            new = {n: fields0[n] + sdt * G[n] for n in self.prognostic_3d}
            sig_new = None
            if zstar:
                # the grid-η substep from the step's start
                eta_g_new = self._fill_surface(eta_g0 - sdt * dhU, LOC_CCC,
                                               self.bcs["eta"], time)
                sig_new = self._sigma_fields(eta_g_new)
                for n in tracers:
                    new[n] = (sc0[n] + sdt * sig_stage[("c", "c")] * G[n]) \
                        / sig_new[("c", "c")]
            new = self._implicit_solve(new, aux, sdt)
            new, bt = self._stage_free_surface(fields0, new, G, sdt, bt,
                                               settings, sigma=sig_new)
            if zstar:
                eta_g_stage, sig_stage = eta_g_new, sig_new
            if self._substepped_tke:
                # χ = -1/2: the AB2 combination is an Euler step of the
                # stage tendency
                uf, vf = self._fill_uv(new, time)
                fnew = dict(new)
                fnew.update(u=uf, v=vf, **{nm: fields0[nm] for nm in
                                           self._substepped_names})
                self._exchange_updated(fnew)
                slow = {nm: G[nm] for nm in self._substepped_names}
                upd, _ = self.closure.step_turbulence(
                    self.grid, ff, fnew, slow, slow, sdt, -0.5, True, 1,
                    time)
                for nm, val in upd.items():
                    if self._immersed:
                        val = self.grid.mask_immersed(val, LOC_CCC)
                    new[nm] = val
            fields = self._mask_state(new)
        uf, vf = self._fill_uv(fields, time)
        dt_sigma = None
        if zstar:
            dt_sigma = self._grid_motion_rate(self._barotropic_divergence(
                *self._zstar_transports(uf, vf, sig_stage, bt, time)))
        w_new = self._w_from_continuity(uf, vf, dt_sigma=dt_sigma,
                                        sigma=sig_stage)
        self._advance_state(fields, w_new, G, bt, dt)
        if zstar:
            self.state.update(dt_sigma=dt_sigma, eta_grid=eta_g_new,
                              G_sigma=dhU)
        return self

    def _prescribed_implicit(self, new, aux, dt):
        """The closure's implicit vertical diffusion of the tracers in the
        prescribed-velocity mode."""
        if self.closure is None:
            return new
        kappas = self.closure.vertical_implicit_kappas(self.grid, new, aux)
        for name, kz in kappas.items():
            if name in new and name != "eta":
                new[name] = implicit_vertical_diffusion(
                    self.grid, new[name], self._mask_kz(kz), dt)
        return new

    def _prescribed_ab2_step(self, dt):
        """The tracer-only quasi-AB2 step over prescribed velocities."""
        nt = self._nt
        dt = nt(dt)
        fdt = float(dt)
        state = self.state
        clock = state["clock"]
        time = float(clock["time"])
        euler = clock["iteration"] == 0 or clock["last_dt"] != dt
        c_new, c_old, keep = self.timestepper.coefficients(euler)
        fields = self._fill_all(dict(state["fields"]), time)
        G, aux, w = self._prescribed_tendencies(fields, time)
        Gm = state["Gm"]
        new = {n: fields[n] + fdt * (c_new * G[n] - c_old * Gm[n] * keep)
               for n in self.tracer_names}
        new["eta"] = fields["eta"]
        new = self._prescribed_implicit(self._mask_state(new), aux, fdt)
        self._advance_state(new, w, G, None, dt)
        return self

    def _prescribed_rk3_step(self, dt):
        """The tracer-only split RK3 over prescribed velocities: three Euler
        stages of Δt/β from the step's start."""
        nt = self._nt
        dt = nt(dt)
        fdt = float(dt)
        time = float(self.state["clock"]["time"])
        fields0 = self.state["fields"]
        fields = fields0
        G = w = None
        for beta in self.timestepper.betas:
            sdt = fdt / beta
            ff = self._fill_all({n: a.clone() for n, a in fields.items()},
                                time)
            G, aux, w = self._prescribed_tendencies(ff, time)
            new = {n: fields0[n] + sdt * G[n] for n in self.tracer_names}
            new["eta"] = fields0["eta"]
            fields = self._prescribed_implicit(self._mask_state(new), aux,
                                               sdt)
        self._advance_state(fields, w, G, None, dt)
        return self

    def _advance_state(self, fields, w, G, barotropic, dt):
        clock = self.state["clock"]
        old = self.state
        self.state = dict(fields=fields,
                          clock=dict(time=self._nt(clock["time"] + dt),
                                     iteration=clock["iteration"] + 1,
                                     last_dt=dt),
                          w=w, Gm=G)
        if barotropic is not None:
            self.state["barotropic"] = barotropic
        for key in ZSTAR_STATE:
            if key in old:
                self.state[key] = old[key]

    # -- the implicit free surface --------------------------------------------

    def _transports(self, new):
        """∫u dz and ∫v dz of the updated velocities, their periodic halos
        wrapped: the JAX tendencies carry the periodic images in their
        first halo ring, where the port's are zero, and the divergence at
        the seam reads that ring."""
        U = self._depth_integral(new["u"], LOC_FCC)
        V = self._depth_integral(new["v"], LOC_CFC)
        return tuple(periodic_halo_fill(self.grid, [U, V]))

    def _transform(self, b, inverse=False):
        """The FFT (periodic) or DCT-II (bounded) of the 2-D ``b`` along x
        then y (their inverses in the reverse order)."""
        from ..solvers.transforms import dct2_matrix, idct2_matrix
        plan = reversed(self._fs_plan) if inverse else self._fs_plan
        for axis, kind in plan:
            if kind == "fft":
                b = (torch.fft.ifft if inverse else torch.fft.fft)(b, dim=axis)
                continue
            M = (idct2_matrix if inverse else dct2_matrix)(b.shape[axis])
            M = torch.as_tensor(M, dtype=b.dtype, device=b.device)
            b = torch.movedim(torch.matmul(torch.movedim(b, axis, -1),
                                           M.transpose(0, 1)), -1, axis)
        return b

    def _implicit_free_surface_solve(self, eta_rhs, dt, H=None):
        """(1 + gHΔt²λ) η̂ = η̂* in transform space; ``H`` overrides the
        column depth (the constant depth of the PCG preconditioner)."""
        grid = self.grid
        sx, sy = grid.interior_slices[:2]
        g = self.free_surface.g
        H = self._H_fc if H is None else H
        shard = getattr(grid, "shard", None)
        if shard is not None:
            # the pencil over x and y, with this operator's divide
            c = g * H * dt * dt
            b = shard.pencil.solve_block(
                shard.rank, eta_rhs[sx, sy, :].contiguous(),
                spectral=lambda bh, lam: bh / (1.0 + c * lam))
        else:
            b = self._transform(eta_rhs[sx, sy, :])
            b = b / (1.0 + g * H * dt * dt * self._fs_lam.to(eta_rhs.dtype))
            b = self._transform(b, inverse=True)
        if b.is_complex():
            b = b.real
        eta = torch.zeros_like(eta_rhs)
        eta[sx, sy, :] = b.to(eta_rhs.dtype)
        return eta

    def _implicit_pcg_solve(self, eta_n, U, V, dt):
        """Matrix-free preconditioned CG for the implicit free surface:

            L(η) = δx(∫ᶻAx ∂x η) + δy(∫ᶻAy ∂y η) − Az η/(gΔt²)
            rhs  = (δx(Δy U★) + δy(Δx V★) − Az ηⁿ/Δt) / (gΔt)

        with the FFT solve of constant depth Lz as the preconditioner on a
        regular RectilinearGrid."""
        from ..operators.operators import dx_f, dy_f
        from ..solvers.conjugate_gradient import conjugate_gradient
        grid = self.grid
        g = self.free_surface.g
        sx, sy = grid.interior_slices[:2]
        m = self._pcg_metrics
        dx_fc, dy_cf = m[("dx", LOC_FCC)], m[("dy", LOC_CFC)]
        dy_fc, dx_cf = m[("dy", LOC_FCC)], m[("dx", LOC_CFC)]

        def embed(e_int):
            e = torch.zeros_like(eta_n)
            e[sx, sy, :] = e_int
            return e

        def L(e_int):
            eta = self._fill_surface(embed(e_int), LOC_CCC, self.bcs["eta"])
            fx = self._int_Ax * dx_f(grid, eta) / dx_fc
            fy = self._int_Ay * dy_f(grid, eta) / dy_cf
            lap = dx_c(grid, fx) + dy_c(grid, fy)
            out = lap - self._az2d * eta / (g * dt * dt)
            return out[sx, sy, :]

        rhs = ((dx_c(grid, dy_fc * U) + dy_c(grid, dx_cf * V)
                - self._az2d * eta_n / dt) / (g * dt))[sx, sy, :]
        precond = None
        if self._pcg_precondition:
            Lz = abs(grid.extent[2])
            az = self._az2d[sx, sy, :]

            def precond(r):
                # L ≈ −Az/(gΔt²)(1 − gH̄Δt²∇²) at the constant depth Lz
                rr = embed(-(g * dt * dt) * r / az)
                return self._implicit_free_surface_solve(rr, dt, H=Lz)[
                    sx, sy, :]

        reltol = 1e-7 if eta_n.dtype == torch.float64 else 1e-5
        # on a shard's grid the dot products sum over the mesh, and the
        # iteration cap is the global grid's
        shard = getattr(grid, "shard", None)
        n_xy = (grid.N[0] * grid.N[1] if shard is None else
                shard.global_grid.N[0] * shard.global_grid.N[1])
        x, _, _ = conjugate_gradient(
            L, rhs, x0=eta_n[sx, sy, :], preconditioner=precond,
            reltol=reltol, maxiter=n_xy, shard=shard)
        return embed(x)

    def _implicit_eta_step(self, eta_n, new, U, V, dt):
        """The backward-Euler free-surface step and the barotropic velocity
        correction u ← u* − Δt g ∂x ηⁿ⁺¹."""
        grid = self.grid
        if self._ifs_method == "FastFourierTransform":
            div = (dx_c(grid, _metric(grid.dy(LOC_FCC), U) * U)
                   + dy_c(grid, _metric(grid.dx(LOC_CFC), V) * V)) \
                / _metric(grid.Az(LOC_CCC), U)
            eta = self._implicit_free_surface_solve(eta_n - dt * div, dt)
        else:
            eta = self._implicit_pcg_solve(eta_n, U, V, dt)
        eta = self._fill_surface(eta, LOC_CCC, self.bcs["eta"])
        g = self.free_surface.g
        new["u"] = new["u"] - dt * g * ddx(grid, eta, LOC_FCC)
        new["v"] = new["v"] - dt * g * ddy(grid, eta, LOC_CFC)
        new["eta"] = eta
        return new

    def _step_split_explicit(self, fields, ab2G, dt, barotropic,
                             settings=None):
        """Substep (η, U, V) from the persisted barotropic state, forced by
        the depth integrals of the AB2-weighted tendencies; returns the
        filtered (η, U, V), halos filled."""
        fs = self.free_surface
        locs_bcs = [(LOC_CCC, self.bcs["eta"]), (LOC_FCC, self.bcs["u"]),
                    (LOC_CFC, self.bcs["v"])]

        def fill(eta, U, V):
            return tuple(fill_surface_halo_regions([eta, U, V], self.grid,
                                                   locs_bcs))

        GU = self._depth_integral(ab2G["u"], LOC_FCC)
        GV = self._depth_integral(ab2G["v"], LOC_CFC)
        eta_f, U_f, V_f = fs.substep(
            self.grid, self._H_fc, self._H_cf, fields["eta"],
            barotropic["U"], barotropic["V"], GU, GV, dt, fill, settings)
        return fill(eta_f, U_f, V_f)

    def __repr__(self):
        return (f"HydrostaticFreeSurfaceModel(grid={self.grid!r}, "
                f"free_surface={type(self.free_surface).__name__}, "
                f"closure={self.closure!r}, tracers={self.tracer_names})")


def state_from_jax(jax_state_numpy, model):
    """Load a JAX ``HydrostaticFreeSurfaceModel``'s state into ``model``.

    ``jax_state_numpy`` is the JAX model's ``state`` with its arrays
    converted to numpy (``fields``, ``clock``, ``w``, ``Gm``, under the
    split-explicit free surface ``barotropic``, and under z* ``dt_sigma``,
    ``eta_grid`` and ``G_sigma``). The JAX arrays may have
    wider halos (the JAX model rounds Hy up to 8): each is cut to the port's
    padded layout, keeping the slots nearest the interior, so the boundary
    faces and every halo the port holds carry the JAX values."""
    def crop(arr):
        arr = np.asarray(arr)
        sl = []
        for axis in range(3):
            want = (model.grid.padded_shape[axis] if arr.shape[axis] > 1
                    else 1)
            extra = arr.shape[axis] - want
            if extra < 0 or extra % 2:
                raise ValueError(f"array of shape {arr.shape} does not hold "
                                 f"the padded layout {model.grid.padded_shape}")
            sl.append(slice(extra // 2, extra // 2 + want))
        return torch.as_tensor(np.ascontiguousarray(arr[tuple(sl)]),
                               dtype=model.grid.dtype,
                               device=model.grid.device)

    s = jax_state_numpy
    nt = model._nt
    state = dict(
        fields={n: crop(s["fields"][n]) for n in model.prognostic_names},
        clock=dict(time=nt(s["clock"]["time"]),
                   iteration=int(s["clock"]["iteration"]),
                   last_dt=nt(s["clock"]["last_dt"])),
        w=crop(s["w"]),
        Gm={n: crop(s["Gm"][n]) for n in model.prognostic_3d})
    if "barotropic" in model.state:
        state["barotropic"] = {k: crop(s["barotropic"][k]) for k in "UV"}
    for key in ZSTAR_STATE:
        if key in model.state:
            state[key] = crop(s[key])
    model.state = state
    return model


__all__ = ["HydrostaticFreeSurfaceModel", "PrescribedVelocityFields",
           "ZCoordinate", "ZStarCoordinate", "state_from_jax"]
