"""NonhydrostaticModel: incompressible LES/DNS with a 3D pressure projection.

Counterpart of ``oceananigans_tpu/models/nonhydrostatic.py`` on a
RectilinearGrid of any topology (periodic, bounded or flat x, y and z),
regular or stretched along any axes, on an ``ImmersedBoundaryGrid``
(``GridFittedBottom``, ``PartialCellBottom``, ``GridFittedBoundary``) and on
the curvilinear grids the JAX model takes (``LatitudeLongitudeGrid``):
flux-form advection,
tracers, buoyancy (``BuoyancyTracer``, ``SeawaterBuoyancy`` with its
equations of state, ``BuoyancyForce`` for a tilted gravity), Coriolis, the
closures of ``closures/`` (the scalar-diffusivity family, closure tuples,
Smagorinsky, Lilly, dynamic Smagorinsky, AMD, and the vertical closures,
CATKE among them as an ordinary tracer closure with its implicit damping)
with the vertically implicit solve, user forcing, Stokes drift, background
fields, the boundary conditions of ``boundary_conditions/`` on every side of
every field, w included (Open conditions with a value or with
``PerturbationAdvection``, and array, callable and FieldTimeSeries values),
RK3 or quasi-AB2, and the pressure solver of ``select_pressure_solver`` or
the user's ``pressure_solver=``: FFT/DCT on a regular grid,
Fourier-tridiagonal with one stretched bounded axis, the conjugate-gradient
solvers elsewhere (``make_immersed_poisson_solver`` on an immersed grid,
``make_variable_spacing_poisson_solver`` on a grid stretched along several
axes or a periodic one and on curvilinear grids), biogeochemistry
(reactions and drift, ``biogeochemistry.py``), Lagrangian particles
(``particles.py``, advected at the end of each step) and auxiliary fields
(read by the forcings).

On an immersed grid the model takes the padded layout and the plain flux
divergences with the near-wall cascade of the schemes (as the JAX model
takes no kernel there), zeroes every field's solid cells before each fill,
and u, v and w's around the projection, and adds the immersed boundary
fluxes. Open sides: every fill of a stage (before the tendencies and in the
projection) is given the clock time and the stage's Δt, so that a
PerturbationAdvection face steps toward its exterior value; before the
divergence, the normal velocity of the PerturbationAdvection sides is
shifted uniformly so that the net volume flux through the open sides is
zero (``_balance_open_mass``). A face field whose high boundary face the
fill does not pin (PerturbationAdvection, or a Flux or Gradient condition
on the wall-normal velocity) is stepped there too, as the JAX model steps
its whole padded array: its tendencies and update cover that face
(``_regions``).

The layout and the step follow the JAX package's choice (its ``__init__``
and ``_build_step``, without the TPU's Nz % 128 gate, Hy-to-8 rounding, lane
tail and tile picks):

- **z-compact** on a regular grid with periodic x and y and a bounded z
  (JAX's ``eligible_zc``) when there is no closure, forcing, Stokes drift,
  background field or user z boundary condition: no z halo (the z boundary
  conditions
  live inside the stencil reads) and ``Hx = Hy = required_halo + 1`` (one
  ring for the deferred correction). When advection is the only tendency
  (no buoyancy, no Coriolis, RK3, no mesh), each RK3 stage runs the fused
  advection + stage-update kernel over u, v, w and the tracers, the
  divergence kernel, the FFT/DCT solve and the halo-fill kernel on the new
  pressure. With ``fuse_correction`` (the default, as in the JAX package)
  stages 1 and 2 only solve for p, and the next stage's update kernel
  applies the correction while it reads the velocities (the tracers are
  advected by the corrected velocities); stage 3 projects with the
  correction kernel. Otherwise each stage takes the tendency route below on
  this layout, with w's bottom face pinned to 0 after each update and the
  projection by the divergence kernel, the solve and the correction kernel.
- **padded** otherwise: every halo ``H = max(grid.H, required_halo)`` (the
  advection's or the closure's) on each axis that is not flat. Each stage
  (RK3) or step (quasi-AB2) fills all halos (one fill launch for all fields;
  a periodic axis wraps, z included), computes the tendencies, updates, runs
  the closure's implicit vertical solve, and projects: fill u, v, w, a plain
  PyTorch divergence, the solve, the pressure fill, a plain PyTorch
  correction (the JAX package computes these in XLA too).

The tendencies (``_tendencies``) follow the JAX ``_compute_tendencies``:
advection (the tendency kernel where JAX's ``eligible`` takes its kernel:
periodic x and y, neither flat, a regular grid, with a bounded, periodic or
flat z; elsewhere, and with background fields, the plain flux divergences of
the JAX XLA path, background fields in their perturbation form), Coriolis,
buoyancy, Stokes drift,
the closure's momentum terms, the tracers' advection and closure terms,
forcing, and the boundary fluxes last. The closure sees the model clock.
Closure state fields (the Lagrangian dynamic Smagorinsky's JLM and JMM) ride
in the state's fields, unchanged through the stages (the JAX step gives
them a zero tendency), and are advanced at the end of each step.

With ``architecture=Distributed(...)`` the model is a domain decomposition
(``parallel/distributed.py``): each shard of the mesh holds its padded
blocks of every prognostic field on its own device for the whole run and
steps a model of this class on its own local grid (the global grid's nodes
and metrics cut at the shard's offset, its x and y connected), in threads
that meet only where the JAX package's collectives meet: every fill ends
with the halo exchange, the pressure solve is the pencil solver's block
entry (``parallel/pencil_fft.py``; on an immersed grid the CG solver with
its dot products summed over the mesh and the pencil solver as its
preconditioner), and the diagnostics reduce over the shards. The advective
tendency is #7 on each shard's blocks (``shard_fused_advection``) where the
serial model takes #6. As in the JAX package the fused update route and
the fused correction stay off under a mesh. The mesh takes periodic x and
y with a periodic, bounded, flat or stretched z, either layout, immersed
bottoms and auxiliary fields; ``model.state`` then returns a gathered copy
(writes into it do not reach the shards) and ``model.state = ...`` (or
``arch.shard(...)``) scatters a global-view state into the blocks. It
refuses, citing ROADMAP item 16b, bounded or stretched x and y, curvilinear
grids and the CG solvers of multiply stretched ones, particles, Open and
PerturbationAdvection boundaries and array boundary values. Sharded ≡
serial holds to rounding: the pencil transforms y and x in complex form
where the serial solver takes a real FFT along x.

The model updates tensors in place where the JAX package returned new
arrays: the halo fills write into the padded tensors they are given, and the
padded projection corrects the stage's new velocities in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..advection import Centered
from ..advection.fluxes import div_Uc, div_Uu, div_Uv, div_Uw
from ..advection.schemes import adapt_advection_order
from ..background_fields import evaluate_background
from ..biogeochemistry import drift_tendency
from ..boundary_conditions import (apply_flux_bcs, fill_all_halo_regions,
                                   regularize_field_boundary_conditions)
from ..boundary_conditions.boundary_condition import (OPEN,
                                                      PerturbationAdvection)
from ..boundary_conditions.fill_halos import (apply_immersed_flux_bcs,
                                              immersed_diffusivity)
from ..closures.scalar_diffusivity import (ClosureTuple, _ClosureBase,
                                           validate_implicit_closure_z_bcs)
from ..defaults import numpy_dtype
from ..fields import Field, set_on_padded
from ..forcings.forcings import regularize_forcing
from ..grids.base import numpy_metric
from ..grids.topology import (BOUNDED, FACE, LOC_CCC, LOC_CCF, LOC_CFC,
                              LOC_FCC, PERIODIC)
from ..immersed import ImmersedBoundaryGrid
from ..kernels import (fused_advection_tendency, fused_advection_update,
                       fused_correct, fused_divergence, periodic_halo_fill)
from ..kernels.fused_advection import (bounded_refusal,
                                      kernel_tendency_eligible)
from ..kernels.fused_advection import shard_fused_advection
from ..kernels.halo_fill import exchange_connected
from ..parallel.distributed import MESH_ITEM, regularize_architecture
from ..solvers.fft_poisson import FFTPoissonSolver
from ..solvers.fourier_tridiagonal import FourierTridiagonalPoissonSolver
from ..solvers.tridiagonal import solve_batched_tridiagonal
from ..timesteppers import (RK3_GAMMAS, RK3_ZETAS,
                            QuasiAdamsBashforth2TimeStepper,
                            RungeKutta3TimeStepper)
from ..utils.dateclock import datetime_of

PROGNOSTIC_LOCS = {"u": LOC_FCC, "v": LOC_CFC, "w": LOC_CCF}

def _timestepper(timestepper):
    if timestepper in ("RungeKutta3", "rk3") or isinstance(
            timestepper, RungeKutta3TimeStepper):
        return RungeKutta3TimeStepper()
    if timestepper in ("QuasiAdamsBashforth2", "ab2", "qab2"):
        return QuasiAdamsBashforth2TimeStepper()
    if isinstance(timestepper, QuasiAdamsBashforth2TimeStepper):
        return timestepper
    raise ValueError(f"unknown timestepper {timestepper!r}")


def select_pressure_solver(grid, fill_p=None):
    """The JAX ``select_pressure_solver``'s choice: on an immersed grid the
    conjugate-gradient solver with the masked Laplacian (preconditioned by
    the FFT solver of the underlying grid when it is regular); on a grid
    that is not a RectilinearGrid, and on one stretched along several axes
    or along a periodic one, the variable-spacing conjugate-gradient solver;
    the FFT/DCT solver on a regular grid; the Fourier-tridiagonal solver
    with one stretched bounded axis (x, y or z). ``fill_p`` fills a padded
    pressure's halos in place (the CG solvers' operator)."""
    from ..grids.rectilinear import RectilinearGrid
    from ..solvers.conjugate_gradient import make_immersed_poisson_solver
    from ..solvers.fourier_tridiagonal import \
        make_variable_spacing_poisson_solver
    if fill_p is None:
        bcs = regularize_field_boundary_conditions(None, grid, LOC_CCC)
        fill_p = lambda p: fill_all_halo_regions([p], grid, [(LOC_CCC, bcs)])
    shard = getattr(grid, "shard", None)
    if shard is not None:
        # a shard's grid: the shard's view of the model's pencil solver,
        # the CG solver on its block on an immersed grid
        from ..parallel.pencil_fft import ShardPoissonSolver
        fft = (None if shard.pencil is None
               else ShardPoissonSolver(shard.pencil, shard))
        if isinstance(grid, ImmersedBoundaryGrid):
            return make_immersed_poisson_solver(grid, fill_p, fft)
        return fft
    if isinstance(grid, ImmersedBoundaryGrid):
        under = grid.underlying_grid
        fft = FFTPoissonSolver(under) if under.all_regular else None
        return make_immersed_poisson_solver(grid, fill_p, fft)
    if not isinstance(grid, RectilinearGrid):
        return make_variable_spacing_poisson_solver(grid, fill_p)
    if grid.all_regular:
        return FFTPoissonSolver(grid)
    stretched = grid.stretched_axes
    if len(stretched) == 1 and grid.topology[stretched[0]] == BOUNDED:
        return FourierTridiagonalPoissonSolver(grid,
                                               stretched_axis=stretched[0])
    return make_variable_spacing_poisson_solver(grid, fill_p)


def mesh_pressure_solver(grid, arch, pressure_solver=None):
    """The pressure solver of a model on the device mesh ``arch``: the
    pencil solver (``DistributedFFTPoissonSolver``) of the grid (of the
    underlying grid of an immersed one, whose shards run the CG solver with
    it as their preconditioner when that grid is regular, as JAX's
    ``select_pressure_solver`` takes the FFT preconditioner; None
    otherwise). A user's ``pressure_solver`` must be a
    ``DistributedFFTPoissonSolver``. The model refuses the grids that would
    need the variable-spacing CG (a stretched x or y, curvilinear grids)
    before it asks (``_refuse_under_mesh``, ROADMAP item 16b)."""
    from ..parallel.pencil_fft import DistributedFFTPoissonSolver
    if pressure_solver is not None:
        if not isinstance(pressure_solver, DistributedFFTPoissonSolver):
            raise NotImplementedError(
                f"a user pressure solver other than the pencil solver under "
                f"a device mesh: {MESH_ITEM}")
        return pressure_solver
    immersed = isinstance(grid, ImmersedBoundaryGrid)
    under = grid.underlying_grid if immersed else grid
    if immersed and not under.all_regular:
        return None
    return DistributedFFTPoissonSolver(under, arch)


class NonhydrostaticModel:
    def __init__(self, grid, advection=None, tracers=(), buoyancy=None,
                 coriolis=None, closure=None, forcing=None,
                 boundary_conditions=None, timestepper="RungeKutta3",
                 pressure_solver=None, background_fields=None,
                 stokes_drift=None, biogeochemistry=None, particles=None,
                 auxiliary_fields=None, fuse_correction=True,
                 architecture=None, reference_datetime=None, device=None,
                 dtype=None):
        self._shards = None
        # the arguments a shard's model is built from (``_build_shards``)
        shard_kw = dict(advection=advection, tracers=tracers,
                        buoyancy=buoyancy, coriolis=coriolis,
                        closure=closure, forcing=forcing,
                        boundary_conditions=boundary_conditions,
                        timestepper=timestepper,
                        background_fields=background_fields,
                        stokes_drift=stokes_drift,
                        biogeochemistry=biogeochemistry,
                        fuse_correction=fuse_correction,
                        reference_datetime=reference_datetime)
        if isinstance(closure, (tuple, list)):
            closure = ClosureTuple(*closure)
        if closure is not None and not isinstance(closure, _ClosureBase):
            raise NotImplementedError(
                f"closure {closure!r} is not one of the closures of "
                "closures/")
        if device is not None or dtype is not None:
            grid = grid.to(device=device, dtype=dtype)
        self.architecture = regularize_architecture(architecture)
        if self.architecture is not None:
            self.architecture.place(grid, pencil=True)
            if particles is not None:
                raise NotImplementedError(
                    f"Lagrangian particles under a device mesh: {MESH_ITEM}")
        self.reference_datetime = reference_datetime
        self._tendency_hooks = []
        self._state_hooks = []
        self.timestepper = _timestepper(timestepper)
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
        self.particles = particles
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.closure = closure
        self.stokes_drift = stokes_drift
        # closures that read a buoyancy (Lilly's Smagorinsky, AMD's Cb)
        # take the model's when given none
        for c in getattr(closure, "closures", (closure,)) if closure else ():
            if hasattr(c, "buoyancy") and c.buoyancy is None:
                c.buoyancy = buoyancy
        self.forcing = regularize_forcing(forcing)
        for name, F in self.forcing.items():
            if hasattr(F, "bind"):
                F.bind(name, self.loc(name), locs=PROGNOSTIC_LOCS)
        self.background_fields = dict(background_fields or {})

        bcs_in = dict(boundary_conditions or {})
        diff_bcs = {key: bcs_in.pop(key) for key in ("nu_e", "kappa_e")
                    if bcs_in.get(key) is not None}
        unknown = set(bcs_in) - set(PROGNOSTIC_LOCS) - set(tracers)
        if unknown:
            raise ValueError(f"boundary conditions for unknown fields {unknown}")
        user_zbcs = any(getattr(b, side, None) is not None
                        for b in bcs_in.values() for side in ("bottom", "top"))
        self.immersed = isinstance(grid, ImmersedBoundaryGrid)
        # JAX's eligible_zc, without its Nz % 128 gate; an immersed grid
        # takes the padded layout (the z-compact route's kernels take no
        # immersed grid)
        self._z_compact = (grid.all_regular and grid.topology == (
            PERIODIC, PERIODIC, BOUNDED)
            and closure is None and not self.forcing
            and stokes_drift is None and not self.immersed
            and biogeochemistry is None and particles is None
            and getattr(advection, "bounds", None) is None
            and not self.background_fields and not user_zbcs)
        # the advective GM form advects the tracers with eddy velocities
        # added, which the kernel does not know (JAX leaves its fused path
        # too)
        self._kernel_tendency = (kernel_tendency_eligible(grid)
                                 and not self.immersed
                                 and not getattr(closure,
                                                 "has_eddy_velocities",
                                                 False))
        # advection is the only tendency: the fused update route (off under
        # a mesh, as JAX's gate)
        self._fused_update = (
            self._z_compact and buoyancy is None and coriolis is None
            and isinstance(self.timestepper, RungeKutta3TimeStepper)
            and self.architecture is None
            and getattr(grid, "shard", None) is None)
        self.fuse_correction = bool(fuse_correction) and self._fused_update

        if advection is None:
            advection = Centered(order=2)
        advection = adapt_advection_order(advection, grid)
        self.advection = advection
        required = advection.required_halo
        if self._z_compact:
            # one spare ring in x and y for the deferred correction; no z halo
            halo = (max(grid.H[0], required + 1),
                    max(grid.H[1], required + 1), 0)
        else:
            if closure is not None:
                required = max(required, closure.required_halo)
            halo = tuple(0 if grid.is_flat(ax) else max(h, required)
                         for ax, h in enumerate(grid.H))
        self.grid = grid.with_halo(halo)
        for ax, topo in enumerate(self.grid.topology):
            if topo == PERIODIC and self.grid.N[ax] < halo[ax]:
                raise ValueError(f"a periodic halo needs N >= H along axis "
                                 f"{ax} (N={self.grid.N[ax]}, H={halo[ax]})")
        if self.grid.topology[2] == BOUNDED and \
                self.grid.N[2] < halo[2] + 1:
            raise ValueError("the bounded-z halo fill needs Nz > Hz")

        if diff_bcs:
            if closure is None:
                raise ValueError("diffusivity boundary conditions "
                                 f"({sorted(diff_bcs)}) need a closure")
            for key, spec in diff_bcs.items():
                diff_bcs[key] = (
                    {n: regularize_field_boundary_conditions(
                        b, self.grid, LOC_CCC) for n, b in spec.items()}
                    if isinstance(spec, dict) else
                    regularize_field_boundary_conditions(spec, self.grid,
                                                         LOC_CCC))
            for c in getattr(closure, "closures", (closure,)):
                c.diffusivity_boundary_conditions = diff_bcs
        self.bcs = {name: regularize_field_boundary_conditions(
            bcs_in.get(name), self.grid, self.loc(name))
            for name in self.prognostic_names}
        self._regions = {name: self._update_region(name)
                         for name in self.prognostic_names}
        if any(r != self.grid.interior_slices
               for r in self._regions.values()):
            # the tendency kernel writes the interior alone
            self._kernel_tendency = False
        why = bounded_refusal(self.grid, self.advection, self.grid.dtype)
        if self._kernel_tendency and why and self.grid.device.type == "cuda":
            # JAX's kernel takes it: refused, not sent to the plain tendency
            raise NotImplementedError(why)
        self.bcs["p"] = regularize_field_boundary_conditions(
            None, self.grid, LOC_CCC)
        validate_implicit_closure_z_bcs(closure, self.bcs)
        # closure-owned state (carried in the fields, stepped by the closure)
        self._closure_state = tuple(getattr(closure, "state_fields", ())
                                    or ())
        for name in self._closure_state:
            self.bcs[name] = regularize_field_boundary_conditions(
                None, self.grid, LOC_CCC)
        if self.architecture is not None:
            self._refuse_under_mesh()
            pressure_solver = mesh_pressure_solver(
                self.grid, self.architecture, pressure_solver)
        elif pressure_solver is None:
            bcs_p = self.bcs["p"]
            pressure_solver = select_pressure_solver(
                self.grid, lambda p: fill_all_halo_regions(
                    [p], self.grid, [(LOC_CCC, bcs_p)]))
        self.pressure_solver = pressure_solver
        self._sharded_advection = None
        if getattr(self.grid, "shard", None) is not None and \
                self._kernel_tendency:
            self._sharded_advection = lambda q: shard_fused_advection(
                self.grid, self.advection, q)
        if self.architecture is not None:
            self._build_shards(shard_kw)
            self._nt = numpy_dtype(self.grid.dtype)
            return

        nt = numpy_dtype(self.grid.dtype)
        self._nt = nt
        names = self.prognostic_names + self._closure_state
        self.state = dict(
            fields={n: self._zeros() for n in names},
            pressure=self._zeros(),
            clock=dict(time=nt(0), iteration=0, last_dt=nt(np.inf)))
        if isinstance(self.timestepper, QuasiAdamsBashforth2TimeStepper):
            self.state["Gm"] = {n: torch.zeros(
                tuple(s.stop - s.start for s in self._regions[n]),
                dtype=self.grid.dtype, device=self.grid.device)
                for n in self.prognostic_names}
        if self.particles is not None:
            self.state["particles"] = self.particles.initial_state(self.grid)

    # -- the shards of a model on a device mesh -----------------------------------

    def _refuse_under_mesh(self):
        """What the mesh does not take yet raises, citing ROADMAP item
        16b: bounded or stretched x and y, grids that are not rectilinear,
        Open and PerturbationAdvection sides, array or time-series
        boundary values."""
        from ..grids.rectilinear import RectilinearGrid
        under = getattr(self.grid, "underlying_grid", self.grid)
        if not isinstance(under, RectilinearGrid):
            raise NotImplementedError(
                f"a {type(under).__name__} under a device mesh: {MESH_ITEM}")
        for ax in (0, 1):
            if under.topology[ax] != PERIODIC or not under.regular(ax):
                raise NotImplementedError(
                    f"a {under.topology[ax]} or stretched sharded axis "
                    f"{'xy'[ax]}: {MESH_ITEM}")
        for name, bcs in self.bcs.items():
            for ax in range(3):
                for bc in bcs.pair(ax):
                    if bc is None:
                        continue
                    if bc.classification == OPEN and (
                            bc.scheme is not None
                            or bc.condition is not None):
                        raise NotImplementedError(
                            f"an Open boundary of {name!r} under a device "
                            f"mesh: {MESH_ITEM}")
                    c = bc.condition
                    if hasattr(c, "evaluate_padded") or (
                            not callable(c) and np.ndim(
                                c.detach().cpu() if hasattr(c, "detach")
                                else c) > 0):
                        raise NotImplementedError(
                            f"an array or time-series boundary value of "
                            f"{name!r} under a device mesh: {MESH_ITEM}")

    def _build_shards(self, kw):
        """One model of this class per shard, on the shard's local grid,
        with the pencil solver's shard view as its pressure solver."""
        arch = self.architecture
        shards = arch.shards(self.grid)
        for sh in shards:
            sh.pencil = self.pressure_solver
        self._comm = arch.communicator
        self._shards = [NonhydrostaticModel(sh.grid, **kw) for sh in shards]
        self._sharded_advection = self._shards[0]._sharded_advection

    def _run(self, fn):
        """``fn(shard_model)`` on every shard, in the shards' threads."""
        return self._comm.run(lambda r: fn(self._shards[r]))

    @property
    def state(self):
        """The model state: fields, pressure, clock (and Gm for quasi-AB2).
        On a device mesh, a gathered global-view copy on the mesh's first
        device: writes into it do not reach the shards (assign a state to
        ``model.state`` to scatter it)."""
        if self._shards is None:
            return self._state
        return self._gathered_state()

    @state.setter
    def state(self, value):
        if self._shards is None:
            self._state = value
        else:
            self._scatter_state(value)

    def _gathered_state(self):
        arch, H = self.architecture, self.grid.H
        states = [m._state for m in self._shards]
        out = {}
        for key, val in states[0].items():
            if key in ("fields", "pressure", "aux"):
                out[key] = arch.gather([st[key] for st in states], H)
            elif key == "Gm":
                out[key] = arch.gather([st[key] for st in states], (0, 0, 0))
            elif key == "clock":
                out[key] = dict(val)
            else:
                out[key] = val
        return out

    def _scatter_state(self, value):
        arch, H = self.architecture, self.grid.H
        parts = {}
        for key, val in value.items():
            if key in ("fields", "pressure", "aux"):
                parts[key] = arch.scatter(val, H)
            elif key == "Gm":
                parts[key] = arch.scatter(val, (0, 0, 0))
        for r, m in enumerate(self._shards):
            st = {k: (parts[k][r] if k in parts else
                      dict(v) if k == "clock" else v)
                  for k, v in value.items()}
            m._state = st

    @property
    def _clock(self):
        return (self._shards[0]._state if self._shards is not None
                else self._state)["clock"]

    # -- basic properties -----------------------------------------------------

    @property
    def prognostic_names(self):
        return ("u", "v", "w") + self.tracer_names

    @property
    def device(self):
        return self.grid.device

    @property
    def dtype(self):
        return self.grid.dtype

    def loc(self, name):
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
            key = "pressure" if name == "p" else "fields"
            data = self.architecture.gather(
                [m._state[key] if name == "p" else m._state[key][name]
                 for m in self._shards], self.grid.H)
        else:
            data = (self.state["pressure"] if name == "p"
                    else self.state["fields"][name])
        loc = LOC_CCC if name == "p" else self.loc(name)
        return Field(self.grid, loc, self.bcs[name], data, _regularize=False)

    def _zeros(self):
        return torch.zeros(self.grid.padded_shape, dtype=self.grid.dtype,
                           device=self.grid.device)

    def _update_region(self, name):
        """The padded slices a field's tendency and update cover: the
        interior, and for a wall-normal velocity whose high boundary face
        the fill does not pin (PerturbationAdvection, a Flux or Gradient
        condition) that face too, which the JAX model steps with the rest
        of its padded array."""
        from ..kernels.halo_fill import PA_FACE, REFLECT, _side_code
        grid = self.grid
        region = list(grid.interior_slices)
        loc = self.loc(name)
        for axis in range(3):
            if loc[axis] != FACE or grid.topology[axis] != BOUNDED or \
                    grid.H[axis] == 0:
                continue
            if _side_code(self.bcs[name].pair(axis)[1], True,
                          pa=True) in (PA_FACE, REFLECT):
                H, N = grid.H[axis], grid.N[axis]
                region[axis] = slice(H, H + N + 1)
        return tuple(region)

    def _region_of(self, name, a):
        """A padded (or broadcastable) tensor over the field's update
        region; scalars pass."""
        if not isinstance(a, torch.Tensor) or a.ndim == 0:
            return a
        return a.broadcast_to(self.grid.padded_shape)[self._regions[name]]

    def _fill_all(self, fields, time=0.0, dt=None):
        """Fill the halos of ``fields`` ({name: padded tensor}) in place,
        their conditions at ``time`` (``dt``: the stage's Δt, for the
        PerturbationAdvection faces); on an immersed grid the solid cells
        are zeroed first."""
        names = list(fields)
        if self.immersed:
            for n in names:
                if n != "p":
                    self.grid.mask_immersed_(fields[n], self.loc(n))
        fill_all_halo_regions(
            [fields[n] for n in names], self.grid,
            [(self.loc(n) if n != "p" else LOC_CCC, self.bcs[n])
             for n in names], time=float(time),
            dt=None if dt is None else float(dt))
        return fields

    # -- setting initial conditions -------------------------------------------

    def set(self, enforce_incompressibility=True, **values):
        """Set prognostic fields from scalars/arrays/functions, then project
        the velocities onto their divergence-free part (with Δt = 1, as the
        JAX model projects). On a device mesh the values are set on the
        global grid, scattered into the shards' blocks, and each shard
        fills and projects its blocks."""
        if self._shards is not None:
            names = set(self.prognostic_names + self._closure_state)
            for name in values:
                if name not in names:
                    raise ValueError(f"unknown prognostic field {name!r}")
            blocks = self.architecture.scatter(
                {n: set_on_padded(self.grid, self.loc(n), v)
                 for n, v in values.items()}, self.grid.H)
            self._comm.run(lambda r: self._shards[r].set(
                enforce_incompressibility, **blocks[r]))
            return
        fields = dict(self.state["fields"])
        time = self.state["clock"]["time"]
        for name, value in values.items():
            if name not in fields:
                raise ValueError(f"unknown prognostic field {name!r}")
            fields[name] = set_on_padded(self.grid, self.loc(name), value)
        self._fill_all({name: fields[name] for name in values}, time)
        if enforce_incompressibility and any(k in values for k in "uvw"):
            # the padded projection works in place: keep the old state's
            # tensors
            vel = [fields[c] if c in values or self._z_compact
                   else fields[c].clone() for c in "uvw"]
            u, v, w, _ = self._project(*vel, self._nt(1.0), time)
            fields.update(u=u, v=v, w=w)
        self.state = {**self.state, "fields": fields}

    # -- step -------------------------------------------------------------------

    def _solve_padded(self, rhs, time=0.0):
        """Solve ∇²p = rhs and return p padded, with its halos filled."""
        p_int = self.pressure_solver.solve(rhs)
        p = torch.empty(self.grid.padded_shape, dtype=rhs.dtype,
                        device=rhs.device)
        p[self.grid.interior_slices] = p_int
        if self._z_compact:
            periodic_halo_fill(self.grid, [p])
        else:
            self._fill_all({"p": p}, time)
        return p

    @property
    def _open_sides(self):
        """The Open sides of the wall-normal velocities that carry a volume
        flux: (name, axis, is_left, has the PerturbationAdvection scheme),
        the scheme's sides and those with a condition (JAX's
        ``_open_sides``)."""
        sides = []
        for name, axis in (("u", 0), ("v", 1), ("w", 2)):
            if self.grid.topology[axis] != BOUNDED:
                continue
            for bc, is_left in zip(self.bcs[name].pair(axis), (True, False)):
                if bc is not None and bc.classification == OPEN:
                    scheme = isinstance(bc.scheme, PerturbationAdvection)
                    if scheme or bc.condition is not None:
                        sides.append((name, axis, is_left, scheme))
        return sides

    def _balance_open_mass(self, vel):
        """Shift the PerturbationAdvection sides' normal velocity uniformly
        so that the net volume flux through the open sides is zero (JAX's
        ``_balance_open_mass``: the solvability of the pressure problem);
        in place. Returns the correction (a 0-d tensor), or None without
        such sides."""
        sides = self._open_sides
        if not any(s[3] for s in sides):
            return None
        grid = self.grid
        areas = (grid.Ax(LOC_FCC), grid.Ay(LOC_CFC), grid.Az(LOC_CCF))
        total_flux = total_area = 0.0
        planes = []
        for name, axis, is_left, scheme in sides:
            H, N = grid.H[axis], grid.N[axis]
            sl = list(grid.interior_slices)
            sl[axis] = slice(H, H + 1) if is_left else slice(H + N,
                                                             H + N + 1)
            sl = tuple(sl)
            A = torch.as_tensor(areas[axis], dtype=grid.dtype,
                                device=grid.device).broadcast_to(
                                    grid.padded_shape)[sl]
            flux = torch.sum(vel[name][sl] * A)
            total_flux = total_flux + (flux if is_left else -flux)
            if scheme:
                total_area = total_area + torch.sum(A)
                planes.append((name, sl, is_left))
        corr = total_flux / total_area
        for name, sl, is_left in planes:
            vel[name][sl] += -corr if is_left else corr
        return corr

    def _project(self, u, v, w, dtt, time=0.0, halos_valid=False):
        """Pressure projection: the divergence and correction kernels in the
        z-compact layout (a fill of u, v, w first unless ``halos_valid``; new
        tensors out); in the padded layout, in place, JAX's order: the solid
        cells of an immersed grid zeroed, a fill of u, v, w (with Δt, at the
        clock ``time``), the open sides' mass balance, the plain PyTorch
        divergence, the solve, the pressure fill, the plain correction of
        the whole padded tensors, the solid cells zeroed again."""
        if self._z_compact:
            if not halos_valid:
                self._fill_all(dict(u=u, v=v, w=w), time, dtt)
            rhs = fused_divergence(self.grid, u, v, w, self._nt(1.0) / dtt)
            p = self._solve_padded(rhs)
            u, v, w = fused_correct(self.grid, p, u, v, w, dtt)
            # the correction wraps its outputs' halos; a shard's come from
            # its neighbours
            exchange_connected(self.grid, [u, v, w])
            return u, v, w, p
        grid = self.grid
        self._fill_all(dict(u=u, v=v, w=w), time, dtt)
        self._balance_open_mass(dict(u=u, v=v, w=w))
        dtt = float(dtt)
        rhs = _interior_divergence(grid, u, v, w) / dtt
        p = self._solve_padded(rhs, time)
        # the whole padded tensors, halos included, as the JAX step
        # corrects them (u -= Δt·∂x p, ...): the filled halos then hold the
        # corrected values; in place, through one scratch tensor
        d = torch.empty_like(p)
        for axis, (a, delta) in enumerate(((u, grid.dx), (v, grid.dy),
                                           (w, grid.dz))):
            if not grid.is_flat(axis):
                _padded_gradient(d, p, axis, delta((LOC_FCC, LOC_CFC,
                                                    LOC_CCF)[axis]))
                a -= d.mul_(dtt)
        if self.immersed:
            for name, a in zip("uvw", (u, v, w)):
                grid.mask_immersed_(a, self.loc(name))
        return u, v, w, p

    def _advection(self, fields, time):
        """The advective tendencies (interior-shaped) of the prognostic
        fields: the tendency kernel (sharded under a mesh); with background
        fields the plain perturbation form of the JAX XLA path, -∇·(𝐔q′)
        - ∇·(𝐮′q_bg) with 𝐔 = 𝐮′ + 𝐮_bg."""
        grid = self.grid
        names = self.prognostic_names
        if not self.background_fields and self._kernel_tendency:
            q = [fields[n] for n in names]
            Gall = (fused_advection_tendency(grid, self.advection, q)
                    if self._sharded_advection is None
                    else self._sharded_advection(q))
            return dict(zip(names, Gall.unbind(0)))
        bg = {name: evaluate_background(grid, self.loc(name), b, time)
              for name, b in self.background_fields.items()}
        adv = self.advection
        vel = [fields[c] for c in "uvw"]
        total = [a + bg[c] if c in bg else a for c, a in zip("uvw", vel)]
        G = {}
        for c, div in zip("uvw", (div_Uu, div_Uv, div_Uw)):
            g = -div(grid, adv, *total, advected=fields[c])
            if c in bg:
                g = g - div(grid, adv, *vel, advected=bg[c])
            G[c] = g
        tracer_vel = total
        if getattr(self.closure, "has_eddy_velocities", False):
            eddy = self.closure.eddy_velocities(grid, fields)
            tracer_vel = [a + e for a, e in zip(total, eddy)]
        for name in self.tracer_names:
            g = -div_Uc(grid, adv, *tracer_vel, fields[name])
            if name in bg:
                g = g - div_Uc(grid, adv, *vel, bg[name])
            G[name] = g
        return {n: self._region_of(n, g) for n, g in G.items()}

    def _tendencies(self, fields, time):
        """The tendencies of the prognostic fields over their update regions
        (``_region``) and the closure's diffusivities, in the JAX package's
        order: advection, Coriolis, buoyancy, Stokes drift, the closure's
        momentum terms, the tracers' closure terms, forcing, boundary fluxes
        (and the immersed ones). The closure state has none: it is carried
        through the stages."""
        grid = self.grid
        G = self._advection(fields, time)
        u, v, w = fields["u"], fields["v"], fields["w"]
        R = self._region_of
        if self.coriolis is not None:
            for c, fn in zip("uvw", ("x_f_cross_U", "y_f_cross_U",
                                     "z_f_cross_U")):
                G[c] = G[c] - R(c, getattr(self.coriolis, fn)(grid, u, v, w))
        if self.buoyancy is not None:
            for c, fn in zip("uvw", ("x_buoyancy", "y_buoyancy",
                                     "z_buoyancy")):
                term = getattr(self.buoyancy, fn, lambda g, f: None)(
                    grid, fields)
                if term is not None:
                    G[c] = G[c] + R(c, term)
        if self.stokes_drift is not None:
            for c, fn in zip("uvw", ("x_tendency", "y_tendency",
                                     "z_tendency")):
                G[c] = G[c] + R(c, getattr(self.stokes_drift, fn)(
                    grid, u, v, w, time))
        aux = {}
        if self.closure is not None:
            aux = self.closure.compute_diffusivities(grid, fields, time)
            mt = self.closure.momentum_tendencies(grid, fields, aux)
            for c in "uvw":
                G[c] = G[c] + R(c, mt[c])
            for name in self.tracer_names:
                G[name] = G[name] + R(name, self.closure.tracer_tendency(
                    grid, name, fields, aux))
        bgc = self.biogeochemistry
        if bgc is not None:
            for name in self.tracer_names:
                G[name] = G[name] + R(name, bgc.tracer_tendency(
                    grid, name, fields, time))
                drift = bgc.drift_velocity(name)
                if drift is not None:
                    G[name] = G[name] + R(name, drift_tendency(
                        grid, self.advection, drift, fields[name]))
        aux_data = self.state.get("aux")
        ffields = {**fields, **aux_data} if aux_data else fields
        for name, F in self.forcing.items():
            G[name] = G[name] + R(name, F(grid, ffields, time))
        locs = {n: self.loc(n) for n in fields}
        for name in G:
            apply_flux_bcs(G[name], grid, self.loc(name), self.bcs[name],
                           time, fields=fields, locs=locs,
                           region=self._regions[name])
            ibc = self.bcs[name].immersed
            if self.immersed and ibc is not None:
                G[name] = G[name] + R(name, apply_immersed_flux_bcs(
                    torch.zeros_like(fields[name]), grid, self.loc(name),
                    ibc, time, c=fields[name],
                    kappa=immersed_diffusivity(self.closure, name)))
        for hook in self._tendency_hooks:
            G = hook(grid, fields, G, float(time))
        return G, aux

    def _implicit_step(self, fields, aux, dtt):
        """The closure's vertically implicit diffusion solve, per field."""
        if self.closure is None:
            return fields
        kappas = self.closure.vertical_implicit_kappas(self.grid, fields, aux)
        if not kappas:
            return fields
        # CATKE, run here as an ordinary tracer closure, damps e implicitly
        # and floors it
        dampings = {}
        if hasattr(self.closure, "vertical_implicit_damping"):
            dampings = self.closure.vertical_implicit_damping(
                self.grid, fields, aux)
        out = dict(fields)
        for name, kz in kappas.items():
            if name == "w":
                if not self.grid.is_flat(2):
                    out[name] = implicit_vertical_diffusion_w(
                        self.grid, fields[name], kz, dtt)
            else:
                out[name] = implicit_vertical_diffusion(
                    self.grid, fields[name], kz, dtt,
                    damping=dampings.get(name))
        if hasattr(self.closure, "clip_fields"):
            out = self.closure.clip_fields(out)
        return out

    def _update(self, fields, coefficients, dt):
        """New padded tensors q + Δt·Σ cᵢGᵢ over the update regions, for
        ``coefficients`` [(cᵢ, Gᵢ)]; the closure state is carried."""
        new = {}
        for name, q in fields.items():
            if name in self._closure_state:
                new[name] = q
                continue
            inc = None
            for coef, Gi in coefficients:
                term = coef * Gi[name]
                inc = term if inc is None else inc + term
            ints = self._regions[name]
            new[name] = q.clone()
            new[name][ints] = q[ints] + float(dt) * inc
        if self._z_compact:
            # w's bottom boundary face (the padded layout's fill pins it)
            new["w"][..., 0] = 0
        return new

    def _advance_closure_state(self, fields, dt, iteration, time):
        if self._closure_state:
            self._fill_all(fields, time)
            fields.update(self.closure.update_state_fields(
                self.grid, fields, dt, iteration))
        return fields

    # -- hooks ----------------------------------------------------------------

    def add_tendency_hook(self, fn):
        """Register ``fn(grid, fields, G, time) -> G``, called on the
        tendencies (``G`` interior-shaped, ``fields`` padded) after the
        boundary fluxes of every stage. The tendencies then have to exist:
        the model leaves the fused update route for the tendency route, as
        the JAX model does. On a device mesh every shard calls it on its
        own blocks and grid."""
        for m in self._shards or ():
            m.add_tendency_hook(fn)
        self._tendency_hooks.append(fn)
        self._fused_update = False
        self.fuse_correction = False
        return fn

    def add_state_hook(self, fn):
        """Register ``fn(grid, fields, time) -> {name: padded tensor}``,
        whose updates replace fields at the end of every step (on a device
        mesh, every shard's, on its own blocks and grid)."""
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

    def _step_particles(self, fields, dt):
        """Advect and track the particles with the step's final fields. The
        projection corrected the velocities' halos; a tracked tracer's
        still hold the values of the last stage's start, so it is filled
        first."""
        if self.particles is not None:
            tracked = [n for n in self.particles.tracked_fields
                       if n in fields and n not in ("u", "v", "w")]
            if tracked:
                self._fill_all({n: fields[n] for n in tracked},
                               self.state["clock"]["time"])
            self.state["particles"] = self.particles.step(
                self.grid, fields, self.state["particles"], dt)

    def time_step(self, dt):
        """Advance the model state by one Δt (on a device mesh, every
        shard's blocks, in the shards' threads; the auxiliary fields as they
        are now are scattered first)."""
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
        if self._fused_update:
            self._step_compact(dt)
        elif isinstance(self.timestepper, QuasiAdamsBashforth2TimeStepper):
            self._step_ab2(dt)
        else:
            self._step_tendencies(dt)
        self._run_state_hooks()
        if self.biogeochemistry is not None:
            self.biogeochemistry.update_state(self)
        return self

    def _step_tendencies(self, dt):
        nt = self._nt
        dt = nt(dt)
        fields = dict(self.state["fields"])
        clock = self.state["clock"]
        time = clock["time"]
        Gm = None
        for gamma, zeta in zip(RK3_GAMMAS, RK3_ZETAS):
            stage_dt = nt(gamma + zeta) * dt
            self._fill_all(fields, time, stage_dt)
            G, aux = self._tendencies(fields, time)
            coefficients = [(gamma, G)] + ([(zeta, Gm)] if zeta != 0.0
                                           else [])
            new = self._update(fields, coefficients, dt)
            new = self._implicit_step(new, aux, stage_dt)
            u, v, w, p = self._project(new["u"], new["v"], new["w"], stage_dt,
                                       time)
            new.update(u=u, v=v, w=w)
            fields = new
            Gm = G
            time = time + stage_dt
        fields = self._advance_closure_state(fields, dt, clock["iteration"],
                                             time)
        self.state = dict(self.state, fields=fields, pressure=p,
                          clock=dict(time=time,
                                     iteration=clock["iteration"] + 1,
                                     last_dt=dt))
        self._step_particles(fields, dt)
        return self

    def _step_ab2(self, dt):
        """Quasi-AB2: Euler (χ = -1/2) on the first step and when Δt
        changes."""
        nt = self._nt
        dt = nt(dt)
        fields = dict(self.state["fields"])
        clock = self.state["clock"]
        euler = clock["iteration"] == 0 or clock["last_dt"] != dt
        a, b, keep = self.timestepper.coefficients(euler)
        self._fill_all(fields, clock["time"], dt)
        G, aux = self._tendencies(fields, clock["time"])
        Gm = {n: g * keep for n, g in self.state["Gm"].items()}
        new = self._update(fields, [(a, G), (-b, Gm)], dt)
        new = self._implicit_step(new, aux, dt)
        u, v, w, p = self._project(new["u"], new["v"], new["w"], dt,
                                   clock["time"])
        new.update(u=u, v=v, w=w)
        new = self._advance_closure_state(new, dt, clock["iteration"],
                                          clock["time"])
        self.state = dict(self.state, fields=new, pressure=p, Gm=G,
                          clock=dict(time=clock["time"] + dt,
                                     iteration=clock["iteration"] + 1,
                                     last_dt=dt))
        self._step_particles(new, dt)
        return self

    def _step_compact(self, dt):
        nt = self._nt
        dt = nt(dt)
        fields = self.state["fields"]
        clock = self.state["clock"]
        time = clock["time"]
        p = self.state["pressure"]
        Gm = None
        pend = None          # (padded p, stage Δt) awaiting correction
        for m, (gamma, zeta) in enumerate(zip(RK3_GAMMAS, RK3_ZETAS)):
            stage_dt = nt(gamma + zeta) * dt
            kw = {} if pend is None else dict(p=pend[0], corr_dt=pend[1])
            Gm, new = fused_advection_update(
                self.grid, self.advection, fields["u"], fields["v"],
                fields["w"], Gm, nt(gamma) * dt, nt(zeta) * dt, **kw,
                tracers={n: fields[n] for n in self.tracer_names})
            if self.fuse_correction and m < 2:
                rhs = fused_divergence(self.grid, new["u"], new["v"],
                                       new["w"], nt(1.0) / stage_dt)
                p = self._solve_padded(rhs)
                pend = (p, stage_dt)
            else:
                u, v, w, p = self._project(new["u"], new["v"], new["w"],
                                           stage_dt, time, halos_valid=True)
                new.update(u=u, v=v, w=w)
                pend = None
            fields = new
            time = time + stage_dt
        self.state = dict(self.state, fields=fields, pressure=p,
                          clock=dict(time=time,
                                     iteration=clock["iteration"] + 1,
                                     last_dt=dt))
        return self

    def __repr__(self):
        return (f"NonhydrostaticModel(grid={self.grid!r}, "
                f"advection={self.advection!r}, tracers={self.tracer_names}, "
                f"closure={self.closure!r}, "
                f"timestepper={self.timestepper.name})")


def _padded_gradient(out, p, axis, delta):
    """δp/Δ at the faces below the cells along ``axis`` over the whole
    padded tensor, into ``out``: out[i] = (p[i] - p[i-1]) / Δ[i], and out[0]
    = p[0] / Δ[0] (the shift's zero fill), as ``operators.ddx`` forms it,
    rounded the same way."""
    n = p.shape[axis]
    lo, hi, inner = (p.narrow(axis, 0, n - 1), p.narrow(axis, 1, n - 1),
                     out.narrow(axis, 1, n - 1))
    if p.requires_grad and torch.is_grad_enabled():
        inner.copy_(hi - lo)   # autograd takes no out=
    else:
        torch.sub(hi, lo, out=inner)
    out.narrow(axis, 0, 1).copy_(p.narrow(axis, 0, 1))
    return out.div_(delta if isinstance(delta, (int, float))
                    else torch.as_tensor(delta, dtype=p.dtype,
                                         device=p.device))


def auxiliary_data(grid, fields):
    """{name: padded tensor} of a model's auxiliary fields on its grid (a
    field made before the model widened the halos is placed anew)."""
    return {n: (f.data if tuple(f.data.shape) == tuple(grid.padded_shape)
                else set_on_padded(grid, f.loc, f.interior))
            for n, f in fields.items()}


def _vertical_spacings(grid):
    """Interior Δz at the centres (n,) and at the faces (n + 1,), numpy; the
    top face n lies in the first halo slot."""
    h, n = grid.H[2], grid.N[2]
    npad = grid.padded_shape[2]
    dzc = np.broadcast_to(np.asarray(numpy_metric(grid, "dz", LOC_CCC))
                          .reshape(-1), (npad,))[h:h + n]
    dzf_all = np.broadcast_to(np.asarray(numpy_metric(grid, "dz", LOC_CCF))
                              .reshape(-1), (npad,))
    dzf = np.empty(n + 1)
    dzf[:n] = dzf_all[h:h + n]
    dzf[n] = dzf_all[h + n] if h + n < npad else dzf_all[-1]
    return dzc, dzf


def _set_interior(grid, q, sol):
    out = q.clone()
    out[grid.interior_slices] = sol
    return out


def implicit_vertical_diffusion(grid, q, kappa, dtt, damping=None):
    """Solve (1 + Δt λ - Δt ∂z κ ∂z) q′ = q on the cell-centred z levels
    with no-flux walls; returns a new padded tensor. ``kappa`` is a scalar
    or a padded (c, c, f) tensor (κ on the face below each cell), ``damping``
    an optional rate λ at the cell centres (a scalar or a padded tensor).
    The operator drops the boundary faces' fluxes: Value and Flux conditions
    enter explicitly (``vitd_explicit_z_term``, the boundary fluxes)."""
    if grid.topology[2] == PERIODIC:
        raise ValueError("the vertically implicit diffusion solve assumes "
                         "walls; it cannot be used on a z-periodic grid")
    h, n = grid.H[2], grid.N[2]
    dzc, dzf = _vertical_spacings(grid)
    inv_lo = np.zeros(n)            # couples q[k-1] through face k
    inv_up = np.zeros(n)            # couples q[k+1] through face k+1
    inv_lo[1:] = 1.0 / (dzc[1:] * dzf[1:n])
    inv_up[:-1] = 1.0 / (dzc[:-1] * dzf[1:n])
    kw = dict(dtype=q.dtype, device=q.device)
    dt_c = torch.tensor(float(dtt), **kw)
    if isinstance(kappa, torch.Tensor) and kappa.ndim == 3:
        sx, sy, _ = grid.interior_slices
        kfaces = kappa[sx, sy, h:h + n + 1].to(q.dtype)
        lo = -dt_c * torch.as_tensor(inv_lo, **kw) * kfaces[..., :n]
        up = -dt_c * torch.as_tensor(inv_up, **kw) * kfaces[..., 1:n + 1]
    else:
        lo = -dt_c * torch.as_tensor(float(kappa) * inv_lo, **kw)
        up = -dt_c * torch.as_tensor(float(kappa) * inv_up, **kw)
    diag = 1.0 - lo - up
    if damping is not None:
        lam = (damping[grid.interior_slices]
               if isinstance(damping, torch.Tensor) and damping.ndim == 3
               else damping)
        diag = diag + float(dtt) * lam
    sol = solve_batched_tridiagonal(lo, diag, up, q[grid.interior_slices])
    return _set_interior(grid, q, sol)


def implicit_vertical_diffusion_w(grid, w, nu, dtt):
    """Solve (1 - Δt ∂z ν ∂z) w′ = w for the face-located vertical velocity
    with w = 0 on both boundary faces; returns a new padded tensor. Stored
    faces are k = 0 … n-1 (face 0, the bottom wall, passes through; the lid
    face n is 0). ``nu`` is a scalar or a padded tensor read at the cell
    centres (ν in the cell above face k), as in the JAX package."""
    h, n = grid.H[2], grid.N[2]
    dzc, dzf = _vertical_spacings(grid)
    # face k couples w[k-1] through cell k-1 and w[k+1] through cell k
    inv_lo = np.zeros(n)
    inv_up = np.zeros(n)
    inv_lo[1:] = 1.0 / (dzc[:-1] * dzf[1:n])
    inv_up[1:] = 1.0 / (dzc[1:] * dzf[1:n])
    kw = dict(dtype=w.dtype, device=w.device)
    dt_c = torch.tensor(float(dtt), **kw)
    if isinstance(nu, torch.Tensor) and nu.ndim == 3:
        sx, sy, _ = grid.interior_slices
        nc = nu[sx, sy, h:h + n].to(w.dtype)
        lo_t = -dt_c * torch.as_tensor(inv_lo, **kw) * torch.cat(
            [torch.zeros_like(nc[..., :1]), nc[..., :-1]], dim=-1)
        up_t = -dt_c * torch.as_tensor(inv_up, **kw) * nc
    else:
        lo_t = -dt_c * torch.as_tensor(float(nu) * inv_lo, **kw)
        up_t = -dt_c * torch.as_tensor(float(nu) * inv_up, **kw)
    # Dirichlet walls: the couplings to the pinned faces stay in the
    # diagonal and drop out of the off-diagonals; row 0 is the identity
    diag = 1.0 - lo_t - up_t
    lo, up, diag = lo_t.clone(), up_t.clone(), diag.clone()
    lo[..., 1] = 0.0
    up[..., n - 1] = 0.0
    diag[..., 0] = 1.0
    lo[..., 0] = 0.0
    up[..., 0] = 0.0
    sol = solve_batched_tridiagonal(lo, diag, up, w[grid.interior_slices])
    return _set_interior(grid, w, sol)


def _shifted(slices, axis, s):
    out = list(slices)
    out[axis] = slice(slices[axis].start + s, slices[axis].stop + s)
    return tuple(out)


def _metric_at(grid, m, slices):
    """A metric (a Python scalar or a padded-broadcastable tensor) at the
    padded ``slices``."""
    if not isinstance(m, torch.Tensor) or m.ndim == 0:
        return m
    return m.broadcast_to(grid.padded_shape)[slices]


def _interior_divergence(grid, u, v, w):
    """divᶜᶜᶜ(u, v, w) = V⁻¹[δxᶜ(Ax u) + δyᶜ(Ay v) + δzᶜ(Az w)] on the
    interior of padded tensors with filled halos; a flat axis adds no
    term."""
    ints = grid.interior_slices
    total = None
    for axis, (a, A) in enumerate(((u, grid.Ax(LOC_FCC)),
                                   (v, grid.Ay(LOC_CFC)),
                                   (w, grid.Az(LOC_CCF)))):
        if grid.is_flat(axis):
            continue
        up = _shifted(ints, axis, 1)
        term = (_metric_at(grid, A, up) * a[up]
                - _metric_at(grid, A, ints) * a[ints])
        total = term if total is None else total + term
    return total / _metric_at(grid, grid.V(LOC_CCC), ints)


def padded_from_jax(grid, arr):
    """A padded tensor of ``grid`` (halos zero) holding the interior of a
    numpy array padded in another layout; the halo widths are read off the
    array's shape."""
    arr = np.asarray(arr)
    N = grid.N
    sl = []
    for axis in range(3):
        extra = arr.shape[axis] - N[axis]
        if extra < 0 or extra % 2:
            raise ValueError(f"array of shape {arr.shape} is not a padded "
                             f"layout of interior {N}")
        h = extra // 2
        sl.append(slice(h, h + N[axis]))
    kw = dict(dtype=grid.dtype, device=grid.device)
    out = torch.zeros(grid.padded_shape, **kw)
    out[grid.interior_slices] = torch.as_tensor(
        np.ascontiguousarray(arr[tuple(sl)]), **kw)
    return out


def _region_from_jax(grid, arr, region):
    """The padded ``region`` (slices of ``grid``'s layout) of a numpy array
    padded in another layout, as a tensor of the grid's dtype and device."""
    arr = np.asarray(arr)
    sl = []
    for axis in range(3):
        h = (arr.shape[axis] - grid.N[axis]) // 2 - grid.H[axis]
        sl.append(slice(region[axis].start + h, region[axis].stop + h))
    return torch.as_tensor(np.ascontiguousarray(arr[tuple(sl)]),
                           dtype=grid.dtype, device=grid.device)


def state_from_jax(jax_state_numpy, model):
    """Load a JAX model's state into ``model``.

    ``jax_state_numpy`` is the JAX ``NonhydrostaticModel.state`` with its
    arrays converted to numpy: ``fields`` (u, v, w, the tracers and the
    closure's state fields), ``pressure``, ``clock`` and, for quasi-AB2,
    ``Gm``. The JAX arrays may use another halo layout; their halo widths
    are read off their shapes, the interiors are written into the port's
    padded tensors, and the halos are refilled. A JAX sharded model's
    gathered state goes into a sharded port model the same way: the global
    tensors are filled on the global grid and scattered into the shards'
    blocks."""
    grid = model.grid
    arrays = jax_state_numpy["fields"]
    names = model.prognostic_names + model._closure_state
    fields = {n: padded_from_jax(grid, arrays[n]) for n in names}
    pressure = padded_from_jax(grid, jax_state_numpy["pressure"])
    model._fill_all({**fields, "p": pressure}, jax_state_numpy["clock"][
        "time"])
    regions = getattr(model, "_regions", {})
    for n, region in regions.items():
        if region != grid.interior_slices or any(
                bc is not None and bc.classification == OPEN
                for bc in (model.bcs[n].pair(a)[0] for a in range(3))):
            # the boundary faces the JAX state carries (a PA face, or a
            # face the fill does not pin): copied after the fill, which
            # would pin them
            fields[n][region] = _region_from_jax(grid, arrays[n], region)
    jc = jax_state_numpy["clock"]
    nt = model._nt
    state = dict(fields=fields, pressure=pressure,
                 clock=dict(time=nt(jc["time"]),
                            iteration=int(jc["iteration"]),
                            last_dt=nt(jc["last_dt"])))
    if isinstance(model.timestepper, QuasiAdamsBashforth2TimeStepper):
        state["Gm"] = {n: _region_from_jax(
            grid, jax_state_numpy["Gm"][n],
            regions.get(n, grid.interior_slices)).clone()
            for n in model.prognostic_names}
    model.state = state
    return model
