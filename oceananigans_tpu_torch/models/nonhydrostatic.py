"""NonhydrostaticModel: incompressible LES/DNS with a 3D pressure projection.

Counterpart of ``oceananigans_tpu/models/nonhydrostatic.py`` on a regular
RectilinearGrid with periodic x and y and a bounded z: flux-form advection,
tracers, ``BuoyancyTracer``, an explicit constant ``ScalarDiffusivity``,
scalar Value/Gradient/Flux conditions on the z sides, RK3 and the FFT/DCT
pressure projection. Coriolis, forcing, other closures and timesteppers
raise ``NotImplementedError`` naming their ROADMAP item.

The layout and the step follow the JAX package's choice (its ``__init__``
and ``_build_step``, without the TPU's Nz % 128 gate, Hy-to-8 rounding, lane
tail and tile picks):

- **z-compact** when there is no closure and no user z boundary condition:
  no z halo (the z boundary conditions live inside the stencil reads) and
  ``Hx = Hy = required_halo + 1`` (one ring for the deferred correction).
  Without buoyancy and without a mesh, advection is the only tendency, and
  each RK3 stage runs the fused advection + stage-update kernel over u, v, w
  and the tracers, the divergence kernel, the FFT/DCT solve and the
  halo-fill kernel on the new pressure. With ``fuse_correction`` (the
  default, as in the JAX package) stages 1 and 2 only solve for p, and the
  next stage's update kernel applies the correction while it reads the
  velocities (the tracers are advected by the corrected velocities); stage
  3 projects with the correction kernel. With buoyancy, or under a mesh,
  each stage takes the tendency route below on this layout: the wrap of all
  fields, the z-compact tendency kernel, buoyancy, the update, w's bottom
  face pinned to 0, and the projection by the divergence kernel, the solve
  and the correction kernel.
- **padded** otherwise: every halo ``H = max(grid.H, required_halo)``, z
  included. Each RK3 stage fills all halos (one periodic-wrap launch and one
  bounded-z launch for all fields), computes the advective tendencies of
  u, v, w and the tracers with the tendency kernel, adds buoyancy, closure
  and boundary fluxes in PyTorch, updates, and projects: fill u, v, w, a
  plain PyTorch divergence, the solve, the pressure fill, a plain PyTorch
  correction (the JAX package computes these in XLA too).

With ``architecture=Distributed(...)`` the state stays global-view on the
mesh's first device (the grid's device) and the advective tendencies come
from the sharded tendency kernel (``build_sharded_fused_advection``:
per-shard blocks with the full padded z, their x/y halos exchanged, one
launch of the tendency kernel per shard, in the grid's layout); everything
else in the step runs on the global view exactly as in the serial tendency
route, so the sharded model equals the serial one with that route.

The model updates tensors in place where the JAX package returned new
arrays: the halo fills write into the padded tensors they are given, and the
padded projection corrects the stage's new velocities in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..advection import Centered
from ..advection.schemes import adapt_advection_order
from ..boundary_conditions import (apply_flux_bcs, fill_all_halo_regions,
                                   regularize_field_boundary_conditions)
from ..boundary_conditions.boundary_condition import default_bcs
from ..buoyancy import BuoyancyTracer
from ..closures import ScalarDiffusivity
from ..defaults import numpy_dtype
from ..fields import Field, set_on_padded
from ..grids.topology import (BOUNDED, LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC,
                              PERIODIC)
from ..kernels import (build_sharded_fused_advection,
                       fused_advection_tendency, fused_advection_update,
                       fused_correct, fused_divergence, periodic_halo_fill)
from ..parallel.distributed import regularize_architecture
from ..solvers.fft_poisson import FFTPoissonSolver
from ..timesteppers import RK3_GAMMAS, RK3_ZETAS, RungeKutta3TimeStepper

PROGNOSTIC_LOCS = {"u": LOC_FCC, "v": LOC_CFC, "w": LOC_CCF}

_NOT_PORTED = {
    "coriolis": "ROADMAP.md queue 1 item 9 (the rest of NH physics)",
    "forcing": "ROADMAP.md queue 1 item 9 (the rest of NH physics)",
    "stokes_drift": "ROADMAP.md queue 1 item 9 (the rest of NH physics)",
    "background_fields": "ROADMAP.md queue 1 item 9 (the rest of NH physics)",
    "pressure_solver": "ROADMAP.md queue 1 item 11 (other Poisson solvers)",
    "biogeochemistry": "ROADMAP.md queue 1 item 15 (the long tail)",
    "particles": "ROADMAP.md queue 1 item 15 (the long tail)",
    "auxiliary_fields": "ROADMAP.md queue 1 item 15 (the long tail)",
}

PHYSICS_ITEM = "ROADMAP.md queue 1 item 9 (the rest of NH physics)"


class NonhydrostaticModel:
    def __init__(self, grid, advection=None, tracers=(), buoyancy=None,
                 coriolis=None, closure=None, forcing=None,
                 boundary_conditions=None, timestepper="RungeKutta3",
                 pressure_solver=None, background_fields=None,
                 stokes_drift=None, biogeochemistry=None, particles=None,
                 auxiliary_fields=None, fuse_correction=True,
                 architecture=None, device=None, dtype=None):
        given = dict(coriolis=coriolis, forcing=forcing,
                     stokes_drift=stokes_drift,
                     background_fields=background_fields,
                     pressure_solver=pressure_solver,
                     biogeochemistry=biogeochemistry, particles=particles,
                     auxiliary_fields=auxiliary_fields)
        for name, value in given.items():
            if value:
                raise NotImplementedError(
                    f"{name} is not ported yet: {_NOT_PORTED[name]}")
        if timestepper not in ("RungeKutta3", "rk3") and not isinstance(
                timestepper, RungeKutta3TimeStepper):
            raise NotImplementedError(
                f"timestepper {timestepper!r} is not ported yet: ROADMAP.md "
                "queue 1 item 9 (quasi-AB2)")
        if not getattr(grid, "all_regular", False) or grid.topology != (
                PERIODIC, PERIODIC, BOUNDED):
            raise NotImplementedError(
                "the port's NonhydrostaticModel runs on a regular "
                "RectilinearGrid with periodic x/y and bounded z: ROADMAP.md "
                "queue 1 item 11 (other grids and topologies)")
        if buoyancy is not None and not isinstance(buoyancy, BuoyancyTracer):
            raise NotImplementedError(
                f"buoyancy {buoyancy!r}: only BuoyancyTracer is ported: "
                f"{PHYSICS_ITEM}")
        if closure is not None and not isinstance(closure, ScalarDiffusivity):
            raise NotImplementedError(
                f"closure {closure!r}: only ScalarDiffusivity is ported: "
                f"{PHYSICS_ITEM}")
        if device is not None or dtype is not None:
            grid = grid.to(device=device, dtype=dtype)
        self.architecture = regularize_architecture(architecture)
        if self.architecture is not None:
            self.architecture.place(grid)
        self.timestepper = RungeKutta3TimeStepper()
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        if buoyancy is not None:
            tracers += tuple(n for n in buoyancy.required_tracers
                             if n not in tracers)
        self.tracer_names = tracers
        self.buoyancy = buoyancy
        self.closure = closure

        bcs_in = dict(boundary_conditions or {})
        unknown = set(bcs_in) - set(PROGNOSTIC_LOCS) - set(tracers)
        if unknown:
            raise ValueError(f"boundary conditions for unknown fields {unknown}")
        user_zbcs = any(getattr(b, side, None) is not None
                        for b in bcs_in.values() for side in ("bottom", "top"))
        self._z_compact = closure is None and not user_zbcs
        # advection is the only tendency: the fused update route
        self._fused_update = (self._z_compact and buoyancy is None
                              and self.architecture is None)
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
            halo = tuple(max(h, required) for h in grid.H)
        self.grid = grid.with_halo(halo)
        if self.grid.N[0] < halo[0] or self.grid.N[1] < halo[1]:
            raise ValueError("the periodic halos need Nx >= Hx and Ny >= Hy")
        if self.grid.N[2] < halo[2] + 1:
            raise ValueError("the bounded-z halo fill needs Nz > Hz")

        self.bcs = {name: regularize_field_boundary_conditions(
            bcs_in.get(name), self.grid, self.loc(name))
            for name in self.prognostic_names}
        if self.bcs["w"] != default_bcs(self.grid, LOC_CCF):
            raise NotImplementedError(
                "boundary conditions on w are not ported yet: ROADMAP.md "
                "queue 1 item 3 (boundary_conditions/)")
        self.bcs["p"] = regularize_field_boundary_conditions(
            None, self.grid, LOC_CCC)
        self.pressure_solver = FFTPoissonSolver(self.grid)
        self._sharded_advection = None
        if self.architecture is not None:
            self._sharded_advection = build_sharded_fused_advection(
                self.grid, self.advection, self.architecture.mesh)

        nt = numpy_dtype(self.grid.dtype)
        self._nt = nt
        self.state = dict(
            fields={n: self._zeros() for n in self.prognostic_names},
            pressure=self._zeros(),
            clock=dict(time=nt(0), iteration=0, last_dt=nt(np.inf)))

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
        return float(self.state["clock"]["time"])

    @property
    def iteration(self):
        return int(self.state["clock"]["iteration"])

    def field(self, name):
        if name == "p":
            return Field(self.grid, LOC_CCC, self.bcs["p"],
                         self.state["pressure"], _regularize=False)
        return Field(self.grid, self.loc(name), self.bcs[name],
                     self.state["fields"][name], _regularize=False)

    def _zeros(self):
        return torch.zeros(self.grid.padded_shape, dtype=self.grid.dtype,
                           device=self.grid.device)

    def _fill_all(self, fields):
        """Fill the halos of ``fields`` ({name: padded tensor}) in place."""
        names = list(fields)
        fill_all_halo_regions(
            [fields[n] for n in names], self.grid,
            [(self.loc(n) if n != "p" else LOC_CCC, self.bcs[n])
             for n in names])
        return fields

    # -- setting initial conditions -------------------------------------------

    def set(self, enforce_incompressibility=True, **values):
        """Set prognostic fields from scalars/arrays/functions, then project
        the velocities onto their divergence-free part."""
        fields = dict(self.state["fields"])
        for name, value in values.items():
            if name not in fields:
                raise ValueError(f"unknown prognostic field {name!r}")
            fields[name] = set_on_padded(self.grid, self.loc(name), value)
        self._fill_all({name: fields[name] for name in values})
        if enforce_incompressibility and any(k in values for k in "uvw"):
            # the padded projection works in place: keep the old state's
            # tensors
            vel = [fields[c] if c in values or self._z_compact
                   else fields[c].clone() for c in "uvw"]
            u, v, w, _ = self._project(*vel, self._nt(1.0))
            fields.update(u=u, v=v, w=w)
        self.state = {**self.state, "fields": fields}

    # -- step -------------------------------------------------------------------

    def _solve_padded(self, rhs):
        """Solve ∇²p = rhs and return p padded, with its halos filled."""
        p_int = self.pressure_solver.solve(rhs)
        p = torch.empty(self.grid.padded_shape, dtype=rhs.dtype,
                        device=rhs.device)
        p[self.grid.interior_slices] = p_int
        if self._z_compact:
            periodic_halo_fill(self.grid, [p])
        else:
            self._fill_all({"p": p})
        return p

    def _project(self, u, v, w, dtt, halos_valid=False):
        """Pressure projection: the divergence and correction kernels in the
        z-compact layout (a fill of u, v, w first unless ``halos_valid``; new
        tensors out); in the padded layout a fill of u, v, w, the plain
        PyTorch divergence and correction (in place) around the solve."""
        if self._z_compact:
            if not halos_valid:
                self._fill_all(dict(u=u, v=v, w=w))
            rhs = fused_divergence(self.grid, u, v, w, self._nt(1.0) / dtt)
            p = self._solve_padded(rhs)
            u, v, w = fused_correct(self.grid, p, u, v, w, dtt)
            return u, v, w, p
        grid = self.grid
        self._fill_all(dict(u=u, v=v, w=w))
        dtt = float(dtt)
        rhs = _interior_divergence(grid, u, v, w) / dtt
        p = self._solve_padded(rhs)
        ints = grid.interior_slices
        pi = p[ints]
        for axis, (a, delta) in enumerate(((u, grid.dx), (v, grid.dy),
                                           (w, grid.dz))):
            loc = (LOC_FCC, LOC_CFC, LOC_CCF)[axis]
            grad = (pi - p[_shifted(ints, axis, -1)]) / delta(loc)
            a[ints] -= dtt * grad
        return u, v, w, p

    def _tendencies(self, fields):
        """The interior-shaped tendencies of every prognostic field:
        advection (the tendency kernel, sharded under a mesh), buoyancy,
        closure, boundary fluxes, in the JAX package's order."""
        grid = self.grid
        names = self.prognostic_names
        q = [fields[n] for n in names]
        Gall = (fused_advection_tendency(grid, self.advection, q)
                if self._sharded_advection is None
                else self._sharded_advection(q))
        G = dict(zip(names, Gall.unbind(0)))
        ints = grid.interior_slices
        if self.buoyancy is not None:
            G["w"] = G["w"] + self.buoyancy.z_buoyancy(grid, fields)[ints]
        if self.closure is not None:
            aux = self.closure.compute_diffusivities(grid, fields, None)
            mt = self.closure.momentum_tendencies(grid, fields, aux)
            for c in "uvw":
                G[c] = G[c] + mt[c][ints]
            for name in self.tracer_names:
                G[name] = G[name] + self.closure.tracer_tendency(
                    grid, name, fields, aux)[ints]
        for name in names:
            apply_flux_bcs(G[name], grid, self.loc(name), self.bcs[name])
        return G

    def time_step(self, dt):
        """Advance the model state by one Δt with RK3."""
        if self._fused_update:
            return self._step_compact(dt)
        return self._step_tendencies(dt)

    def _step_tendencies(self, dt):
        nt = self._nt
        dt = nt(dt)
        fields = dict(self.state["fields"])
        clock = self.state["clock"]
        time = clock["time"]
        ints = self.grid.interior_slices
        Gm = None
        for gamma, zeta in zip(RK3_GAMMAS, RK3_ZETAS):
            stage_dt = nt(gamma + zeta) * dt
            self._fill_all(fields)
            G = self._tendencies(fields)
            new = {}
            for name, q in fields.items():
                inc = gamma * G[name]
                if zeta != 0.0:
                    inc = inc + zeta * Gm[name]
                new[name] = q.clone()
                new[name][ints] = q[ints] + float(dt) * inc
            if self._z_compact:
                # w's bottom boundary face (the padded layout's fill pins it)
                new["w"][..., 0] = 0
            u, v, w, p = self._project(new["u"], new["v"], new["w"], stage_dt)
            new.update(u=u, v=v, w=w)
            fields = new
            Gm = G
            time = time + stage_dt
        self.state = dict(fields=fields, pressure=p,
                          clock=dict(time=time,
                                     iteration=clock["iteration"] + 1,
                                     last_dt=dt))
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
                                           stage_dt, halos_valid=True)
                new.update(u=u, v=v, w=w)
                pend = None
            fields = new
            time = time + stage_dt
        self.state = dict(fields=fields, pressure=p,
                          clock=dict(time=time,
                                     iteration=clock["iteration"] + 1,
                                     last_dt=dt))
        return self

    def __repr__(self):
        return (f"NonhydrostaticModel(grid={self.grid!r}, "
                f"advection={self.advection!r}, tracers={self.tracer_names}, "
                f"timestepper={self.timestepper.name})")


def _shifted(slices, axis, s):
    out = list(slices)
    out[axis] = slice(slices[axis].start + s, slices[axis].stop + s)
    return tuple(out)


def _interior_divergence(grid, u, v, w):
    """divᶜᶜᶜ(u, v, w) = V⁻¹[δxᶜ(Ax u) + δyᶜ(Ay v) + δzᶜ(Az w)] on the
    interior of padded tensors with filled halos."""
    ints = grid.interior_slices
    terms = [A * a[_shifted(ints, axis, 1)] - A * a[ints]
             for axis, (a, A) in enumerate(((u, grid.Ax(LOC_FCC)),
                                            (v, grid.Ay(LOC_CFC)),
                                            (w, grid.Az(LOC_CCF))))]
    return ((terms[0] + terms[1]) + terms[2]) / grid.V(LOC_CCC)


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


def state_from_jax(jax_state_numpy, model):
    """Load a JAX model's state into ``model``.

    ``jax_state_numpy`` is the JAX ``NonhydrostaticModel.state`` with its
    arrays converted to numpy: ``fields`` (u, v, w and the tracers),
    ``pressure`` and ``clock``. The JAX arrays may use another halo layout;
    their halo widths are read off their shapes, the interiors are written
    into the port's padded tensors, and the halos are refilled."""
    fields = {n: padded_from_jax(model.grid, jax_state_numpy["fields"][n])
              for n in model.prognostic_names}
    pressure = padded_from_jax(model.grid, jax_state_numpy["pressure"])
    model._fill_all({**fields, "p": pressure})
    jc = jax_state_numpy["clock"]
    nt = model._nt
    model.state = dict(fields=fields, pressure=pressure,
                       clock=dict(time=nt(jc["time"]),
                                  iteration=int(jc["iteration"]),
                                  last_dt=nt(jc["last_dt"])))
    return model
