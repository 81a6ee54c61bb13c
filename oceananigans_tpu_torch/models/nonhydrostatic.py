"""NonhydrostaticModel: incompressible LES/DNS with a 3D pressure projection.

Counterpart of ``oceananigans_tpu/models/nonhydrostatic.py``, cut to the
flagship configuration: a regular RectilinearGrid, periodic x and y, bounded
z, flux-form advection only (no tracers, buoyancy, Coriolis, closure or
forcing), RK3, and the FFT/DCT pressure projection. Anything else raises
``NotImplementedError`` naming its ROADMAP item.

Layout: the z-compact layout at any Nz (no z halo; the z boundary conditions
live inside the stencil reads) and ``Hx = Hy = required_halo + 1`` (one ring
beyond the advection stencil for the deferred correction).

Each RK3 stage runs the fused advection + stage-update kernel, the
divergence kernel, the FFT/DCT solve (``torch.fft`` and a ``torch.matmul``
DCT), and the halo-fill kernel on the new pressure. With ``fuse_correction``
(the default, as in the JAX package) stages 1 and 2 only solve for p, and the
next stage's update kernel applies the correction while it reads the
velocities; stage 3 projects with the correction kernel. Without it every
stage projects with the correction kernel.

The model updates its state tensors in place where the JAX package returned
new arrays: the halo fills write into the padded tensors they are given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..advection import Centered
from ..advection.schemes import adapt_advection_order
from ..boundary_conditions import (fill_all_halo_regions,
                                   regularize_field_boundary_conditions)
from ..defaults import numpy_dtype
from ..fields import Field, set_on_padded
from ..grids.topology import (BOUNDED, LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC,
                              PERIODIC)
from ..kernels import (fused_advection_update, fused_correct,
                       fused_divergence, periodic_halo_fill)
from ..solvers.fft_poisson import FFTPoissonSolver
from ..timesteppers import RK3_GAMMAS, RK3_ZETAS, RungeKutta3TimeStepper

PROGNOSTIC_LOCS = {"u": LOC_FCC, "v": LOC_CFC, "w": LOC_CCF}

_NOT_PORTED = {
    "tracers": "ROADMAP.md queue 1 item 8 (tracers and buoyancy)",
    "buoyancy": "ROADMAP.md queue 1 item 8 (tracers and buoyancy)",
    "closure": "ROADMAP.md queue 1 item 8 (closures)",
    "coriolis": "ROADMAP.md queue 1 item 9 (the rest of NH physics)",
    "forcing": "ROADMAP.md queue 1 item 9 (the rest of NH physics)",
    "stokes_drift": "ROADMAP.md queue 1 item 9 (the rest of NH physics)",
    "background_fields": "ROADMAP.md queue 1 item 9 (the rest of NH physics)",
    "pressure_solver": "ROADMAP.md queue 1 item 11 (other Poisson solvers)",
    "biogeochemistry": "ROADMAP.md queue 1 item 15 (the long tail)",
    "particles": "ROADMAP.md queue 1 item 15 (the long tail)",
    "auxiliary_fields": "ROADMAP.md queue 1 item 15 (the long tail)",
}


class NonhydrostaticModel:
    def __init__(self, grid, advection=None, tracers=(), buoyancy=None,
                 coriolis=None, closure=None, forcing=None,
                 boundary_conditions=None, timestepper="RungeKutta3",
                 pressure_solver=None, background_fields=None,
                 stokes_drift=None, biogeochemistry=None, particles=None,
                 auxiliary_fields=None, fuse_correction=True, device=None,
                 dtype=None):
        given = dict(tracers=tracers, buoyancy=buoyancy, closure=closure,
                     coriolis=coriolis, forcing=forcing,
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
        if device is not None or dtype is not None:
            grid = grid.to(device=device, dtype=dtype)
        self.timestepper = RungeKutta3TimeStepper()
        self.tracer_names = ()
        self.fuse_correction = bool(fuse_correction)

        if advection is None:
            advection = Centered(order=2)
        advection = adapt_advection_order(advection, grid)
        self.advection = advection
        required = advection.required_halo
        # one spare ring in x and y for the deferred correction; no z halo
        halo = (max(grid.H[0], required + 1), max(grid.H[1], required + 1), 0)
        self.grid = grid.with_halo(halo)
        if self.grid.N[0] < halo[0] or self.grid.N[1] < halo[1]:
            raise ValueError("the periodic halos need Nx >= Hx and Ny >= Hy")

        bcs_in = dict(boundary_conditions or {})
        unknown = set(bcs_in) - set(PROGNOSTIC_LOCS)
        if unknown:
            raise ValueError(f"boundary conditions for unknown fields {unknown}")
        self.bcs = {name: regularize_field_boundary_conditions(
            bcs_in.get(name), self.grid, loc)
            for name, loc in PROGNOSTIC_LOCS.items()}
        self.bcs["p"] = regularize_field_boundary_conditions(
            None, self.grid, LOC_CCC)
        self.pressure_solver = FFTPoissonSolver(self.grid)

        nt = numpy_dtype(self.grid.dtype)
        self._nt = nt
        zeros = lambda: torch.zeros(self.grid.padded_shape,
                                    dtype=self.grid.dtype,
                                    device=self.grid.device)
        self.state = dict(
            fields={n: zeros() for n in self.prognostic_names},
            pressure=zeros(),
            clock=dict(time=nt(0), iteration=0, last_dt=nt(np.inf)))

    # -- basic properties -----------------------------------------------------

    @property
    def prognostic_names(self):
        return ("u", "v", "w")

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

    # -- setting initial conditions -------------------------------------------

    def set(self, enforce_incompressibility=True, **values):
        """Set prognostic fields from scalars/arrays/functions, then project
        the velocities onto their divergence-free part."""
        fields = dict(self.state["fields"])
        for name, value in values.items():
            if name not in fields:
                raise ValueError(f"unknown prognostic field {name!r}")
            fields[name] = set_on_padded(self.grid, self.loc(name), value)
        fill_all_halo_regions([fields[name] for name in values], self.grid)
        if enforce_incompressibility and any(k in values for k in "uvw"):
            u, v, w, _ = self._project(fields["u"], fields["v"], fields["w"],
                                       self._nt(1.0))
            fields.update(u=u, v=v, w=w)
        self.state = {**self.state, "fields": fields}

    # -- step -------------------------------------------------------------------

    def _solve_padded(self, rhs):
        """Solve ∇²p = rhs and return p padded, with periodic halos filled by
        the halo-fill kernel."""
        p_int = self.pressure_solver.solve(rhs)
        p = torch.empty(self.grid.padded_shape, dtype=rhs.dtype,
                        device=rhs.device)
        p[self.grid.interior_slices] = p_int
        periodic_halo_fill(self.grid, [p])
        return p

    def _project(self, u, v, w, dtt):
        """Pressure projection of velocities with valid halos: divergence
        kernel, solve, correction kernel."""
        rhs = fused_divergence(self.grid, u, v, w, self._nt(1.0) / dtt)
        p = self._solve_padded(rhs)
        u, v, w = fused_correct(self.grid, p, u, v, w, dtt)
        return u, v, w, p

    def time_step(self, dt):
        """Advance the model state by one Δt with RK3."""
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
                fields["w"], Gm, nt(gamma) * dt, nt(zeta) * dt, **kw)
            if self.fuse_correction and m < 2:
                rhs = fused_divergence(self.grid, new["u"], new["v"],
                                       new["w"], nt(1.0) / stage_dt)
                p = self._solve_padded(rhs)
                pend = (p, stage_dt)
            else:
                u, v, w, p = self._project(new["u"], new["v"], new["w"],
                                           stage_dt)
                new = dict(u=u, v=v, w=w)
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
                f"advection={self.advection!r}, "
                f"timestepper={self.timestepper.name})")


def state_from_jax(jax_state_numpy, model):
    """Load a JAX model's state into ``model``.

    ``jax_state_numpy`` is the JAX ``NonhydrostaticModel.state`` with its
    arrays converted to numpy: ``fields`` (u, v, w), ``pressure`` and
    ``clock``. The JAX arrays may use another halo layout; their halo widths
    are read off their shapes, the interiors are written into the port's
    padded tensors, and the halos are refilled."""
    grid = model.grid
    N = grid.N
    kw = dict(dtype=grid.dtype, device=grid.device)

    def interior_of(arr):
        arr = np.asarray(arr)
        sl = []
        for axis in range(3):
            extra = arr.shape[axis] - N[axis]
            if extra < 0 or extra % 2:
                raise ValueError(f"array of shape {arr.shape} is not a padded "
                                 f"layout of interior {N}")
            h = extra // 2
            sl.append(slice(h, h + N[axis]))
        return torch.as_tensor(np.ascontiguousarray(arr[tuple(sl)]), **kw)

    def padded(arr):
        out = torch.zeros(grid.padded_shape, **kw)
        out[grid.interior_slices] = interior_of(arr)
        return out

    fields = {n: padded(jax_state_numpy["fields"][n])
              for n in model.prognostic_names}
    pressure = padded(jax_state_numpy["pressure"])
    fill_all_halo_regions(list(fields.values()) + [pressure], grid)
    jc = jax_state_numpy["clock"]
    nt = model._nt
    model.state = dict(fields=fields, pressure=pressure,
                       clock=dict(time=nt(jc["time"]),
                                  iteration=int(jc["iteration"]),
                                  last_dt=nt(jc["last_dt"])))
    return model
