"""Diagnostics: CFL numbers, the time-step wizard, the state checker.

Counterpart of ``oceananigans_tpu/simulation/diagnostics.py``. The advective
time scale is one device reduction (``cell_advection_timescale``); reading
it on the host is the one deliberate sync of the wizard, one scalar a call,
as in JAX. Where a model keeps w outside its prognostic fields (the
hydrostatic model's diagnosed w, ``state["w"]``) the CFL and the wizard read
it there; the JAX ones look for w among the fields only. On a model on a
device mesh each reduction runs on every shard's blocks and the shards
combine their results with the mesh's ``all_reduce`` (``over_shards``), so
that a diagnostic gathers nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..advection.fluxes import cell_advection_timescale


def _velocities(model):
    f = model.state["fields"]
    w = f["w"] if "w" in f else model.state["w"]
    return f["u"], f["v"], w


def over_shards(model, fn, op):
    """``fn(model)``, a number or a tensor; on a model on a device mesh,
    ``fn`` of every shard's model combined by the mesh's ``all_reduce``
    (``"min"``, ``"max"`` or ``"sum"``, in rank order)."""
    shards = getattr(model, "_shards", None)
    if not shards:
        return fn(model)
    comm = model.architecture.communicator

    def reduce(rank):
        v = fn(shards[rank])
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(v, dtype=torch.float64,
                             device=shards[rank].grid.device)
        return comm.all_reduce(rank, v, op)

    return comm.run(reduce)[0]


def _advective_timescale(model):
    return over_shards(model, lambda m: cell_advection_timescale(
        m.grid, *_velocities(m)), "min")


def _as_float(v):
    if isinstance(v, torch.Tensor):
        return float(v.max())
    return float(np.max(np.asarray(v)))


class AdvectiveCFL:
    def __init__(self, dt):
        self.dt = dt

    def __call__(self, model):
        # a Simulation works too (diagnostics are called with one)
        model = getattr(model, "model", model)
        tau = float(_advective_timescale(model))
        dt = self.dt(model) if callable(self.dt) else self.dt
        return float(dt / tau)


CFL = AdvectiveCFL


def _closure_max_nu(model, closure):
    """(max ν, power) pairs of one closure: power 2 for Laplacian, 4 for
    biharmonic diffusivities; a closure tuple gives its members'."""
    grid = model.grid
    if closure is None:
        return []
    if hasattr(closure, "closures"):
        out = []
        for c in closure.closures:
            out.extend(_closure_max_nu(model, c))
        return out
    power = 4 if type(closure).__name__ == "ScalarBiharmonicDiffusivity" \
        else 2

    def as_max(v):
        if callable(v) and not isinstance(v, torch.Tensor):
            if getattr(closure, "discrete_form", False):
                return None
            from ..closures.scalar_diffusivity import resolve_coefficient
            from ..grids.topology import LOC_CCC
            v = resolve_coefficient(grid, v, LOC_CCC, model.time)
            v = v[grid.interior_slices] if isinstance(v, torch.Tensor) else v
        if v is None or np.isscalar(v) and not np.isreal(v):
            return None
        return _as_float(v)

    vals = []
    nu = getattr(closure, "nu", None)
    m = as_max(nu) if nu is not None else None
    if m is not None:
        vals.append((m, power))
    kappa = getattr(closure, "kappa", None)
    for v in (kappa.values() if isinstance(kappa, dict)
              else () if kappa is None else (kappa,)):
        m = as_max(v)
        if m is not None:
            vals.append((m, power))
    if not vals:
        # closures with diagnosed diffusivities (Smagorinsky, AMD, CATKE,
        # k-ε, ...): the maxima of the current ones
        fields = dict(model.state["fields"])
        if "w" not in fields and "w" in model.state:
            fields["w"] = model.state["w"]
        aux = closure.compute_diffusivities(grid, fields,
                                            model.state["clock"]["time"])
        for key, v in aux.items():
            if key.startswith(("nu", "kappa")) and isinstance(v,
                                                             torch.Tensor):
                vals.append((float(v.max()), 2))
    return vals


def _closure_maxima(model, closure):
    """``_closure_max_nu`` of the model; on a device mesh each shard's
    maxima reduced over the shards."""
    shards = getattr(model, "_shards", None)
    if not shards:
        return _closure_max_nu(model, closure)
    pairs = {}

    def maxima(m):
        pairs[id(m)] = _closure_max_nu(m, closure)
        return torch.tensor([v for v, _ in pairs[id(m)]] or [0.0],
                            dtype=torch.float64)

    out = over_shards(model, maxima, "max")
    return [(float(v), p) for v, (_, p) in zip(out, pairs[id(shards[0])])]


def _minimum_spacing(grid):
    return min(grid.minimum_spacing(i) for i in range(3)
               if not grid.is_flat(i))


class DiffusiveCFL:
    def __init__(self, dt):
        self.dt = dt

    def __call__(self, model):
        model = getattr(model, "model", model)
        dmin = _minimum_spacing(model.grid)
        dt = self.dt(model) if callable(self.dt) else self.dt
        # Δt over the least time scale of every closure component: d²/ν
        # (Laplacian) or d⁴/ν (biharmonic)
        cfl = 0.0
        for numax, power in _closure_maxima(model, model.closure):
            cfl = max(cfl, dt * numax / dmin ** power)
        return float(cfl)


class TimeStepWizard:
    """Adapt ``Simulation.dt`` to hold a target CFL number. Install with
    ``sim.add_callback(TimeStepWizard(cfl=0.7), IterationInterval(10))``."""

    def __init__(self, cfl=0.2, diffusive_cfl=np.inf, max_change=1.1,
                 min_change=0.5, max_dt=np.inf, min_dt=0.0):
        self.cfl = cfl
        self.diffusive_cfl = diffusive_cfl
        self.max_change = max_change
        self.min_change = min_change
        self.max_dt = max_dt
        self.min_dt = min_dt

    def new_dt(self, model, dt):
        tau = float(_advective_timescale(model))
        new = self.cfl * tau
        if self.diffusive_cfl is not None and model.closure is not None:
            # the closure's ν (its interior maximum for a function of the
            # coordinates, which the JAX wizard cannot read)
            nu = getattr(model.closure, "nu", 0.0)
            nu = 0.0 if nu is None else nu
            if callable(nu) and not isinstance(nu, torch.Tensor):
                from ..closures.scalar_diffusivity import resolve_coefficient
                from ..grids.topology import LOC_CCC
                grid = model.grid
                nu = resolve_coefficient(grid, nu, LOC_CCC,
                                         model.time)[grid.interior_slices]
            if not np.isscalar(nu):
                nu = _as_float(nu)
            if nu > 0:
                new = min(new, self.diffusive_cfl
                          * _minimum_spacing(model.grid) ** 2 / nu)
        new = min(new, self.max_change * dt)
        new = max(new, self.min_change * dt)
        return float(np.clip(new, self.min_dt, self.max_dt))

    def __call__(self, sim):
        sim.dt = self.new_dt(sim.model, sim.dt)


class StateChecker:
    """Print the min, max and mean of every prognostic field."""

    def __call__(self, sim):
        model = sim.model
        print(f"State check, iteration {model.iteration}, "
              f"time {model.time:.4g}:")
        for name in model.prognostic_names:
            fld = model.field(name)
            print(f"  {name:>4}: min {float(fld.min()):+.6e} "
                  f"max {float(fld.max()):+.6e} mean {float(fld.mean()):+.6e}")


def conjure_time_step_wizard(simulation, schedule=None, **wizard_kwargs):
    """Install a TimeStepWizard callback on the simulation."""
    from ..utils.schedules import IterationInterval
    wizard = TimeStepWizard(**wizard_kwargs)
    simulation.add_callback(wizard, schedule or IterationInterval(10),
                            name="time_step_wizard")
    return wizard
