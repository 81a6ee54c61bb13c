"""The free-function spellings of the grid, field and model methods.

Counterpart of ``oceananigans_tpu/api.py``: ``xnodes(grid, "c")``,
``interior(u)``, ``time_step(model, 60)``, ``run(sim)`` and the rest, so
that scripts written against the JAX package's flat namespace run on the
port. Pointwise metric queries (``xspacing`` .. ``volume``) take a location
tuple such as ("c", "c", "f").
"""

from __future__ import annotations

from .grids.topology import LOC_CCC

__all__ = [
    "nodes", "xnodes", "ynodes", "znodes", "rnodes", "lambda_nodes",
    "phi_nodes", "xspacings", "yspacings", "zspacings", "rspacings",
    "lambda_spacings", "phi_spacings", "lambda_spacing", "phi_spacing",
    "minimum_xspacing", "minimum_yspacing", "minimum_zspacing",
    "xspacing", "yspacing", "zspacing", "xarea", "yarea", "zarea", "volume",
    "interior", "compute", "set", "time_step", "run", "iteration",
    "iteration_limit_exceeded", "stop_time_exceeded",
    "wall_time_limit_exceeded",
]


def _grid_of(x):
    return getattr(x, "grid", x)


def _loc_of(x, default=LOC_CCC):
    return getattr(x, "loc", default)


# -- nodes ----------------------------------------------------------------------

def nodes(grid_or_field, loc=None):
    return _grid_of(grid_or_field).nodes(loc or _loc_of(grid_or_field))


def xnodes(grid_or_field, loc="c"):
    return _grid_of(grid_or_field).xnodes(loc)


def ynodes(grid_or_field, loc="c"):
    return _grid_of(grid_or_field).ynodes(loc)


def znodes(grid_or_field, loc="c"):
    return _grid_of(grid_or_field).znodes(loc)


# the grid's own vertical coordinate: z on the static grids
rnodes = znodes


def lambda_nodes(grid_or_field, loc="c"):
    return _grid_of(grid_or_field).lambda_nodes(loc)


def phi_nodes(grid_or_field, loc="c"):
    return _grid_of(grid_or_field).phi_nodes(loc)


# -- spacings -------------------------------------------------------------------

def xspacings(grid_or_field, loc=LOC_CCC):
    """The x spacing: a float on a regular axis, else a tensor."""
    return _grid_of(grid_or_field).dx(loc)


def yspacings(grid_or_field, loc=LOC_CCC):
    return _grid_of(grid_or_field).dy(loc)


def zspacings(grid_or_field, loc=LOC_CCC):
    return _grid_of(grid_or_field).dz(loc)


rspacings = zspacings


def lambda_spacings(grid_or_field, loc="c"):
    """The longitude spacings in degrees of a latitude-longitude grid."""
    return _grid_of(grid_or_field).lambda_spacings(loc)


def phi_spacings(grid_or_field, loc="c"):
    """The latitude spacings in degrees of a latitude-longitude grid."""
    return _grid_of(grid_or_field).phi_spacings(loc)


lambda_spacing = lambda_spacings
phi_spacing = phi_spacings


def minimum_xspacing(grid_or_field):
    return _grid_of(grid_or_field).minimum_xspacing()


def minimum_yspacing(grid_or_field):
    return _grid_of(grid_or_field).minimum_yspacing()


def minimum_zspacing(grid_or_field):
    return _grid_of(grid_or_field).minimum_zspacing()


# -- metrics at a location ------------------------------------------------------

def xspacing(grid, loc=LOC_CCC):
    return grid.dx(loc)


def yspacing(grid, loc=LOC_CCC):
    return grid.dy(loc)


def zspacing(grid, loc=LOC_CCC):
    return grid.dz(loc)


def xarea(grid, loc=LOC_CCC):
    return grid.Ax(loc)


def yarea(grid, loc=LOC_CCC):
    return grid.Ay(loc)


def zarea(grid, loc=LOC_CCC):
    return grid.Az(loc)


def volume(grid, loc=LOC_CCC):
    return grid.V(loc)


# -- fields and operations ------------------------------------------------------

def interior(field_or_op):
    return field_or_op.interior


def compute(op):
    """Evaluate an operation or a computed field."""
    return op.compute()


# -- drivers --------------------------------------------------------------------

def set(obj, *args, **kw):
    """``obj.set(...)`` of a model or a field."""
    return obj.set(*args, **kw)


def time_step(model, dt):
    """Advance ``model`` one step of ``dt``; returns the model."""
    model.time_step(dt)
    return model


def run(simulation, **kw):
    return simulation.run(**kw)


def iteration(model_or_sim):
    m = getattr(model_or_sim, "model", model_or_sim)
    return m.iteration


def iteration_limit_exceeded(sim):
    return (sim.stop_iteration is not None
            and sim.model.iteration >= sim.stop_iteration)


def stop_time_exceeded(sim):
    return sim.stop_time is not None and sim.model.time >= sim.stop_time


def wall_time_limit_exceeded(sim):
    return (sim.wall_time_limit is not None
            and sim.run_wall_time >= sim.wall_time_limit)
