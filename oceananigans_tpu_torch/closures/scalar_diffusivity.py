"""ScalarDiffusivity, ScalarBiharmonicDiffusivity and their relatives.

Counterpart of ``oceananigans_tpu/closures/scalar_diffusivity.py``: the
isotropic (full strain tensor), horizontal and vertical formulations with ν
and a per-tracer κ that are constants, padded cell-centred tensors,
continuous functions f(x, y, z, t) or discrete forms f(grid, fields, t[, p]);
the explicit or vertically implicit time discretization; the biharmonic and
horizontal-divergence families; closure tuples; ``FluxTapering`` and the
``viscosity`` / ``diffusivity`` accessors.

Closure protocol (consumed by the models), on padded tensors:

    compute_diffusivities(grid, fields, time)    -> aux (dict, or a list of
                                                    them for a tuple)
    momentum_tendencies(grid, fields, aux)       -> {u, v, w} contributions
    tracer_tendency(grid, name, fields, aux)     -> the tracer's contribution
    vertical_implicit_kappas(grid, fields, aux)  -> {name: κz} for the
        implicit vertical solve, {} when fully explicit

A continuous-form coefficient is called with the padded coordinates as
broadcastable tensors of the grid's dtype and device and the time as a
Python float, so it is written with torch operations (or plain arithmetic).
"""

from __future__ import annotations

import torch

from ..boundary_conditions import fill_halo_regions
from ..fields.field import as_padded, coordinates
from ..grids.topology import LOC_CCC
from ..operators.operators import ddx, ddy, div_xy_ccc, interp_to
from .diffusion_operators import (div_2nu_strain_u, div_2nu_strain_v,
                                  div_2nu_strain_w, div_kappa_grad,
                                  vitd_explicit_z_term)

ISO = "iso"
HORIZONTAL = "horizontal"
VERTICAL = "vertical"

def _varies(k):
    """A coefficient that is not a constant: a callable or a tensor."""
    return callable(k) or (isinstance(k, torch.Tensor) and k.ndim >= 1)


class _ClosureBase:
    # conditions on the closure's diagnostic diffusivities:
    # {"nu_e": FieldBoundaryConditions, "kappa_e": {tracer: ...}}, handed
    # over by the model from its ``boundary_conditions``
    diffusivity_boundary_conditions = None

    def _fill_diffusivity(self, grid, arr, key, tracer=None):
        """Fill the halos of a diffusivity (in place) when conditions were
        given for it; otherwise return it as computed."""
        bcs = self.diffusivity_boundary_conditions or {}
        spec = bcs.get(key)
        if isinstance(spec, dict):
            spec = spec.get(tracer)
        if spec is None:
            return arr
        return fill_halo_regions(arr, grid, LOC_CCC, spec)

    def _fp(self):
        raise NotImplementedError

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, o):
        return hasattr(o, "_fp") and self._fp() == o._fp()

    def compute_diffusivities(self, grid, fields, time):
        return {}

    def vertical_implicit_kappas(self, grid, fields, aux):
        return {}

    required_halo = 1

    # True for the always-implicit closures with a 3-D κ (CATKE, Ri-based,
    # convective adjustment)
    implicit_only_z = False


def validate_implicit_closure_z_bcs(closure, bcs):
    """Refuse Value or Gradient z conditions on fields that an
    always-implicit closure diffuses: its tridiagonal drops the boundary
    faces and no explicit remainder restores them. ``bcs``: the model's
    regularized {name: FieldBoundaryConditions}."""
    if closure is None:
        return
    members = getattr(closure, "closures", (closure,))
    if not any(getattr(c, "implicit_only_z", False) for c in members):
        return
    from ..boundary_conditions.boundary_condition import GRADIENT, VALUE
    for name, fb in bcs.items():
        if name in ("eta", "ph", "w"):
            continue
        for side in ("bottom", "top"):
            bc = getattr(fb, side, None)
            if bc is not None and bc.classification in (VALUE, GRADIENT):
                raise NotImplementedError(
                    f"{side} {bc.classification} boundary condition on "
                    f"{name!r} combined with an always-implicit closure: the "
                    f"implicit vertical solve assumes Flux z conditions")


def _kappa_for(kappa, name):
    if isinstance(kappa, dict):
        return kappa.get(name, 0.0)
    return kappa


def resolve_coefficient(grid, k, loc, time=0.0):
    """A coefficient as a scalar, a padded tensor, or a continuous-form
    callable ν(x, y, z, t) evaluated at ``loc`` into a padded tensor."""
    if callable(k) and not isinstance(k, torch.Tensor):
        return as_padded(grid, k(*coordinates(grid, loc), float(time)))
    return k


def time_discretization_str(td):
    """The name of a time discretization: a marker object or a string."""
    return getattr(td, "name", td)


class ExplicitTimeDiscretization:
    name = "explicit"


class VerticallyImplicitTimeDiscretization:
    name = "vertically_implicit"


_TD_MARKERS = (ExplicitTimeDiscretization,
               VerticallyImplicitTimeDiscretization)


def _td_first(args, time_discretization):
    if args and isinstance(args[0], _TD_MARKERS):
        return args[1:], args[0]
    return args, time_discretization


class ScalarDiffusivity(_ClosureBase):
    def __init__(self, *args, nu=0.0, kappa=0.0, formulation=ISO,
                 time_discretization="explicit", discrete_form=False,
                 loc=None, parameters=None):
        """``ScalarDiffusivity([time_discretization,] nu, kappa,
        formulation, time_discretization)``, positionally or by keyword.
        ``discrete_form=True``: ν and κ are ``f(grid, fields, time[, p])``
        returning a padded cell-centred tensor; ``parameters`` is passed as
        the trailing argument when given; ``loc`` is accepted for the JAX
        signature (whole-array coefficients are cell-centred)."""
        args, time_discretization = _td_first(args, time_discretization)
        if len(args) > 4:
            raise TypeError("too many positional arguments")
        nu, kappa, formulation, time_discretization = (
            tuple(args) + (nu, kappa, formulation,
                           time_discretization)[len(args):])
        self.nu = nu
        self.kappa = kappa
        self.discrete_form = bool(discrete_form)
        self.parameters = parameters
        self.formulation = formulation
        self.time_discretization = time_discretization_str(
            time_discretization)
        if formulation not in (ISO, HORIZONTAL, VERTICAL):
            raise ValueError(formulation)
        if self.time_discretization not in ("explicit",
                                            "vertically_implicit"):
            raise ValueError(f"time discretization {time_discretization!r}")

    @staticmethod
    def _coef_fp(k):
        # tensors are not hashable: a new tensor is a new configuration
        return id(k) if isinstance(k, torch.Tensor) else k

    def _fp(self):
        if isinstance(self.kappa, dict):
            k = tuple(sorted((n, self._coef_fp(v))
                             for n, v in self.kappa.items()))
        else:
            k = self._coef_fp(self.kappa)
        return ("ScalarDiffusivity", self._coef_fp(self.nu), k,
                self.formulation, self.time_discretization,
                self.discrete_form)

    def __repr__(self):
        return (f"ScalarDiffusivity(nu={self.nu}, kappa={self.kappa}, "
                f"formulation={self.formulation!r}, time_discretization="
                f"{self.time_discretization!r})")

    @property
    def _axes(self):
        return {ISO: (0, 1, 2), HORIZONTAL: (0, 1), VERTICAL: (2,)}[
            self.formulation]

    @property
    def _explicit_axes(self):
        if self.time_discretization == "vertically_implicit":
            return tuple(a for a in self._axes if a != 2)
        return self._axes

    @property
    def _vitd_z(self):
        return (self.time_discretization == "vertically_implicit"
                and 2 in self._axes)

    def _resolve(self, grid, k, loc, fields, time):
        if self.discrete_form and callable(k):
            args = (grid, fields, time)
            if self.parameters is not None:
                args = args + (self.parameters,)
            arr = k(*args)           # cell-centred padded tensor
        elif callable(k) and not isinstance(k, torch.Tensor):
            return resolve_coefficient(grid, k, loc, time)
        else:
            arr = k
        if not isinstance(arr, torch.Tensor) or arr.ndim == 0:
            return arr
        # a cell-centred tensor, interpolated to the stress location
        return interp_to(grid, arr, LOC_CCC, loc)

    def _kappa_key(self, name):
        return ("kappa_ccc" if not isinstance(self.kappa, dict)
                else f"kappa_ccc_{name}")

    def compute_diffusivities(self, grid, fields, time):
        # varying ν and κ are resolved once a stage at the stress locations
        aux = {}
        if _varies(self.nu):
            for key, loc in (("nu_ccc", LOC_CCC), ("nu_ffc", ("f", "f", "c")),
                             ("nu_fcf", ("f", "c", "f")),
                             ("nu_cff", ("c", "f", "f")),
                             ("nu_ccf", ("c", "c", "f"))):
                aux[key] = self._resolve(grid, self.nu, loc, fields, time)
        kappas = (self.kappa if isinstance(self.kappa, dict)
                  else {None: self.kappa})
        for name, k in kappas.items():
            if _varies(k):
                key = "kappa_ccc" if name is None else f"kappa_ccc_{name}"
                aux[key] = self._resolve(grid, k, LOC_CCC, fields, time)
        return aux

    def _nu_at(self, aux, key):
        return aux[key] if _varies(self.nu) else self.nu

    def momentum_tendencies(self, grid, fields, aux):
        u, v, w = fields["u"], fields["v"], fields["w"]
        nu = self._nu_at(aux, "nu_ccc")
        axes = self._explicit_axes
        if self.formulation == ISO:
            nu_ffc = self._nu_at(aux, "nu_ffc")
            nu_fcf = self._nu_at(aux, "nu_fcf")
            nu_cff = self._nu_at(aux, "nu_cff")
            out = dict(
                u=div_2nu_strain_u(grid, u, v, w, nu, nu_ffc, nu_fcf, axes),
                v=div_2nu_strain_v(grid, u, v, w, nu, nu_ffc, nu_cff, axes),
                w=div_2nu_strain_w(grid, u, v, w, nu, nu_fcf, nu_cff, axes))
            if self._vitd_z:
                # 2νSxz = ν(∂z u + ∂x w): the tridiagonal owns ν ∂z u on the
                # interior faces, ν ∂x w stays explicit everywhere and the
                # walls keep the full flux
                tu = vitd_explicit_z_term(grid, u, ("f", "c", "c"), nu,
                                          cross_grad=ddx(grid, w,
                                                         ("f", "c", "f")))
                tv = vitd_explicit_z_term(grid, v, ("c", "f", "c"), nu,
                                          cross_grad=ddy(grid, w,
                                                         ("c", "f", "f")))
                if tu is not None:
                    out["u"] = out["u"] + tu
                    out["v"] = out["v"] + tv
            return out
        # the horizontal and vertical formulations take the Laplacian form
        out = dict(u=div_kappa_grad(grid, u, ("f", "c", "c"), nu, axes),
                   v=div_kappa_grad(grid, v, ("c", "f", "c"), nu, axes),
                   w=div_kappa_grad(grid, w, ("c", "c", "f"), nu, axes))
        if self._vitd_z:
            tu = vitd_explicit_z_term(grid, u, ("f", "c", "c"), nu)
            tv = vitd_explicit_z_term(grid, v, ("c", "f", "c"), nu)
            if tu is not None:
                out["u"] = out["u"] + tu
                out["v"] = out["v"] + tv
        return out

    def tracer_tendency(self, grid, name, fields, aux):
        k = _kappa_for(self.kappa, name)
        if _varies(k):
            k = aux[self._kappa_key(name)]
        g = div_kappa_grad(grid, fields[name], LOC_CCC, k,
                           self._explicit_axes)
        if self._vitd_z:
            t = vitd_explicit_z_term(grid, fields[name], LOC_CCC, k)
            if t is not None:
                g = g + t
        return g

    def vertical_implicit_kappas(self, grid, fields, aux):
        if self.time_discretization != "vertically_implicit":
            return {}
        if 2 not in self._axes:
            # a horizontal formulation has no z diffusivity to solve for
            return {}
        nu_z = aux["nu_ccf"] if _varies(self.nu) else self.nu
        out = {"u": nu_z, "v": nu_z}
        if "w" in fields:
            # under the strain form τ₃₃ = 2ν ∂z w: the implicit operator owns
            # 2ν, as in the JAX package
            out["w"] = 2 * nu_z if self.formulation == ISO else nu_z
        for name in fields:
            if name not in ("u", "v", "w"):
                k = _kappa_for(self.kappa, name)
                if _varies(k):
                    k = aux[self._kappa_key(name)]
                out[name] = k
        return out


def VerticalScalarDiffusivity(*args, nu=0.0, kappa=0.0,
                              time_discretization="explicit"):
    """``([time_discretization,] nu, kappa, time_discretization)``."""
    args, time_discretization = _td_first(args, time_discretization)
    if len(args) > 3:
        raise TypeError("too many positional arguments")
    nu, kappa, time_discretization = (
        tuple(args) + (nu, kappa, time_discretization)[len(args):])
    return ScalarDiffusivity(nu=nu, kappa=kappa, formulation=VERTICAL,
                             time_discretization=time_discretization)


def HorizontalScalarDiffusivity(*args, nu=0.0, kappa=0.0,
                                time_discretization="explicit"):
    """``([time_discretization,] nu, kappa)``."""
    args, time_discretization = _td_first(args, time_discretization)
    if len(args) > 2:
        raise TypeError("too many positional arguments")
    nu, kappa = tuple(args) + (nu, kappa)[len(args):]
    return ScalarDiffusivity(nu=nu, kappa=kappa, formulation=HORIZONTAL,
                             time_discretization=time_discretization)


class ScalarBiharmonicDiffusivity(_ClosureBase):
    """Fourth-order hyperdiffusion: the tendency -∇·(ν ∇(∇²q)), which
    damps."""

    required_halo = 2

    def __init__(self, nu=0.0, kappa=0.0, formulation=ISO):
        self.nu = nu
        self.kappa = kappa
        self.discrete_form = False
        self.parameters = None
        self.formulation = formulation

    def _fp(self):
        k = (tuple(sorted(self.kappa.items())) if isinstance(self.kappa, dict)
             else self.kappa)
        return ("ScalarBiharmonicDiffusivity", self.nu, k, self.formulation)

    @property
    def _axes(self):
        return {ISO: (0, 1, 2), HORIZONTAL: (0, 1), VERTICAL: (2,)}[
            self.formulation]

    def _biharm(self, grid, q, loc, kappa):
        lap = div_kappa_grad(grid, q, loc, 1.0, self._axes)
        return -div_kappa_grad(grid, lap, loc, kappa, self._axes)

    def momentum_tendencies(self, grid, fields, aux):
        return dict(
            u=self._biharm(grid, fields["u"], ("f", "c", "c"), self.nu),
            v=self._biharm(grid, fields["v"], ("c", "f", "c"), self.nu),
            w=self._biharm(grid, fields["w"], ("c", "c", "f"), self.nu))

    def tracer_tendency(self, grid, name, fields, aux):
        k = _kappa_for(self.kappa, name)
        return self._biharm(grid, fields[name], LOC_CCC, k)


def VerticalScalarBiharmonicDiffusivity(nu=0.0, kappa=0.0):
    return ScalarBiharmonicDiffusivity(nu, kappa, VERTICAL)


def HorizontalScalarBiharmonicDiffusivity(nu=0.0, kappa=0.0):
    return ScalarBiharmonicDiffusivity(nu, kappa, HORIZONTAL)


def _sum(terms):
    total = 0
    for t in terms:
        total = total + t
    return total


class ClosureTuple(_ClosureBase):
    """The sum of several closures' fluxes."""

    def __init__(self, *closures):
        self.closures = tuple(closures)
        self.required_halo = max(getattr(c, "required_halo", 1)
                                 for c in closures)
        names = []
        for c in closures:
            for n in getattr(c, "required_tracers", ()):
                if n not in names:
                    names.append(n)
        self.required_tracers = tuple(names)

    def _fp(self):
        return ("ClosureTuple",) + tuple(c._fp() for c in self.closures)

    def compute_diffusivities(self, grid, fields, time):
        return [c.compute_diffusivities(grid, fields, time)
                for c in self.closures]

    def momentum_tendencies(self, grid, fields, aux):
        outs = [c.momentum_tendencies(grid, fields, a)
                for c, a in zip(self.closures, aux)]
        return {k: _sum(o[k] for o in outs) for k in ("u", "v", "w")}

    def tracer_tendency(self, grid, name, fields, aux):
        return _sum(c.tracer_tendency(grid, name, fields, a)
                    for c, a in zip(self.closures, aux))

    def vertical_implicit_kappas(self, grid, fields, aux):
        combined = {}
        for c, a in zip(self.closures, aux):
            for k, v in c.vertical_implicit_kappas(grid, fields, a).items():
                combined[k] = combined.get(k, 0.0) + v
        return combined

    # -- the advective GM form of a member ----------------------------------
    # the tuple carries its members' eddy velocities (the JAX ClosureTuple
    # has none, so there an advective member loses its skew transport:
    # ROADMAP.md queue 3)

    @property
    def has_eddy_velocities(self):
        return any(getattr(c, "has_eddy_velocities", False)
                   for c in self.closures)

    def eddy_velocities(self, grid, fields):
        """The sum of the members' eddy transport velocities."""
        total = None
        for c in self.closures:
            if getattr(c, "has_eddy_velocities", False):
                e = c.eddy_velocities(grid, fields)
                total = e if total is None else tuple(
                    a + b for a, b in zip(total, e))
        return total

    def vertical_implicit_damping(self, grid, fields, aux):
        combined = {}
        for c, a in zip(self.closures, aux):
            if hasattr(c, "vertical_implicit_damping"):
                for k, v in c.vertical_implicit_damping(grid, fields,
                                                        a).items():
                    combined[k] = combined.get(k, 0.0) + v
        return combined

    def clip_fields(self, fields):
        for c in self.closures:
            if hasattr(c, "clip_fields"):
                fields = c.clip_fields(fields)
        return fields

    # -- a substepped TKE member (CATKE) ------------------------------------
    # the tuple exposes its member's substepping, so that the model drives
    # it as it drives the bare closure

    @property
    def tke_member(self):
        for c in self.closures:
            if getattr(c, "substepped_tke", False):
                return c
        return None

    @property
    def substepped_tke(self):
        return self.tke_member is not None

    @property
    def substepped_tracers(self):
        m = self.tke_member
        return m.substepped_tracers if m is not None else ()

    @property
    def tke_time_step(self):
        return self.tke_member.tke_time_step

    def substeps_for(self, dt):
        return self.tke_member.substeps_for(dt)

    def step_turbulence(self, grid, fields_old, fields_new, slow_G, Gm, dt,
                        chi0, euler, M, time):
        return self.tke_member.step_turbulence(
            grid, fields_old, fields_new, slow_G, Gm, dt, chi0, euler, M,
            time)

    def tracer_tendency_excluding_tke(self, grid, name, fields, aux):
        """The slow tendency of a substepped tracer from the other members
        (the substepped member's terms live in step_turbulence)."""
        tke = self.tke_member
        total = torch.zeros_like(fields[name])
        for c, a in zip(self.closures, aux):
            if c is not tke:
                total = total + c.tracer_tendency(grid, name, fields, a)
        return total


class HorizontalDivergenceScalarDiffusivity(_ClosureBase):
    """Divergence damping: the momentum tendency (∂x, ∂y) of ν ∇h·u, which
    damps the horizontally divergent mode only."""

    def __init__(self, nu=0.0):
        self.nu = nu

    def _fp(self):
        return ("HorizontalDivergenceScalarDiffusivity", self.nu)

    def _delta(self, grid, fields):
        return div_xy_ccc(grid, fields["u"], fields["v"])

    def _momentum(self, grid, fields, q):
        out = dict(u=ddx(grid, q, ("f", "c", "c")),
                   v=ddy(grid, q, ("c", "f", "c")))
        if "w" in fields:
            out["w"] = torch.zeros_like(fields["w"])
        return out

    def momentum_tendencies(self, grid, fields, aux):
        return self._momentum(grid, fields,
                              self.nu * self._delta(grid, fields))

    def tracer_tendency(self, grid, name, fields, aux):
        return 0.0


class HorizontalDivergenceScalarBiharmonicDiffusivity(
        HorizontalDivergenceScalarDiffusivity):
    """Biharmonic divergence damping: -(∂x, ∂y) of ν ∇h²(∇h·u)."""

    required_halo = 2

    def _fp(self):
        return ("HorizontalDivergenceScalarBiharmonicDiffusivity", self.nu)

    def momentum_tendencies(self, grid, fields, aux):
        delta = self._delta(grid, fields)
        lap = div_kappa_grad(grid, delta, LOC_CCC, 1.0, (0, 1))
        return self._momentum(grid, fields, -self.nu * lap)


class FluxTapering:
    """The isopycnal slope-tapering specification (``slope_limiter=`` of
    the isopycnal closures, which are not ported yet)."""

    def __init__(self, max_slope):
        self.max_slope = float(max_slope)


def viscosity(closure, diffusivity_fields):
    """The closure's (eddy) viscosity: the ``nu_e`` field or the constant."""
    if isinstance(diffusivity_fields, dict) and "nu_e" in diffusivity_fields:
        return diffusivity_fields["nu_e"]
    return getattr(closure, "nu", 0.0)


def diffusivity(closure, diffusivity_fields, tracer="b"):
    """The closure's (eddy) diffusivity of ``tracer``."""
    if isinstance(diffusivity_fields, dict):
        for key in (f"kappa_{tracer}", "kappa_e", "nu_e"):
            if key in diffusivity_fields:
                return diffusivity_fields[key]
    return _kappa_for(getattr(closure, "kappa", 0.0), tracer)
