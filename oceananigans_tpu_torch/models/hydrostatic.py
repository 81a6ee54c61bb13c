"""HydrostaticFreeSurfaceModel: the primitive equations with a free surface.

Counterpart of ``oceananigans_tpu/models/hydrostatic.py`` for a static z
coordinate: prognostic u, v, tracers and η; w diagnosed from continuity; the
hydrostatic pressure anomaly from ``BuoyancyTracer``; vector-invariant
momentum advection, Coriolis, tracer advection, scalar Flux conditions; the
quasi-AB2 step (Euler on the first step and when Δt changes) with an
``ExplicitFreeSurface`` or a ``SplitExplicitFreeSurface`` (a fixed substep
count, the barotropic corrector, and (η, U, V) persisted across steps).

The tendency of u, v and the tracers goes through
``kernels.fused_vi_tendency`` (the port of TPU kernels #10 and #11) or its
plain PyTorch version, by ``fused_tendencies``:

- ``"auto"`` (the default): on a CUDA grid the kernel where it covers the
  configuration and the plain version elsewhere; on a CPU grid the plain
  version. It never raises for coverage, as the JAX "auto" (its XLA path)
  never does.
- ``True`` or ``"packed"`` (a TPU layout of the same function): the kernel
  on a CUDA grid (its plain version on a CPU grid); a configuration the
  kernel does not cover raises, on any device, as the JAX opt-in does.
- ``False``: the plain version.

``uses_kernel`` says whether a model launches the kernel. Where the JAX
"auto" takes XLA, the port's takes the kernel on the card: a speed choice,
not a semantic one (the JAX fused and XLA paths agree to roundoff, and so
do the port's two paths).

With no ``free_surface`` the model takes the JAX default:
``ImplicitFreeSurface()`` on a RectilinearGrid (regular in x and y, as the
port's always is) and ``SplitExplicitFreeSurface(cfl=0.7)`` elsewhere;
neither is ported yet, so both raise, naming the free surface chosen.

Against the JAX model: the Hy-to-8 rounding of the halo (a Mosaic tile
workaround) is dropped, the halo is ``max(grid halo, required)``; z is
scanned with ``torch.cumsum`` where the JAX model contracts with a
triangular matrix (an MXU workaround). As in JAX, the stored u and v after a
step are the corrected fields before their halo fill (their boundary faces
carry the step's increment, refilled at the next step's start), and w is
diagnosed from the filled ones.

Closures, forcing, biogeochemistry, auxiliary fields, prescribed velocities,
z-star, ``SplitRungeKutta3``, per-tracer advection schemes, flux-form
momentum advection, ``ImplicitFreeSurface`` and ``FixedTimeStepSize``
substepping raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..advection import Centered
from ..advection.vector_invariant import VectorInvariant
from ..boundary_conditions import (apply_flux_bcs_padded,
                                   fill_all_halo_regions,
                                   fill_surface_halo_regions,
                                   regularize_field_boundary_conditions)
from ..buoyancy import BuoyancyTracer
from ..defaults import numpy_dtype
from ..fields import Field, set_on_padded
from ..grids.topology import LOC_CCC, LOC_CCF, LOC_CFC, LOC_FCC
from ..kernels import fused_vi_tendency, fused_vi_tendency_plain
from ..kernels.fused_vector_invariant import vi_config
from ..operators.operators import _metric, ddx, ddy, div_xy_ccc, dx_c, dy_c
from ..timesteppers import QuasiAdamsBashforth2TimeStepper
from .free_surfaces import (ExplicitFreeSurface, ImplicitFreeSurface,
                            SplitExplicitFreeSurface)

PROGNOSTIC_LOCS = {"u": LOC_FCC, "v": LOC_CFC}


def _item(what):
    return f"ROADMAP.md queue 1 item 13 (hydrostatic: {what})"


_NOT_PORTED = {
    "closure": _item("vertical diffusivities and CATKE"),
    "forcing": _item("forcing"),
    "biogeochemistry": "ROADMAP.md queue 1 item 15 (the long tail)",
    "auxiliary_fields": "ROADMAP.md queue 1 item 15 (the long tail)",
    "velocities": _item("prescribed velocities"),
}


def default_free_surface(grid):
    """The JAX model's default free surface for ``grid``: implicit on a
    RectilinearGrid regular in x and y, split-explicit with ``cfl=0.7``
    elsewhere. Neither is ported yet: the error names the one chosen."""
    from ..grids.rectilinear import RectilinearGrid
    if isinstance(grid, RectilinearGrid):
        chosen, make = "ImplicitFreeSurface()", ImplicitFreeSurface
    else:
        chosen = "SplitExplicitFreeSurface(cfl=0.7)"
        make = functools.partial(SplitExplicitFreeSurface, cfl=0.7)
    try:
        return make()
    except NotImplementedError as e:
        raise NotImplementedError(
            f"the default free surface on a {type(grid).__name__} is the "
            f"JAX model's {chosen}: {e}; pass free_surface= explicitly"
        ) from None


class HydrostaticFreeSurfaceModel:
    def __init__(self, grid, momentum_advection=None, tracer_advection=None,
                 free_surface=None, tracers=(), buoyancy=None, coriolis=None,
                 closure=None, forcing=None, boundary_conditions=None,
                 velocities=None, timestepper="QuasiAdamsBashforth2",
                 vertical_coordinate="z", biogeochemistry=None,
                 auxiliary_fields=None, fused_tendencies="auto", device=None,
                 dtype=None):
        given = dict(closure=closure, forcing=forcing,
                     biogeochemistry=biogeochemistry,
                     auxiliary_fields=auxiliary_fields, velocities=velocities)
        for name, value in given.items():
            if value:
                raise NotImplementedError(
                    f"{name} is not ported yet: {_NOT_PORTED[name]}")
        if callable(vertical_coordinate):
            vertical_coordinate = vertical_coordinate()
        if vertical_coordinate != "z":
            raise NotImplementedError(
                f"vertical_coordinate={vertical_coordinate!r} is not ported "
                f"yet: {_item('z-star')}")
        if timestepper not in ("QuasiAdamsBashforth2", "ab2", "qab2"):
            raise NotImplementedError(
                f"timestepper {timestepper!r} is not ported yet: "
                f"{_item('SplitRungeKutta3')}")
        if isinstance(tracer_advection, dict):
            raise NotImplementedError(
                f"per-tracer advection schemes are not ported yet: "
                f"{_item('per-tracer advection')}")
        if momentum_advection is not None and not isinstance(
                momentum_advection, VectorInvariant):
            raise NotImplementedError(
                f"momentum advection {momentum_advection!r}: only the vector-"
                f"invariant form is ported: {_item('flux-form momentum')}")
        if buoyancy is not None and not isinstance(buoyancy, BuoyancyTracer):
            raise NotImplementedError(
                f"buoyancy {buoyancy!r}: only BuoyancyTracer is ported: "
                f"{_item('SeawaterBuoyancy')}")
        if fused_tendencies not in (True, False, "packed", "auto"):
            raise ValueError(f"fused_tendencies={fused_tendencies!r}")
        if device is not None or dtype is not None:
            grid = grid.to(device=device, dtype=dtype)
        if free_surface is None:
            free_surface = default_free_surface(grid)
        if not isinstance(free_surface, (ExplicitFreeSurface,
                                         SplitExplicitFreeSurface)):
            raise NotImplementedError(
                f"free surface {free_surface!r} is not ported yet: "
                f"{_item('implicit free surface')}")
        self.free_surface = free_surface
        self.momentum_advection = (momentum_advection if momentum_advection
                                   is not None else VectorInvariant())
        self.tracer_advection = (tracer_advection if tracer_advection
                                 is not None else Centered(2))
        if isinstance(tracers, str):
            tracers = (tracers,)
        tracers = tuple(tracers)
        if buoyancy is not None:
            tracers += tuple(n for n in buoyancy.required_tracers
                             if n not in tracers)
        self.tracer_names = tracers
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.timestepper = QuasiAdamsBashforth2TimeStepper()

        required = max(getattr(self.tracer_advection, "required_halo", 1),
                       self.momentum_advection.required_halo)
        halo = tuple(max(h, required) if not grid.is_flat(i) else 0
                     for i, h in enumerate(grid.H))
        self.grid = grid.with_halo(halo)
        if not self.grid.is_bounded(2):
            raise ValueError("HydrostaticFreeSurfaceModel needs a Bounded "
                             "z direction")
        if self.grid.N[2] < halo[2] + 1:
            raise ValueError("the bounded-z halo fill needs Nz > Hz")

        bcs_in = dict(boundary_conditions or {})
        unknown = set(bcs_in) - {"u", "v", "eta"} - set(tracers)
        if unknown:
            raise ValueError(f"boundary conditions for unknown fields "
                             f"{sorted(unknown)}")
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

        self.uses_kernel = self._kernel_route(fused_tendencies, coriolis)

        h, n = self.grid.H[2], self.grid.N[2]
        self._dzc = torch.as_tensor(
            np.broadcast_to(np.asarray(self.grid.dz(LOC_CCC), np.float64),
                            (n,)).copy(), dtype=self.grid.dtype,
            device=self.grid.device)
        self._H = abs(self.grid.extent[2])
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

    def _kernel_route(self, fused_tendencies, coriolis):
        """Whether the tendency launches the kernel (module docstring)."""
        if fused_tendencies is False:
            return False
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

    # -- properties -----------------------------------------------------------

    @property
    def prognostic_3d(self):
        return ("u", "v") + self.tracer_names

    @property
    def prognostic_names(self):
        return self.prognostic_3d + ("eta",)

    def loc(self, name):
        if name == "w":
            return LOC_CCF
        return PROGNOSTIC_LOCS.get(name, LOC_CCC)

    @property
    def time(self):
        return float(self.state["clock"]["time"])

    @property
    def iteration(self):
        return int(self.state["clock"]["iteration"])

    def field(self, name):
        data = self.state["w"] if name == "w" else self.state["fields"][name]
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

    # -- halo fills -----------------------------------------------------------

    def _fill_surface(self, a, loc, bcs):
        """The x/y halos of a 2-D surface field, in place."""
        return fill_surface_halo_regions([a], self.grid, [(loc, bcs)])[0]

    def _fill_all(self, fields):
        """Fill the halos of ``fields`` ({name: padded tensor}) in place."""
        names = [n for n in fields if n != "eta"]
        fill_all_halo_regions([fields[n] for n in names], self.grid,
                              [(self.loc(n), self.bcs[n]) for n in names])
        if "eta" in fields:
            self._fill_surface(fields["eta"], LOC_CCC, self.bcs["eta"])
        return fields

    # -- set ------------------------------------------------------------------

    def set(self, **values):
        """Set prognostic fields from scalars, arrays or callables of
        (λ, φ, z); η takes a 2-D or (Nx, Ny, 1) array too. Setting u, v or η
        re-initializes the barotropic transports from ∫u dz, ∫v dz."""
        fields = dict(self.state["fields"])
        for name, value in values.items():
            if name not in fields:
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
                data = set_on_padded(self.grid, LOC_CCC, value)
                kz = self.grid.H[2] if data.shape[2] > self.grid.H[2] else 0
                data = data[:, :, kz:kz + 1].clone()
                fields["eta"] = self._fill_surface(data, LOC_CCC,
                                                   self.bcs["eta"])
                continue
            data = set_on_padded(self.grid, self.loc(name), value)
            fill_all_halo_regions([data], self.grid,
                                  [(self.loc(name), self.bcs[name])])
            fields[name] = data
        self.state = {**self.state, "fields": fields}
        if "barotropic" in self.state and {"u", "v", "eta"} & set(values):
            U = self._fill_surface(self._depth_integral(fields["u"]), LOC_FCC,
                                   self.bcs["u"])
            V = self._fill_surface(self._depth_integral(fields["v"]), LOC_CFC,
                                   self.bcs["v"])
            self.state = {**self.state, "barotropic": {"U": U, "V": V}}

    # -- diagnostics ----------------------------------------------------------

    def _depth_integral(self, q):
        """∫ q dz over the interior z, as a (Nx + 2Hx, Ny + 2Hy, 1) tensor."""
        h, n = self.grid.H[2], self.grid.N[2]
        return (q[:, :, h:h + n] * self._dzc).sum(2, keepdim=True)

    def _w_from_continuity(self, u, v):
        """w at the z faces by integrating continuity up from the bottom;
        halos filled."""
        grid = self.grid
        h, n = grid.H[2], grid.N[2]
        sx, sy = grid.interior_slices[:2]
        d = div_xy_ccc(grid, u, v)[sx, sy, h:h + n] * self._dzc
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
            * self._dzc
        above = torch.flip(torch.cumsum(torch.flip(bdz, [2]), 2), [2]) - bdz
        p = self._zeros()
        p[sx, sy, h:h + n] = -(0.5 * bdz + above)
        fill_surface_halo_regions([p], grid, [(LOC_CCC, self.bcs["ph"])])
        return p

    # -- tendencies -----------------------------------------------------------

    def _compute_tendencies(self, fields, w):
        grid = self.grid
        u, v = fields["u"], fields["v"]
        ph = self._hydrostatic_pressure(fields)
        fn = fused_vi_tendency if self.uses_kernel else fused_vi_tendency_plain
        Gu, Gv, Gc = fn(grid, self.momentum_advection, self.tracer_advection,
                        self.tracer_names, self.coriolis, u, v, w,
                        {n: fields[n] for n in self.tracer_names}, ph)
        G = {"u": Gu, "v": Gv, **Gc}
        if isinstance(self.free_surface, ExplicitFreeSurface):
            g = self.free_surface.g
            G["u"] = G["u"] - g * ddx(grid, fields["eta"], LOC_FCC)
            G["v"] = G["v"] - g * ddy(grid, fields["eta"], LOC_CFC)
        for name in G:
            apply_flux_bcs_padded(G[name], grid, self.loc(name),
                                  self.bcs[name])
        return G

    # -- step -----------------------------------------------------------------

    def time_step(self, dt):
        """Advance the model by one quasi-AB2 step of Δt."""
        nt = self._nt
        dt = nt(dt)
        fdt = float(dt)
        state = self.state
        clock = state["clock"]
        euler = clock["iteration"] == 0 or clock["last_dt"] != dt
        c_new, c_old, keep = self.timestepper.coefficients(euler)
        fields = self._fill_all(dict(state["fields"]))
        w = self._w_from_continuity(fields["u"], fields["v"])
        G = self._compute_tendencies(fields, w)
        Gm = state["Gm"]
        ab2G = {n: c_new * G[n] - c_old * Gm[n] * keep
                for n in self.prognostic_3d}
        new = {n: fields[n] + fdt * ab2G[n] for n in self.prognostic_3d}
        fs = self.free_surface
        bt = state.get("barotropic")
        if isinstance(fs, SplitExplicitFreeSurface):
            eta_f, U_f, V_f = self._step_split_explicit(fields, ab2G, fdt, bt)
            du = (U_f - self._depth_integral(new["u"])) / self._H
            dv = (V_f - self._depth_integral(new["v"])) / self._H
            new["u"] = new["u"] + du
            new["v"] = new["v"] + dv
            new["eta"] = eta_f
            bt = {"U": U_f, "V": V_f}
        else:
            grid = self.grid
            U = self._depth_integral(new["u"])
            V = self._depth_integral(new["v"])
            div = (dx_c(grid, _metric(grid.dy(LOC_FCC), U) * U)
                   + dy_c(grid, _metric(grid.dx(LOC_CFC), V) * V)) \
                / _metric(grid.Az(LOC_CCC), U)
            new["eta"] = fields["eta"] - fdt * div
        uf, vf = new["u"].clone(), new["v"].clone()
        fill_all_halo_regions([uf, vf], self.grid,
                              [(LOC_FCC, self.bcs["u"]),
                               (LOC_CFC, self.bcs["v"])])
        w_new = self._w_from_continuity(uf, vf)
        self.state = dict(fields=new,
                          clock=dict(time=nt(clock["time"] + dt),
                                     iteration=clock["iteration"] + 1,
                                     last_dt=dt),
                          w=w_new, Gm=G)
        if bt is not None:
            self.state["barotropic"] = bt
        return self

    def _step_split_explicit(self, fields, ab2G, dt, barotropic):
        """Substep (η, U, V) from the persisted barotropic state, forced by
        the depth integrals of the AB2-weighted tendencies; returns the
        filtered (η, U, V), halos filled."""
        fs = self.free_surface
        locs_bcs = [(LOC_CCC, self.bcs["eta"]), (LOC_FCC, self.bcs["u"]),
                    (LOC_CFC, self.bcs["v"])]

        def fill(eta, U, V):
            return tuple(fill_surface_halo_regions([eta, U, V], self.grid,
                                                   locs_bcs))

        GU = self._depth_integral(ab2G["u"])
        GV = self._depth_integral(ab2G["v"])
        eta_f, U_f, V_f = fs.substep(
            self.grid, self._H, self._H, fields["eta"], barotropic["U"],
            barotropic["V"], GU, GV, dt, fill)
        return fill(eta_f, U_f, V_f)

    def __repr__(self):
        return (f"HydrostaticFreeSurfaceModel(grid={self.grid!r}, "
                f"free_surface={type(self.free_surface).__name__}, "
                f"tracers={self.tracer_names})")


def state_from_jax(jax_state_numpy, model):
    """Load a JAX ``HydrostaticFreeSurfaceModel``'s state into ``model``.

    ``jax_state_numpy`` is the JAX model's ``state`` with its arrays
    converted to numpy (``fields``, ``clock``, ``w``, ``Gm`` and, under the
    split-explicit free surface, ``barotropic``). The JAX arrays may have
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
    model.state = state
    return model


__all__ = ["HydrostaticFreeSurfaceModel", "state_from_jax"]
