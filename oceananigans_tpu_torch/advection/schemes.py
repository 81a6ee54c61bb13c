"""Advection schemes: Centered, UpwindBiased, WENO.

Counterpart of ``oceananigans_tpu/advection/schemes.py``.
Each scheme exposes, over padded tensors,

    symmetric(grid, a, axis, beta)            # face value, no bias
    biased_by(grid, a, axis, beta, q)         # upwind value selected by sign(q)
    biased_pair(grid, a, axis, beta)          # (left-, right-biased) values

``smooth`` (on ``biased_by`` and ``biased_pair``) lists arrays whose summed
Jiang–Shu indicators replace the reconstructed variable's own: the
reference's VelocityStencil, which the WENO vector-invariant vorticity uses;
linear schemes ignore it.

``beta`` is 0 for center→face output, 1 for face→center output. An upwind or
WENO scheme carries a lower-order centered scheme for the *advecting*
velocity, and near the walls of a Bounded direction every scheme cascades to
its buffer scheme (WENO9 → WENO7 → WENO5 → WENO3 → UpwindBiased(1);
Centered(4) → Centered(2)), with masks on the global index. WENO computes
its smoothness indicators in ``smoothness_dtype`` (float32 by default),
whatever the field dtype.

On a stretched axis (``grid.regular(axis)`` False: a stretched coordinate;
the horizontal axes of a shell grid are index-regular) the reconstruction
coefficients are derived per slot from the face positions
(``eno_coefficients_nonuniform``), the right-biased stencils get their own
(the mirror symmetry no longer holds, so ``biased_by`` forms both sides and
selects), and the optimal weights and smoothness factors stay uniform, as in
JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..defaults import as_torch_dtype
from .reconstruction import (_ShiftCache, eno_coefficients,
                             eno_coefficients_nonuniform, left_shifts, mirror,
                             optimal_weights, smoothness_factors,
                             smoothness_value, stencil_value, typed_constants)
from ..operators.shifts import shift, shift_zbc


class _SelectedShiftCache:
    """Shift reader returning ``where(pos, a[o], a[mirror(o)])`` — the
    upwind-selected cell for offset ``o``. ``zbc`` activates halo-free
    boundary-aware reads."""

    def __init__(self, a, axis, pos, beta, zbc=None):
        self.a, self.axis, self.pos, self.beta = a, axis, pos, beta
        self.zbc = zbc
        self.cache = {}

    def _shift(self, off):
        if self.zbc is not None:
            return shift_zbc(self.a, off, self.axis, self.zbc)
        return shift(self.a, off, self.axis)

    def __call__(self, off):
        if off not in self.cache:
            l = self._shift(off)
            r = self._shift(2 * self.beta - 1 - off)
            self.cache[off] = torch.where(self.pos, l, r)
        return self.cache[off]


class _MirroredShiftCache(_ShiftCache):
    """Shift reader of the right-biased stencils: offset ``o`` reads
    ``a[mirror(o)] = a[2β-1-o]``, so a left-biased evaluation through it is
    the right-biased reconstruction (the mirror stencils share coefficients
    and smoothness factors)."""

    def __init__(self, a, axis, beta, zbc=None):
        super().__init__(a, axis, zbc)
        self.beta = beta

    def __call__(self, off):
        return super().__call__(2 * self.beta - 1 - off)


def _is_stretched(grid, axis):
    reg = getattr(grid, "regular", None)
    if reg is None or grid.is_flat(axis):
        return False
    return not reg(axis)


def shard_cut(grid, axis):
    """(the global grid, the offset) of a shard's ``grid`` along a sharded
    ``axis`` (x or y), or None: per-slot tables along a stretched sharded
    axis are the global grid's cut at the offset, so that the slots near a
    shard's edges, whose stencils reach past its padded range, read what
    the serial grid reads."""
    shard = getattr(grid, "shard", None)
    if shard is None or axis > 1 or not hasattr(shard, "offset"):
        return None
    glob = shard.global_grid
    return getattr(glob, "underlying_grid", glob), shard.offset[axis]


def _padded_faces(grid, axis):
    """The npad + 1 face positions along ``axis`` (the last extrapolated)."""
    f = np.asarray(grid.coord_padded(axis, "f"), np.float64)
    d = f[-1] - f[-2] if len(f) > 1 else 1.0
    return np.append(f, f[-1] + d)


@functools.lru_cache(maxsize=None)
def _nonuniform_eno_np(faces_key, nfaces, beta, k, s, mirrored, npad):
    """The float64 coefficient arrays of ``_nonuniform_eno``, keyed by the
    face positions."""
    faces = np.frombuffer(faces_key, np.float64).reshape(nfaces)
    if not mirrored:
        return tuple(eno_coefficients_nonuniform(faces, k, s, beta, npad))
    # the right-biased stencil s covers the cells at the mirrored shifts:
    # evaluate a reconstruction whose cells are exactly those
    shifts = mirror(left_shifts(k, s, beta), beta)
    s_equiv = beta - 1 - min(shifts)
    cs = eno_coefficients_nonuniform(faces, k, s_equiv, beta, npad)
    # the cells ascend, the mirrored shifts descend
    return tuple(reversed(cs))


def _nonuniform_eno(grid, axis, beta, k, s, mirrored, like):
    """Per-slot ENO coefficients of stencil s along a stretched ``axis``
    (``mirrored``: of the right-biased stencil, paired with the mirrored
    shifts), as tensors broadcastable along the axis in the dtype and on
    the device of ``like``; cached on the grid."""
    key = (axis, beta, k, s, mirrored, like.dtype, str(like.device))
    cache = grid.__dict__.setdefault("_nonuniform_eno", {})
    cut = shard_cut(grid, axis)
    if key not in cache and cut is not None:
        glob, o = cut
        n = grid.padded_shape[axis]
        cache[key] = tuple(c.narrow(axis, o, n) for c in _nonuniform_eno(
            glob, axis, beta, k, s, mirrored, like))
    if key not in cache:
        faces = _padded_faces(grid, axis)
        cs = _nonuniform_eno_np(faces.tobytes(), faces.size, beta, k, s,
                                mirrored, grid.padded_shape[axis])
        view = [1, 1, 1]
        view[axis] = -1
        cache[key] = tuple(torch.as_tensor(c.reshape(view), dtype=like.dtype,
                                           device=like.device) for c in cs)
    return cache[key]


# WENO regularization (reference: weno_interpolants.jl `const ϵ = 1f-8`)
WENO_EPSILON = 1e-8

# Saturation of r = τ/(β+ε) before squaring (keeps the float32 smoothness
# arithmetic finite for metric-weighted operands).
WENO_R_MAX = 1e12

# Global smoothness indicator τ coefficients per buffer k (Don & Borges 2013):
# τ = |Σ_s t_s β_s| with β ordered from the downwind-most stencil (s=0).
TAU_COEFFS = {
    2: (1, -1),
    3: (1, 0, -1),
    4: (1, 3, -3, -1),
    5: (1, 2, -6, 2, 1),
    6: (1, 36, 135, -135, -36, -1),
}


def _axis_bounded(grid, axis):
    """Whether ``axis`` is a Bounded direction the near-wall order cascade
    applies to."""
    from ..grids.topology import BOUNDED
    return not grid.is_flat(axis) and grid.topology[axis] == BOUNDED


def cascade_mask(grid, axis, beta, R, shape, device):
    """True where the order-R scheme applies along a Bounded ``axis``: faces
    i ∈ [R+1, N+1−R] and centers i ∈ [R, N+1−R] (1-based), i.e. padded slots
    [H+R−β, H+N−R]; on a shard's grid i and N are the global grid's
    (``global_extent``: the walls are the global grid's)."""
    from ..grids.topology import global_extent
    H = grid.H[axis]
    offset, N = global_extent(grid, axis)
    i0 = H + R - beta - offset
    i1 = H + N - R - offset
    view = [1, 1, 1]
    view[axis] = shape[axis]
    iota = torch.arange(shape[axis], device=device).reshape(view)
    return (iota >= i0) & (iota <= i1)


def immersed_ok(grid, axis, R):
    """On an immersed grid, True where no solid cell lies within ±R cells
    along ``axis`` (the order-R scheme applies there; within R of a solid
    cell the reconstruction cascades to the buffer scheme, down to the
    2-point stencil that reads no solid value); None on other grids.
    Cached on the grid as a boolean tensor on its device."""
    solid = getattr(grid, "solid_ccc", None)
    if solid is None or grid.is_flat(axis):
        return None
    cache = grid.__dict__.setdefault("_imm_adv_masks", {})
    m = cache.get((axis, R))
    if m is None:
        parent = getattr(grid, "_parent", None)
        if parent is not None:
            # a shard's block: the global grid's mask cut at the block (the
            # rolls wrap the global padded array, as the serial model's)
            ok = parent[1](immersed_ok(parent[0], axis, R).cpu().numpy())
        else:
            near = solid.copy()
            for r in range(1, R + 1):
                near = near | np.roll(solid, r, axis) | np.roll(solid, -r,
                                                                axis)
            ok = ~near
        m = cache[(axis, R)] = torch.as_tensor(ok, device=grid.device)
    return m


def _cascade_select(grid, axis, beta, R, hi, lo):
    return torch.where(cascade_mask(grid, axis, beta, R, hi.shape, hi.device),
                       hi, lo)


class AdvectionScheme:
    required_halo = 1

    def _fp(self):
        return (type(self).__name__, self.order)

    def __hash__(self):
        return hash(self._fp())

    def __eq__(self, other):
        return isinstance(other, AdvectionScheme) and self._fp() == other._fp()

    def __repr__(self):
        return f"{type(self).__name__}(order={self.order})"

    def buffer_scheme(self):
        """The lower-order scheme evaluated inside the boundary buffer of a
        Bounded direction; None = evaluated unconditionally."""
        return None

    def _cascade(self, grid, axis, beta, hi, lo_eval):
        """Near the walls of a Bounded direction and near immersed solid
        cells, the buffer scheme's value replaces ``hi``."""
        bs = self.buffer_scheme()
        if bs is None:
            return hi
        bounded = _axis_bounded(grid, axis)
        imask = immersed_ok(grid, axis, self.buffer)
        if not bounded and imask is None:
            return hi
        lo = lo_eval(bs)
        out = hi
        if bounded:
            out = _cascade_select(grid, axis, beta, self.buffer, out, lo)
        if imask is not None:
            out = torch.where(imask, out, lo)
        return out

    def biased_by(self, grid, a, axis, beta, q, smooth=None, zbc=None):
        hi = self._biased_by_plain(grid, a, axis, beta, q, smooth=smooth,
                                   zbc=zbc)
        if not grid.is_flat(axis) and _is_stretched(grid, axis):
            # biased_pair already cascaded both sides
            return hi
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.biased_by(grid, a, axis, beta, q,
                                                     smooth=smooth, zbc=zbc))

    def biased_pair(self, grid, a, axis, beta, smooth=None, zbc=None):
        """(left, right) biased reconstructions; near the walls of a Bounded
        direction each side cascades to the buffer scheme's."""
        if grid.is_flat(axis):
            return a, a
        l = self._biased(grid, _ShiftCache(a, axis, zbc), axis, beta,
                         None if smooth is None else
                         [_ShiftCache(s, axis, zbc) for s in smooth])
        r = self._biased(grid, _MirroredShiftCache(a, axis, beta, zbc), axis,
                         beta, None if smooth is None else
                         [_MirroredShiftCache(s, axis, beta, zbc)
                          for s in smooth], mirrored=True)
        bs = self.buffer_scheme()
        bounded = _axis_bounded(grid, axis)
        imask = immersed_ok(grid, axis, getattr(self, "buffer", 1))
        if bs is None or (not bounded and imask is None):
            return l, r
        ll, lr = bs.biased_pair(grid, a, axis, beta, smooth=smooth, zbc=zbc)
        if bounded:
            l = _cascade_select(grid, axis, beta, self.buffer, l, ll)
            r = _cascade_select(grid, axis, beta, self.buffer, r, lr)
        if imask is not None:
            l = torch.where(imask, l, ll)
            r = torch.where(imask, r, lr)
        return l, r

    def _biased_by_plain(self, grid, a, axis, beta, q, smooth=None,
                         zbc=None):
        """Upwind reconstruction selected by the sign of ``q``: select each
        stencil cell first — ``where(q > 0, a[shift], a[mirror(shift)])`` —
        then reconstruct once with the left-biased coefficients (the mirror
        stencils share coefficients and smoothness factors)."""
        if grid.is_flat(axis):
            return a
        if _is_stretched(grid, axis):
            # the nonuniform coefficients are not mirror-symmetric: both
            # sides, then the selection
            l, r = self.biased_pair(grid, a, axis, beta, smooth=smooth,
                                    zbc=zbc)
            return torch.where(q > 0, l, r)
        pos = q > 0
        sel = _SelectedShiftCache(a, axis, pos, beta, zbc)
        scs = (None if smooth is None else
               [_SelectedShiftCache(s, axis, pos, beta, zbc) for s in smooth])
        return self._biased(grid, sel, axis, beta, scs)


class Centered(AdvectionScheme):
    """Symmetric reconstruction of even order."""

    def __init__(self, order=2):
        if order % 2 != 0:
            raise ValueError("Centered order must be even")
        self.order = order
        self.buffer = order // 2
        self.required_halo = self.buffer
        self._coeffs = eno_coefficients(order, self.buffer - 1)

    def _coeffs_for(self, grid, axis, beta, like):
        if _is_stretched(grid, axis):
            return _nonuniform_eno(grid, axis, beta, self.order,
                                   self.buffer - 1, False, like)
        return self._coeffs

    def buffer_scheme(self):
        if self.order <= 2:
            return None
        if not hasattr(self, "_buffer_scheme"):
            self._buffer_scheme = Centered(order=self.order - 2)
        return self._buffer_scheme

    def _symmetric_plain(self, grid, a, axis, beta, zbc=None):
        if grid.is_flat(axis):
            return a
        sc = _ShiftCache(a, axis, zbc)
        shifts = left_shifts(self.order, self.buffer - 1, beta)
        return stencil_value(sc, shifts, self._coeffs_for(grid, axis, beta,
                                                          a))

    def symmetric(self, grid, a, axis, beta, zbc=None):
        hi = self._symmetric_plain(grid, a, axis, beta, zbc)
        if grid.is_flat(axis):
            return hi
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.symmetric(grid, a, axis, beta,
                                                     zbc=zbc))

    def _biased(self, grid, sc, axis, beta, smooth=None, mirrored=False):
        shifts = left_shifts(self.order, self.buffer - 1, beta)
        return stencil_value(sc, shifts, self._coeffs_for(grid, axis, beta,
                                                          sc(0)))

    def biased_pair(self, grid, a, axis, beta, smooth=None, zbc=None):
        # no bias: both sides get the symmetric value
        s = self.symmetric(grid, a, axis, beta, zbc)
        return s, s


class UpwindBiased(AdvectionScheme):
    """Odd-order upwind-biased reconstruction."""

    def __init__(self, order=3):
        if order % 2 != 1:
            raise ValueError("UpwindBiased order must be odd")
        self.order = order
        self.buffer = (order + 1) // 2
        self.required_halo = self.buffer
        self._s = self.buffer - 1
        self._coeffs = eno_coefficients(order, self._s)
        self.advecting_velocity_scheme = Centered(order=max(order - 1, 2))

    def buffer_scheme(self):
        if self.order <= 1:
            return None
        if not hasattr(self, "_buffer_scheme"):
            self._buffer_scheme = UpwindBiased(order=self.order - 2)
        return self._buffer_scheme

    def symmetric(self, grid, a, axis, beta, zbc=None):
        # the cascade mask uses THIS scheme's buffer and chain
        hi = self.advecting_velocity_scheme._symmetric_plain(
            grid, a, axis, beta, zbc)
        if grid.is_flat(axis):
            return hi
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.symmetric(grid, a, axis, beta,
                                                     zbc=zbc))

    def _biased(self, grid, sc, axis, beta, smooth=None, mirrored=False):
        if grid.is_flat(axis):
            return sc(0)
        coeffs = (_nonuniform_eno(grid, axis, beta, self.order, self._s,
                                  mirrored, sc(0))
                  if _is_stretched(grid, axis) else self._coeffs)
        return stencil_value(sc, left_shifts(self.order, self._s, beta),
                             coeffs)


class WENO(AdvectionScheme):
    """Weighted ENO of odd order 3–11 with WENO-Z nonlinear weights

        α_s = γ_s · (1 + (τ / (β_s + ε))²),   τ = |Σ_s t_s β_s|

    with the smoothness arithmetic in ``smoothness_dtype``. ``bounds=(lo,
    hi)`` turns on the bounds-preserving limiter of the tracer flux
    divergence (``advection/fluxes.py`` ``div_Uc``)."""

    def __init__(self, order=5, smoothness_dtype=torch.float32, bounds=None):
        if order % 2 != 1:
            raise ValueError("WENO order must be odd (3, 5, 7, 9, 11)")
        self.order = order
        self.buffer = k = (order + 1) // 2
        self.required_halo = self.buffer
        self.smoothness_dtype = as_torch_dtype(smoothness_dtype)
        self.bounds = (tuple(float(b) for b in bounds) if bounds is not None
                       else None)
        self._gammas = optimal_weights(k)
        self._coeffs = [eno_coefficients(k, s) for s in range(k)]
        self._sfactors = [smoothness_factors(k, s) for s in range(k)]
        self.advecting_velocity_scheme = Centered(order=order - 1)

    def buffer_scheme(self):
        if not hasattr(self, "_buffer_scheme"):
            if self.order > 3:
                self._buffer_scheme = WENO(
                    order=self.order - 2,
                    smoothness_dtype=self.smoothness_dtype)
            else:
                self._buffer_scheme = UpwindBiased(order=1)
        return self._buffer_scheme

    def _fp(self):
        return (type(self).__name__, self.order, str(self.smoothness_dtype),
                self.bounds)

    def __repr__(self):
        bounds = "" if self.bounds is None else f", bounds={self.bounds}"
        return (f"WENO(order={self.order}, "
                f"smoothness_dtype={self.smoothness_dtype}{bounds})")

    def symmetric(self, grid, a, axis, beta, zbc=None):
        hi = self.advecting_velocity_scheme._symmetric_plain(
            grid, a, axis, beta, zbc)
        if grid.is_flat(axis):
            return hi
        return self._cascade(grid, axis, beta, hi,
                             lambda bs: bs.symmetric(grid, a, axis, beta,
                                                     zbc=zbc))

    def _biased(self, grid, sc, axis, beta, smooth=None, mirrored=False):
        if grid.is_flat(axis):
            return sc(0)
        k = self.buffer
        out_dtype = sc(0).dtype
        sdt = self.smoothness_dtype
        stretched = _is_stretched(grid, axis)
        ps, betas = [], []
        for s in range(k):
            shifts = left_shifts(k, s, beta)
            cs = (_nonuniform_eno(grid, axis, beta, k, s, mirrored, sc(0))
                  if stretched else self._coeffs[s])
            ps.append(stencil_value(sc, shifts, cs))
            b = None
            for scm in (sc,) if smooth is None else smooth:
                bm = smoothness_value(scm, shifts, self._sfactors[s],
                                      compute_dtype=sdt)
                b = bm if b is None else b + bm
            betas.append(b)
        # the constants in the smoothness dtype, as JAX rounds them
        taus, (eps, rmax), gammas = (typed_constants(c, betas[0].dtype) for c in
                                     (TAU_COEFFS[k], (WENO_EPSILON, WENO_R_MAX),
                                      self._gammas))
        tau = None
        for t, tt, b in zip(TAU_COEFFS[k], taus, betas):
            if t == 0:
                continue
            term = tt * b
            tau = term if tau is None else tau + term
        tau = torch.abs(tau)
        num = den = None
        for s in range(k):
            r = tau / (betas[s] + eps)
            r = torch.clamp(r, max=rmax.item())   # exact in r's dtype
            alpha = (gammas[s] * (1.0 + r * r)).to(out_dtype)
            nterm = alpha * ps[s]
            num = nterm if num is None else num + nterm
            den = alpha if den is None else den + alpha
        return num / den


def adapt_advection_order(advection, grid):
    """Shrink the advection order per direction to fit small grids (a scheme
    of buffer B needs N ≥ B points; otherwise Centered drops to order 2N,
    upwind/WENO to 2N-1). Returns a FluxFormAdvection when any direction
    changed."""
    if advection is None or not isinstance(advection, AdvectionScheme):
        return advection

    def adapt_one(scheme, N):
        if N >= scheme.buffer:
            return scheme
        if isinstance(scheme, Centered):
            return Centered(order=max(2, 2 * N))
        if isinstance(scheme, WENO) and 2 * N - 1 >= 3:
            return WENO(order=2 * N - 1,
                        smoothness_dtype=scheme.smoothness_dtype,
                        bounds=scheme.bounds)
        if isinstance(scheme, (WENO, UpwindBiased)):
            return UpwindBiased(order=max(1, 2 * N - 1))
        return scheme

    from ..grids.topology import global_extent
    per_axis = (advection.schemes if isinstance(advection, FluxFormAdvection)
                else (advection,) * 3)
    # a shard's grid adapts to the global grid's N
    new = tuple(s if grid.is_flat(ax) else
                adapt_one(s, global_extent(grid, ax)[1])
                for ax, s in enumerate(per_axis))
    if all(n is o for n, o in zip(new, per_axis)):
        return advection
    return FluxFormAdvection(*new)


class FluxFormAdvection(AdvectionScheme):
    """A different scheme per direction."""

    def __init__(self, x, y=None, z=None):
        self.schemes = (x, y if y is not None else x,
                        z if z is not None else x)
        self.order = max(s.order for s in self.schemes)
        self.required_halo = max(s.required_halo for s in self.schemes)
        # the members' bounds-preserving limiter carries over: a bounded
        # WENO that adapt_advection_order wraps keeps its limiter
        all_bounds = {getattr(s, "bounds", None) for s in self.schemes}
        all_bounds.discard(None)
        if len(all_bounds) > 1:
            raise ValueError("FluxFormAdvection members declare different "
                             f"bounds: {sorted(all_bounds)}")
        self.bounds = all_bounds.pop() if all_bounds else None

    def _fp(self):
        return ("FluxFormAdvection",) + tuple(s._fp() for s in self.schemes)

    def symmetric(self, grid, a, axis, beta, zbc=None):
        return self.schemes[axis].symmetric(grid, a, axis, beta, zbc)

    def biased_by(self, grid, a, axis, beta, q, smooth=None, zbc=None):
        return self.schemes[axis].biased_by(grid, a, axis, beta, q,
                                            smooth=smooth, zbc=zbc)

    def biased_pair(self, grid, a, axis, beta, smooth=None, zbc=None):
        return self.schemes[axis].biased_pair(grid, a, axis, beta,
                                              smooth=smooth, zbc=zbc)
