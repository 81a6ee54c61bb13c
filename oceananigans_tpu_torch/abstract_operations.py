"""AbstractOperations: lazy expression trees over Fields for diagnostics.

Counterpart of ``oceananigans_tpu/abstract_operations.py``: Unary, Binary and
Multiary operations with location matching (the second operand is
interpolated to the first's location), ``Derivative`` and ``partial_x/y/z``,
``at``, ``KernelFunctionOperation``, ``ConditionalOperation``, the metric
reductions ``Average``, ``Integral``, ``CumulativeIntegral``, the unweighted
``Reduction`` and ``Accumulation``, ``Field``'s operator overloads and
``ComputedField``.

An operation is a deferred function of padded tensors: ``materialize()``
evaluates the tree on its operands' device and returns a padded tensor (a
reduction returns its keep-dims result). ``compute()`` wraps it in a Field.
The reductions take ``condition=`` (a Field, an operation, a callable of the
coordinates or a boolean array) and skip the solid points of an immersed
grid, through the masks of ``fields/field.py`` that the Field reductions
use.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from .fields.field import (Field, align_reduction_mask, condition_interior,
                           set_on_padded)
from .grids.topology import BOUNDED, CENTER, FACE, LOC_CCC
from .operators.operators import ddx, ddy, ddz, interp_to


class AbstractOperation:
    """A lazy node with ``.grid`` and ``.loc``; ``materialize()`` returns a
    padded tensor."""

    grid = None
    loc = LOC_CCC

    def materialize(self):
        raise NotImplementedError

    # -- algebra --------------------------------------------------------------

    def __add__(self, other):
        return BinaryOperation(operator.add, self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return BinaryOperation(operator.sub, self, other)

    def __rsub__(self, other):
        return BinaryOperation(operator.sub, other, self)

    def __mul__(self, other):
        return BinaryOperation(operator.mul, self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return BinaryOperation(operator.truediv, self, other)

    def __rtruediv__(self, other):
        return BinaryOperation(operator.truediv, other, self)

    def __pow__(self, other):
        return BinaryOperation(operator.pow, self, other)

    def __neg__(self):
        return UnaryOperation(operator.neg, self)

    def __abs__(self):
        return UnaryOperation(operator.abs, self)

    # -- evaluation -----------------------------------------------------------

    def compute(self):
        """The operation evaluated into a Field."""
        return Field(self.grid, self.loc, None, self.materialize())

    @property
    def interior(self):
        return self.compute().interior


def _materialize(x, grid, loc):
    if isinstance(x, AbstractOperation):
        a, src_loc = x.materialize(), x.loc
    elif isinstance(x, Field):
        a, src_loc = x.data, x.loc
    else:
        return x
    if src_loc != loc:
        a = interp_to(grid, a, src_loc, loc)
    return a


def _grid_loc_of(*xs):
    for x in xs:
        if isinstance(x, (AbstractOperation, Field)):
            return x.grid, x.loc
    raise ValueError("no field operand")


class UnaryOperation(AbstractOperation):
    def __init__(self, op, a, loc=None):
        self.op = op
        self.a = a
        self.grid, aloc = _grid_loc_of(a)
        self.loc = tuple(loc) if loc else aloc

    def materialize(self):
        return self.op(_materialize(self.a, self.grid, self.loc))


class BinaryOperation(AbstractOperation):
    """The second operand is interpolated to the first's location (or both
    to ``loc``)."""

    def __init__(self, op, a, b, loc=None):
        self.op = op
        self.a, self.b = a, b
        self.grid, aloc = _grid_loc_of(a, b)
        self.loc = tuple(loc) if loc else aloc

    def materialize(self):
        return self.op(_materialize(self.a, self.grid, self.loc),
                       _materialize(self.b, self.grid, self.loc))


class MultiaryOperation(AbstractOperation):
    def __init__(self, op, *args, loc=None):
        self.op = op
        self.args = args
        self.grid, aloc = _grid_loc_of(*args)
        self.loc = tuple(loc) if loc else aloc

    def materialize(self):
        return self.op(*[_materialize(a, self.grid, self.loc)
                         for a in self.args])


class Derivative(AbstractOperation):
    """∂ along ``axis``; the location flips along it."""

    def __init__(self, a, axis):
        self.a = a
        self.axis = axis
        self.grid, aloc = _grid_loc_of(a)
        loc = list(aloc)
        loc[axis] = FACE if aloc[axis] == CENTER else CENTER
        self.loc = tuple(loc)

    def materialize(self):
        src = (self.a.materialize() if isinstance(self.a, AbstractOperation)
               else self.a.data)
        return (ddx, ddy, ddz)[self.axis](self.grid, src, self.loc)


def partial_x(a):
    return Derivative(a, 0)


def partial_y(a):
    return Derivative(a, 1)


def partial_z(a):
    return Derivative(a, 2)


def at(loc, a):
    """``a`` relocated (interpolated) to ``loc``."""
    return UnaryOperation(lambda x: x, a, loc=tuple(loc))


class KernelFunctionOperation(AbstractOperation):
    """``func(grid, *args) -> padded tensor`` as an operation; Field
    arguments arrive as their padded tensors, operations materialized."""

    def __init__(self, func, grid, *args, loc=LOC_CCC):
        self.func = func
        self.grid = grid
        self.args = args
        self.loc = tuple(loc)

    def materialize(self):
        args = [a.data if isinstance(a, Field)
                else (a.materialize() if isinstance(a, AbstractOperation)
                      else a)
                for a in self.args]
        return self.func(self.grid, *args)


class ConditionalOperation(AbstractOperation):
    """``a`` where ``condition`` holds, ``mask_value`` elsewhere."""

    def __init__(self, a, condition, mask_value=0.0):
        self.a = a
        self.condition = condition
        self.mask_value = mask_value
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data = _materialize(self.a, self.grid, self.loc)
        cond = self.condition
        if isinstance(cond, AbstractOperation):
            cond = cond.materialize()
        elif isinstance(cond, Field):
            cond = cond.data
        elif callable(cond):
            cond = set_on_padded(self.grid, self.loc, cond)
        cond = torch.as_tensor(cond, device=data.device).to(torch.bool)
        return torch.where(cond, data, torch.as_tensor(
            self.mask_value, dtype=data.dtype, device=data.device))


# -- metric reductions ---------------------------------------------------------

def _op_interior_slices(grid, loc, data_shape):
    """N points per axis, N + 1 where the operand is a face in a bounded
    direction (as Field.interior), the one slot of a size-1 axis."""
    sls = []
    for ax in range(3):
        if data_shape[ax] == 1:
            sls.append(slice(0, 1))
            continue
        n, h = grid.N[ax], grid.H[ax]
        extra = 1 if (loc[ax] == FACE and grid.topology[ax] == BOUNDED) else 0
        sls.append(slice(h, h + n + extra))
    return tuple(sls)


def _data_of(op_or_field):
    if isinstance(op_or_field, Field):
        return op_or_field.grid, op_or_field.loc, op_or_field.data
    return op_or_field.grid, op_or_field.loc, op_or_field.materialize()


def _interior_and_weights(op_or_field, dims):
    """The interior data and the metric weights of a reduction over
    ``dims``: the product of the grid spacings along ``dims`` only. A face
    operand in a bounded reduction direction takes both boundary faces with
    half (trapezoid) end weights."""
    grid, loc, data = _data_of(op_or_field)
    metric = {0: grid.dx, 1: grid.dy, 2: grid.dz}
    kw = dict(dtype=data.dtype, device=data.device)
    w = torch.ones((), **kw)
    for ax in dims:
        w = w * torch.as_tensor(metric[ax](loc), **kw)
    w = w.broadcast_to(data.shape)
    ii = _op_interior_slices(grid, loc, data.shape)
    data_i, w_i = data[ii], w[ii]
    for ax in dims:
        if (data.shape[ax] != 1 and loc[ax] == FACE
                and grid.topology[ax] == BOUNDED):
            npts = data_i.shape[ax]
            fac = np.ones(npts)
            fac[0] = fac[-1] = 0.5
            shape = [1, 1, 1]
            shape[ax] = npts
            w_i = w_i * torch.as_tensor(fac.reshape(shape), **kw)
    return data_i, w_i, grid, loc


def reduction_mask(op_or_field, grid, loc, condition=None):
    """The interior boolean mask of a reduction: ``condition``, the fluid
    points of an immersed grid and a ConditionalOperation operand's own
    condition; None when none applies."""
    m = condition_interior(condition, grid, loc)
    fm = getattr(grid, "fluid_mask_at", None)
    if fm is not None:
        shape = (op_or_field.data.shape if isinstance(op_or_field, Field)
                 else grid.padded_shape)
        sl = list(_op_interior_slices(grid, loc, shape))
        for ax in range(3):
            if shape[ax] == 1:
                sl[ax] = grid.interior_slices[ax]
        f = fm(loc, torch.bool)[tuple(sl)]
        m = f if m is None else (m & f)
    if condition is None and isinstance(op_or_field, ConditionalOperation):
        c = condition_interior(op_or_field.condition, grid, loc)
        if c is not None:
            m = c if m is None else (m & c)
    return m


def _dims(dims):
    return tuple(dims) if np.iterable(dims) else (dims,)


def conditional_length(field, dims=None, condition=None):
    """The number of points a conditional reduction takes (all of the
    interior without a condition on a grid that is not immersed)."""
    grid, loc = _grid_loc_of(field)
    m = reduction_mask(field, grid, loc, condition)
    ii = grid.interior_slices
    if m is None:
        shape = tuple(s.stop - s.start for s in ii)
        if dims is None:
            return int(np.prod(shape))
        return torch.ones(shape, dtype=torch.int64, device=grid.device).sum(
            dim=_dims(dims), keepdim=True)
    if dims is None:
        return m.sum()
    return m.sum(dim=_dims(dims), keepdim=True)


def _masked_operands(self, dims):
    data, w, grid, loc = _interior_and_weights(self.a, dims)
    m = reduction_mask(self.a, grid, loc, self.condition)
    if m is not None:
        m = align_reduction_mask(m, data.shape)
    return data, w, m


def _full(value, like):
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


class Average(AbstractOperation):
    """The metric-weighted mean over ``dims``; with a condition (or on an
    immersed grid, or over a ConditionalOperation) over the points that
    take part, normalised by their weights."""

    def __init__(self, a, dims=(0, 1, 2), condition=None, mask=0.0):
        self.a = a
        self.dims = _dims(dims)
        self.condition = condition
        self.mask_value = mask
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data, w, m = _masked_operands(self, self.dims)
        if m is not None:
            data = torch.where(m, data, _full(self.mask_value, data))
            w = torch.where(m, w, _full(0.0, w))
        num = (data * w).sum(dim=self.dims, keepdim=True)
        return num / w.sum(dim=self.dims, keepdim=True)

    def compute(self):
        return self.materialize()

    @property
    def interior(self):
        return self.materialize()


class Integral(Average):
    """The metric-weighted integral over ``dims``; masked points contribute
    ``mask`` (0 by default)."""

    def materialize(self):
        data, w, m = _masked_operands(self, self.dims)
        contrib = data * w
        if m is not None:
            contrib = torch.where(m, contrib, _full(self.mask_value, contrib))
        return contrib.sum(dim=self.dims, keepdim=True)


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = x.prod(dim=d, keepdim=True)
    return x if keepdim else x.squeeze(dim)


_REDUCERS = dict(
    sum=lambda x, dim, keepdim: x.sum(dim=dim, keepdim=keepdim),
    mean=lambda x, dim, keepdim: x.mean(dim=dim, keepdim=keepdim),
    maximum=lambda x, dim, keepdim: x.amax(dim=dim, keepdim=keepdim),
    minimum=lambda x, dim, keepdim: x.amin(dim=dim, keepdim=keepdim),
    prod=_prod)
_ACCUMULATORS = dict(cumsum=torch.cumsum, cumprod=torch.cumprod,
                     cummax=lambda x, dim: torch.cummax(x, dim).values,
                     cummin=lambda x, dim: torch.cummin(x, dim).values)

# the neutral fill of a masked point, per operation
_NEUTRALS = dict(sum=0.0, mean=0.0, prod=1.0, maximum=-np.inf,
                 minimum=np.inf, cumsum=0.0, cumprod=1.0, cummax=-np.inf,
                 cummin=np.inf)


class Reduction(AbstractOperation):
    """An unweighted reduction over ``dims``: ``op`` one of sum, mean,
    maximum, minimum, prod, or a callable ``op(x, dim=..., keepdim=True)``.
    With a condition the masked points take the operation's neutral value
    (or ``mask``); ``mean`` then divides by the count of points taken."""

    def __init__(self, op, a, dims=(0, 1, 2), condition=None, mask=None):
        self.op_name = op if isinstance(op, str) else None
        self.op = _REDUCERS[op] if isinstance(op, str) else op
        self.a = a
        self.dims = _dims(dims)
        self.condition = condition
        self.mask_value = mask
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data, _, m = _masked_operands(self, self.dims)
        if m is not None:
            if self.op_name == "mean" and self.mask_value is None:
                num = torch.where(m, data, _full(0.0, data)).sum(
                    dim=self.dims, keepdim=True)
                return num / m.to(data.dtype).sum(dim=self.dims,
                                                  keepdim=True)
            fill = (self.mask_value if self.mask_value is not None
                    else _NEUTRALS.get(self.op_name, 0.0))
            data = torch.where(m, data, _full(fill, data))
        return self.op(data, dim=self.dims, keepdim=True)

    def compute(self):
        return self.materialize()

    @property
    def interior(self):
        return self.materialize()


class Accumulation(AbstractOperation):
    """An unweighted scan along one dimension: ``op`` one of cumsum,
    cumprod, cummax, cummin, or a callable ``op(x, dim)``; ``reverse=True``
    scans from the high end."""

    def __init__(self, op, a, dims=2, condition=None, mask=None,
                 reverse=False):
        self.op_name = op if isinstance(op, str) else None
        self.op = _ACCUMULATORS[op] if isinstance(op, str) else op
        self.a = a
        self.dim = int(dims)
        self.condition = condition
        self.mask_value = mask
        self.reverse = bool(reverse)
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data, _, m = _masked_operands(self, (self.dim,))
        if m is not None:
            fill = (self.mask_value if self.mask_value is not None
                    else _NEUTRALS.get(self.op_name, 0.0))
            data = torch.where(m, data, _full(fill, data))
        if self.reverse:
            data = torch.flip(data, (self.dim,))
        out = self.op(data, self.dim)
        return torch.flip(out, (self.dim,)) if self.reverse else out

    def compute(self):
        return self.materialize()

    @property
    def interior(self):
        return self.materialize()


class CumulativeIntegral(AbstractOperation):
    """The cumulative metric-weighted integral along one dimension;
    ``reverse`` and ``condition`` as for Accumulation (masked points
    contribute ``mask``·Δ, 0 by default)."""

    def __init__(self, a, dims=2, condition=None, mask=0.0, reverse=False):
        self.a = a
        self.dim = int(dims)
        self.condition = condition
        self.mask_value = mask
        self.reverse = bool(reverse)
        self.grid, self.loc = _grid_loc_of(a)

    def materialize(self):
        data, w, m = _masked_operands(self, (self.dim,))
        if m is not None:
            data = torch.where(m, data, _full(self.mask_value, data))
        contrib = data * w
        if self.reverse:
            contrib = torch.flip(contrib, (self.dim,))
        out = torch.cumsum(contrib, self.dim)
        return torch.flip(out, (self.dim,)) if self.reverse else out

    def compute(self):
        return self.materialize()


# -- Field's operator overloads -------------------------------------------------

def _field_binop(op):
    def method(self, other):
        return BinaryOperation(op, self, other)
    return method


def _field_rbinop(op):
    def method(self, other):
        return BinaryOperation(op, other, self)
    return method


Field.__add__ = _field_binop(operator.add)
Field.__radd__ = _field_binop(operator.add)
Field.__sub__ = _field_binop(operator.sub)
Field.__rsub__ = _field_rbinop(operator.sub)
Field.__mul__ = _field_binop(operator.mul)
Field.__rmul__ = _field_binop(operator.mul)
Field.__truediv__ = _field_binop(operator.truediv)
Field.__rtruediv__ = _field_rbinop(operator.truediv)
Field.__pow__ = _field_binop(operator.pow)
Field.__neg__ = lambda self: UnaryOperation(operator.neg, self)
Field.__abs__ = lambda self: UnaryOperation(operator.abs, self)


class ComputedField:
    """An operation evaluated on demand and cached by time:
    ``compute(time)`` evaluates again only when ``time`` differs from the
    cached one; ``compute()`` always evaluates."""

    def __init__(self, op):
        self.op = op
        self.grid = op.grid
        self.loc = op.loc
        self._time = None
        self._cached = None

    def compute(self, time=None):
        if (time is None or self._cached is None
                or self._time is None or time != self._time):
            self._cached = self.op.compute()
            self._time = time
        return self._cached

    @property
    def interior(self):
        return self.compute().interior

    def __call__(self, model=None):
        # the writers' protocol: the value at the model's time, cached
        return self.compute(None if model is None else model.time)
