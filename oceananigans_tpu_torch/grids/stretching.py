"""Named coordinate stretchings.

Counterpart of ``oceananigans_tpu/grids/stretching.py``: the same
discretizations, formed in float64 numpy exactly as the JAX package forms
them. Each discretization is callable with a 0-based face index (the grid
builders evaluate ``faces(k) for k in range(N + 1)``) and exposes ``.faces``
(the N+1 interface positions) and ``len()`` (the cell count), so it can be
passed as an ``x=``, ``y=`` or ``z=`` (``longitude=``, ``latitude=``)
coordinate::

    grid = RectilinearGrid(size=(64, 64, 32), x=(0, 1), y=(0, 1),
                           z=ExponentialDiscretization(32, -1000, 0),
                           device="cpu")
"""

from __future__ import annotations

import math

import numpy as np


class PowerLawStretching:
    """x ↦ x^power (reference: coordinate_utils.jl:181-192)."""

    def __init__(self, power=1.02):
        self.power = float(power)

    def __call__(self, x):
        return x ** self.power


class LinearStretching:
    """x ↦ (1 + coefficient)·x (reference: coordinate_utils.jl:199-210)."""

    def __init__(self, coefficient=0.02):
        self.coefficient = float(coefficient)

    def __call__(self, x):
        return (1 + self.coefficient) * x


def _exp_face(i, N, left, right, scale, bias):
    """Face i (1-based) of the exponential discretization (reference:
    construct_exponential_coordinate, coordinate_utils.jl:140-160)."""
    delta = (right - left) / N
    xi = left + (i - 1) * delta
    if bias == "right":
        x = right - (right - left) * math.expm1((right - xi) / scale) \
            / math.expm1((right - left) / scale)
    elif bias == "left":
        x = left + (right - left) * math.expm1((xi - left) / scale) \
            / math.expm1((right - left) / scale)
    else:
        raise ValueError("bias must be 'left' or 'right'")
    eps32 = 10 * np.finfo(np.float32).eps
    if abs(x - left) < eps32:
        x = left
    elif abs(x - right) < eps32:
        x = right
    return x


class ExponentialDiscretization:
    """N cells spanning [left, right] with exponentially varying spacing,
    interfaces stacked toward the ``bias`` side (reference:
    coordinate_utils.jl ExponentialDiscretization)."""

    def __init__(self, size, left, right, scale=None, bias="right"):
        self.size = int(size)
        self.left, self.right = float(left), float(right)
        self.scale = float(scale if scale is not None
                           else (right - left) / 5)
        self.bias = bias
        self.faces = np.asarray([
            _exp_face(i, self.size, self.left, self.right, self.scale, bias)
            for i in range(1, self.size + 2)])

    def __call__(self, k):
        return self.faces[k]

    def __len__(self):
        return self.size

    def __repr__(self):
        return (f"ExponentialDiscretization(size={self.size}, "
                f"left={self.left}, right={self.right}, "
                f"scale={self.scale}, bias={self.bias!r})")


class ReferenceToStretchedDiscretization:
    """Constant spacing near the ``bias`` edge, then spacings grown by the
    ``stretching`` law up to ``maximum_spacing``, until ``extent`` is
    covered (reference: coordinate_utils.jl
    ReferenceToStretchedDiscretization + compute_stretched_interfaces)."""

    def __init__(self, extent, bias="right", bias_edge=0.0,
                 constant_spacing=None, constant_spacing_extent=None,
                 maximum_stretching_extent=np.inf, maximum_spacing=np.inf,
                 stretching=None, rounding_digits=2):
        self.extent = float(extent)
        self.bias = bias
        self.bias_edge = float(bias_edge)
        d0 = float(constant_spacing if constant_spacing is not None
                   else extent / 20)
        h0 = float(constant_spacing_extent
                   if constant_spacing_extent is not None else 5 * d0)
        self.constant_spacing = d0
        self.constant_spacing_extent = h0
        self.stretching = stretching or PowerLawStretching(1.02)
        if bias == "left":
            direction = 1
        elif bias == "right":
            direction = -1
        else:
            raise ValueError("bias must be 'left' or 'right'")
        faces = [self.bias_edge + direction * d0 * i
                 for i in range(int(np.ceil(h0 / d0)) + 1)]
        while abs(faces[-1] - self.bias_edge) < self.extent:
            d_prev = abs(faces[-1] - faces[-2])
            if abs(self.bias_edge - faces[-1]) <= maximum_stretching_extent:
                d = min(maximum_spacing, self.stretching(d_prev))
            else:
                d = d_prev
            nxt = round(faces[-1] + direction * d, rounding_digits)
            if nxt == faces[-1]:
                # the increment collapsed under rounding (a spacing below
                # 0.5·10^-rounding_digits): d_prev would become 0 and the
                # loop would never end
                raise ValueError(
                    f"spacing {d} rounds to zero at rounding_digits="
                    f"{rounding_digits}; pass a larger rounding_digits "
                    "for this domain scale (the reference's "
                    "ExponentialDiscretization makes the same demand)")
            faces.append(nxt)
        if direction == -1:
            faces = faces[::-1]
        self.faces = np.asarray(faces)

    def __call__(self, k):
        return self.faces[k]

    def __len__(self):
        return len(self.faces) - 1

    def __repr__(self):
        return (f"ReferenceToStretchedDiscretization(extent={self.extent}, "
                f"size={len(self)}, bias={self.bias!r})")
