"""The multi-dimensional (two horizontal dimensions) WENO reconstruction.

Counterpart of ``oceananigans_tpu/advection/multidimensional.py``: a
5th-order centred WENO point-value filter applied along the horizontal axis
tangential to a 1-D reconstruction (``VectorInvariant(
multi_dimensional_stencil=True)``). Three 3-point stencils are combined with
the split positive and negative centred weights (σ± splitting avoids the
negative centred optimal weights), ε = 1e-8. ``csrc/vi_kernel.cuh``
``md_filter`` is the same arithmetic in the fused VI kernel, whose constant
table holds ``FILTER_CONSTANTS``.
"""

from __future__ import annotations

import numpy as np

from ..operators.shifts import shift

_SQ15 = np.sqrt(15.0)
EPS = 1e-8

# optimal weights of the three stencils for the evaluation points
# ξ = -√15/10 (1), the centre split into σ± (2±), +√15/10 (3)
G1 = ((1008 + 71 * _SQ15) / 5240, 408 / 655, (1008 - 71 * _SQ15) / 5240)
G3 = ((1008 - 71 * _SQ15) / 5240, 408 / 655, (1008 + 71 * _SQ15) / 5240)
SIG_P = 214.0 / 80.0
SIG_M = 67.0 / 40.0
G2P = (9 / 80 / SIG_P, 49 / 20 / SIG_P, 9 / 80 / SIG_P)
G2M = (9 / 40 / SIG_M, 49 / 40 / SIG_M, 9 / 40 / SIG_M)

# each stencil's reconstruction coefficients at the three points
A1 = (((2 - 3 * _SQ15) / 60, (-4 + 12 * _SQ15) / 60, (62 - 9 * _SQ15) / 60),
      ((2 + 3 * _SQ15) / 60, 56 / 60, (2 - 3 * _SQ15) / 60),
      ((62 + 9 * _SQ15) / 60, (-4 - 12 * _SQ15) / 60, (2 + 3 * _SQ15) / 60))
A2 = ((-1 / 24, 2 / 24, 23 / 24),
      (-1 / 24, 26 / 24, -1 / 24),
      (23 / 24, 2 / 24, -1 / 24))
A3 = (((2 + 3 * _SQ15) / 60, (-4 - 12 * _SQ15) / 60, (62 + 9 * _SQ15) / 60),
      ((2 - 3 * _SQ15) / 60, 56 / 60, (2 + 3 * _SQ15) / 60),
      ((62 - 9 * _SQ15) / 60, (-4 + 12 * _SQ15) / 60, (2 - 3 * _SQ15) / 60))


def _beta(kind, p0, p1, p2):
    d2 = p0 - 2 * p1 + p2
    if kind == "left":
        d1 = p0 - 4 * p1 + 3 * p2
    elif kind == "center":
        d1 = p0 - p2
    else:
        d1 = 3 * p0 - 4 * p1 + p2
    return (13.0 / 12.0) * d2 * d2 + 0.25 * d1 * d1


def _weights(b0, b1, b2, g):
    a0 = g[0] / (b0 + EPS) ** 2
    a1 = g[1] / (b1 + EPS) ** 2
    a2 = g[2] / (b2 + EPS) ** 2
    s = a0 + a1 + a2
    return a0 / s, a1 / s, a2 / s


def centered_weno5_filter(a, axis):
    """The 5-point centred WENO filter of ``a`` along ``axis`` (reads
    outside the padded tensor are 0, as ``shift`` gives)."""
    Qm2, Qm1 = shift(a, -2, axis), shift(a, -1, axis)
    Qp1, Qp2 = shift(a, +1, axis), shift(a, +2, axis)
    S = ((Qm2, Qm1, a), (Qm1, a, Qp1), (a, Qp1, Qp2))

    def recon(A, s):
        return A[s][0] * S[s][0] + A[s][1] * S[s][1] + A[s][2] * S[s][2]

    b0 = _beta("left", *S[0])
    b1 = _beta("center", *S[1])
    b2 = _beta("right", *S[2])
    w1 = _weights(b0, b1, b2, G1)
    w3 = _weights(b0, b1, b2, G3)
    w2p = _weights(b0, b1, b2, G2P)
    w2m = _weights(b0, b1, b2, G2M)
    q1 = sum(w1[s] * recon(A1, s) for s in range(3))
    q3 = sum(w3[s] * recon(A3, s) for s in range(3))
    q2p = sum(w2p[s] * recon(A2, s) for s in range(3))
    q2m = sum(w2m[s] * recon(A2, s) for s in range(3))
    q2 = SIG_P * q2p - SIG_M * q2m
    return q1 / 6 + 2 * q2 / 3 + q3 / 6


# The constants in the order the kernel's table holds them: G1, G3, G2P,
# G2M (3 each), A1, A2, A3 (9 each, row-major), SIG_P, SIG_M, EPS.
FILTER_CONSTANTS = tuple(
    float(c) for c in (*G1, *G3, *G2P, *G2M,
                       *np.ravel(A1), *np.ravel(A2), *np.ravel(A3),
                       SIG_P, SIG_M, EPS))

__all__ = ["centered_weno5_filter", "FILTER_CONSTANTS"]
