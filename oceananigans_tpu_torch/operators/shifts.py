"""Index-shift primitive for stencil operators on halo-padded tensors.

Counterpart of ``oceananigans_tpu/operators/shifts.py``. ``shift(a, s, axis)``
returns a tensor of the same shape with ``out[i] = a[i + s]``; slots that
would read out of range are zero-filled. Those slots are always in the
outermost halo ring, so with a halo at least as wide as the stencil radius
they never reach the interior. ``shift_zbc`` is the halo-free bounded-z
variant: out-of-range reads take the values the boundary halo would carry.
"""

from __future__ import annotations

import torch


def shift(a, s, axis):
    """out[i] = a[i + s] along ``axis``; zero-fill out-of-range (halo-only)."""
    if s == 0:
        return a
    n = a.shape[axis]
    out = torch.zeros_like(a)
    m = n - abs(s)
    if m <= 0:
        return out
    if s > 0:
        out.narrow(axis, 0, m).copy_(a.narrow(axis, s, m))
    else:
        out.narrow(axis, -s, m).copy_(a.narrow(axis, 0, m))
    return out


def _plane(a, axis, k):
    return a.narrow(axis, k, 1)


def shift_zbc(a, s, axis, kind, n=None):
    """``shift`` for a HALO-FREE bounded axis: out-of-range reads are fixed
    up with the boundary-condition values the halo would have carried.

    - ``"even"``     mirror about the boundary faces (the default no-flux
      fill of center-located fields): a[-1-m] = a[m], a[N+m] = a[N-1-m].
    - ``"odd_face"`` face-located field pinned to 0 on the boundary faces
      with odd reflection (w): a[-m] = -a[m], a[N] = 0, a[N+m] = -a[N-m].
    """
    out = shift(a, s, axis)
    if s == 0 or kind is None:
        return out
    if n is None:
        n = a.shape[axis]
    if kind == "even":
        if s < 0:
            for k in range(-s):
                out.narrow(axis, k, 1).copy_(_plane(a, axis, -(k + s) - 1))
        else:
            for k in range(n - s, n):
                out.narrow(axis, k, 1).copy_(_plane(a, axis, 2 * n - 1 - (k + s)))
        return out
    if kind == "odd_face":
        if s < 0:
            for k in range(-s):
                src = -(k + s)
                dst = out.narrow(axis, k, 1)
                if src < n:
                    dst.copy_(-_plane(a, axis, src))
                else:
                    dst.zero_()
        else:
            for k in range(n - s, n):
                tgt = k + s
                dst = out.narrow(axis, k, 1)
                if tgt == n:
                    dst.zero_()
                else:
                    dst.copy_(-_plane(a, axis, 2 * n - tgt))
        return out
    raise ValueError(f"unknown zbc kind {kind!r}")
