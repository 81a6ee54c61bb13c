"""Conservative regridding between grids.

Counterpart of ``oceananigans_tpu/fields/regridding.py``: along each axis
regridded, a destination cell's value is the overlap-weighted mean of the
source cells, W[i_dst, j_src] = |dst_i ∩ src_j| / Δdst_i, applied as a
contraction along that axis on the data's device.
"""

from __future__ import annotations

import numpy as np
import torch


def overlap_matrix(src_faces, dst_faces):
    """W with W @ source cell values = destination cell values (the
    conservative means); a destination cell reaching past the source range
    is renormalised over its covered part."""
    src = np.asarray(src_faces, np.float64)
    dst = np.asarray(dst_faces, np.float64)
    lo = np.maximum(dst[:-1, None], src[None, :-1])
    hi = np.minimum(dst[1:, None], src[None, 1:])
    overlap = np.maximum(hi - lo, 0.0)
    W = overlap / (dst[1:] - dst[:-1])[:, None]
    cover = W.sum(axis=1, keepdims=True)
    return np.where(cover > 1e-12, W / np.maximum(cover, 1e-12), 0.0)


_EQ = {0: "dn,nij->dij", 1: "dn,inj->idj", 2: "dn,ijn->ijd"}


def regrid(data, src_grid, dst_grid, axes=(2,)):
    """Regrid an interior-shaped tensor (or array) conservatively from
    ``src_grid`` to ``dst_grid`` along ``axes``, one axis after another
    (the other extents must match). Grids need ``nodes1d(axis, 'f')``."""
    out = torch.as_tensor(data)
    for axis in axes:
        if src_grid.is_flat(axis) or dst_grid.is_flat(axis):
            continue
        src_f = src_grid.nodes1d(axis, "f")
        dst_f = dst_grid.nodes1d(axis, "f")
        if len(src_f) == src_grid.N[axis]:    # periodic: close the circle
            src_f = np.append(src_f, src_f[0] + src_grid.extent[axis])
        if len(dst_f) == dst_grid.N[axis]:
            dst_f = np.append(dst_f, dst_f[0] + dst_grid.extent[axis])
        W = torch.as_tensor(overlap_matrix(src_f, dst_f), dtype=out.dtype,
                            device=out.device)
        out = torch.einsum(_EQ[axis], W, out)
    return out


def regrid_field(field, dst_grid, axes=(2,)):
    """A Field's interior regridded onto ``dst_grid`` (centre
    locations)."""
    return regrid(field.interior, field.grid, dst_grid, axes)
