"""The one-launch halo fill (``kernels/halo_fill.py`` ``fill_halos``) on the
CPU: its design, each written slot formed from one read-only slot, held
against the sequential fill it replaces.

- ``evaluate`` mirrors the kernel (``csrc/halo_fill.cu``): per axis it maps
  each slot to a source slot and an operation (``map_at``), then forms every
  slot as Fz(Fy(Fx(a[sx, sy, sz]))) from the untouched input, in the plain
  version's arithmetic; the tripolar fold couples x and y (a slot first
  takes its x map into the interior, then folds), and a polar cap takes the
  zonal mean of the boundary row at its z source. It takes the codes and
  the float64 geometry the kernel's parameter block is built from
  (``fill_codes``, ``axis_geometry``) and is held bit for bit against the
  sequential plain fill (the fold, bounded x, the periodic wrap, bounded
  y, bounded z), in float32 and float64, over periodic and bounded x and y,
  a bounded z with a halo, the z-compact Hz = 0 and 2-D surfaces, the four
  locations, Flux, Open, Value and Gradient on every side with nonzero
  values, N from below H (the narrow slots that keep their value) to
  larger than H + 1, on rectilinear and lat-lon grids
  (``tests/test_torch_global.py`` holds it on the fold and the polar caps).
- the port's fill against the JAX ``fill_halo_regions`` (its XLA path on
  the CPU): 1e-14 relative in float64; on an axis narrower than its halo
  needs, the slots where the two differ are exactly the narrow slots.
- what the kernel refuses raises.
The CUDA kernel itself is held against the plain fill on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu as jo
from oceananigans_tpu.boundary_conditions import (
    FieldBoundaryConditions as JFBC, FluxBoundaryCondition as JFlux,
    GradientBoundaryCondition as JGrad, ValueBoundaryCondition as JValue,
    fill_halo_regions as j_fill, regularize_field_boundary_conditions as j_reg)
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.boundary_conditions import (
    BoundaryCondition, FieldBoundaryConditions, fill_all_halo_regions,
    regularize_field_boundary_conditions)
from oceananigans_tpu_torch.boundary_conditions import boundary_condition as bcm
from oceananigans_tpu_torch.kernels import halo_fill as hf

torch.set_num_threads(1)

LOCS = {"ccc": ("c", "c", "c"), "fcc": ("f", "c", "c"),
        "cfc": ("c", "f", "c"), "ccf": ("c", "c", "f")}
CLASSES = (bcm.FLUX, bcm.OPEN, bcm.VALUE, bcm.GRADIENT)
SIDES = ("west", "east", "south", "north", "bottom", "top")
H = (3, 2, 3)


def rotated_bcs(r):
    """Every side a classification, rotated by ``r``, with nonzero values;
    four rotations put each classification on each side."""
    return FieldBoundaryConditions(**{
        side: BoundaryCondition(CLASSES[(s + r) % 4],
                                0.1 * (s + 1) * (-1) ** s)
        for s, side in enumerate(SIDES)})


# -- the kernel's maps, slot by slot ---------------------------------------------

COPY, PIN, ODD, VALUE_LO, VALUE_HI, GRAD_LO, GRAD_HI, FOLD_ROW, SUBST_ROW = \
    range(9)


def side_map(codes, N, Hh, P, half, dist, n):
    """(source index, operation, v, half, dist, polar side) of slot ``n``
    under its side's map, as ``side_map`` in csrc/halo_fill.cu (v = 0 for a
    polar cap, whose value comes from the zonal mean)."""
    lo, hi = hf.kept_range(codes, N, Hh, P)
    if lo <= n < hi:
        return n, COPY, 0.0, 1.0, 0.0, None
    E = Hh + N
    if n < lo:
        c, v = codes[0], codes[1]
        if c == hf.WRAP:
            return n + N, COPY, 0.0, 1.0, 0.0, None
        if c == hf.MIRROR:
            return 2 * Hh - 1 - n, COPY, 0.0, 1.0, 0.0, None
        if c in (hf.EXTRAPOLATE_VALUE, hf.POLAR_VALUE):
            return (Hh, VALUE_LO, v, half[0], dist[0][n],
                    0 if c == hf.POLAR_VALUE else None)
        if c == hf.EXTRAPOLATE_GRADIENT:
            return Hh, GRAD_LO, v, 1.0, dist[0][n], None
        if c in hf.PINS:
            polar = 0 if c == hf.POLAR_PINNED else None
            return ((n, PIN, v, 1.0, 0.0, polar) if n == Hh
                    else (2 * Hh - n, ODD, 2.0 * v, 1.0, 0.0, polar))
        return 2 * Hh - n, COPY, 0.0, 1.0, 0.0, None
    c, v = codes[2], codes[3]
    if c == hf.WRAP:
        return n - N, COPY, 0.0, 1.0, 0.0, None
    if c == hf.MIRROR:
        return 2 * E - 1 - n, COPY, 0.0, 1.0, 0.0, None
    if c in (hf.EXTRAPOLATE_VALUE, hf.POLAR_VALUE):
        return (E - 1, VALUE_HI, v, half[1], dist[1][n - E],
                1 if c == hf.POLAR_VALUE else None)
    if c == hf.EXTRAPOLATE_GRADIENT:
        return E - 1, GRAD_HI, v, 1.0, dist[1][n - E], None
    if c in hf.PINS:
        polar = 1 if c == hf.POLAR_PINNED else None
        return ((n, PIN, v, 1.0, 0.0, polar) if n == E
                else (2 * E - n, ODD, 2.0 * v, 1.0, 0.0, polar))
    if c == hf.FOLD:
        return ((n, SUBST_ROW, v, 1.0, 0.0, None) if n == E - 1
                else (2 * E - 2 - n, FOLD_ROW, v, 1.0, 0.0, None))
    if c == hf.FOLD_FACE:
        return 2 * E - 1 - n, FOLD_ROW, v, 1.0, 0.0, None
    return 2 * E - n, COPY, 0.0, 1.0, 0.0, None


def map_at(codes, N, Hh, P, half, dist, n):
    """The kernel's map of slot ``n`` along one axis (``map_at`` in
    csrc/halo_fill.cu): its side's, or the identity where that reads a slot
    the axis writes (a bounded axis narrower than its halo needs)."""
    m = side_map(codes, N, Hh, P, half, dist, n)
    lo, hi = hf.kept_range(codes, N, Hh, P)
    if m[1] not in (PIN, SUBST_ROW) and not lo <= m[0] < hi:
        return n, COPY, 0.0, 1.0, 0.0, None
    return m


def apply(r, op, v, half, dist):
    """One axis's maps on every slot at once: ``op``, ``v``, ``half`` and
    ``dist`` broadcast along their axis (v, half, dist rounded to r's
    dtype, as the kernel rounds them)."""
    out = r
    for code, value in (
            (PIN, v.expand_as(r)), (ODD, v - r),
            (VALUE_LO, r - (r - v) / half * dist),
            (VALUE_HI, r + (v - r) / half * dist),
            (GRAD_LO, r - v * dist), (GRAD_HI, r + v * dist)):
        out = torch.where(op == code, value, out)
    return out


def evaluate(grid, a, loc, bcs, z=True):
    """The kernel's result for one field: every slot from one load of the
    untouched input, the x, y and z maps applied in order. A fold row reads
    the folded x of its x source times the sign; a polar cap's v is the
    zonal mean at the slot's z source."""
    codes = hf.fill_codes(grid, a.shape, [(loc, bcs)], z=z)[0]
    geom = hf.axis_geometry(grid, a.shape)
    maps = [[map_at(codes[ax], N, Hh, P, half, dist, n) for n in range(P)]
            for ax, (N, Hh, P, half, dist) in enumerate(geom)]
    (PX, PY, PZ) = (g[2] for g in geom)
    Nx, Hx = geom[0][0], geom[0][1]
    sx = torch.tensor([m[0] for m in maps[0]])[:, None].repeat(1, PY)
    sy = torch.tensor([m[0] for m in maps[1]])[None, :].repeat(PX, 1)
    sz = torch.tensor([m[0] for m in maps[2]])
    sign = torch.ones((PX, PY), dtype=a.dtype)
    for j, m in enumerate(maps[1]):
        if m[1] not in (FOLD_ROW, SUBST_ROW):
            continue
        for i in range(PX):
            i0 = int(sx[i, j]) - Hx
            if m[1] == SUBST_ROW and i0 < Nx // 2:
                continue
            wrap = loc[0] == "f" and i0 == 0
            sx[i, j] = Hx + ((0 if wrap else Nx - i0) if loc[0] == "f"
                             else Nx - 1 - i0)
            sign[i, j] = abs(m[2]) if wrap else m[2]
    r = a[sx[:, :, None], sy[:, :, None], sz[None, None, :]] \
        * sign[:, :, None]
    means = torch.cat([hf.polar_row_mean(grid, a, True),
                       hf.polar_row_mean(grid, a, False)], 1)[0]
    for ax, ms in enumerate(maps):
        shape = [1, 1, 1]
        shape[ax] = len(ms)
        op = torch.tensor([COPY if m[1] in (FOLD_ROW, SUBST_ROW) else m[1]
                           for m in ms]).reshape(shape)
        v, hv, dv = (torch.tensor([m[k] for m in ms],
                                  dtype=a.dtype).reshape(shape)
                     for k in (2, 3, 4))
        if ax == 1 and any(m[5] is not None for m in ms):
            # the polar caps' v: the mean at each slot's z source
            v = v.expand(1, PY, PZ).clone()
            for j, m in enumerate(ms):
                if m[5] is not None:
                    mean = means[m[5]][sz]
                    v[0, j] = 2 * mean if m[1] == ODD else mean
        r = apply(r, op, v, hv, dv)
    return r


def _grid(kind, topo, N, z_halo, dtype):
    halo = H[:2] + ((H[2],) if z_halo else (0,))
    if kind == "latlon":
        lon = (0.0, 360.0) if topo[0] == "P" else (0.0, 60.0)
        return ot.LatitudeLongitudeGrid(size=N, longitude=lon,
                                        latitude=(15, 75), z=(-1800.0, 0.0),
                                        halo=halo, dtype=dtype, device="cpu")
    topology = tuple("periodic" if t == "P" else "bounded" for t in topo) \
        + ("bounded",)
    return ot.RectilinearGrid(size=N, x=(0.0, 2.0), y=(-1.0, 1.0),
                              z=(-3.0, 0.0), topology=topology, halo=halo,
                              dtype=dtype, device="cpu")


GRIDS = [("rect", t) for t in ("PP", "PB", "BP", "BB")] \
    + [("latlon", t) for t in ("PB", "BB")]
ZKINDS = ("z_halo", "z_compact", "surface")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("size", ["n_h_plus_1", "larger", "n_eq_h",
                                  "n_lt_h"])
@pytest.mark.parametrize("zkind", ZKINDS)
@pytest.mark.parametrize("kind,topo", GRIDS, ids=[f"{k}-{t}" for k, t in GRIDS])
def test_maps_match_sequential_fill(kind, topo, zkind, size, dtype):
    """Each slot from one load through the x, y and z maps equals the
    sequential plain fill, bit for bit; on a bounded axis narrower than its
    halo needs (N = H, and N = H - 1) the narrow slots keep their value in
    both."""
    N = {"n_h_plus_1": tuple(h + 1 for h in H), "larger": (9, 7, 6),
         "n_eq_h": H,
         "n_lt_h": tuple(h if t == "P" else h - 1
                         for h, t in zip(H, topo + "B"))}[size]
    grid = _grid(kind, topo, N, zkind == "z_halo", dtype)
    shape = grid.padded_shape
    if zkind == "surface":
        shape = shape[:2] + (1,)
    gen = torch.Generator().manual_seed(7)
    for loc in LOCS.values():
        for r in range(4):
            bcs = rotated_bcs(r)
            a = torch.randn(shape, generator=gen, dtype=dtype)
            want = hf.fill_halos_plain(grid, [a.clone()], [(loc, bcs)])[0]
            assert torch.equal(evaluate(grid, a, loc, bcs), want), (loc, r)
            got = hf.fill_halos(grid, [a.clone()], [(loc, bcs)])[0]
            assert torch.equal(got, want), (loc, r)


@pytest.mark.parametrize("zkind", ["z_halo", "surface"])
@pytest.mark.parametrize("kind,topo", [("rect", "PB"), ("latlon", "BB")],
                         ids=["rect-PB", "latlon-BB"])
def test_xy_only_maps(kind, topo, zkind):
    """With z left alone (the hydrostatic pressure's and the surfaces'
    fills), the maps still match the sequential fill bit for bit."""
    grid = _grid(kind, topo, (9, 7, 6), True, torch.float64)
    shape = grid.padded_shape[:2] + ((1,) if zkind == "surface"
                                     else grid.padded_shape[2:])
    a = torch.randn(shape, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    for loc in LOCS.values():
        bcs = rotated_bcs(2)
        want = hf.fill_halos_plain(grid, [a.clone()], [(loc, bcs)], z=False)
        assert torch.equal(evaluate(grid, a, loc, bcs, z=False), want[0])


def test_periodic_only_maps():
    """Without conditions only the periodic axes are filled: the wrap."""
    grid = _grid("rect", "PB", (9, 7, 6), True, torch.float64)
    a = torch.randn(grid.padded_shape, dtype=torch.float64)
    b = hf.periodic_halo_fill(grid, [a.clone()])[0]
    want = hf.periodic_halo_fill_plain(grid, [a.clone()])[0]
    assert torch.equal(b, want)
    assert torch.equal(b[3:-3, :2], a[3:-3, :2])


def test_extrapolated_slots():
    """The slots a check on the card holds to roundoff are exactly those
    where the plain fill's result moves with the Value conditions (random
    values per side, so that no two sides' changes cancel in a corner)."""
    grid = _grid("rect", "BB", (9, 7, 6), True, torch.float64)
    a = torch.randn(grid.padded_shape, dtype=torch.float64)
    loc = LOCS["ccc"]
    rng = np.random.default_rng(5)
    bcs = [FieldBoundaryConditions(**{s: BoundaryCondition(bcm.VALUE, v)
                                      for s, v in zip(SIDES, rng.random(6))})
           for _ in range(2)]
    outs = [hf.fill_halos_plain(grid, [a.clone()], [(loc, b)])[0]
            for b in bcs]
    mask = hf.extrapolated_slots(grid, a.shape, [(loc, bcs[0])])[0]
    assert torch.equal(outs[0] != outs[1], mask)


# -- against the JAX package -----------------------------------------------------

def _jax_bcs(r, J, topology):
    """Value, Gradient and Flux conditions rotated over the bounded sides;
    None (the default: impenetrable for a wall-normal face field) for the
    fourth."""
    mk = [(JValue, ot.ValueBoundaryCondition),
          (JGrad, ot.GradientBoundaryCondition),
          (JFlux, ot.FluxBoundaryCondition), None]
    sides = {}
    for s, side in enumerate(SIDES):
        if topology[s // 2] != "bounded":
            continue
        pick = mk[(s + r) % 4]
        if pick is not None:
            sides[side] = pick[0 if J else 1](0.1 * (s + 1) * (-1) ** s)
    return (JFBC if J else FieldBoundaryConditions)(**sides)


JAX_GRIDS = {
    "latlon_box": dict(cls="LatitudeLongitudeGrid", size=(10, 8, 6),
                       longitude=(0.0, 60.0), latitude=(15, 75),
                       z=(-1800.0, 0.0), halo=(3, 3, 3)),
    "periodic_rect": dict(cls="RectilinearGrid", size=(10, 8, 6),
                          extent=(1.0, 2.0, 3.0), halo=(3, 3, 3)),
}


@pytest.mark.parametrize("loc", list(LOCS), ids=list(LOCS))
@pytest.mark.parametrize("name", list(JAX_GRIDS))
def test_fill_against_jax(name, loc):
    """The port's fill (every axis) against JAX fill_halo_regions:
    1e-14 relative in float64."""
    spec = dict(JAX_GRIDS[name])
    cls = spec.pop("cls")
    jg = getattr(jo, cls)(dtype=np.float64, **spec)
    tg = getattr(ot, cls)(dtype=torch.float64, device="cpu", **spec)
    lc = LOCS[loc]
    rng = np.random.default_rng(17)
    for r in range(4):
        a = rng.standard_normal(tg.padded_shape)
        jb = j_reg(_jax_bcs(r, True, tg.topology), jg, lc)
        tb = regularize_field_boundary_conditions(
            _jax_bcs(r, False, tg.topology), tg, lc)
        want = np.asarray(j_fill(jnp.asarray(a), jg, lc, jb))
        got = fill_all_halo_regions([torch.as_tensor(a.copy())], tg,
                                    [(lc, tb)])[0].numpy()
        assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max(), r


# -- what the kernel refuses -----------------------------------------------------

@pytest.mark.parametrize("case", ["bounded_h_gt_max", "fold_bounded_x",
                                  "periodic_y_n_lt_h", "periodic_z"])
def test_refused(case):
    """A bounded axis with H > MAX_H, a fold without a periodic x and a
    periodic axis with N < H raise, on the CPU as on the card. A periodic z
    with conditions other than periodic, refused before item 3 was closed,
    wraps as JAX's fill does: the kernel's maps equal the wrap of its
    periodic conditions (``test_periodic_z_wraps``)."""
    topology = {"bounded_h_gt_max": ("bounded", "periodic", "bounded"),
                "fold_bounded_x": ("bounded", "bounded", "bounded"),
                "periodic_y_n_lt_h": ("periodic", "periodic", "bounded"),
                "periodic_z": ("periodic", "periodic", "periodic")}[case]
    size = {"bounded_h_gt_max": (12, 8, 8), "fold_bounded_x": (8, 8, 8),
            "periodic_y_n_lt_h": (8, 2, 8), "periodic_z": (8, 8, 8)}[case]
    halo = (9, 3, 3) if case == "bounded_h_gt_max" else (3, 3, 3)
    grid = ot.RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                              topology=topology, halo=halo,
                              dtype=torch.float64, device="cpu")
    loc = LOCS["ccc"]
    given = (FieldBoundaryConditions(north=bcm.ZipperBoundaryCondition(1.0))
             if case == "fold_bounded_x" else None)
    bcs = regularize_field_boundary_conditions(given, grid, loc)
    if case == "periodic_z":
        # a Flux condition on a periodic z side (regularizing refuses it, so
        # the conditions are built as they are)
        bcs = FieldBoundaryConditions(**{
            side: (BoundaryCondition(bcm.FLUX, 0.5) if side == "bottom"
                   else bcs.side(side)) for side in SIDES})
    a = torch.zeros(grid.padded_shape, dtype=torch.float64)
    if case == "periodic_z":
        periodic = regularize_field_boundary_conditions(None, grid, loc)
        assert hf.fill_codes(grid, grid.padded_shape, [(loc, bcs)]) == \
            hf.fill_codes(grid, grid.padded_shape, [(loc, periodic)])
        return
    with pytest.raises(ValueError):
        hf.fill_halos(grid, [a], [(loc, bcs)])


@pytest.mark.parametrize("loc", list(LOCS), ids=list(LOCS))
def test_narrow_axis_against_jax(loc):
    """On bounded axes narrower than their halos (N = 2, H = 3: the JAX
    fill takes any N), the port's fill equals the JAX fill_halo_regions
    (1e-14 relative) outside the narrow slots, where JAX reads a source its
    fill writes; there the two differ, and the port keeps the slot's own
    value along that axis."""
    spec = dict(size=(2, 2, 2), x=(0.0, 1.0), y=(0.0, 2.0), z=(-3.0, 0.0),
                topology=("bounded",) * 3, halo=(3, 3, 3))
    jg = jo.RectilinearGrid(dtype=np.float64, **spec)
    tg = ot.RectilinearGrid(dtype=torch.float64, device="cpu", **spec)
    lc = LOCS[loc]
    rng = np.random.default_rng(29)
    differs = False
    for r in range(4):
        a = rng.standard_normal(tg.padded_shape)
        jb = j_reg(_jax_bcs(r, True, tg.topology), jg, lc)
        tb = regularize_field_boundary_conditions(
            _jax_bcs(r, False, tg.topology), tg, lc)
        want = np.asarray(j_fill(jnp.asarray(a), jg, lc, jb))
        got = fill_all_halo_regions([torch.as_tensor(a.copy())], tg,
                                    [(lc, tb)])[0].numpy()
        codes = hf.fill_codes(tg, a.shape, [(lc, tb)])[0]
        mask = np.zeros(a.shape, bool)
        for ax in range(3):
            for n in hf.narrow_slots(codes[ax], tg.N[ax], tg.H[ax]):
                mask[(slice(None),) * ax + (n,)] = True
        assert mask.any()
        assert np.abs(got - want)[~mask].max() <= 1e-14 * np.abs(want).max()
        differs |= bool((got != want)[mask].any())
    assert differs
