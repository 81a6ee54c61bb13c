"""The port's cubed-sphere grid and panel exchange against the JAX package's.

The geometry is float64 numpy on both sides (the port keeps its own copy of
the conformal map and the node construction): connectivity and edge
rotations equal, the nodes and every panel metric within 1e-12 relative.
The exchanges copy values, so they are held bit for bit on random float64
fields: the per-panel slice copies, their gathers (``PanelExchange``) on the
stacked and the concatenated layouts, against JAX's per-panel functions,
its ``build_fast_exchange`` and its ``build_concat_exchange_catform``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu.grids.cubed_sphere as jcs
from oceananigans_tpu.grids.conformal_map import \
    conformal_cubed_sphere_nodes as j_nodes
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.grids.cubed_sphere as tcs
from oceananigans_tpu_torch.grids.conformal_map import (
    conformal_cubed_sphere_nodes, rancic_C, rancic_published_A)

torch.set_num_threads(1)

N, NZ, R = 8, 3, 6.371e6
LOCS = [(a, b, c) for a in "cf" for b in "cf" for c in "cf"]


@pytest.fixture(scope="module")
def grids():
    kw = dict(z=(-1000.0, 0.0), radius=R)
    j = jcs.ConformalCubedSphereGrid((N, N, NZ), dtype=jnp.float64, **kw)
    t = tcs.ConformalCubedSphereGrid((N, N, NZ), dtype=torch.float64,
                                     device="cpu", **kw)
    return j, t


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def test_rancic_coefficients_match_published():
    """The fitted map reproduces Rančić et al. (1996) Table B1's leading
    coefficients (the JAX test's bound, 5e-8)."""
    A, _ = rancic_published_A(rancic_C())
    published = [1.47713062600964, -0.38183510510174, -0.05573058001191,
                 -0.00895883606818, -0.00791315785221, -0.00486625437708]
    for k, ak in enumerate(published):
        assert abs(A[k] - ak) < 5e-8, (k, A[k], ak)


def test_connectivity_and_rotations(grids):
    j, t = grids
    assert t.connectivity == j.connectivity
    assert len(t.connectivity) == 24
    assert set(t.edge_rotations) == set(j.edge_rotations)
    for key, rot in j.edge_rotations.items():
        assert np.array_equal(t.edge_rotations[key], rot), key


@pytest.mark.parametrize("mesh", ["conformal", "elliptic", "equiangular"])
def test_nodes(mesh, grids):
    """The base nodes of each mesh and the extended (halo) corner nodes,
    within 1e-12."""
    if mesh == "conformal":
        for a, b in zip(conformal_cubed_sphere_nodes(N), j_nodes(N)):
            assert np.max(np.abs(a - b)) <= 1e-12
        j, t = grids
    else:
        j = jcs.ConformalCubedSphereGrid((N, N), mesh=mesh,
                                         dtype=jnp.float64)
        t = tcs.ConformalCubedSphereGrid((N, N), mesh=mesh, device="cpu",
                                         dtype=torch.float64)
    for a, b in zip(t.extended_nodes, j.extended_nodes):
        assert np.max(np.abs(a - b)) <= 1e-12


@pytest.mark.parametrize("name", ["dx", "dy", "Az", "V", "Ax", "Ay"])
def test_panel_metrics(name, grids):
    """Every panel's metric at every staggering over the padded extent
    (exact halo metrics), and the padded (λ, φ) nodes, within 1e-12."""
    j, t = grids
    for jp, tp in zip(j.panel_grids, t.panel_grids):
        assert tp.padded_shape == jp.padded_shape
        assert tp.topology == ("fully_connected", "fully_connected",
                               "bounded")
        for loc in LOCS:
            want = np.broadcast_to(np.asarray(getattr(jp, name)(loc)),
                                   jp.padded_shape)
            got = getattr(tp, name)(loc)
            got = np.broadcast_to(got.numpy() if torch.is_tensor(got)
                                  else got, tp.padded_shape)
            assert _rel(got, want) <= 1e-12, (name, loc)
        for loc in (("c", "c"), ("f", "c"), ("c", "f"), ("f", "f")):
            for a, b in zip(tp.nodes2d_padded(loc), jp.nodes2d_padded(loc)):
                assert np.max(np.abs(a - b)) <= 1e-10


def test_total_area(grids):
    """The panels' interior cell areas tile the sphere: 4πR² to 1e-12."""
    _, t = grids
    total = sum(g.Az(("c", "c", "c"))[g.interior_slices[:2]].sum().item()
                for g in t.panel_grids)
    assert abs(total / (4 * np.pi * R ** 2) - 1) < 1e-12


def _fields(t, k, nz=5, seed=0):
    rng = np.random.default_rng(seed)
    shape = (6,) + t.panel_grids[0].padded_shape[:2] + (nz,)
    return [rng.standard_normal(shape) for _ in range(k)]


def test_center_exchange_bitwise(grids):
    j, t = grids
    (a,) = _fields(t, 1)
    want = np.asarray(jcs.fill_cubed_sphere_halos(jnp.asarray(a), j))
    got = tcs.fill_cubed_sphere_halos(torch.as_tensor(a), t)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(t.exchange.centers(torch.as_tensor(a)).numpy(),
                          want)
    one = np.asarray(jcs.fill_cubed_sphere_halos(jnp.asarray(a), j,
                                                 passes=1))
    assert np.array_equal(
        t.exchange.centers(torch.as_tensor(a), passes=1).numpy(), one)


def test_velocity_exchange_and_sync_bitwise(grids):
    j, t = grids
    u, v = _fields(t, 2, seed=1)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.as_tensor(u), torch.as_tensor(v)
    su, sv = jcs.sync_shared_velocity_faces(ju, jv, j)
    for got, want in zip(tcs.sync_shared_velocity_faces(tu, tv, t), (su, sv)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(t.exchange.sync(tu, tv), (su, sv)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    fu, fv = jcs.fill_cubed_sphere_velocity_halos(su, sv, j)
    for got, want in zip(tcs.fill_cubed_sphere_velocity_halos(
            *tcs.sync_shared_velocity_faces(tu, tv, t), t), (fu, fv)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    _, exuv = jcs.build_fast_exchange(j)
    for got, want in zip(t.exchange.velocities(tu, tv), exuv(ju, jv)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_concatenated_exchange_bitwise(grids):
    """The gathers on the (6·NP, NP, NZ) view against JAX's
    build_concat_exchange_catform, both passes and the single pass."""
    j, t = grids
    a, u, v = _fields(t, 3, seed=2)
    NP = t.panel_grids[0].padded_shape[0]
    cat = lambda x: x.reshape((6 * NP,) + x.shape[2:])  # noqa: E731
    exc, exuv, sync = jcs.build_concat_exchange_catform(j)
    ja, ju, jv = (jnp.asarray(cat(x)) for x in (a, u, v))
    ta, tu, tv = (torch.as_tensor(cat(x)) for x in (a, u, v))
    ex = t.exchange
    assert np.array_equal(ex.centers(ta).numpy(), np.asarray(exc(ja)))
    assert np.array_equal(ex.centers(ta, passes=1).numpy(),
                          np.asarray(exc.single_pass(ja)))
    for mine, theirs in ((ex.velocities(tu, tv), exuv(ju, jv)),
                         (ex.velocities(tu, tv, passes=1),
                          exuv.single_pass(ju, jv)),
                         (ex.sync(tu, tv), sync(ju, jv))):
        for got, want in zip(mine, theirs):
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_concat_panels_grid(grids):
    """The concatenated grid's metrics against JAX's ConcatPanelsGrid."""
    j, t = grids
    jc = jcs.ConcatPanelsGrid(j.panel_grids)
    tc = tcs.concat_panels_grid(t.panel_grids)
    assert tc.padded_shape == jc.padded_shape and tc.N == jc.N
    assert tc.interior_slices == jc.interior_slices
    for name in ("dx", "dy", "dz", "Az", "V"):
        for loc in LOCS:
            want = np.broadcast_to(np.asarray(getattr(jc, name)(loc)),
                                   jc.padded_shape)
            got = getattr(tc, name)(loc)
            got = np.broadcast_to(got.numpy() if torch.is_tensor(got)
                                  else got, tc.padded_shape)
            assert _rel(got, want) <= 1e-12, (name, loc)


def test_device_policy():
    """Built without device=, the grid lives on the card; with no card it
    raises, as the port's other grids do."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.ConformalCubedSphereGrid((4, 4))
    assert ot.ConformalCubedSphereGrid is tcs.ConformalCubedSphereGrid


def test_fully_connected_axes(grids):
    """A panel's x and y are FULLY_CONNECTED: no lateral condition (a user
    one raises), the fill keeps them (its plan's x and y codes are KEEP on
    the concatenated grid, whose x extent holds every panel's halos) and
    fills z, and the advection cascade and the operators treat them as
    unbounded."""
    from oceananigans_tpu_torch.advection.schemes import _axis_bounded
    from oceananigans_tpu_torch.boundary_conditions import (
        regularize_field_boundary_conditions as reg)
    from oceananigans_tpu_torch.kernels import halo_fill as hf
    _, t = grids
    g = t.panel_grids[0]
    bcs = reg(None, g, ("c", "c", "c"))
    assert all(bcs.side(s) is None for s in ("west", "east", "south",
                                             "north"))
    assert bcs.side("bottom") is not None
    with pytest.raises(ValueError, match="fully_connected"):
        reg(ot.FieldBoundaryConditions(west=ot.ValueBoundaryCondition(1.0)),
            g, ("c", "c", "c"))
    cat = tcs.concat_panels_grid(t.panel_grids)
    lbs = [(loc, reg(None, cat, loc)) for loc in LOCS[:4]]
    for codes in hf.fill_codes(cat, cat.padded_shape, lbs, len(lbs)):
        assert codes[0][0] == codes[1][0] == hf.KEEP
        assert codes[2][0] != hf.KEEP
    assert not _axis_bounded(cat, 0) and not _axis_bounded(cat, 1)
    a = torch.randn(cat.padded_shape, dtype=torch.float64)
    b = a.clone()
    ot.boundary_conditions.fill_all_halo_regions([b], cat, [lbs[0]])
    hz, nz = cat.H[2], cat.N[2]
    assert torch.equal(a[..., hz:hz + nz], b[..., hz:hz + nz])
    assert not torch.equal(a, b)
