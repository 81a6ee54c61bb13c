"""The port's abstract operations, function fields and diagnostic
operations against the JAX package, on the CPU.

Every case of the JAX package's tests/test_field_algebra.py,
tests/test_conditional_reductions.py and tests/test_diagnostic_operations.py
runs on both packages with the same inputs: the port's results pass the JAX
test's own checks and equal JAX's, float64, to 1e-12 relative to max|JAX|
(absolute below 1e-12). Each scenario is written once and takes the package
(``ot`` or ``J``) as its argument.
"""

import numpy as np
import pytest
import torch

import oceananigans_tpu as J
import oceananigans_tpu.abstract_operations  # noqa: F401
import oceananigans_tpu.fields.field  # noqa: F401
import oceananigans_tpu.grids.orthogonal_spherical_shell  # noqa: F401
import oceananigans_tpu.immersed  # noqa: F401
import oceananigans_tpu.models.diagnostic_operations  # noqa: F401
import oceananigans_tpu_torch as ot
import oceananigans_tpu_torch.abstract_operations  # noqa: F401
import oceananigans_tpu_torch.fields.field  # noqa: F401
import oceananigans_tpu_torch.grids.orthogonal_spherical_shell  # noqa: F401
import oceananigans_tpu_torch.immersed  # noqa: F401
import oceananigans_tpu_torch.models.diagnostic_operations  # noqa: F401

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12
LOC_CCC, LOC_FCC = ("c", "c", "c"), ("f", "c", "c")


def _kw(pkg):
    return {"device": "cpu", "dtype": F64} if pkg is ot else \
        {"dtype": np.float64}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _grid(pkg, **kw):
    return pkg.RectilinearGrid(**kw, **_kw(pkg))


def _neg(pkg):
    return torch.neg if pkg is ot else (lambda a: -a)


def _both(scenario, *args):
    """The scenario's results on the port and on JAX, as numpy."""
    got = {k: _np(v) for k, v in scenario(ot, *args).items()}
    want = {k: _np(v) for k, v in scenario(J, *args).items()}
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        scale = max(1.0, float(np.max(np.abs(want[k]))) if want[k].size
                    else 1.0)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=TOL * scale, err_msg=k)
    return got


# -- tests/test_field_algebra.py ----------------------------------------------

def _algebra_grid(pkg):
    return _grid(pkg, size=(8, 8, 4), extent=(1.0, 1.0, 1.0),
                 topology=("periodic", "periodic", "bounded"))


def _scalar_broadcasting(pkg):
    c = pkg.CenterField(_algebra_grid(pkg))
    c.set(lambda x, y, z: x)
    exprs = dict(add=c + 1, radd=1 + c, rmul=2 * c, div=c / 2, rsub=1 - c,
                 pow=c ** 2, neg=-c, abs=abs(c - 0.5))
    out = {k: e.compute().interior for k, e in exprs.items()}
    out["c"] = c.interior
    return out


def test_scalar_broadcasting_both_sides():
    r = _both(_scalar_broadcasting)
    ci = r["c"]
    for k, want in dict(add=ci + 1, radd=ci + 1, rmul=2 * ci, div=ci / 2,
                        rsub=1 - ci, pow=ci ** 2, neg=-ci,
                        abs=np.abs(ci - 0.5)).items():
        assert np.allclose(r[k], want), k


def _mixed_product(pkg):
    g = _algebra_grid(pkg)
    c, u = pkg.CenterField(g), pkg.XFaceField(g)
    c.set(lambda x, y, z: 3.0)
    u.set(lambda x, y, z: np.sin(2 * np.pi * x))
    prod = (c * u).compute()
    assert tuple(prod.loc) == LOC_CCC
    return dict(prod=prod.interior, u=u.data)


def test_mixed_location_product_interpolates():
    r = _both(_mixed_product)
    g = _algebra_grid(ot)
    h, (nx, ny, nz) = g.H, g.N
    up = r["u"]
    mean = 0.5 * (up[h[0]:h[0] + nx] + up[h[0] + 1:h[0] + 1 + nx])
    assert np.allclose(r["prod"],
                       3.0 * mean[:, h[1]:h[1] + ny, h[2]:h[2] + nz],
                       atol=1e-12)


def _nested(pkg):
    g = _algebra_grid(pkg)
    c, u = pkg.CenterField(g), pkg.XFaceField(g)
    c.set(lambda x, y, z: x)
    u.set(lambda x, y, z: 1.0)
    return dict(r=(2 * (c * u) + 1 - c).compute().interior, c=c.interior)


def test_nested_expression_tree():
    r = _both(_nested)
    assert np.allclose(r["r"], 2 * r["c"] + 1 - r["c"])


def _derivatives(pkg):
    ao = pkg.abstract_operations
    g = _algebra_grid(pkg)
    c = pkg.CenterField(g)
    c.set(lambda x, y, z: x)
    dcdx = ao.partial_x(c)
    assert tuple(dcdx.loc)[0] == "f"
    w = pkg.ZFaceField(g)
    w.set(lambda x, y, z: z)
    dwdz = ao.partial_z(w)
    assert tuple(dwdz.loc)[2] == "c"
    return dict(dcdx=dcdx.compute().interior, dwdz=dwdz.compute().interior)


def test_derivative_locations_and_values():
    r = _both(_derivatives)
    assert np.allclose(r["dcdx"][1:-1], 1.0, atol=1e-12)
    assert np.allclose(r["dwdz"][:, :, 1:], 1.0, atol=1e-12)


def _reduction_of_expression(pkg):
    c = pkg.CenterField(_algebra_grid(pkg))
    c.set(lambda x, y, z: x)
    return dict(avg=pkg.Average(c * c).compute(), c=c.interior)


def test_reduction_of_expression():
    r = _both(_reduction_of_expression)
    assert np.isclose(float(r["avg"].squeeze()), (r["c"] ** 2).mean(),
                      atol=1e-12)


def _computed_field_caching(pkg):
    ao = pkg.abstract_operations
    c = pkg.CenterField(_algebra_grid(pkg))
    c.set(lambda x, y, z: 1.0)
    calls = []

    class CountingOp(ao.UnaryOperation):
        def materialize(self):
            calls.append(1)
            return super().materialize()

    f = ao.ComputedField(CountingOp(_neg(pkg), c))
    f.compute(0.0)
    f.compute(0.0)
    counts = [len(calls)]
    f.compute(1.0)
    counts.append(len(calls))
    f.compute()
    counts.append(len(calls))
    return dict(counts=np.array(counts), f=f.interior)


def test_computed_field_caches_by_time():
    r = _both(_computed_field_caching)
    assert list(r["counts"]) == [1, 2, 3]
    assert np.allclose(r["f"], -1.0)


def _lazy(pkg):
    c = pkg.CenterField(_algebra_grid(pkg))
    c.set(lambda x, y, z: 1.0)
    expr = 2 * c
    c.set(lambda x, y, z: 3.0)
    return dict(r=expr.compute().interior)


def test_algebra_is_lazy_until_compute():
    assert np.allclose(_both(_lazy)["r"], 6.0)


def _face_data(pkg, size, **kw):
    grid = _grid(pkg, size=size, extent=(1.0, 1.0, 1.0),
                 topology=("bounded", "periodic", "bounded"), **kw)
    data = pkg.fields.field.set_on_padded(grid, LOC_FCC, lambda x, y, z: x)
    return pkg.Field(grid, LOC_FCC, None, data)


def _trapezoid(pkg):
    f = _face_data(pkg, (8, 4, 4))
    return dict(total=pkg.Integral(f).interior, avg=pkg.Average(f).interior)


def test_integral_on_face_field_is_trapezoidal():
    r = _both(_trapezoid)
    np.testing.assert_allclose(float(r["total"].squeeze()), 0.5, rtol=1e-12)
    np.testing.assert_allclose(float(r["avg"].squeeze()), 0.5, rtol=1e-12)


def _face_mask(pkg):
    f = _face_data(pkg, (4, 4, 4))
    return dict(interior=f.interior, max=f.max())


def test_face_field_reduction_mask_covers_all_faces():
    r = _both(_face_mask)
    assert r["interior"].shape[0] == 5
    np.testing.assert_allclose(r["interior"][-1, 0, 0], 1.0, rtol=1e-12)
    np.testing.assert_allclose(float(r["max"]), 1.0, rtol=1e-12)


def _function_fields(pkg):
    grid = _grid(pkg, size=(4, 4, 4), extent=(1.0, 1.0, 1.0),
                 topology=("periodic", "periodic", "bounded"))
    ff = pkg.FunctionField(LOC_FCC, lambda x, y, z, t: x + t, grid, time=0.0)
    H = grid.H[0]
    first = _np(ff.data)[H:H + 4, H + 1, H + 1]
    ff.at_time(2.0)
    second = _np(ff.data)[H:H + 4, H + 1, H + 1]
    avg = pkg.Average(ff).interior
    c = pkg.ConstantField(0.3)
    assert float(c) == 0.3
    model = pkg.NonhydrostaticModel(grid=grid, advection=None)
    model.set(u=c, v=pkg.ZeroField(), w=pkg.ZeroField())
    return dict(first=first, second=second, avg=avg,
                x=np.asarray(grid.coord_padded(0, "f"))[H:H + 4],
                u=model.field("u").interior,
                one=pkg.OneField().on_grid(grid).interior)


def test_function_field_and_constant_fields():
    r = _both(_function_fields)
    np.testing.assert_allclose(r["first"], r["x"], rtol=1e-6)
    np.testing.assert_allclose(r["second"], r["x"] + 2.0, rtol=1e-6)
    np.testing.assert_allclose(float(r["avg"].squeeze()),
                               np.mean(r["x"]) + 2.0, rtol=1e-6)
    np.testing.assert_allclose(r["u"], 0.3, rtol=1e-6)
    np.testing.assert_allclose(r["one"], 1.0)


def _metric_and_interpolate(pkg):
    grid = _grid(pkg, size=(8, 4, 4), extent=(2.0, 1.0, 1.0),
                 topology=("periodic", "periodic", "bounded"))
    vol = pkg.GridMetricOperation(LOC_CCC, "volume", grid)
    with pytest.raises(ValueError):
        pkg.GridMetricOperation(LOC_CCC, "nope", grid)
    c = pkg.CenterField(grid).set(lambda x, y, z: 2 * x)
    return dict(v=vol.interior, one=pkg.interpolate(c, 0.8, 0.5, -0.5),
                many=pkg.interpolate(c, np.array([0.4, 1.2]),
                                     np.array([0.5, 0.5]),
                                     np.array([-0.5, -0.5])))


def test_grid_metric_operation_and_interpolate():
    r = _both(_metric_and_interpolate)
    np.testing.assert_allclose(r["v"].sum(), 2.0, rtol=1e-6)
    np.testing.assert_allclose(r["v"], 2.0 / 8 * (1.0 / 4) ** 2, rtol=1e-6)
    np.testing.assert_allclose(float(r["one"]), 1.6, rtol=1e-5)
    np.testing.assert_allclose(r["many"], [0.8, 2.4], rtol=1e-5)


# -- tests/test_conditional_reductions.py --------------------------------------

# the port's periodic fill takes N >= H (ROADMAP queue 2, #4 and #5): the
# grids with two cells along a periodic axis take a halo of 2 in both
# packages
H2 = (2, 2, 2)


def _grids(pkg):
    grid = _grid(pkg, size=(6, 2, 2), extent=(1.0, 1.0, 1.0), halo=H2)
    ibg = pkg.immersed.ImmersedBoundaryGrid(
        grid, pkg.immersed.GridFittedBoundary(
            lambda x, y, z: x < 0.5 + 0 * y + 0 * z))
    return grid, ibg


def _poisoned(N):
    c = np.full(N, 2.0)
    c[0], c[1], c[2] = 1e6, -1e4, -12.5
    return c




def _cond(x, y, z):
    return x > 0.5 + 0 * y + 0 * z


def _immersed_reductions(pkg):
    grid, ibg = _grids(pkg)
    fful, fimm = pkg.CenterField(grid), pkg.CenterField(ibg)
    fful.set(2.0)
    fimm.set(_poisoned(grid.N))
    out = dict(length=pkg.conditional_length(fimm))
    for name in ("norm", "mean", "max", "min", "sum", "prod"):
        out["ful_" + name] = getattr(fful, name)()
        out["imm_" + name] = getattr(fimm, name)()
    return out


def test_immersed_reductions_exclude_solid():
    r = _both(_immersed_reductions)
    n = 6 * 2 * 2
    assert int(r["length"]) == n // 2
    assert np.isclose(r["ful_norm"], np.sqrt(2) * r["imm_norm"])
    for name in ("mean", "max", "min"):
        assert np.isclose(r["ful_" + name], r["imm_" + name])
    assert np.isclose(r["ful_sum"], 2 * r["imm_sum"])
    assert np.isclose(r["ful_prod"], r["imm_prod"] * 2.0 ** (n // 2))


def _dimwise(pkg, op):
    grid, ibg = _grids(pkg)
    fful, fimm = pkg.CenterField(grid), pkg.CenterField(ibg)
    fful.set(2.0)
    fimm.set(_poisoned(grid.N))
    R = pkg.abstract_operations.Reduction
    return dict(ful=R(op, fful, dims=0).compute(),
                imm=R(op, fimm, dims=0).compute())


@pytest.mark.parametrize("op", ["mean", "maximum", "minimum"])
def test_immersed_dimwise_reductions(op):
    r = _both(_dimwise, op)
    assert r["ful"].shape == r["imm"].shape == (1, 2, 2)
    assert np.allclose(r["ful"], r["imm"])


def _condition_kwarg(pkg):
    grid, _ = _grids(pkg)
    f = pkg.CenterField(grid)
    f.set(_poisoned(grid.N))
    out = dict(length=pkg.conditional_length(f, condition=_cond))
    for name in ("mean", "max", "min", "sum", "norm"):
        out[name] = getattr(f, name)(condition=_cond)
    out["dimwise"] = pkg.abstract_operations.Reduction(
        "sum", f, dims=0, condition=_cond).compute()
    return out


def test_condition_kwarg_matches_immersed():
    r = _both(_condition_kwarg)
    n = 24
    assert int(r["length"]) == n // 2
    for name in ("mean", "max", "min"):
        assert np.isclose(r[name], 2.0)
    assert np.isclose(r["sum"], 2.0 * (n // 2))
    assert np.isclose(r["norm"], 2.0 * np.sqrt(n // 2))
    assert r["dimwise"].shape == (1, 2, 2)
    assert np.allclose(r["dimwise"], 2.0 * 3)


def _conditional_average(pkg):
    ao = pkg.abstract_operations
    grid, _ = _grids(pkg)
    c = pkg.CenterField(grid)
    c.set(_poisoned(grid.N))
    op = ao.ConditionalOperation(c, _cond, mask_value=0.0)
    return dict(a=ao.Average(c, condition=_cond).compute(),
                a2=ao.Average(op).compute(),
                i=ao.Integral(c, condition=_cond).compute())


def test_conditional_average_normalizes_by_conditional_volume():
    r = _both(_conditional_average)
    assert np.isclose(float(r["a"].squeeze()), 2.0)
    assert np.isclose(float(r["a2"].squeeze()), 2.0)
    assert np.isclose(float(r["i"].squeeze()), 1.0)


def _immersed_average(pkg):
    grid, ibg = _grids(pkg)
    c = pkg.CenterField(ibg)
    c.set(_poisoned(grid.N))
    return dict(a=pkg.Average(c).compute())


def test_average_over_immersed_grid_is_fluid_only():
    assert np.isclose(float(_both(_immersed_average)["a"].squeeze()), 2.0)


ZF = -np.array([1.0, 0.55, 0.3, 0.15, 0.05, 0.0])


def _cumulative_integral(pkg):
    grid = _grid(pkg, size=(2, 2, 5), x=(0, 1), y=(0, 1), z=ZF, halo=H2)
    c = pkg.CenterField(grid)
    c.set(1.0)
    CI = pkg.CumulativeIntegral
    return dict(out=CI(c, dims=2).compute(),
                rev=CI(c, dims=2, reverse=True).compute())


def test_cumulative_integral_on_stretched_z():
    r = _both(_cumulative_integral)
    dz = np.diff(ZF)
    assert r["out"].shape == (2, 2, 5)
    assert np.allclose(r["out"][0, 0], np.cumsum(dz), rtol=1e-6)
    assert np.allclose(r["rev"][0, 0], np.cumsum(dz[::-1])[::-1], rtol=1e-6)


def _accumulation(pkg):
    grid = _grid(pkg, size=(2, 2, 6), extent=(1, 1, 1), halo=H2)
    c = pkg.CenterField(grid)
    c.set(np.broadcast_to(np.arange(6.0), (2, 2, 6)).copy())
    A = pkg.Accumulation
    return dict(fwd=A("cumsum", c, dims=2).compute(),
                rev=A("cumsum", c, dims=2, reverse=True).compute(),
                mx=A("cummax", c, dims=2).compute())


def test_accumulation_reverse_and_cummax():
    r = _both(_accumulation)
    vals = np.arange(6.0)
    assert np.allclose(r["fwd"][0, 0], np.cumsum(vals))
    assert np.allclose(r["rev"][0, 0], np.cumsum(vals[::-1])[::-1])
    assert np.allclose(r["mx"][0, 0], np.maximum.accumulate(vals))


def _masked_accumulation(pkg):
    grid, ibg = _grids(pkg)
    c = pkg.CenterField(ibg)
    c.set(_poisoned(grid.N))
    return dict(out=pkg.Accumulation("cumsum", c, dims=0).compute())


def test_masked_accumulation_uses_neutral_fill():
    assert np.allclose(_both(_masked_accumulation)["out"][-1, 0, 0], 6.0)


def _reduced_field(pkg):
    grid = _grid(pkg, size=(6, 2, 4), extent=(1.0, 1.0, 1.0), halo=H2)
    ibg = pkg.immersed.ImmersedBoundaryGrid(
        grid, pkg.immersed.GridFittedBottom(
            lambda x, y: np.where(x < 1 / 3, 0.0, -1.0)))
    eta3 = pkg.CenterField(ibg)
    eta3.set(2.0)
    eta = pkg.Field(ibg, LOC_CCC, None, eta3.data[:, :, :1],
                    _regularize=False)
    assert tuple(eta.interior.shape) == (6, 2, 1)
    return dict(sum=eta.sum(), mean=eta.mean(), max=eta.max(),
                cmean=eta.mean(condition=_cond),
                csum=eta.sum(condition=_cond))


def test_reduced_field_reductions_on_immersed_grid():
    r = _both(_reduced_field)
    assert np.isclose(r["sum"], 2.0 * 4 * 2)
    assert np.isclose(r["mean"], 2.0)
    assert np.isclose(r["max"], 2.0)
    assert r["cmean"] > 0.0 and np.isclose(r["cmean"], 2.0)
    assert np.isclose(r["csum"], 2.0 * 3 * 2)


def _rotation(pkg):
    shell = pkg.grids.orthogonal_spherical_shell
    g = pkg.RotatedLatitudeLongitudeGrid(
        size=(12, 12, 2), longitude=(-30, 30), latitude=(-25, 25),
        z=(-10, 0), north_pole=(70.0, 30.0), **_kw(pkg))
    rng = np.random.default_rng(7)
    arr = (lambda a: torch.as_tensor(a)) if pkg is ot else np.asarray
    u = arr(rng.standard_normal(g.padded_shape))
    v = arr(rng.standard_normal(g.padded_shape))
    ue, vn = shell.rotate_to_geographic(g, u, v)
    ub, vb = shell.rotate_from_geographic(g, ue, vn)
    ii = g.interior_slices
    return dict(u=_np(u)[ii], v=_np(v)[ii], ub=_np(ub)[ii], vb=_np(vb)[ii],
                s0=_np(u ** 2 + v ** 2)[ii], s1=_np(ue ** 2 + vn ** 2)[ii])


def test_vector_rotation_roundtrip_preserves_magnitude():
    r = _both(_rotation)
    assert np.allclose(r["ub"], r["u"], atol=1e-10)
    assert np.allclose(r["vb"], r["v"], atol=1e-10)
    assert np.allclose(r["s0"], r["s1"], rtol=1e-10)


# -- tests/test_diagnostic_operations.py ---------------------------------------

def _cube(pkg, **kw):
    return _grid(pkg, size=(8, 8, 8), extent=(1.0, 1.0, 1.0),
                 topology=("periodic", "periodic", "bounded"), **kw)


def _forcing_operation(pkg):
    tau = 60.0
    forcing = pkg.forcings.ContinuousForcing(
        lambda x, y, z, t, c: -c / tau, field_dependencies="c")
    model = pkg.NonhydrostaticModel(grid=_cube(pkg), tracers=("c",),
                                    forcing={"c": forcing})
    model.set(c=1.0)
    out = pkg.models.ForcingField("c", model).interior
    model.set(c=2.0)
    with pytest.raises(KeyError):
        pkg.models.ForcingOperation(
            "c", pkg.NonhydrostaticModel(grid=_cube(pkg), tracers=("c",)))
    return dict(out=out, out2=pkg.models.ForcingField("c", model).interior)


def test_forcing_operation_matches_forcing():
    r = _both(_forcing_operation)
    assert r["out"].shape == (8, 8, 8)
    assert np.allclose(r["out"], -1.0 / 60.0)
    assert np.allclose(r["out2"], -2.0 / 60.0)


def _bc_operation(pkg):
    bcs = pkg.boundary_conditions
    flux = lambda x, y, t: 1e-4 * np.cos(2 * np.pi * x)
    grid = _cube(pkg)
    model = pkg.NonhydrostaticModel(
        grid=grid, tracers=("c",),
        boundary_conditions={"c": bcs.FieldBoundaryConditions(
            top=bcs.FluxBoundaryCondition(flux),
            bottom=bcs.FluxBoundaryCondition(2.5))})
    M = pkg.models
    return dict(top=M.BoundaryConditionOperation("c", "top", model).interior,
                x=np.asarray(grid.nodes1d(0, "c")),
                bottom=M.BoundaryConditionField(
                    "c", "bottom", model).compute().interior,
                west=M.BoundaryConditionOperation("u", "west",
                                                  model).interior)


def test_boundary_condition_operation():
    r = _both(_bc_operation)
    assert r["top"].shape == (8, 8, 1)
    assert np.allclose(r["top"][:, 0, 0], 1e-4 * np.cos(2 * np.pi * r["x"]),
                       atol=1e-12)
    assert np.allclose(r["bottom"], 2.5)
    assert np.allclose(r["west"], 0.0)


def _adjacent_mean(pkg):
    grid = _grid(pkg, size=(16, 16, 16), extent=(3.0, 4.0, 5.0),
                 topology=("periodic", "periodic", "bounded"))
    model = pkg.NonhydrostaticModel(grid=grid, tracers=("c",))
    bam = pkg.models.boundary_adjacent_mean
    model.set(c=lambda x, y, z: np.sin(2 * np.pi * y / 4.0))
    east = bam(model.field("c"), "east")
    model.set(c=lambda x, y, z: z)
    return dict(east=east, top=bam(model.field("c"), "top"),
                bottom=bam(model.field("c"), "bottom"),
                zc=np.asarray(grid.nodes1d(2, "c")))


def test_boundary_adjacent_mean():
    r = _both(_adjacent_mean)
    assert abs(float(r["east"])) < 1e-12
    assert float(r["top"]) == pytest.approx(r["zc"][-1], rel=1e-12)
    assert float(r["bottom"]) == pytest.approx(r["zc"][0], rel=1e-12)


def _adjacent_mean_face(pkg):
    u = _face_data(pkg, (4, 2, 2), halo=H2)
    bam = pkg.models.diagnostic_operations.boundary_adjacent_mean
    holder = pkg.models.diagnostic_operations.BoundaryAdjacentMean()
    holder("east", u)
    return dict(east=bam(u, "east"), west=bam(u, "west"),
                kept=np.array(holder()))


def test_boundary_adjacent_mean_face_right_side():
    r = _both(_adjacent_mean_face)
    np.testing.assert_allclose(float(r["east"]), 0.75, rtol=1e-6)
    np.testing.assert_allclose(float(r["west"]), 0.25, rtol=1e-6)
    np.testing.assert_allclose(float(r["kept"]), 0.75, rtol=1e-6)


# -- the port's own: the diagnostic fields and the lazy seawater density -------

def _buoyancy_and_density(pkg):
    grid = _cube(pkg)
    model = pkg.NonhydrostaticModel(grid=grid,
                                    buoyancy=pkg.SeawaterBuoyancy(),
                                    tracers=("T", "S"))
    model.set(T=lambda x, y, z: 10 + 5 * z + np.sin(2 * np.pi * x),
              S=lambda x, y, z: 35 - 0.5 * z)
    rho = pkg.seawater_density(model)
    assert isinstance(rho, pkg.KernelFunctionOperation)
    return dict(b=pkg.models.diagnostic_operations.BuoyancyField(model).interior,
                rho=rho.compute().interior,
                p=pkg.models.diagnostic_operations.PressureField(model).interior)


def test_buoyancy_pressure_fields_and_lazy_seawater_density():
    """``BuoyancyField``, ``PressureField`` and ``seawater_density`` (a lazy
    ``KernelFunctionOperation`` in both packages) after ``set``."""
    r = _both(_buoyancy_and_density)
    assert np.all(np.isfinite(r["rho"])) and r["rho"].min() > 1000.0
