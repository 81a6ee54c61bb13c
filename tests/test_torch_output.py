"""The port's output writers, readers and checkpoints against the JAX
package's, on the CPU in float64.

- Files across packages: a 3-step Simulation of one NonhydrostaticModel
  state in each package, each with a FieldWriter (whole fields, a surface
  window and a scalar), a NetCDFWriter, an HDF5Writer and a NetCDF4Writer.
  Each package reads the other's FieldWriter dataset and NetCDF4 file with
  its own FieldTimeSeries; the NetCDF-3 and HDF5 files hold the same
  variables, dimensions, groups and attributes (the source and halo
  attributes aside: the JAX model widens its halos). Times and iterations
  are equal, values within 1e-10 relative to max|JAX|.
- WindowedTimeAverage under a changing Δt (a wizard-like sequence, strides
  1 and 2, a window shorter than the interval): 1e-14 relative.
- Checkpoints:
  - the port's own round trip is bitwise: a model picked up from the
    checkpoint at iteration 2 and run to 4 equals the model that ran
    through, every tensor of its state (NH RK3 on the fused route, NH
    quasi-AB2 with a closure, the hydrostatic ocean row with the
    split-explicit free surface and CATKE, shallow water);
  - a checkpoint the JAX package wrote at iteration 2, picked up by the
    port and run 3 more steps, equals the JAX model run on from the same
    file: 1e-10 relative to max|JAX|, for the same four models;
  - restore refuses a port checkpoint of another configuration.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import chip_smoke
import oceananigans_tpu as jo
from oceananigans_tpu.simulation import Simulation as JSimulation
from oceananigans_tpu.simulation import checkpointer as jcp
from oceananigans_tpu.simulation.hdf5_writer import HDF5Writer as JHDF5
from oceananigans_tpu.simulation.output_readers import \
    FieldTimeSeries as JFTS
from oceananigans_tpu.simulation.output_writers import (
    FieldWriter as JFieldWriter, WindowedTimeAverage as JWTA)
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch.models import state_from_jax
from oceananigans_tpu_torch.simulation import checkpointer as tcp

h5py = pytest.importorskip("h5py")

torch.set_num_threads(1)

F64 = torch.float64
N = (8, 8, 8)
TOL = 1e-10


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _nh_initial():
    rng = np.random.default_rng(0)
    return dict(u=0.1 * rng.standard_normal(N), v=0.1 * rng.standard_normal(N),
                c=rng.standard_normal(N))


def _jax_nh(**kw):
    jm = jo.NonhydrostaticModel(
        grid=jo.RectilinearGrid(size=N, extent=(1, 1, 1), dtype=np.float64),
        tracers=("c",), **kw)
    jm.set(**_nh_initial())
    return jm


def _port_nh(**kw):
    tm = ot.NonhydrostaticModel(
        ot.RectilinearGrid(size=N, extent=(1, 1, 1), dtype=F64,
                           device="cpu"), tracers=("c",), **kw)
    tm.set(**_nh_initial())
    return tm


def _nh_pair(**kw):
    """The JAX model and the port's with the JAX model's state."""
    jm = _jax_nh(**kw)
    tm = _port_nh(**kw)
    state_from_jax(_numpy(jm.state), tm)
    return jm, tm


# -- files across packages -----------------------------------------------------------

SURFACE = (slice(None), slice(None), -1)


def _writers(P, model, d):
    """The four writers of package ``P`` (its top-level module) into
    directory ``d``."""
    nc4 = P.NetCDF4Writer if P is ot else jo.NetCDF4Writer
    h5 = ot.HDF5Writer if P is ot else JHDF5
    every = P.IterationInterval(1)
    return {
        "fields": (JFieldWriter if P is jo else ot.FieldWriter)(
            model, {"u": "u", "c": "c",
                    "mean_c": lambda m: m.field("c").mean()},
            os.path.join(d, "fields"), schedule=every),
        "surface": (JFieldWriter if P is jo else ot.FieldWriter)(
            model, {"u": "u", "w": "w"}, os.path.join(d, "surface"),
            schedule=P.IterationInterval(2), indices=SURFACE),
        "nc3": P.NetCDFWriter(model, {"c": "c", "u": "u"},
                              os.path.join(d, "out3.nc"), schedule=every),
        "h5": h5(model, {"c": "c", "v": "v"}, os.path.join(d, "out.h5"),
                 schedule=every),
        "nc4": nc4(model, {"c": "c", "u": "u"}, os.path.join(d, "out4.nc"),
                   schedule=every, indices={"u": SURFACE}),
    }


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both packages' files of the same 3-step run."""
    jm, tm = _nh_pair()
    dirs = {}
    for P, model, sim_cls in ((jo, jm, JSimulation), (ot, tm, ot.Simulation)):
        d = str(tmp_path_factory.mktemp("jax" if P is jo else "port"))
        sim = sim_cls(model, dt=1e-3, stop_iteration=3)
        writers = _writers(P, model, d)
        for name, w in writers.items():
            sim.output_writers[name] = w
        sim.run()
        writers["nc3"].close()
        writers["nc4"].close()
        dirs[P.__name__] = d
    return dirs["oceananigans_tpu"], dirs["oceananigans_tpu_torch"]


@pytest.mark.parametrize("dataset", ["fields", "surface"])
def test_field_writer_across_packages(written, dataset):
    """Each package's FieldTimeSeries reads the other's dataset: the same
    names, times, iterations and grid keys; values within 1e-10."""
    jdir, tdir = (os.path.join(d, dataset) for d in written)
    assert ot.written_names(jdir) == jo.written_names(tdir)
    for name in ot.written_names(jdir):
        theirs = ot.FieldTimeSeries(jdir, name, device="cpu")
        ours = ot.FieldTimeSeries(tdir, name, device="cpu")
        jtheirs, jours = JFTS(tdir, name), JFTS(jdir, name)
        assert list(theirs.times) == list(jours.times)
        assert theirs.iterations == ours.iterations == jtheirs.iterations
        assert np.allclose(theirs.times, ours.times, rtol=1e-14, atol=0)
        for i in range(len(ours)):
            assert _rel(ours[i], jours[i]) <= TOL, (name, i)
            assert _rel(jtheirs[i], theirs[i]) <= TOL, (name, i)
        assert set(ours.grid_meta) == set(theirs.grid_meta)
    for d in (jdir, tdir):
        assert set(json.load(open(os.path.join(d, "series.json")))) == {
            "times", "iterations", "outputs"}
    ds = ot.FieldDataset(jdir, device="cpu")
    assert list(ds) == ot.written_names(jdir)
    assert ds.u is ds["u"]


def test_netcdf3_across_packages(written):
    """The NetCDF-3 files: the same dimensions, variables and coordinate
    values; the data within 1e-10."""
    jf, tf = (netcdf_file(os.path.join(d, "out3.nc"), "r", mmap=False)
              for d in written)
    try:
        assert jf.dimensions == tf.dimensions
        assert set(jf.variables) == set(tf.variables)
        for name, var in jf.variables.items():
            assert var.dimensions == tf.variables[name].dimensions
            assert _rel(tf.variables[name][:], var[:]) <= TOL, name
    finally:
        jf.close()
        tf.close()


def _h5_tree(f):
    out = {}
    f.visititems(lambda k, v: out.__setitem__(k, dict(v.attrs)))
    return out


def test_hdf5_across_packages(written):
    """The HDF5 files: the same groups, datasets and attribute keys; the
    data within 1e-10 and the times equal."""
    with h5py.File(os.path.join(written[0], "out.h5"), "r") as jf, \
            h5py.File(os.path.join(written[1], "out.h5"), "r") as tf:
        jt, tt = _h5_tree(jf), _h5_tree(tf)
        assert set(jt) == set(tt)
        for key, attrs in jt.items():
            assert set(attrs) == set(tt[key]), key
        for key in jt:
            if isinstance(jf[key], h5py.Dataset):
                assert _rel(tf[key][()], jf[key][()]) <= TOL, key
        assert tf["grid"].attrs["topology"] == jf["grid"].attrs["topology"]


def test_netcdf4_across_packages(written):
    """Each package's FieldTimeSeries reads the other's NetCDF4 file: the
    same variables, dimension scales, coordinates and attributes; the data
    within 1e-10."""
    jpath, tpath = (os.path.join(d, "out4.nc") for d in written)
    assert ot.written_names(jpath) == jo.written_names(tpath)
    for name in ("c", "u"):
        theirs = ot.FieldTimeSeries(jpath, name, device="cpu")
        jtheirs = JFTS(tpath, name)
        assert list(theirs.times) == list(JFTS(jpath, name).times)
        assert np.allclose(theirs.times, jtheirs.times, rtol=1e-14, atol=0)
        assert {k: str(v) for k, v in theirs.attributes.items()} == {
            k: str(v) for k, v in jtheirs.attributes.items()}
        for a, b in zip(theirs.coordinates, jtheirs.coordinates):
            assert np.array_equal(a, b)
        for i in range(len(theirs)):
            assert _rel(jtheirs[i], theirs[i]) <= TOL, (name, i)
    with h5py.File(jpath, "r") as jf, h5py.File(tpath, "r") as tf:
        assert set(jf) == set(tf)
        skip = {"source", "_NCProperties"}
        assert {k for k in jf.attrs if k not in skip} == {
            k for k in tf.attrs if k not in skip}


class _Run:
    """What a writer reads of a simulation: its model."""

    def __init__(self, model):
        self.model = model


@pytest.mark.parametrize("writer", ["hdf5", "netcdf4"])
def test_file_splitting_across_packages(tmp_path, writer):
    """Six writes with a size limit below one write's bytes: both packages
    split into the same files, each holding the same entries; a NetCDF4
    file reopened with overwrite_existing=False appends to its time axis."""
    jm, tm = _nh_pair()
    files = {}
    for P, model in ((jo, jm), (ot, tm)):
        d = tmp_path / P.__name__
        d.mkdir()
        if writer == "hdf5":
            w = (JHDF5 if P is jo else ot.HDF5Writer)(
                model, {"c": "c"}, str(d / "out.h5"), max_filesize=4000)
        else:
            w = P.NetCDF4Writer(model, {"c": "c"}, str(d / "out.nc"),
                                file_splitting=P.FileSizeLimit(4000))
        for _ in range(6):
            w.write(_Run(model))
        if writer == "netcdf4":
            w.close()
        files[P is jo] = sorted(os.listdir(d))
        if writer == "netcdf4":
            last = str(d / files[P is jo][-1])
            n0 = len(h5py.File(last, "r")["time"])
            w = P.NetCDF4Writer(model, {"c": "c"}, last,
                                overwrite_existing=False)
            w.write(_Run(model))
            w.close()
            assert len(h5py.File(last, "r")["time"]) == n0 + 1
    assert files[True] == files[False] and len(files[True]) > 1


def test_hdf5_writers_need_h5py(monkeypatch, tmp_path):
    """Without h5py the HDF5 writers raise ImportError when built, and the
    package imports none."""
    import builtins
    real = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ImportError("no h5py here")
        return real(name, *args, **kw)
    tm = _port_nh()
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    for writer in (ot.HDF5Writer, ot.NetCDF4Writer):
        with pytest.raises(ImportError, match="needs h5py"):
            writer(tm, {"c": "c"}, str(tmp_path / "x.nc"))


# -- WindowedTimeAverage --------------------------------------------------------------

class _Clock:
    """A stand-in model: a time and an output that varies with it."""

    def __init__(self):
        self.time = 0.0
        self.base = np.random.default_rng(4).standard_normal((5, 4, 3))


@pytest.mark.parametrize("stride,window", [(1, None), (2, None), (1, 0.35)])
def test_windowed_time_average(stride, window):
    """The same collections under a changing Δt in both packages: every
    result within 1e-14 relative."""
    dts = [0.07, 0.11, 0.05, 0.13, 0.02, 0.09, 0.12, 0.06, 0.1, 0.08] * 3
    jclock, tclock = _Clock(), _Clock()
    jw = JWTA(lambda m: m.base * np.sin(3 * m.time) + m.time, 0.5,
              window=window, stride=stride)
    tw = ot.WindowedTimeAverage(
        lambda m: torch.as_tensor(m.base) * np.sin(3 * m.time) + m.time,
        0.5, window=window, stride=stride)
    sched = ot.AveragedTimeInterval(0.5, window=window, stride=stride)
    sched.initialize(tclock)
    results = 0
    for clock in (jclock, tclock):
        clock.state = {"clock": {"time": np.float64(0.0)}}
    jw.collect(jclock)
    tw.collect(tclock)
    for dt in dts:
        for clock in (jclock, tclock):
            clock.time += dt
            clock.state = {"clock": {"time": np.float64(clock.time)}}
        jw.collect(jclock)
        tw.collect(tclock)
        if sched(tclock):
            want, got = jw.result(), tw.result()
            if want is None:
                # an actuation past the window's end: nothing collected
                assert got is None
                continue
            assert isinstance(got, torch.Tensor)
            assert _rel(got, want) <= 1e-14
            results += 1
    assert results >= 2


# -- checkpoints -------------------------------------------------------------------------

OCEAN_N = (12, 10, 8)
SW_N = (16, 12)


def _jax_ocean():
    from oceananigans_tpu.advection.vector_invariant import \
        VectorInvariant as JVI
    from oceananigans_tpu.closures.catke import CATKEVerticalDiffusivity
    from oceananigans_tpu.models.free_surfaces import \
        SplitExplicitFreeSurface as JSplit
    g = jo.LatitudeLongitudeGrid(size=OCEAN_N, longitude=(0, 60),
                                 latitude=(15, 75), z=(-1800.0, 0.0),
                                 dtype=np.float64)
    m = jo.HydrostaticFreeSurfaceModel(
        g, momentum_advection=JVI(),
        tracer_advection=jo.WENO(5, smoothness_dtype=jnp.float64),
        coriolis=jo.HydrostaticSphericalCoriolis(),
        free_surface=JSplit(cfl=0.7),
        buoyancy=jo.SeawaterBuoyancy(
            equation_of_state=jo.LinearEquationOfState()),
        closure=CATKEVerticalDiffusivity(), tracers=("T", "S"),
        boundary_conditions={"u": jo.FieldBoundaryConditions(
            top=jo.FluxBoundaryCondition(-1e-4),
            bottom=jo.FluxBoundaryCondition(
                chip_smoke.ocean_drag, field_dependencies=("u", "v")))})
    rng = np.random.default_rng(0)
    m.set(T=lambda lam, phi, z: 12 + 8e-3 * z + 2 * np.cos(np.radians(phi)),
          S=35.0, u=0.05 * rng.standard_normal(OCEAN_N))
    return m


def _port_ocean():
    return chip_smoke.ocean_model(OCEAN_N, F64, "cpu", smoothness=F64,
                                  momentum_advection=ot.VectorInvariant())


def _sw_initial():
    rng = np.random.default_rng(1)
    return 0.05 * rng.standard_normal(SW_N), dict(
        h=1.0 + 0.05 * rng.standard_normal(SW_N),
        uh=0.1 * rng.standard_normal(SW_N),
        vh=0.1 * rng.standard_normal(SW_N), c=rng.random(SW_N))


def _sw(P, **kw):
    hB, init = _sw_initial()
    grid_kw = dict(size=SW_N, extent=(10.0, 10.0),
                   topology=("periodic", "periodic", "flat"))
    if P is jo:
        grid = jo.RectilinearGrid(dtype=np.float64, **grid_kw)
        kw = dict(kw, fused=False)
    else:
        grid = ot.RectilinearGrid(dtype=F64, device="cpu", **grid_kw)
    m = P.ShallowWaterModel(grid=grid, advection=P.WENO(5, smoothness_dtype=(
        jnp.float64 if P is jo else F64)), coriolis=P.FPlane(f=0.3),
        bathymetry=hB, tracers=("c",), gravitational_acceleration=9.81,
        **kw)
    m.set(**init)
    return m


def _nh_ab2(P):
    return dict(closure=P.ScalarDiffusivity(nu=1e-3, kappa=2e-3),
                timestepper="QuasiAdamsBashforth2")


CKPT_MODELS = {
    # name: (JAX model, port model, Δt, compared fields)
    "nh_rk3": (_jax_nh, _port_nh, 1e-3, ("u", "v", "w", "c")),
    "nh_ab2_closure": (lambda: _jax_nh(**_nh_ab2(jo)),
                       lambda: _port_nh(**_nh_ab2(ot)), 1e-3,
                       ("u", "v", "w", "c")),
    "ocean_catke": (_jax_ocean, _port_ocean, 600.0,
                    ("u", "v", "T", "S", "e", "eta", "w")),
    "shallow_water": (lambda: _sw(jo), lambda: _sw(ot), 1e-3,
                      ("uh", "vh", "h", "c")),
}


def _state_tensors(model):
    return tcp._flatten_state(model.state)


@pytest.mark.parametrize("name", sorted(CKPT_MODELS))
def test_own_checkpoint_bitwise(tmp_path, name):
    """Run to iteration 4 with a checkpoint at 2; a fresh model picked up
    from it through Simulation.run(pickup=) equals the first at 4, every
    state tensor bit for bit."""
    _, make, dt, _ = CKPT_MODELS[name]
    a = make()
    sim = ot.Simulation(a, dt=dt, stop_iteration=4)
    sim.output_writers["ckpt"] = ot.Checkpointer(
        a, ot.IterationInterval(2), dir=str(tmp_path))
    sim.run()
    b = make()
    sim = ot.Simulation(b, dt=dt, stop_iteration=4)
    sim.run(pickup=str(tmp_path / "checkpoint_iteration2.npz"))
    sa, sb = _state_tensors(a), _state_tensors(b)
    assert set(sa) == set(sb)
    for key, x in sa.items():
        y = sb[key]
        if name == "shallow_water" and key.startswith("fields/"):
            # the fused stage leaves the halo slots unwritten (every reader
            # fills them first): the interiors
            ii = a.grid.interior_slices
            x, y = x[ii], y[ii]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), key
        else:
            assert type(x) is type(y) and x == y, key
    spec = ot.checkpoint_grid(str(tmp_path / "checkpoint_iteration2.npz"),
                              device="cpu")
    assert spec == a.grid


@pytest.mark.parametrize("name", sorted(CKPT_MODELS))
def test_jax_checkpoint_continued(tmp_path, name):
    """The JAX model writes a checkpoint at iteration 2 and runs 3 more
    steps; the port restores that file and runs 3 steps: 1e-10 relative to
    max|JAX| in every compared field; the clocks agree."""
    make_jax, make_port, dt, names = CKPT_MODELS[name]
    jm = make_jax()
    for _ in range(2):
        jm.time_step(dt)
    cp = jcp.Checkpointer(jm, dir=str(tmp_path))
    cp.write(JSimulation(jm, dt=dt))
    for _ in range(3):
        jm.time_step(dt)
    tm = make_port()
    tcp.restore(tm, cp.path(2))
    assert tm.iteration == 2
    for _ in range(3):
        tm.time_step(dt)
    assert tm.iteration == jm.iteration
    assert abs(tm.time - jm.time) <= 1e-14 * jm.time
    for field in names:
        want = np.asarray(jm.field(field).interior)
        got = tm.field(field).interior.numpy()
        if field == "w" and got.shape[2] == want.shape[2] - 1:
            want = want[..., :-1]          # the z-compact layout's w
        assert got.shape == want.shape, field
        assert _rel(got, want) <= TOL, (field, _rel(got, want))


def test_restore_refuses_another_configuration(tmp_path):
    """A port checkpoint of a quasi-AB2 model does not restore into an RK3
    one (its G⁻ has no place), nor into a model of another size."""
    ab2 = _port_nh(timestepper="QuasiAdamsBashforth2")
    ot.Checkpointer(ab2, dir=str(tmp_path)).write(
        ot.Simulation(ab2, dt=1e-3))
    path = str(tmp_path / "checkpoint_iteration0.npz")
    rk3 = _port_nh()
    with pytest.raises(ValueError, match="unexpected"):
        tcp.restore(rk3, path)
    other = ot.NonhydrostaticModel(
        ot.RectilinearGrid(size=(8, 8, 4), extent=(1, 1, 1), dtype=F64,
                           device="cpu"), tracers=("c",),
        timestepper="QuasiAdamsBashforth2")
    with pytest.raises(ValueError, match="the model holds"):
        tcp.restore(other, path)
