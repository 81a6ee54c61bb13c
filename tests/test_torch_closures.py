"""The port's closures against the JAX package's, on the CPU in float64.

Each closure's ``compute_diffusivities``, momentum tendencies and tracer
tendencies run on the same seeded padded fields (random halos included) at
(12, 10, 8) with H = 3, on both sides: the eddy viscosity over the whole
padded tensor and the tendencies over the interior agree to 1e-12 relative
to max|JAX| (the same operators in the same order; only the interior means
of the dynamic coefficient sum in another order). The closures: Smagorinsky
(a per-tracer Pr dict, Lilly-modified through ``LillyCoefficient`` and
through ``SmagorinskyLilly(buoyancy=...)``), the dynamic coefficient with
(0, 1) and (0, 1, 2) averaging and with Lagrangian averaging (its state
update on the first and a later step), AMD with and without the buoyancy
term ``Cb``, every ScalarDiffusivity formulation with constant, function,
array, discrete-form and per-tracer coefficients, explicit and vertically
implicit (the explicit remainder and the implicit diffusivities), the
biharmonic and horizontal-divergence families, and a tuple. Then the
batched tridiagonal solve and the implicit vertical diffusion of a centre
and of a face field, the equations of state, SeawaterBuoyancy and a tilted
BuoyancyForce, each against JAX at 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceananigans_tpu.buoyancy as jb
import oceananigans_tpu.closures as jc
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.models.nonhydrostatic import (
    implicit_vertical_diffusion as j_ivd,
    implicit_vertical_diffusion_w as j_ivd_w)
from oceananigans_tpu.solvers.tridiagonal import (
    solve_batched_tridiagonal as j_tridiag)
import oceananigans_tpu_torch.buoyancy as tb
import oceananigans_tpu_torch.closures as tc
from oceananigans_tpu_torch.grids import RectilinearGrid as TGrid
from oceananigans_tpu_torch.models.nonhydrostatic import (
    implicit_vertical_diffusion as t_ivd,
    implicit_vertical_diffusion_w as t_ivd_w)
from oceananigans_tpu_torch.solvers.tridiagonal import (
    solve_batched_tridiagonal as t_tridiag)

torch.set_num_threads(1)

N, H = (12, 10, 8), (3, 3, 3)
GRID = dict(size=N, extent=(1.0, 0.8, 0.5), halo=H)
TIME = 0.3
TOL = 1e-12


def _grids():
    return (JGrid(dtype=np.float64, **GRID),
            TGrid(dtype=torch.float64, device="cpu", **GRID))


def _fields(shape, seed=7):
    """u, v, w, b, c with random halos; b stably stratified with noise so
    Lilly's factor takes both branches."""
    rng = np.random.default_rng(seed)
    arrays = {n: 0.1 * rng.standard_normal(shape) for n in "uvwc"}
    z = np.linspace(-1.0, 0.0, shape[2]).reshape(1, 1, -1)
    arrays["b"] = 0.05 * z + 1e-3 * rng.standard_normal(shape)
    arrays["JLM"] = 1e-4 * rng.random(shape)
    arrays["JMM"] = 1e-4 * rng.random(shape)
    return ({n: jnp.asarray(a) for n, a in arrays.items()},
            {n: torch.as_tensor(a) for n, a in arrays.items()})


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.max(np.abs(want))
    return np.max(np.abs(got - want)) / (scale if scale > 0 else 1.0)


def _coef(k, lib):
    """The same coefficient for either side: a callable, an array or a
    discrete form is built with that side's array type."""
    kind, value = k
    if kind == "const":
        return value
    if kind == "function":
        return lambda x, y, z, t: value * (1.0 + x * y) + 1e-4 * z * z + 1e-3 * t
    if kind == "array":
        rng = np.random.default_rng(11)
        a = value * (1.0 + rng.random(JGrid(dtype=np.float64, **GRID)
                                      .padded_shape))
        return jnp.asarray(a) if lib == "jax" else torch.as_tensor(a)
    if kind == "discrete":
        return lambda grid, fields, t, p: p * (1.0 + fields["b"] ** 2)
    raise ValueError(kind)


def _scalar(lib, formulation, nu, kappa, td="explicit", discrete=False):
    m = jc if lib == "jax" else tc
    td = (m.VerticallyImplicitTimeDiscretization() if td == "implicit"
          else m.ExplicitTimeDiscretization())
    if isinstance(kappa, dict):
        kappa = {n: _coef(k, lib) for n, k in kappa.items()}
    else:
        kappa = _coef(kappa, lib)
    return m.ScalarDiffusivity(td, nu=_coef(nu, lib), kappa=kappa,
                               formulation=formulation,
                               discrete_form=discrete,
                               parameters=2e-3 if discrete else None)


def _buoyant(make):
    return lambda lib: make(lib, (jb if lib == "jax" else tb).BuoyancyTracer())


CLOSURES = {
    "smagorinsky": lambda lib: (jc if lib == "jax" else tc).Smagorinsky(),
    "smagorinsky_pr_dict": lambda lib: (jc if lib == "jax" else tc)
    .Smagorinsky(Pr={"b": 0.5}),
    "lilly_coefficient": _buoyant(lambda lib, b: (
        jc if lib == "jax" else tc).Smagorinsky(
            coefficient=(jc if lib == "jax" else tc).LillyCoefficient(
                Pr=0.7), buoyancy=b)),
    "smagorinsky_lilly_given_buoyancy": _buoyant(lambda lib, b: (
        jc if lib == "jax" else tc).SmagorinskyLilly(buoyancy=b)),
    "dynamic_01": lambda lib: (jc if lib == "jax" else tc)
    .DynamicSmagorinsky(averaging=(0, 1)),
    "dynamic_012": lambda lib: (jc if lib == "jax" else tc)
    .DynamicSmagorinsky(averaging=(0, 1, 2)),
    "dynamic_lagrangian": lambda lib: (jc if lib == "jax" else tc)
    .DynamicSmagorinsky(averaging=(jc if lib == "jax" else tc)
                        .LagrangianAveraging()),
    "amd": lambda lib: (jc if lib == "jax" else tc)
    .AnisotropicMinimumDissipation(),
    "amd_cb": _buoyant(lambda lib, b: (jc if lib == "jax" else tc)
                       .AnisotropicMinimumDissipation(Cb=1.0, buoyancy=b)),
    "biharmonic_iso": lambda lib: (jc if lib == "jax" else tc)
    .ScalarBiharmonicDiffusivity(nu=1e-4, kappa={"b": 2e-4}),
    "biharmonic_horizontal": lambda lib: (jc if lib == "jax" else tc)
    .HorizontalScalarBiharmonicDiffusivity(nu=1e-4, kappa=3e-4),
    "biharmonic_vertical": lambda lib: (jc if lib == "jax" else tc)
    .VerticalScalarBiharmonicDiffusivity(nu=1e-4, kappa=3e-4),
    "horizontal_divergence": lambda lib: (jc if lib == "jax" else tc)
    .HorizontalDivergenceScalarDiffusivity(nu=2e-3),
    "horizontal_divergence_biharmonic": lambda lib: (
        jc if lib == "jax" else tc)
    .HorizontalDivergenceScalarBiharmonicDiffusivity(nu=2e-4),
    "tuple": lambda lib: (jc if lib == "jax" else tc).ClosureTuple(
        (jc if lib == "jax" else tc).Smagorinsky(),
        _scalar(lib, "vertical", ("const", 1e-3), ("const", 2e-3))),
}
for _form in ("iso", "horizontal", "vertical"):
    for _td in ("explicit", "implicit"):
        for _kind, _nu, _kappa in (
                ("const", ("const", 1e-3), {"b": ("const", 2e-3)}),
                ("function", ("function", 1e-3),
                 {"b": ("function", 2e-3), "c": ("const", 5e-4)}),
                ("array", ("array", 1e-3), ("array", 2e-3))):
            CLOSURES[f"scalar_{_form}_{_td}_{_kind}"] = (
                lambda lib, f=_form, t=_td, n=_nu, k=_kappa:
                _scalar(lib, f, n, k, t))
    CLOSURES[f"scalar_{_form}_discrete"] = (
        lambda lib, f=_form: _scalar(lib, f, ("discrete", None),
                                     ("discrete", None), discrete=True))


def _compare(a, b, what, full=False):
    if isinstance(b, (int, float)):
        assert float(a) == b, what
        return
    jg, _ = _grids()
    ints = jg.interior_slices
    want = np.asarray(b) if full else np.asarray(b)[ints]
    got = a.numpy() if full else a[ints].numpy()
    if got.shape != want.shape:
        got = np.broadcast_to(got, want.shape)
    assert _rel(got, want) <= TOL, (what, _rel(got, want))


@pytest.mark.parametrize("case", sorted(CLOSURES))
def test_closure_against_jax(case):
    jg, tg = _grids()
    jf, tf = _fields(jg.padded_shape)
    jcl, tcl = CLOSURES[case]("jax"), CLOSURES[case]("torch")
    jaux = jcl.compute_diffusivities(jg, jf, TIME)
    taux = tcl.compute_diffusivities(tg, tf, TIME)
    pairs = list(zip(jaux, taux)) if isinstance(jaux, list) else [(jaux,
                                                                   taux)]
    for ja, ta in pairs:
        assert set(ta) <= set(ja), (set(ta), set(ja))
        for key, tv in ta.items():
            if key.startswith("_"):
                continue
            _compare(tv, ja[key], (case, key), full=True)
    jm = jcl.momentum_tendencies(jg, jf, jaux)
    tm = tcl.momentum_tendencies(tg, tf, taux)
    for c in "uvw":
        _compare(tm[c], jm[c], (case, c))
    for name in ("b", "c"):
        want = jcl.tracer_tendency(jg, name, jf, jaux)
        got = tcl.tracer_tendency(tg, name, tf, taux)
        _compare(got, want, (case, name))
    jk = jcl.vertical_implicit_kappas(jg, jf, jaux)
    tk = tcl.vertical_implicit_kappas(tg, tf, taux)
    assert set(jk) == set(tk), case
    for name in jk:
        _compare(tk[name], jk[name], (case, "kappa_z", name), full=True)
    if case == "dynamic_lagrangian":
        for iteration in (0, 5):
            want = jcl.update_state_fields(jg, jf, jnp.asarray(0.01),
                                           jnp.asarray(iteration))
            got = tcl.update_state_fields(tg, tf, np.float64(0.01),
                                          iteration)
            for key in ("JLM", "JMM"):
                _compare(got[key], want[key], (case, key, iteration),
                         full=True)


def test_smagorinsky_lilly_alias_pin():
    """``SmagorinskyLilly()`` built without a buoyancy stays plain
    Smagorinsky after a model hands it one; ``LillyCoefficient`` is
    buoyancy-modified: both as in the JAX package."""
    import oceananigans_tpu_torch as ot
    for lib, m, bm in (("jax", jc, jb), ("torch", tc, tb)):
        alias, lilly = m.SmagorinskyLilly(), m.Smagorinsky(
            coefficient=m.LillyCoefficient())
        assert not alias.buoyancy_modified and lilly.buoyancy_modified, lib
    tg = TGrid(size=(8, 8, 8), extent=(1.0, 1.0, 1.0), device="cpu",
               dtype=torch.float64)
    for closure, modified in ((tc.SmagorinskyLilly(), False),
                              (tc.Smagorinsky(
                                  coefficient=tc.LillyCoefficient()), True)):
        model = ot.NonhydrostaticModel(tg, buoyancy=tb.BuoyancyTracer(),
                                       closure=closure)
        assert model.closure.buoyancy is model.buoyancy
        assert model.closure.buoyancy_modified is modified


# -- the implicit vertical solve ------------------------------------------------

def test_tridiagonal_against_jax():
    rng = np.random.default_rng(3)
    shape = (5, 4, 9)
    a, c = -rng.random(shape), -rng.random(shape)
    b = 2.5 + rng.random(shape)
    d = rng.standard_normal(shape)
    for coefs in ((a, b, c), (a[0, 0], b[0, 0], c[0, 0]), (-0.3, 1.9, -0.4)):
        want = j_tridiag(*(jnp.asarray(x) for x in coefs), jnp.asarray(d))
        got = t_tridiag(*(torch.as_tensor(x) if np.ndim(x) else x
                          for x in coefs), torch.as_tensor(d))
        assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("kappa", ["scalar", "field"])
def test_implicit_vertical_diffusion_against_jax(kappa):
    jg, tg = _grids()
    rng = np.random.default_rng(4)
    q = rng.standard_normal(jg.padded_shape)
    k = 1e-2 * (1 + rng.random(jg.padded_shape)) if kappa == "field" \
        else 1.5e-2
    jk = jnp.asarray(k) if kappa == "field" else k
    tk = torch.as_tensor(k) if kappa == "field" else k
    ints = jg.interior_slices
    for jfn, tfn in ((j_ivd, t_ivd), (j_ivd_w, t_ivd_w)):
        want = np.asarray(jfn(jg, jnp.asarray(q), jk, 0.05))[ints]
        got = tfn(tg, torch.as_tensor(q), tk, 0.05)[ints].numpy()
        assert _rel(got, want) <= TOL, jfn.__name__
    lam = 0.3 * rng.random(jg.padded_shape)
    want = np.asarray(j_ivd(jg, jnp.asarray(q), jk, 0.05,
                            damping=jnp.asarray(lam)))[ints]
    got = t_ivd(tg, torch.as_tensor(q), tk, 0.05,
                damping=torch.as_tensor(lam))[ints].numpy()
    assert _rel(got, want) <= TOL


# -- buoyancy and the equations of state --------------------------------------

def _tsz(shape=(6, 5, 7)):
    rng = np.random.default_rng(9)
    T = 2.0 + 25.0 * rng.random(shape)
    S = 30.0 + 7.0 * rng.random(shape)
    z = -4000.0 * rng.random(shape)
    return T, S, z


@pytest.mark.parametrize("eos", ["roquet", "teos10"])
def test_equation_of_state_against_jax(eos):
    cls = {"roquet": "RoquetSecondOrderEquationOfState",
           "teos10": "TEOS10EquationOfState"}[eos]
    je, te = getattr(jb, cls)(), getattr(tb, cls)()
    T, S, z = _tsz()
    jargs = [jnp.asarray(a) for a in (T, S, z)]
    targs = [torch.as_tensor(a) for a in (T, S, z)]
    methods = ["density_anomaly"] + (
        ["density", "thermal_expansion", "haline_contraction"]
        if eos == "teos10" else [])
    for name in methods:
        want = getattr(je, name)(*jargs)
        got = getattr(te, name)(*targs)
        assert _rel(got.numpy(), want) <= TOL, name
    want = je.buoyancy(9.81, *jargs)
    assert _rel(te.buoyancy(9.81, *targs).numpy(), want) <= TOL
    if eos == "teos10":
        # the published check value, in the port too
        rho = te.density(torch.tensor(10.0, dtype=torch.float64),
                         torch.tensor(30.0, dtype=torch.float64),
                         torch.tensor(-1000.0, dtype=torch.float64))
        assert abs(rho.item() - 1027.45140) < 1e-4


@pytest.mark.parametrize("case", ["linear", "teos10", "constant_salinity",
                                  "tilted"])
def test_seawater_buoyancy_against_jax(case):
    jg, tg = _grids()
    rng = np.random.default_rng(12)
    T = 10.0 + rng.standard_normal(jg.padded_shape)
    S = 35.0 + rng.standard_normal(jg.padded_shape)
    jf = {"T": jnp.asarray(T), "S": jnp.asarray(S)}
    tf = {"T": torch.as_tensor(T), "S": torch.as_tensor(S)}

    def make(m):
        if case == "linear":
            return m.SeawaterBuoyancy(m.LinearEquationOfState(2e-4, 8e-4))
        if case == "teos10":
            return m.SeawaterBuoyancy(m.TEOS10EquationOfState())
        if case == "constant_salinity":
            return m.SeawaterBuoyancy(constant_salinity=35.0,
                                      gravitational_acceleration=9.81)
        return m.BuoyancyForce(m.SeawaterBuoyancy(),
                               gravity_unit_vector=(0.3, -0.2, -1.0))

    jbu, tbu = make(jb), make(tb)
    assert tbu.required_tracers == jbu.required_tracers
    ints = jg.interior_slices
    for name in ("buoyancy_ccc", "x_buoyancy", "y_buoyancy", "z_buoyancy"):
        if not hasattr(jbu, name):
            assert not hasattr(tbu, name), name
            continue
        want = getattr(jbu, name)(jg, jf)
        got = getattr(tbu, name)(tg, tf)
        assert (want is None) == (got is None), name
        if want is not None:
            assert _rel(got[ints].numpy(), np.asarray(want)[ints]) <= TOL, \
                name
