"""Every advection scheme of the CUDA advection kernels (#1, #6 and #8), on
the CPU.

The kernels take Centered(2-12), UpwindBiased(1-11) and WENO(3-11), each
with its near-wall order cascade along a bounded z, from the coefficient
table of ``kernels/fused_advection.py`` ``coefficient_table`` (the layout of
``csrc/reconstruction.cuh``). Two kinds of test, with no card:

- the table, evaluated in numpy as the kernels evaluate it (cell n of the
  selected line, WENO-Z with the table's factors, weights and τ
  coefficients, the cascade level from the z index), against the plain
  scheme's ``biased_by`` and ``symmetric`` on random lines, both signs, on
  a bounded z whose every cascade level is hit and along a periodic x: all
  17 schemes, float64, bound 1e-13 relative to max|plain| (the same
  operations in the same order);
- the plain versions of #6 and #8 against the JAX package's Pallas kernels
  in interpret mode (#1's in tests/test_torch_schemes_update.py), float64
  with float64 smoothness, bound 1e-12 relative to max|JAX|: #6 padded
  with a bounded z (so the cascade is hit), #8 with bathymetry, an f-plane
  and a tracer; at WENO(9), WENO(11),
  UpwindBiased(5), Centered(4) and Centered(12). Both sides take H = (8, 8)
  in x and y (the JAX kernels need 2Hy % 8 == 0, and #8 Hx % 8 == 0).

The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py (phase 25) and tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceananigans_tpu.advection import Centered as JCentered
from oceananigans_tpu.advection import UpwindBiased as JUpwind
from oceananigans_tpu.advection import WENO as JWENO
from oceananigans_tpu.coriolis import FPlane as JFPlane
from oceananigans_tpu.grids import RectilinearGrid as JGrid
from oceananigans_tpu.kernels.fused_advection import build_fused_advection
from oceananigans_tpu.kernels.fused_shallow_water import build_fused_sw_update
import oceananigans_tpu_torch as ot
from oceananigans_tpu_torch import kernels as K
from oceananigans_tpu_torch.kernels.fused_advection import (
    CENTERED, WENO_FAMILY, coefficient_table, count_launch, scheme_code,
    table_layout, variant_name)

torch.set_num_threads(1)

F64 = torch.float64

# every scheme the kernels take, as the port builds it (float64 smoothness)
SCHEMES = {
    **{f"Centered({o})": (lambda o=o: ot.Centered(o))
       for o in range(2, 13, 2)},
    **{f"UpwindBiased({o})": (lambda o=o: ot.UpwindBiased(o))
       for o in range(1, 12, 2)},
    **{f"WENO({o})": (lambda o=o: ot.WENO(o, smoothness_dtype=F64))
       for o in range(3, 12, 2)},
}

# the schemes held against the JAX kernels: (port, JAX)
JAX_SCHEMES = {
    "WENO(9)": (lambda: ot.WENO(9, smoothness_dtype=F64),
                lambda: JWENO(9, smoothness_dtype=jnp.float64)),
    "WENO(11)": (lambda: ot.WENO(11, smoothness_dtype=F64),
                 lambda: JWENO(11, smoothness_dtype=jnp.float64)),
    "UpwindBiased(5)": (lambda: ot.UpwindBiased(5), lambda: JUpwind(5)),
    "Centered(4)": (lambda: ot.Centered(4), lambda: JCentered(4)),
    "Centered(12)": (lambda: ot.Centered(12), lambda: JCentered(12)),
}

TOL_TABLE = 1e-13
TOL_JAX = 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# -- the table in numpy, as the kernels read it -----------------------------

class TableEvaluator:
    """The kernels' reconstructions (csrc/reconstruction.cuh) from the
    coefficient table, over numpy lines: ``line(o)`` is the array of the
    values at offset o from every reconstruction point."""

    def __init__(self, scheme):
        self.fam, self.K = scheme_code(scheme)
        self.tab = np.asarray(list(coefficient_table(scheme)))
        self.lay = table_layout(self.K)

    def row(self, part, b, n):
        return self.tab[self.lay[part][b]:self.lay[part][b] + n]

    def centered(self, B, beta, line):
        c = self.row("sym", B, 2 * B)
        acc = c[0] * line(beta - B)
        for n in range(1, 2 * B):
            acc = acc + c[n] * line(beta - B + n)
        return acc

    def symmetric(self, B, beta, line):
        Bv = B if self.fam == CENTERED else max(B - 1, 1)
        return self.centered(Bv, beta, line)

    def biased(self, B, beta, pos, line):
        def cell(n):
            return np.where(pos, line(beta - B + n), line(beta + B - 1 - n))
        if self.fam == WENO_FAMILY and B >= 2:
            return self.weno(B, cell)
        if self.fam == CENTERED:
            c, L = self.row("sym", B, 2 * B), 2 * B
        else:
            c, L = self.row("ub", B, 2 * B - 1), 2 * B - 1
        acc = c[0] * cell(0)
        for n in range(1, L):
            acc = acc + c[n] * cell(n)
        return acc

    def weno(self, B, cell):
        wc = self.row("wc", B, B * B).reshape(B, B)
        wf = self.row("wf", B, B ** 3).reshape(B, B, B)
        wg, wt = self.row("wg", B, B), self.row("wt", B, B)
        eps, rmax = self.tab[self.lay["eps"]], self.tab[self.lay["eps"] + 1]
        ps, bs = [], []
        for s in range(B):
            o = B - 1 - s
            acc = wc[s, 0] * cell(o)
            for j in range(1, B):
                acc = acc + wc[s, j] * cell(o + j)
            ps.append(acc)
            beta = 0.0
            for m in range(B):
                lin = wf[s, m, 0] * cell(o)
                for j in range(1, B):
                    lin = lin + wf[s, m, j] * cell(o + j)
                beta = beta + lin * lin
            bs.append(beta)
        tau = bs[0]
        for s in range(1, B):
            if wt[s] != 0:
                tau = tau + wt[s] * bs[s]
        tau = np.abs(tau)
        num = den = 0.0
        for s in range(B):
            r = np.minimum(tau / (bs[s] + eps), rmax)
            alpha = wg[s] * (1.0 + r * r)
            num = num + alpha * ps[s]
            den = den + alpha
        return num / den

    def levels(self, N, beta):
        """The buffer at each index of a bounded axis of N cells."""
        out = np.ones(N, dtype=int)
        for k in range(N):
            for B in range(self.K, 1, -1):
                if B - beta <= k <= N - B:
                    out[k] = B
                    break
        return out


@pytest.mark.parametrize("name", list(SCHEMES))
def test_table_reproduces_plain_scheme(name):
    """Along the bounded z (every cascade level) and the periodic x, both
    orientations β = 0, 1, both signs of the advecting velocity."""
    scheme = SCHEMES[name]()
    ev = TableEvaluator(scheme)
    K_ = ev.K
    N = (9, 3, 2 * K_ + 5)
    H = (K_, 1, K_)
    grid = ot.RectilinearGrid(size=N, extent=(1.0, 1.0, 1.0), halo=H,
                              dtype=F64, device="cpu")
    rng = np.random.default_rng(40 + K_)
    a = rng.standard_normal(grid.padded_shape)
    q = rng.standard_normal(grid.padded_shape)
    ta, tq = torch.as_tensor(a), torch.as_tensor(q)
    lev = {b: ev.levels(N[2], b) for b in (0, 1)}
    for beta in (0, 1):
        # along z: the interior z slots of every column
        def zline(o, arr=a):
            return arr[:, :, H[2] + o:H[2] + o + N[2]]
        pos = zline(0, q) > 0
        want = scheme.biased_by(grid, ta, 2, beta, tq)[..., H[2]:H[2] + N[2]]
        got = np.empty_like(want.numpy())
        sym_want = scheme.symmetric(grid, ta, 2, beta)[..., H[2]:H[2] + N[2]]
        sym_got = np.empty_like(got)
        for B in range(1, K_ + 1):
            at = lev[beta] == B
            if at.any():
                got[..., at] = ev.biased(B, beta, pos, zline)[..., at]
                sym_got[..., at] = ev.symmetric(B, beta, zline)[..., at]
        assert set(lev[beta]) == set(range(1, K_ + 1))
        assert _rel(got, want) <= TOL_TABLE, (name, "z", beta)
        assert _rel(sym_got, sym_want) <= TOL_TABLE, (name, "z sym", beta)

        # along the periodic x: the scheme's own buffer everywhere
        def xline(o, arr=a):
            return arr[H[0] + o:H[0] + o + N[0]]
        pos = xline(0, q) > 0
        want = scheme.biased_by(grid, ta, 0, beta, tq)[H[0]:H[0] + N[0]]
        assert _rel(ev.biased(K_, beta, pos, xline), want) <= TOL_TABLE, \
            (name, "x", beta)
        want = scheme.symmetric(grid, ta, 0, beta)[H[0]:H[0] + N[0]]
        assert _rel(ev.symmetric(K_, beta, xline), want) <= TOL_TABLE, \
            (name, "x sym", beta)


def test_table_bf16_smoothness_rows():
    """With bfloat16 smoothness only the smoothness part of the table is
    rounded; the linear part equals the float64 table's."""
    for order in (7, 11):
        t = list(coefficient_table(ot.WENO(order,
                                           smoothness_dtype=torch.bfloat16)))
        f = list(coefficient_table(ot.WENO(order, smoothness_dtype=F64)))
        lin = table_layout((order + 1) // 2)["lin"]
        assert t[:lin] == f[:lin]
        assert all(float(torch.tensor(x, dtype=torch.bfloat16)) == y
                   for x, y in zip(f[lin:], t[lin:]))


@pytest.mark.parametrize("name", list(SCHEMES))
def test_launches_counted_by_variant(name):
    """A launch counts once in its kernel's ``launches`` and once under its
    scheme's variant (``centered4``, ``upwind5``, ``weno9``), which
    ``counters()`` reports as ``<kernel>_<variant>`` and
    ``reset_counters()`` clears."""
    scheme = SCHEMES[name]()
    family, order = name[:-1].split("(")
    variant = {"Centered": "centered", "UpwindBiased": "upwind",
               "WENO": "weno"}[family] + order
    assert variant_name(scheme) == variant
    K.reset_counters()
    for kernel in K.VARIANT_KERNELS:
        count_launch(kernel, scheme)
        count_launch(kernel, scheme)
    launches = K.counters()[0]
    for kernel in K.VARIANT_KERNELS:
        assert launches[kernel.__name__] == 2
        assert launches[f"{kernel.__name__}_{variant}"] == 2
    K.reset_counters()
    launches = K.counters()[0]
    assert all(launches[kernel.__name__] == 0 for kernel in K.VARIANT_KERNELS)
    assert not any(k.endswith(variant) for k in launches)


# -- the plain kernels against the JAX Pallas kernels -----------------------

H8 = (8, 8)


def _wrap_xy(a, H):
    return np.pad(a, ((H[0], H[0]), (H[1], H[1])) + ((0, 0),) * (a.ndim - 2),
                  mode="wrap")


@pytest.mark.parametrize("name", list(JAX_SCHEMES))
def test_padded_tendency_against_jax(name):
    """#6 on the padded layout, z halos as given (H = (8, 8, 8)), a bounded
    z of 20 cells: u, v, w and one tracer."""
    tscheme, jscheme = (f() for f in JAX_SCHEMES[name])
    N, halo = (16, 16, 20), H8 + (8,)
    jgrid = JGrid(size=N, extent=(1.0, 2.0, 1.5), halo=halo, dtype=np.float64)
    tgrid = ot.RectilinearGrid(size=N, extent=(1.0, 2.0, 1.5), halo=halo,
                               dtype=F64, device="cpu")
    rng = np.random.default_rng(51)
    shape = (N[0], N[1], N[2] + 2 * halo[2])
    padded = [_wrap_xy(s * rng.standard_normal(shape), H8)
              for s in (0.1, 0.1, 0.1, 1.0)]
    fn = build_fused_advection(jgrid, jscheme, ("c",))
    j = [jnp.asarray(a) for a in padded]
    Gu, Gv, Gw, Gc = fn(j[0], j[1], j[2], {"c": j[3]})
    got = K.fused_advection_tendency(tgrid, tscheme,
                                     [torch.as_tensor(a) for a in padded])
    for k, want in enumerate((Gu, Gv, Gw, Gc["c"])):
        want = np.asarray(want)[tgrid.interior_slices]
        assert _rel(got[k].numpy(), want) <= TOL_JAX, (name, k)


@pytest.mark.parametrize("name", list(JAX_SCHEMES))
def test_shallow_water_against_jax(name):
    """#8 with G⁻, bathymetry, FPlane(0.3) and a tracer at 16 x 24: G and
    the new fields' interiors."""
    tscheme, jscheme = (f() for f in JAX_SCHEMES[name])
    N, halo = (16, 24), H8 + (0,)
    topo = ("periodic", "periodic", "flat")
    jg = JGrid(size=N, extent=(10.0, 10.0), topology=topo, halo=halo,
               dtype=np.float64)
    tg = ot.RectilinearGrid(size=N, extent=(10.0, 10.0), topology=topo,
                            halo=halo, dtype=F64, device="cpu")
    rng = np.random.default_rng(52)
    hB = 0.05 * rng.standard_normal(N)
    init = dict(uh=0.1 * rng.standard_normal(N),
                vh=0.1 * rng.standard_normal(N),
                h=1.0 + 0.05 * rng.standard_normal(N), c=rng.random(N))
    names = ("uh", "vh", "h", "c")
    gm = [rng.standard_normal(N) for _ in names]
    gdt, zdt = 2e-3, -1e-3
    jfn = build_fused_sw_update(jg, jscheme, 9.81, JFPlane(f=0.3),
                                jnp.asarray(_wrap_xy(hB, H8)[..., None]),
                                ("c",))
    ypad = -(-(N[1] + 2 * H8[1]) // 128) * 128
    jgm = [jnp.asarray(np.pad(g, ((0, 0), (H8[1], ypad - N[1] - H8[1]))))
           for g in gm]
    jG, jnew = jfn({n: jnp.asarray(_wrap_xy(init[n], H8)[..., None])
                    for n in names}, jgm, gdt, zdt)
    tG, tnew = K.fused_sw_update(
        tg, tscheme, 9.81, 0.3, torch.as_tensor(_wrap_xy(hB, H8)[..., None]),
        names, {n: torch.as_tensor(_wrap_xy(init[n], H8)[..., None])
                for n in names},
        torch.as_tensor(np.stack(gm)[..., None]), gdt, zdt)
    sy = slice(H8[1], H8[1] + N[1])
    jints = (slice(H8[0], H8[0] + N[0]), sy)
    for k, fname in enumerate(names):
        assert _rel(tG[k, ..., 0].numpy(), np.asarray(jG[k])[:, sy]) \
            <= TOL_JAX, (name, "G", fname)
        assert _rel(tnew[fname][tg.interior_slices].numpy(),
                    np.asarray(jnew[fname])[jints]) <= TOL_JAX, \
            (name, "new", fname)
