"""The port's flat namespace holds the JAX package's: every name that
``oceananigans_tpu/__init__.py`` binds (by import, definition or
assignment) is bound by ``oceananigans_tpu_torch/__init__.py`` too, found by
parsing both files with ``ast``, and each resolves on the imported port; the
names for what exists only in the JAX package's TPU layer raise when used,
as the JAX package's own ``CubedSpherePartition`` does."""

import ast
from pathlib import Path

import pytest

import oceananigans_tpu_torch as ot

REPO = Path(__file__).resolve().parent.parent


def _bound_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        body = node.body if isinstance(node, ast.Try) else [node]
        for n in body:
            if isinstance(n, (ast.Import, ast.ImportFrom)):
                names.update(a.asname or a.name.split(".")[0]
                             for a in n.names)
            elif isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, ast.Assign):
                names.update(t.id for t in n.targets
                             if isinstance(t, ast.Name))
    return names


JAX_NAMES = sorted(_bound_names(REPO / "oceananigans_tpu" / "__init__.py"))
PORT_NAMES = _bound_names(REPO / "oceananigans_tpu_torch" / "__init__.py")


def test_every_jax_name_is_exported():
    missing = [n for n in JAX_NAMES if n not in PORT_NAMES]
    assert not missing, missing
    assert len(JAX_NAMES) > 200


def test_every_name_resolves_and_is_public():
    for name in JAX_NAMES:
        getattr(ot, name)
        assert name.startswith("__") or name in ot.__all__, name


def test_tpu_layer_names_raise():
    with pytest.raises(NotImplementedError):
        ot.CubedSpherePartition()


def test_free_functions_on_a_grid():
    grid = ot.RectilinearGrid(size=(4, 3, 2), extent=(2.0, 3.0, 1.0),
                              device="cpu")
    assert ot.xnodes(grid, ot.Center()).shape == (4,)
    assert ot.znodes(grid, ot.Face()).shape == (3,)
    assert ot.minimum_xspacing(grid) == 0.5
    assert ot.minimum_zspacing(grid) == 0.5
    assert ot.volume(grid) == 0.5 * 1.0 * 0.5
    model = ot.NonhydrostaticModel(grid, tracers=("c",))
    ot.set(model, c=1.0)
    ot.time_step(model, 0.01)
    assert ot.iteration(model) == 1
    assert float(ot.interior(model.field("c")).mean()) == pytest.approx(1.0)
    clock = ot.Clock(time=30.0, iteration=5, dtype=model.dtype)
    assert clock["iteration"] == 5 and float(clock["time"]) == 30.0
    panel = ot.ConformalCubedSpherePanel((4, 4, 2), panel=1, z=(-10, 0),
                                         device="cpu")
    assert panel.N == (4, 4, 2)
    assert ot.OceananigansLogger().name == "oceananigans_tpu_torch"
