"""The port stands without JAX: importing it loads no ``jax`` module, and no
source file of the package (nor ``chip_smoke.py`` and ``sw_update_ab.py``,
which drive it on the card) imports ``jax``, the JAX package or
``triton``; importing it builds no kernel. ``h5py``, which the card's
machine lacks, is imported only inside the functions that need it, so
importing the port (its ``simulation`` package included) loads none."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "oceananigans_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py",
                                            REPO / "sw_update_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "oceananigans_tpu", "triton")


def test_import_loads_no_jax():
    code = ("import oceananigans_tpu_torch, oceananigans_tpu_torch.models, "
            "oceananigans_tpu_torch.kernels, "
            "oceananigans_tpu_torch.models.hydrostatic, "
            "oceananigans_tpu_torch.models.free_surfaces, "
            "oceananigans_tpu_torch.grids.latlon, "
            "oceananigans_tpu_torch.grids.orthogonal_spherical_shell, "
            "oceananigans_tpu_torch.grids.tripolar, "
            "oceananigans_tpu_torch.grids.conformal_map, "
            "oceananigans_tpu_torch.grids.cubed_sphere, "
            "oceananigans_tpu_torch.models.shallow_water, "
            "oceananigans_tpu_torch.models.cubed_sphere_shallow_water, "
            "oceananigans_tpu_torch.models.cubed_sphere_hydrostatic, "
            "oceananigans_tpu_torch.grids.stretching, "
            "oceananigans_tpu_torch.kernels.fused_vector_invariant, "
            "oceananigans_tpu_torch.parallel, "
            "oceananigans_tpu_torch.parallel.distributed, "
            "oceananigans_tpu_torch.parallel.halo_exchange, "
            "oceananigans_tpu_torch.parallel.communicator, "
            "oceananigans_tpu_torch.parallel.pencil_fft, "
            "oceananigans_tpu_torch.kernels.vpu_probes, "
            "oceananigans_tpu_torch.tools.weno_vpu_microbench, "
            "oceananigans_tpu_torch.tools.vpu_mix_probe, "
            "oceananigans_tpu_torch.tools.repro_bf16_smoothness, "
            "oceananigans_tpu_torch.simulation, "
            "oceananigans_tpu_torch.simulation.checkpointer, "
            "oceananigans_tpu_torch.simulation.diagnostics, "
            "oceananigans_tpu_torch.simulation.output_writers, "
            "oceananigans_tpu_torch.simulation.output_readers, "
            "oceananigans_tpu_torch.simulation.netcdf_writer, "
            "oceananigans_tpu_torch.simulation.hdf5_writer, "
            "oceananigans_tpu_torch.simulation.netcdf4_writer, "
            "oceananigans_tpu_torch.simulation.variance_dissipation, "
            "oceananigans_tpu_torch.grids.reconstruction, "
            "oceananigans_tpu_torch.abstract_operations, "
            "oceananigans_tpu_torch.api, "
            "oceananigans_tpu_torch.logger, "
            "oceananigans_tpu_torch.particles, "
            "oceananigans_tpu_torch.biogeochemistry, "
            "oceananigans_tpu_torch.fields.function_field, "
            "oceananigans_tpu_torch.fields.regridding, "
            "oceananigans_tpu_torch.models.diagnostic_operations, "
            "oceananigans_tpu_torch.models.ensemble, "
            "oceananigans_tpu_torch.utils.profiling, "
            "oceananigans_tpu_torch.utils, sys; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'oceananigans_tpu', 'triton', 'h5py')]; "
            "assert not bad, bad; "
            "from oceananigans_tpu_torch.kernels import build; "
            "assert build._lib is None")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), (path.name, roots)


def _module_level(node):
    """The nodes of ``node`` outside function bodies."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _module_level(child)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_h5py_lazily(path):
    """No import of h5py outside a function (a class body or a try block
    at module level included)."""
    for node in _module_level(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        assert not any(n.split(".")[0] == "h5py" for n in names), path.name
