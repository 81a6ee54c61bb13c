"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles to an object with its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects into
a shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/liboceananigans_kernels_<hash>.so *.o

The build happens at first use (never at import), from the package's own
sources, into ``oceananigans_tpu_torch/_build/``. The file name carries a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
is reused. ``nvcc`` is looked up in ``$CUDA_HOME/bin``, then
``/usr/local/cuda/bin``, then ``PATH``. ``compile_log`` keeps what the
compilers printed (``-Xptxas -v``: registers, spills, shared memory per
kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Flags of one source beside NVCC_FLAGS: the bounded #6 contracts no
# product and sum into an FMA, so that its reconstructions round as its
# plain version's do (the limiter's ratios amplify a difference of an ulp
# near the bounds).
SOURCE_FLAGS = {f"advection_bounded_k{k}.cu": ("-fmad=false",)
                for k in range(2, 7)}

_lock = threading.Lock()
_lib = None
build_seconds = None        # wall time of this process's build, or 0.0 if reused
source_seconds = {}         # each source's nvcc wall time in this process's build
compile_log = ""            # the compilers' output of this process's build

P = ctypes.c_void_p
I = ctypes.c_int
D = ctypes.c_double

# C entry points: name -> argtypes. Every entry returns the launch's
# cudaGetLastError() as an int.
SIGNATURES = {
    "oc_fill_params_size": [],
    "oc_fill_plan": [P, I, I, P, P, P, P, P, P, P, P, P],
    "oc_fill_halos": [P, P, I, P, P, P],
    "oc_advection_tendency": [I, I, I, I, P, P, I, I, P, I, I, I, I, I, I,
                              I, D, D, D, D, P, I, I, I, I, I, I, I, P],
    "oc_fused_divergence": [I, P, P, P, P, I, I, I, I, I, D, D, D, D, P],
    "oc_fused_correct": [I, P, P, P, P, P, P, P, I, I, I, I, I,
                         D, D, D, D, P],
    "oc_fused_advection_update": [I, I, I, I, P, P, P, P, P, P, I, I, I, I,
                                  I, I, I, D, D, D, D, D, D, D, D, D, D, P,
                                  I, I, I, I, I, I, I, P],
    "oc_fused_sw_update": [I, I, I, I, P, P, P, I, I, P, P, P, I, I, I, I,
                           D, D, D, D, D, D, D, D, D, D, P, I, I, I, I, I, I,
                           P],
    "oc_advection_blocks_per_sm": [I, I, I, I, I, I, I, I, I, I, I, P],
    "oc_advection_tendency_bounded": [I, I, I, P, P, I, I, P, I, I, I, I, I,
                                      I, I, D, D, D, D, D, D, P, I, I, I, I,
                                      I, I, I, P],
    "oc_advection_bounded_blocks_per_sm": [I, I, I, I, I, I, I, I, I, I, P],
    "oc_fused_sw_update_blocks_per_sm": [I, I, I, I, I, I, I, I, P],
    "oc_vi_set_tables": [P, P, I],
    "oc_fused_vi_tendency": [I, I, P, P, P, P, P, P, I, I, I, I, I, I, P],
    "oc_vi_blocks_per_sm": [I, I, P, I, I, I, I, I, P],
    "oc_mesh_halo_exchange": [P, P, P, I, I, I, I, I, I, I, I, P],
    "oc_mesh_fold_exchange": [P, P, P, I, I, I, I, I, I, I, I, I, P],
    "oc_weno_microbench": [I, P, P, I, I, D, P],
    "oc_vpu_mix": [I, P, P, I, I, D, P],
    "oc_bf16_smoothness": [I, P, P, I, I, P],
}


def find_nvcc():
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _source_hash(sources):
    h = hashlib.sha256()
    for f in sources + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; wait for every one; return their
    output and each one's wall time from the start, raising if any
    failed."""
    t0 = time.perf_counter()
    done = [None] * len(cmds)

    def run(n):
        p = subprocess.run(cmds[n], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        done[n] = (p.returncode, p.stdout, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(n,))
               for n in range(len(cmds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for cmd, (rc, text, _) in zip(cmds, done):
        if rc != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + text)
    return [d[1] for d in done], [d[2] for d in done]


def build():
    """Compile the kernels if no library for the current sources exists;
    return the library's path."""
    global build_seconds, compile_log, source_seconds
    sources = sorted(CSRC_DIR.glob("*.cu"))
    key = _source_hash(sources)
    out = BUILD_DIR / f"liboceananigans_kernels_{key}.so"
    if out.exists():
        if build_seconds is None:
            build_seconds = 0.0
        return out
    objdir = BUILD_DIR / f"obj_{key}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    objs = [objdir / (s.stem + ".o") for s in sources]
    t0 = time.perf_counter()
    logs, seconds = _run_all([[nvcc] + list(NVCC_FLAGS)
                              + list(SOURCE_FLAGS.get(s.name, ()))
                              + ["-c", "-o", str(o), str(s)]
                              for s, o in zip(sources, objs)])
    source_seconds = {s.name: t for s, t in zip(sources, seconds)}
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    logs += _run_all([[nvcc] + list(NVCC_FLAGS[:2]) + ["-shared", "-o",
                                                       str(tmp)]
                      + [str(o) for o in objs]])[0]
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    compile_log = "".join(logs)
    return out


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def check(rc, lib):
    """Raise if a C entry of ``lib`` reported a CUDA error for its launch."""
    if rc != 0:
        msg = lib.oc_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (error {rc})")


def stream_of(t):
    """PyTorch's current CUDA stream on the tensor's device, as a pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def load(path):
    """Load a kernel library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.oc_error_string.argtypes = [ctypes.c_int]
    lib.oc_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


# Fields one launch of a batched kernel takes: their pointers ride in the
# kernel's parameter block (kBatch in csrc/advection_stencils.cuh and
# csrc/fused_shallow_water.cu, kMaxFields in csrc/halo_fill.cu). A call with
# more fields launches once per batch.
BATCH = 32


def batches(n):
    """(first, stop) of each launch's fields, for n fields."""
    return [(a, min(n, a + BATCH)) for a in range(0, n, BATCH)]


def pointers(tensors):
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
