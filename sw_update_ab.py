"""A/B of the fused shallow-water stage (#8, ``csrc/sw_kernel.cuh``) between
checkouts of the repo, on one card.

Each checkout's ``csrc/fused_shallow_water.cu`` is built with the sources
WENO(5) needs beside it (``advection_k3.cu``, which holds #8's buffer-3
instantiation, and ``halo_fill.cu``, which holds ``oc_error_string``),
with the flags of its ``kernels/build.py``, all checkouts at once; the
library is loaded with lazy binding, so the other buffers' instantiations
may stay unbuilt. Then for each checkout root given, in order, a process of
its own times ``fused_sw_update``'s G⁻ variant at 16392² in float32
(WENO(5), f = 0: the inputs and the timer of the shallow-water phase of
that checkout's ``chip_smoke.py``), five medians of ten calls each. Each
prints one JSON line; the last line gives every root's median of medians.
Alternate the order to spread the card's drift over both, for example::

    python3 sw_update_ab.py parent_out/tree . . parent_out/tree

Exits with another code than 0 when a process fails or there is no card.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

N = 16392
ROUNDS = 5


def build_sw(build):
    """The checkout's #8 sources for WENO(5) built into one library in its
    ``_build`` directory (reused when present); returns it loaded, with the
    checkout's signatures of the entries it holds."""
    sources = [build.CSRC_DIR / "fused_shallow_water.cu",
               build.CSRC_DIR / "advection_k3.cu",
               build.CSRC_DIR / "halo_fill.cu"]
    out = build.BUILD_DIR / f"ab_sw_{build._source_hash(sources)}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = build.find_nvcc()
        objs = [out.with_name(f"{out.stem}_{s.stem}.o") for s in sources]
        build._run_all([[nvcc] + list(build.NVCC_FLAGS)
                        + ["-c", "-o", str(o), str(s)]
                        for s, o in zip(sources, objs)])
        build._run_all([[nvcc] + list(build.NVCC_FLAGS[:2])
                        + ["-shared", "-o", str(out)]
                        + [str(o) for o in objs]])
    lib = ctypes.CDLL(str(out), mode=os.RTLD_LAZY)
    for name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.oc_error_string.argtypes = [ctypes.c_int]
    lib.oc_error_string.restype = ctypes.c_char_p
    return lib


def child(root, build_only=False):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    import oceananigans_tpu_torch as ot
    from oceananigans_tpu_torch import kernels as K
    from oceananigans_tpu_torch.kernels import build
    import chip_smoke as cs
    assert build.__file__.startswith(root), build.__file__
    build._lib = build_sw(build)
    if build_only:
        return
    grid, fields, hB, Gm = cs.sw_kernel_inputs(N, torch.float32, (), seed=4)
    args = (grid, ot.WENO(5), 9.81, 0.0, hB, cs.SW_NAMES, fields, Gm, 2e-5,
            -1e-5)
    ms = [cs.cuda_ms(lambda: K.fused_sw_update(*args)) for _ in range(ROUNDS)]
    print(json.dumps(dict(root=root, shape=list(grid.padded_shape), ms=ms,
                          median=statistics.median(ms))), flush=True)


def main(roots):
    if not roots:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    builds = [subprocess.Popen([sys.executable, __file__, "--build", root])
              for root in dict.fromkeys(roots)]
    if any([p.wait() != 0 for p in builds]):
        raise SystemExit("a build failed")
    by_root = {}
    for root in roots:
        p = subprocess.run([sys.executable, __file__, "--child", root],
                           capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            raise SystemExit(f"{root}: exit {p.returncode}")
        line = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        by_root.setdefault(line["root"], []).extend(line["ms"])
    print(json.dumps({r: statistics.median(v) for r, v in by_root.items()}))


if __name__ == "__main__":
    if sys.argv[1:2] in (["--child"], ["--build"]):
        child(sys.argv[2], build_only=sys.argv[1] == "--build")
    else:
        main(sys.argv[1:])
