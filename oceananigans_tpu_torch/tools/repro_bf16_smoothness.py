"""The bf16-smoothness WENO-5 reconstruction on the card: the port's
counterpart of ``scripts/repro_bf16_smoothness.py``.

    python -m oceananigans_tpu_torch.tools.repro_bf16_smoothness
    python -m oceananigans_tpu_torch.tools.repro_bf16_smoothness --device cpu

On the script's slab (256×256 normals from numpy's default_rng(0)) it runs
``kernels.vpu_probes.bf16_smoothness`` (kernel #12c) with the smoothness in
bfloat16 and, as the script's control, in float32. For each it prints the
script's line (``OK dtype=...: checksum ...``); then one JSON line with both
checksums, the largest bf16-vs-float32 difference of the output, and each
call's median time (CUDA events on the card, the host clock on the CPU).
"""

import json
import sys

import torch

from ..defaults import resolve_device
from ..kernels import vpu_probes as V
from . import probe_common as pc


def run(device, shape=V.SLAB):
    """The measurement as a dict; also prints the script's lines."""
    x = pc.slab(shape, device)
    out = {}
    res = dict(probe="repro_bf16_smoothness", slab=list(shape))
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        out[name] = V.bf16_smoothness(x, dtype)
        res[f"checksum_{name}"] = out[name].double().sum().item()
        res[f"ms_{name}"] = pc.time_ms(lambda: V.bf16_smoothness(x, dtype),
                                       device)
        print(f"OK dtype={name}: checksum {res[f'checksum_{name}']:.6f}",
              flush=True)
    res["max_abs_bf16_vs_float32"] = (out["bfloat16"] - out["float32"]).abs() \
        .max().item()
    res.update(pc.card(device))
    return res


def main(argv=None):
    args = pc.parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(device, pc.slab_shape(args.slab, device))),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
