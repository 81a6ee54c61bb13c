"""The card's float32 rate on each body of the operation mix: the port's
counterpart of ``scripts/vpu_mix_probe.py``.

    python -m oceananigans_tpu_torch.tools.vpu_mix_probe
    python -m oceananigans_tpu_torch.tools.vpu_mix_probe --slab full
    python -m oceananigans_tpu_torch.tools.vpu_mix_probe --device cpu --reps 2

The protocol is the script's: ``reps`` (2000) passes over a float32 slab, one
body a pass folded back into the slab (``kernels.vpu_probes.vpu_mix``,
kernel #12b), for an all-FMA chain (32 operations), the WENO-5 body with
products for its divisions, with exact divisions, with exact reciprocals,
and with the approximate reciprocal the JAX TPU kernels take for the
weights (87 operations each); 7 more operations a pass for the loop. The
rate is the operations over the median of 5 calls (CUDA events on the
card), against the card's float32 peak (SMs × 128 lanes × 2 × the maximum
SM clock). With ``--device cpu`` the plain version runs under the host
clock: the rate is then the CPU's and no device metric. Prints one JSON line
per body.
"""

import json
import sys

from ..defaults import resolve_device
from ..kernels import vpu_probes as V
from . import probe_common as pc


def run(device, shape=V.SLAB, reps=V.MIX_REPS):
    """One dict per body (the script's fields and the card's)."""
    x = pc.slab(shape, device)
    peak = pc.peak(device)
    out = []
    for body, (_, flop, _) in V.BODIES.items():
        ms = pc.time_ms(lambda: V.vpu_mix(x, body, reps), device)
        tf = x.numel() * reps * (flop + V.MIX_LOOP_FLOP) / (ms * 1e-3) / 1e12
        out.append(dict(
            variant=body, tflops=tf,
            fraction_of_fma_peak=tf / peak["tflops"] if peak else None,
            ms=ms, reps=reps, slab=list(shape), flop_per_pass=flop,
            fma_peak_tflops=peak["tflops"] if peak else None,
            **pc.card(device)))
    return out


def main(argv=None):
    args = pc.parser(__doc__.splitlines()[0], V.MIX_REPS).parse_args(argv)
    device = resolve_device(args.device)
    for line in run(device, pc.slab_shape(args.slab, device), args.reps):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
