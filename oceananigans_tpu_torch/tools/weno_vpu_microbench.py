"""The marginal float32 rate of the WENO-5 body on the card: the port's
counterpart of ``scripts/weno_vpu_microbench.py``.

    python -m oceananigans_tpu_torch.tools.weno_vpu_microbench
    python -m oceananigans_tpu_torch.tools.weno_vpu_microbench --slab full
    python -m oceananigans_tpu_torch.tools.weno_vpu_microbench --device cpu --reps 2

The protocol is the script's: ``reps`` (200) passes over a float32 slab, each
pass K independent WENO-5 bodies folded back into the slab
(``kernels.vpu_probes.weno_microbench``, kernel #12a); the time at K = 8, 16
and 32 is fitted by a line, whose slope is the time of one more body, and
(87 + 3) operations per body and element turn it into Tflop/s. The
denominator is the card's float32 peak from its own numbers (SMs × 128 lanes
× 2 × the maximum SM clock), each factor printed. On the card each point is
the median of 5 calls timed with CUDA events; the residual of the fit says
how far the time is from linear in K. With ``--device cpu`` the plain
version runs under the host clock: the rate is then the CPU's and no device
metric. Prints one JSON line.
"""

import json
import sys

import numpy as np

from ..defaults import resolve_device
from ..kernels import vpu_probes as V
from . import probe_common as pc


def run(device, shape=V.SLAB, reps=V.MICROBENCH_REPS):
    """The measurement as a dict (the script's fields and the card's)."""
    x = pc.slab(shape, device)
    ks = V.MICROBENCH_K
    ms = [pc.time_ms(lambda: V.weno_microbench(x, k, reps), device)
          for k in ks]
    slope, icept = (float(c) for c in np.polyfit(ks, ms, 1))  # ms per body
    resid = [m - (slope * k + icept) for k, m in zip(ks, ms)]
    flop = x.numel() * reps * (V.WENO_FLOP + V.DERIVE_FLOP)
    tf = flop / (slope * 1e-3) / 1e12
    peak = pc.peak(device)
    return dict(
        metric="weno5_body_marginal_tflops", value=tf, unit="Tflop/s",
        reps=reps, slab=list(shape), k_points=list(ks), ms_points=ms,
        fit_residual_ms=resid, ms_per_extra_body=slope,
        fma_peak_tflops=peak["tflops"] if peak else None,
        fraction_of_fma_peak=tf / peak["tflops"] if peak else None,
        fma_peak=peak, **pc.card(device))


def main(argv=None):
    args = pc.parser(__doc__.splitlines()[0],
                     V.MICROBENCH_REPS).parse_args(argv)
    device = resolve_device(args.device)
    out = run(device, pc.slab_shape(args.slab, device), args.reps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
