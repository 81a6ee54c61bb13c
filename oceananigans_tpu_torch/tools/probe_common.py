"""What the probe entry points share: the device, the card's name, power
limit and float32 peak, and the timing of one call."""

import argparse
import statistics
import subprocess
import time

import torch

from ..kernels.vpu_probes import SLAB

THREADS_PER_SM = 2048       # Hopper's resident threads per SM
FP32_LANES_PER_SM = 128     # Hopper: four sub-partitions of 32 FP32 lanes


def parser(description, reps=None):
    """--device and --slab, and --reps with the default ``reps`` if given."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain version)")
    p.add_argument("--slab", default="256x256",
                   help="ROWSxCOLS, or 'full': enough rows of 256 for one "
                        "thread on every resident-thread slot of the card")
    if reps is not None:
        p.add_argument("--reps", type=int, default=reps,
                       help=f"passes over the slab (the script's {reps})")
    return p


def slab_shape(spec, device):
    """(rows, cols) of ``--slab``."""
    if spec == "full":
        if device.type != "cuda":
            raise ValueError("--slab full sizes the slab to the card")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return (sms * THREADS_PER_SM // SLAB[1], SLAB[1])
    rows, cols = (int(a) for a in spec.split("x"))
    return rows, cols


def slab(shape, device, scale=1.0):
    """The scripts' slab: numpy's default_rng(0) normals in float32."""
    import numpy as np
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    return torch.as_tensor(scale * x).to(device)


def card(device):
    """The device's name and, for a card, ``nvidia-smi``'s name and power
    limit."""
    if device.type != "cuda":
        return dict(device="cpu")
    smi = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return dict(device=torch.cuda.get_device_name(device), card=smi)


def peak(device):
    """The card's float32 peak outside the tensor cores, from its own
    numbers: SMs × 128 lanes × 2 operations (a multiply-add) × the maximum
    SM clock that ``nvidia-smi`` reports; each factor and the product in
    Tflop/s. None on the CPU."""
    if device.type != "cuda":
        return None
    index = device.index or 0
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    mhz = float(out.strip().splitlines()[0])
    return dict(sms=sms, fp32_lanes_per_sm=FP32_LANES_PER_SM,
                max_sm_clock_mhz=mhz,
                tflops=sms * FP32_LANES_PER_SM * 2 * mhz * 1e6 / 1e12)


def time_ms(fn, device, ncall=5):
    """Median time of one call of ``fn`` after one warm-up call: CUDA events
    on a card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(ncall):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
