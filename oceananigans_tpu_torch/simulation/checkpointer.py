"""Checkpoint and resume.

Counterpart of ``oceananigans_tpu/simulation/checkpointer.py``, in the same
file layout: one ``<prefix>_iteration<N>.npz`` per snapshot holding the
model's state flattened to named arrays (``fields/u``, ``clock/time``,
``Gm/u``, ``barotropic/U``, ...) and the grid spec as ``__grid_spec__``.

The port's own checkpoints carry one more key, ``__layout__``, and restore
verbatim, halos included, so that a run picked up from one continues bit
for bit; every state entry of the model must be in the file with its shape
and dtype, or ``restore`` raises. A checkpoint without the key was written
by the JAX package: its arrays are in the JAX halo layout, so it restores
through the model's ``state_from_jax``, and, as the JAX ``restore`` does,
an entry the file lacks keeps the model's current value.
"""

from __future__ import annotations

import glob
import importlib
import json
import os
import re

import numpy as np
import torch

from ..utils.schedules import IterationInterval
from .output_writers import to_host

LAYOUT_KEY = "__layout__"
LAYOUT = b"oceananigans_tpu_torch"


def _flatten_state(state, prefix=""):
    out = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_state(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(arrays):
    out = {}
    for key, v in arrays.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


class Checkpointer:
    def __init__(self, model, schedule=None, dir=".", prefix="checkpoint",
                 keep=None):
        self.model = model
        self.schedule = schedule or IterationInterval(1000)
        self.dir = dir
        self.prefix = prefix
        self.keep = keep
        os.makedirs(dir, exist_ok=True)

    def path(self, iteration):
        return os.path.join(self.dir, f"{self.prefix}_iteration{iteration}.npz")

    def write(self, sim):
        model = sim.model
        arrays = {k: to_host(v) for k, v in _flatten_state(model.state).items()}
        from ..grids.reconstruction import constructor_arguments
        try:
            arrays["__grid_spec__"] = np.frombuffer(
                json.dumps(constructor_arguments(model.grid)).encode(),
                dtype=np.uint8)
        except NotImplementedError:
            pass      # a grid class without a spec still checkpoints
        arrays[LAYOUT_KEY] = np.frombuffer(LAYOUT, dtype=np.uint8)
        np.savez(self.path(model.iteration), **arrays)
        if self.keep:
            files = sorted(glob.glob(os.path.join(
                self.dir, f"{self.prefix}_iteration*.npz")),
                key=_iteration_of)
            for f in files[:-self.keep]:
                os.remove(f)

    def maybe_write(self, sim, force=False):
        if force:
            return      # no checkpoint at the run's start
        if self.schedule(sim.model):
            self.write(sim)


def _iteration_of(path):
    m = re.search(r"iteration(\d+)\.npz$", path)
    return int(m.group(1)) if m else -1


def checkpoint_grid(path, device=None):
    """The grid recorded in a checkpoint, rebuilt on ``device``; None when
    the file holds no grid spec."""
    from ..grids.reconstruction import reconstruct_grid
    with np.load(path) as data:
        if "__grid_spec__" not in data.files:
            return None
        spec = json.loads(bytes(data["__grid_spec__"]).decode())
    return reconstruct_grid(spec, device=device)


def _restore_verbatim(model, arrays, path):
    want = _flatten_state(model.state)
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint {path} does not hold this model's "
                         f"state: missing {missing}, unexpected {extra}")
    flat = {}
    for key, ref in want.items():
        a = arrays[key]
        if isinstance(ref, torch.Tensor):
            if tuple(a.shape) != tuple(ref.shape) or a.dtype != \
                    torch.empty((), dtype=ref.dtype).numpy().dtype:
                raise ValueError(
                    f"checkpoint {path}: {key} is {a.dtype} {a.shape}, the "
                    f"model holds {ref.dtype} {tuple(ref.shape)}")
            flat[key] = torch.as_tensor(a, device=ref.device).clone()
        else:
            flat[key] = type(ref)(a[()])
    model.state = _unflatten(flat)


def _restore_from_jax(model, arrays):
    """A JAX-written state into the model through its ``state_from_jax``;
    entries the file lacks keep the model's current values."""
    state = _unflatten(arrays)
    current = {k: ({kk: to_host(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else to_host(v))
               for k, v in model.state.items()}
    for k, v in current.items():
        if isinstance(v, dict) and isinstance(state.get(k), dict):
            state[k] = {**v, **state[k]}
        else:
            state.setdefault(k, v)
    module = importlib.import_module(type(model).__module__)
    module.state_from_jax(state, model)


def restore(model, path):
    """Restore the model's state from a checkpoint file: verbatim from the
    port's own, through ``state_from_jax`` from the JAX package's."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if not k.startswith("__")}
        own = LAYOUT_KEY in data.files
    if own:
        _restore_verbatim(model, arrays, path)
    else:
        _restore_from_jax(model, arrays)
    return model


def restore_latest(model, pickup, checkpointers=()):
    """``pickup=True``: the newest checkpoint of the given Checkpointers
    (their dir and prefix), else ``checkpoint_iteration*.npz`` in the
    working directory; ``pickup=<path>``: that file."""
    if pickup is True:
        patterns = [os.path.join(cp.dir, f"{cp.prefix}_iteration*.npz")
                    for cp in checkpointers] or ["checkpoint_iteration*.npz"]
        files = []
        for pat in patterns:
            files.extend(glob.glob(pat))
        files = sorted(files, key=_iteration_of)
        if not files:
            raise FileNotFoundError(
                f"no checkpoint files found for pickup ({patterns})")
        path = files[-1]
    else:
        path = pickup
    return restore(model, path)
