"""Distributed architecture: device meshes and domain decomposition.

Counterpart of ``oceananigans_tpu/parallel/distributed.py``. The JAX package
is single-controller: one process, a ``jax.sharding.Mesh`` over the chips
with axes ("x", "y"), and ``shard_map`` regions that see per-shard blocks.
The port keeps that design: a ``Distributed`` architecture holds a ``Mesh``,
an (Sx, Sy) array of ``torch.device``s with axis names ("x", "y"), and the
sharded stages (``kernels/fused_shallow_water.py``
``build_sharded_fused_sw_update``, ``kernels/fused_advection.py``
``build_sharded_fused_advection``) cut the global-view fields into per-shard
padded blocks on those devices, fill the blocks' halos from their neighbours
(``parallel/halo_exchange.py``), run the single-device kernel on each block
and stitch the interiors back together.

An explicit ``devices=`` list may name one device several times: the
counterpart of JAX's virtual CPU devices. Blocks on one device then exchange
their strips through a kernel, blocks on different devices through peer
copies. The model state stays global-view on the mesh's first device
(``Distributed.shard``); a model built with a ``Distributed`` architecture
takes that device as its grid's device.
"""

from __future__ import annotations

import numpy as np
import torch


class CPU:
    """Single-device architecture marker. Models take ``architecture=CPU()``
    for reference-script compatibility and treat it as the default: the
    grid's own device."""

    mesh = None

    def __repr__(self):
        return "CPU()"


class GPU(CPU):
    """Single-accelerator architecture marker: the default, as ``CPU()``."""

    def __repr__(self):
        return "GPU()"


class Equal:
    """Equal split along a direction: ``Partition(x=Equal(), y=2)`` divides
    x over whatever device count remains. Every split is equal: this is the
    only split kind that shards."""

    def __repr__(self):
        return "Equal()"


class Fractional:
    """Uneven fractional split (reference: Fractional(ϵ₁, ϵ₂, …)): an MPI
    load-balancing device; every shard here is an equal tile, so this
    raises."""

    def __init__(self, *fractions):
        raise NotImplementedError(
            "Fractional partitions are an MPI load-balancing device; under "
            "GSPMD all shards are equal tiles on homogeneous TPU chips. "
            "Use Partition(x=<int>) or Partition(x=Equal()).")


class Sizes:
    """Explicit per-rank sizes (reference: Sizes(n₁, n₂, …)); see
    :class:`Fractional`."""

    def __init__(self, *sizes):
        raise NotImplementedError(
            "Sizes partitions are an MPI load-balancing device; under GSPMD "
            "all shards are equal tiles on homogeneous TPU chips. "
            "Use Partition(x=<int>) or Partition(x=Equal()).")


def XPartition(n):
    """Reference-API alias: n x-slabs, a device-mesh Partition along x."""
    return Partition(x=int(n))


def YPartition(n):
    """n y-slabs; see :func:`XPartition`."""
    return Partition(y=int(n))


def CubedSpherePartition(*args, **kw):
    """The reference's MultiRegion cubed-sphere panel distribution: not a
    partition object here."""
    raise NotImplementedError(
        "CubedSpherePartition is a MultiRegion (explicit per-device region)"
        " concept; the GSPMD path shards the panel-batched cubed-sphere "
        "state instead — construct the model with architecture="
        "Distributed(...) (see docs/tpu_design.md).")


class Partition:
    """Rank layout (reference: Partition{Sx,Sy,Sz}): ``x`` and ``y`` are the
    number of shards along each horizontal direction (an int, or
    ``Equal()`` to divide the remaining devices); z is never sharded."""

    def __init__(self, x=1, y=1):
        self._equal_axis = None
        if isinstance(x, Equal):
            self._equal_axis, x = 0, 0
        if isinstance(y, Equal):
            if self._equal_axis is not None:
                raise ValueError("only one direction may be Equal()")
            self._equal_axis, y = 1, 0
        self.x = int(x)
        self.y = int(y)

    def resolve(self, n_devices):
        """Fill an ``Equal()`` direction from the device count."""
        if self._equal_axis is None:
            return self
        other = self.y if self._equal_axis == 0 else self.x
        other = max(other, 1)
        if n_devices % other:
            raise ValueError(f"{n_devices} devices do not divide over "
                             f"Partition with fixed factor {other}")
        p = Partition(x=self.x or 1, y=self.y or 1)
        if self._equal_axis == 0:
            p.x = n_devices // other
        else:
            p.y = n_devices // other
        return p

    def __repr__(self):
        return f"Partition(x={self.x}, y={self.y})"


class Mesh:
    """An (Sx, Sy) array of ``torch.device``s (``devices``, a numpy object
    array) with the axis names ("x", "y"). Shard (i, j) holds the block of
    the i-th x range and the j-th y range."""

    def __init__(self, devices, axis_names=("x", "y")):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    def __repr__(self):
        return (f"Mesh(shape={self.devices.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def same_device(a, b):
    """Whether two devices are the same (``cuda`` names the current card)."""
    return _normalize(torch.device(a)) == _normalize(torch.device(b))


def _normalize(dev):
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Distributed:
    """Device-mesh architecture.

    Usage::

        arch = Distributed(Partition(x=2, y=2))        # 4 cards
        arch = Distributed(Partition(2, 2),
                           devices=[torch.device("cuda:0")] * 4)  # 1 card
        model = ShallowWaterModel(grid, ..., architecture=arch)

    ``devices`` defaults to every visible CUDA card; with none it raises, as
    a grid built for the default device does. A list may name a device more
    than once. ``partition`` defaults to the squarest split of the devices.
    """

    def __init__(self, partition=None, devices=None):
        if devices is None:
            n_cuda = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if n_cuda == 0:
                raise RuntimeError(
                    "Distributed() defaults to the visible CUDA devices and "
                    "there are none; pass devices=[torch.device(\"cpu\")] * n "
                    "to build a mesh on the CPU")
            devices = [torch.device("cuda", i) for i in range(n_cuda)]
        devices = [_normalize(torch.device(d)) for d in devices]
        n = len(devices)
        if partition is None:
            px = int(np.floor(np.sqrt(n)))
            while n % px:
                px -= 1
            partition = Partition(px, n // px)
        partition = partition.resolve(n)
        need = partition.x * partition.y
        if need > n:
            raise ValueError(f"partition {partition} needs {need} devices, "
                             f"have {n}")
        self.partition = partition
        dev_array = np.empty(need, dtype=object)
        dev_array[:] = devices[:need]
        self.mesh = Mesh(dev_array.reshape(partition.x, partition.y))

    @property
    def device(self):
        """The device that holds the global-view state: the mesh's first."""
        return self.mesh.devices[0, 0]

    def shard(self, state):
        """The state (nested dicts, lists and tuples of tensors and scalars)
        as global-view tensors on the mesh's first device."""
        if isinstance(state, torch.Tensor):
            return state.to(self.device)
        if isinstance(state, dict):
            return {k: self.shard(v) for k, v in state.items()}
        if isinstance(state, (list, tuple)):
            return type(state)(self.shard(v) for v in state)
        return state

    def validate_grid(self, grid):
        """The interior must divide the mesh along x and y: the sharded
        stages cut it into equal blocks. (The JAX check is on the padded
        extent, a GSPMD tiling rule that the port's blocks do not have.)"""
        px, py = self.partition.x, self.partition.y
        nx, ny = grid.N[0], grid.N[1]
        if nx % px or ny % py:
            raise ValueError(
                f"interior ({nx}, {ny}) not divisible by partition "
                f"({px}, {py}); choose N so that Nx % {px} == 0 and "
                f"Ny % {py} == 0")

    def place(self, grid):
        """The grid a model on this architecture runs on: ``grid`` itself,
        which must live on the mesh's first device (a grid on another device
        raises rather than being moved)."""
        if not same_device(grid.device, self.device):
            raise ValueError(
                f"the grid lives on {grid.device} but the mesh's first "
                f"device is {self.device}; build the grid with "
                f"device={str(self.device)!r}")
        self.validate_grid(grid)
        return grid

    def __repr__(self):
        return f"Distributed({self.partition}, {self.mesh})"


def regularize_architecture(architecture):
    """None for the default (``None``, ``CPU()`` or ``GPU()``), else the
    ``Distributed`` architecture."""
    if architecture is None or isinstance(architecture, CPU):
        return None
    if not isinstance(architecture, Distributed):
        raise TypeError(f"unknown architecture {architecture!r}")
    return architecture
