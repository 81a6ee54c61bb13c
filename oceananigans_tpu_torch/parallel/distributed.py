"""Distributed architecture: device meshes and domain decomposition.

Counterpart of ``oceananigans_tpu/parallel/distributed.py``. The JAX package
places a model's global-view state on a ``jax.sharding.Mesh`` with
``NamedSharding`` and lets GSPMD partition the step; PyTorch has no
partitioner inside one process, so the port decomposes the domain itself,
as Oceananigans' own distributed models do: a ``Distributed`` architecture
holds a ``Mesh``, an (Sx, Sy) array of ``torch.device``s with axis names
("x", "y"), and a model built on it holds each shard's padded block of
every prognostic field on that shard's device for the whole run. Each shard
steps the model's own code on its own local grid (``shard_grid``: the
global grid's nodes and metrics cut at the shard's offset, its sharded
sides marked connected); the shards meet only in the collectives of
``parallel/communicator.py``: the halo exchange (which every halo fill of a
connected grid ends with), the pencil transposes of the pressure solver
(``parallel/pencil_fft.py``) and reductions.

``scatter`` cuts global padded tensors into the blocks (halos included, so
a block's halos hold the global view's values there) and puts each on its
shard's device; ``gather`` puts the blocks back together on the mesh's
first device. ``shard`` keeps the JAX call shape, ``model.state =
arch.shard(model.state)``: a model on a mesh scatters any state assigned
to it into its blocks.

An explicit ``devices=`` list may name one device several times: the
counterpart of JAX's virtual CPU devices. Blocks on one device then exchange
their strips through a kernel, blocks on different devices through peer
copies. A model built with a ``Distributed`` architecture takes a grid on
the mesh's first device, where ``gather`` returns the global view.
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
        self._comm = None

    @property
    def communicator(self):
        """The mesh's communicator (``parallel/communicator.py``), made on
        first use and shared by everything that runs on this mesh."""
        if self._comm is None:
            from .communicator import Communicator
            self._comm = Communicator(self)
        return self._comm

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
        """The device that holds the gathered global view: the mesh's
        first."""
        return self.mesh.devices[0, 0]

    @property
    def size(self):
        return self.partition.x * self.partition.y

    @property
    def communicator(self):
        """The mesh's communicator, shared by every model on this
        architecture."""
        return self.mesh.communicator

    def shard(self, state):
        """A model's global-view ``state`` (nested dicts, lists and tuples of
        tensors and scalars) with its tensors on the mesh's first device,
        for the JAX call shape ``model.state = arch.shard(model.state)``: a
        model on this architecture scatters any state assigned to it into
        its shards' blocks."""
        return _map(state, lambda a: a.to(self.device))

    def scatter(self, state, halo):
        """Each shard's block of ``state`` (a tensor, or nested dicts, lists
        and tuples of tensors and scalars) on its device: a ``Blocks`` list
        in rank order (the mesh's row-major order). Tensors of two or more
        dimensions are global padded tensors with the x and y halos
        ``halo`` (Hx, Hy, ...); each block is the shard's interior padded by
        the same halos, cut with them from the global tensor (so its halos
        hold the global view's values), trailing axes whole. Other leaves
        are copied to every shard (tensors moved to its device)."""
        S = self.mesh.devices.shape
        out = Blocks(halo, S)
        for i in range(S[0]):
            for j in range(S[1]):
                dev = self.mesh.devices[i, j]
                out.append(_map(state, lambda a: cut_block(a, halo, S, i, j,
                                                        dev)))
        return out

    def gather(self, blocks, halo=None):
        """The global view of ``blocks`` (a ``Blocks`` list, or a list in
        rank order with ``halo`` given) on the mesh's first device: each
        tensor of two or more dimensions is assembled from the shards'
        interiors, its outer halo ring from the edge shards' halos; other
        leaves are the first shard's."""
        halo = blocks.halo if halo is None else halo
        S = self.mesh.devices.shape
        dev = self.device
        return _zip_map(list(blocks),
                        lambda parts: _assemble(parts, halo, S, dev))

    def validate_grid(self, grid, pencil=False):
        """The interior must divide the mesh along x and y: the blocks are
        equal. (The JAX check is on the padded extent, a GSPMD tiling rule
        that the port's blocks do not have.) With ``pencil`` (a model that
        solves for a pressure) Nx and Ny must also divide P = Sx·Sy, the
        pencil solver's slabs (JAX's ``pencil_fft.py`` rule, P the flattened
        mesh)."""
        px, py = self.partition.x, self.partition.y
        nx, ny = grid.N[0], grid.N[1]
        if nx % px or ny % py:
            raise ValueError(
                f"interior ({nx}, {ny}) not divisible by partition "
                f"({px}, {py}); choose N so that Nx % {px} == 0 and "
                f"Ny % {py} == 0")
        P = px * py
        if pencil and (nx % P or ny % P):
            raise ValueError(
                f"the mesh size {P} must divide Nx={nx} and Ny={ny} "
                "(reference analogue: distributed_fft_based_poisson_solver.jl"
                ":80-91 divisibility constraints)")

    def place(self, grid, pencil=False):
        """The grid a model on this architecture runs on: ``grid`` itself,
        which must live on the mesh's first device (a grid on another device
        raises rather than being moved)."""
        if not same_device(grid.device, self.device):
            raise ValueError(
                f"the grid lives on {grid.device} but the mesh's first "
                f"device is {self.device}; build the grid with "
                f"device={str(self.device)!r}")
        self.validate_grid(grid, pencil)
        return grid

    def shards(self, grid):
        """The ``Shard`` of every rank, in rank order, for a model on
        ``grid`` (the global grid, its halo final)."""
        return mesh_shards(grid, self.mesh)

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


MESH_ITEM = "ROADMAP.md queue 1 item 16b"


class Blocks(list):
    """Per-shard blocks in rank order, with the halo (Hx, Hy, ...) they were
    cut with and the mesh's shape."""

    def __init__(self, halo, shape, items=()):
        super().__init__(items)
        self.halo = tuple(halo)
        self.shape = tuple(shape)


class Shard:
    """One shard of a global grid on a mesh: its ``rank`` (the mesh's
    row-major order), ``index`` (i, j), the interior ``offset`` of its block
    in the global grid, its ``device`` and its local ``grid``
    (``RectilinearGrid.local_grid`` with the sides along the mesh's axes
    marked connected: the fills keep them and hand them to ``exchange``)."""

    def __init__(self, mesh, rank, grid):
        S = mesh.devices.shape
        self.comm = mesh.communicator
        self.rank = rank
        self.index = (rank // S[1], rank % S[1])
        nl = (grid.N[0] // S[0], grid.N[1] // S[1])
        self.local_n = nl
        self.offset = (self.index[0] * nl[0], self.index[1] * nl[1])
        self.device = mesh.devices[self.index]
        self.global_grid = grid
        self.grid = shard_grid(grid, nl, self.offset, self.device, self)
        self.pencil = None      # the model's DistributedFFTPoissonSolver

    def exchange(self, fields, plain=False):
        """The halo exchange of this shard's padded ``fields`` (one shape)
        with every other shard's, in place (``plain``: by the plain
        copies)."""
        H = self.grid.H
        self.comm.exchange(self.rank, fields, H, self.local_n + (0,),
                           plain=plain)
        return fields

    def all_reduce(self, value, op="sum"):
        return self.comm.all_reduce(self.rank, value, op)

    def __repr__(self):
        return f"Shard(rank={self.rank}, index={self.index})"


def mesh_shards(grid, mesh):
    """The ``Shard`` of every rank of ``mesh``, in rank order, for the
    global ``grid``, whose interior must divide the mesh along x and y."""
    S = mesh.devices.shape
    if grid.N[0] % S[0] or grid.N[1] % S[1]:
        raise ValueError(f"interior {tuple(grid.N[:2])} must divide the mesh "
                         f"{S}")
    return [Shard(mesh, rank, grid) for rank in range(S[0] * S[1])]


def shard_grid(grid, local_n, offset, device, shard):
    """The local grid of ``shard``: ``grid``'s ``local_grid`` at
    ``offset``, its x and y (where not flat) marked connected, with the
    shard attached; an ``ImmersedBoundaryGrid`` keeps its immersed boundary,
    its masks and geometry cut from the global grid's (``block``)."""
    from ..immersed import ImmersedBoundaryGrid
    under = grid.underlying_grid if isinstance(grid, ImmersedBoundaryGrid) \
        else grid
    if not hasattr(under, "local_grid"):
        raise NotImplementedError(
            f"a {type(under).__name__} under a device mesh: {MESH_ITEM}")
    local = under.local_grid(tuple(local_n) + (grid.N[2],), device=device,
                             offset=offset)
    local.connected = tuple(not grid.is_flat(ax) for ax in (0, 1)) + (False,)
    local.shard = shard
    if isinstance(grid, ImmersedBoundaryGrid):
        return grid.block(local, offset)
    return local


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _zip_map(trees, fn):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(trees)
    if isinstance(first, dict):
        return {k: _zip_map([t[k] for t in trees], fn) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map([t[k] for t in trees], fn)
                           for k in range(len(first)))
    return first


def cut_block(a, halo, S, i, j, dev):
    """Shard (i, j)'s block of the global padded tensor ``a`` (halos
    included), contiguous on ``dev``; tensors of fewer than two dimensions
    are copied."""
    if a.ndim < 2:
        return a.to(dev, copy=True)
    hx, hy = halo[0], halo[1]
    nx, ny = a.shape[0] - 2 * hx, a.shape[1] - 2 * hy
    if nx % S[0] or ny % S[1]:
        raise ValueError(f"a tensor of shape {tuple(a.shape)} with halo "
                         f"({hx}, {hy}) does not divide the mesh {S}")
    nlx, nly = nx // S[0], ny // S[1]
    b = a[i * nlx:i * nlx + nlx + 2 * hx, j * nly:j * nly + nly + 2 * hy]
    return b.to(dev, copy=True, memory_format=torch.contiguous_format)


def _assemble(parts, halo, S, dev):
    """The global padded tensor of the blocks ``parts`` (rank order): each
    block's interior at its place, the outer halo ring from the edge
    blocks' halos."""
    first = parts[0]
    if first.ndim < 2:
        return first.to(dev, copy=True)
    hx, hy = halo[0], halo[1]
    nlx, nly = first.shape[0] - 2 * hx, first.shape[1] - 2 * hy
    out = torch.empty((S[0] * nlx + 2 * hx, S[1] * nly + 2 * hy)
                      + tuple(first.shape[2:]), dtype=first.dtype,
                      device=dev)
    # the edge blocks' whole blocks first (the outer halo ring), then every
    # interior
    for r, b in enumerate(parts):
        i, j = r // S[1], r % S[1]
        if i in (0, S[0] - 1) or j in (0, S[1] - 1):
            out[i * nlx:i * nlx + nlx + 2 * hx,
                j * nly:j * nly + nly + 2 * hy] = b.to(dev)
    for r, b in enumerate(parts):
        i, j = r // S[1], r % S[1]
        out[hx + i * nlx:hx + (i + 1) * nlx, hy + j * nly:hy + (j + 1) * nly] \
            = b[hx:hx + nlx, hy:hy + nly].to(dev)
    return out

