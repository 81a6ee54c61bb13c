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
global grid's nodes and metrics cut at the shard's offset; each side of x
and y marked connected or a wall: a periodic axis's sides are connected, a
bounded axis's are walls only at the global grid's own walls, the low side
of the first shard and the high side of the last, and the tripolar fold
connects the top row of shards across it); the shards meet only in the
collectives of
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

from ..grids.topology import BOUNDED, PERIODIC


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


PANELS = ("panels",)
PANEL_SHARD_COUNTS = (1, 2, 3, 6)


class Mesh:
    """An (Sx, Sy) array of ``torch.device``s (``devices``, a numpy object
    array) with the axis names ("x", "y"). Shard (i, j) holds the block of
    the i-th x range and the j-th y range. A one-dimensional array named
    ("panels",) is a cubed sphere's panel mesh (JAX's call shape
    ``Mesh(devices[:6], ("panels",))``): shard r holds panels
    r·6/S .. (r + 1)·6/S of every four-dimensional state tensor."""

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


class ShardedState(dict):
    """A model state from ``Distributed.shard``: a dict of global-view
    tensors that names the ``architecture`` it is to be scattered over."""

    def __init__(self, state, architecture):
        super().__init__(state)
        self.architecture = architecture


class Distributed:
    """Device-mesh architecture.

    Usage::

        arch = Distributed(Partition(x=2, y=2))        # 4 cards
        arch = Distributed(Partition(2, 2),
                           devices=[torch.device("cuda:0")] * 4)  # 1 card
        model = ShallowWaterModel(grid, ..., architecture=arch)
        arch = Distributed(Mesh(np.array([cuda0] * 6, dtype=object),
                                ("panels",)))  # a cubed sphere's panels
        cs_model.state = arch.shard(cs_model.state)

    ``devices`` defaults to every visible CUDA card; with none it raises, as
    a grid built for the default device does. A list may name a device more
    than once. ``partition`` defaults to the squarest split of the devices.
    """

    def __init__(self, partition=None, devices=None):
        self.panel_shards = None
        if isinstance(partition, Mesh):
            self._take_mesh_of(partition)
            return
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

    def _take_mesh_of(self, mesh):
        """A ``Distributed`` over a cubed sphere's panel mesh, named
        ("panels",), of 1, 2, 3 or 6 shards (an (x, y) mesh is given by
        its ``Partition`` and ``devices``)."""
        if tuple(mesh.axis_names) != PANELS:
            raise ValueError(f"a mesh named {tuple(mesh.axis_names)}: give "
                             f"an (x, y) mesh as Partition(x, y) and "
                             f"devices=, a panel mesh as ('panels',)")
        dev = np.empty(mesh.devices.size, dtype=object)
        dev[:] = [_normalize(torch.device(d)) for d in mesh.devices.ravel()]
        n = dev.size
        if n not in PANEL_SHARD_COUNTS:
            raise ValueError(
                f"a panel mesh of {n} shards: the six panels divide over "
                f"1, 2, 3 or 6 shards")
        self.panel_shards = n
        self.partition = None
        self.mesh = Mesh(dev, PANELS)

    @property
    def device(self):
        """The device that holds the gathered global view: the mesh's
        first."""
        return self.mesh.devices.ravel()[0]

    @property
    def size(self):
        return self.mesh.devices.size

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
        its shards' blocks, and a model built without an architecture
        takes this one (a ``ShardedState`` names it; ``MeshModel``)."""
        return ShardedState(_map(dict(state), lambda a: a.to(self.device)),
                            self)

    def scatter(self, state, halo):
        """Each shard's block of ``state`` (a tensor, or nested dicts, lists
        and tuples of tensors and scalars) on its device: a ``Blocks`` list
        in rank order (the mesh's row-major order). Tensors of two or more
        dimensions are global padded tensors with the x and y halos
        ``halo`` (Hx, Hy, ...); each block is the shard's interior padded by
        the same halos, cut with them from the global tensor (so its halos
        hold the global view's values), trailing axes whole. Other leaves
        are copied to every shard (tensors moved to its device)."""
        if self.panel_shards is not None:
            return self._scatter_panels(state, halo)
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
        if self.panel_shards is not None:
            return _zip_map(list(blocks), lambda parts: (
                torch.cat([b.to(dev) for b in parts]) if parts[0].ndim == 4
                else parts[0].to(dev, copy=True)))
        return _zip_map(list(blocks),
                        lambda parts: _assemble(parts, halo, S, dev))

    def _scatter_panels(self, state, halo):
        """A panel mesh's blocks: every four-dimensional tensor (6, ...)
        cut into its shards' panels along the leading axis, other leaves
        copied to every shard."""
        n = self.panel_shards
        k = 6 // n
        out = Blocks(halo, (n, 1))
        for r, dev in enumerate(self.mesh.devices.ravel()):
            def cut(a, r=r, dev=dev):
                if a.ndim != 4:
                    return a.to(dev, copy=True)
                if a.shape[0] != 6:
                    raise ValueError(f"a panel mesh cuts (6, ...) tensors, "
                                     f"got {tuple(a.shape)}")
                return a[r * k:(r + 1) * k].to(
                    dev, copy=True, memory_format=torch.contiguous_format)
            out.append(_map(state, cut))
        return out

    def panel_shards_of(self, grid):
        """The ``PanelShard`` of every rank of a panel mesh, for a cubed
        sphere on ``grid``; an (x, y) mesh raises (the cubed sphere shards
        over its panels), as does a mesh whose devices are not the grid's
        (the panels' metric tables live on the grid's device: a panel mesh
        across cards needs them on every card, ROADMAP.md's multi-card
        note)."""
        if self.panel_shards is None:
            raise ValueError(
                "a cubed sphere shards over its panels: pass Distributed("
                "Mesh(devices, ('panels',))) with 1, 2, 3 or 6 devices")
        for d in self.mesh.devices.ravel():
            if not same_device(d, grid.device):
                raise NotImplementedError(
                    f"a panel shard on {d} for a grid on {grid.device}: "
                    f"{MULTI_CARD}")
        return [PanelShard(self.mesh, r, 6 // self.panel_shards)
                for r in range(self.panel_shards)]

    def validate_grid(self, grid, pencil=False):
        """The interior must divide the mesh along x and y: the blocks are
        equal. (The JAX check is on the padded extent, a GSPMD tiling rule
        that the port's blocks do not have.) With ``pencil`` (a model that
        solves for a pressure) Nx and Ny must also divide P = Sx·Sy, the
        pencil solver's slabs (JAX's ``pencil_fft.py`` rule, P the flattened
        mesh)."""
        if self.panel_shards is not None:
            raise ValueError("a panel mesh shards a cubed sphere's panels; "
                             "this grid takes Partition(x, y)")
        px, py = self.partition.x, self.partition.y
        nx, ny = grid.N[0], grid.N[1]
        if nx % px or ny % py:
            raise ValueError(
                f"interior ({nx}, {ny}) not divisible by partition "
                f"({px}, {py}); choose N so that Nx % {px} == 0 and "
                f"Ny % {py} == 0")
        P = px * py
        if pencil and (grid.is_flat(0) or grid.is_flat(1)):
            # the pencil's slabs cut the other horizontal axis and z
            nz = grid.N[2]
            if (nx * ny) % P or nz % P:
                raise ValueError(
                    f"the mesh size {P} must divide N={tuple(grid.N)} along "
                    f"the axes the pencil's slabs cut (the horizontal axis "
                    f"that is not flat, and z)")
        elif pencil and (nx % P or ny % P):
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
        if self.panel_shards is not None:
            self.validate_grid(grid)
        return mesh_shards(grid, self.mesh)

    def __repr__(self):
        if self.panel_shards is not None:
            return f"Distributed(panels={self.panel_shards}, {self.mesh})"
        return f"Distributed({self.partition}, {self.mesh})"


def regularize_architecture(architecture):
    """None for the default (``None``, ``CPU()`` or ``GPU()``), else the
    ``Distributed`` architecture."""
    if architecture is None or isinstance(architecture, CPU):
        return None
    if not isinstance(architecture, Distributed):
        raise TypeError(f"unknown architecture {architecture!r}")
    return architecture


MULTI_CARD = ("more than one card per model needs the multi-card transport "
              "(ROADMAP.md multi-card note, outside item 16b)")


def cut_boundary_conditions(bcs, grid, shard):
    """The user's ``boundary_conditions`` ({name: FieldBoundaryConditions})
    as shard ``shard`` of the global ``grid`` takes them: every array value
    becomes the global grid's padded plane (the interior padded as the fill
    pads it: wrapped along a periodic transverse axis, its edge repeated
    along the others) cut at the shard's offset, halos included, and every
    time series is cut so at each snapshot it serves (``_CutSeries``);
    scalars, callables (of the shard's own coordinates), schemes and the
    Open sides pass as they are (a side that the shard shares with another
    is kept by its fills and exchanged)."""
    from ..boundary_conditions.boundary_condition import (
        BoundaryCondition, FieldBoundaryConditions, _FieldTimeSeriesCondition)
    if not bcs:
        return bcs
    offset = shard.offset
    local = shard.grid

    def cut(bc, axis):
        c = bc.condition
        if c is None or callable(c) and not hasattr(c, "evaluate_padded") \
                or isinstance(c, (int, float, np.number)):
            return bc
        if isinstance(c, _FieldTimeSeriesCondition):
            c = _FieldTimeSeriesCondition(_CutSeries(c.fts, grid, local,
                                                     offset))
        elif hasattr(c, "evaluate_padded"):
            return bc
        else:
            c = _cut_plane(c, grid, local, axis, offset)
        return BoundaryCondition(bc.classification, c, bc.scheme,
                                 bc.field_dependencies)

    out = {}
    for name, fbcs in bcs.items():
        if not isinstance(fbcs, FieldBoundaryConditions):
            out[name] = fbcs
            continue
        sides = {}
        for k, side in enumerate(("west", "east", "south", "north",
                                  "bottom", "top")):
            bc = fbcs.side(side)
            sides[side] = None if bc is None else cut(bc, k // 2)
        out[name] = FieldBoundaryConditions(immersed=fbcs.immersed, **sides)
    return out


def _pad_plane(arr, grid, axes):
    """An interior plane (numpy) padded over ``axes`` as the fill pads it:
    wrapped along a periodic axis, its edge repeated along the others."""
    for d, ax in enumerate(axes):
        pad = [(0, 0)] * arr.ndim
        pad[d] = (grid.H[ax], grid.H[ax])
        arr = np.pad(arr, pad, mode="wrap" if grid.topology[ax] == PERIODIC
                     else "edge")
    return arr


def _cut_plane(cond, grid, local, axis, offset):
    """An array condition of a side normal to ``axis`` on the global
    ``grid``, as the shard's padded plane (float64 numpy): the global
    padded plane cut at ``offset`` along the transverse x and y."""
    arr = np.asarray(cond.detach().cpu() if hasattr(cond, "detach")
                     else cond, dtype=np.float64)
    t_axes = [ax for ax in range(3) if ax != axis]
    if arr.shape == tuple(grid.N[ax] for ax in t_axes):
        arr = _pad_plane(arr, grid, t_axes)
    for d, ax in enumerate(t_axes):
        if ax < 2 and arr.ndim > d and \
                arr.shape[d] == grid.N[ax] + 2 * grid.H[ax]:
            n = local.N[ax] + 2 * local.H[ax]
            arr = np.take(arr, np.arange(offset[ax], offset[ax] + n),
                          axis=d)
    return np.ascontiguousarray(arr)


class _CutSeries:
    """A FieldTimeSeries of a z-normal plane as a shard reads it: each
    snapshot the global plane padded as the fill pads it and cut at the
    shard's offset (made once a snapshot), interpolated in time as
    ``FieldTimeSeries.at_time`` interpolates."""

    def __init__(self, fts, grid, local, offset):
        self.fts = fts
        self.times = fts.times
        self._grid, self._local, self._offset = grid, local, offset
        self._cut = {}

    def __getitem__(self, i):
        hit = self._cut.get(i)
        if hit is None:
            a = self.fts[i]
            a = a.reshape(a.shape[0], a.shape[1], -1)[..., :1]
            g, loc = self._grid, self._local
            for ax in range(2):
                npad = g.padded_shape[ax] - a.shape[ax]
                idx = torch.arange(-(npad // 2), a.shape[ax]
                                   + npad - npad // 2, device=a.device)
                idx = (idx.remainder(a.shape[ax]) if g.topology[ax] ==
                       PERIODIC else idx.clamp(0, a.shape[ax] - 1))
                o = self._offset[ax]
                a = a.index_select(ax, idx[o:o + loc.padded_shape[ax]])
            hit = self._cut[i] = a.to(loc.device)
        return hit

    def at_time(self, t):
        from ..simulation.output_readers import FieldTimeSeries
        return FieldTimeSeries.at_time(self, t)


class MeshModel:
    """The shard plumbing of a model on a device mesh, shared by every
    model class. Off a mesh ``_shards`` is None and ``state`` is the
    model's own. On a mesh (``_enter_mesh``) ``_shards`` holds one model of
    the class per shard, on the shard's local grid, and the shards meet
    only in the mesh's communicator (``_comm``); ``state`` is then a
    gathered global view, each entry's blocks cut and put back with the x
    and y halos of ``_block_halo``. A state from ``Distributed.shard``
    assigned to a model off a mesh puts the model on that mesh (JAX's call
    shape ``model.state = arch.shard(model.state)``); a class that cannot
    be sharded raises there (its ``_enter_mesh``)."""

    _shards = None

    def _run(self, fn):
        """``fn(shard_model)`` on every shard, in the shards' threads."""
        return self._comm.run(lambda r: fn(self._shards[r]))

    def _block_halo(self, key):
        """The x and y halos the blocks of state entry ``key`` are cut
        with; None for an entry every shard holds whole (the clock)."""
        return None if key == "clock" else self.grid.H

    @property
    def state(self):
        """The model state. On a device mesh, a gathered global-view copy on
        the mesh's first device: writes into it do not reach the shards
        (assign a state to ``model.state`` to scatter it)."""
        if self._shards is None:
            return self._state
        states = [m._state for m in self._shards]
        out = {}
        for key, val in states[0].items():
            halo = self._block_halo(key)
            out[key] = (_whole(val) if halo is None else
                        self.architecture.gather([st[key] for st in states],
                                                 halo))
        return out

    @state.setter
    def state(self, value):
        if isinstance(value, ShardedState):
            self._take_mesh(value.architecture)
        if self._shards is None:
            self._state = value
            return
        parts = {k: self.architecture.scatter(v, self._block_halo(k))
                 for k, v in value.items() if self._block_halo(k) is not None}
        for r, m in enumerate(self._shards):
            m._state = {k: parts[k][r] if k in parts else _whole(v)
                        for k, v in value.items()}

    def _take_mesh(self, arch):
        """A state sharded over ``arch``: a model off a mesh enters it; a
        model on a mesh must be on the same devices."""
        if self._shards is None:
            self._enter_mesh(arch)
            return
        mine = self.architecture.mesh.devices
        if mine.shape != arch.mesh.devices.shape or any(
                not same_device(a, b) for a, b in
                zip(mine.ravel(), arch.mesh.devices.ravel())):
            raise ValueError(f"a state sharded over {arch} given to a model "
                             f"on {self.architecture}")

    def _enter_mesh(self, arch):
        raise NotImplementedError(
            f"a {type(self).__name__} has no shards: each model class "
            f"gives its own _enter_mesh")

    @property
    def _clock(self):
        return (self._shards[0]._state if self._shards is not None
                else self._state)["clock"]


def _whole(val):
    """A state entry that every shard holds whole: a dict copied (the
    clock), anything else shared."""
    return dict(val) if isinstance(val, dict) else val


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
    in the global grid, its ``device`` and its local ``grid`` (the global
    grid's ``local_grid`` with ``connected``, per axis (low, high), the
    sides the fills keep and hand to ``exchange``, and ``walls``, the sides
    that are the global grid's own)."""

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
        # the axes whose last shard wraps to the first (a bounded axis's
        # edge shards hold the global walls instead)
        self.periodic = tuple(grid.topology[ax] == PERIODIC
                              for ax in (0, 1))
        self.grid = shard_grid(grid, nl, self.offset, self.device, self)
        self.pencil = None      # the model's DistributedFFTPoissonSolver

    def exchange(self, fields, plain=False, fold=None, periodic=None):
        """The halo exchange of this shard's padded ``fields`` (one shape)
        with every other shard's, in place (``plain``: by the plain
        copies; ``fold``: the tripolar north fold's per-field (sign, x-face,
        y-face) or None, the same on every shard; ``periodic``: the axes
        that wrap, the global grid's periodic ones by default)."""
        H = self.grid.H
        self.comm.exchange(self.rank, fields, H, self.local_n + (0,),
                           plain=plain, fold=fold,
                           periodic=self.periodic if periodic is None
                           else periodic)
        return fields

    def all_reduce(self, value, op="sum"):
        return self.comm.all_reduce(self.rank, value, op)

    def __repr__(self):
        return f"Shard(rank={self.rank}, index={self.index})"


class PanelShard:
    """One shard of a cubed sphere over its panels: its ``rank``, the
    global ``panels`` it holds (a range of k = 6/S), its ``device`` and
    the mesh's communicator ``comm``."""

    def __init__(self, mesh, rank, k):
        self.comm = mesh.communicator
        self.rank = rank
        self.panels = range(rank * k, (rank + 1) * k)
        self.device = mesh.devices.ravel()[rank]

    def all_reduce(self, value, op="sum"):
        return self.comm.all_reduce(self.rank, value, op)

    def __repr__(self):
        return (f"PanelShard(rank={self.rank}, panels={self.panels.start}.."
                f"{self.panels.stop - 1})")


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
    ``offset``, each side of x and y marked connected (``shard_sides``) or
    a wall of the global grid (``walls``), with the shard attached; an
    ``ImmersedBoundaryGrid`` keeps its immersed boundary,
    its masks and geometry cut from the global grid's (``block``)."""
    from ..immersed import ImmersedBoundaryGrid
    under = grid.underlying_grid if isinstance(grid, ImmersedBoundaryGrid) \
        else grid
    if not hasattr(under, "local_grid"):
        raise ValueError(
            f"a {type(under).__name__} has no local grid to cut: the "
            f"(x, y) mesh takes rectilinear, lat-lon and shell grids (a "
            f"cubed sphere shards over its panels)")
    local = under.local_grid(tuple(local_n) + (grid.N[2],), device=device,
                             offset=offset)
    shape = shard.comm.mesh.devices.shape
    local.connected = shard_sides(grid, shard.index, shape)
    # the global grid's walls: the sides not connected, and the fold, which
    # the top row of shards exchanges across but whose boundary faces are
    # the global grid's own
    local.walls = tuple(
        (not lo, not hi or (ax == 1 and shard.index[1] == shape[1] - 1))
        for ax, (lo, hi) in enumerate(local.connected))
    local.shard = shard
    if isinstance(grid, ImmersedBoundaryGrid):
        return grid.block(local, offset)
    return local


def shard_sides(grid, index, shape):
    """Per axis, (low, high): whether each side of shard ``index`` of a
    mesh of ``shape`` is connected to another shard. Both sides of a
    periodic axis are (the last shard's high side to the first's low side);
    on a bounded axis every side but the global grid's walls, the low side
    of the first shard and the high side of the last; no side of a flat
    axis or of z."""
    out = []
    for ax in (0, 1):
        if grid.is_flat(ax):
            out.append((False, False))
        elif grid.topology[ax] == BOUNDED:
            # a tripolar grid's north side: the top shards meet across the
            # fold
            fold = ax == 1 and getattr(grid, "zipper_north", False)
            out.append((index[ax] > 0, fold or index[ax] < shape[ax] - 1))
        else:
            out.append((True, True))
    return tuple(out) + ((False, False),)


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
    blocks' halos (each slot from one block)."""
    first = parts[0]
    if first.ndim < 2:
        return first.to(dev, copy=True)
    hx, hy = halo[0], halo[1]
    nlx, nly = first.shape[0] - 2 * hx, first.shape[1] - 2 * hy
    out = torch.empty((S[0] * nlx + 2 * hx, S[1] * nly + 2 * hy)
                      + tuple(first.shape[2:]), dtype=first.dtype,
                      device=dev)
    # each slot from the block that owns it: a block's interior, and at the
    # mesh's edges its halos there (the outer halo ring, corners included)
    for r, b in enumerate(parts):
        i, j = r // S[1], r % S[1]
        x0 = 0 if i == 0 else hx
        x1 = nlx + (2 * hx if i == S[0] - 1 else hx)
        y0 = 0 if j == 0 else hy
        y1 = nly + (2 * hy if j == S[1] - 1 else hy)
        out[i * nlx + x0:i * nlx + x1, j * nly + y0:j * nly + y1] = \
            b[x0:x1, y0:y1].to(dev)
    return out

