"""The meeting points of the shards of a device mesh.

Counterpart of the collectives that the JAX package's ``shard_map`` regions
use (``lax.ppermute`` for the halo strips, ``lax.all_to_all`` for the pencil
transposes, ``lax.psum`` and its kin for reductions). Each shard of a
``Distributed`` mesh holds its own padded blocks for the whole run and steps
the serial model's own code on them; the shards meet only here:

- ``exchange(rank, fields)``: the halo strips of every shard's padded blocks
  (``parallel/halo_exchange.py``: the exchange kernel for blocks on one card,
  peer copies between cards, the plain copies on the CPU);
- ``all_to_all(rank, pieces)``: shard ``rank`` sends ``pieces[dst]`` to each
  ``dst`` and receives the list of what every shard sent it;
- ``all_reduce(rank, value, op)``: the sum, max or min of every shard's
  tensor, combined in the mesh's row-major order (never in arrival order, so
  that a result does not change from run to run), the same value on every
  shard.

This implementation runs inside one process: one persistent thread per
shard (``run``), each with its shard's device current, and the meeting
points are barriers. At a barrier the last shard to arrive runs the
collective over what every shard posted, then all go on. One shard runs at
a time between meetings (it holds the communicator's turn, which it gives
up at each meeting): the GIL would serialize the shards' host work anyway,
and a shard that ran beside the others would hand the GIL to them at every
PyTorch call, which releases it. The shards on one card share its default
stream, which keeps the order of their launches as the turns order their
host work; copies between cards are ordered by ``copy_``. A shard's
exception aborts the barrier, so no other shard waits on it, and ``run``
raises it in the caller. A mesh has one communicator (``Mesh.communicator``);
its threads start at the first run and end when it is collected, and
between runs they hold nothing of the last one.
"""

from __future__ import annotations

import queue
import threading
import weakref
from concurrent.futures import Future

import torch

SUM, MAX, MIN = "sum", "max", "min"
_OPS = {SUM: torch.add, MAX: torch.maximum, MIN: torch.minimum}


class ShardError(RuntimeError):
    """The shards met at different points, or a collective's inputs
    disagree."""


_local = threading.local()


def current_rank():
    """The rank of the shard whose thread is running, or None outside one."""
    return getattr(_local, "rank", None)


class Communicator:
    """The in-process communicator of a ``Mesh``: ``size`` shards, rank r
    the r-th device of the mesh in row-major order."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.devices = list(mesh.devices.ravel())
        self.size = len(self.devices)
        self._barrier = threading.Barrier(self.size, action=self._combine)
        self._posted = [None] * self.size
        self._results = None
        self._queues = None
        self._lock = threading.Lock()
        self._turn = threading.Lock()    # held by the one running shard

    # -- running the shards ----------------------------------------------------

    def _start(self):
        self._queues = [queue.SimpleQueue() for _ in range(self.size)]
        ref = weakref.ref(self)
        for rank in range(self.size):
            threading.Thread(target=_serve, args=(ref, rank,
                                                  self._queues[rank]),
                             daemon=True, name=f"shard-{rank}").start()
        # the threads hold only a weak reference and their queue: when the
        # communicator is collected, each finds None on its queue and ends
        weakref.finalize(self, _stop, self._queues)

    def _serve_one(self, rank, fn, fut):
        dev = self.devices[rank]
        self._take_turn()
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out = fn(rank)
            else:
                out = fn(rank)
            self._meet(rank, "end", None, None, resume=False)
            fut.set_result(out)
        except BaseException as err:   # noqa: BLE001 - re-raised by run
            self._give_turn()
            self._barrier.abort()
            fut.set_exception(err)

    def _take_turn(self):
        self._turn.acquire()
        _local.turn = True

    def _give_turn(self):
        if getattr(_local, "turn", False):
            _local.turn = False
            self._turn.release()

    def run(self, fn):
        """Run ``fn(rank)`` on every shard, each in its own thread with its
        device current; returns the results in rank order. The first
        exception a shard raised (by rank, a broken barrier last) is raised
        here after every shard has stopped."""
        if current_rank() is not None:
            raise ShardError("a shard cannot start another run of the mesh")
        with self._lock:
            if self.size == 1:
                return self._run_inline(fn)
            if self._queues is None:
                self._start()
            futures = [Future() for _ in range(self.size)]
            for q, fut in zip(self._queues, futures):
                q.put((fn, fut))
            errors = [f.exception() for f in futures]
            if any(e is not None for e in errors):
                self._barrier.reset()
                self._posted = [None] * self.size
                first = [e for e in errors if e is not None and not
                         isinstance(e, threading.BrokenBarrierError)]
                raise (first or [e for e in errors if e is not None])[0]
            return [f.result() for f in futures]

    def _run_inline(self, fn):
        _local.rank = 0
        try:
            dev = self.devices[0]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return [fn(0)]
            return [fn(0)]
        finally:
            _local.rank = None

    # -- meeting points -------------------------------------------------------

    def _combine(self):
        """The barrier's action, run by the last shard to arrive: the
        collective over every shard's posted (tag, fn, payload)."""
        tags = {p[0] for p in self._posted}
        if len(tags) != 1:
            raise ShardError(f"the shards met at different points: "
                             f"{[p[0] for p in self._posted]}")
        fn = self._posted[0][1]
        payloads = [p[2] for p in self._posted]
        self._posted = [None] * self.size
        self._results = None if fn is None else fn(payloads)

    def _meet(self, rank, tag, fn, payload, resume=True):
        self._posted[rank] = (tag, fn, payload)
        inline = self.size == 1
        if not inline:
            self._give_turn()
        self._barrier.wait()
        if resume and not inline:
            self._take_turn()
        return None if self._results is None else self._results[rank]

    def exchange(self, rank, fields, halo, local_n, plain=False):
        """Fill the x and y halos of every shard's padded ``fields`` (a list
        of tensors of one shape) from the neighbouring shards' interiors, in
        place: x first, then y over the full x extent (the corners in two
        hops). ``halo`` and ``local_n`` are the blocks' (Hx, Hy, ...) and
        local interior (nlx, nly, ...). ``plain`` takes the plain copies
        (``halo_exchange_plain``) on any device."""
        from .halo_exchange import halo_exchange_local, halo_exchange_plain
        S = self.mesh.devices.shape
        route = halo_exchange_plain if plain else halo_exchange_local

        def fn(payloads):
            blocks = [[payloads[i * S[1] + j] for j in range(S[1])]
                      for i in range(S[0])]
            route(blocks, self.mesh, halo, local_n)

        self._meet(rank, "exchange", fn, list(fields))
        return fields

    def all_to_all(self, rank, pieces):
        """Send ``pieces[dst]`` (a tensor, or None for nothing) to each shard
        ``dst``; returns the list, by source rank, of the pieces sent to this
        shard, each on this shard's device. A piece on the receiver's device
        arrives as the sender's tensor itself: the sender must not write it
        afterwards."""
        devices = self.devices

        def fn(payloads):
            return [[None if p[dst] is None else p[dst].to(devices[dst])
                     for p in payloads] for dst in range(self.size)]

        if len(pieces) != self.size:
            raise ShardError(f"all_to_all takes {self.size} pieces, got "
                             f"{len(pieces)}")
        return self._meet(rank, "all_to_all", fn, list(pieces))

    def all_reduce(self, rank, value, op=SUM):
        """The ``op`` (``"sum"``, ``"max"`` or ``"min"``) of every shard's
        ``value`` (tensors of one shape), combined in rank order on the
        first shard's device; each shard receives its own copy on its
        device."""
        combine = _OPS[op]
        devices = self.devices

        def fn(payloads):
            total = payloads[0]
            for p in payloads[1:]:
                total = combine(total, p.to(total.device))
            return [total.to(d, copy=True) for d in devices]

        return self._meet(rank, f"all_reduce_{op}", fn, value)


def _serve(ref, rank, jobs):
    """A shard's thread: run each (fn, future) put on ``jobs`` with the
    communicator that ``ref`` names, until None arrives. Between runs the
    thread holds nothing of the last one (``_serve_one``'s locals are gone)
    and no strong reference to the communicator."""
    _local.rank = rank
    while True:
        job = jobs.get()
        if job is None:
            return
        ref()._serve_one(rank, *job)
        del job


def _stop(queues):
    for q in queues:
        q.put(None)
