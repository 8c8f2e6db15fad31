"""The shard mesh: S threads of one process that meet at collectives.

The port's counterpart of ``jax.sharding.Mesh`` together with
``partisan_tpu/hostmesh.py``.  The reference splits the node axis across
devices and runs one round as an SPMD program under ``jax.shard_map``;
here the same round body runs once per shard, each in its own thread,
and the shards meet at a rendezvous for every collective:

- ``all_gather`` concatenates every shard's tensor on axis 0 (tiled),
- ``all_to_all`` splits each shard's tensor into S chunks on axis 0 and
  hands chunk r to shard r, which concatenates what it got in rank order,
- ``psum``, ``pmax`` and ``pmin`` reduce elementwise in rank order, so
  the result does not depend on which thread arrived first.

Each collective takes a tensor or a tree of them (``Planes``,
NamedTuples, tuples); a shard's tensors move to the receiver's device
with ``.to()``.  One card may appear S times in a mesh (the single-card
case: S shards share its default stream, so a tensor handed across the
rendezvous is ordered after the work that made it).  Every rank gets its
own result tensors from a collective, computed before any shard runs on.

Only one shard thread runs at a time (the shards take turns, see
``_Rendezvous``; the caller's thread waits in ``join``), so the
kernels' build and launch counts and every module-level cache the round
touches need no lock.  A mesh that ran shards concurrently would need
them.

A collective that not every shard reaches raises
:class:`RendezvousError` after the mesh's timeout, naming the collective
and the ranks that did arrive — for example when a quiet gate reads
differently on two shards and only one branch holds a collective.  If a
shard raises, :meth:`Mesh.run` releases the others and re-raises that
error in the caller.

The shard count
---------------
The counterpart of XLA's ``--xla_force_host_platform_device_count`` is
one process-wide count, set by :func:`force_host_devices` or by the
environment variable ``PARTISAN_SHARDS``.  Without it the count is
``torch.cuda.device_count()`` for CUDA and 1 for the CPU.  No default
picks the CPU: ``make_mesh()`` with no device is a mesh on the card.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Sequence

import torch
from torch.utils import _pytree

from partisan_tpu_torch import device as device_mod

SHARDS_ENV = "PARTISAN_SHARDS"
DEFAULT_TIMEOUT_S = 300.0

_forced: int | None = None


def force_host_devices(count: int | None) -> None:
    """Pin the process-wide shard count (``None`` clears the pin; the
    environment variable ``PARTISAN_SHARDS`` still applies then)."""
    global _forced
    if count is not None and int(count) < 1:
        raise ValueError(f"shard count must be >= 1, got {count}")
    _forced = None if count is None else int(count)


def shard_count(device=None) -> int:
    """The shard count a mesh on ``device`` (``None`` = the card) gets by
    default: the pinned count, else ``PARTISAN_SHARDS``, else the number
    of CUDA devices (1 on the CPU)."""
    if _forced is not None:
        return _forced
    env = os.environ.get(SHARDS_ENV, "").strip()
    if env:
        return max(int(env), 1)
    dev = device_mod.resolve(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


class RendezvousError(RuntimeError):
    """A collective not every shard reached (timeout), or shards that
    met at different collectives."""


class _Aborted(Exception):
    """Raised in a shard released because another shard failed."""


class _Rendezvous:
    """One meeting point for S threads, which take turns: between two
    collectives the shards run one after another in rank order, each
    handing the turn to the next when it reaches the next collective (or
    ends), so only one shard thread runs at a time and the shards never
    contend for the interpreter lock (nor for any module state).  The
    turn is a semaphore per rank,
    so a hand-over wakes exactly one thread (a plain lock held while it
    is not that rank's turn: released by the hand-over, taken by the
    rank).  A shard that gets the turn
    back before its collective completed knows that a shard ended
    without reaching it.  Collective k deposits into buffer k % 2: a
    shard can only start collective k + 2 after every shard arrived at
    k + 1, which each does after reading k."""

    def __init__(self, size: int, timeout: float) -> None:
        self.size = size
        self.timeout = timeout
        self.lock = threading.Lock()
        self.turn = [threading.Lock() for _ in range(size)]
        for t in self.turn[1:]:
            t.acquire()
        self.gen = 0
        self.done = [False] * size
        self.arrived: dict = {}
        self.bufs = ([None] * size, [None] * size)
        # each generation's results, by rank
        self.results = ({}, {})
        self.error: BaseException | None = None

    def abort(self, err: BaseException) -> None:
        with self.lock:
            if self.error is None:
                self.error = err
        for t in self.turn:
            _release(t)

    def _fail(self, err: RendezvousError):
        self.abort(err)
        raise err

    def _hand_on(self, rank: int) -> None:
        for k in range(1, self.size + 1):
            r = (rank + k) % self.size
            if not self.done[r]:
                _release(self.turn[r])
                return

    def _await_turn(self, rank: int, what: str) -> None:
        if not self.turn[rank].acquire(timeout=self.timeout):
            self._fail(RendezvousError(
                f"{what}: rank {rank} waited {self.timeout:g} s for its "
                f"turn (ranks {sorted(self.arrived)} of {self.size} "
                "arrived)"))
        if self.error is not None:
            raise _Aborted()

    def begin(self, rank: int) -> None:
        self._await_turn(rank, f"rank {rank}'s first turn")

    def end(self, rank: int) -> None:
        with self.lock:
            self.done[rank] = True
        self._hand_on(rank)

    def meet(self, rank: int, name: str, value) -> tuple:
        """``(every shard's value in rank order, the generation's
        results by rank)``."""
        with self.lock:
            if self.error is not None:
                raise _Aborted()
            g = self.gen
            buf = self.bufs[g % 2]
            buf[rank] = (name, value)
            self.arrived[rank] = name
            if len(self.arrived) == self.size:
                self.gen += 1
                self.arrived = {}
        self._hand_on(rank)
        self._await_turn(rank, f"collective {name!r}")
        if self.gen == g:
            # the turn came back round before every shard arrived: the
            # missing ones ended without this collective
            self._fail(RendezvousError(
                f"collective {name!r}: only ranks {sorted(self.arrived)} "
                f"of {self.size} arrived (the others ended without it)"))
        names = {buf[r][0] for r in range(self.size)}
        if len(names) != 1:
            self._fail(RendezvousError(
                "shards met at different collectives: "
                + ", ".join(f"rank {r}: {buf[r][0]!r}"
                            for r in range(self.size))))
        return [buf[r][1] for r in range(self.size)], self.results[g % 2]


def _release(lock) -> None:
    """Hand a turn on (a no-op if that rank's turn is already free)."""
    try:
        lock.release()
    except RuntimeError:
        pass


def _flat(tree):
    return _pytree.tree_flatten(tree)


class Mesh:
    """S shard devices (one card may appear several times) and the
    rendezvous their threads meet at while :meth:`run` runs."""

    def __init__(self, devices: Sequence, timeout: float = DEFAULT_TIMEOUT_S):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.timeout = float(timeout)
        self._rv: _Rendezvous | None = None
        # collectives met and the bytes the shards received from one
        # another at them, since the mesh was made (rank 0 counts)
        self.stats = {"collectives": 0, "bytes": 0}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    # ---- running the shards -------------------------------------------
    def run(self, fn: Callable, *per_rank) -> list:
        """Call ``fn(rank, *args_r)`` once per shard, each in its own
        thread (inline for a 1-shard mesh), where ``args_r`` takes
        element ``rank`` of every sequence in ``per_rank``; returns the
        results in rank order.  The first error a shard raises is
        re-raised here once every shard has stopped."""
        S = self.size
        if self._rv is not None:
            raise RuntimeError("Mesh.run is not re-entrant")
        self._rv = _Rendezvous(S, self.timeout)
        try:
            if S == 1:
                with _on(self.devices[0]):
                    return [fn(0, *(a[0] for a in per_rank))]
            out: list = [None] * S
            errs: list = [None] * S
            # a new thread's intra-op pool size starts at the default;
            # the shards take the caller's
            n_threads = torch.get_num_threads()

            rv = self._rv

            def shard(r: int) -> None:
                torch.set_num_threads(n_threads)
                try:
                    rv.begin(r)
                    with _on(self.devices[r]):
                        out[r] = fn(r, *(a[r] for a in per_rank))
                    rv.end(r)
                except _Aborted as e:
                    errs[r] = e
                except BaseException as e:   # noqa: BLE001 - re-raised
                    errs[r] = e
                    rv.abort(e)

            threads = [threading.Thread(target=shard, args=(r,),
                                        name=f"shard-{r}", daemon=True)
                       for r in range(S)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            first = next((e for e in errs
                          if e is not None and not isinstance(e, _Aborted)),
                         None)
            if first is not None:
                raise first
            return out
        finally:
            self._rv = None

    # ---- collectives (called from inside run) ---------------------------
    def _collective(self, rank: int, name: str, tree, combine):
        """Meet the other shards at collective ``name`` and return
        ``combine(flat leaves of every shard, device, rank)`` for this
        rank, unflattened like ``tree``.  The first shard to read
        computes every rank's result, before any shard runs on (so no
        later write by a shard reaches another's result), and each rank
        takes its own: shards that share a card share no tensor a
        collective returns, as each card of a multi-card mesh holds its
        own."""
        if self._rv is None:
            raise RuntimeError(f"{name}: collectives run inside Mesh.run")
        if self.size == 1:
            return tree
        vals, results = self._rv.meet(rank, name, tree)
        if not results:
            flats = [_flat(v)[0] for v in vals]
            # what crosses between shards: every other shard's leaves at
            # each receiver (an all-to-all chunk only at its receiver)
            S = self.size
            total = sum(x.numel() * x.element_size()
                        for f in flats for x in f
                        if isinstance(x, torch.Tensor))
            self.stats["collectives"] += 1
            self.stats["bytes"] += total * (S - 1) // (
                S if name == "all_to_all" else 1)
            spec = _flat(tree)[1]
            for r, dev in enumerate(self.devices):
                results[r] = _pytree.tree_unflatten(
                    [combine([f[i] for f in flats], dev, r)
                     for i in range(len(flats[0]))], spec)
        return results.pop(rank)

    def all_gather(self, rank: int, tree):
        """Every shard's leaves concatenated on axis 0, in rank order."""
        return self._collective(
            rank, "all_gather", tree,
            lambda xs, dev, r: torch.cat([x.to(dev) for x in xs], dim=0))

    def all_to_all(self, rank: int, tree):
        """Each leaf's axis 0 is split into S equal chunks; shard r gets
        chunk r of every shard, concatenated in rank order."""
        S = self.size
        return self._collective(
            rank, "all_to_all", tree,
            lambda xs, dev, r: torch.cat([x.chunk(S, dim=0)[r].to(dev)
                                          for x in xs], dim=0))

    def _reduce(self, rank: int, name: str, op, tree):
        def combine(xs, dev, r):
            acc = torch.as_tensor(xs[0]).to(dev)
            for x in xs[1:]:
                acc = op(acc, torch.as_tensor(x).to(dev))
            return acc

        return self._collective(rank, name, tree, combine)

    def psum(self, rank: int, tree):
        return self._reduce(rank, "psum", torch.add, tree)

    def pmax(self, rank: int, tree):
        return self._reduce(rank, "pmax", torch.maximum, tree)

    def pmin(self, rank: int, tree):
        return self._reduce(rank, "pmin", torch.minimum, tree)


class _on:
    """Makes ``dev`` the thread's current CUDA device (no-op on the CPU)."""

    def __init__(self, dev: torch.device) -> None:
        self.ctx = torch.cuda.device(dev) if dev.type == "cuda" else None

    def __enter__(self):
        if self.ctx is not None:
            self.ctx.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.ctx is not None:
            self.ctx.__exit__(*exc)


def make_mesh(n_devices: int | None = None, device=None,
              timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards (default :func:`shard_count`)
    on ``device`` (``None`` = the card; raises without one).  A device
    with an index (``cuda:1``, or the CPU) holds every shard; a bare
    ``cuda`` spreads the shards over the visible cards in turn, so more
    shards than cards put several shards on one card."""
    dev = device_mod.resolve(device)
    S = shard_count(dev) if n_devices is None else int(n_devices)
    if S < 1:
        raise ValueError(f"a mesh needs at least one shard, got {S}")
    if dev.type == "cuda" and dev.index is None:
        k = max(torch.cuda.device_count(), 1)
        devs = [torch.device("cuda", r % k) for r in range(S)]
    else:
        devs = [dev] * S
    return Mesh(devs, timeout=timeout)
