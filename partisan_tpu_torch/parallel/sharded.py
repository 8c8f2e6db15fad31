"""The sharded cluster: the node axis split over a shard mesh (port of
``partisan_tpu/parallel/sharded.py``).

The reference runs one round as an SPMD program under ``jax.shard_map``;
here each shard runs the port's ``round_body`` in its own thread of a
:class:`~partisan_tpu_torch.parallel.mesh.Mesh` with a :class:`ShardComm`
that gives managers and models the ``LocalComm`` interface:

- per-node protocol transitions run shard-locally;
- the event-message exchange crosses shards with one ``all_gather`` of
  the emission planes (each at its narrow dtype), after which every
  shard routes only its own node range; or, with
  ``Config.sharded_exchange="all_to_all"``, each shard sorts its
  emissions by destination shard, packs a fixed quota per destination
  and exchanges the packs;
- state-gossip merges scatter into a full-range proposal that the
  shards ``pmax`` and slice;
- counts and plane values reduce with ``allsum``/``allmax``/``allmin``
  before they are written, so the replicated leaves stay identical on
  every shard.

Randomness keys off global node ids (``ops/rng.py``), so a sharded run
equals the single-device run leaf for leaf, apart from the all-to-all
exchange once its quota sheds.

``ShardedCluster`` takes and returns the global ``ClusterState``, as the
reference's does: ``steps(state, k)`` cuts the state once into S shard
states on the mesh's devices, runs the k rounds in the shard threads,
and joins the shards once at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from partisan_tpu_torch import managers as managers_mod
from partisan_tpu_torch import interpose as interpose_mod
from partisan_tpu_torch import latency as latency_mod
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import (Cluster, ClusterState, TraceRound,
                                        round_body, run_until)
from partisan_tpu_torch.config import Config
from partisan_tpu_torch.ops import exchange, gossip
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.parallel.mesh import Mesh
from partisan_tpu_torch.types import W_DST, W_KIND

# leaf placements of the spec table
SHARD = "shard"      # split on axis 0 (the node axis)
SHARD1 = "shard1"    # split on axis 1 (the flight ring's node axis)
REPL = "repl"        # the same value on every shard
OWN = "own"          # replicated, each shard holding its own copy (a
#                      leaf the round writes in place: the ring's labels)


@dataclasses.dataclass(frozen=True)
class ShardComm:
    """The ``LocalComm`` interface for shard ``rank`` of ``mesh``."""

    n_global: int
    inbox_cap: int
    msg_words: int
    n_shards: int
    rank: int
    mesh: Mesh
    exchange_mode: str = "all_gather"   # Config.sharded_exchange
    a2a_factor: int = 4                 # Config.a2a_factor
    # the running count of records the all-to-all quota shed, a device
    # scalar in a one-slot list (read and reset by ShardedCluster.a2a_shed)
    shed: list = dataclasses.field(default_factory=list, compare=False)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[self.rank]

    @property
    def n_local(self) -> int:
        return self.n_global // self.n_shards

    @property
    def node_offset(self) -> int:
        return self.rank * self.n_local

    def local_ids(self) -> torch.Tensor:
        off = self.node_offset
        return torch.arange(off, off + self.n_local, dtype=torch.int32,
                            device=self.device)

    def local(self, x):
        """This shard's rows of a replicated per-node ``[n_global, ...]``
        tensor."""
        return x[self.node_offset:self.node_offset + self.n_local]

    def route(self, emitted) -> exchange.Inbox:
        if self.exchange_mode == "all_to_all":
            return self._route_a2a(emitted)
        # every shard's [n_local, E] planes, gathered at their storage
        # dtypes, then routed into this shard's node range
        every = self.mesh.all_gather(self.rank, emitted)
        return exchange.route(every, self.n_local, self.inbox_cap,
                              node_offset=self.node_offset)

    def _route_a2a(self, emitted) -> exchange.Inbox:
        """Stable-sort this shard's records by destination shard, pack
        ``Q = min(M, a2a_factor * ceil(M / S))`` of them per destination
        shard, exchange the packs, then route what arrived.  Records past
        the quota shed; stability keeps each sender's order."""
        S, dev = self.n_shards, self.device
        flat = emitted.map(lambda w: w.reshape(-1))
        M = flat[0].shape[0]
        Q = min(M, self.a2a_factor * -(-M // S))
        kind, dst = flat[W_KIND], flat[W_DST]
        ok = (kind != 0) & (dst >= 0) & (dst < self.n_global)
        dshard = torch.where(ok, torch.div(dst, self.n_local,
                                           rounding_mode="floor"), S)
        order = torch.sort(dshard, stable=True)[1]
        bounds = torch.searchsorted(
            dshard[order], torch.arange(S + 1, dtype=dshard.dtype,
                                        device=dev))
        starts = bounds[:-1]
        counts = bounds[1:] - bounds[:-1]
        qi = torch.arange(Q, dtype=torch.int64, device=dev)
        pos = (starts[:, None] + qi[None, :]).clamp(0, max(M - 1, 0))
        fits = qi[None, :] < counts[:, None]                 # [S, Q]
        send = plane_ops.where(fits, plane_ops.take_flat(flat, order[pos]),
                               0)
        shed = (counts - Q).clamp(min=0).sum()
        self.shed[:] = [self.shed[0] + shed if self.shed else shed]
        recv = self.mesh.all_to_all(self.rank, send)         # [S, Q]
        return exchange.route(recv, self.n_local, self.inbox_cap,
                              node_offset=self.node_offset)

    def push_max(self, rows: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Scatter this shard's rows into a full-range proposal, ``pmax``
        it across shards, keep this shard's rows (max is order-free, so
        this equals the single-device merge)."""
        prop = gossip.push_max(rows, dst, n_out=self.n_global)
        return self.local(self.mesh.pmax(self.rank, prop))

    def push_or(self, rows: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        return self.push_max(rows.to(torch.int32), dst).to(torch.bool)

    def allsum(self, x):
        return self.mesh.psum(self.rank, x)

    def allmax(self, x):
        return self.mesh.pmax(self.rank, x)

    def allmin(self, x):
        """Elementwise on arrays (the health plane's label halo)."""
        return self.mesh.pmin(self.rank, x)

    def gather_vec(self, x):
        """A per-node local tensor (or tree) -> the global one."""
        return self.mesh.all_gather(self.rank, x)

    def actor_gather(self, x, a: int):
        """The causal actor block (global rows 0..a-1, all on shard 0),
        on every shard: the other shards' slices are zero, so a psum
        rebuilds it."""
        if a > self.n_local:
            raise ValueError(
                f"n_actors={a} must be <= nodes per shard "
                f"({self.n_local}) so the actor block is shard-resident")
        return self.mesh.psum(self.rank, x.map(lambda w: w[:a]))


def _versions(state) -> list:
    """Each tensor leaf with its version counter (bumped by every write
    in place, into the leaf or a view of it)."""
    return [(path, x, x._version) for path, x in state_io.flatten(state)
            if isinstance(x, torch.Tensor)]


def _check_unwritten(seen: list) -> None:
    """The shards are handed views of one state (a shard's rows, every
    replicated leaf), which no round may write in place (``comm.py``):
    raise if one was."""
    bad = [path for path, x, v in seen if x._version != v]
    if bad:
        raise RuntimeError(f"the round wrote in place into leaves {bad} of "
                           "the state it was handed, which the shards share")


def _like(subtree, spec):
    return state_io.tree_map(lambda _: spec, subtree)


def _rows_or_scalar(subtree):
    """Node-axis slabs shard; scalar counters replicate."""
    return state_io.tree_map(lambda x: REPL if x.dim() == 0 else SHARD,
                             subtree)


@dataclasses.dataclass
class ShardedCluster:
    """``Cluster``'s API with the round run by the shards of ``mesh``.
    State crosses every call whole: ``init``, ``step``, ``steps``,
    ``record`` and ``run_until`` take and return the global state, on
    the mesh's first device."""

    cfg: Config
    mesh: Mesh
    manager: Any = None
    model: Any = None
    interpose: Any = None

    def __post_init__(self) -> None:
        if self.manager is None:
            self.manager = managers_mod.get(self.cfg.peer_service_manager)
        S = self.mesh.size
        if self.cfg.n_nodes % S:
            raise ValueError(f"n_nodes={self.cfg.n_nodes} not divisible "
                             f"by mesh size {S}")
        self.device = self.mesh.devices[0]
        # the single-device cluster builds the global initial state and
        # discovers the flight ring's shape; it never steps
        self._host = Cluster(self.cfg, manager=self.manager,
                             model=self.model, interpose=self.interpose,
                             device=self.device)
        self.interpose = self._host.interpose
        self.comms = tuple(
            ShardComm(n_global=self.cfg.n_nodes, inbox_cap=self.cfg.inbox_cap,
                      msg_words=self.cfg.msg_words, n_shards=S, rank=r,
                      mesh=self.mesh,
                      exchange_mode=self.cfg.sharded_exchange,
                      a2a_factor=self.cfg.a2a_factor)
            for r in range(S))

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    # ---- the spec table ------------------------------------------------
    def _state_specs(self, state: ClusterState) -> ClusterState:
        """Per leaf: ``SHARD`` (node axis 0), ``SHARD1`` (the flight
        ring's node axis 1) or ``REPL`` — the reference's table."""
        pv = state.provenance
        return ClusterState(
            rnd=REPL,
            faults=_like(state.faults, REPL),
            inbox=_like(state.inbox, SHARD),
            manager=_like(state.manager, SHARD),
            model=_like(state.model, SHARD),
            delivery=_rows_or_scalar(state.delivery),
            stats=_like(state.stats, REPL),
            interpose=(interpose_mod.specs(self.interpose, state.interpose,
                                           SHARD, REPL)
                       if self.interpose is not None else ()),
            outbox=_rows_or_scalar(state.outbox),
            # every value written into these is reduced first, so they
            # are identical on every shard
            metrics=_like(state.metrics, REPL),
            latency=_like(state.latency, REPL),
            flight=(() if state.flight == () else latency_mod.FlightState(
                rnd=OWN, sent=SHARD1, dropped=SHARD1)),
            n_active=_like(state.n_active, REPL),
            health=_like(state.health, REPL),
            # the forest tables are per-node rows; rings and totals are
            # reduced before every write
            provenance=(() if pv == () else type(pv)(**{
                f: (SHARD if f in ("parent", "hop", "claim_rnd", "epoch")
                    else _like(getattr(pv, f), REPL))
                for f in pv._fields})),
            control=_like(state.control, REPL),
            traffic=_like(state.traffic, REPL),
            salt=_like(state.salt, REPL),
            elastic=_like(state.elastic, REPL),
            ingress=(() if state.ingress == () else type(state.ingress)(**{
                f: (REPL if f in ("shed_pend", "shed_total", "injected")
                    else SHARD)
                for f in state.ingress._fields})),
            watchdog=_like(state.watchdog, REPL),
        )

    # ---- state placement -------------------------------------------------
    def init(self) -> ClusterState:
        return self._host.init()

    def flight_shape(self, state: ClusterState) -> tuple:
        return self._host.flight_shape(state)

    def shard_state(self, state: ClusterState) -> list:
        """The global state cut into S shard states, each on its shard's
        device: sharded leaves keep the shard's contiguous rows (a view
        when the device is the same), the flight ring's node axis 1 and
        its labels are copied out, other replicated leaves are shared
        (read-only: ``steps`` and ``record`` check that no round wrote
        into one)."""
        specs = state_io.flatten(self._state_specs(state))
        leaves = state_io.flatten(state)
        if len(specs) != len(leaves):
            raise ValueError(f"spec table has {len(specs)} leaves, the "
                             f"state {len(leaves)}")
        out = []
        for comm in self.comms:
            lo, hi, dev = comm.node_offset, \
                comm.node_offset + comm.n_local, comm.device
            parts = []
            for (_, spec), (_, x) in zip(specs, leaves):
                if spec == SHARD:
                    x = x[lo:hi]
                elif spec == SHARD1:
                    # the shard's own copy: its rounds write it in place
                    x = x[:, lo:hi].clone(
                        memory_format=torch.contiguous_format)
                elif spec == OWN:
                    x = x.clone()
                parts.append(x.to(dev))
            out.append(state_io.unflatten(state, parts))
        return out

    def gather_state(self, shards: list) -> ClusterState:
        """Join S shard states into the global state on the mesh's first
        device (replicated leaves from shard 0)."""
        specs = state_io.flatten(self._state_specs(shards[0]))
        flat = [state_io.flatten(s) for s in shards]
        dev = self.device
        parts = []
        for i, (_, spec) in enumerate(specs):
            xs = [f[i][1] for f in flat]
            if spec == SHARD:
                parts.append(torch.cat([x.to(dev) for x in xs], dim=0))
            elif spec == SHARD1:
                parts.append(torch.cat([x.to(dev) for x in xs], dim=1))
            else:
                parts.append(xs[0].to(dev))
        return state_io.unflatten(shards[0], parts)

    # ---- the sharded round -----------------------------------------------
    def _round(self, comm: ShardComm, state: ClusterState, **kw):
        return round_body(self.cfg, self.manager, self.model, comm, state,
                          interpose=self.interpose, **kw)

    def step(self, state: ClusterState) -> ClusterState:
        return self.steps(state, 1)

    def steps(self, state: ClusterState, k: int) -> ClusterState:
        """Run k rounds: one cut, k rounds in every shard thread, one
        join.  A shard's flight ring is its own copy, so every round
        writes it in place."""
        if k < 1:
            return state

        def run(r, st):
            for _ in range(k):
                st = self._round(self.comms[r], st, flight_owned=True)
            return st

        seen = _versions(state)
        out = self.gather_state(self.mesh.run(run, self.shard_state(state)))
        _check_unwritten(seen)
        return out

    def record(self, state: ClusterState, k: int):
        """Run k rounds capturing the send-path trace: the single-device
        ``Cluster.record``'s ``(state', TraceRound)``.  Each shard's
        interleave writes its ``sent`` rows straight into the one stacked
        ``int32[k, n, E', W]`` trace when the shards share a device (rows
        ``lo:hi`` of a round are contiguous), else into its own buffer,
        joined at the end."""
        if k < 1:
            raise ValueError(f"record(): k must be at least 1, got {k}")
        one_dev = all(d == self.device for d in self.mesh.devices)
        sent_buf: dict = {}

        def run(r, st):
            comm = self.comms[r]
            lo, hi = comm.node_offset, comm.node_offset + comm.n_local
            mine = None
            rounds = []
            for i in range(k):
                def place(shape, i=i):
                    nonlocal mine
                    if one_dev:
                        if "all" not in sent_buf:
                            sent_buf["all"] = torch.empty(
                                (k, self.cfg.n_nodes) + tuple(shape[1:]),
                                dtype=torch.int32, device=self.device)
                        return sent_buf["all"][i, lo:hi]
                    if mine is None:
                        mine = torch.empty((k,) + tuple(shape),
                                           dtype=torch.int32,
                                           device=comm.device)
                    return mine[i]
                st, tr = self._round(comm, st, capture=True, sent_out=place,
                                     flight_owned=True)
                rounds.append(tr)
            dropped = torch.stack([t.dropped for t in rounds])
            rnd = torch.stack([t.rnd for t in rounds])
            return st, mine, dropped, rnd

        seen = _versions(state)
        outs = self.mesh.run(run, self.shard_state(state))
        _check_unwritten(seen)
        st = self.gather_state([o[0] for o in outs])
        sent = sent_buf["all"] if one_dev else torch.cat(
            [o[1].to(self.device) for o in outs], dim=1)
        dropped = torch.cat([o[2].to(self.device) for o in outs], dim=1)
        return st, TraceRound(rnd=outs[0][3].to(self.device), sent=sent,
                              dropped=dropped)

    def a2a_shed(self) -> int:
        """Records the all-to-all quota shed since the last call (one
        host read)."""
        sheds = [c.shed.pop().to(self.device) for c in self.comms if c.shed]
        return int(torch.stack(sheds).sum()) if sheds else 0

    def run_until(self, state: ClusterState, pred, max_rounds: int,
                  check_every: int = 1):
        return run_until(self, state, pred, max_rounds, check_every)
