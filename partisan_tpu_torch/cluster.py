"""The cluster engine: state tuple + the round step (port of
``partisan_tpu/cluster.py``).

One round advances the whole cluster ``round_ms`` of virtual time:
per-node round keys, the manager transition, the model transition, the
delivery layer's send path, the wire stage and the exchange into next
round's inboxes, the dead-receiver stage, the delivery layer's causal
receive path, then the stats and, every ``Config.health`` rounds, the
health plane's topology snapshot.  The wire stage has the reference's
two arms:

- the FAST arm (``step``/``steps`` with no interposition, no channel
  capacity and groups partitions): compaction first, one packed
  destination-facts gather, the hash-Bernoulli edge cut, route;
- the GENERIC arm (``record``, or any interposition, the channel-capacity
  stage or dense partitions): monotonic shed, the interposition chain,
  the emitted count, the channel-capacity throttle, the fault filter,
  THE plane->wire interleave (the hand-written CUDA kernel on the card)
  only when capturing the trace, then compaction and route.

``ClusterState`` keeps the reference's field order and leaf dtypes, with
``()`` for every plane the port does not carry.  The reference's
``lax.cond`` quiet gates are host-evaluated flags here (a later slice
moves them on the device and captures ``steps(k)`` as a CUDA graph).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from partisan_tpu_torch import channels as channels_mod
from partisan_tpu_torch import delivery as delivery_mod
from partisan_tpu_torch import device as device_mod
from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import health as health_mod
from partisan_tpu_torch import interpose as interpose_mod
from partisan_tpu_torch import managers as managers_mod
from partisan_tpu_torch.comm import LocalComm
from partisan_tpu_torch.config import Config
from partisan_tpu_torch.managers.base import RoundCtx
from partisan_tpu_torch.ops import exchange, rng
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.types import W_CHANNEL, W_DST, W_KIND

_MSG_FILTER_TAG = 11


class Stats(NamedTuple):
    emitted: torch.Tensor    # int32 — event messages emitted (pre-fault)
    delivered: torch.Tensor  # int32 — delivered into inboxes
    dropped: torch.Tensor    # int32 — overflow + fault + dead-receiver drops


class ClusterState(NamedTuple):
    rnd: torch.Tensor
    faults: faults_mod.FaultState
    inbox: exchange.Inbox
    manager: Any
    model: Any
    delivery: Any
    stats: Stats
    interpose: Any = ()
    outbox: Any = ()
    metrics: Any = ()
    latency: Any = ()
    flight: Any = ()
    n_active: Any = ()   # int32 scalar active prefix width (width_operand)
    health: Any = ()
    provenance: Any = ()
    control: Any = ()
    traffic: Any = ()
    salt: Any = ()
    elastic: Any = ()
    ingress: Any = ()
    watchdog: Any = ()


class TraceRound(NamedTuple):
    rnd: torch.Tensor      # int32 — the round these sends ran in
    sent: torch.Tensor     # int32[n, E', W] — emissions entering the wire
    dropped: torch.Tensor  # bool[n, E'] — cleared by the fault stage


def _count(x: torch.Tensor) -> torch.Tensor:
    """int32 total of a bool mask or a count vector (the stats dtype)."""
    return x.sum().to(torch.int32)


def round_body(cfg: Config, manager: Any, model: Any, comm: LocalComm,
               state: ClusterState, interpose: Any = None,
               capture: bool = False, sent_out=None):
    """ONE round; ``capture`` also returns the round's ``TraceRound``.
    ``sent_out(shape)``, when given, returns the int32 tensor the trace's
    ``sent`` is written into."""
    seed = cfg.seed
    n = cfg.n_nodes
    n_act = state.n_active
    gids = comm.local_ids()
    keys = rng.node_keys(seed, state.rnd, gids)
    alive_local = state.faults.alive
    faults_wire = state.faults
    if cfg.width_operand:
        alive_local = state.faults.alive & (gids < n_act)
        faults_wire = state.faults._replace(alive=alive_local)
    ctx = RoundCtx(rnd=state.rnd, alive=alive_local, keys=keys,
                   inbox=state.inbox, faults=state.faults, n_active=n_act,
                   seed=seed)

    mstate, m_emit = manager.step(cfg, comm, state.manager, ctx)
    nbrs = None
    if model is not None:
        nbrs = manager.neighbors(cfg, mstate, comm)
        dstate_model, a_emit = model.step(cfg, comm, state.model, ctx, nbrs)
        emitted = plane_ops.concat(plane_ops.blocks_of(m_emit)
                                   + plane_ops.blocks_of(a_emit), dim=1)
    else:
        dstate_model = ()
        emitted = plane_ops.concat(plane_ops.blocks_of(m_emit), dim=1)

    dstate, wides = state.delivery, ()
    if delivery_mod.enabled(cfg):
        dstate, emitted, wides = delivery_mod.outbound(cfg, comm, dstate,
                                                       emitted, ctx)

    want_shed = cfg.monotonic_shed and any(c.monotonic for c in cfg.channels)
    dev = gids.device
    trace = None
    istate = state.interpose
    obstate = state.outbox
    fast = (interpose is None and not channels_mod.enabled(cfg)
            and cfg.resolved_partition_mode == "groups" and not capture)
    if fast:
        # FAST arm: compaction first, then ONE packed destination-facts
        # gather, the edge cut and the route; skipped when nothing was
        # emitted anywhere (the quiet-round path).
        kind_raw = emitted[W_KIND]
        n_raw = _count(kind_raw != 0)
        shed_n = torch.zeros((), dtype=torch.int32, device=dev)
        if bool(n_raw > 0):
            emc = exchange.compact_emissions(emitted, cfg.emit_compact) \
                if cfg.emit_compact else emitted
            kind_w = emc[W_KIND]
            dst_w = emc[W_DST]
            backed = state.inbox.drops > 0 if want_shed else None
            info_d = faults_mod.pack_wire_info(faults_wire, backed)[
                dst_w.clamp(0, n - 1).to(torch.int64)]
            if want_shed:
                mono_m = torch.zeros(kind_w.shape, dtype=torch.bool,
                                     device=dev)
                for i, c in enumerate(cfg.channels):
                    if c.monotonic:
                        mono_m = mono_m | (emc[W_CHANNEL] == i)
                shed = mono_m & (((info_d >> 1) & 1) == 1) & (kind_w != 0)
                kind_w = torch.where(shed, 0, kind_w)
                shed_n = _count(shed)
            cut = faults_mod.wire_cut_from_info(
                faults_wire, info_d, kind_w != 0, gids, dst_w, alive_local,
                state.faults.partition, seed, state.rnd, _MSG_FILTER_TAG)
            final = plane_ops.set_word(emc, W_KIND,
                                       torch.where(cut, 0, kind_w))
            inbox = comm.route(final)
        else:
            inbox = exchange.empty_inbox(n, cfg.inbox_cap, cfg.wire_layout,
                                         device=dev)
        n_emitted = n_raw - shed_n
    else:
        # GENERIC arm: monotonic shed, interposition, emitted count, the
        # channel-capacity throttle, the fault filter, the interleaved
        # trace when capturing, then compaction + route.
        if want_shed:
            mono = torch.tensor([c.monotonic for c in cfg.channels],
                                dtype=torch.bool, device=dev)
            backed = state.inbox.drops > 0
            ch = emitted[W_CHANNEL].clamp(0, cfg.n_channels - 1)
            dstv = emitted[W_DST].clamp(0, n - 1)
            shed = mono[ch.to(torch.int64)] & backed[dstv.to(torch.int64)] \
                & (emitted[W_KIND] != 0)
            emitted = plane_ops.set_word(
                emitted, W_KIND, torch.where(shed, 0, emitted[W_KIND]))
        if interpose is not None:
            istate, emitted = interpose.apply(cfg, comm, istate, emitted,
                                              ctx)
        n_emitted = _count(emitted[W_KIND] != 0)
        if channels_mod.enabled(cfg):
            # after the count (a deferred send was counted when emitted),
            # before the faults (it rides the wire the round it leaves)
            obstate, emitted = channels_mod.throttle(cfg, comm, obstate,
                                                     emitted)
        sent = emitted
        emitted = faults_mod.filter_msgs(faults_wire, emitted, seed,
                                         state.rnd, _MSG_FILTER_TAG)
        if capture:
            sent_buf = None if sent_out is None \
                else sent_out(tuple(sent[0].shape) + (len(sent),))
            trace = TraceRound(
                rnd=state.rnd, sent=plane_ops.interleave(sent, out=sent_buf),
                dropped=(sent[W_KIND] != 0) & (emitted[W_KIND] == 0))
        if bool((emitted[W_KIND] != 0).any()):
            e = exchange.compact_emissions(emitted, cfg.emit_compact) \
                if cfg.emit_compact else emitted
            inbox = comm.route(e)
        else:
            inbox = exchange.empty_inbox(n, cfg.inbox_cap, cfg.wire_layout,
                                         device=dev)

    # Dead-receiver stage.  On the fast arm the data mask is the identity
    # (the wire cut already severed every edge to a dead row).
    dead = ~alive_local
    inbox = exchange.Inbox(
        data=inbox.data if fast
        else plane_ops.where(dead[:, None], 0, inbox.data),
        count=torch.where(dead, 0, inbox.count),
        drops=inbox.drops + torch.where(dead, inbox.count, 0))
    ev_delivered = _count(inbox.count)
    causal_delivered = 0
    if delivery_mod.needs_inbound(cfg):
        # broadcast lanes bypass the route; p2p records are re-ordered
        # out of the inbox here
        dstate, inbox, causal_delivered = delivery_mod.inbound(
            cfg, comm, dstate, inbox, wides, ctx)
    # `dropped` books the event lane only
    stats = Stats(
        emitted=state.stats.emitted + n_emitted,
        delivered=state.stats.delivered + ev_delivered + causal_delivered,
        dropped=state.stats.dropped + (n_emitted - ev_delivered))
    hstate = state.health
    if health_mod.enabled(cfg) and bool((state.rnd + 1) % cfg.health == 0):
        # topology snapshot on the post-transition state every
        # cfg.health rounds (one host read of the round gate)
        if nbrs is None:
            nbrs = manager.neighbors(cfg, mstate, comm)
        cov_ok = True
        if model is not None and hasattr(model, "coverage"):
            n_al = alive_local.sum()
            cov_ok = (n_al > 0) & (
                model.coverage(dstate_model, alive_local, 0) >= 1.0)
        hstate = health_mod.record_snapshot(
            cfg, comm, state.health, rnd=state.rnd, nbrs=nbrs,
            alive=faults_wire.alive, cov_ok=cov_ok,
            partition=state.faults.partition)
    out = ClusterState(rnd=state.rnd + 1, faults=state.faults, inbox=inbox,
                       manager=mstate, model=dstate_model,
                       delivery=dstate, stats=stats, interpose=istate,
                       outbox=obstate, n_active=n_act, health=hstate)
    if capture:
        return out, trace
    return out


def activate(state: ClusterState, width) -> ClusterState:
    """Set the active prefix width (``Config.width_operand`` runs): rows
    [old, width) become live, their leaves already holding init values."""
    if isinstance(state.n_active, tuple):
        raise ValueError("activate() needs Config.width_operand=True")
    n = state.faults.alive.shape[0]
    w = int(width)
    if not 1 <= w <= n:
        raise ValueError(f"activate(): width {w} outside [1, {n}]")
    return state._replace(n_active=torch.tensor(
        w, dtype=torch.int32, device=state.faults.alive.device))


def active_alive(state: ClusterState) -> torch.Tensor:
    """bool[n]: faults.alive restricted to the active prefix."""
    alive = state.faults.alive
    if isinstance(state.n_active, tuple):
        return alive
    n = alive.shape[0]
    return alive & (torch.arange(n, dtype=torch.int32, device=alive.device)
                    < state.n_active)


def run_until(cluster: Any, state: ClusterState, pred, max_rounds: int,
              check_every: int = 1) -> tuple[ClusterState, int]:
    """Step until host-side ``pred(state)``; (state, round) or (state, -1)."""
    for _ in range(0, max_rounds, check_every):
        if pred(state):
            return state, int(state.rnd)
        state = cluster.steps(state, check_every)
    return (state, int(state.rnd)) if pred(state) else (state, -1)


@dataclasses.dataclass
class Cluster:
    """Runs the round step for one configuration on one device
    (``device=None`` means the card).  ``interpose`` is an interposition
    (or a ``Chain``); the egress/ingress delay keys append their Delay
    stage after it."""

    cfg: Config
    manager: Any = None
    model: Any = None
    interpose: Any = None
    device: Any = None

    def __post_init__(self) -> None:
        self.device = device_mod.resolve(self.device)
        if self.manager is None:
            self.manager = managers_mod.get(self.cfg.peer_service_manager)
        self._user_interpose = self.interpose   # before the delay wrap
        self.interpose = interpose_mod.config_delays(self.cfg,
                                                     self.interpose)
        self.comm = LocalComm(n_global=self.cfg.n_nodes,
                              inbox_cap=self.cfg.inbox_cap,
                              msg_words=self.cfg.msg_words,
                              device=self.device)

    def init(self) -> ClusterState:
        cfg, comm, dev = self.cfg, self.comm, self.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return ClusterState(
            rnd=zero,
            faults=faults_mod.none(cfg.n_nodes, cfg.resolved_partition_mode,
                                   device=dev),
            inbox=exchange.empty_inbox(comm.n_local, cfg.inbox_cap,
                                       cfg.wire_layout, device=dev),
            manager=self.manager.init(cfg, comm),
            model=self.model.init(cfg, comm) if self.model is not None
            else (),
            delivery=(delivery_mod.init(cfg, comm)
                      if delivery_mod.enabled(cfg) else ()),
            stats=Stats(zero, zero, zero),
            interpose=(self.interpose.init(cfg, comm)
                       if self.interpose is not None else ()),
            outbox=(channels_mod.init(cfg, comm)
                    if channels_mod.enabled(cfg) else ()),
            n_active=(torch.tensor(cfg.n_nodes, dtype=torch.int32,
                                   device=dev)
                      if cfg.width_operand else ()),
            health=(health_mod.init(cfg, device=dev)
                    if health_mod.enabled(cfg) else ()),
        )

    def step(self, state: ClusterState) -> ClusterState:
        return round_body(self.cfg, self.manager, self.model, self.comm,
                          state, interpose=self.interpose)

    def steps(self, state: ClusterState, k: int) -> ClusterState:
        """Run k rounds (``Config.superstep`` folds rounds without
        changing them, so it needs no separate loop here)."""
        for _ in range(k):
            state = self.step(state)
        return state

    def record(self, state: ClusterState, k: int):
        """Run k rounds capturing the send-path trace: ``(state',
        TraceRound)`` with leaves stacked on a leading round axis.  The
        interleave writes each round's ``sent`` straight into its place in
        the stacked int32[k, n, E', W] trace."""
        if k < 1:
            raise ValueError(f"record(): k must be at least 1, got {k}")
        sent = None
        rounds = []
        for i in range(k):
            def place(shape, i=i):
                nonlocal sent
                if sent is None:
                    sent = torch.empty((k,) + shape, dtype=torch.int32,
                                       device=self.device)
                return sent[i]
            state, tr = round_body(self.cfg, self.manager, self.model,
                                   self.comm, state,
                                   interpose=self.interpose, capture=True,
                                   sent_out=place)
            rounds.append(tr)
        return state, TraceRound(
            rnd=torch.stack([t.rnd for t in rounds]), sent=sent,
            dropped=torch.stack([t.dropped for t in rounds]))

    def run_until(self, state: ClusterState, pred, max_rounds: int,
                  check_every: int = 1) -> tuple[ClusterState, int]:
        return run_until(self, state, pred, max_rounds, check_every)
