"""The cluster engine: state tuple + the round step (port of
``partisan_tpu/cluster.py``).

One round advances the whole cluster ``round_ms`` of virtual time:
per-node round keys, the manager transition, the model transition, the
provenance and latency stamps (trailing wire words), the delivery
layer's send path, the wire stage and the exchange into next round's
inboxes, the latency and provenance records on the pre-mask inbox, the
dead-receiver stage, the delivery layer's causal receive path, then the
stats, the metrics ring, every ``Config.health`` rounds the health
plane's topology snapshot, and last the controllers' update.  The wire
stage has the reference's two arms:

- the FAST arm (``step``/``steps`` with no interposition, no channel
  capacity, no flight ring and groups partitions): compaction first,
  one packed destination-facts gather, the hash-Bernoulli edge cut,
  route;
- the GENERIC arm (``record``, the flight ring, or any interposition,
  the channel-capacity stage or dense partitions): monotonic shed, the
  interposition chain, the emitted count, the channel-capacity throttle,
  the fault filter, THE plane->wire interleave (the hand-written CUDA
  kernel on the card) when capturing the trace or writing the flight
  ring, then compaction and route.

``ClusterState`` keeps the reference's field order and leaf dtypes, with
``()`` for every plane that is off.  The reference's ``lax.cond`` quiet
gates are host-evaluated flags here (a later slice moves them on the
device and captures ``steps(k)`` as a CUDA graph); the planes add none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from partisan_tpu_torch import channels as channels_mod
from partisan_tpu_torch import control as control_mod
from partisan_tpu_torch import delivery as delivery_mod
from partisan_tpu_torch import device as device_mod
from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import health as health_mod
from partisan_tpu_torch import interpose as interpose_mod
from partisan_tpu_torch import latency as latency_mod
from partisan_tpu_torch import managers as managers_mod
from partisan_tpu_torch import metrics as metrics_mod
from partisan_tpu_torch import provenance as provenance_mod
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


class _SentShape(Exception):
    """Stops a shape-probing round at its trace (``Cluster.flight_shape``)."""


def _count(x: torch.Tensor) -> torch.Tensor:
    """int32 total of a bool mask or a count vector (the stats dtype)."""
    return x.sum().to(torch.int32)


def round_body(cfg: Config, manager: Any, model: Any, comm: LocalComm,
               state: ClusterState, interpose: Any = None,
               capture: bool = False, sent_out=None,
               flight_owned: bool = False):
    """ONE round; ``capture`` also returns the round's ``TraceRound``.
    ``sent_out(shape)``, when given, returns the int32 tensor the trace's
    ``sent`` is written into.  ``flight_owned`` says the state's flight
    ring belongs to this caller's run (an earlier round of the same
    ``steps`` call), so the round writes its slot in place instead of
    copying the ring first."""
    mx = metrics_mod.enabled(cfg)
    lx = latency_mod.enabled(cfg)
    px = provenance_mod.enabled(cfg)
    pspec = provenance_mod.spec_of(model) if px else None
    fx = latency_mod.flight_enabled(cfg) and state.flight != ()
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
                   control=state.control, seed=seed)

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
    if px:
        # (emitter id, sender hop), before the birth word: the latency
        # plane reads the last word
        emitted = provenance_mod.stamp(cfg, pspec, emitted, gids)
    if lx:
        emitted = latency_mod.stamp(emitted, state.rnd)

    dstate, wides = state.delivery, ()
    if delivery_mod.enabled(cfg):
        dstate, emitted, wides = delivery_mod.outbound(cfg, comm, dstate,
                                                       emitted, ctx)
    # provenance counts control records on the post-outbound, pre-wire
    # stack
    prov_stack = emitted if px else None

    want_shed = cfg.monotonic_shed and any(c.monotonic for c in cfg.channels)
    dev = gids.device
    trace = None
    istate = state.interpose
    obstate = state.outbox
    fstate = state.flight
    fast = (interpose is None and not channels_mod.enabled(cfg)
            and cfg.resolved_partition_mode == "groups" and not capture
            and not fx)
    zero = torch.zeros((), dtype=torch.int32, device=dev) \
        if fast or mx else None
    if fast:
        # FAST arm: compaction first, then ONE packed destination-facts
        # gather, the edge cut and the route; skipped when nothing was
        # emitted anywhere (the quiet-round path, whose plane counts and
        # histograms are zeros).
        kind_raw = emitted[W_KIND]
        n_raw = _count(kind_raw != 0)
        shed_n = zero
        if mx:
            fault_n = zero
            shed_ch = torch.zeros(cfg.n_channels, dtype=torch.int32,
                                  device=dev)
        if lx:
            lat_fault = lat_compact = latency_mod.zero_hist(dev)
        if bool(n_raw > 0):
            emc = exchange.compact_emissions(emitted, cfg.emit_compact) \
                if cfg.emit_compact else emitted
            kind_w = emc[W_KIND]
            dst_w = emc[W_DST]
            backed = state.inbox.drops > 0 if want_shed else None
            info_d = faults_mod.pack_wire_info(faults_wire, backed)[
                dst_w.clamp(0, n - 1).to(torch.int64)]
            shed_m = None
            if want_shed:
                mono_m = torch.zeros(kind_w.shape, dtype=torch.bool,
                                     device=dev)
                for i, c in enumerate(cfg.channels):
                    if c.monotonic:
                        mono_m = mono_m | (emc[W_CHANNEL] == i)
                shed = mono_m & (((info_d >> 1) & 1) == 1) & (kind_w != 0)
                kind_w = torch.where(shed, 0, kind_w)
                shed_n = _count(shed)
                shed_m = shed
            cut = faults_mod.wire_cut_from_info(
                faults_wire, info_d, kind_w != 0, gids, dst_w, alive_local,
                state.faults.partition, seed, state.rnd, _MSG_FILTER_TAG)
            final = plane_ops.set_word(emc, W_KIND,
                                       torch.where(cut, 0, kind_w))
            inbox = comm.route(final)
            if mx:
                fault_n = _count(cut & (kind_w != 0))
                # emc's kind word is still pre-shed: the masked count
                # sees the shed slots as live
                if shed_m is not None:
                    shed_ch = metrics_mod.channel_counts(cfg, emc,
                                                         mask=shed_m)
            if lx:
                lat_fault = latency_mod.age_hist(
                    emc, cut & (kind_w != 0), state.rnd)
                if cfg.emit_compact:
                    l_rank = torch.cumsum(kind_raw != 0, dim=1) - 1
                    lat_compact = latency_mod.age_hist(
                        emitted,
                        (kind_raw != 0) & (l_rank >= cfg.emit_compact),
                        state.rnd)
        else:
            inbox = exchange.empty_inbox(n, cfg.inbox_cap, cfg.wire_layout,
                                         device=dev)
        n_emitted = n_raw - shed_n
        if lx:
            lat_outbox = latency_mod.zero_hist(dev)
        if mx:
            m_fault, m_shed, m_outbox = fault_n, shed_n, zero
            # emitted per channel: the pre-wire stack less the sheds
            emit_ch = metrics_mod.channel_counts(cfg, emitted) - shed_ch
            m_compact = zero
            if cfg.emit_compact:
                # the fast arm compacts the pre-shed stack
                live_row = (kind_raw != 0).sum(dim=1)
                m_compact = (live_row - cfg.emit_compact).clamp(min=0) \
                    .sum().to(torch.int32)
    else:
        # GENERIC arm: monotonic shed, interposition, emitted count, the
        # channel-capacity throttle, the fault filter, the interleaved
        # trace when capturing or flight recording, then compaction +
        # route.
        if mx:
            m_shed = zero
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
            if mx:
                m_shed = _count(shed)
        if interpose is not None:
            istate, emitted = interpose.apply(cfg, comm, istate, emitted,
                                              ctx)
        n_emitted = _count(emitted[W_KIND] != 0)
        if mx:
            emit_ch = metrics_mod.channel_counts(cfg, emitted)
        if lx:
            lat_outbox = latency_mod.zero_hist(dev)
        if channels_mod.enabled(cfg):
            # after the count (a deferred send was counted when emitted),
            # before the faults (it rides the wire the round it leaves);
            # the backpressure controller's round-start pressure sets the
            # per-channel stale-shed ages
            shed_ages = (control_mod.shed_age(cfg, state.control.backpressure)
                         if cfg.control.backpressure else None)
            if lx:
                obstate, emitted, lat_outbox = channels_mod.throttle(
                    cfg, comm, obstate, emitted, birth_rnd=state.rnd,
                    shed_age=shed_ages)
            else:
                obstate, emitted = channels_mod.throttle(cfg, comm, obstate,
                                                         emitted)
        if mx:
            m_outbox = (channels_mod.shed_delta(state.outbox, obstate)
                        if channels_mod.enabled(cfg) else zero)
        sent = emitted
        emitted = faults_mod.filter_msgs(faults_wire, emitted, seed,
                                         state.rnd, _MSG_FILTER_TAG)
        if capture or fx or lx or mx:
            fault_dropped = (sent[W_KIND] != 0) & (emitted[W_KIND] == 0)
        live_any = (emitted[W_KIND] != 0).any()
        if fx:
            # one host read: the route gate and the round (the ring slot)
            go, rnd_host = torch.stack(
                [live_any.to(torch.int32), state.rnd]).tolist()
        else:
            go = bool(live_any)
        sent_wire = None
        if capture:
            sent_buf = None if sent_out is None \
                else sent_out(tuple(sent[0].shape) + (len(sent),))
            sent_wire = plane_ops.interleave(sent, out=sent_buf)
            trace = TraceRound(rnd=state.rnd, sent=sent_wire,
                               dropped=fault_dropped)
        if fx:
            fstate = latency_mod.record_flight(
                cfg, state.flight, rnd=state.rnd, rnd_host=rnd_host,
                sent=sent, sent_wire=sent_wire, dropped=fault_dropped,
                owned=flight_owned)
        if lx:
            lat_fault = latency_mod.age_hist(sent, fault_dropped, state.rnd)
            lat_compact = latency_mod.zero_hist(dev)
            if cfg.emit_compact:
                # compaction runs after the fault stage on this arm
                l_rank = torch.cumsum(emitted[W_KIND] != 0, dim=1) - 1
                lat_compact = latency_mod.age_hist(
                    emitted,
                    (emitted[W_KIND] != 0) & (l_rank >= cfg.emit_compact),
                    state.rnd)
        if mx:
            m_fault = _count(fault_dropped)
            m_compact = zero
            if cfg.emit_compact:
                live_row = (emitted[W_KIND] != 0).sum(dim=1)
                m_compact = (live_row - cfg.emit_compact).clamp(min=0) \
                    .sum().to(torch.int32)
        if go:
            e = exchange.compact_emissions(emitted, cfg.emit_compact) \
                if cfg.emit_compact else emitted
            inbox = comm.route(e)
        else:
            inbox = exchange.empty_inbox(n, cfg.inbox_cap, cfg.wire_layout,
                                         device=dev)

    dead = ~alive_local
    if mx:
        # inbox overflow is read before the dead-receiver stage folds its
        # own loss into the same drops field
        m_inbox_of = _count(inbox.drops)
        m_dead = _count(torch.where(dead, inbox.count, 0))
    ctrl_chmax = None
    if cfg.control.backpressure:
        # the backpressure sensor, computed once for latency too
        ctrl_chmax = control_mod.pressure_signal(cfg, comm, inbox.data,
                                                 dead, state.rnd)
    lt = state.latency
    if lx:
        lt = latency_mod.record_round(
            cfg, comm, lt, rnd=state.rnd, inbox_data=inbox.data, dead=dead,
            fault_hist=lat_fault, compact_hist=lat_compact,
            outbox_hist=lat_outbox, chmax=ctrl_chmax)
    pv = state.provenance
    if px:
        pv = provenance_mod.record_round(
            cfg, comm, pspec, pv, rnd=state.rnd, emitted=prov_stack,
            inbox_data=inbox.data, dead=dead, alive_local=alive_local)
    # Dead-receiver stage.  On the fast arm the data mask is the identity
    # (the wire cut already severed every edge to a dead row).
    inbox = exchange.Inbox(
        data=inbox.data if fast
        else plane_ops.where(dead[:, None], 0, inbox.data),
        count=torch.where(dead, 0, inbox.count),
        drops=inbox.drops + torch.where(dead, inbox.count, 0))
    ev_delivered = _count(inbox.count)
    if mx:
        # event-lane deliveries per channel, before the causal merge
        deliver_ch = metrics_mod.channel_counts(cfg, inbox.data)
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
    mets = state.metrics
    if mx:
        # the residual cause closes the books: sum(drops) is the round's
        # dropped delta
        m_other = (n_emitted - ev_delivered) - (
            m_compact + m_fault + m_inbox_of + m_dead + m_outbox)
        drops_vec = torch.stack([m_compact, m_fault, m_inbox_of, m_dead,
                                 m_outbox, zero, m_other]).to(torch.int32)
        dlv_of = (delivery_mod.overflow_total(dstate)
                  - delivery_mod.overflow_total(state.delivery))
        if nbrs is None:
            nbrs = manager.neighbors(cfg, mstate, comm)
        mets = metrics_mod.record_round(
            cfg, comm, state.metrics, rnd=state.rnd, emitted_ch=emit_ch,
            delivered_ch=deliver_ch, causal=causal_delivered, shed=m_shed,
            drops=drops_vec, inbox_count=inbox.count,
            alive_local=alive_local, alive_global=faults_wire.alive,
            nbrs=nbrs, dlv_overflow=dlv_of)
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
    ctrl = state.control
    if control_mod.enabled(cfg):
        # the controllers step on the planes' fresh states; the next
        # round reads the result
        ctrl = control_mod.update(cfg, state.control, rnd=state.rnd,
                                  pv=pv, health=hstate, chmax=ctrl_chmax)
    out = ClusterState(rnd=state.rnd + 1, faults=state.faults, inbox=inbox,
                       manager=mstate, model=dstate_model,
                       delivery=dstate, stats=stats, interpose=istate,
                       outbox=obstate, metrics=mets, latency=lt,
                       flight=fstate, n_active=n_act, health=hstate,
                       provenance=pv, control=ctrl)
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
        st = ClusterState(
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
            metrics=(metrics_mod.init(cfg, comm)
                     if metrics_mod.enabled(cfg) else ()),
            latency=(latency_mod.init(cfg, device=dev)
                     if latency_mod.enabled(cfg) else ()),
            n_active=(torch.tensor(cfg.n_nodes, dtype=torch.int32,
                                   device=dev)
                      if cfg.width_operand else ()),
            health=(health_mod.init(cfg, device=dev)
                    if health_mod.enabled(cfg) else ()),
            provenance=(provenance_mod.init(cfg, comm)
                        if provenance_mod.enabled(cfg) else ()),
            control=(control_mod.init(cfg, device=dev)
                     if control_mod.enabled(cfg) else ()),
        )
        if latency_mod.flight_enabled(cfg):
            st = st._replace(flight=latency_mod.flight_init(
                cfg, self.flight_shape(st), device=dev))
        return st

    def flight_shape(self, state: ClusterState) -> tuple:
        """``(n, E, W)`` of the wire stack the flight ring records.  E
        depends on the manager, model, delivery lanes, outbox and
        interposition, so it is read off the round itself: one captured
        round of ``state`` (a state without a ring) runs up to the point
        where its trace would be interleaved, and stops there.  Cached
        per cluster."""
        if getattr(self, "_flight_shape", None) is None:
            def stop(shape):
                raise _SentShape(shape)

            try:
                round_body(self.cfg, self.manager, self.model, self.comm,
                           state._replace(flight=()),
                           interpose=self.interpose, capture=True,
                           sent_out=stop)
            except _SentShape as e:
                self._flight_shape = tuple(e.args[0])
            else:
                raise RuntimeError("flight_shape: the round never reached "
                                   "its trace")
        return self._flight_shape

    def step(self, state: ClusterState) -> ClusterState:
        return round_body(self.cfg, self.manager, self.model, self.comm,
                          state, interpose=self.interpose)

    def steps(self, state: ClusterState, k: int) -> ClusterState:
        """Run k rounds (``Config.superstep`` folds rounds without
        changing them, so it needs no separate loop here).  The flight
        ring, when on, is copied once, by the first round, and written
        in place by the rest."""
        for i in range(k):
            state = round_body(self.cfg, self.manager, self.model,
                               self.comm, state, interpose=self.interpose,
                               flight_owned=i > 0)
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
                                   sent_out=place, flight_owned=i > 0)
            rounds.append(tr)
        return state, TraceRound(
            rnd=torch.stack([t.rnd for t in rounds]), sent=sent,
            dropped=torch.stack([t.dropped for t in rounds]))

    def run_until(self, state: ClusterState, pred, max_rounds: int,
                  check_every: int = 1) -> tuple[ClusterState, int]:
        return run_until(self, state, pred, max_rounds, check_every)
