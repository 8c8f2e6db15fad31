"""The cluster engine: state tuple + the round step (port of
``partisan_tpu/cluster.py``).

One round advances the whole cluster ``round_ms`` of virtual time: the
elastic stage (a scale-in's deactivation when its drain deadline comes,
the resize ring), the traffic plane's churn tick, per-node round keys,
the manager transition, the traffic plane's arrivals, the ingress lane's
due requests, the model transition, the provenance and
latency stamps (trailing wire words), the delivery layer's send path,
the wire stage and the exchange into next round's inboxes, the latency
and provenance records on the pre-mask inbox, the dead-receiver stage,
the delivery layer's causal receive path, then the stats, the metrics
ring, every ``Config.health`` rounds the health plane's topology
snapshot, the controllers' update, and last the invariant watchdog.  The wire
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
  ring (not once the watchdog's trip mode has frozen it), then
  compaction and route.

``ClusterState`` keeps the reference's field order and leaf dtypes, with
``()`` for every plane that is off.  The reference's ``lax.cond`` quiet
gates are host-evaluated flags here (a later slice moves them on the
device and captures ``steps(k)`` as a CUDA graph); the planes add none.
Each stage runs under its reference ``round.*`` label
(``ops/scope.phase``: nothing at all unless a census or a profiler
capture is active).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from partisan_tpu_torch import channels as channels_mod
from partisan_tpu_torch import control as control_mod
from partisan_tpu_torch import delivery as delivery_mod
from partisan_tpu_torch import device as device_mod
from partisan_tpu_torch import elastic as elastic_mod
from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import health as health_mod
from partisan_tpu_torch import ingress as ingress_mod
from partisan_tpu_torch import interpose as interpose_mod
from partisan_tpu_torch import latency as latency_mod
from partisan_tpu_torch import managers as managers_mod
from partisan_tpu_torch import metrics as metrics_mod
from partisan_tpu_torch import provenance as provenance_mod
from partisan_tpu_torch import watchdog as watchdog_mod
from partisan_tpu_torch import workload as workload_mod
from partisan_tpu_torch.comm import LocalComm
from partisan_tpu_torch.config import Config
from partisan_tpu_torch.managers.base import RoundCtx
from partisan_tpu_torch.ops import exchange, gate, rng, scope
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
    """ONE round, on one device (``LocalComm``) or on one shard of a
    sharded cluster (``parallel/sharded.ShardComm``: the node-axis leaves
    are this shard's rows, the rest replicated); ``capture`` also
    returns the round's ``TraceRound``.
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
    tx = workload_mod.enabled(cfg)
    gx = ingress_mod.enabled(cfg)
    wdx = watchdog_mod.enabled(cfg)
    # the effective seed: with Config.salt_operand every draw keys off
    # uint32(cfg.seed) + salt (mod 2**32), so salt 0 draws what the
    # unsalted round draws and salt s what a run at seed + s draws
    seed = cfg.seed
    if cfg.salt_operand:
        seed = (state.salt + (cfg.seed & faults_mod.MASK32)) \
            & faults_mod.MASK32
    n = cfg.n_nodes
    # the elastic stage first, before any active-prefix mask: a due
    # deactivation moves n_act for the rest of the round, on the card
    estate = state.elastic
    n_act = state.n_active
    traffic_w = None
    if elastic_mod.enabled(cfg):
        with scope.phase("round.elastic"):
            estate, n_act, traffic_w = elastic_mod.track(
                cfg, state.elastic, state.rnd, state.n_active)
    if tx and cfg.traffic.churn:
        # the in-round churn tick, at round start: this round's context
        # and wire see the post-tick mask
        with scope.phase("round.traffic"):
            state = state._replace(faults=workload_mod.churn(
                cfg, state.traffic, state.faults, state.rnd, n_act,
                seed=seed))
    gids = comm.local_ids()
    keys = rng.node_keys(seed, state.rnd, gids)
    # the fault state is replicated: a shard reads its own rows of it
    alive_local = comm.local(state.faults.alive)
    faults_wire = state.faults
    if cfg.width_operand:
        # rows at or past the active width read dead, on the wire too
        ids_g = gids if comm.n_local == n else torch.arange(
            n, dtype=torch.int32, device=gids.device)
        alive_g = state.faults.alive & (ids_g < n_act)
        faults_wire = state.faults._replace(alive=alive_g)
        alive_local = comm.local(alive_g)
    ctx = RoundCtx(rnd=state.rnd, alive=alive_local, keys=keys,
                   inbox=state.inbox, faults=state.faults, n_active=n_act,
                   control=state.control, seed=seed)

    # the round.* labels (ops/scope.phase) name each stage for a census
    # (lint/cost.py) and a profiler capture (perfwatch.attribute); the
    # lint zero-cost-when-off rule keys on them
    with scope.phase("round.manager"):
        mstate, m_emit = manager.step(cfg, comm, state.manager, ctx)
    tstate = state.traffic
    t_blocks = []
    if tx:
        # open-loop arrivals: an APP block joining the one assembly
        # concatenate, riding every later stage like model emissions;
        # draining rows neither source nor receive new ones
        with scope.phase("round.traffic"):
            tstate, t_emit = workload_mod.generate(
                cfg, comm, state.traffic, ctx, width=traffic_w)
        t_blocks = [t_emit]
    gstate = state.ingress
    if gx:
        # staged external requests due this round: an [n, slots] APP
        # block after the traffic block; their sheds join the books below
        with scope.phase("round.ingress"):
            gstate, g_emit, ing_shed, ing_shed_ch = ingress_mod.release(
                cfg, comm, state.ingress, ctx)
        t_blocks = t_blocks + [g_emit]
    nbrs = None
    if model is not None:
        with scope.phase("round.model"):
            nbrs = manager.neighbors(cfg, mstate, comm)
            dstate_model, a_emit = model.step(cfg, comm, state.model, ctx,
                                              nbrs)
            emitted = plane_ops.concat(plane_ops.blocks_of(m_emit)
                                       + plane_ops.blocks_of(a_emit)
                                       + t_blocks, dim=1)
    else:
        dstate_model = ()
        emitted = plane_ops.concat(plane_ops.blocks_of(m_emit) + t_blocks,
                                   dim=1)
    if px:
        # (emitter id, sender hop), before the birth word: the latency
        # plane reads the last word
        emitted = provenance_mod.stamp(cfg, pspec, emitted, gids)
    if lx:
        emitted = latency_mod.stamp(emitted, state.rnd)

    dstate, wides = state.delivery, ()
    if delivery_mod.enabled(cfg):
        with scope.phase("round.delivery_outbound"):
            dstate, emitted, wides = delivery_mod.outbound(
                cfg, comm, dstate, emitted, ctx)
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
        # the route holds collectives: the gate reads the whole cluster
        any_emit = comm.allsum(n_raw) > 0

        def counts():
            # the plane counts and histograms of a round with no sends
            out = {"shed_n": zero}
            if mx:
                out["fault_n"] = zero
                out["shed_ch"] = torch.zeros(cfg.n_channels,
                                             dtype=torch.int32, device=dev)
            if lx:
                out["lat_fault"] = out["lat_compact"] = \
                    latency_mod.zero_hist(dev)
            return out

        def quiet():
            return {"inbox": exchange.empty_inbox(
                comm.n_local, cfg.inbox_cap, cfg.wire_layout, device=dev),
                **counts()}

        def wire():
            with scope.phase("round.wire_fast"):
                return wire_body()

        def wire_body():
            out = counts()
            emc = exchange.compact_emissions(emitted, cfg.emit_compact) \
                if cfg.emit_compact else emitted
            kind_w = emc[W_KIND]
            dst_w = emc[W_DST]
            backed = comm.gather_vec(state.inbox.drops > 0) \
                if want_shed else None
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
                out["shed_n"] = _count(shed)
                shed_m = shed
            cut = faults_mod.wire_cut_from_info(
                faults_wire, info_d, kind_w != 0, gids, dst_w, alive_local,
                comm.local(state.faults.partition), seed, state.rnd,
                _MSG_FILTER_TAG)
            final = plane_ops.set_word(emc, W_KIND,
                                       torch.where(cut, 0, kind_w))
            out["inbox"] = comm.route(final)
            if mx:
                out["fault_n"] = _count(cut & (kind_w != 0))
                # emc's kind word is still pre-shed: the masked count
                # sees the shed slots as live
                if shed_m is not None:
                    out["shed_ch"] = metrics_mod.channel_counts(
                        cfg, emc, mask=shed_m)
            if lx:
                out["lat_fault"] = latency_mod.age_hist(
                    emc, cut & (kind_w != 0), state.rnd)
                if cfg.emit_compact:
                    l_rank = torch.cumsum(kind_raw != 0, dim=1) - 1
                    out["lat_compact"] = latency_mod.age_hist(
                        emitted,
                        (kind_raw != 0) & (l_rank >= cfg.emit_compact),
                        state.rnd)
            return out

        wired = gate.cond(any_emit, wire, quiet)
        inbox, shed_n = wired["inbox"], wired["shed_n"]
        if mx:
            fault_n, shed_ch = wired["fault_n"], wired["shed_ch"]
        if lx:
            lat_fault, lat_compact = wired["lat_fault"], wired["lat_compact"]
        # the counts are this shard's; the books take the cluster's
        n_emitted = comm.allsum(n_raw - shed_n)
        if lx:
            lat_outbox = latency_mod.zero_hist(dev)
        if mx:
            m_fault, m_shed, m_outbox = comm.allsum(fault_n), \
                comm.allsum(shed_n), zero
            # emitted per channel: the pre-wire stack less the sheds
            emit_ch = comm.allsum(
                metrics_mod.channel_counts(cfg, emitted) - shed_ch)
            m_compact = zero
            if cfg.emit_compact:
                # the fast arm compacts the pre-shed stack
                live_row = (kind_raw != 0).sum(dim=1)
                m_compact = comm.allsum(
                    (live_row - cfg.emit_compact).clamp(min=0)
                    .sum().to(torch.int32))
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
            backed = comm.gather_vec(state.inbox.drops > 0)
            ch = emitted[W_CHANNEL].clamp(0, cfg.n_channels - 1)
            dstv = emitted[W_DST].clamp(0, n - 1)
            shed = mono[ch.to(torch.int64)] & backed[dstv.to(torch.int64)] \
                & (emitted[W_KIND] != 0)
            emitted = plane_ops.set_word(
                emitted, W_KIND, torch.where(shed, 0, emitted[W_KIND]))
            if mx:
                m_shed = comm.allsum(_count(shed))
        if interpose is not None:
            with scope.phase("round.interpose"):
                istate, emitted = interpose.apply(cfg, comm, istate,
                                                  emitted, ctx)
        n_emitted = comm.allsum(_count(emitted[W_KIND] != 0))
        if mx:
            emit_ch = comm.allsum(metrics_mod.channel_counts(cfg, emitted))
        if lx:
            lat_outbox = latency_mod.zero_hist(dev)
        if channels_mod.enabled(cfg):
            # after the count (a deferred send was counted when emitted),
            # before the faults (it rides the wire the round it leaves);
            # the backpressure controller's round-start pressure sets the
            # per-channel stale-shed ages
            shed_ages = None
            if cfg.control.backpressure:
                with scope.phase("round.control.backpressure"):
                    shed_ages = control_mod.shed_age(
                        cfg, state.control.backpressure)
            with scope.phase("round.throttle"):
                if lx:
                    obstate, emitted, lat_outbox = channels_mod.throttle(
                        cfg, comm, obstate, emitted, birth_rnd=state.rnd,
                        shed_age=shed_ages)
                else:
                    obstate, emitted = channels_mod.throttle(
                        cfg, comm, obstate, emitted)
        if mx:
            m_outbox = (channels_mod.shed_delta(state.outbox, obstate)
                        if channels_mod.enabled(cfg) else zero)
        with scope.phase("round.fault"):
            sent = emitted
            emitted = faults_mod.filter_msgs(faults_wire, emitted, seed,
                                             state.rnd, _MSG_FILTER_TAG)
            if capture or fx or lx or mx:
                fault_dropped = (sent[W_KIND] != 0) \
                    & (emitted[W_KIND] == 0)
        # the route holds collectives: the gate reads the whole cluster
        live_any = comm.allmax((emitted[W_KIND] != 0).any())
        frozen = 0
        if fx:
            # one host read: the route gate, the round (the ring slot)
            # and, in the watchdog's trip mode, the trip latch
            gates = [live_any.to(torch.int32), state.rnd]
            if wdx and cfg.watchdog.trip_flight:
                gates.append(state.watchdog.tripped)
            go, rnd_host, *frozen = scope.host_list(torch.stack(gates))
            frozen = frozen[0] if frozen else 0
        sent_wire = None
        if capture:
            sent_buf = None if sent_out is None \
                else sent_out(tuple(sent[0].shape) + (len(sent),))
            sent_wire = plane_ops.interleave(sent, out=sent_buf)
            trace = TraceRound(rnd=state.rnd, sent=sent_wire,
                               dropped=fault_dropped)
        if fx:
            # trip mode: once an earlier round latched a breach the ring
            # freezes; the breach round itself is the last slot written
            with scope.phase("round.flight"):
                fstate = gate.choose(
                    not frozen, lambda: latency_mod.record_flight(
                        cfg, state.flight, rnd=state.rnd, rnd_host=rnd_host,
                        sent=sent, sent_wire=sent_wire,
                        dropped=fault_dropped, owned=flight_owned),
                    lambda: state.flight)
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
            m_fault = comm.allsum(_count(fault_dropped))
            m_compact = zero
            if cfg.emit_compact:
                live_row = (emitted[W_KIND] != 0).sum(dim=1)
                m_compact = comm.allsum(
                    (live_row - cfg.emit_compact).clamp(min=0)
                    .sum().to(torch.int32))

        def routed():
            with scope.phase("round.route"):
                e = exchange.compact_emissions(emitted, cfg.emit_compact) \
                    if cfg.emit_compact else emitted
                return comm.route(e)

        def quiet():
            return exchange.empty_inbox(comm.n_local, cfg.inbox_cap,
                                        cfg.wire_layout, device=dev)

        if fx:
            inbox = gate.choose(go, routed, quiet)
        else:
            inbox = gate.cond(live_any, routed, quiet)

    if gx:
        # shed external requests are offered load: emitted and dropped
        n_emitted = n_emitted + ing_shed
        if mx:
            emit_ch = emit_ch + ing_shed_ch
    dead = ~alive_local
    if mx:
        # inbox overflow is read before the dead-receiver stage folds its
        # own loss into the same drops field
        m_inbox_of = comm.allsum(_count(inbox.drops))
        m_dead = comm.allsum(_count(torch.where(dead, inbox.count, 0)))
    ctrl_chmax = None
    if cfg.control.backpressure:
        # the backpressure sensor, computed once for latency too
        with scope.phase("round.control.backpressure"):
            ctrl_chmax = control_mod.pressure_signal(cfg, comm, inbox.data,
                                                     dead, state.rnd)
    lt = state.latency
    if lx:
        with scope.phase("round.latency"):
            lt = latency_mod.record_round(
                cfg, comm, lt, rnd=state.rnd, inbox_data=inbox.data,
                dead=dead, fault_hist=lat_fault, compact_hist=lat_compact,
                outbox_hist=lat_outbox, chmax=ctrl_chmax)
    pv = state.provenance
    if px:
        with scope.phase("round.provenance"):
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
    ev_delivered = comm.allsum(_count(inbox.count))
    if mx:
        # event-lane deliveries per channel, before the causal merge
        deliver_ch = comm.allsum(metrics_mod.channel_counts(cfg, inbox.data))
    causal_delivered = 0
    if delivery_mod.needs_inbound(cfg):
        # broadcast lanes bypass the route; p2p records are re-ordered
        # out of the inbox here
        with scope.phase("round.delivery_inbound"):
            dstate, inbox, causal_delivered = delivery_mod.inbound(
                cfg, comm, dstate, inbox, wides, ctx)
    # `dropped` books the event lane only
    drop_delta = n_emitted - ev_delivered
    if cfg.watchdog.inject_round >= 0:
        # the watchdog's test plane: ledger corruption at exactly one
        # round, whether or not the plane is on
        drop_delta = drop_delta + torch.where(
            state.rnd == cfg.watchdog.inject_round,
            cfg.watchdog.inject_amount, 0).to(torch.int32)
    stats = Stats(
        emitted=state.stats.emitted + n_emitted,
        delivered=state.stats.delivered + ev_delivered + causal_delivered,
        dropped=state.stats.dropped + drop_delta)
    mets = state.metrics
    if mx:
        with scope.phase("round.metrics"):
            # the residual cause closes the books: sum(drops) is the
            # round's dropped delta
            m_ingress = ing_shed if gx else zero
            m_other = (n_emitted - ev_delivered) - (
                m_compact + m_fault + m_inbox_of + m_dead + m_outbox
                + m_ingress)
            drops_vec = torch.stack([m_compact, m_fault, m_inbox_of,
                                     m_dead, m_outbox, m_ingress,
                                     m_other]).to(torch.int32)
            dlv_of = (delivery_mod.overflow_total(dstate)
                      - delivery_mod.overflow_total(state.delivery))
            if nbrs is None:
                nbrs = manager.neighbors(cfg, mstate, comm)
            mets = metrics_mod.record_round(
                cfg, comm, state.metrics, rnd=state.rnd,
                emitted_ch=emit_ch, delivered_ch=deliver_ch,
                causal=causal_delivered, shed=m_shed, drops=drops_vec,
                inbox_count=inbox.count, alive_local=alive_local,
                alive_global=faults_wire.alive, nbrs=nbrs,
                dlv_overflow=dlv_of)
    hstate = state.health
    if health_mod.enabled(cfg):
        # topology snapshot on the post-transition state every
        # cfg.health rounds (one host read of the round gate)
        def snapshot():
            nb = nbrs if nbrs is not None \
                else manager.neighbors(cfg, mstate, comm)
            cov_ok = True
            if model is not None and hasattr(model, "coverage"):
                n_al = alive_local.sum()
                cov_l = model.coverage(dstate_model, alive_local, 0)
                if comm.n_local == n:
                    cov_ok = (n_al > 0) & (cov_l >= 1.0)
                else:
                    # every shard's alive rows covered (a shard with
                    # none is vacuously so), and some node alive
                    ok_l = (n_al == 0) | (cov_l >= 1.0)
                    cov_ok = (comm.allsum(n_al.to(torch.int32)) > 0) & (
                        comm.allsum((~ok_l).to(torch.int32)) == 0)
            return health_mod.record_snapshot(
                cfg, comm, state.health, rnd=state.rnd, nbrs_local=nb,
                alive_global=faults_wire.alive, cov_ok=cov_ok,
                partition=state.faults.partition)

        with scope.phase("round.health"):
            hstate = gate.cond((state.rnd + 1) % cfg.health == 0, snapshot,
                               lambda: state.health)
    ctrl = state.control
    if control_mod.enabled(cfg):
        # the controllers step on the planes' fresh states; the next
        # round reads the result
        ctrl = control_mod.update(cfg, state.control, rnd=state.rnd,
                                  pv=pv, health=hstate, chmax=ctrl_chmax)
    wstate = state.watchdog
    if wdx:
        # last: the watchdog audits exactly the values the state commits,
        # injected corruption included
        with scope.phase("round.watchdog"):
            wstate = watchdog_mod.update(
                cfg, comm, state.watchdog, rnd=state.rnd, emitted=n_emitted,
                delivered=ev_delivered + causal_delivered,
                dropped=drop_delta, drops=drops_vec,
                digest=hstate.digest if health_mod.enabled(cfg) else None,
                age_hwm=lt.age_hwm if lx else None)
    out = ClusterState(rnd=state.rnd + 1, faults=state.faults, inbox=inbox,
                       manager=mstate, model=dstate_model,
                       delivery=dstate, stats=stats, interpose=istate,
                       outbox=obstate, metrics=mets, latency=lt,
                       flight=fstate, n_active=n_act, health=hstate,
                       provenance=pv, control=ctrl, traffic=tstate,
                       salt=state.salt, elastic=estate,
                       ingress=gstate, watchdog=wstate)
    if capture:
        return out, trace
    return out


def activate(state: ClusterState, width) -> ClusterState:
    """Set the active prefix width (``Config.width_operand`` runs): rows
    [old, width) become live, their leaves already holding init values.
    The width goes through ``elastic.check_width``, the guard the scale
    paths share."""
    if isinstance(state.n_active, tuple):
        raise ValueError(
            "activate() needs Config.width_operand=True (the state "
            "carries no n_active operand)")
    w = elastic_mod.check_width("activate()", width,
                                state.faults.alive.shape[0])
    return state._replace(n_active=torch.tensor(
        w, dtype=torch.int32, device=state.faults.alive.device))


def with_salt(state: ClusterState, salt) -> ClusterState:
    """Set the per-run seed salt (``Config.salt_operand`` runs): the
    round's draws key off ``cfg.seed + salt`` mod 2**32, so a run at
    salt s equals a run at ``Config(seed=cfg.seed + s)``.  The salt is a
    uint32 held in int64, as every uint32 value of the port is."""
    if isinstance(state.salt, tuple):
        raise ValueError(
            "with_salt() needs Config(salt_operand=True) (the state "
            "carries no salt operand)")
    s = np.asarray(salt).astype(np.int64) & faults_mod.MASK32
    return state._replace(salt=torch.as_tensor(
        s, device=state.faults.alive.device))


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
            traffic=(workload_mod.init(cfg, device=dev)
                     if workload_mod.enabled(cfg) else ()),
            salt=(torch.zeros((), dtype=torch.int64, device=dev)
                  if cfg.salt_operand else ()),
            elastic=(elastic_mod.init(cfg, device=dev)
                     if elastic_mod.enabled(cfg) else ()),
            ingress=(ingress_mod.init(cfg, comm)
                     if ingress_mod.enabled(cfg) else ()),
            watchdog=(watchdog_mod.init(cfg, device=dev)
                      if watchdog_mod.enabled(cfg) else ()),
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
