"""Scenario runners (port of ``partisan_tpu/scenarios.py``): the
scenario suite's default configs 1-6 and the HyParView view-size
conformance check, and bench.py's main path.

- :func:`config1_anti_entropy` … :func:`config6_echo`,
  :func:`hyparview_views`, :data:`ALL`, :data:`DEFAULT_SIZES` and
  :func:`run_all` return the reference's dicts; the CLI
  (``python -m partisan_tpu_torch.scenarios [--only 1 ... 6] [--scale S]
  [--health] [--device cpu]``) prints one JSON line per config.  They
  run on the card unless given ``device="cpu"``.
- The bootstraps: the full mesh's joins via node 0, the batched
  staggered overlay boot (with SCAMP's admission stagger) and the
  width-operand ladder; the convergence loop polls coverage, or the
  health digest's one int32 when the plane's cadence divides
  ``K_PROG``; the steady-state throughput instrument.
- :func:`app_model` runs the traffic suite's app models (Paxos, Lampson
  2PC, Alsberg-Day) through their scripted workload with no traffic
  plane.
- :func:`bench_config` and :func:`bench_broadcast` are bench.py's main
  path (its configuration with every plane off, the ladder, one
  broadcast stepped to coverage), shared by chip_smoke.py and the
  profiler so both drive the same path.

Every stepping phase runs ``K_PROG`` rounds between host checks, as the
reference does.  Only the health plane's opt-in (``HEALTH``, the CLI's
``--health``) is carried; the other planes' opt-ins are refused by
``Config``.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from partisan_tpu_torch import cluster as cluster_mod
from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import health as health_mod
from partisan_tpu_torch.config import (Config, HyParViewConfig,
                                       PlumtreeConfig)
from partisan_tpu_torch.models.plumtree import Plumtree

K_PROG = 10

# Health-plane opt-in (--health): topology snapshots every K_PROG rounds,
# so each batch ends with a digest describing exactly its final state;
# _converge then polls the packed digest word.
HEALTH = False


def _sync(st) -> None:
    """Execution barrier: wait for the card to finish the state."""
    if st.rnd.device.type == "cuda":
        torch.cuda.synchronize(st.rnd.device)
    int(st.rnd)


def _metrics_cfg(cfg: Config) -> Config:
    """Apply the module-level plane opt-ins to a scenario config (only
    the health plane is carried)."""
    if HEALTH:
        cfg = cfg.replace(health=K_PROG, health_ring=512)
    return cfg


def _mark_bcast(st, node, slot):
    """Mark a broadcast's origin in the provenance forest: a no-op while
    the provenance plane is not carried."""
    return st


def make_cluster_auto(cfg: Config, model=None, interpose=None,
                      device=None):
    """The scenario cluster factory.  On one card this is ``Cluster``
    (the sharded cluster is not ported)."""
    return cluster_mod.Cluster(cfg, model=model, interpose=interpose,
                               device=device)


def _boot_fullmesh(cl, n):
    """Every node joins the full mesh via node 0, then two ``K_PROG``
    executions let membership gossip settle."""
    st = cl.init()
    m = st.manager
    for i in range(1, n):
        m = cl.manager.join(cl.cfg, m, i, 0)
    st = cl.steps(st._replace(manager=m), K_PROG)
    return cl.steps(st, K_PROG)


def _boot_overlay(cl, n, settle_execs=3, on_wave=None, state=None,
                  wave_factor=4, stagger=0, wave_execs=1):
    """Batched staggered bootstrap (random contacts from
    ``np.random.default_rng(7)``) for partial-view overlays; one
    ``K_PROG`` execution per wave.  ``stagger`` (admissions/round,
    SCAMP only) spreads each wave's join admissions over rounds
    (``join_round``) and runs enough executions to cover the spread;
    ``wave_execs`` adds settle executions per wave."""
    rng = np.random.default_rng(7)
    st = cl.init() if state is None else state
    base = 1
    rnd_now = None
    while base < n:
        hi = min(base * wave_factor, n)
        nodes = np.arange(base, hi, dtype=np.int32)
        targets = rng.integers(0, base, size=nodes.shape[0]).astype(np.int32)
        execs = wave_execs
        if stagger > 0:
            if rnd_now is None:
                rnd_now = int(st.rnd)
            window = max(1, -(-nodes.shape[0] // stagger))   # ceil
            rnds = rnd_now + rng.integers(
                0, window, size=nodes.shape[0]).astype(np.int32)
            st = st._replace(manager=cl.manager.join_many(
                cl.cfg, st.manager, nodes, targets, rnds))
            execs = -(-window // K_PROG) + wave_execs - 1
        else:
            st = st._replace(manager=cl.manager.join_many(
                cl.cfg, st.manager, nodes, targets))
        for _ in range(execs):
            st = cl.steps(st, K_PROG)
        if rnd_now is not None:
            rnd_now += K_PROG * execs
        if on_wave is not None:
            on_wave(hi, st)
        base = hi
    for _ in range(settle_execs):
        st = cl.steps(st, K_PROG)
    _sync(st)
    return st


def _boot_ladder(make_cluster, n, widths=None, wave_factor=8,
                 settle_execs=1, on_wave=None, final_state=None,
                 upper_wave_factor=2):
    """Reduced-width bootstrap ladder on ONE full-width cluster: rungs
    are prefix activations of the same state (``Config.width_operand``
    must be on — the only ladder path ported).  The first rung ramps at
    ``wave_factor``, later rungs at ``upper_wave_factor``; joins come
    from ``np.random.default_rng(7)``, the reference's schedule.
    Returns (cluster, state)."""
    rng = np.random.default_rng(7)
    if widths is None:
        widths = [w for w in (8192,) if w < n] + [n]
    cl_full = make_cluster(n)
    if not cl_full.cfg.width_operand:
        raise NotImplementedError(
            "only the width-operand ladder is ported: set "
            "Config(width_operand=True)")
    return cl_full, _boot_ladder_width_op(
        cl_full, n, widths, rng, wave_factor, settle_execs, on_wave,
        final_state, upper_wave_factor)


def _boot_ladder_width_op(cl, n, widths, rng, wave_factor, settle_execs,
                          on_wave, final_state, upper_wave_factor):
    st = final_state if final_state is not None else cl.init()
    base = 1
    for w in widths:
        st = cluster_mod.activate(st, w)
        factor = upper_wave_factor \
            if (upper_wave_factor and w != widths[0]) else wave_factor
        while base < w:
            hi = min(base * factor, w)
            nodes = np.arange(base, hi, dtype=np.int32)
            targets = rng.integers(0, base,
                                   size=nodes.shape[0]).astype(np.int32)
            st = st._replace(manager=cl.manager.join_many(
                cl.cfg, st.manager, nodes, targets))
            st = cl.steps(st, K_PROG)
            if on_wave is not None:
                on_wave(hi, st, w)
            base = hi
    for _ in range(settle_execs):
        st = cl.steps(st, K_PROG)
    _sync(st)
    return st


def _throughput(cl, st):
    """Simulated rounds/sec from the best of 3 ``K_PROG``-round runs
    (after one warm-up run).  The caller's state is left as it was."""
    st = cl.steps(st, K_PROG)
    _sync(st)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        st = cl.steps(st, K_PROG)
        _sync(st)
        best = min(best, time.perf_counter() - t0)
    return K_PROG / best


def _converge(cl, st, coverage_fn, max_rounds, use_digest=True):
    """Step until converged, checked every K_PROG rounds.  Returns
    (state, converged_round | -1).  With the health plane on at a
    cadence dividing K_PROG each check reads ONE int32, the digest's
    coverage bit (the model's slot-0 coverage, set by the snapshot that
    closed the batch); otherwise ``coverage_fn(state) == 1.0``."""
    if use_digest and health_mod.enabled(cl.cfg) \
            and K_PROG % cl.cfg.health == 0:
        def done(s):
            return health_mod.digest_converged(health_mod.digest(s))
    else:
        def done(s):
            return float(coverage_fn(s)) == 1.0
    for _ in range(0, max_rounds, K_PROG):
        if done(st):
            return st, int(st.rnd)
        st = cl.steps(st, K_PROG)
    return (st, int(st.rnd)) if done(st) else (st, -1)


# ---------------------------------------------------------------------------
# Conformance oracles (distribution-level expected values)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def scamp_ideal_mean(n: int, c: int = 5, v2: bool = True, seeds=(0, 1),
                     ttl: int = 32) -> float:
    """Expected partial-view mean of the ideal SCAMP subscription process
    run directly: n sequential joins through uniform contacts, the
    contact fanning out to its view + extra copies, each copy kept
    w.p. 1/(1 + |view incl self|) or walking on (the reference's
    oracle, same draws: a contact is ``rng.choice`` over the ids joined
    so far, which ``range(j)`` gives without building the list)."""
    import random

    total = 0.0
    extras = c - 1 if v2 else c
    for seed in seeds:
        rng = random.Random(seed)
        view: dict[int, set] = {0: set()}
        for j in range(1, n):
            contact = rng.choice(range(j))
            view[j] = {contact}
            members = list(view[contact])
            targets = members + [rng.choice(members) if members else contact
                                 for _ in range(extras)]
            for t in targets:
                node, hops = t, 0
                while True:
                    hops += 1
                    known = (j == node) or (j in view[node])
                    if not known and (hops >= ttl or rng.random()
                                      < 1.0 / (2 + len(view[node]))):
                        view[node].add(j)
                        break
                    if hops >= ttl:
                        break           # known + expired: copy destroyed
                    nxts = [x for x in view[node] if x != j]
                    if not nxts:
                        if not known:
                            view[node].add(j)
                        break
                    node = rng.choice(nxts)
        total += sum(len(v) for v in view.values()) / n
    return total / len(seeds)


def rumor_fixed_point(fanout: int = 2) -> float:
    """Mean-field coverage plateau of blind infect-and-die rumor
    mongering: the susceptible fraction s solves s = exp(-fanout·(1-s));
    coverage = 1 - s (~0.7968 at fanout 2)."""
    s = 0.2
    for _ in range(64):
        s = math.exp(-fanout * (1.0 - s))
    return 1.0 - s


def hyparview_views(n=1000, settle_execs=6, device=None):
    """HyParView view-size conformance: after bootstrap every active view
    holds within [active_min, active_max] and the overlay is one
    connected component, read from the device health plane's digest."""
    cfg = Config(n_nodes=n, seed=2, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups",
                 health=K_PROG, health_ring=64)
    cl = cluster_mod.Cluster(cfg, device=device)
    st = _boot_overlay(cl, n, settle_execs=settle_execs)
    act = st.manager.active.cpu().numpy()
    alive = st.faults.alive.cpu().numpy()
    sizes = (act >= 0).sum(axis=1)[alive]
    digest = health_mod.digest(st)
    return {"config": "hyparview_views", "n": n,
            "active_min": cfg.hyparview.active_min,
            "active_max": cfg.hyparview.active_max,
            "size_mean": round(float(sizes.mean()), 2),
            "size_min": int(sizes.min()), "size_max": int(sizes.max()),
            "frac_at_least_min": round(
                float((sizes >= cfg.hyparview.active_min).mean()), 4),
            "components": health_mod.digest_components(digest),
            "healthy": health_mod.healthy(digest)}


def _coverage(model):
    return lambda s: model.coverage(s.model, s.faults.alive, 0)


def config1_anti_entropy(n=16, max_rounds=120, device=None):
    """16-node full-mesh anti-entropy: rounds to full coverage +
    simulated rounds/sec."""
    from partisan_tpu_torch.models.anti_entropy import AntiEntropy

    cfg = _metrics_cfg(Config(n_nodes=n, seed=1, inbox_cap=max(32, n + 8)))
    model = AntiEntropy()
    cl = cluster_mod.Cluster(cfg, model=model, device=device)
    st = _boot_fullmesh(cl, n)
    start = int(st.rnd)
    st = _mark_bcast(st._replace(model=model.broadcast(st.model, 0, 0)),
                     0, 0)
    st, conv = _converge(cl, st, _coverage(model), max_rounds)
    return {"config": 1, "n": n, "convergence_rounds": conv - start,
            "rounds_per_sec": round(_throughput(cl, st), 1)}


def config2_rumor(n=1000, max_rounds=200, device=None):
    """HyParView + rumor mongering: the coverage plateau of
    infect-and-die gossip and the rounds to reach 95% of it."""
    from partisan_tpu_torch.models.rumor_mongering import RumorMongering

    cfg = _metrics_cfg(Config(n_nodes=n, seed=2,
                              peer_service_manager="hyparview",
                              msg_words=16, partition_mode="groups"))
    model = RumorMongering()
    cl = cluster_mod.Cluster(cfg, model=model, device=device)
    cov = _coverage(model)
    st = _boot_overlay(cl, n)
    start = int(st.rnd)
    st = _mark_bcast(st._replace(model=model.broadcast(st.model, 0, 0)),
                     0, 0)
    trail = []
    for _ in range(max_rounds // K_PROG):
        st = cl.steps(st, K_PROG)
        trail.append((int(st.rnd), float(cov(st))))
        if len(trail) >= 3 and trail[-1][1] == trail[-3][1]:
            break   # plateaued
    plateau = trail[-1][1]
    infection = next(r for (r, c) in trail if c >= 0.95 * plateau) - start
    return {"config": 2, "n": n, "fanout": 2,
            "infection_rounds": infection,
            "coverage_plateau": round(plateau, 4),
            "expected_plateau_meanfield": round(rumor_fixed_point(2), 4),
            "rounds_per_sec": round(_throughput(cl, st), 1)}


def config3_plumtree_drop(n=10_000, drop=0.05, max_rounds=400, device=None):
    """HyParView + Plumtree under iid link drop: the lazy i_have/graft
    repair path must still converge, within the reference's bound."""
    cfg = _metrics_cfg(Config(n_nodes=n, seed=3,
                              peer_service_manager="hyparview",
                              msg_words=16, partition_mode="groups",
                              emit_compact=32 if n > 4096 else 0))
    model = Plumtree()
    cl = make_cluster_auto(cfg, model=model, device=device)
    st = _boot_overlay(cl, n)
    st = st._replace(faults=faults_mod.set_link_drop(st.faults, drop))
    start = int(st.rnd)
    st = _mark_bcast(st._replace(
        model=model.broadcast(st.model, 0, 0, start)), 0, 0)
    st, conv = _converge(cl, st, _coverage(model), max_rounds)
    bound = (2 * math.ceil(math.log2(max(n, 2))) + 8 * 3 + K_PROG)
    return {"config": 3, "n": n, "link_drop": drop,
            "repair_rounds": (conv - start) if conv >= 0 else -1,
            "expected_max_repair_rounds": bound,
            "rounds_per_sec": round(_throughput(cl, st), 1)}


def config4_scamp_churn(n=10_000, churn_per_min=0.30, rounds=120,
                        device=None):
    """SCAMP v2 under churn: the partial-view size distribution before
    and after a sustained birth/death process, against the ideal
    subscription process."""
    cfg = _metrics_cfg(Config(n_nodes=n, seed=4,
                              peer_service_manager="scamp_v2",
                              msg_words=16, partition_mode="groups",
                              inbox_cap=96))
    cl = make_cluster_auto(cfg, device=device)
    st = _boot_overlay(cl, n, stagger=40, wave_execs=2)
    for _ in range(6):
        st = cl.steps(st, K_PROG)
    _sync(st)
    stable = (st.manager.partial >= 0).sum(dim=1).cpu().numpy()
    p = churn_per_min / 60.0    # per round (one round = 1 s)
    for _ in range(max(1, rounds // K_PROG)):
        st = st._replace(faults=faults_mod.churn_step(
            st.faults, cfg.seed, st.rnd, p, p))
        st = cl.steps(st, K_PROG)
    _sync(st)
    sizes = (st.manager.partial >= 0).sum(dim=1).cpu().numpy()
    alive = st.faults.alive.cpu().numpy()
    s = sizes[alive]
    ideal = scamp_ideal_mean(n)
    ratio = float(stable.mean()) / ideal
    return {"config": 4, "n": n, "churn_per_min": churn_per_min,
            "alive": int(alive.sum()),
            "stable_partial_view_mean": round(float(stable.mean()), 2),
            "partial_view_mean": round(float(s.mean()), 2),
            "partial_view_p95": int(np.percentile(s, 95)),
            "expected_ideal_process": round(ideal, 1),
            "expected_c1_logn": round((cfg.scamp.c + 1) * np.log(n), 1),
            "ideal_ratio": round(ratio, 3),
            "in_band": bool(0.65 <= ratio <= 1.35),
            "rounds_per_sec": round(_throughput(cl, st), 1)}


def config5_causal_crash(n=100_000, senders=64, crashes=16, max_rounds=400,
                         device=None):
    """HyParView + Plumtree + point-to-point causal traffic under crash
    faults, at the north-star scale: ``senders`` nodes drawn from the
    whole id space each send two causally-ordered messages to a random
    destination while ``crashes`` nodes are down and the overlay heals
    around them.  Checks per-(sender, receiver) FIFO with exactly-once
    delivery at every receiver, and Plumtree convergence across the
    healed overlay."""
    from partisan_tpu_torch.models.p2p_chat import P2PChat
    from partisan_tpu_torch.models.stack import Stack

    n = max(n, 32)
    senders = min(senders, n // 4)
    crashes = min(crashes, n // 4)
    plum = Plumtree()
    chat = P2PChat()
    stack = Stack([plum, chat])

    def make_cfg(width):
        return _metrics_cfg(Config(
            n_nodes=width, seed=5, peer_service_manager="hyparview",
            msg_words=16, partition_mode="groups",
            causal_p2p_labels=("chat",), max_broadcasts=8, inbox_cap=16,
            emit_compact=32 if n > 4096 else 0, timer_stagger=False,
            width_operand=True,
            plumtree=PlumtreeConfig(push_slots=2, lazy_cap=4)))

    cfg = make_cfg(n)
    cl = make_cluster_auto(cfg, model=stack, device=device)

    def cov(s):
        return plum.coverage(stack.sub(s.model, 0), s.faults.alive, 0)

    def make_cluster(width):
        return cl if width == n else make_cluster_auto(
            make_cfg(width), model=stack, device=device)

    _, st = _boot_ladder(make_cluster, n)
    start = int(st.rnd)

    # Senders, receivers and crash victims, disjoint, drawn from the
    # whole id space but node 0 (the broadcast source below).
    rng = np.random.default_rng(11)
    cast = 1 + rng.choice(n - 1, size=2 * senders + crashes, replace=False)
    snd, rcv = cast[:senders], cast[senders:2 * senders]
    victims = cast[2 * senders:]
    # Two causally-ordered sends per sender (seq 1 then 2 per edge).
    nodes = np.repeat(snd, 2)
    rnds = np.stack([np.full(senders, start + 2),
                     np.full(senders, start + 6)], axis=1).reshape(-1)
    dsts = np.repeat(rcv, 2)
    st = st._replace(model=stack.replace_sub(
        st.model, 1, chat.schedule_many(stack.sub(st.model, 1),
                                        nodes, rnds, dsts)))
    alive = st.faults.alive.clone()
    alive[torch.as_tensor(victims, device=alive.device)] = False
    st = st._replace(faults=st.faults._replace(alive=alive))

    # Plumtree broadcast from node 0 over the healing overlay; the
    # convergence wall is measured around the stepped loop.
    st = _mark_bcast(st._replace(model=stack.replace_sub(
        st.model, 0, plum.broadcast(stack.sub(st.model, 0), 0, 0, start))),
        0, 0)
    _sync(st)
    t_conv = time.perf_counter()
    st, conv = _converge(cl, st, cov, max_rounds)
    _sync(st)
    conv_wall = round(time.perf_counter() - t_conv, 3)
    # let the p2p streams drain (replay cadence = retransmit timer)
    for _ in range(max(1, (cfg.retransmit_every * 4) // K_PROG)):
        st = cl.steps(st, K_PROG)
    _sync(st)

    logs = P2PChat.logs(stack.sub(st.model, 1))
    ordered = delivered = 0
    for r in rcv:
        log = logs[int(r)]
        delivered += len(log)
        ordered += P2PChat.edge_fifo_ok(log)
    rps = _throughput(cl, st)
    return {"config": 5, "n": n, "senders": int(senders),
            "crashes": int(crashes),
            "convergence_rounds": (conv - start) if conv >= 0 else -1,
            "rounds_per_sec": round(rps, 1),
            "convergence_wall_sec": conv_wall if conv >= 0 else None,
            "causal_deliveries": int(delivered),
            "causal_expected": int(2 * senders),
            "fifo_ok_receivers": int(ordered),
            "n_receivers": int(senders)}


ECHO_CSV_HEADER = ("backend,concurrency,parallelism,bytes,nummessages,"
                   "latency,time,rounds,measured_wall_s,measured")


def config6_echo(n=2, sizes_kb=(1024, 2048, 4096, 8192),
                 concurrency=(1, 2, 4, 8), latencies_ms=(1, 20, 100),
                 parallelism=1, num_messages=1000, bandwidth_mb_s=1000.0,
                 csv_path=None, device=None) -> dict:
    """The echo/latency matrix (the reference's ``performance_test``
    sweep: size × concurrency × RTT): two nodes, ``concurrency``
    ping-pong senders sharing the channel's ``parallelism`` lanes under
    capacity enforcement, ``num_messages`` round trips each, every cell
    its own run.  One round is one link traversal worth ``per_round_ms =
    max(latency / 2, size / bandwidth)``, so a lane moves ``floor(bw ·
    per_round_ms / size)`` messages a round.  ``rounds`` and
    ``measured_wall_s`` are measured; ``time`` (rounds × per_round_ms in
    µs) and ``lane_rate`` are derived.  ``csv_path`` gets the rows in the
    reference's column layout."""
    from partisan_tpu_torch.config import DEFAULT_CHANNEL, ChannelSpec
    from partisan_tpu_torch.models.echo import CLIENT, Echo

    rows = []
    for conc in concurrency:
        for size_kb in sizes_kb:
            for lat in latencies_ms:
                ser_ms = size_kb / 1024.0 / bandwidth_mb_s * 1000.0
                per_round_ms = max(lat / 2.0, ser_ms)
                lane_rate = max(1, int(
                    bandwidth_mb_s * 1024.0 * per_round_ms / 1000.0
                    // size_kb))
                model = Echo(concurrency=conc, num_messages=num_messages)
                cfg = Config(
                    n_nodes=n, seed=11, peer_service_manager="static",
                    channel_capacity=True, lane_rate=lane_rate,
                    outbox_cap=max(32, 2 * conc),
                    channels=(ChannelSpec(DEFAULT_CHANNEL,
                                          parallelism=parallelism),))
                cl = cluster_mod.Cluster(cfg, model=model, device=device)
                t0 = time.perf_counter()
                st, _ = cl.run_until(
                    cl.init(), lambda s: model.done(s.model),
                    max_rounds=2 * num_messages
                    + 4 * num_messages * conc
                    // max(parallelism * lane_rate, 1) + 50,
                    check_every=50)
                _sync(st)
                wall = round(time.perf_counter() - t0, 3)
                assert model.done(st.model), "echo run incomplete"
                echoes = int(st.model.echoed[CLIENT].sum())
                assert echoes == conc * num_messages, (echoes, conc)
                rounds = int(st.rnd)
                rows.append({
                    "backend": "partisan_tpu", "concurrency": conc,
                    "parallelism": parallelism, "bytes": size_kb * 1024,
                    "nummessages": num_messages, "latency": lat,
                    "lane_rate": lane_rate,
                    "time": int(rounds * per_round_ms * 1000),
                    "rounds": rounds, "measured_wall_s": wall,
                    "measured": 1})
    if csv_path:
        cols = ECHO_CSV_HEADER.split(",")
        with open(csv_path, "w") as f:
            f.write(ECHO_CSV_HEADER + "\n")
            for r in rows:
                f.write(",".join(str(r[c]) for c in cols) + "\n")
    return {"config": 6, "cells": len(rows), "measured_runs": len(rows),
            "rows": rows}


ALL = {
    1: config1_anti_entropy,
    2: config2_rumor,
    3: config3_plumtree_drop,
    4: config4_scamp_churn,
    5: config5_causal_crash,
    6: config6_echo,
}

DEFAULT_SIZES = {1: 16, 2: 1000, 3: 10_000, 4: 10_000, 5: 100_000, 6: 2}


def run_all(scale: float = 1.0, only=None, device=None) -> list[dict]:
    """Configs 1-6 (or ``only``) at ``DEFAULT_SIZES * scale``; config 6
    runs ``max(50, int(1000 * scale))`` round trips per sender."""
    out = []
    for i, fn in ALL.items():
        if only and i not in only:
            continue
        if i == 6:
            out.append(fn(num_messages=max(50, int(1000 * scale)),
                          device=device))
            continue
        out.append(fn(n=max(8, int(DEFAULT_SIZES[i] * scale)),
                      device=device))
    return out


# The traffic suite's app models (``partisan_tpu/scenarios.py``
# ``TRAFFIC_MODELS``) whose app half is ported: the model, its Config
# extras, its boot and its scripted workload.  The traffic plane itself
# (``traffic_scenario``) is not ported yet.
APP_MODELS = ("paxos", "commit", "alsberg_day")


def _traffic_build(model_name: str, n: int):
    """``(model, extras, boot, drive, check)`` of one app model, as the
    reference's ``_traffic_build`` builds them.  ``drive(st, start,
    rounds)`` returns the state and the app script, ``((offset, fn),
    ...)`` with ``fn(cluster, state, rnd) -> state`` applied at round
    ``start + offset``; ``check(st)`` returns ``(ok, facts)``."""
    def crowd(rounds):
        # the second script event, mid-flash-crowd, on the K_PROG grain
        return rounds // 4 // K_PROG * K_PROG + K_PROG

    def boot(cl):
        return _boot_fullmesh(cl, n)

    if model_name == "paxos":
        from partisan_tpu_torch.models.paxos import Paxos

        model = Paxos(slots=2)
        extras = dict(msg_words=13, inbox_cap=96)

        def drive(st, start, rounds):
            def prop(slot, node, value, off):
                def fn(cluster, state, rnd):
                    return state._replace(model=model.propose(
                        state.model, node, slot, value, rnd, n))
                return (off, fn)
            # decree 0 proposed calm, decree 1 by two rival proposers at
            # the same boundary
            return st, (prop(0, 1, 111, K_PROG),
                        prop(1, 2, 222, crowd(rounds)),
                        prop(1, 3, 333, crowd(rounds)))

        def check(st):
            decided0 = len(model.decided_nodes(st.model, 0))
            decided1 = len(model.decided_nodes(st.model, 1))
            return bool(model.agreement(st.model)
                        and decided0 > n // 2 and decided1 > n // 2), \
                {"decided_0": int(decided0), "decided_1": int(decided1)}

        return model, extras, boot, drive, check

    if model_name == "commit":
        from partisan_tpu_torch.models import commit as commit_mod

        model = commit_mod.CommitProtocol("lampson_2pc", slots=2)
        extras = dict(inbox_cap=96, emit_cap=16)

        def drive(st, start, rounds):
            def begin(slot, coord, value, off):
                def fn(cluster, state, rnd):
                    return state._replace(model=model.begin(
                        state.model, coord, slot, value,
                        state.faults.alive, rnd))
                return (off, fn)
            return st, (begin(0, 0, 5, K_PROG),
                        begin(1, 1, 9, crowd(rounds)))

        def check(st):
            agree = bool(model.agreement(st.model))
            delivered = int((st.model.p_status
                             == commit_mod.P_COMMIT).sum())
            return agree and delivered > 0, \
                {"agreement": agree, "commits": delivered}

        return model, extras, boot, drive, check

    if model_name == "alsberg_day":
        from partisan_tpu_torch.models.alsberg_day import AlsbergDay

        model = AlsbergDay(keys=4)
        extras = dict(inbox_cap=96, emit_cap=16)

        def drive(st, start, rounds):
            def write(client, key, value, off):
                def fn(cluster, state, rnd):
                    return state._replace(model=model.write(
                        state.model, client, key, value))
                return (off, fn)
            return st, (write(5, 0, 42, K_PROG),
                        write(6, 1, 43, crowd(rounds)))

        def check(st):
            ok = bool(st.model.req_ok[5, 0]) and bool(st.model.req_ok[6, 1])
            rep = bool(AlsbergDay.replicated(st.model, 0, st.faults.alive))
            return ok and rep, {"acked": ok, "replicated": rep}

        return model, extras, boot, drive, check

    raise ValueError(f"unknown app model {model_name!r}; have "
                     f"{APP_MODELS}")


def run_script(cl, st, events, start: int, rounds: int):
    """Step ``rounds`` rounds from round ``start``, applying each
    ``(offset, fn)`` of ``events`` at round ``start + offset`` (before
    that round runs); rounds between events run as one ``steps`` call."""
    at = sorted({off for off, _ in events if 0 <= off < rounds})
    done = 0
    for off in at + [rounds]:
        st = cl.steps(st, off - done)
        done = off
        for o, fn in events:
            if o == off:
                st = fn(cl, st, start + off)
    return st


def app_model(model_name: str, n: int = 48, rounds: int = 240,
              seed: int = 29, device=None) -> dict:
    """One app model's scripted workload of the traffic suite, with no
    traffic plane: ``Config(n_nodes=n, seed=seed, **extras)``, the full
    mesh booted, the app script at its offsets, ``rounds`` rounds, then
    the app check.  Returns the check's facts, ``app_ok``, the wall
    seconds (boot apart), the cluster and the final state."""
    model, extras, boot, drive, check = _traffic_build(model_name, n)
    cl = cluster_mod.Cluster(Config(n_nodes=n, seed=seed, **extras),
                             model=model, device=device)
    t0 = time.perf_counter()
    st = boot(cl)
    _sync(st)
    t_boot = time.perf_counter() - t0
    start = int(st.rnd)
    st, events = drive(st, start, rounds)
    t0 = time.perf_counter()
    st = run_script(cl, st, events, start, rounds)
    _sync(st)
    wall = time.perf_counter() - t0
    ok, facts = check(st)
    return {"model": model_name, "n": n, "rounds": rounds, "seed": seed,
            "app_ok": ok, **facts, "boot_s": t_boot, "run_s": wall,
            "cluster": cl, "state": st}


def bench_config(n: int) -> Config:
    """bench.py's configuration at ``n`` nodes, every plane off."""
    return Config(n_nodes=n, seed=1, peer_service_manager="hyparview",
                  msg_words=16, partition_mode="groups", max_broadcasts=8,
                  inbox_cap=16, emit_compact=32, timer_stagger=False,
                  metrics_ring=256, health_ring=256, provenance_ring=256,
                  width_operand=True,
                  hyparview=HyParViewConfig(isolation_window_ms=25_000),
                  plumtree=PlumtreeConfig(push_slots=2, lazy_cap=4))


def bench_broadcast(n: int, device=None, widths=None) -> dict:
    """The bench main path at ``n`` nodes: init, the width-operand ladder
    (``widths``, default [8192, n]), one broadcast from node 0 slot 0,
    stepped to coverage 1.0 (raises if it is not reached).  Returns the
    cluster, model and state, the broadcast and convergence rounds, and
    the wall seconds of each phase."""
    model = Plumtree()
    t0 = time.perf_counter()
    cl = cluster_mod.Cluster(bench_config(n), model=model, device=device)
    st = cl.init()
    _sync(st)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, st = _boot_ladder(lambda w: cl, n, widths=widths, settle_execs=1,
                         final_state=st)
    t_boot = time.perf_counter() - t0
    start = int(st.rnd)
    boot = st
    st = st._replace(model=model.broadcast(st.model, 0, 0, start))
    t0 = time.perf_counter()
    st, conv = _converge(
        cl, st, lambda s: model.coverage(s.model, s.faults.alive, 0),
        max(300, 2 * int(np.log2(n)) * 20))
    t_conv = time.perf_counter() - t0
    if conv < 0:
        raise AssertionError(f"n={n}: the broadcast did not reach coverage "
                             "1.0")
    return {"cluster": cl, "model": model, "boot_state": boot, "state": st,
            "start_round": start, "converged_round": conv,
            "init_s": t_init, "bootstrap_s": t_boot, "convergence_s": t_conv}


def main(argv=None) -> int:
    import argparse
    import json

    global HEALTH
    ap = argparse.ArgumentParser(
        prog="python -m partisan_tpu_torch.scenarios",
        description="the scenario suite's configs 1-6, one JSON line each")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", type=int, nargs="*", default=None,
                    choices=sorted(ALL))
    ap.add_argument("--health", action="store_true",
                    help="run with the health plane on (snapshots every "
                         "K_PROG rounds; convergence polls the digest)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    HEALTH = HEALTH or args.health
    for r in run_all(scale=args.scale, only=args.only, device=args.device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
