"""Scenario runners (port of ``partisan_tpu/scenarios.py``): the
scenario suite's default configs 1-6, the overload harness (config 8),
the controllers' A/B harness, the HyParView view-size conformance check,
and bench.py's main path.

- :func:`config1_anti_entropy` … :func:`config6_echo`,
  :func:`config8_overload`, :func:`hyparview_views`, :data:`ALL`,
  :data:`DEFAULT_SIZES` and :func:`run_all` return the reference's
  dicts; the CLI (``python -m partisan_tpu_torch.scenarios [--only 1 ...
  6 8] [--scale S] [--metrics] [--latency] [--health] [--provenance]
  [--control-ab] [--slo ROUNDS] [--device cpu]``) prints one JSON line
  per config, the planes' series on stderr.  They run on the card unless
  given ``device="cpu"``.
- :func:`control_ab` with :func:`fanout_ab_arm`,
  :func:`fanout_calm_arm` and :func:`healing_ab_arm`: each controller
  against the static config; :func:`slo_gate` is ``--slo``'s config 8
  half (the traffic suite's half needs the traffic plane, not ported).
- The bootstraps: the full mesh's joins via node 0, the batched
  staggered overlay boot (with SCAMP's admission stagger), the
  width-operand ladder and the harnesses' one-batch join; the
  convergence loop polls coverage, or the health digest's one int32
  when the plane's cadence divides ``K_PROG``; the steady-state
  throughput instrument.
- :func:`app_model` runs the traffic suite's app models (Paxos, Lampson
  2PC, Alsberg-Day) through their scripted workload with no traffic
  plane.
- :func:`bench_config` and :func:`bench_broadcast` are bench.py's main
  path (its configuration, the ladder, one broadcast stepped to
  coverage; its plane flags optional), shared by chip_smoke.py and the
  profiler so both drive the same path.

Every stepping phase runs ``K_PROG`` rounds between host checks, as the
reference does.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from partisan_tpu_torch import cluster as cluster_mod
from partisan_tpu_torch import control as control_mod
from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import health as health_mod
from partisan_tpu_torch import latency as latency_mod
from partisan_tpu_torch import metrics as metrics_mod
from partisan_tpu_torch import provenance as provenance_mod
from partisan_tpu_torch.config import (Config, ControlConfig,
                                       HyParViewConfig, PlumtreeConfig)
from partisan_tpu_torch.models.plumtree import Plumtree

K_PROG = 10

# Plane opt-ins (the CLI's --metrics, --latency, --health,
# --provenance): scenarios run with the plane on and print its series to
# stderr as JSON lines beside the unchanged stdout lines.  With the health
# plane on, snapshots come every K_PROG rounds, so each batch ends with a
# digest describing exactly its final state and _converge polls it.
METRICS = False
LATENCY = False
HEALTH = False
PROVENANCE = False


def _sync(st) -> None:
    """Execution barrier: wait for the card to finish the state."""
    if st.rnd.device.type == "cuda":
        torch.cuda.synchronize(st.rnd.device)
    int(st.rnd)


def _metrics_cfg(cfg: Config) -> Config:
    """Apply the module-level plane opt-ins to a scenario config."""
    if METRICS:
        cfg = cfg.replace(metrics=True, metrics_ring=512)
    if LATENCY:
        cfg = cfg.replace(latency=True)
    if HEALTH:
        cfg = cfg.replace(health=K_PROG, health_ring=512)
    if PROVENANCE:
        cfg = cfg.replace(provenance=True, provenance_ring=512)
    return cfg


def _mark_bcast(st, node, slot):
    """Mark a scenario broadcast's origin in the provenance forest (a
    no-op when the plane is off)."""
    if st.provenance == ():
        return st
    return st._replace(provenance=provenance_mod.mark_origin(
        st.provenance, node, slot, rnd=int(st.rnd)))


def _emit_metrics(cfg: Config, st, label) -> None:
    """Print a run's plane series to stderr as JSON lines tagged with the
    scenario label: the metrics rows and totals, the latency percentiles,
    the health rows, the provenance headline."""
    import json
    import sys

    names = tuple(c.name for c in cfg.channels)
    if st.metrics != ():
        snap = metrics_mod.snapshot(st.metrics)
        for row in metrics_mod.rows(snap, channels=names):
            print(json.dumps({"kind": "metrics", "config": label, **row}),
                  file=sys.stderr)
        print(json.dumps({"kind": "metrics_totals", "config": label,
                          **metrics_mod.totals(snap)}), file=sys.stderr)
    if st.latency != ():
        print(json.dumps({"kind": "latency", "config": label,
                          **latency_mod.percentiles(st.latency,
                                                    channels=names)}),
              file=sys.stderr)
    if st.health != ():
        for row in health_mod.rows(health_mod.snapshot(st.health)):
            print(json.dumps({"kind": "health", "config": label, **row}),
                  file=sys.stderr)
    if st.provenance != ():
        snap = provenance_mod.snapshot(st.provenance)
        t = provenance_mod.tree(snap, 0)
        print(json.dumps({"kind": "provenance", "config": label,
                          **provenance_mod.redundancy(snap),
                          "tree_depth_mean": t["depth_mean"],
                          "tree_depth_max": t["depth_max"],
                          "coverage_round": t["cover_round"]}),
              file=sys.stderr)


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
    _emit_metrics(cfg, st, 1)
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
    _emit_metrics(cfg, st, 2)
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
    _emit_metrics(cfg, st, 3)
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
    _emit_metrics(cfg, st, 4)
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

    _emit_metrics(cfg, st, 5)
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


def config8_overload(n=96, waves=10, wave_len=12, adaptive=True, seed=7,
                     device=None):
    """Bulk-traffic overload under channel capacity, the backpressure
    controller's A/B harness: bursts of four simultaneous fresh Plumtree
    broadcasts saturate the per-edge broadcast lanes (``lane_rate=1``);
    with ``adaptive=True`` the controller sheds the stalest queued
    records.  Returns the per-channel p99/max/count of
    ``latency.percentiles``, the ``--slo`` gate's input."""
    n = max(n, 32)
    ctl = ControlConfig(backpressure=True) if adaptive else ControlConfig()
    cfg = Config(n_nodes=n, seed=seed, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups",
                 latency=True, channel_capacity=True, lane_rate=1,
                 outbox_cap=48, max_broadcasts=8, control=ctl,
                 plumtree=PlumtreeConfig(aae=False))
    model = Plumtree()
    cl = cluster_mod.Cluster(cfg, model=model, device=device)
    st = _boot_joinall(cl, 40)
    rng = np.random.default_rng(9)
    ver = 1
    for _ in range(waves):
        mm = st.model
        for s in range(4):
            src = int(rng.integers(0, n))
            mm = model.broadcast(mm, src, s, ver + 1, fresh=True)
        ver += 1
        st = cl.steps(st._replace(model=mm), wave_len)
    _sync(st)
    names = tuple(c.name for c in cfg.channels)
    pct = latency_mod.percentiles(st.latency, channels=names)
    out = {"config": 8, "n": n, "adaptive": adaptive,
           "waves": waves, "wave_len": wave_len,
           "coverage": round(float(model.coverage(
               st.model, st.faults.alive, 3, version=ver)), 4),
           "outbox_shed": int(st.outbox.shed),
           "p99": {ch: pct[ch]["p99"] for ch in names},
           "age_max": {ch: pct[ch]["max"] for ch in names},
           "delivered": {ch: pct[ch]["count"] for ch in names}}
    if adaptive:
        out["control"] = control_mod.poll(st.control)
    return out


def slo_gate(p99: dict, bound: int) -> tuple[bool, list[dict]]:
    """Per-channel p99 pass/fail rows against ``bound`` rounds; channels
    with no traffic pass."""
    rows = []
    ok = True
    for ch, v in p99.items():
        passed = v is None or v <= bound
        ok = ok and passed
        rows.append({"kind": "slo", "channel": ch, "p99": v,
                     "bound": bound, "pass": passed})
    return ok, rows


def _boot_joinall(cl, settle: int):
    """Every node joins via node 0 in one scripted batch, then ``settle``
    rounds: the A/B harnesses' bootstrap."""
    n = cl.cfg.n_nodes
    st = cl.init()
    m = cl.manager.join_many(cl.cfg, st.manager, list(range(1, n)),
                             [0] * (n - 1))
    return cl.steps(st._replace(manager=m), settle)


def fanout_ab_arm(adaptive: bool, n=128, waves=12, wave_len=10, seed=3,
                  device=None) -> dict:
    """One arm of the fanout governor's A/B: recycled-slot broadcasts
    (each resets the learned pruned flags) with AAE off and shuffles
    quiesced; returns the cumulative and steady-half redundancy ratios,
    the last slot's coverage and, adaptive, the controller's poll (and
    the final state under ``_state``)."""
    ctl = ControlConfig(fanout=True) if adaptive else ControlConfig()
    cfg = Config(n_nodes=n, seed=seed, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups",
                 provenance=True, provenance_ring=512,
                 max_broadcasts=8, control=ctl, lazy_tick_ms=3000,
                 hyparview=HyParViewConfig(active_min=6, active_max=8,
                                           shuffle_interval_ms=60_000),
                 plumtree=PlumtreeConfig(aae=False))
    model = Plumtree()
    cl = cluster_mod.Cluster(cfg, model=model, device=device)
    st = _boot_joinall(cl, 60)
    rng = np.random.default_rng(5)
    ver = 1
    for w in range(waves):
        st = st._replace(model=model.broadcast(
            st.model, int(rng.integers(0, n)), w % 4, ver + 1,
            fresh=True))
        ver += 1
        st = cl.steps(st, wave_len)
    traffic_end = int(st.rnd)
    # one more window for the last wave's lazy/graft repair
    st = cl.steps(st, wave_len)
    _sync(st)
    snap = provenance_mod.snapshot(st.provenance)
    rr = np.asarray(snap["rounds"])
    g = np.asarray(snap["gossip"]).astype(float)
    d = np.asarray(snap["dup"]).sum(axis=1).astype(float)
    tail = (rr >= traffic_end - (waves // 2) * wave_len) \
        & (rr < traffic_end)
    arm = {
        "redundancy_ratio": provenance_mod.redundancy(
            snap)["redundancy_ratio"],
        "steady_redundancy_ratio": round(
            float(d[tail].sum()) / max(float(g[tail].sum()), 1), 4),
        "coverage": round(float(model.coverage(
            st.model, st.faults.alive, (waves - 1) % 4,
            version=ver)), 4),
    }
    if adaptive:
        arm.update(control_mod.poll(st.control))
        arm["_state"] = st
    return arm


def fanout_calm_arm(adaptive: bool, n=64, seed=4, device=None) -> dict:
    """The calm run: one broadcast, no recycles, then 30 quiet rounds.
    The adaptive arm must match the static arm's coverage and redundancy
    and make no adjustment on the quiet tail."""
    ctl = ControlConfig(fanout=True) if adaptive else ControlConfig()
    cfg = Config(n_nodes=n, seed=seed, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups", provenance=True,
                 provenance_ring=256, max_broadcasts=4, control=ctl,
                 plumtree=PlumtreeConfig(aae=False))
    model = Plumtree()
    cl = cluster_mod.Cluster(cfg, model=model, device=device)
    st = _boot_joinall(cl, 40)
    st = st._replace(model=model.broadcast(st.model, 0, 0, 2))
    st = cl.steps(st, 30)
    adj_after_wave = int(st.control.fanout.adjustments) if adaptive else 0
    st = cl.steps(st, 30)                 # the quiet tail
    _sync(st)
    arm = {"redundancy_ratio": provenance_mod.redundancy(
               st.provenance)["redundancy_ratio"],
           "coverage": round(float(model.coverage(
               st.model, st.faults.alive, 0, version=2)), 4)}
    if adaptive:
        arm.update(control_mod.poll(st.control))
        arm["quiet_adjustments"] = (arm["fanout_adjustments"]
                                    - adj_after_wave)
    return arm


def healing_ab_arm(adaptive: bool, n=128, seed=11, crash_frac=0.35,
                   device=None) -> dict:
    """One arm of the healing A/B: a crash batch degrades the digest;
    returns the rounds until ``health.overlay_ok`` holds again."""
    ctl = ControlConfig(healing=True) if adaptive else ControlConfig()
    cfg = Config(n_nodes=n, seed=seed, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups", health=5,
                 health_ring=256, control=ctl)
    cl = cluster_mod.Cluster(cfg, model=Plumtree(), device=device)
    st = _boot_joinall(cl, 60)
    rng = np.random.default_rng(13)
    victims = rng.choice(np.arange(1, n), size=int(n * crash_frac),
                         replace=False)
    st = st._replace(faults=faults_mod.crash_many(
        st.faults, [int(v) for v in victims]))
    r0 = int(st.rnd)
    healed = -1
    for _ in range(60):
        st = cl.steps(st, 5)
        if health_mod.overlay_ok(health_mod.digest(st)):
            healed = int(st.rnd) - r0
            break
    arm = {"rounds_to_heal": healed}
    if adaptive:
        arm.update(control_mod.poll(st.control))
        arm["_state"] = st
    return arm


def _strip_state(arm: dict) -> dict:
    """Drop the state handle before JSON export."""
    return {k: v for k, v in arm.items() if k != "_state"}


def control_ab(scale: float = 1.0, device=None) -> dict:
    """The three controllers' A/B: for each, the closed loop against the
    static config on its headline metric (steady redundancy, per-channel
    delivery p99 under overload, rounds to heal), plus the fanout
    governor's calm-run no-regression check."""
    out: dict = {}
    n = max(64, int(128 * scale))
    fan_s = fanout_ab_arm(False, n=n, device=device)
    fan_a = _strip_state(fanout_ab_arm(True, n=n, device=device))
    out["fanout"] = {
        "metric": "steady_redundancy_ratio", "n": n,
        "static": fan_s, "adaptive": fan_a,
        "win": fan_a["steady_redundancy_ratio"]
        < fan_s["steady_redundancy_ratio"],
        "coverage_ok": fan_a["coverage"] == 1.0,
    }
    cn = max(48, int(64 * scale))
    calm_s = fanout_calm_arm(False, n=cn, device=device)
    calm_a = fanout_calm_arm(True, n=cn, device=device)
    out["fanout_calm"] = {
        "static": calm_s, "adaptive": calm_a,
        "no_regression": (calm_a["coverage"] == calm_s["coverage"]
                          and calm_a["redundancy_ratio"]
                          == calm_s["redundancy_ratio"]
                          and calm_a["quiet_adjustments"] == 0),
    }
    bp_n = max(48, int(96 * scale))
    bp_s = config8_overload(n=bp_n, adaptive=False, device=device)
    bp_a = config8_overload(n=bp_n, adaptive=True, device=device)
    bulk = [ch for ch, v in bp_s["p99"].items() if v is not None]
    # a trafficked channel must stay trafficked and strictly beat the
    # static p99
    out["backpressure"] = {
        "metric": "p99_delivery_age", "n": bp_n,
        "static": bp_s, "adaptive": bp_a,
        "win": bool(bulk) and all(
            bp_a["p99"][ch] is not None
            and bp_a["delivered"][ch] > 0
            and bp_a["p99"][ch] < bp_s["p99"][ch]
            for ch in bulk),
        "coverage_ok": bp_a["coverage"] == 1.0,
    }
    hn = max(64, int(128 * scale))
    heal_s = healing_ab_arm(False, n=hn, device=device)
    heal_a = _strip_state(healing_ab_arm(True, n=hn, device=device))
    out["healing"] = {
        "metric": "rounds_to_heal", "n": hn,
        "static": heal_s, "adaptive": heal_a,
        "win": (heal_a["rounds_to_heal"] != -1
                and (heal_s["rounds_to_heal"] == -1
                     or heal_a["rounds_to_heal"]
                     < heal_s["rounds_to_heal"])),
    }
    out["all_win"] = bool(out["fanout"]["win"]
                          and out["backpressure"]["win"]
                          and out["healing"]["win"]
                          and out["fanout_calm"]["no_regression"])
    return out


ALL = {
    1: config1_anti_entropy,
    2: config2_rumor,
    3: config3_plumtree_drop,
    4: config4_scamp_churn,
    5: config5_causal_crash,
    6: config6_echo,
    8: config8_overload,
}

DEFAULT_SIZES = {1: 16, 2: 1000, 3: 10_000, 4: 10_000, 5: 100_000, 6: 2,
                 8: 96}

# Left out of run_all's default sweep: the overload scenario is the
# backpressure A/B harness, driven by --slo and --control-ab (or --only).
OPT_IN = frozenset({8})


def run_all(scale: float = 1.0, only=None, device=None) -> list[dict]:
    """Configs 1-6 (or ``only``, which may name config 8) at
    ``DEFAULT_SIZES * scale``; config 6 runs ``max(50, int(1000 *
    scale))`` round trips per sender."""
    out = []
    for i, fn in ALL.items():
        if only and i not in only:
            continue
        if not only and i in OPT_IN:
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


def bench_broadcast(n: int, device=None, widths=None, metrics=False,
                    latency=False, provenance=False) -> dict:
    """The bench main path at ``n`` nodes: init, the width-operand ladder
    (``widths``, default [8192, n]), one broadcast from node 0 slot 0,
    stepped to coverage 1.0 (raises if it is not reached).  ``metrics``,
    ``latency`` and ``provenance`` turn bench.py's plane flags on (with
    provenance, node 0 is marked as the broadcast's origin first, as
    bench.py does).  Returns the cluster, model and
    state, the broadcast and convergence rounds, and the wall seconds of
    each phase."""
    model = Plumtree()
    cfg = bench_config(n).replace(metrics=metrics, latency=latency,
                                  provenance=provenance)
    t0 = time.perf_counter()
    cl = cluster_mod.Cluster(cfg, model=model, device=device)
    st = cl.init()
    _sync(st)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, st = _boot_ladder(lambda w: cl, n, widths=widths, settle_execs=1,
                         final_state=st)
    t_boot = time.perf_counter() - t0
    start = int(st.rnd)
    boot = st
    if provenance:
        st = st._replace(provenance=provenance_mod.mark_origin(
            st.provenance, 0, 0, rnd=start))
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


def bench_planes_report(cfg: Config, st) -> list[dict]:
    """bench.py's stderr lines for the planes that are on: the metrics
    totals, the latency percentiles, the provenance headline."""
    names = tuple(c.name for c in cfg.channels)
    n = cfg.n_nodes
    out = []
    if st.metrics != ():
        out.append({"kind": "metrics_totals", "n": n,
                    **metrics_mod.totals(metrics_mod.snapshot(st.metrics))})
    if st.latency != ():
        out.append({"kind": "latency", "n": n,
                    **latency_mod.percentiles(st.latency, channels=names)})
    if st.provenance != ():
        snap = provenance_mod.snapshot(st.provenance)
        tr = provenance_mod.tree(snap, 0)
        out.append({"kind": "provenance", "n": n,
                    **provenance_mod.redundancy(snap),
                    "tree_depth_mean": tr["depth_mean"],
                    "tree_depth_max": tr["depth_max"],
                    "branching_mean": tr["branching_mean"],
                    "branching_max": tr["branching_max"],
                    "claimed": tr["claimed"],
                    "coverage_round": tr["cover_round"]})
    return out


def main(argv=None) -> int:
    import argparse
    import json

    global METRICS, LATENCY, HEALTH, PROVENANCE
    ap = argparse.ArgumentParser(
        prog="python -m partisan_tpu_torch.scenarios",
        description="the scenario suite's configs 1-6 (and 8), one JSON "
                    "line each")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", type=int, nargs="*", default=None,
                    choices=sorted(ALL))
    ap.add_argument("--metrics", action="store_true",
                    help="run with the metrics ring on; per-round series "
                         "to stderr as JSON lines")
    ap.add_argument("--latency", action="store_true",
                    help="run with the latency plane on; per-channel "
                         "delivery-age percentiles to stderr")
    ap.add_argument("--health", action="store_true",
                    help="run with the health plane on (snapshots every "
                         "K_PROG rounds; convergence polls the digest)")
    ap.add_argument("--provenance", action="store_true",
                    help="run with the provenance plane on; redundancy, "
                         "tree depth and coverage round to stderr")
    ap.add_argument("--control-ab", action="store_true",
                    help="run the three controllers' A/B and print one "
                         "JSON object")
    ap.add_argument("--slo", type=int, default=None, metavar="ROUNDS",
                    help="config 8's static and adaptive arms and the "
                         "adaptive per-channel p99 gate at ROUNDS")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    METRICS = METRICS or args.metrics
    LATENCY = LATENCY or args.latency
    HEALTH = HEALTH or args.health
    PROVENANCE = PROVENANCE or args.provenance
    if args.control_ab:
        print(json.dumps(control_ab(scale=args.scale, device=args.device)),
              flush=True)
        return 0
    if args.slo is not None:
        n8 = max(48, int(DEFAULT_SIZES[8] * args.scale))
        static = config8_overload(n=n8, adaptive=False, device=args.device)
        adaptive = config8_overload(n=n8, adaptive=True, device=args.device)
        print(json.dumps({"kind": "overload_static", **static}), flush=True)
        print(json.dumps({"kind": "overload_adaptive", **adaptive}),
              flush=True)
        ok, rows = slo_gate(adaptive["p99"], args.slo)
        for row in rows:
            print(json.dumps(row), flush=True)
        print(json.dumps({"kind": "slo_verdict", "pass": ok,
                          "bound": args.slo}), flush=True)
        # the traffic suite's half of --slo (traffic_slo) needs the
        # traffic plane, which is not ported
        print(json.dumps({"kind": "traffic_slo", "ported": False,
                          "reason": "the traffic plane (workload.py, "
                                    "soak.py) is not ported yet"}),
              flush=True)
        return 0 if ok else 1
    for r in run_all(scale=args.scale, only=args.only, device=args.device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
