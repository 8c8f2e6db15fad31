"""Scenario runners (port of ``partisan_tpu/scenarios.py``): the
scenario suite's configs 1-7, the overload harness (config 8), the
elasticity scenario (config 9), the controllers' A/B harness, the
traffic SLO suite, the HyParView view-size conformance check, and
bench.py's main path.

- :func:`config1_anti_entropy` … :func:`config9_elastic`,
  :func:`hyparview_views`, :data:`ALL`, :data:`DEFAULT_SIZES` and
  :func:`run_all` return the reference's dicts; the CLI (``python -m
  partisan_tpu_torch.scenarios [--only 1 ... 9] [--scale S] [--metrics]
  [--latency] [--health] [--provenance] [--control-ab] [--slo [ROUNDS]]
  [--slo-out PATH] [--soak --soak-rounds K --ckpt-dir DIR --pipeline D]
  [--elastic [--ingress-trace PATH]] [--ops [--ops-out PATH]] [--device
  cpu]``) prints one JSON line per config, the planes' series and the ops
  journal's spans on stderr.  They run on the card unless
  given ``device="cpu"``.
- :func:`config7_soak`: the long-horizon storm soak through the soak
  engine (``soak.py``); :func:`config9_elastic`: scale-out and scale-in
  under a flash crowd through the same engine.
- :func:`control_ab` with :func:`fanout_ab_arm`,
  :func:`fanout_calm_arm` and :func:`healing_ab_arm`: each controller
  against the static config; :func:`slo_gate` is ``--slo``'s config 8
  half, :func:`traffic_slo` its traffic half: every app model of
  :data:`TRAFFIC_MODELS` under the traffic plane
  (:func:`traffic_scenario`).
- The bootstraps: the full mesh's joins via node 0, the batched
  staggered overlay boot (with SCAMP's admission stagger), the
  width-operand ladder and the harnesses' one-batch join; the
  convergence loop polls coverage, or the health digest's one int32
  when the plane's cadence divides ``K_PROG``; the steady-state
  throughput instrument.
- :func:`app_model` runs the traffic suite's app models (Paxos, Lampson
  2PC, Alsberg-Day) through their scripted workload with no traffic
  plane.
- :func:`bench_config` is bench.py's configuration; bench.py's main path
  (the ladder, one broadcast stepped to coverage) is
  ``partisan_tpu_torch.bench.run``.

Every stepping phase runs ``K_PROG`` rounds between host checks, as the
reference does.
"""

from __future__ import annotations

import functools
import math
import os
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
from partisan_tpu_torch import state_io
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
# The ops journal opt-in (--ops): the soak-engine scenarios (configs 7
# and 9, the traffic suite) fuse their run into the journal (opslog.py),
# print its incident spans to stderr as JSON lines, and fold the span
# gate into their verdicts.  OPS_OUT (--ops-out PATH) also writes the
# journal, the config label suffixed before the extension.
OPS = False
OPS_OUT = None


def _sync(st) -> None:
    """Execution barrier: wait for the card to finish the state."""
    if st.rnd.device.type == "cuda":
        torch.cuda.synchronize(st.rnd.device)
    int(st.rnd)


def _emit_ops(res, storm, label, *, channels=None, slo_rounds=None,
              crowd_x1000=None) -> dict:
    """Fuse a soak run into the ops journal, print its incident spans,
    orphan reactions, error budgets and gate verdict to stderr as JSON
    lines, write the journal when ``OPS_OUT`` is set, and return the
    counts and verdict a scenario folds in."""
    import json
    import os
    import sys

    from partisan_tpu_torch import opslog

    journal = opslog.from_soak(res, storm=storm, channels=channels,
                               slo_rounds=slo_rounds,
                               crowd_x1000=crowd_x1000)
    matched = opslog.match(journal, crowd_x1000=crowd_x1000)
    for span in matched["spans"]:
        print(json.dumps({"config": label, **span}), file=sys.stderr)
    for orphan in matched["orphans"]:
        print(json.dumps({"config": label, **orphan}), file=sys.stderr)
    if slo_rounds is not None:
        # budgets print for the record; the verdict gates on spans only
        for row in opslog.error_budgets(journal, slo_rounds=slo_rounds):
            print(json.dumps({"config": label, **row}), file=sys.stderr)
    verdict = opslog.gate(matched)
    print(json.dumps({"config": label, **verdict}), file=sys.stderr)
    if OPS_OUT:
        root, ext = os.path.splitext(OPS_OUT)
        journal.to_jsonl(f"{root}.{label}{ext or '.jsonl'}"
                         if label is not None else OPS_OUT)
    return {**matched["counts"], "ok": verdict["ok"]}


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


# At or above this many nodes, with more than one shard available,
# make_cluster_auto returns a ShardedCluster (override with
# PARTISAN_SHARDED_N, as the reference's scenarios module reads it).
SHARDED_N_MIN = int(os.environ.get("PARTISAN_SHARDED_N", 65_536))


def make_cluster_auto(cfg: Config, model=None, interpose=None,
                      device=None):
    """The cluster factory, sharded by default at scale: at
    ``n >= SHARDED_N_MIN`` with a shard count above 1
    (``parallel.mesh.shard_count``: the pinned count or
    ``PARTISAN_SHARDS``, else the number of cards) a ``ShardedCluster``
    over the largest shard count that divides n, on ``device``; a prime
    n, a count of 1 or a smaller n get the one-device ``Cluster``.  Both
    have the same API, and evolve the same state."""
    from partisan_tpu_torch import device as device_mod
    from partisan_tpu_torch.parallel import mesh as mesh_mod

    dev = device_mod.resolve(device)
    count = mesh_mod.shard_count(dev)
    if cfg.n_nodes >= SHARDED_N_MIN and count > 1:
        for k in range(count, 1, -1):
            if cfg.n_nodes % k == 0:
                from partisan_tpu_torch.parallel.sharded import (
                    ShardedCluster)

                return ShardedCluster(cfg, mesh_mod.make_mesh(k, device=dev),
                                      model=model, interpose=interpose)
    return cluster_mod.Cluster(cfg, model=model, interpose=interpose,
                               device=dev)


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


def _grow_state(old_st, new_init, old_n: int, new_n: int):
    """The legacy re-embedding of an ``old_n``-wide state into a fresh
    ``new_n``-wide init state (the multi-program ladder): every
    node-axis leaf prefix-copies (rows >= old_n keep their init values:
    alive, unjoined, inert) and same-shaped leaves (the round, Stats,
    link_drop) carry over.  Ids are global and the per-node hash streams
    are keyed by id, so the prefix cluster's dynamics are unchanged.
    ``cluster.activate`` (the width-operand ladder) is the same contract
    done in place; a dense partition matrix cannot grow and raises."""
    def leaf(o, ni):
        if o.shape == ni.shape:
            return o
        if (o.dim() == ni.dim() and o.dim() >= 1 and o.shape[0] == old_n
                and ni.shape[0] == new_n and o.shape[1:] == ni.shape[1:]):
            out = ni.clone()
            out[:old_n] = o
            return out
        raise ValueError(
            f"cannot grow state leaf {tuple(o.shape)} -> "
            f"{tuple(ni.shape)} ({old_n}->{new_n}); dense partition_mode "
            "does not support the width ladder")

    olds = [x for _, x in state_io.flatten(old_st)]
    news = [x for _, x in state_io.flatten(new_init)]
    if len(olds) != len(news):
        raise ValueError(f"state trees differ: {len(olds)} leaves vs "
                         f"{len(news)}")
    return state_io.unflatten(new_init, [leaf(o, ni)
                                         for o, ni in zip(olds, news)])


def _boot_ladder(make_cluster, n, widths=None, wave_factor=8,
                 settle_execs=1, on_wave=None, final_state=None,
                 upper_wave_factor=2):
    """Reduced-width bootstrap ladder: the early join waves run on a
    prefix of the cluster, widening between rungs.  With
    ``Config.width_operand`` every rung is a prefix activation of ONE
    full-width cluster's state (``make_cluster`` is called once, at
    ``n``); without it the legacy path builds one cluster per rung and
    re-embeds the state between rungs (:func:`_grow_state`).  The
    first rung ramps at ``wave_factor``, later rungs at
    ``upper_wave_factor``; joins come from ``np.random.default_rng(7)``,
    the reference's schedule, identical on both paths.  Returns
    (cluster, state)."""
    rng = np.random.default_rng(7)
    if widths is None:
        widths = [w for w in (8192,) if w < n] + [n]
    cl_full = make_cluster(n)
    if cl_full.cfg.width_operand:
        return cl_full, _boot_ladder_width_op(
            cl_full, n, widths, rng, wave_factor, settle_execs, on_wave,
            final_state, upper_wave_factor)
    st, cl, prev_w, base = None, None, None, 1
    for w in widths:
        cl = cl_full if w == n else make_cluster(w)
        init = final_state if (w == n and final_state is not None) \
            else cl.init()
        st = init if st is None else _grow_state(st, init, prev_w, w)
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
        prev_w = w
    for _ in range(settle_execs):
        st = cl.steps(st, K_PROG)
    _sync(st)
    return cl, st


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


def fleet_sweep(width: int = 8, n: int = 256, seed: int = 0,
                max_rounds: int = 300, settle: int = 40,
                salts=None, device=None) -> dict:
    """A distribution card over a seed population: W independent
    HyParView + Plumtree clusters, one per salt, stepped as one batched
    round (``fleet.Fleet``), each broadcasting from node 0 after the
    same scripted bootstrap and polled on the batched health digest
    until every member converges (or ``max_rounds``).  It gives
    p5/p50/p95 over the members of rounds to converge (from each
    member's snapshot ring), the whole-run redundancy ratio (provenance
    plane) and the per-channel delivery-age p99 (latency plane)."""
    from partisan_tpu_torch import fleet as fleet_mod

    cfg = Config(n_nodes=n, seed=seed, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups",
                 health=K_PROG, health_ring=max(64, max_rounds // K_PROG + 8),
                 provenance=True, provenance_ring=256, latency=True,
                 max_broadcasts=8, salt_operand=True)
    model = Plumtree()
    fl = fleet_mod.Fleet(cfg, width=width, model=model, device=device)
    t0 = time.perf_counter()
    st = fl.init(salts)
    joins, contacts = list(range(1, n)), [0] * (n - 1)
    st = st._replace(manager=fl.map_members(
        lambda m: fl.manager.join_many(cfg, m, joins, contacts),
        st.manager))
    st = fl.steps(st, settle)
    r0 = int(st.rnd)
    st = st._replace(model=fl.map_members(
        lambda m: model.broadcast(m, 0, 0, 2), st.model))
    for _ in range(0, max_rounds, K_PROG):
        words = health_mod.digest(st)
        if all(health_mod.digest_converged(w) for w in words):
            break
        st = fl.steps(st, K_PROG)
    wall = time.perf_counter() - t0

    # per-member reductions: host-side slices of the batched planes
    conv, redund, p99 = [], [], {}
    rings = st.health.rnd.cpu().numpy()
    digests = st.health.digests.cpu().numpy()
    for j in range(width):
        order = metrics_mod.ring_order(rings[j])
        hit = [int(r) - r0 for r, w in zip(rings[j][order],
                                           digests[j][order])
               if r >= r0 and health_mod.digest_converged(int(w))]
        conv.append(hit[0] if hit else -1)
        redund.append(provenance_mod.redundancy(
            fl.member_state(st, j).provenance)["redundancy_ratio"])
        for ch, v in fl.member_latency(
                st, j, channels=tuple(c.name for c in cfg.channels)
        ).items():
            p99.setdefault(ch, []).append(v["p99"])
    return {
        "config": "fleet_sweep", "width": width, "n": n, "seed": seed,
        "rounds": int(st.rnd) - r0,
        "converged": sum(1 for c in conv if c >= 0),
        "rounds_to_converge": fleet_mod.distribution(conv),
        "redundancy_ratio": fleet_mod.distribution(redund),
        "p99": {ch: fleet_mod.distribution(vs)
                for ch, vs in p99.items() if any(v is not None
                                                 for v in vs)},
        "programs": fl.programs(),
        "wall_s": round(wall, 2),
        "members": {
            "rounds_to_converge": conv,
            "redundancy_ratio": redund,
        },
    }


# ---------------------------------------------------------------------------
# The traffic SLO suite: the app models under the open-loop traffic plane
# (flash crowds, churn, partitions, one-way links, stragglers), each
# gated on the latency plane's per-channel p99.  The bulk channel may
# degrade under a flash crowd; the membership and control channels must
# hold their p99.
# ---------------------------------------------------------------------------

BULK_CHANNEL = "bulk"
TRAFFIC_SLO_BOUND = 4          # rounds: the control channels' p99 ceiling
TRAFFIC_MODELS = ("p2p_chat", "causal_chat", "paxos", "commit",
                  "alsberg_day")
# the models whose controllers-off vs controllers-on A/B the suite runs
TRAFFIC_AB_MODELS = ("p2p_chat", "causal_chat", "paxos")
# the models app_model runs without the traffic plane
APP_MODELS = ("paxos", "commit", "alsberg_day")


def _traffic_build(model_name: str, n: int):
    """``(model, extras, boot, drive, check)`` of one app model, as the
    reference's ``_traffic_build`` builds them.  ``drive(st, start,
    rounds)`` returns the state and the app script, ``((offset,
    soak.Script), ...)`` applied at round ``start + offset``;
    ``check(st)`` returns ``(ok, facts)``."""
    from partisan_tpu_torch import soak as soak_mod

    def crowd(rounds):
        # the second script event, mid-flash-crowd, on the K_PROG grain
        return rounds // 4 // K_PROG * K_PROG + K_PROG

    if model_name in ("p2p_chat", "causal_chat"):
        from partisan_tpu_torch.models.stack import Stack

        plum = Plumtree()
        # provenance on: the chat scenarios schedule Plumtree broadcasts,
        # and the crowd-window redundancy gate reads the forest
        extras = dict(peer_service_manager="hyparview", msg_words=16,
                      health=5, health_ring=256, max_broadcasts=8,
                      provenance=True, provenance_ring=512,
                      plumtree=PlumtreeConfig(push_slots=2, lazy_cap=4,
                                              aae=True))
        senders = tuple(range(1, 5))
        receivers = tuple(range(n - 8, n - 4))

        def bcast(slot, root, value, off):
            def fn(cluster, state, rnd):
                m = stack.replace_sub(state.model, 0, plum.broadcast(
                    stack.sub(state.model, 0), root, slot, value))
                return _mark_bcast(state._replace(model=m), root, slot)
            return (off, soak_mod.Script(fn))

        def bcast_events(start, rounds):
            # traffic_scenario's crowd window is [g(q), g(q) + g(2q)):
            # one broadcast strictly before it, one at its grain-snapped
            # midpoint
            def g(off):
                return max(K_PROG, off // K_PROG * K_PROG)

            q = rounds // 8
            calm = max(0, g(q) - K_PROG)
            mid = g(q) + max(K_PROG, g(2 * q) // 2 // K_PROG * K_PROG)
            return (bcast(0, 0, start + calm, calm),
                    bcast(1, 0, start + mid, mid))

        def bcast_check(st):
            """Both scheduled broadcasts covered the healed overlay."""
            return [float(plum.coverage(stack.sub(st.model, 0),
                                        st.faults.alive, s))
                    for s in (0, 1)]

        if model_name == "p2p_chat":
            from partisan_tpu_torch.models.p2p_chat import P2PChat

            chat = P2PChat()
            stack = Stack([plum, chat])
            extras["causal_p2p_labels"] = ("chat",)

            def drive(st, start, rounds):
                # two sends per sender: one calm, one inside the crowd
                nodes = np.repeat(np.asarray(senders, np.int32), 2)
                rnds = np.stack([
                    np.full(len(senders), start + 4),
                    np.full(len(senders), start + rounds // 4 + 4),
                ], axis=1).reshape(-1)
                dsts = np.repeat(np.asarray(receivers, np.int32), 2)
                m = chat.schedule_many(stack.sub(st.model, 1), nodes, rnds,
                                       dsts)
                return st._replace(
                    model=stack.replace_sub(st.model, 1, m)), \
                    bcast_events(start, rounds)

            def check(st):
                logs = P2PChat.logs(stack.sub(st.model, 1))
                got = sum(len(logs[int(r)]) for r in receivers)
                fifo = all(P2PChat.edge_fifo_ok(logs[int(r)])
                           for r in receivers)
                cov = bcast_check(st)
                return bool(fifo and got >= len(senders)
                            and all(c == 1.0 for c in cov)), \
                    {"causal_delivered": int(got),
                     "causal_expected": 2 * len(senders),
                     "bcast_coverage": cov}
        else:
            from partisan_tpu_torch.models.causal_chat import CausalChat

            chat = CausalChat()
            stack = Stack([plum, chat])
            extras["causal_labels"] = ("chat",)
            extras["n_actors"] = n

            def drive(st, start, rounds):
                m = stack.sub(st.model, 1)
                for s in senders:
                    m = chat.schedule(m, int(s), start + 4)
                    m = chat.schedule(m, int(s), start + rounds // 4 + 4)
                return st._replace(
                    model=stack.replace_sub(st.model, 1, m)), \
                    bcast_events(start, rounds)

            def check(st):
                logs = CausalChat.logs(stack.sub(st.model, 1))
                got = sum(len(lg) for lg in logs)
                cov = bcast_check(st)
                return bool(got > 0 and all(c == 1.0 for c in cov)), \
                    {"causal_delivered": int(got), "bcast_coverage": cov}

        def boot(cl):
            return _boot_joinall(cl, 40)

        return stack, extras, boot, drive, check

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
                return (off, soak_mod.Script(fn))
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
                return (off, soak_mod.Script(fn))
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
                return (off, soak_mod.Script(fn))
            return st, (write(5, 0, 42, K_PROG),
                        write(6, 1, 43, crowd(rounds)))

        def check(st):
            ok = bool(st.model.req_ok[5, 0]) and bool(st.model.req_ok[6, 1])
            rep = bool(AlsbergDay.replicated(st.model, 0, st.faults.alive))
            return ok and rep, {"acked": ok, "replicated": rep}

        return model, extras, boot, drive, check

    raise ValueError(f"unknown traffic model {model_name!r}; have "
                     f"{TRAFFIC_MODELS}")


def run_script(cl, st, events, start: int, rounds: int):
    """Step ``rounds`` rounds from round ``start``, applying each
    ``(offset, action)`` of ``events`` at round ``start + offset``
    (before that round runs); rounds between events run as one ``steps``
    call."""
    at = sorted({off for off, _ in events if 0 <= off < rounds})
    done = 0
    for off in at + [rounds]:
        st = cl.steps(st, off - done)
        done = off
        for o, action in events:
            if o == off:
                st = action.apply(cl, st, start + off)
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


def traffic_scenario(model_name: str, n: int = 64, rounds: int = 240,
                     adaptive: bool = True, seed: int = 29,
                     bound: int = TRAFFIC_SLO_BOUND, rate_x1000: int = 600,
                     crowd_x1000: int = 4000, device=None) -> dict:
    """One app model under the whole traffic plane, through the soak
    engine: open-loop bulk arrivals on a ``bulk`` channel (hot-spot
    skewed), a flash crowd over rounds/8..3/8 with stragglers riding it,
    a one-way link cut, an in-round churn pulse and a regional partition
    and heal, while the app's own script runs and must keep its
    guarantee.  Returns the reference's dict: per-channel p99 (control
    channels within ``bound``), the crowd windows' head-of-line
    isolation, conservation at every boundary, overlay recovery where
    the model runs on HyParView, and the app check.  ``adaptive`` arms
    the backpressure controller (with healing where the health plane is
    on and the fanout governor where provenance is)."""
    return _traffic_run(model_name, n=n, rounds=rounds, adaptive=adaptive,
                        seed=seed, bound=bound, rate_x1000=rate_x1000,
                        crowd_x1000=crowd_x1000, device=device)[0]


def _traffic_run(model_name: str, n: int = 64, rounds: int = 240,
                 adaptive: bool = True, seed: int = 29,
                 bound: int = TRAFFIC_SLO_BOUND, rate_x1000: int = 600,
                 crowd_x1000: int = 4000, device=None) -> tuple:
    """:func:`traffic_scenario`'s ``(dict, SoakResult, Cluster)``."""
    from partisan_tpu_torch import interpose as interpose_mod
    from partisan_tpu_torch import soak as soak_mod
    from partisan_tpu_torch import workload
    from partisan_tpu_torch.config import (DEFAULT_CHANNELS, ChannelSpec,
                                           TrafficConfig)

    n = max(n, 24)
    model, extras, boot, drive, check = _traffic_build(model_name, n)
    hx = extras.get("health", 0) > 0
    px = bool(extras.get("provenance"))
    ctl = ControlConfig(backpressure=True, healing=hx, fanout=px,
                        ring=64) if adaptive else ControlConfig()
    cfg = Config(
        n_nodes=n, seed=seed,
        channels=DEFAULT_CHANNELS + (ChannelSpec(BULK_CHANNEL),),
        latency=True, channel_capacity=True, lane_rate=1, outbox_cap=128,
        control=ctl,
        # dense faults, so the one-way cut is expressible
        partition_mode="dense",
        traffic=TrafficConfig(enabled=True, rate_x1000=rate_x1000,
                              burst_max=4, zipf_s=1.0, hot_skew=2,
                              channel=BULK_CHANNEL, churn=True, ring=256),
        **extras)

    def make():
        return cluster_mod.Cluster(
            cfg, model=model, interpose=interpose_mod.StragglerDelay(cap=16),
            device=device)

    cl = make()
    st = boot(cl)
    # the boot's deferred join backlog would dominate the cumulative p99:
    # the gate measures the storm phase only
    st = st._replace(latency=latency_mod.init(cfg, device=cl.device))
    start = int(st.rnd)
    q = rounds // 8
    st, app_events = drive(st, start, rounds)
    slow = tuple(range(n - 4, n))      # high ids: never app-critical
    half = n // 2

    def g(off: int) -> int:
        """A storm offset snapped to the K_PROG chunk grain."""
        return max(K_PROG, off // K_PROG * K_PROG)

    timeline = workload.Traffic(
        # q..3q: the flash crowd with stragglers riding it
        workload.flash_crowd(g(q), g(2 * q), crowd_x1000, rate_x1000)
        + ((g(q), workload.Stragglers(nodes=slow, mult=2)),
           (g(3 * q), workload.Stragglers(nodes=slow, mult=0)),
           # the upper half cannot reach the lower (the other way flows)
           (g(3 * q + q // 2), workload.DirectedCut(
               src=tuple(range(half, n)), dst=tuple(range(half)))),
           (g(4 * q), soak_mod.Heal()),
           # an in-round churn pulse at 0.4% a round
           (g(4 * q + q // 2), workload.SetChurn(4000)),
           (g(5 * q + q // 2), workload.SetChurn(0)),
           # a regional partition, then heal and revive; the last 2q
           # rounds are the recovery window
           (g(5 * q + q // 2), soak_mod.Partition()),
           (g(6 * q), soak_mod.Heal(revive=True)))
        + tuple(app_events))
    storm = timeline.storm(start=start)
    # the flow ledger at every boundary: exact for the event-lane
    # models; the causal lanes' fan-out gets an upward slack, the p2p
    # lane's duplicate netting a one-sided bound
    causal = bool(cfg.causal_labels or cfg.causal_p2p_labels)
    slack = (8 * n if cfg.causal_labels else 32) if causal else 0
    invariants = [soak_mod.flow_conservation(
        slack=slack, one_sided=bool(cfg.causal_p2p_labels))]
    warm = [cl]
    eng = soak_mod.Soak(
        make_cluster=lambda: warm.pop() if warm else make(),
        storm=storm, invariants=invariants,
        cfg=soak_mod.SoakConfig(chunk_fixed=K_PROG, poll_latency=True))
    t0 = time.perf_counter()
    res = eng.run(st, rounds=rounds)
    wall = time.perf_counter() - t0
    st = res.state

    names = tuple(c.name for c in cfg.channels)
    pct = latency_mod.percentiles(st.latency, channels=names)
    p99 = {ch: pct[ch]["p99"] for ch in names}
    delivered = {ch: pct[ch]["count"] for ch in names}
    # the control channels: every trafficked channel but bulk
    control_ok = all(
        p99[ch] is not None and p99[ch] <= bound
        for ch in names if ch != BULK_CHANNEL and delivered[ch] > 0)
    app_ok, app_info = check(st)
    # head-of-line isolation per window inside the crowd: bulk breached
    # while every measured control channel held
    crowd_rows = [row for row in res.chunks
                  if row.get("traffic", {}).get("rate_x1000", 0)
                  >= crowd_x1000]

    def _isolated(row):
        p = row.get("p99") or {}
        bulk_w = p.get(BULK_CHANNEL)
        ctrl = [v for ch, v in p.items()
                if ch != BULK_CHANNEL and v is not None]
        return (bulk_w is not None and bulk_w > bound
                and bool(ctrl) and all(v <= bound for v in ctrl))

    out = {
        "model": model_name, "n": n, "rounds": res.rounds,
        "adaptive": adaptive, "bound": bound,
        "crowd_chunks": len(crowd_rows),
        "crowd_isolation_chunks": sum(
            1 for row in crowd_rows if _isolated(row)),
        "p99": p99, "age_max": {ch: pct[ch]["max"] for ch in names},
        "delivered": delivered,
        "bulk_p99": p99[BULK_CHANNEL],
        "control_ok": bool(control_ok),
        "outbox_shed": int(st.outbox.shed),
        "traffic": workload.poll(st.traffic),
        "breaches": res.breaches, "retries": res.retries,
        "chunks": len(res.chunks),
        "slo_windows": _slo_window_count(res.chunks, bound),
        "app_ok": bool(app_ok), "app": app_info,
        "wall_s": round(wall, 1),
    }
    if OPS:
        out["ops"] = _emit_ops(res, storm, f"traffic_{model_name}",
                               channels=names, slo_rounds=bound,
                               crowd_x1000=crowd_x1000)
    if px:
        # the scheduled broadcasts inside the flash crowd: gossip copies
        # move during the overload and duplicates stay within them
        snap = provenance_mod.snapshot(st.provenance)
        lo, hi = start + g(q), start + g(q) + g(2 * q)
        mask = (snap["rounds"] >= lo) & (snap["rounds"] < hi)
        crowd_gossip = int(snap["gossip"][mask].sum())
        crowd_dup = int(snap["dup"][mask].sum())
        out["broadcast"] = {
            **provenance_mod.redundancy(snap),
            "crowd_gossip": crowd_gossip,
            "crowd_dup": crowd_dup,
            "crowd_redundancy": (round(crowd_dup / crowd_gossip, 4)
                                 if crowd_gossip else None),
        }
        out["broadcast_ok"] = bool(crowd_gossip > 0
                                   and crowd_dup <= crowd_gossip)
    if hx:
        # recovery: the graph bits of the last few chunk digests (the
        # coverage bit is not consulted: slot 0 carries no broadcast
        # here until the scheduled one)
        tail = [row["digest"] for row in res.chunks[-3:] if "digest" in row]
        out["overlay_ok"] = bool(any(health_mod.overlay_ok(d)
                                     for d in tail))
    if adaptive:
        out["control"] = control_mod.poll(st.control)
    return out, res, eng._cluster()


def _slo_window_count(chunks, bound: int) -> int:
    """Breach windows in a soak's chunk rows (the maximal runs
    ``telemetry.replay_traffic_events`` emits events for)."""
    from partisan_tpu_torch import telemetry as telemetry_mod

    bus = telemetry_mod.Bus()
    counter = {"n": 0}
    bus.attach("w", telemetry_mod.TRAFFIC_SLO_BREACH_WINDOW,
               lambda *_a: counter.__setitem__("n", counter["n"] + 1))
    telemetry_mod.replay_traffic_events(bus, chunks, slo_rounds=bound,
                                        crowd_x1000=2 ** 31 - 1)
    return counter["n"]


def traffic_slo(scale: float = 1.0, bound: int = TRAFFIC_SLO_BOUND,
                device=None, on_run=None) -> dict:
    """The multi-scenario SLO suite: every app model under the traffic
    plane with the controllers on, plus controllers-off arms for the A/B
    models.  Verdicts: per scenario, control p99 within ``bound``,
    conservation, overlay recovery and the app's guarantee;
    ``isolation``, some arm shows bulk degraded past the bound while the
    control channels held; ``wins``, adaptive bulk p99 below static.
    ``on_run(name, arm, dict, result, cluster)``, when given, sees every
    scenario run with its ``SoakResult`` and ``Cluster``."""
    out: dict = {"bound": bound, "scale": scale, "scenarios": {}}
    wins = 0
    isolation = 0
    all_ok = True
    for name in TRAFFIC_MODELS:
        base_n = 64 if name in ("p2p_chat", "causal_chat") else 48
        n = max(24, int(base_n * scale))
        rounds = max(80, int(240 * scale))
        entry: dict = {}

        def arm(label):
            run = _traffic_run(name, n=n, rounds=rounds,
                               adaptive=label == "adaptive", bound=bound,
                               device=device)
            if on_run is not None:
                on_run(name, label, *run)
            return run[0]

        adaptive = arm("adaptive")
        entry["adaptive"] = adaptive
        ok = (adaptive["control_ok"] and adaptive["app_ok"]
              and adaptive["breaches"] == 0
              and adaptive.get("overlay_ok", True)
              and adaptive.get("broadcast_ok", True)
              and adaptive.get("ops", {}).get("ok", True))
        entry["ok"] = bool(ok)
        all_ok = all_ok and ok
        if name in TRAFFIC_AB_MODELS:
            static = arm("static")
            entry["static"] = static
            sb, ab = static["bulk_p99"], adaptive["bulk_p99"]
            win = sb is not None and ab is not None and ab < sb
            entry["win"] = bool(win)
            wins += int(win)
        iso = max(entry.get("static", {}).get("crowd_isolation_chunks", 0),
                  adaptive["crowd_isolation_chunks"])
        if iso > 0:
            isolation += 1
            entry["isolation"] = True
        out["scenarios"][name] = entry
    out["wins"] = wins
    out["isolation_scenarios"] = isolation
    out["pass"] = bool(all_ok and wins >= 2 and isolation >= 1)
    return out


def config7_storm(start: int, period: int = 200):
    """Config 7's storm from round ``start``, repeating every ``period``
    rounds: iid link drop, heal, a 2% crash batch, a full partition, heal
    and revive, two churn ticks, heal and revive."""
    from partisan_tpu_torch import soak as soak_mod

    p = period
    return soak_mod.Storm(events=(
        (0, soak_mod.LinkDrop(0.2)),
        (p * 2 // 10, soak_mod.Heal()),
        (p * 3 // 10, soak_mod.CrashBatch(frac=0.02)),
        (p * 5 // 10, soak_mod.Partition()),
        (p * 7 // 10, soak_mod.Heal(revive=True)),
        (p * 8 // 10, soak_mod.Churn(0.01, 0.01)),
        (p * 85 // 100, soak_mod.Churn(0.01, 0.01)),
        (p * 9 // 10, soak_mod.Heal(revive=True)),
    ), start=start, period=p)


def config7_cfg(n: int = 10_000, superstep: int = 1) -> Config:
    """Config 7's Config at ``n`` nodes: HyParView + Plumtree with the
    health plane, 16-word messages and the compacted emission past 4096
    nodes."""
    return _metrics_cfg(Config(
        n_nodes=n, seed=7, peer_service_manager="hyparview", msg_words=16,
        partition_mode="groups", health=K_PROG, health_ring=512,
        superstep=superstep, emit_compact=32 if n > 4096 else 0))


def config7_soak(n=10_000, rounds=2000, ckpt_dir=None, storm_period=200,
                 superstep=1, pipeline=1, device=None) -> dict:
    """The long-horizon soak: a repeating fault storm (iid link drop,
    heal, crash batch, full partition, heal and revive, churn ticks,
    heal) over a HyParView + Plumtree overlay with the health plane,
    driven through the chunked soak engine with checkpoints every
    ``10 * K_PROG`` rounds (on disk with ``ckpt_dir``), the digest polled
    per chunk.  Chunk rows go to stderr as ``soak_chunk`` JSON lines.
    ``superstep`` folds rounds and lifts the chunk cap when the soak
    engine's memory guard admits it; ``pipeline`` >= 2 keeps
    that many chunks submitted between boundaries
    (``SoakConfig.pipeline_depth``).  With ``OPS`` the dict gains the ops
    journal's counts and verdict (``ops``)."""
    return _config7_run(n=n, rounds=rounds, ckpt_dir=ckpt_dir,
                        storm_period=storm_period, superstep=superstep,
                        pipeline=pipeline, device=device)[0]


def _config7_run(n=10_000, rounds=2000, ckpt_dir=None, storm_period=200,
                 superstep=1, pipeline=1, device=None, spool=None) -> tuple:
    """:func:`config7_soak`'s ``(dict, SoakResult, Cluster)``; ``spool``
    is the soak engine's ``Soak.spool``."""
    import json
    import sys

    from partisan_tpu_torch import soak as soak_mod

    n = max(n, 64)
    cfg = config7_cfg(n, superstep)

    def mk():
        return cluster_mod.Cluster(cfg, model=Plumtree(), device=device)

    cl = mk()
    st = _boot_overlay(cl, n)
    p = storm_period
    storm = config7_storm(int(st.rnd), p)
    warm = [cl]
    eng = soak_mod.Soak(
        make_cluster=lambda: warm.pop() if warm else mk(), storm=storm,
        invariants=[soak_mod.conservation()], spool=spool,
        cfg=soak_mod.SoakConfig(checkpoint_dir=ckpt_dir,
                                checkpoint_every=10 * K_PROG,
                                pipeline_depth=pipeline))
    t0 = time.perf_counter()
    res = eng.run(st, rounds=rounds)
    wall = time.perf_counter() - t0
    for row in res.chunks:
        print(json.dumps({"kind": "soak_chunk", "config": 7, **row}),
              file=sys.stderr)
    _emit_metrics(cl.cfg, res.state, 7)
    digest = health_mod.digest(res.state)
    out = {"config": 7, "n": n, "rounds": res.rounds,
           "chunks": len(res.chunks), "programs": res.programs,
           "retries": res.retries, "breaches": res.breaches,
           "storm_period": p, "wall_s": round(wall, 1),
           "rounds_per_sec": round(res.rounds / max(wall, 1e-9), 1),
           "components": health_mod.digest_components(digest),
           "healthy": health_mod.healthy(digest)}
    if OPS:
        out["ops"] = _emit_ops(
            res, storm, 7, channels=tuple(c.name for c in cl.cfg.channels))
    return out, res, eng._cluster()


def config9_elastic(n=8192, seed=7, drain=3 * K_PROG, bound=8,
                    ingress_trace=None, ckpt_dir=None, device=None) -> dict:
    """Runtime elasticity under live traffic: a cluster booted at half its
    capacity scales out to full width in the middle of a flash crowd (the
    new rows join through the join path), takes a 2% crash batch, then
    scales in to a quarter through the graceful leave (a drain window and
    the deactivation inside the round), and heals: one storm timeline
    through the soak engine, checkpointed every ``10 * K_PROG`` rounds.

    Gates: no conservation breach, the overlay recovered (the health
    digest one component and healthy), per-channel delivery-age p99 <=
    ``bound``, and the elastic timeline exactly [half, full, quarter].
    ``ingress_trace`` replays a recorded request trace (``ingress.Journal``
    lines) through the ingress lane beside the in-round traffic.  Chunk
    rows go to stderr as ``soak_chunk`` JSON lines.  With ``OPS`` the
    dict gains the ops journal's counts and verdict (``ops``), and
    ``pass`` needs its gate too."""
    return _config9_run(n=n, seed=seed, drain=drain, bound=bound,
                        ingress_trace=ingress_trace, ckpt_dir=ckpt_dir,
                        device=device)[0]


def config9_cfg(n: int = 8192, seed: int = 7, ingress: bool = False
                ) -> Config:
    """Config 9's Config at ``n`` nodes (capacity): HyParView + Plumtree,
    the width operand and the elastic carry, the latency and metrics
    planes, the health plane every K_PROG rounds, the traffic plane at
    rate 300, the ingress lane (8 slots) when ``ingress``, and the
    compacted emission past 4096 nodes."""
    from partisan_tpu_torch.config import IngressConfig, TrafficConfig

    return Config(
        n_nodes=n, seed=seed, peer_service_manager="hyparview",
        msg_words=16, partition_mode="groups", width_operand=True,
        elastic=True, latency=True, metrics=True, metrics_ring=512,
        health=K_PROG, health_ring=512,
        traffic=TrafficConfig(enabled=True, rate_x1000=300, burst_max=2,
                              hot_skew=1),
        ingress=IngressConfig(enabled=ingress, slots=8),
        emit_compact=32 if n > 4096 else 0)


def config9_boot(cl, w0: int):
    """Config 9's boot: activate the ``w0`` prefix and join it in waves of
    factor 8 (contacts from ``default_rng(7)``), K_PROG rounds a wave,
    then 3 * K_PROG settle rounds."""
    st = cluster_mod.activate(cl.init(), w0)
    rng = np.random.default_rng(7)
    base = 1
    while base < w0:
        hi = min(base * 8, w0)
        nodes = np.arange(base, hi, dtype=np.int32)
        tgts = rng.integers(0, base, size=nodes.shape[0]).astype(np.int32)
        st = cl.steps(st._replace(manager=cl.manager.join_many(
            cl.cfg, st.manager, nodes, tgts)), K_PROG)
        base = hi
    for _ in range(3):
        st = cl.steps(st, K_PROG)
    _sync(st)
    return st


def _config9_run(n=8192, seed=7, drain=3 * K_PROG, bound=8,
                 ingress_trace=None, ckpt_dir=None, device=None,
                 step_fn=None, spool=None) -> tuple:
    """:func:`config9_elastic`'s ``(dict, SoakResult, Cluster)``;
    ``step_fn`` and ``spool`` are the soak engine's chunk dispatch
    (``Soak.step_fn``) and telemetry spool (``Soak.spool``)."""
    import json
    import sys

    from partisan_tpu_torch import elastic as elastic_mod
    from partisan_tpu_torch import soak as soak_mod
    from partisan_tpu_torch import workload as workload_mod

    n = max(n, 64)
    w0, w_hi, w_lo = n // 2, n, n // 4
    cfg = config9_cfg(n, seed, ingress=ingress_trace is not None)

    def mk():
        return cluster_mod.Cluster(cfg, model=Plumtree(), device=device)

    cl = mk()
    st = config9_boot(cl, w0)
    # the timeline, in K_PROG phases: a flash crowd, the scale-out in its
    # middle, a crash batch, the crowd's end, the scale-in (drain, then
    # the deactivation inside the round), the heal
    P = K_PROG
    crowd_rate = 1500
    events = (
        workload_mod.flash_crowd(P, 6 * P, crowd_rate, 300)
        + ((2 * P, soak_mod.ScaleOut(w_hi)),
           (4 * P, soak_mod.CrashBatch(frac=0.02)),
           (8 * P, soak_mod.ScaleIn(w_lo, drain=drain)),
           (8 * P + drain + P, soak_mod.Heal(revive=True))))
    storm = workload_mod.Traffic(events=()).storm(start=int(st.rnd),
                                                  extra=events)
    feed = None
    if ingress_trace is not None:
        from partisan_tpu_torch import ingress as ingress_mod

        feed = ingress_mod.IngressFeed(journal_path=ingress_trace)
    warm = [cl]
    eng = soak_mod.Soak(
        make_cluster=lambda: warm.pop() if warm else mk(), storm=storm,
        invariants=[soak_mod.conservation()], ingress=feed,
        step_fn=step_fn, spool=spool,
        cfg=soak_mod.SoakConfig(poll_latency=True, checkpoint_dir=ckpt_dir,
                                checkpoint_every=10 * K_PROG))
    rounds = 8 * P + drain + 6 * P
    t0 = time.perf_counter()
    res = eng.run(st, rounds=rounds)
    wall = time.perf_counter() - t0
    for row in res.chunks:
        print(json.dumps({"kind": "soak_chunk", "config": 9, **row}),
              file=sys.stderr)
    _emit_metrics(cl.cfg, res.state, 9)
    digest = health_mod.digest(res.state)
    timeline = elastic_mod.snapshot(res.state.elastic)
    names = tuple(c.name for c in cl.cfg.channels)
    pct = latency_mod.percentiles(res.state.latency, channels=names)
    p99 = {ch: pct[ch]["p99"] for ch in names}
    slo_ok, _rows = slo_gate(p99, bound)
    widths = [int(w) for w in timeline["widths"]]
    out = {"config": 9, "n": n, "rounds": res.rounds,
           "chunks": len(res.chunks), "retries": res.retries,
           "breaches": res.breaches,
           "widths": widths, "resizes": timeline["resizes"],
           "n_active": timeline["n_active"],
           "traffic": workload_mod.poll(res.state.traffic),
           "p99": p99, "slo_bound": bound,
           "wall_s": round(wall, 1),
           "components": health_mod.digest_components(digest),
           "overlay_ok": health_mod.overlay_ok(digest),
           "pass": (res.breaches == 0 and bool(slo_ok)
                    and health_mod.overlay_ok(digest)
                    and widths == [w0, w_hi, w_lo]
                    and timeline["n_active"] == w_lo)}
    if feed is not None:
        from partisan_tpu_torch import ingress as ingress_mod

        out["ingress"] = ingress_mod.poll(res.state.ingress)
    if OPS:
        out["ops"] = _emit_ops(res, storm, 9, channels=names,
                               slo_rounds=bound, crowd_x1000=crowd_rate)
        out["pass"] = bool(out["pass"] and out["ops"]["ok"])
    return out, res, eng._cluster()


def bench_config(n: int) -> Config:
    """bench.py's configuration at ``n`` nodes, every plane off."""
    return Config(n_nodes=n, seed=1, peer_service_manager="hyparview",
                  msg_words=16, partition_mode="groups", max_broadcasts=8,
                  inbox_cap=16, emit_compact=32, timer_stagger=False,
                  metrics_ring=256, health_ring=256, provenance_ring=256,
                  width_operand=True,
                  hyparview=HyParViewConfig(isolation_window_ms=25_000),
                  plumtree=PlumtreeConfig(push_slots=2, lazy_cap=4))


ALL = {
    1: config1_anti_entropy,
    2: config2_rumor,
    3: config3_plumtree_drop,
    4: config4_scamp_churn,
    5: config5_causal_crash,
    6: config6_echo,
    7: config7_soak,
    8: config8_overload,
    9: config9_elastic,
}

DEFAULT_SIZES = {1: 16, 2: 1000, 3: 10_000, 4: 10_000, 5: 100_000, 6: 2,
                 7: 10_000, 8: 96, 9: 8192}

# Left out of run_all's default sweep (run them with --only, --soak,
# --slo or --elastic): the soak is hours of simulated time by design; the
# overload scenario is the backpressure A/B harness; the elastic scenario
# scales half, full, quarter under a flash crowd through the soak engine.
OPT_IN = frozenset({7, 8, 9})


def run_all(scale: float = 1.0, only=None, device=None) -> list[dict]:
    """Configs 1-6 (or ``only``, which may name configs 7, 8 and 9) at
    ``DEFAULT_SIZES * scale``; config 6 runs ``max(50, int(1000 *
    scale))`` round trips per sender, config 7 ``max(400, int(2000 *
    scale))`` rounds."""
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
        if i == 7:
            out.append(fn(n=max(64, int(DEFAULT_SIZES[7] * scale)),
                          rounds=max(400, int(2000 * scale)),
                          device=device))
            continue
        out.append(fn(n=max(8, int(DEFAULT_SIZES[i] * scale)),
                      device=device))
    return out


def main(argv=None) -> int:
    import argparse
    import json

    global METRICS, LATENCY, HEALTH, PROVENANCE, OPS, OPS_OUT
    ap = argparse.ArgumentParser(
        prog="python -m partisan_tpu_torch.scenarios",
        description="the scenario suite's configs 1-6 (and 7, 8), one "
                    "JSON line each")
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
    ap.add_argument("--soak", action="store_true",
                    help="run the long-horizon soak (config 7) only")
    ap.add_argument("--soak-rounds", type=int, default=2000,
                    help="soak horizon in rounds (with --soak)")
    ap.add_argument("--superstep", type=int, default=1, metavar="R",
                    help="with --soak: Config.superstep (a loop fold; the "
                         "chunk cap lifts when the census admits it)")
    ap.add_argument("--pipeline", type=int, default=1, metavar="D",
                    help="with --soak: keep up to D chunks submitted "
                         "between checkpoint and storm boundaries "
                         "(SoakConfig.pipeline_depth)")
    ap.add_argument("--elastic", action="store_true",
                    help="run the elasticity scenario (config 9) only and "
                         "exit non-zero if a gate breaches")
    ap.add_argument("--ingress-trace", default=None, metavar="PATH",
                    help="with --elastic: replay a recorded request trace "
                         "(ingress.Journal JSON lines) through the ingress "
                         "lane beside the in-round traffic")
    ap.add_argument("--ckpt-dir", default=None,
                    help="with --soak or --elastic: persist checkpoints "
                         "here")
    ap.add_argument("--slo", type=int, nargs="?", const=4, default=None,
                    metavar="ROUNDS",
                    help="config 8's static and adaptive arms and the "
                         "adaptive per-channel p99 gate at ROUNDS, then "
                         "the traffic SLO suite at that bound")
    ap.add_argument("--slo-out", default=None, metavar="PATH",
                    help="with --slo: also write the traffic_slo object "
                         "to PATH")
    ap.add_argument("--ops", action="store_true",
                    help="fuse each soak-engine run (configs 7 and 9, the "
                         "traffic suite) into the ops journal, print its "
                         "incident spans, error budgets and gate verdict "
                         "to stderr as JSON lines, and fold the span gate "
                         "into the scenario's verdict and exit status")
    ap.add_argument("--ops-out", default=None, metavar="PATH",
                    help="with --ops: also write the journal (JSON lines; "
                         "the config label suffixed before the extension) "
                         "for tools/incident_report.py --gate")
    ap.add_argument("--perf", action="store_true",
                    help="capture the run under torch.profiler with the "
                         "round.* labels live and print the per-phase "
                         "device time (perfwatch.attribute; the census's "
                         "phase keys) to stderr as perf_phase JSON lines; "
                         "stdout is unchanged")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if not args.perf:
        return _run_cli(args)
    import shutil
    import sys
    import tempfile

    from partisan_tpu_torch import perfwatch

    perf_dir = tempfile.mkdtemp(prefix="ptt_perf_")
    try:
        with perfwatch.capture(perf_dir):
            return _run_cli(args)
    finally:
        # also on the branches' SystemExit: the capture closed first
        for name, slot in sorted(perfwatch.attribute(perf_dir).items()):
            print(json.dumps({"kind": "perf_phase", "phase": name, **slot}),
                  file=sys.stderr, flush=True)
        shutil.rmtree(perf_dir, ignore_errors=True)


def _run_cli(args) -> int:
    import json

    global METRICS, LATENCY, HEALTH, PROVENANCE, OPS, OPS_OUT
    METRICS = METRICS or args.metrics
    LATENCY = LATENCY or args.latency
    HEALTH = HEALTH or args.health
    PROVENANCE = PROVENANCE or args.provenance
    OPS = OPS or args.ops
    OPS_OUT = OPS_OUT or args.ops_out
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
        # the traffic suite: one verdict line per scenario, then the
        # suite object
        suite = traffic_slo(scale=args.scale, bound=args.slo,
                            device=args.device)
        for name, entry in suite["scenarios"].items():
            line = {"kind": "traffic_slo_scenario", "model": name,
                    "ok": entry["ok"],
                    "isolation": entry.get("isolation", False)}
            if "win" in entry:
                line["win"] = entry["win"]
                line["bulk_p99_static"] = entry["static"]["bulk_p99"]
                line["bulk_p99_adaptive"] = entry["adaptive"]["bulk_p99"]
            print(json.dumps(line), flush=True)
        print(json.dumps({"kind": "traffic_slo", **suite}), flush=True)
        if args.slo_out:
            with open(args.slo_out, "w") as f:
                json.dump(suite, f, indent=1)
        return 0 if (ok and suite["pass"]) else 1
    if args.elastic:
        out9 = config9_elastic(
            n=max(64, int(DEFAULT_SIZES[9] * args.scale)),
            ingress_trace=args.ingress_trace, ckpt_dir=args.ckpt_dir,
            device=args.device)
        print(json.dumps(out9), flush=True)
        return 0 if out9["pass"] else 1
    if args.soak:
        out7 = config7_soak(
            n=max(64, int(DEFAULT_SIZES[7] * args.scale)),
            rounds=args.soak_rounds, ckpt_dir=args.ckpt_dir,
            superstep=args.superstep, pipeline=args.pipeline,
            device=args.device)
        print(json.dumps(out7), flush=True)
        return 0 if out7.get("ops", {}).get("ok", True) else 1
    for r in run_all(scale=args.scale, only=args.only, device=args.device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
