"""Main-path runners (port of the bench path of ``partisan_tpu/scenarios.py``):
the width-operand bootstrap ladder, the coverage-poll convergence loop
and the steady-state throughput instrument.  Every stepping phase runs
``K_PROG`` rounds between host checks, as the reference does.

:func:`bench_config` and :func:`bench_broadcast` are bench.py's main
path (its configuration with every plane off, the ladder, one broadcast
stepped to coverage), shared by chip_smoke.py and the profiler so both
drive the same path.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from partisan_tpu_torch import cluster as cluster_mod
from partisan_tpu_torch.config import (Config, HyParViewConfig,
                                       PlumtreeConfig)
from partisan_tpu_torch.models.plumtree import Plumtree

K_PROG = 10


def _sync(st) -> None:
    """Execution barrier: wait for the card to finish the state."""
    if st.rnd.device.type == "cuda":
        torch.cuda.synchronize(st.rnd.device)
    int(st.rnd)


def _boot_fullmesh(cl, n):
    """Every node joins the full mesh via node 0, then two ``K_PROG``
    executions let membership gossip settle."""
    st = cl.init()
    m = st.manager
    for i in range(1, n):
        m = cl.manager.join(cl.cfg, m, i, 0)
    st = cl.steps(st._replace(manager=m), K_PROG)
    return cl.steps(st, K_PROG)


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


def _converge(cl, st, coverage_fn, max_rounds):
    """Step until ``coverage_fn(state) == 1.0``, checked every K_PROG
    rounds.  Returns (state, converged_round | -1)."""
    for _ in range(0, max_rounds, K_PROG):
        if float(coverage_fn(st)) == 1.0:
            return st, int(st.rnd)
        st = cl.steps(st, K_PROG)
    return (st, int(st.rnd)) if float(coverage_fn(st)) == 1.0 else (st, -1)


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
