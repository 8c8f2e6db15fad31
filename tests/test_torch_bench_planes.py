"""bench.py's main path with the metrics, latency and provenance planes on,
in the port against the JAX reference on the CPU: ``bench.run(n,
metrics=True, latency=True, provenance=True)`` beside the port's
``scenarios.bench_broadcast`` with the same flags, at n=256 with the
width ladder [n/2, n] (the width operand, ``emit_compact=32``,
``inbox_cap=16``, bench's origin mark).  Both sides are stepped one round
at a time through their own ``Cluster.steps``; every state leaf is
compared at the start of each ``steps`` call (after the joins, the
prefix activations, the origin mark and the broadcast) and after every
round.  A second setup broadcasts while only the first half of the
rows is active, then widens mid-broadcast, so the planes' active-prefix
masks (the alive counts, the provenance cover count) see both widths.
Then bench.py's stderr lines (the metrics rows and totals, the
latency percentiles, the provenance headline) are compared with the
port's ``bench_planes_report`` and ``metrics.rows`` on the final state.
Tolerance 0 throughout."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import bench
from partisan_tpu import cluster as jcluster
from partisan_tpu import provenance as jprov
from partisan_tpu import scenarios as jsc
from partisan_tpu.config import Config as JConfig
from partisan_tpu.config import HyParViewConfig as JHyParView
from partisan_tpu.config import PlumtreeConfig as JPlumtreeCfg
from partisan_tpu.models.plumtree import Plumtree as JPlumtree
from partisan_tpu_torch import cluster as tcluster
from partisan_tpu_torch import metrics as tmetrics
from partisan_tpu_torch import provenance as tprov
from partisan_tpu_torch import scenarios as tsc
from partisan_tpu_torch import state_io
from partisan_tpu_torch.config import PlumtreeConfig as TPlumtreeCfg
from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree
from test_torch_cluster import assert_same, bench_kwargs
from test_torch_metrics import lockstep

torch.set_num_threads(1)

N = 256
WIDTHS = [N // 2, N]
PLANES = dict(metrics=True, latency=True, provenance=True)


def _jleaves(st):
    return [np.asarray(a) for a in
            jax.tree_util.tree_leaves(jax.device_get(st))]


def _tleaves(st):
    return state_io.flatten(state_io.state_to_numpy(st))


def _one_round_steps(monkeypatch, cls, leaves, log):
    """Make ``cls.steps(st, k)`` run k one-round calls, logging the
    state it is handed and the state after each round."""
    orig = cls.steps

    def steps(self, st, k):
        log.append(("call", leaves(st)))
        for _ in range(k):
            st = orig(self, st, 1)
            log.append(("round", leaves(st)))
        return st

    monkeypatch.setattr(cls, "steps", steps)


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    jlog, tlog = [], []
    try:
        ladder = jsc._boot_ladder
        mp.setattr(jsc, "_boot_ladder",
                   lambda mk, n, **kw: ladder(mk, n, widths=WIDTHS, **kw))
        _one_round_steps(mp, jcluster.Cluster, _jleaves, jlog)
        _one_round_steps(mp, tcluster.Cluster, _tleaves, tlog)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            jres = bench.run(N, **PLANES)
        trun = tsc.bench_broadcast(N, device="cpu", widths=WIDTHS, **PLANES)
    finally:
        mp.undo()
    lines = [json.loads(x) for x in err.getvalue().splitlines()
             if x.startswith("{")]
    return jres, lines, jlog, trun, tlog


def test_config_is_bench_make_cfg(runs):
    jres, _, _, trun, _ = runs
    cfg = trun["cluster"].cfg
    assert cfg.width_operand and cfg.emit_compact == 32
    assert cfg.inbox_cap == 16
    assert (cfg.metrics, cfg.latency, cfg.provenance) == (True, True, True)


def test_every_leaf_after_every_round(runs):
    _, _, jlog, _, tlog = runs
    # a ladder of four waves and a settle, then the convergence batches
    assert len(jlog) == len(tlog) > 5 * (jsc.K_PROG + 1)
    for i, ((jtag, jl), (ttag, tl)) in enumerate(zip(jlog, tlog)):
        assert jtag == ttag, (i, jtag, ttag)
        assert len(jl) == len(tl), (i, len(jl), len(tl))
        for ja, (path, ta) in zip(jl, tl):
            label = f"entry {i} ({jtag}) {path}"
            assert ja.dtype == ta.dtype, (label, ja.dtype, ta.dtype)
            assert ja.shape == ta.shape, (label, ja.shape, ta.shape)
            np.testing.assert_array_equal(ja, ta, err_msg=label)


def test_origin_mark_and_broadcast_step(runs):
    """The first ``steps`` call after the boot gets the marked state:
    the port's boot state plus bench's origin mark and broadcast."""
    _, _, jlog, trun, tlog = runs
    start = trun["start_round"]
    marks = [i for i, (tag, leaves) in enumerate(tlog) if tag == "call"
             and int(dict(leaves)["rnd"]) == start]
    assert len(marks) == 1
    boot = dict(_tleaves(trun["boot_state"]))
    marked = dict(tlog[marks[0]][1])
    changed = sorted(p for p in boot if not np.array_equal(boot[p],
                                                           marked[p]))
    assert any(p.startswith("provenance.") for p in changed), changed
    assert any(p.startswith("model.") for p in changed), changed
    assert all(p.split(".")[0] in ("provenance", "model") for p in changed)


def test_result_and_report_lines_match_bench(runs):
    jres, lines, _, trun, _ = runs
    st, cfg = trun["state"], trun["cluster"].cfg
    assert trun["converged_round"] == jres["converged_round"]
    assert int(st.stats.emitted) == jres["emitted"]
    assert int(st.stats.dropped) == jres["dropped"]
    mine = tsc.bench_planes_report(cfg, st)
    names = tuple(c.name for c in cfg.channels)
    rows = [{"kind": "metrics", "n": N, **r} for r in tmetrics.rows(
        tmetrics.snapshot(st.metrics), channels=names)]
    theirs = [x for x in lines if x["kind"] in
              ("metrics", "metrics_totals", "latency", "provenance")]
    assert json.loads(json.dumps(rows + mine)) == theirs
    # the books close: every drop has its cause
    tot = mine[0]
    assert tot["emitted"] - tot["delivered"] == tot["dropped"]


@pytest.mark.parametrize("aae", [True, False])
def test_broadcast_under_a_narrow_prefix(aae):
    """The bench config with the planes on at n=128, booted on the first
    64 rows only; a broadcast from node 0 runs 16 rounds at that width,
    then the other half is activated and joined, and 12 more rounds
    run.  Every leaf after every round.  With Plumtree's anti-entropy
    exchange off the eager and lazy wire carry the whole broadcast, so
    the provenance forest covers the narrow prefix and its cover round
    is set there."""
    n, half = 128, 64
    kw = bench_kwargs(JHyParView, JPlumtreeCfg, n=n)
    kw["plumtree"] = JPlumtreeCfg(push_slots=2, lazy_cap=4, aae=aae)
    jcl = jcluster.Cluster(JConfig(**{**kw, **PLANES}), model=JPlumtree())
    tcl = tcluster.Cluster(tsc.bench_config(n).replace(
        plumtree=TPlumtreeCfg(push_slots=2, lazy_cap=4, aae=aae), **PLANES),
        model=TPlumtree(), device="cpu")
    _, js = jsc._boot_ladder(lambda w: jcl, n, widths=[half])
    _, ts = tsc._boot_ladder(lambda w: tcl, n, widths=[half])
    assert_same(js, ts, "half-width boot")
    assert int(ts.n_active) == half
    r0 = int(ts.rnd)
    js = js._replace(
        provenance=jprov.mark_origin(js.provenance, 0, 0, rnd=r0),
        model=jcl.model.broadcast(js.model, 0, 0, r0))
    ts = ts._replace(
        provenance=tprov.mark_origin(ts.provenance, 0, 0, rnd=r0),
        model=tcl.model.broadcast(ts.model, 0, 0, r0))
    assert_same(js, ts, "marked")
    js, ts = lockstep(jcl, tcl, js, ts, 16, "half width")
    cover = int(ts.provenance.cover_rnd[0])
    assert (cover >= r0) == (not aae), cover
    js = jcluster.activate(js, n)
    ts = tcluster.activate(ts, n)
    nodes = np.arange(half, n, dtype=np.int32)
    tgts = np.random.default_rng(3).integers(
        0, half, size=nodes.size).astype(np.int32)
    js = js._replace(manager=jcl.manager.join_many(
        jcl.cfg, js.manager, nodes, tgts))
    ts = ts._replace(manager=tcl.manager.join_many(
        tcl.cfg, ts.manager, nodes, tgts))
    assert_same(js, ts, "widened")
    lockstep(jcl, tcl, js, ts, 12, "full width")
