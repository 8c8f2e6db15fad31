"""Filibuster, trace and analysis in the port against the JAX reference on
the CPU: the three tests/test_filibuster.py checker setups (N=6 full
mesh, direct mail unacked and acked, max_faults 1 and 2) give the same
``Result`` — verdict, execution / prune / candidate counts, the shrunk
counterexample, its rendering, the golden trace — and the host-side
modules agree on the same traces: ``schedule_drops``,
``iter_schedules``, ``analysis``, ``Trace`` events / render / save /
load across the two packages (tolerance 0 throughout)."""

import numpy as np
import pytest
import torch

from partisan_tpu import analysis as ja
from partisan_tpu import filibuster as jfil
from partisan_tpu import interpose as ji
from partisan_tpu import trace as jtrace
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.models.direct_mail import DirectMail as JDirectMail
from partisan_tpu_torch import analysis as ta
from partisan_tpu_torch import filibuster as tfil
from partisan_tpu_torch import interpose as ti
from partisan_tpu_torch import trace as ttrace
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.models.direct_mail import DirectMail as TDirectMail

torch.set_num_threads(1)

N = 6
HORIZON = 12


def _boot(cl, model):
    """tests/support.boot_fullmesh, then a broadcast from node 0."""
    st = cl.init()
    m = st.manager
    for i in range(1, N):
        m = cl.manager.join(cl.cfg, m, i, 0)
    st = cl.steps(st._replace(manager=m), 15)
    return st._replace(model=model.broadcast(st.model, 0, 0))


@pytest.fixture(scope="module")
def builds():
    """One booted (cluster, state) per side and direct-mail variant,
    built on the first ``build`` call and reused by every checker (the
    schedule is swapped into the state, so one cluster serves all)."""
    cache = {}

    def build_fn(side, acked):
        def build(interp):
            key = (side, acked)
            if key not in cache:
                kw = dict(n_nodes=N, seed=17, inbox_cap=max(32, N + 8),
                          ack_cap=8 if acked else 0)
                if side == "jax":
                    model = JDirectMail(acked=acked)
                    cl = JCluster(JConfig(**kw), model=model,
                                  interpose=interp)
                else:
                    model = TDirectMail(acked=acked)
                    cl = TCluster(TConfig(**kw), model=model,
                                  interpose=interp, device="cpu")
                cache[key] = (cl, _boot(cl, model))
            return cache[key]
        return build

    return build_fn


def _covered(cl, st):
    return float(cl.model.coverage(st.model, st.faults.alive, 0)) == 1.0


SETUPS = {"unacked_finds_counterexample": (False, 1, 200),
          "acked_certified": (True, 1, 200),
          "budget_two_bounded": (False, 2, 30)}


@pytest.fixture(scope="module")
def results(builds):
    out = {}
    for name, (acked, max_faults, max_exec) in SETUPS.items():
        out[name] = tuple(
            fil.Checker(build=builds(side, acked), horizon=HORIZON,
                        assertion=_covered, candidate=fil.app_messages,
                        max_faults=max_faults,
                        max_executions=max_exec).run()
            for side, fil in (("jax", jfil), ("torch", tfil)))
    return out


@pytest.mark.parametrize("name", list(SETUPS))
def test_checker_results_identical(results, name):
    jr, tr = results[name]
    for field in ("passed", "executions", "pruned", "candidates"):
        assert getattr(jr, field) == getattr(tr, field), field
    assert jr.render() == tr.render()
    if jr.counterexample is None:
        assert tr.counterexample is None
    else:
        assert jr.counterexample.schedule == tr.counterexample.schedule
        assert jr.counterexample.passed == tr.counterexample.passed
        np.testing.assert_array_equal(jr.counterexample.trace.sent,
                                      tr.counterexample.trace.sent)
    for a, b in ((jr.base_trace.sent, tr.base_trace.sent),
                 (jr.base_trace.dropped, tr.base_trace.dropped),
                 (jr.base_trace.rounds, tr.base_trace.rounds)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the reference test's own assertions, on the port's result
    if name == "acked_certified":
        assert tr.passed and tr.executions >= N
    else:
        assert not tr.passed and len(tr.counterexample.schedule) == 1
        assert "APP" in tr.render()


def test_schedule_compilation_identical():
    one = [(3, 1, 0), (5, 2, 7), (0, 0, 1)]
    batch = [one, [(1, 1, 1)], []]
    for sched in (one, batch, []):
        np.testing.assert_array_equal(
            jfil.schedule_drops(sched, 6, 4, 8),
            tfil.schedule_drops(sched, 6, 4, 8))
    for bad in ([(6, 0, 0)], [(0, 0, 8)]):
        with pytest.raises(ValueError):
            tfil.schedule_drops(bad, 6, 4, 8)
    cands = [(0, 1, 0), (0, 2, 0), (1, 1, 1), (0, 1, 0)]
    assert list(jfil.iter_schedules(cands, 2)) == \
        list(tfil.iter_schedules(cands, 2))
    np.testing.assert_array_equal(
        jtrace.schedule_from_events(one, 4, 3, 8, start=2),
        ttrace.schedule_from_events(one, 4, 3, 8, start=2))


def test_analysis_identical_on_the_same_traces(results, tmp_path):
    """analysis on each side's own traces (the acked golden trace has
    ACK edges; the unacked counterexample trace has an omission)."""
    pairs = [(results["acked_certified"][0].base_trace,
              results["acked_certified"][1].base_trace),
             (results["unacked_finds_counterexample"][0]
              .counterexample.trace,
              results["unacked_finds_counterexample"][1]
              .counterexample.trace)]
    for jt, tt in pairs:
        g = ta.reaction_graph(tt)
        assert ja.reaction_graph(jt) == g
        assert ja.closure(ja.reaction_graph(jt)) == ta.closure(g)
        assert ja.background_kinds(jt) == ta.background_kinds(tt)
        assert ja.annotations(jt) == ta.annotations(tt)
        assert ja.prunable(g, "ACK", "APP") == ta.prunable(g, "ACK", "APP")
    assert "APP" in ta.reaction_graph(pairs[0][1]).get("ACK", set())
    assert ja.ensemble_reaction([p[0] for p in pairs]) == \
        ta.ensemble_reaction([p[1] for p in pairs])
    # annotation files written by one package load in the other
    ja.save_annotations(pairs[0][0], tmp_path / "j.json", protocol="dm")
    ta.save_annotations(pairs[0][1], tmp_path / "t.json", protocol="dm")
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "t.json").read_text()
    assert ta.load_annotations(tmp_path / "j.json") == \
        ja.load_annotations(tmp_path / "t.json")


def test_trace_roundtrips_across_packages(results, tmp_path):
    jt, tt = (r.base_trace for r in results["acked_certified"])
    assert list(jt.events()) != [] and [
        (e.rnd, e.src, e.dst, e.kind, e.channel, e.clock, e.slot,
         e.dropped, e.payload, e.kind_name) for e in jt.events()] == [
        (e.rnd, e.src, e.dst, e.kind, e.channel, e.clock, e.slot,
         e.dropped, e.payload, e.kind_name) for e in tt.events()]
    assert jt.render(limit=7) == tt.render(limit=7)
    np.testing.assert_array_equal(jt.delivered(), tt.delivered())
    jt.save(tmp_path / "jax.npz")
    tt.save(tmp_path / "torch.npz")
    for loaded, other in ((ttrace.Trace.load(tmp_path / "jax.npz"), jt),
                          (jtrace.Trace.load(tmp_path / "torch.npz"), tt)):
        assert loaded.matches(other)
        np.testing.assert_array_equal(loaded.sent, other.sent)
        np.testing.assert_array_equal(loaded.rounds, other.rounds)
        assert loaded.render() == other.render()
    tail = tt.tail(3)
    assert tail.n_rounds == 3 and tail.start == tt.start + HORIZON - 3
    np.testing.assert_array_equal(jt.tail(3).sent, tail.sent)
    np.testing.assert_array_equal(jt.omission_schedule(),
                                  tt.omission_schedule())


def test_replay_from_recorded_drops(builds):
    """Trace replay (tests/test_trace.py): the recorded APP sends of the
    unacked golden run, compiled into an OmissionSchedule, silence the
    broadcast on both sides alike."""
    zero = np.zeros((1, 1, 1), np.bool_)
    jcl, js = builds("jax", False)(ji.OmissionSchedule(zero))
    tcl, ts = builds("torch", False)(ti.OmissionSchedule(zero))
    js = js._replace(interpose=jcl.interpose.init(jcl.cfg, jcl.comm))
    ts = ts._replace(interpose=tcl.interpose.init(tcl.cfg, tcl.comm))
    tr = ttrace.from_capture(tcl.record(ts, 4)[1])
    assert tr.matches(jtrace.from_capture(jcl.record(js, 4)[1]))
    coords = [(e.rnd, e.src, e.slot) for e in tr.events()
              if e.kind_name == "APP"]
    assert coords
    sched = ttrace.schedule_from_events(coords, tr.start + tr.n_rounds, N,
                                        tr.emit_width)
    js = js._replace(interpose=ji.OmissionSchedule(sched).init(
        jcl.cfg, jcl.comm))
    ts = ts._replace(interpose=ti.OmissionSchedule(sched).init(
        tcl.cfg, tcl.comm))
    js, jrep = jcl.record(js, 4)
    ts, trep = tcl.record(ts, 4)
    np.testing.assert_array_equal(np.asarray(jrep.sent), trep.sent.numpy())
    assert int(ts.model.store[:, 0].sum()) == 1   # only the broadcaster
