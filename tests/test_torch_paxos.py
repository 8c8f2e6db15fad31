"""Paxos in the port against the JAX reference on the CPU: every state
leaf after every round for each setup of tests/test_paxos.py (a single
proposer, competing proposers, minority crashes, an omitted DECIDE
fan-out), a round whose inbox holds tied ballots, the traffic suite's
Paxos workload at n=48 cut to 80 rounds, the property harness's two
Paxos runs (every ``RunResult`` field and ``render()``, the cached boot
state unchanged), and the Filibuster search over the proposal exchange
(every ``Result`` field).  Tolerance 0 throughout.

The helpers here (``Side``, ``run_plan``, ``to_jax``, ``inject``,
``run_result_fields``, ``traffic_lockstep``) serve the other app-model
parity files too."""

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu import faults as jf
from partisan_tpu import filibuster as jfil
from partisan_tpu import interpose as ji
from partisan_tpu import prop as jprop
from partisan_tpu import prop_models as jpm
from partisan_tpu import scenarios as jsc
from partisan_tpu import types as JT
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.models import paxos as jpaxos
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch import filibuster as tfil
from partisan_tpu_torch import interpose as ti
from partisan_tpu_torch import prop as tprop
from partisan_tpu_torch import prop_models as tpm
from partisan_tpu_torch import scenarios as tsc
from partisan_tpu_torch import state_io
from partisan_tpu_torch import types as TT
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.models import paxos as tpaxos
from partisan_tpu_torch.ops.plane import Planes
from test_torch_cluster import assert_same

torch.set_num_threads(1)

N = 5


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Side:
    """One package's cluster, model and state, with the helpers a plan's
    actions need (``faults``, ``arr`` for host arrays, ``drop`` for the
    link-drop probability)."""

    cl: Any
    model: Any
    st: Any
    faults: Any
    arr: Any
    drop: Any


def jax_side(cl, model, st):
    return Side(cl, model, st, jf, lambda x: jnp.asarray(np.asarray(x)),
                lambda f, p: f._replace(link_drop=jnp.float32(p)))


def torch_side(cl, model, st):
    return Side(cl, model, st, tf, lambda x: torch.as_tensor(np.asarray(x)),
                tf.set_link_drop)


def boot(side, n):
    """Init, then every node joins via node 0 (the JAX tests'
    ``build``)."""
    st = side.cl.init()
    for i in range(1, n):
        st = st._replace(manager=side.cl.manager.join(side.cl.cfg,
                                                      st.manager, i, 0))
    side.st = st
    return side


def run_plan(j, t, plan, label):
    """Run ``plan`` on both sides in lockstep, comparing every leaf after
    every action and every round.  Items: an int (that many rounds), a
    callable ``fn(side, st) -> st`` applied to both, or ``(pred, cap)``:
    rounds until ``pred(side, st)`` holds on the port (at most ``cap``)."""
    assert_same(j.st, t.st, f"{label} start")
    for item in plan:
        if callable(item):
            j.st, t.st = item(j, j.st), item(t, t.st)
            assert_same(j.st, t.st, f"{label} after an action")
            continue
        if isinstance(item, tuple):
            pred, cap = item
            for _ in range(cap):
                if pred(t, t.st):
                    break
                j.st, t.st = j.cl.step(j.st), t.cl.step(t.st)
                assert_same(j.st, t.st, f"{label} round {int(t.st.rnd)}")
            assert pred(t, t.st), f"{label}: predicate not reached"
            continue
        for _ in range(item):
            j.st, t.st = j.cl.step(j.st), t.cl.step(t.st)
            assert_same(j.st, t.st, f"{label} round {int(t.st.rnd)}")


def to_jax(template, ts):
    """The port's state as a JAX state shaped like ``template``."""
    leaves = [jnp.asarray(x) for _, x in
              state_io.flatten(state_io.state_to_numpy(ts))]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves)


def inject(ts, node, records):
    """``ts`` with ``records`` ({word index: value} dicts) appended to
    ``node``'s inbox, after its delivered records."""
    data = [w.clone() for w in ts.inbox.data]
    count = ts.inbox.count.clone()
    for rec in records:
        c = int(count[node])
        for i, w in enumerate(data):
            w[node, c] = rec.get(i, 0)
        count[node] += 1
    return ts._replace(inbox=ts.inbox._replace(data=Planes(data),
                                               count=count))


def app_record(src, dst, *payload):
    return {JT.W_KIND: int(JT.MsgKind.APP), JT.W_SRC: src, JT.W_DST: dst,
            **{JT.P0 + i: v for i, v in enumerate(payload)}}


def run_result_fields(res) -> dict:
    return {"ok": res.ok, "seed": res.seed,
            "commands": [repr(c) for c in res.commands],
            "shrunk": None if res.shrunk is None
            else [repr(c) for c in res.shrunk],
            "render": res.render()}


def harness_pair(make_sys, **kw):
    """The same harness run in both packages (``make_sys(prop_models,
    prop)`` builds the system and fault model); returns both RunResults
    and checks the port's cached boot state is untouched by the run."""
    out = []
    for pm, pr in ((jpm, jprop), (tpm, tprop)):
        system, fm = make_sys(pm, pr)
        if pm is tpm:
            system.device = "cpu"
            before = state_io.state_to_numpy(system.build()[1])
        out.append(pr.Harness(system=system, fault_model=fm, **kw).run())
    after = state_io.state_to_numpy(system._st0)
    for (p, a), (_, b) in zip(state_io.flatten(before),
                              state_io.flatten(after)):
        np.testing.assert_array_equal(a, b, err_msg=f"_st0 {p} changed")
    assert run_result_fields(out[0]) == run_result_fields(out[1])
    return out[1]


def traffic_lockstep(name, rounds=80, n=48, seed=29):
    """The traffic suite's workload of one app model at ``n`` with no
    traffic plane, both packages in lockstep for ``rounds`` rounds after
    the full-mesh boot; returns the port's final state and check."""
    jmodel, jextras, jboot, jdrive, _ = jsc._traffic_build(name, n)
    tmodel, textras, tboot, tdrive, tcheck = tsc._traffic_build(name, n)
    assert jextras == textras
    jcl = JCluster(JConfig(n_nodes=n, seed=seed, **jextras), model=jmodel)
    tcl = TCluster(TConfig(n_nodes=n, seed=seed, **textras), model=tmodel,
                   device="cpu")
    js, ts = jboot(jcl), tboot(tcl)
    assert_same(js, ts, f"{name} n={n} boot")
    start = int(ts.rnd)
    js, jev = jdrive(js, start, rounds)
    ts, tev = tdrive(ts, start, rounds)
    assert [o for o, _ in jev] == [o for o, _ in tev]
    for r in range(rounds):
        for (off, ja), (_, ta) in zip(jev, tev):
            if off == r:
                js = ja.apply(jcl, js, start + r)
                ts = ta(tcl, ts, start + r)
        js, ts = jcl.step(js), tcl.step(ts)
        assert_same(js, ts, f"{name} n={n} round {start + r}")
    # the port's own app_model run reaches the same state
    run = tsc.app_model(name, n=n, rounds=rounds, seed=seed, device="cpu")
    for (p, a), (_, b) in zip(state_io.flatten(state_io.state_to_numpy(ts)),
                              state_io.flatten(state_io.state_to_numpy(
                                  run["state"]))):
        np.testing.assert_array_equal(a, b, err_msg=f"app_model {p}")
    return ts, tcheck(ts)


# ---------------------------------------------------------------------------
# Paxos
# ---------------------------------------------------------------------------

def pair(slots=2, quorum=None, jip=None, tip=None, settle=5, **kw):
    """tests/test_paxos.py's ``build`` in both packages, settled in
    lockstep."""
    cfg = dict(n_nodes=N, seed=7, msg_words=13, inbox_cap=64, **kw)
    jm, tm = jpaxos.Paxos(slots=slots, quorum=quorum), \
        tpaxos.Paxos(slots=slots, quorum=quorum)
    j = boot(jax_side(JCluster(JConfig(**cfg), model=jm, interpose=jip),
                      jm, None), N)
    t = boot(torch_side(TCluster(TConfig(**cfg), model=tm, interpose=tip,
                                 device="cpu"), tm, None), N)
    run_plan(j, t, [settle], "boot")
    return j, t


def propose(node, slot, value):
    def act(side, st):
        return st._replace(model=side.model.propose(
            st.model, node, slot, value, int(st.rnd), N))
    return act


def crash(node):
    return lambda side, st: st._replace(faults=side.faults.crash(st.faults,
                                                                 node))


def _drop_decides_j(cfg, ctx, em):
    return (em[..., JT.W_KIND] == JT.MsgKind.APP) \
        & (em[..., JT.P0] == jpaxos.OP_DECIDE)


def _drop_decides_t(cfg, ctx, em):
    return (em[TT.W_KIND] == TT.MsgKind.APP) \
        & (em[TT.P0] == tpaxos.OP_DECIDE)


SETUPS = {
    "single_proposer": (dict(), [propose(2, 0, 111), 12]),
    "competing_proposers": (dict(), [propose(1, 0, 100),
                                     propose(3, 0, 300), 60]),
    "minority_crashes": (dict(), [propose(0, 0, 42), 12, crash(3), crash(4),
                                  propose(1, 0, 999), 40]),
    "omitted_decide": (dict(slots=1, jip=ji.Drop(_drop_decides_j),
                            tip=ti.Drop(_drop_decides_t)),
                       [propose(2, 0, 77), 20]),
}


@pytest.mark.parametrize("name", list(SETUPS))
def test_setup_bit_identical_every_round(name):
    kw, plan = SETUPS[name]
    j, t = pair(**kw)
    run_plan(j, t, plan, name)
    m = t.st.model
    # the reference test's own assertions, on the port's state
    assert tpaxos.Paxos.agreement(m)
    d = sorted({int(v) for v in m.decided[:, 0] if v >= 0})
    want = {"single_proposer": ([111], list(range(N))),
            "competing_proposers": (None, list(range(N))),
            "minority_crashes": ([42], None),
            "omitted_decide": ([77], [2])}[name]
    if want[0] is not None:
        assert d == want[0]
    else:
        assert len(d) == 1 and d[0] in (100, 300)
    if want[1] is not None:
        assert t.model.decided_nodes(m, 0) == want[1]


def test_tied_ballots_pick_the_first_inbox_slot():
    """Equal ballots in one inbox: the acceptor accepts the first ACCEPT,
    the proposer adopts the first promise's value and the acceptor
    promises the first PREPARE's sender, in both packages."""
    j, t = pair()
    run_plan(j, t, [propose(2, 0, 500)], "propose")
    ballot = int(t.st.model.p_ballot[2, 0])
    ts = inject(t.st, 1, [app_record(3, 1, tpaxos.OP_ACCEPT, 0, 7, 55, 0),
                          app_record(2, 1, tpaxos.OP_ACCEPT, 0, 7, 66, 0)])
    ts = inject(ts, 2, [
        app_record(4, 2, tpaxos.OP_PROMISE, 0, ballot, 77, 9),
        app_record(0, 2, tpaxos.OP_PROMISE, 0, ballot, 88, 9)])
    ts = inject(ts, 4, [app_record(1, 4, tpaxos.OP_PREPARE, 1, 12, 0, 0),
                        app_record(3, 4, tpaxos.OP_PREPARE, 1, 12, 0, 0)])
    t.st, j.st = ts, to_jax(j.st, ts)
    run_plan(j, t, [1], "tied ballots")
    m = t.st.model
    assert int(m.a_value[1, 0]) == 55 and int(m.a_ballot[1, 0]) == 7
    assert int(m.p_hib[2, 0]) == 9 and int(m.p_hiv[2, 0]) == 77
    assert int(m.a_promised[4, 1]) == 12
    # the promise went to the first PREPARE's sender, node 1
    inbox = t.st.inbox

    def promises_from_4(node):
        d = inbox.data
        return bool(((d[TT.W_KIND][node] == TT.MsgKind.APP)
                     & (d[TT.W_SRC][node] == 4) & (d[TT.P1][node] == 1)
                     & (d[TT.P0][node] == tpaxos.OP_PROMISE)).any())

    assert promises_from_4(1) and not promises_from_4(3)


def test_traffic_workload_n48_bit_identical():
    ts, (ok, facts) = traffic_lockstep("paxos")
    assert ok and facts == {"decided_0": 48, "decided_1": 48}


def test_harness_at_fault_budget_identical():
    res = harness_pair(
        lambda pm, pr: (pm.PaxosSystem(n_nodes=5, slots=2, seed=3),
                        pr.CrashFaultModel(tolerance=1)),
        scheduler="finite_fault", n_runs=4, n_commands=5, seed=21)
    assert res.ok, res.render()


def test_harness_unsafe_adopt_canary_identical():
    res = harness_pair(
        lambda pm, pr: (pm.PaxosSystem(n_nodes=5, slots=1, seed=3,
                                       unsafe_adopt=True,
                                       check_termination=False), None),
        n_runs=8, n_commands=6, seed=5)
    assert not res.ok and res.shrunk is not None
    assert 2 <= len(res.shrunk) <= 3
    assert all(c.name == "propose" for c in res.shrunk)


def test_filibuster_over_paxos_identical():
    """tests/test_paxos.py's single-omission search (n=5, seed 11,
    horizon 40, max_faults 1, max_executions 60)."""
    results = []
    for side, fil, Cl, Cfg, P, T in (
            ("jax", jfil, JCluster, JConfig, jpaxos, JT),
            ("torch", tfil, TCluster, TConfig, tpaxos, TT)):
        model = P.Paxos(slots=1, retry_rounds=6)

        def build_fb(ip, model=model, Cl=Cl, Cfg=Cfg, side=side):
            cfg = Cfg(n_nodes=5, seed=11, msg_words=13, inbox_cap=64)
            kw = {"device": "cpu"} if side == "torch" else {}
            cl = Cl(cfg, model=model, interpose=ip, **kw)
            st = cl.init()
            for i in range(1, 5):
                st = st._replace(manager=cl.manager.join(cfg, st.manager,
                                                         i, 0))
            st = cl.steps(st, 5)
            return cl, st._replace(model=model.propose(
                st.model, 2, 0, 55, int(st.rnd), 5))

        def assertion(cl, st, model=model):
            return model.agreement(st.model) \
                and len(model.decided_nodes(st.model, 0)) == 5

        results.append(fil.Checker(
            build=build_fb, horizon=40, assertion=assertion,
            candidate=lambda e, T=T: e.kind == T.MsgKind.APP,
            max_faults=1, max_executions=60).run())
    jr, tr = results
    for field in ("passed", "executions", "pruned", "candidates"):
        assert getattr(jr, field) == getattr(tr, field), field
    assert jr.render() == tr.render() == \
        "filibuster: PASSED — 60 executions, 0 pruned, 95 candidates"
    for a, b in ((jr.base_trace.sent, tr.base_trace.sent),
                 (jr.base_trace.dropped, tr.base_trace.dropped)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tr.base_trace.sent.shape[-1] == 13
