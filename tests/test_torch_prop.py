"""The property harness in the port against the JAX reference on the CPU:
the runs of tests/test_prop.py (Noop, ReliableBroadcast acked under the
omission budget, PrimaryBackup, Linearizability, the single-success
scheduler, AtomicCommit CTP at seed 3) give the same ``RunResult`` —
verdict, seed, command scripts, shrunk script, ``render()`` — with the
cached boot state unchanged by the run; the hand-written scripts (the
unacked broadcast canary and its shrink, a crashed client, 2PC's
blocking omission against CTP's repair) give the same verdicts and
shrinks; the crash fault model draws the same commands."""

import random

import pytest
import torch

from partisan_tpu import faults as jf
from partisan_tpu import prop as jprop
from partisan_tpu import prop_models as jpm
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch import prop as tprop
from partisan_tpu_torch import prop_models as tpm
from test_torch_paxos import harness_pair, run_result_fields

torch.set_num_threads(1)

RUNS = {
    "noop": (lambda pm, pr: (pm.NoopSystem(seed=2), None),
             dict(n_runs=2, n_commands=3)),
    "reliable_broadcast_acked": (
        lambda pm, pr: (pm.ReliableBroadcastSystem(seed=7, acked=True),
                        pr.CrashFaultModel(tolerance=2, allow_crash=False)),
        dict(scheduler="finite_fault", n_runs=3, n_commands=6, seed=101)),
    "primary_backup": (
        lambda pm, pr: (pm.PrimaryBackupSystem(seed=5, acked=True), None),
        dict(scheduler="default", n_runs=2, n_commands=5, seed=40)),
    "linearizability": (
        lambda pm, pr: (pm.LinearizabilitySystem(seed=8), None),
        dict(scheduler="default", n_runs=2, n_commands=4, seed=77)),
    "single_success": (lambda pm, pr: (pm.NoopSystem(seed=3), None),
                       dict(scheduler="single_success", n_runs=10,
                            n_commands=2)),
    "atomic_commit_ctp": (
        lambda pm, pr: (pm.AtomicCommitSystem(variant="bernstein_ctp",
                                              seed=3),
                        pr.CrashFaultModel(tolerance=1, allow_crash=False)),
        dict(scheduler="finite_fault", n_runs=4, n_commands=5, seed=900)),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_harness_run_identical(name):
    make, kw = RUNS[name]
    res = harness_pair(make, **kw)
    assert res.ok, res.render()
    assert "PASSED" in res.render()


def omit(s, d, faults):
    return lambda c, st: st._replace(
        faults=faults.inject_partition(st.faults, [s], [d]))


def scripts(side):
    """The hand-written scripts of tests/test_prop.py for one package:
    ``(harness, script, expect_ok)`` triples, shrinking the failures."""
    pm, pr, faults = side
    out = []
    for acked, ok in ((False, False), (True, True)):
        sys = pm.ReliableBroadcastSystem(seed=7, acked=acked)
        bc = pr.Command(name="broadcast", args=(2, 0),
                        apply=lambda c, s, sys=sys: s._replace(
                            model=sys.model.broadcast(s.model, 2, 0)))
        out.append((sys, [pr.Command(name="omit_edge", args=(2, 4),
                                     kind="fault",
                                     apply=omit(2, 4, faults)), bc], ok))
    sys = pm.PrimaryBackupSystem(seed=6, acked=True)
    out.append((sys, [
        pr.Command(name="write", args=(2, 0, 111),
                   apply=lambda c, s, sys=sys: s._replace(
                       model=sys.model.write(s.model, 2, 0, 111))),
        pr.Command(name="crash", args=(2,), kind="fault",
                   apply=lambda c, s: s._replace(
                       faults=faults.crash(s.faults, 2)))], True))
    for variant, ok in (("lampson_2pc", False), ("bernstein_ctp", True)):
        sys = pm.AtomicCommitSystem(variant=variant)
        out.append((sys, [sys.begin_command(0, 0, 77),
                          pr.Command(name="omit_edge", args=(0, 4),
                                     kind="fault",
                                     apply=omit(0, 4, faults))], ok))
    return out


def test_scripts_and_shrinks_identical():
    sides = []
    for side in ((jpm, jprop, jf), (tpm, tprop, tf)):
        got = []
        for sys, script, expect in scripts(side):
            if side[0] is tpm:
                sys.device = "cpu"
            h = side[1].Harness(system=sys, n_runs=1)
            ok = h._execute(script)
            assert ok == expect, (sys.name, script)
            shrunk = None if ok else [repr(c) for c in h._shrink(script)]
            got.append((ok, shrunk))
        sides.append(got)
    assert sides[0] == sides[1]
    assert [s for _, s in sides[1] if s is not None] == [
        ["omit_edge(2, 4)", "broadcast(2, 0)"],
        ["begin(0, 0, 77)", "omit_edge(0, 4)"]]


def test_crash_fault_model_draws_identical():
    out = []
    for pm, pr in ((jpm, jprop), (tpm, tprop)):
        sys = pm.NoopSystem(n_nodes=4, seed=2)
        if pm is tpm:
            sys.device = "cpu"
        cl, st = sys.build()
        with pytest.raises(ValueError):
            pr.CrashFaultModel(tolerance=1, allow_omission=False,
                               protect=frozenset(range(4))).gen_fault(
                random.Random(0), cl, st)
        rng = random.Random(0)
        fm = pr.CrashFaultModel(protect=frozenset({0}))
        out.append([repr(fm.gen_fault(rng, cl, st)) for _ in range(12)])
    assert out[0] == out[1]
    assert any(c.startswith("crash") for c in out[1]) \
        and any(c.startswith("omit_edge") for c in out[1])


def test_run_result_render_failed_form():
    cmd = tprop.Command(name="propose", args=(1, 0, 101),
                        apply=lambda c, s: s)
    jcmd = jprop.Command(name="propose", args=(1, 0, 101),
                         apply=lambda c, s: s)
    for shrunk in (None, [1]):
        t = tprop.RunResult(ok=False, seed=4, commands=[cmd, cmd],
                            shrunk=None if shrunk is None else [cmd])
        j = jprop.RunResult(ok=False, seed=4, commands=[jcmd, jcmd],
                            shrunk=None if shrunk is None else [jcmd])
        assert run_result_fields(t) == run_result_fields(j)
