"""The 2PC/3PC/CTP commit engine in the port against the JAX reference on
the CPU: every state leaf after every round for each setup of
tests/test_commit.py (n=6, every variant: fault-free, concurrent
transactions, a partitioned participant, two PREPAREs for one slot in
one round; 3PC's non-blocking timeout; CTP's cooperative termination and
its non-participants; 2PC under 30% link drop), the value-carrying
PREPARE scatter's explicit last-slot winner, and Lampson 2PC's traffic
workload at n=48 cut to 80 rounds.  Tolerance 0 throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.models import commit as jcp
from partisan_tpu_torch import types as TT
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.models import commit as tcp
from partisan_tpu_torch.ops import scatter
from test_torch_paxos import (boot, jax_side, run_plan, torch_side,
                              traffic_lockstep)

torch.set_num_threads(1)

N = 6
VARIANTS = tcp.CommitProtocol.VARIANTS


def pair(variant):
    """tests/test_commit.py's ``build`` in both packages."""
    cfg = dict(n_nodes=N, seed=11, inbox_cap=64, emit_cap=16)
    jm, tm = jcp.CommitProtocol(variant, slots=2), \
        tcp.CommitProtocol(variant, slots=2)
    j = boot(jax_side(JCluster(JConfig(**cfg), model=jm), jm, None), N)
    t = boot(torch_side(TCluster(TConfig(**cfg), model=tm, device="cpu"),
                        tm, None), N)
    return j, t


def begin(coord, slot, value, members=None):
    mask = np.ones(N, bool) if members is None else np.asarray(members)

    def act(side, st):
        return st._replace(model=side.model.begin(
            st.model, coord, slot, value, side.arr(mask), st.rnd))
    return act


def partition(a, b):
    return lambda side, st: st._replace(faults=side.faults.inject_partition(
        st.faults, side.arr(a), side.arr(b)))


def heal(side, st):
    return st._replace(faults=side.faults.resolve_partition(st.faults))


def crash(node):
    return lambda side, st: st._replace(faults=side.faults.crash(st.faults,
                                                                 node))


def link_drop(p):
    return lambda side, st: st._replace(faults=side.drop(st.faults, p))


def status_at_least(count, status, rows=slice(None)):
    return lambda side, st: int((st.model.p_status[rows, 0]
                                 >= status).sum()) >= count


def precommitted(side, st):
    return int((st.model.p_status[:, 0] == tcp.P_PRECOMMIT).sum()) >= N - 1


PER_VARIANT = {
    "fault_free": [begin(2, 0, 77), 12],
    "concurrent": [begin(0, 0, 5), begin(3, 1, 9), 14],
    "partitioned_participant": [partition([2], [5]), begin(2, 0, 4), 25],
    # two coordinators PREPARE slot 0 in the same round: every
    # participant sees two PREPAREs for one slot in one inbox
    "two_prepares_one_round": [begin(1, 0, 10), begin(4, 0, 20), 20],
}
SINGLE = {
    "3pc_participant_timeout": ("skeen_3pc", [
        begin(0, 0, 8), (precommitted, 20), crash(0), 15]),
    "ctp_cooperative_termination": ("bernstein_ctp", [
        begin(0, 0, 3), (status_at_least(N, tcp.P_PREPARED), 20),
        partition([0], [5]), 30]),
    "ctp_nonparticipants": ("bernstein_ctp", [
        begin(0, 0, 3, np.arange(N) < 3),
        (status_at_least(3, tcp.P_PREPARED, slice(0, 3)), 20),
        partition([1], [0, 2]), 30, heal, 30]),
    "2pc_random_omissions": ("lampson_2pc", [
        link_drop(0.3), begin(1, 0, 6), 30]),
}
CASES = [(v, name) for name in PER_VARIANT for v in VARIANTS] \
    + [(v, name) for name, (v, _) in SINGLE.items()]


@pytest.mark.parametrize("variant,name", CASES)
def test_setup_bit_identical_every_round(variant, name):
    plan = PER_VARIANT[name] if name in PER_VARIANT else SINGLE[name][1]
    j, t = pair(variant)
    run_plan(j, t, plan, f"{variant} {name}")
    m = t.st.model
    assert bool(tcp.CommitProtocol.agreement(m))
    if name == "fault_free":
        assert bool((m.p_status[:, 0] == tcp.P_COMMIT).all())
        assert bool((m.p_value[:, 0] == 77).all())
        assert int(m.c_outcome[2, 0]) == 1
    if name == "partitioned_participant" and variant == "lampson_2pc":
        assert int(m.c_outcome[2, 0]) == 2
        assert not bool((m.p_status[:, 0] == tcp.P_COMMIT).any())
    if name == "ctp_cooperative_termination":
        assert int(m.p_status[5, 0]) == tcp.P_COMMIT
    if name == "ctp_nonparticipants":
        assert int(m.p_status[1, 0]) == tcp.P_COMMIT


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_prepares_last_inbox_slot_wins(variant):
    """The PREPARE scatter carries values (coordinator, value): with two
    PREPAREs for one slot in one inbox, the last inbox slot's sender and
    value are recorded, as the reference's scatter applies updates in
    order on the CPU."""
    j, t = pair(variant)
    run_plan(j, t, [begin(1, 0, 10), begin(4, 0, 20), 1], "prepares out")
    d = t.st.inbox.data
    prep = (d[TT.W_KIND] == TT.MsgKind.APP) & (d[TT.P0] == tcp.OP_PREPARE) \
        & (d[TT.P1] == 0)
    want = {}
    for node in range(N):
        idx = prep[node].nonzero().flatten().tolist()
        assert len(idx) == 2, (node, idx)
        want[node] = (int(d[TT.W_SRC][node, idx[-1]]),
                      int(d[TT.P2][node, idx[-1]]))
    run_plan(j, t, [1], "prepares in")
    m = t.st.model
    for node, (src, val) in want.items():
        assert (int(m.p_coord[node, 0]), int(m.p_value[node, 0])) \
            == (src, val)


def test_last_writer_matches_the_reference_scatter():
    """``last_writer``/``take_last`` against ``.at[].set(mode="drop")``
    on random masks with many duplicate targets."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        n, cap, width = 7, 33, 3
        m = rng.random((n, cap)) < 0.5
        idx = rng.integers(0, width, (n, cap)).astype(np.int32)
        v = rng.integers(-50, 50, (n, cap)).astype(np.int32)
        dest = rng.integers(-9, 9, (n, width)).astype(np.int32)
        rows = np.broadcast_to(np.arange(n)[:, None], (n, cap))
        want = np.asarray(jnp.asarray(dest).at[
            rows, np.where(m, idx, width)].set(v, mode="drop"))
        win = scatter.last_writer(torch.as_tensor(idx), torch.as_tensor(m),
                              width)
        got = scatter.take_last(torch.as_tensor(dest), win, torch.as_tensor(v))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(trial))


def test_traffic_workload_n48_bit_identical():
    ts, (ok, facts) = traffic_lockstep("commit")
    assert ok and facts == {"agreement": True, "commits": 96}
