"""Alsberg-Day primary/backup replication in the port against the JAX
reference on the CPU: every state leaf after every round for each setup
of tests/test_alsberg.py (n=5, acked and unacked: a replicated write,
the primary writing, concurrent keys, 40% loss, an unreachable backup,
a same-round write collision, a same-client overwrite, a displaced
write), the collision's explicit last-slot winner, and the traffic
workload at n=48 cut to 80 rounds.  Tolerance 0 throughout."""

import pytest
import torch

from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.models.alsberg_day import AlsbergDay as JAlsbergDay
from partisan_tpu_torch import types as TT
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.models import alsberg_day as tad
from test_torch_commit import heal, link_drop, partition
from test_torch_paxos import (boot, jax_side, run_plan, torch_side,
                              traffic_lockstep)

torch.set_num_threads(1)

N = 5


def pair(acked):
    """tests/test_alsberg.py's ``build`` in both packages."""
    cfg = dict(n_nodes=N, seed=5, inbox_cap=64, emit_cap=16,
               ack_cap=32 if acked else 0)
    jm, tm = JAlsbergDay(acked=acked, keys=4), tad.AlsbergDay(acked=acked,
                                                              keys=4)
    j = boot(jax_side(JCluster(JConfig(**cfg), model=jm), jm, None), N)
    t = boot(torch_side(TCluster(TConfig(**cfg), model=tm, device="cpu"),
                        tm, None), N)
    return j, t


def write(client, key, value):
    return lambda side, st: st._replace(model=side.model.write(
        st.model, client, key, value))


def acked_ok(client, key):
    return lambda side, st: bool(st.model.req_ok[client, key])


SETUPS = {
    "write_replicates": [write(3, 1, 42), 8],
    "write_from_primary": [write(0, 0, 7), 8],
    "concurrent_keys": [write(1, 0, 10), write(2, 2, 20), write(4, 3, 30),
                        10],
    "lossy_links": [link_drop(0.4), write(2, 1, 9), (acked_ok(2, 1), 120),
                    link_drop(0.0), 10],
    "backup_unreachable": [partition([0], [4]), write(2, 1, 9), 20, heal,
                           15],
    "same_round_collision": [write(1, 2, 5), write(3, 2, 9), 12],
    "same_client_overwrite": [write(2, 1, 7), 1, write(2, 1, 8), 12],
    "ok_implies_all": [write(1, 2, 3), 10],
    "displaced_write": [write(1, 0, 11), 1, write(2, 0, 22), 10],
}
CASES = [(name, acked) for name in SETUPS for acked in (False, True)
         if name != "lossy_links" or acked]


@pytest.mark.parametrize("name,acked", CASES)
def test_setup_bit_identical_every_round(name, acked):
    j, t = pair(acked)
    run_plan(j, t, SETUPS[name], f"{name} acked={acked}")
    m = t.st.model
    alive = t.st.faults.alive
    # the reference test's own assertions, for the variant it runs
    if name == "write_replicates" or (acked and name in (
            "lossy_links", "backup_unreachable", "same_client_overwrite")):
        assert bool(m.req_ok[3 if name == "write_replicates" else 2, 1])
        assert bool(tad.AlsbergDay.replicated(m, 1, alive))
    if name == "same_round_collision" and acked:
        assert bool(m.req_ok[1, 2]) and bool(m.req_ok[3, 2])
        assert bool(tad.AlsbergDay.replicated(m, 2, alive))
    if name == "displaced_write" and not acked:
        assert bool(m.req_ok[1, 0]) and bool(m.req_ok[2, 0])
        assert bool((m.store[:, 0] == 22).all())


@pytest.mark.parametrize("acked", [False, True])
def test_collision_last_inbox_slot_wins(acked):
    """Two clients' writes to one key reach the primary in one round: the
    store takes the LAST inbox slot's value and its client becomes the
    outstanding one; the other client is acknowledged at once."""
    j, t = pair(acked)
    run_plan(j, t, [write(1, 2, 5), write(3, 2, 9), 1], "writes out")
    d = t.st.inbox.data
    w = (d[TT.W_KIND][0] == TT.MsgKind.APP) \
        & (d[TT.P0][0] == tad.OP_WRITE) & (d[TT.P1][0] == 2)
    idx = w.nonzero().flatten().tolist()
    # (the acked variant's ack lane delivers each write twice)
    assert {int(d[TT.W_SRC][0, i]) for i in idx} == {1, 3}
    last_src = int(d[TT.W_SRC][0, idx[-1]])
    last_val = int(d[TT.P2][0, idx[-1]])
    run_plan(j, t, [1], "writes in")
    m = t.st.model
    assert int(m.store[0, 2]) == last_val
    assert int(m.out_client[0, 2]) == last_src
    loser = 4 - last_src                  # the clients are 1 and 3
    d = t.st.inbox.data
    ok_to_loser = (d[TT.W_KIND][loser] == TT.MsgKind.APP) \
        & (d[TT.P0][loser] == tad.OP_WRITE_OK) & (d[TT.W_SRC][loser] == 0)
    assert bool(ok_to_loser.any())


def test_traffic_workload_n48_bit_identical():
    ts, (ok, facts) = traffic_lockstep("alsberg_day")
    assert ok and facts == {"acked": True, "replicated": True}
