"""SCAMP v1/v2 parity: the PyTorch port's manager against the JAX
reference on the CPU at n=64, bit for bit (tolerance 0).  Both sides
start from the reference's init state carried across with
``state_from_numpy`` and step in lockstep; every state leaf must agree
after every K_PROG-round execution, through batched joins without and
with an admission stagger, graceful leaves, and churn."""

import jax
import numpy as np
import pytest
import torch

from partisan_tpu import faults as jf
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.config import ScampConfig as JScampCfg
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.config import ScampConfig as TScampCfg
from partisan_tpu_torch.managers.scamp import Scamp

from test_torch_cluster import assert_same

torch.set_num_threads(1)

N = 64
K_PROG = 10


def kwargs(version, sc_cls):
    return dict(n_nodes=N, seed=5, peer_service_manager=f"scamp_v{version}",
                msg_words=16, partition_mode="groups", inbox_cap=24,
                scamp=sc_cls(partial_max=16, in_max=16, message_window=3))


def pair(version, **kw):
    jcl = JCluster(JConfig(**kwargs(version, JScampCfg)))
    tcl = TCluster(TConfig(**kwargs(version, TScampCfg)), device="cpu",
                   **kw)
    return jcl, tcl


def both_steps(jcl, tcl, js, ts, execs, label):
    for i in range(execs):
        js, ts = jcl.steps(js, K_PROG), tcl.steps(ts, K_PROG)
        assert_same(js, ts, f"{label} exec {i}")
    return js, ts


@pytest.fixture(scope="module", params=[1, 2])
def booted(request):
    """Two join waves — the first immediate, the second staggered by
    ``rounds`` — stepped in lockstep from the carried-over init."""
    v = request.param
    jcl, tcl = pair(v)
    js = jcl.init()
    ts = state_io.state_from_numpy(jax.device_get(js), device="cpu")
    assert_same(js, tcl.init(), "port init")
    first = np.arange(1, 16, dtype=np.int32)
    tgts = (first // 2).astype(np.int32)
    js = js._replace(manager=jcl.manager.join_many(jcl.cfg, js.manager,
                                                   first, tgts))
    ts = ts._replace(manager=tcl.manager.join_many(tcl.cfg, ts.manager,
                                                   first, tgts))
    js, ts = both_steps(jcl, tcl, js, ts, 2, f"v{v} wave 1")
    rest = np.arange(16, N, dtype=np.int32)
    tgts = np.random.default_rng(v).integers(0, 16, rest.shape[0]) \
        .astype(np.int32)
    rounds = (int(js.rnd) + (rest % 25)).astype(np.int32)
    js = js._replace(manager=jcl.manager.join_many(jcl.cfg, js.manager,
                                                   rest, tgts, rounds))
    ts = ts._replace(manager=tcl.manager.join_many(tcl.cfg, ts.manager,
                                                   rest, tgts, rounds))
    js, ts = both_steps(jcl, tcl, js, ts, 4, f"v{v} wave 2")
    return v, jcl, tcl, js, ts


def test_boot_builds_the_overlay(booted):
    v, _, tcl, _, ts = booted
    sizes = (ts.manager.partial >= 0).sum(dim=1)
    assert int(sizes.min()) >= 1 and float(sizes.float().mean()) > 2.0
    if v == 2:
        assert int((ts.manager.in_view >= 0).sum()) > 0
    members = tcl.manager.members(tcl.cfg, ts.manager, tcl.comm)
    assert bool(members[torch.arange(N), torch.arange(N)].all())


def test_graceful_leaves_bit_identical(booted):
    """One ``leave`` and one ``leave_many`` batch (v2: the REPLACE
    rebalance of the in-view; v1: the UNSUBSCRIBE walks)."""
    v, jcl, tcl, js, ts = booted
    js = js._replace(manager=jcl.manager.leave(jcl.cfg, js.manager, 5))
    ts = ts._replace(manager=tcl.manager.leave(tcl.cfg, ts.manager, 5))
    js = js._replace(manager=jcl.manager.leave_many(jcl.cfg, js.manager,
                                                    [9, 30, 41]))
    ts = ts._replace(manager=tcl.manager.leave_many(tcl.cfg, ts.manager,
                                                    [9, 30, 41]))
    assert_same(js, ts, f"v{v} leaves marked")
    js, ts = both_steps(jcl, tcl, js, ts, 3, f"v{v} leave")
    assert bool(ts.manager.left[[5, 9, 30, 41]].all())
    assert int((ts.manager.partial == 5).sum()) < N


def test_churn_bit_identical(booted):
    """``faults.churn_step`` each execution at 4%/round birth and death,
    the isolation window (3 periodic intervals) included."""
    v, jcl, tcl, js, ts = booted
    for i in range(4):
        jfs = jf.churn_step(js.faults, 4, js.rnd, 0.04, 0.04)
        tfs = tf.churn_step(ts.faults, 4, ts.rnd, 0.04, 0.04)
        np.testing.assert_array_equal(np.asarray(jfs.alive),
                                      tfs.alive.numpy())
        js, ts = js._replace(faults=jfs), ts._replace(faults=tfs)
        js, ts = both_steps(jcl, tcl, js, ts, 1, f"v{v} churn {i}")
    assert int((~ts.faults.alive).sum()) > 0


def test_recover_and_rejoin_bit_identical(booted):
    v, jcl, tcl, js, ts = booted
    js = js._replace(faults=jf.crash(js.faults, 12))
    ts = ts._replace(faults=tf.crash(ts.faults, 12))
    js, ts = both_steps(jcl, tcl, js, ts, 1, f"v{v} crashed")
    js = js._replace(faults=jf.recover(js.faults, 12))
    ts = ts._replace(faults=tf.recover(ts.faults, 12))
    js = js._replace(manager=jcl.manager.join(jcl.cfg, js.manager, 12, 3))
    ts = ts._replace(manager=tcl.manager.join(tcl.cfg, ts.manager, 12, 3))
    both_steps(jcl, tcl, js, ts, 2, f"v{v} recovered")


def test_shortened_slot_loop_equals_full_loop(booted):
    """The slot loop that stops after the last occupied slot against the
    loop over all ``inbox_cap`` slots, round by round, through a join
    wave (busy inboxes), quiet rounds and a leave."""
    v, _, tcl, _, ts = booted
    _, full = pair(v, manager=Scamp(version=v, full_slot_loop=True))
    ts = ts._replace(manager=tcl.manager.join_many(
        tcl.cfg, ts.manager, np.array([7, 8]), np.array([1, 2]), None))
    ts = ts._replace(manager=tcl.manager.leave(tcl.cfg, ts.manager, 20))
    a, b = ts, ts
    busy = 0
    for r in range(25):
        busy = max(busy, int(a.inbox.count.max()))
        a, b = tcl.step(a), full.step(b)
        for (p, x), (_, y) in zip(state_io.flatten(a),
                                  state_io.flatten(b)):
            assert torch.equal(x, y), (r, p)
    assert 0 < busy < tcl.cfg.inbox_cap
