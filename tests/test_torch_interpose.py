"""The generic wire arm of the port against the JAX reference on the CPU:
every interposition class (the tests/test_interpose.py setups: N=8 full
mesh, direct mail, a broadcast from node 0), the egress/ingress delay
keys, dense partitions, and acked direct mail with retransmits under
link drops and a crash.  Both sides step in lockstep from the same
state; every state leaf must be bit-identical after every round
(tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu import delivery as jdelivery
from partisan_tpu import faults as jf
from partisan_tpu import interpose as ji
from partisan_tpu import types as JT
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.models.direct_mail import DirectMail as JDirectMail
from partisan_tpu_torch import delivery as tdelivery
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch import interpose as ti
from partisan_tpu_torch import types as TT
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.models.direct_mail import DirectMail as TDirectMail
from tests.test_torch_cluster import assert_same

torch.set_num_threads(1)

N = 8


def fm_kwargs(n, seed, **kw):
    """tests/support.fm_config's configuration."""
    return dict(n_nodes=n, seed=seed, inbox_cap=max(32, n + 8), **kw)


def pair(n, seed, jip=None, tip=None, acked=False, **kw):
    jcl = JCluster(JConfig(**fm_kwargs(n, seed, **kw)),
                   model=JDirectMail(acked), interpose=jip)
    tcl = TCluster(TConfig(**fm_kwargs(n, seed, **kw)),
                   model=TDirectMail(acked), interpose=tip, device="cpu")
    return jcl, tcl


def boot(jcl, tcl, settle=15):
    """tests/support.boot_fullmesh on both sides (every node joins via
    node 0, then membership gossip settles), then a broadcast from node
    0 slot 0."""
    js, ts = jcl.init(), tcl.init()
    assert_same(js, ts, "init")
    jm, tm = js.manager, ts.manager
    for i in range(1, jcl.cfg.n_nodes):
        jm = jcl.manager.join(jcl.cfg, jm, i, 0)
        tm = tcl.manager.join(tcl.cfg, tm, i, 0)
    js = jcl.steps(js._replace(manager=jm), settle)
    ts = tcl.steps(ts._replace(manager=tm), settle)
    assert_same(js, ts, "full-mesh boot")
    return (js._replace(model=jcl.model.broadcast(js.model, 0, 0)),
            ts._replace(model=tcl.model.broadcast(ts.model, 0, 0)))


def lockstep(jcl, tcl, js, ts, rounds, label):
    for r in range(rounds):
        js, ts = jcl.step(js), tcl.step(ts)
        assert_same(js, ts, f"{label} round {r}")
    return js, ts


@pytest.fixture(scope="module")
def booted():
    return boot(*pair(N, 5))


def _is_app(kind_of):
    return lambda cfg, ctx, em: kind_of(em) == 40


def _jkind(em):
    return em[..., JT.W_KIND]


def _tkind(em):
    return em[TT.W_KIND]


def _observe(side):
    if side == "jax":
        return ji.Observe(
            fn=lambda cfg, ctx, em: jnp.sum(_jkind(em) == 40,
                                            dtype=jnp.int32),
            combine=lambda s, aux: s + aux, init_state=jnp.int32(0))
    return ti.Observe(
        fn=lambda cfg, ctx, em: (_tkind(em) == 40).sum().to(torch.int32),
        combine=lambda s, aux: s + aux, init_state=0)


def _redirect(side):
    if side == "jax":
        return ji.Rewrite(lambda cfg, ctx, em: em.at[..., JT.W_DST].set(
            jnp.where(_jkind(em) == 40, 1, em[..., JT.W_DST])))
    return ti.Rewrite(lambda cfg, ctx, em: em[:TT.W_DST] + (
        torch.where(_tkind(em) == 40, 1, em[TT.W_DST]),) + em[TT.W_DST + 1:])


def _delay(side):
    mod, kind, flags = (ji, _jkind, lambda em: em[..., JT.W_FLAGS]) \
        if side == "jax" else (ti, _tkind, lambda em: em[TT.W_FLAGS])
    return mod.Delay(pred=lambda cfg, ctx, em: (kind(em) == 40)
                     & ((flags(em) & 2) == 0), rounds=4, cap=N + 2)


def _omission(side, start=0, partial=False):
    if partial:   # 3 sender rows, 2 slots: the rest passes
        drops = np.zeros((4, 3, 2), np.bool_)
        drops[:, 0, :] = True
    else:         # wider than the emission width: clipped
        drops = np.zeros((30, N, 64), np.bool_)
        drops[:, 0, :] = True
    return (ji if side == "jax" else ti).OmissionSchedule(drops, start=start)


def _drop_app(side):
    if side == "jax":
        return ji.Drop(_is_app(_jkind))
    return ti.Drop(_is_app(_tkind))


# name -> (interposition factory, config keywords, rounds, coverage after)
CASES = {
    "drop": (_drop_app, {}, 6, 1 / N),
    "rewrite": (_redirect, {}, 6, 2 / N),
    "delay": (_delay, {}, 7, 1.0),
    "observe": (_observe, {}, 4, 1.0),
    "chain_observe_then_drop": (
        lambda side: (ji if side == "jax" else ti).Chain(
            [_observe(side), _drop_app(side)]), {}, 4, 1 / N),
    "omission": (_omission, {}, 4, 1 / N),
    "omission_partial_window": (
        lambda side: _omission(side, start=15, partial=True), {}, 6,
        (N - 1) / N),
    "straggler": (lambda side: (ji if side == "jax" else ti)
                  .StragglerDelay(cap=8), {}, 6, 1.0),
    "config_delays_after_observe": (
        _observe, dict(egress_delay_ms=2000, ingress_delay_ms=1000), 6, 1.0),
    "config_delay_alone": (
        lambda side: None, dict(egress_delay_ms=3000, delay_buf_cap=16), 6,
        1.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_interposition_bit_identical(booted, name):
    make, kw, rounds, cov = CASES[name]
    jcl, tcl = pair(N, 5, make("jax"), make("torch"), **kw)
    js, ts = booted
    assert int(js.rnd) == 15
    js = js._replace(interpose=() if jcl.interpose is None
                     else jcl.interpose.init(jcl.cfg, jcl.comm))
    ts = ts._replace(interpose=() if tcl.interpose is None
                     else tcl.interpose.init(tcl.cfg, tcl.comm))
    if name == "straggler":   # the broadcaster is slow by 3 rounds
        js = js._replace(interpose={**js.interpose, "mult": js.interpose[
            "mult"].at[0].set(3)})
        ts.interpose["mult"][0] = 3
    assert_same(js, ts, f"{name} installed")
    js, ts = lockstep(jcl, tcl, js, ts, rounds, name)
    assert float(tcl.model.coverage(ts.model, ts.faults.alive, 0)) == cov
    if name == "config_delays_after_observe":
        assert isinstance(tcl.interpose, ti.Chain)
        assert tcl.interpose.items[1].cap == 192
        js, jtr = jcl.record(js, 3)
        ts, ttr = tcl.record(ts, 3)
        assert_same(jtr, ttr, f"{name} trace")
        assert_same(js, ts, f"{name} after record")


def test_scenario_fullmesh_boot_bit_identical():
    """scenarios._boot_fullmesh: every node joins via node 0, then two
    K_PROG executions."""
    from partisan_tpu import scenarios as jsc
    from partisan_tpu_torch import scenarios as tsc

    jcl, tcl = pair(N, 2)
    js, ts = jsc._boot_fullmesh(jcl, N), tsc._boot_fullmesh(tcl, N)
    assert_same(js, ts, "scenarios._boot_fullmesh")
    assert bool(tcl.manager.members(tcl.cfg, ts.manager).all())


def test_dense_partition_and_fullmesh_scripting():
    """Dense partitions (a partial a x b cut, then healed) on the generic
    arm, the captured trace's fault drops, and the full-mesh leave /
    rejoin scripting, at N=12."""
    n = 12
    jcl, tcl = pair(n, 3)
    assert tcl.cfg.resolved_partition_mode == "dense"
    js, ts = boot(jcl, tcl)
    a, b = np.arange(0, 4), np.arange(6, 9)
    js = js._replace(faults=jf.inject_partition(js.faults, a, b))
    ts = ts._replace(faults=tf.inject_partition(ts.faults, a, b))
    assert_same(js, ts, "partitioned")
    js, jtr = jcl.record(js, 3)
    ts, ttr = tcl.record(ts, 3)
    assert_same(jtr, ttr, "partitioned trace")
    assert_same(js, ts, "partitioned after record")
    assert bool(ttr.dropped.any())
    js, ts = lockstep(jcl, tcl, js, ts, 3, "partitioned")
    js = js._replace(faults=jf.resolve_partition(js.faults),
                     manager=jcl.manager.leave(jcl.cfg, js.manager, 9))
    ts = ts._replace(faults=tf.resolve_partition(ts.faults),
                     manager=tcl.manager.leave(tcl.cfg, ts.manager, 9))
    js, ts = lockstep(jcl, tcl, js, ts, 3, "healed, 9 left")
    js = js._replace(manager=jcl.manager.rejoin(jcl.cfg, js.manager, 9, 0))
    ts = ts._replace(manager=tcl.manager.rejoin(tcl.cfg, ts.manager, 9, 0))
    lockstep(jcl, tcl, js, ts, 3, "9 rejoined")


def test_acked_direct_mail_retransmits_under_link_drop():
    """The ack lane at N=10 with a 2-slot store (so sends overflow it),
    30% link drops and a crash: acks, ack consumption, stamping, slot
    choice by rank, overflow and the retransmit tick, every round."""
    n = 10
    jcl, tcl = pair(n, 9, acked=True, ack_cap=2)
    js, ts = boot(jcl, tcl)
    for node, slot in ((0, 1), (3, 4)):
        js = js._replace(model=jcl.model.broadcast(js.model, node, slot))
        ts = ts._replace(model=tcl.model.broadcast(ts.model, node, slot))
    js = js._replace(faults=js.faults._replace(link_drop=jnp.float32(0.3)))
    ts = ts._replace(faults=tf.set_link_drop(ts.faults, 0.3))
    js, ts = lockstep(jcl, tcl, js, ts, 4, "lossy")
    js = js._replace(faults=jf.crash(js.faults, 5))
    ts = ts._replace(faults=tf.crash(ts.faults, 5))
    js, ts = lockstep(jcl, tcl, js, ts, 8, "lossy, 5 crashed")
    assert int(ts.delivery.ack.overflow) > 0
    assert int(tdelivery.overflow_total(ts.delivery)) == \
        int(jdelivery.overflow_total(js.delivery))
    assert tdelivery.overflow_total(()) == 0
    assert int(ts.stats.dropped) > 0
    assert np.asarray(jax.device_get(js.delivery.ack.next_clock)).max() > 3
