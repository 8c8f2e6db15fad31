"""The delivery layer's causal lanes in the port against the JAX reference
on the CPU: the point-to-point lane (the tests/test_delivery.py p2p
setups, plus one with small bucket tables so that stream resets and
aborts happen), the causal broadcast lane through ``CausalChat`` (the
tests/test_delivery.py causal setups), and config 5's configuration —
``Stack([Plumtree, P2PChat])`` over HyParView at n=128 with
``emit_compact=32`` and the width operand.  The reference's state is
carried across with ``state_io`` and both sides step from it; every
state leaf must be bit-identical after every round (after every K_PROG
execution on the ladder), tolerance 0.  The reference test's own
assertion is then checked on the port's final state."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu import delivery as jdelivery
from partisan_tpu import faults as jf
from partisan_tpu import scenarios as jsc
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.config import PlumtreeConfig as JPlumtreeCfg
from partisan_tpu.models.causal_chat import CausalChat as JCausalChat
from partisan_tpu.models.p2p_chat import P2PChat as JP2PChat
from partisan_tpu.models.plumtree import Plumtree as JPlumtree
from partisan_tpu.models.stack import Stack as JStack
from partisan_tpu_torch import delivery as tdelivery
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch import scenarios as tsc
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.config import PlumtreeConfig as TPlumtreeCfg
from partisan_tpu_torch.models.causal_chat import CausalChat as TCausalChat
from partisan_tpu_torch.models.p2p_chat import P2PChat as TP2PChat
from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree
from partisan_tpu_torch.models.stack import Stack as TStack
from tests.test_torch_cluster import assert_same

torch.set_num_threads(1)

J = SimpleNamespace(
    f=jf, drop=lambda s, p: s._replace(
        faults=s.faults._replace(link_drop=jnp.float32(p))))
T = SimpleNamespace(
    f=tf, drop=lambda s, p: s._replace(faults=tf.set_link_drop(s.faults, p)))


def lockstep(jcl, tcl, script, state=None):
    """Run ``script`` on both sides from the reference's init state (or
    ``state``, a reference state) carried across: an int steps that many
    rounds, comparing every leaf after each; a callable ``act(side, cl,
    st) -> st`` is applied to each side.  Returns both final states."""
    js = jcl.init() if state is None else state
    ts = state_io.state_from_numpy(jax.device_get(js), device="cpu")
    assert_same(js, ts, "carried")
    for i, item in enumerate(script):
        if callable(item):
            js, ts = item(J, jcl, js), item(T, tcl, ts)
            assert_same(js, ts, f"action {i}")
            continue
        for r in range(item):
            js, ts = jcl.step(js), tcl.step(ts)
            assert_same(js, ts, f"item {i} round {r} (rnd {int(ts.rnd)})")
    return js, ts


def sched(sends, now=0):
    """Schedule p2p sends ``(node, rnd, dst)``; ``rnd`` may be a callable
    of the current round."""
    def act(side, cl, st):
        m = st.model
        for node, rnd, dst in sends:
            r = rnd(int(st.rnd)) if callable(rnd) else rnd
            m = cl.model.schedule(m, node=node, rnd=r, dst=dst,
                                  now=now(int(st.rnd)) if callable(now)
                                  else now)
        return st._replace(model=m)
    return act


def drop(p):
    return lambda side, cl, st: side.drop(st, p)


def fault(name, *args):
    return lambda side, cl, st: st._replace(
        faults=getattr(side.f, name)(st.faults, *args))


def seqs_from(ts, node, sender):
    return [t % 1000 for t in TP2PChat.logs(ts.model)[node]
            if t // 1000 == sender]


def p2p_pair(n, seed, **kw):
    kw = dict(n_nodes=n, seed=seed, causal_p2p_labels=("chat",),
              peer_service_manager="static", **kw)
    return (JCluster(JConfig(**kw), model=JP2PChat()),
            TCluster(TConfig(**kw), model=TP2PChat(), device="cpu"))


def _any_node_plan(n=64):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        dst = int(rng.integers(0, n - 1))
        dst = dst if dst < i else dst + 1
        out += [(i, 4 + 2 * k, dst) for k in range(3)]
    return out


# name: (n, seed, config overrides, script, check(ts, cfg))
P2P_SETUPS = {
    "fifo_per_edge_under_loss": (
        8, 3, {}, [sched([(0, r, 5) for r in (5, 6, 7, 9)]), drop(0.5), 20,
                   drop(0.0), 8],
        lambda ts: seqs_from(ts, 5, 0) == [1, 2, 3, 4]),
    "any_node_sends": (
        64, 11, {}, [sched(_any_node_plan()), 30],
        lambda ts: sum(map(len, TP2PChat.logs(ts.model))) == 192 and all(
            TP2PChat.edge_fifo_ok(g) and len(g) == len(set(g))
            for g in TP2PChat.logs(ts.model))),
    "quota_spill_no_loss": (
        32, 23, dict(causal_deliver_cap=4),
        [sched([(s, 3, 0) for s in range(1, 21)]), 14],
        lambda ts: len(set(TP2PChat.logs(ts.model)[0])) == 20),
    "backpressure_never_wedges": (
        8, 29, dict(p2p_hist_cap=4),
        [sched([(1, 3 + k, 6) for k in range(8)]), drop(1.0), 14,
         drop(0.0), 10,
         sched([(1, lambda r: r + 1, 6)], now=lambda r: r), 6],
        lambda ts: seqs_from(ts, 6, 1) == [1, 2, 3, 4, 9]
        and int(ts.delivery.p2p[0].overflow) > 0),
    "lost_head_delivers_first": (
        8, 37, dict(retransmit_interval_ms=8_000),
        [sched([(1, 3, 5), (1, 6, 5)]), drop(1.0), 4, drop(0.0), 24],
        lambda ts: seqs_from(ts, 5, 1) == [1, 2]),
    "receiver_crash_recovery": (
        8, 41, {},
        [sched([(1, 2, 5), (1, 3, 5)]), 8, fault("crash", 5),
         sched([(1, lambda r: r + 1, 5)]), 6, fault("recover", 5),
         sched([(1, lambda r: r + 1, 5)]), 8],
        lambda ts: seqs_from(ts, 5, 1) == [1, 2, 4]
        and int(ts.delivery.p2p[0].aborted) > 0),
    # Two-bucket tables on both ends: six senders into node 0 and node 0
    # into six destinations, under loss — bucket evictions reset
    # streams, orphaned arrivals ask for reopens, unacked records abort.
    "small_tables_reset_and_abort": (
        16, 7, dict(p2p_dst_cap=2, p2p_src_cap=2),
        [sched([(s, r, 0) for s in range(1, 7) for r in (3, 5)]
               + [(0, 3 + k, 1 + k) for k in range(6)]), drop(0.3), 16,
         drop(0.0), 8],
        lambda ts: int(ts.delivery.p2p[0].resets) > 0
        and int(ts.delivery.p2p[0].aborted) > 0),
}


@pytest.mark.parametrize("name", sorted(P2P_SETUPS))
def test_p2p_lane_bit_identical(name):
    n, seed, over, script, check = P2P_SETUPS[name]
    js, ts = lockstep(*p2p_pair(n, seed, **over), script)
    assert check(ts), (name, TP2PChat.logs(ts.model))
    assert int(tdelivery.overflow_total(ts.delivery)) == \
        int(jdelivery.overflow_total(js.delivery))


def chat_pair(seed, **kw):
    kw = dict(n_nodes=8, seed=seed, causal_labels=("chat",), n_actors=8,
              **kw)
    return (JCluster(JConfig(**kw), model=JCausalChat()),
            TCluster(TConfig(**kw), model=TCausalChat(), device="cpu"))


def boot_mesh(side, cl, st):
    """tests/support.boot_fullmesh's joins via node 0 (the settle rounds
    are stepped by the script)."""
    m = st.manager
    for i in range(1, cl.cfg.n_nodes):
        m = cl.manager.join(cl.cfg, m, i, 0)
    return st._replace(manager=m)


def cast(node, after=1):
    return lambda side, cl, st: st._replace(model=cl.model.schedule(
        st.model, node=node, rnd=int(st.rnd) + after))


def chat_logs(ts):
    return TCausalChat.logs(ts.model)


# name: (seed, config overrides, script, check(ts))
CAUSAL_SETUPS = {
    # B hears A, then sends; C hears B first but must deliver A first
    # (recovered by A's history replay once the cut heals).
    "order_across_senders_with_loss": (
        13, {}, [boot_mesh, 15, fault("inject_partition", [0], [2]),
                 cast(0), 3, cast(1), 3, fault("resolve_partition"), 4],
        lambda ts: chat_logs(ts)[2][:2] == [1, 1001] and all(
            len(g) == len(set(g)) for g in chat_logs(ts))),
    # More deliverable records than one round's quota after a partition
    # heals: the excess spills to later rounds, exactly once, in order.
    "catchup_beyond_deliver_cap": (
        17, dict(causal_deliver_cap=4, causal_hist_cap=8),
        [boot_mesh, 15, fault("inject_partition", [0, 1, 2, 3], [6]),
         *[cast(a) for a in range(4)], *[cast(a, 3) for a in range(4)],
         6, fault("resolve_partition"), 10],
        lambda ts: sorted(chat_logs(ts)[6]) == [
            1, 2, 1001, 1002, 2001, 2002, 3001, 3002]),
}


@pytest.mark.parametrize("name", sorted(CAUSAL_SETUPS))
def test_causal_broadcast_lane_bit_identical(name):
    seed, over, script, check = CAUSAL_SETUPS[name]
    _, ts = lockstep(*chat_pair(seed, **over), script)
    assert check(ts), chat_logs(ts)


def test_config5_stack_with_compaction_bit_identical():
    """Config 5's configuration at n=128 with ``emit_compact=32`` (the
    scenario compacts only above n=4096): the width-operand ladder
    compared after every K_PROG execution, then the scripted p2p sends,
    crashed victims and a Plumtree broadcast stepped round by round."""
    n, k = 128, tsc.K_PROG

    def kw(pt):
        return dict(n_nodes=n, seed=5, peer_service_manager="hyparview",
                    msg_words=16, partition_mode="groups",
                    causal_p2p_labels=("chat",), max_broadcasts=8,
                    inbox_cap=16, emit_compact=32, timer_stagger=False,
                    width_operand=True,
                    plumtree=pt(push_slots=2, lazy_cap=4))

    jst, tst = JStack([JPlumtree(), JP2PChat()]), \
        TStack([TPlumtree(), TP2PChat()])
    jcl = JCluster(JConfig(**kw(JPlumtreeCfg)), model=jst)
    tcl = TCluster(TConfig(**kw(TPlumtreeCfg)), model=tst, device="cpu")
    js0 = jcl.init()
    ts0 = state_io.state_from_numpy(jax.device_get(js0), device="cpu")
    jw, tw = [], []
    _, js = jsc._boot_ladder(lambda w: jcl, n, settle_execs=1,
                             on_wave=lambda hi, s, w: jw.append(
                                 jax.device_get(s)), final_state=js0)
    _, ts = tsc._boot_ladder(lambda w: tcl, n, settle_execs=1,
                             on_wave=lambda hi, s, w: tw.append(s),
                             final_state=ts0)
    assert len(jw) == len(tw) > 0
    for i, (a, b) in enumerate(zip(jw, tw)):
        assert_same(a, b, f"ladder wave {i}")
    assert_same(js, ts, "ladder settled")
    start = int(ts.rnd)
    victims = [7, 40, 99]

    def script(side, cl, st):
        stack, (plum, chat) = cl.model, cl.model.models
        m = stack.replace_sub(st.model, 1, chat.schedule_many(
            stack.sub(st.model, 1), [3, 3, 50, 50, 77, 77],
            [start + 2, start + 6] * 3, [60, 60, 3, 3, 120, 120]))
        m = stack.replace_sub(m, 0, plum.broadcast(stack.sub(m, 0), 0, 0,
                                                   start))
        f = st.faults
        for v in victims:
            f = side.f.crash(f, v)
        return st._replace(model=m, faults=f)

    js, ts = lockstep(jcl, tcl, [script, 2 * k], state=js)
    logs = TP2PChat.logs(ts.model[1])
    assert [logs[r] for r in (60, 3, 120)] == [[3001, 3002], [50001, 50002],
                                               [77001, 77002]]
    cov = float(tst.coverage(ts.model, ts.faults.alive, 0))
    assert cov == 1.0
