"""The latency plane and the flight recorder in the port against the JAX
reference on the CPU: every state leaf after every round of
tests/test_latency.py's setups (the faulted HyParView + Plumtree run
with metrics and latency on, the outbox-defer burst, the compaction and
outbox cut sites, an acked retransmission under 50% link drop, the
flight ring on the generic arm), the ring's decoded ``Trace`` equal to
``Cluster.record``'s last rounds, the flight shape against
``jax.eval_shape``, the host readers (``percentiles``, ``window_snap``,
``breach_accounting``), the plane read-only against its off run, and
the configuration checks.  Tolerance 0 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import partisan_tpu.config as jconfig
import partisan_tpu_torch.config as tconfig
from partisan_tpu import latency as jlatency
from partisan_tpu import types as JT
from partisan_tpu.cluster import round_body as j_round_body
from partisan_tpu.models.direct_mail import DirectMail as JDirectMail
from partisan_tpu.models.plumtree import Plumtree as JPlumtree
from partisan_tpu.ops import msg as jmsg
from partisan_tpu_torch import latency as tlatency
from partisan_tpu_torch import metrics as tmetrics
from partisan_tpu_torch import state_io
from partisan_tpu_torch import trace as ttrace
from partisan_tpu_torch import types as TT
from partisan_tpu_torch.models.direct_mail import DirectMail as TDirectMail
from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree
from partisan_tpu_torch.ops import msg as tmsg
from test_torch_cluster import assert_same
from test_torch_metrics import (carry, faulted_cfg, faulted_run, join_all,
                                lockstep, pair)

torch.set_num_threads(1)


class JBurst:
    """Node 1 fires four messages to node 0 at round 2 on the default
    channel (the channel-capacity defer workload)."""

    def init(self, cfg, comm):
        return jnp.int32(0)

    def step(self, cfg, comm, state, ctx, nbrs):
        gids = comm.local_ids()
        fire = (ctx.rnd == 2) & (gids == 1)
        dst = jnp.where(fire, 0, -1)
        return state, jmsg.build(
            cfg, JT.MsgKind.APP, gids[:, None],
            jnp.broadcast_to(dst[:, None], (comm.n_local, 4)),
            payload=(jnp.int32(7),))


class TBurst:
    def init(self, cfg, comm):
        return torch.zeros((), dtype=torch.int32, device=comm.device)

    def step(self, cfg, comm, state, ctx, nbrs):
        gids = comm.local_ids()
        fire = (ctx.rnd == 2) & (gids == 1)
        dst = torch.where(fire, 0, -1).to(torch.int32)
        return state, tmsg.build(
            cfg, TT.MsgKind.APP, gids[:, None],
            dst[:, None].expand(comm.n_local, 4), payload=(7,))


def burst_run(make_cfg, rounds):
    jcl, tcl = pair(make_cfg, JBurst(), TBurst())
    js, ts = jcl.init(), tcl.init()
    assert_same(js, ts, "burst init")
    return lockstep(jcl, tcl, js, ts, rounds, "burst")


_CACHE: dict = {}


def _faulted():
    if "faulted" not in _CACHE:
        _CACHE["faulted"] = faulted_run(
            lambda C: faulted_cfg(C, metrics=True, metrics_ring=256,
                                  latency=True), rounds=40)
    return _CACHE["faulted"]


def test_faulted_run_bit_identical_and_reconciles():
    js, ts = _faulted()
    cfg = tconfig.Config(msg_words=16, latency=True)
    assert len(ts.inbox.data) == cfg.msg_words + 1
    snap = tlatency.snapshot(ts.latency)
    msnap = tmetrics.snapshot(ts.metrics)
    assert (snap["deliver"].sum(axis=1)
            == msnap["delivered"].sum(axis=0)).all()
    tot = tmetrics.totals(msnap)
    for cause, name in ((tmetrics.CAUSE_FAULT, "fault_cut"),
                        (tmetrics.CAUSE_DEAD, "dead_receiver"),
                        (tmetrics.CAUSE_COMPACT, "compact_shed"),
                        (tmetrics.CAUSE_OUTBOX, "outbox_shed")):
        assert snap["drop_age"][cause].sum() == tot["drops_by_cause"][name]
    assert snap["drop_age"][tmetrics.CAUSE_FAULT].sum() > 0
    assert snap["drop_age"][tmetrics.CAUSE_INBOX].sum() == 0
    jsnap = jlatency.snapshot(js.latency)
    for k in ("deliver", "drop_age", "age_hwm", "bounds"):
        np.testing.assert_array_equal(jsnap[k], snap[k], err_msg=k)
    assert tlatency.percentiles(snap) == jlatency.percentiles(jsnap)


def test_readers_match_reference():
    js, ts = _faulted()
    names = ("default", "partisan_membership", "rpc", "broadcast")
    jsnap = jlatency.snapshot(js.latency)
    tsnap = tlatency.snapshot(ts.latency)
    assert tlatency.percentiles(ts.latency, channels=names) \
        == jlatency.percentiles(js.latency, channels=names)
    half = {**tsnap, "deliver": tsnap["deliver"] // 2}
    jhalf = {**jsnap, "deliver": jsnap["deliver"] // 2}
    for a, b in ((tlatency.window_snap(half, tsnap),
                  jlatency.window_snap(jhalf, jsnap)),
                 (tlatency.window_snap(None, tsnap),
                  jlatency.window_snap(None, jsnap))):
        assert tlatency.percentiles(a) == jlatency.percentiles(b)
    rows = [(0, 10, {"default": 3, "bulk": None}), (10, 10, {"default": 5})]
    for slo in (3, 4, 5):
        assert tlatency.breach_accounting(rows, slo_rounds=slo) \
            == jlatency.breach_accounting(rows, slo_rounds=slo)
        assert tlatency.breach_accounting(
            rows, slo_rounds=slo, channels=("default", "rpc")) \
            == jlatency.breach_accounting(
                rows, slo_rounds=slo, channels=("default", "rpc"))
    ages = np.array([0, 1, 2, 3, 4, 7, 8, 1023, 1024, 5000], np.int32)
    np.testing.assert_array_equal(
        tlatency.bucket(torch.as_tensor(ages)).numpy(),
        np.asarray(jlatency.bucket(jnp.asarray(ages))))


def test_outbox_defer_ages_exact():
    """A lane_rate=1 burst of four same-edge sends delivers ages 0..3:
    deferred copies keep their birth round."""
    _, ts = burst_run(lambda C: C.Config(
        n_nodes=4, seed=3, peer_service_manager="static",
        channel_capacity=True, lane_rate=1, latency=True), 10)
    snap = tlatency.snapshot(ts.latency)
    ch0 = snap["deliver"][0]
    assert ch0.sum() == 4 and ch0[0] == 1 and ch0[1] == 1 and ch0[2] == 2
    assert snap["age_hwm"][0] == 3 and snap["drop_age"].sum() == 0


@pytest.mark.parametrize("kw, cause, name", [
    (dict(partition_mode="groups", emit_compact=2),
     tmetrics.CAUSE_COMPACT, "compact_shed"),
    (dict(channel_capacity=True, lane_rate=1, outbox_cap=1),
     tmetrics.CAUSE_OUTBOX, "outbox_shed"),
])
def test_compact_and_outbox_drop_ages(kw, cause, name):
    """Both cut sites with real losses: two sheds each, their ages in
    the matching drop-age row."""
    _, ts = burst_run(lambda C: C.Config(
        n_nodes=4, seed=3, peer_service_manager="static", metrics=True,
        metrics_ring=32, latency=True, **kw), 6)
    snap = tlatency.snapshot(ts.latency)
    tot = tmetrics.totals(tmetrics.snapshot(ts.metrics))
    assert tot["drops_by_cause"][name] == 2
    assert snap["drop_age"][cause].sum() == 2
    assert snap["deliver"].sum() == 2


def test_retransmit_keeps_birth_round():
    """An acked send retransmitted over a lossy link arrives with its
    original birth: the high-water mark exceeds 0."""
    jcl, tcl = pair(lambda C: C.Config(n_nodes=16, seed=21, ack_cap=16,
                                       latency=True),
                    JDirectMail(acked=True), TDirectMail(acked=True))
    js = jcl.init()
    m = js.manager
    for i in range(1, 16):
        m = jcl.manager.join(jcl.cfg, m, i, 0)
    js = jcl.steps(js._replace(manager=m), 15)
    js = js._replace(faults=js.faults._replace(link_drop=jnp.float32(0.5)),
                     model=jcl.model.broadcast(js.model, node=3, slot=0))
    _, ts = lockstep(jcl, tcl, js, carry(js), 30, "retransmit")
    assert int(tlatency.snapshot(ts.latency)["age_hwm"].max()) > 0


def _flight_pair():
    if "flight" not in _CACHE:
        def mk(C):
            return C.Config(n_nodes=32, seed=5,
                            peer_service_manager="hyparview", msg_words=16,
                            partition_mode="groups", max_broadcasts=4,
                            flight_rounds=8, latency=True,
                            plumtree=C.PlumtreeConfig(push_slots=2,
                                                      lazy_cap=4))
        jcl, tcl = pair(mk, JPlumtree(), TPlumtree())
        _CACHE["flight"] = (jcl, tcl)
    return _CACHE["flight"]


def test_flight_ring_bit_identical_and_equals_record():
    """The generic arm with the ring on, every leaf after every round;
    the decoded ring equals the last 8 rounds of ``Cluster.record`` over
    the same rounds, and a ``steps`` batch (the ring copied once, then
    written in place) leaves the caller's state untouched."""
    jcl, tcl = _flight_pair()
    js = join_all(jcl, jcl.init())
    ts = join_all(tcl, tcl.init())
    assert_same(js, ts, "flight init")
    js, ts = lockstep(jcl, tcl, js, ts, 10, "flight boot")
    js = js._replace(model=jcl.model.broadcast(js.model, 0, 0, 7))
    alive = js.faults.alive.at[5].set(False)
    base_j = js._replace(faults=js.faults._replace(
        alive=alive, link_drop=jnp.float32(0.1)))
    base = carry(base_j)
    before = state_io.state_to_numpy(base)
    js, ts = lockstep(jcl, tcl, base_j, base, 12, "flight")
    flight = tlatency.flight_trace(ts.flight)
    jf = jlatency.flight_trace(js.flight)
    assert np.array_equal(flight.sent, jf.sent)
    assert np.array_equal(flight.rounds, jf.rounds)
    batch = tcl.steps(base, 12)
    for (p, a), (_, b) in zip(state_io.flatten(state_io.state_to_numpy(ts)),
                              state_io.flatten(state_io.state_to_numpy(
                                  batch))):
        np.testing.assert_array_equal(a, b, err_msg=f"steps {p}")
    for (p, a), (_, b) in zip(state_io.flatten(before), state_io.flatten(
            state_io.state_to_numpy(base))):
        np.testing.assert_array_equal(a, b, err_msg=f"caller's {p}")
    _, traced = tcl.record(base, 12)
    recorded = ttrace.from_capture(traced).tail(8)
    assert flight.matches(recorded)
    assert np.array_equal(flight.rounds, recorded.rounds)
    assert np.array_equal(flight.dropped, recorded.dropped)
    assert flight.dropped.sum() > 0 and sum(1 for _ in flight.events()) > 0


def _eval_shape(jcl):
    base = jax.eval_shape(jcl._init_noflight)
    tr = jax.eval_shape(lambda s: j_round_body(
        jcl.cfg, jcl.manager, jcl.model, jcl.comm, s,
        interpose=jcl.interpose, capture=True)[1], base)
    return tuple(tr.sent.shape)


@pytest.mark.parametrize("setup", ["bench_planes", "flight_plumtree",
                                   "burst", "acked", "capacity"])
def test_flight_shape_matches_eval_shape(setup):
    """The ring's (n, E, W), read off a stopped round in the port, is
    ``jax.eval_shape``'s for each setup the flight ring is used with."""
    if setup == "flight_plumtree":
        jcl, tcl = _flight_pair()
    elif setup == "bench_planes":
        from test_torch_cluster import bench_kwargs

        def mk(C):
            return C.Config(**{**bench_kwargs(C.HyParViewConfig,
                                              C.PlumtreeConfig, n=64),
                               "metrics": True, "latency": True,
                               "provenance": True, "flight_rounds": 4})
        jcl, tcl = pair(mk, JPlumtree(), TPlumtree())
    elif setup == "acked":
        jcl, tcl = pair(lambda C: C.Config(
            n_nodes=8, seed=1, ack_cap=4, latency=True, flight_rounds=2),
            JDirectMail(acked=True), TDirectMail(acked=True))
    else:
        kw = dict(channel_capacity=True, outbox_cap=5) \
            if setup == "capacity" else {}
        jcl, tcl = pair(lambda C: C.Config(
            n_nodes=4, seed=3, peer_service_manager="static",
            flight_rounds=32, latency=True, **kw), JBurst(), TBurst())
    want = _eval_shape(jcl)
    assert tcl.flight_shape(tcl.init()) == want
    st = tcl.init()
    assert tuple(st.flight.sent.shape) == (jcl.cfg.flight_rounds,) + want
    assert_same(jcl.init(), st, f"{setup} init")


def test_latency_plane_is_read_only():
    """Every protocol leaf equals the plane-off run's, and the inbox's
    protocol words agree (the birth word sits outside the record)."""
    js_on, ts_on = _faulted()
    _, ts_off = faulted_run(lambda C: faulted_cfg(
        C, metrics=True, metrics_ring=256), with_jax=False)
    for name in ("rnd", "manager", "model", "stats", "faults", "delivery",
                 "metrics"):
        for (p, a), (_, b) in zip(
                state_io.flatten(state_io.state_to_numpy(
                    getattr(ts_off, name)), name),
                state_io.flatten(state_io.state_to_numpy(
                    getattr(ts_on, name)), name)):
            np.testing.assert_array_equal(a, b, err_msg=p)
    w = len(ts_off.inbox.data)
    for a, b in zip(ts_off.inbox.data, ts_on.inbox.data[:w]):
        assert torch.equal(a, b)


def test_config_checks():
    for C in (jconfig, tconfig):
        with pytest.raises(ValueError, match="flight_rounds"):
            C.Config(flight_rounds=-1)
        cfg = C.Config(msg_words=16, latency=True)
        assert cfg.wire_words == 17
    assert [str(d).split(".")[-1] for d in
            tconfig.Config(msg_words=16, latency=True).wire_dtypes] \
        == [str(np.dtype(d)) for d in
            jconfig.Config(msg_words=16, latency=True).wire_dtypes]
    assert tlatency.BUCKET_BOUNDS == jlatency.BUCKET_BOUNDS
