"""Slice parity: the PyTorch port's main path (bench config, width-operand
bootstrap ladder, one Plumtree broadcast stepped to coverage, the
``Cluster.record`` capture) against the JAX reference at n=64 on the
CPU.  The reference's init state is carried across with
``state_from_numpy`` and both sides step in lockstep; every state leaf
must be bit-identical after every K_PROG-round execution."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from partisan_tpu import faults as jf
from partisan_tpu import scenarios as jsc
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.config import HyParViewConfig as JHyParView
from partisan_tpu.config import PlumtreeConfig as JPlumtreeCfg
from partisan_tpu.models.plumtree import Plumtree as JPlumtree
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch import scenarios as tsc
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.config import ControlConfig as TControlCfg
from partisan_tpu_torch.config import HyParViewConfig as THyParView
from partisan_tpu_torch.config import PlumtreeConfig as TPlumtreeCfg
from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree

torch.set_num_threads(1)

N = 64
K_PROG = tsc.K_PROG
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_kwargs(hv_cls, pt_cls, n=N):
    """bench.py's make_cfg, every plane off."""
    return dict(n_nodes=n, seed=1, peer_service_manager="hyparview",
                msg_words=16, partition_mode="groups", max_broadcasts=8,
                inbox_cap=16, emit_compact=32, timer_stagger=False,
                metrics=False, metrics_ring=256, latency=False, health=0,
                health_ring=256, provenance=False, provenance_ring=256,
                width_operand=True, superstep=1,
                hyparview=hv_cls(isolation_window_ms=25_000),
                plumtree=pt_cls(push_slots=2, lazy_cap=4))


def assert_same(js, ts, label=""):
    """Every leaf of a reference state equals the port's (dtype, shape,
    bits), in pytree order."""
    jl = jax.tree_util.tree_leaves(jax.device_get(js))
    tl = state_io.flatten(state_io.state_to_numpy(ts))
    assert len(jl) == len(tl), (label, len(jl), len(tl))
    for ja, (path, ta) in zip(jl, tl):
        ja = np.asarray(ja)
        assert ja.dtype == ta.dtype, (label, path, ja.dtype, ta.dtype)
        assert ja.shape == ta.shape, (label, path, ja.shape, ta.shape)
        np.testing.assert_array_equal(ja, ta, err_msg=f"{label} {path}")


@pytest.fixture(scope="module")
def pair():
    jm, tm = JPlumtree(), TPlumtree()
    jcl = JCluster(JConfig(**bench_kwargs(JHyParView, JPlumtreeCfg)),
                   model=jm)
    tcl = TCluster(TConfig(**bench_kwargs(THyParView, TPlumtreeCfg)),
                   model=tm, device="cpu")
    return jcl, tcl, jm, tm


@pytest.fixture(scope="module")
def booted(pair):
    """Both ladders (widths [32, 64]) from the carried-over init state,
    with a snapshot after every wave execution."""
    jcl, tcl, _, _ = pair
    js0 = jcl.init()
    ts0 = state_io.state_from_numpy(jax.device_get(js0), device="cpu")
    jw, tw = [], []
    _, js = jsc._boot_ladder(
        lambda w: jcl, N, widths=[32, 64], settle_execs=1,
        on_wave=lambda hi, s, w: jw.append(jax.device_get(s)),
        final_state=js0)
    _, ts = tsc._boot_ladder(
        lambda w: tcl, N, widths=[32, 64], settle_execs=1,
        on_wave=lambda hi, s, w: tw.append(s), final_state=ts0)
    return js0, ts0, jw, tw, js, ts


def test_init_carried_across_matches_port_init(pair, booted):
    _, tcl, _, _ = pair
    js0, ts0 = booted[0], booted[1]
    assert_same(js0, ts0, "carried init")
    assert_same(js0, tcl.init(), "port init")
    assert len(state_io.flatten(ts0)) == 44


def test_ladder_bit_identical_after_every_execution(booted):
    _, _, jw, tw, js, ts = booted
    assert len(jw) == len(tw) >= 3
    for i, (a, b) in enumerate(zip(jw, tw)):
        assert_same(a, b, f"wave {i}")
    assert_same(js, ts, "ladder end")


def test_broadcast_converges_in_lockstep(pair, booted):
    jcl, tcl, jm, tm = pair
    js, ts = booted[4], booted[5]
    r0 = int(js.rnd)
    js = js._replace(model=jm.broadcast(js.model, 0, 0, r0))
    ts = ts._replace(model=tm.broadcast(ts.model, 0, 0, r0))
    assert_same(js, ts, "broadcast")
    jconv = tconv = -1
    for i in range(30):
        jdone = float(jm.coverage(js.model, js.faults.alive, 0, r0)) == 1.0
        tdone = float(tm.coverage(ts.model, ts.faults.alive, 0, r0)) == 1.0
        assert jdone == tdone
        if jdone:
            jconv, tconv = int(js.rnd), int(ts.rnd)
            break
        js, ts = jcl.steps(js, K_PROG), tcl.steps(ts, K_PROG)
        assert_same(js, ts, f"converge exec {i}")
    assert jconv == tconv > r0
    # the ported _converge loop lands on the same round
    ts_b = tsc._converge(tcl, booted[5]._replace(
        model=tm.broadcast(booted[5].model, 0, 0, r0)),
        lambda s: tm.coverage(s.model, s.faults.alive, 0, r0), 300)[1]
    assert ts_b == tconv


def test_record_trace_bit_identical(pair, booted):
    jcl, tcl, jm, tm = pair
    js, ts = booted[4], booted[5]
    js = js._replace(model=jm.broadcast(js.model, 5, 1, 3))
    ts = ts._replace(model=tm.broadcast(ts.model, 5, 1, 3))
    js, jtr = jcl.record(js, 5)
    ts, ttr = tcl.record(ts, 5)
    assert tuple(ttr.sent.shape) == (5, N, 77, 16)
    np.testing.assert_array_equal(np.asarray(jtr.rnd), ttr.rnd.numpy())
    np.testing.assert_array_equal(np.asarray(jtr.sent), ttr.sent.numpy())
    np.testing.assert_array_equal(np.asarray(jtr.dropped),
                                  ttr.dropped.numpy())
    assert int((ttr.sent[..., 0] != 0).sum()) > 0
    assert_same(js, ts, "after record")


def test_fault_case_bit_identical(pair, booted):
    jcl, tcl, jm, tm = pair
    js, ts = booted[4], booted[5]
    victims = [3, 17, 40, 41]
    a, b = np.arange(0, 24), np.arange(24, N)
    jfs = jf.inject_partition(jf.crash_many(js.faults, victims), a, b)
    tfs = tf.inject_partition(tf.crash_many(ts.faults, victims), a, b)
    jfs = jfs._replace(link_drop=jax.numpy.float32(0.05))
    tfs = tf.set_link_drop(tfs, 0.05)
    js = js._replace(faults=jfs, model=jm.broadcast(js.model, 30, 0, 9))
    ts = ts._replace(faults=tfs, model=tm.broadcast(ts.model, 30, 0, 9))
    assert_same(js, ts, "faults injected")
    for i in range(3):
        js, ts = jcl.steps(js, K_PROG), tcl.steps(ts, K_PROG)
        assert_same(js, ts, f"faulted exec {i}")
    js, jtr = jcl.record(js, 3)
    ts, ttr = tcl.record(ts, 3)
    np.testing.assert_array_equal(np.asarray(jtr.sent), ttr.sent.numpy())
    np.testing.assert_array_equal(np.asarray(jtr.dropped),
                                  ttr.dropped.numpy())
    assert bool(ttr.dropped.any())
    js = js._replace(faults=jf.resolve_partition(js.faults))
    ts = ts._replace(faults=tf.resolve_partition(ts.faults))
    for i in range(2):
        js, ts = jcl.steps(js, K_PROG), tcl.steps(ts, K_PROG)
        assert_same(js, ts, f"healed exec {i}")


def test_record_under_omission_schedule_bit_identical(pair, booted):
    """The bench path through the generic wire arm: an OmissionSchedule
    (5% of the slots of four rounds, from a numpy seed, plus every slot
    of node 0 in the broadcast round) during a broadcast, record(4)."""
    from partisan_tpu import interpose as ji
    from partisan_tpu_torch import interpose as ti

    _, _, jm, tm = pair
    js, ts = booted[4], booted[5]
    r0 = int(js.rnd)
    drops = np.random.default_rng(11).random((4, N, 77)) < 0.05
    drops[0, 0, :] = True
    jsched = ji.OmissionSchedule(drops, start=r0)
    tsched = ti.OmissionSchedule(drops, start=r0)
    jcl = JCluster(JConfig(**bench_kwargs(JHyParView, JPlumtreeCfg)),
                   model=jm, interpose=jsched)
    tcl = TCluster(TConfig(**bench_kwargs(THyParView, TPlumtreeCfg)),
                   model=tm, interpose=tsched, device="cpu")
    js = js._replace(model=jm.broadcast(js.model, 0, 0, r0),
                     interpose=jsched.init(jcl.cfg, jcl.comm))
    ts = ts._replace(model=tm.broadcast(ts.model, 0, 0, r0),
                     interpose=tsched.init(tcl.cfg, tcl.comm))
    assert_same(js, ts, "schedule installed")
    js, jtr = jcl.record(js, 4)
    ts, ttr = tcl.record(ts, 4)
    np.testing.assert_array_equal(np.asarray(jtr.sent), ttr.sent.numpy())
    np.testing.assert_array_equal(np.asarray(jtr.dropped),
                                  ttr.dropped.numpy())
    assert_same(js, ts, "after record under omissions")
    assert not bool((ttr.sent[0, 0, :, 0] != 0).any())


@pytest.mark.parametrize("variant", ["staggered_no_width_operand",
                                     "quiet_features_off"])
def test_config_variants_bit_identical(variant):
    """Branches the bench config does not take: staggered timers, no
    width operand (n_active = ()), two AAE peers per tick, no
    compaction, heartbeat / auto-rejoin / AAE off."""
    n = 48

    def kw(hv_cls, pt_cls):
        k = bench_kwargs(hv_cls, pt_cls, n=n)
        if variant == "staggered_no_width_operand":
            k.update(timer_stagger=True, width_operand=False,
                     plumtree=pt_cls(push_slots=2, lazy_cap=4,
                                     exchange_limit=2))
        else:
            k.update(emit_compact=0,
                     hyparview=hv_cls(heartbeat=False, auto_rejoin=False),
                     plumtree=pt_cls(aae=False))
        return k

    jm, tm = JPlumtree(), TPlumtree()
    jcl = JCluster(JConfig(**kw(JHyParView, JPlumtreeCfg)), model=jm)
    tcl = TCluster(TConfig(**kw(THyParView, TPlumtreeCfg)), model=tm,
                   device="cpu")
    js = jcl.init()
    ts = state_io.state_from_numpy(jax.device_get(js), device="cpu")
    nodes = np.arange(1, n, dtype=np.int32)
    contacts = (nodes // 3).astype(np.int32)
    js = js._replace(manager=jcl.manager.join_many(jcl.cfg, js.manager,
                                                   nodes, contacts))
    ts = ts._replace(manager=tcl.manager.join_many(tcl.cfg, ts.manager,
                                                   nodes, contacts))
    for i in range(3):
        js, ts = jcl.steps(js, K_PROG), tcl.steps(ts, K_PROG)
        assert_same(js, ts, f"{variant} boot {i}")
    js = js._replace(model=jm.broadcast(js.model, 9, 0, 2))
    ts = ts._replace(model=tm.broadcast(ts.model, 9, 0, 2))
    for i in range(2):
        js, ts = jcl.steps(js, K_PROG), tcl.steps(ts, K_PROG)
        assert_same(js, ts, f"{variant} broadcast {i}")
    if variant == "staggered_no_width_operand":
        js, jtr = jcl.record(js, 2)
        ts, ttr = tcl.record(ts, 2)
        np.testing.assert_array_equal(np.asarray(jtr.sent), ttr.sent.numpy())
        assert_same(js, ts, f"{variant} record")


def test_state_numpy_roundtrip(booted):
    ts = booted[5]
    back = state_io.state_from_numpy(state_io.state_to_numpy(ts),
                                     device="cpu")
    for (p, a), (_, b) in zip(state_io.flatten(ts), state_io.flatten(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_port_imports_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import partisan_tpu_torch, partisan_tpu_torch.cluster, "
            "partisan_tpu_torch.scenarios, partisan_tpu_torch.state_io, "
            "partisan_tpu_torch.kernels, partisan_tpu_torch.filibuster, "
            "partisan_tpu_torch.probe, partisan_tpu_torch.trace, "
            "partisan_tpu_torch.analysis, partisan_tpu_torch.interpose, "
            "partisan_tpu_torch.health, partisan_tpu_torch.managers.scamp, "
            "partisan_tpu_torch.managers.static, "
            "partisan_tpu_torch.managers.client_server, "
            "partisan_tpu_torch.models.anti_entropy, "
            "partisan_tpu_torch.models.rumor_mongering, "
            "partisan_tpu_torch.delivery, partisan_tpu_torch.channels, "
            "partisan_tpu_torch.ops.vclock, "
            "partisan_tpu_torch.models.stack, "
            "partisan_tpu_torch.models.p2p_chat, "
            "partisan_tpu_torch.models.causal_chat, "
            "partisan_tpu_torch.models.echo, "
            "partisan_tpu_torch.models.paxos, "
            "partisan_tpu_torch.ops.scatter, "
            "partisan_tpu_torch.models.commit, "
            "partisan_tpu_torch.models.alsberg_day, "
            "partisan_tpu_torch.prop, partisan_tpu_torch.prop_models, "
            "partisan_tpu_torch.metrics, partisan_tpu_torch.latency, "
            "partisan_tpu_torch.provenance, partisan_tpu_torch.control; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'partisan_tpu' "
            "or m.startswith('partisan_tpu.')]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run([sys.executable, "-E", "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"


def test_entry_points_default_to_cuda():
    cfg = TConfig(**bench_kwargs(THyParView, TPlumtreeCfg))
    if torch.cuda.is_available():
        assert TCluster(cfg, model=TPlumtree()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TCluster(cfg, model=TPlumtree())
        with pytest.raises(RuntimeError):
            state_io.state_from_numpy(())


@pytest.mark.parametrize("override", [
    dict(distance=object()), dict(watchdog=object()),
    dict(traffic=object(), latency=True),
    dict(ingress=object(), provenance=True), dict(plane_major=False),
    dict(salt_operand=True, metrics=True), dict(traffic=object()),
    dict(salt_operand=True),
    dict(elastic=True),
    dict(hyparview=THyParView(xbot=True)),
    dict(ingress=object()),
    dict(health=10, watchdog=object()),
    dict(peer_service_manager="xbot"),
])
def test_config_refuses_unported_options(override):
    kw = bench_kwargs(THyParView, TPlumtreeCfg)
    kw.update(override)
    with pytest.raises(NotImplementedError):
        TConfig(**kw)


@pytest.mark.parametrize("override", [
    dict(health=10), dict(health=3, health_ring=4),
    dict(peer_service_manager="scamp_v1"),
    dict(peer_service_manager="scamp_v2", membership_strategy="scamp_v2"),
    dict(peer_service_manager="static"),
    dict(peer_service_manager="client_server", cs_servers=3),
    dict(causal_labels=("chat",), n_actors=8, causal_buf_cap=4),
    dict(causal_p2p_labels=("p2p",), p2p_dst_cap=8, p2p_src_cap=8),
    dict(channel_capacity=True, lane_rate=3, outbox_cap=8),
    dict(metrics=True, metrics_ring=16), dict(latency=True, flight_rounds=8),
    dict(provenance=True, provenance_ring=16), dict(health=10, metrics=True),
    dict(health=5, control=TControlCfg(healing=True)),
])
def test_config_accepts_ported_options(override):
    from partisan_tpu_torch import managers
    from partisan_tpu_torch.config import ScampConfig as TScampCfg

    kw = bench_kwargs(THyParView, TPlumtreeCfg)
    kw.update(override, scamp=TScampCfg(partial_max=8))
    cfg = TConfig(**kw)
    assert managers.get(cfg.peer_service_manager).name.startswith(
        cfg.peer_service_manager.split("_")[0])
    width = managers.neighbor_width(cfg)
    assert width == {"hyparview": 6, "scamp_v1": 8, "scamp_v2": 8}.get(
        cfg.peer_service_manager, cfg.n_nodes)
    for bad in (dict(health=-1), dict(health_ring=0)):
        with pytest.raises(ValueError):
            TConfig(**{**kw, **bad})
