"""The in-round controllers in the port against the JAX reference on the
CPU: every state leaf after every round of tests/test_control.py's calm
closed-loop round (every plane, channel capacity and all three
controllers on), config 8's overload arm with backpressure cut short,
the readers (``shed_age``, ``poll``, ``snapshot``,
``decisions``), the calm run's flag-on leaves equal to the flag-off
run's, and the configuration checks.  Tolerance 0 throughout.  The
fanout and healing arms are in test_torch_control_arms.py."""

import jax
import numpy as np
import pytest
import torch

import partisan_tpu.config as jconfig
import partisan_tpu_torch.config as tconfig
from partisan_tpu import control as jcontrol
from partisan_tpu import scenarios as jsc
from partisan_tpu.models.plumtree import Plumtree as JPlumtree
from partisan_tpu_torch import control as tcontrol
from partisan_tpu_torch import scenarios as tsc
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree
from test_torch_cluster import assert_same
from test_torch_metrics import carry, join_all, lockstep, pair

torch.set_num_threads(1)


def all_cfg(C, ctl, n=32):
    """Every plane + channel capacity: the closed-loop round's shape
    (tests/test_control.py's ``_all_cfg``)."""
    return C.Config(n_nodes=n, seed=5, peer_service_manager="hyparview",
                    msg_words=16, partition_mode="groups",
                    provenance=True, provenance_ring=64,
                    latency=True, channel_capacity=True,
                    health=5, health_ring=32, max_broadcasts=8, control=ctl)


def on_ctl(C, ring=16):
    return C.ControlConfig(fanout=True, backpressure=True, healing=True,
                           ring=ring)


def assert_arm(j, t, label):
    """An A/B arm's dict equal on both sides; its state too, if kept."""
    js, ts = j.pop("_state", None), t.pop("_state", None)
    assert j == t, (label, j, t)
    if js is not None:
        assert_same(js, ts, label)


def test_controller_prerequisites_validated():
    for C in (jconfig, tconfig):
        with pytest.raises(ValueError, match="provenance"):
            C.Config(control=C.ControlConfig(fanout=True))
        with pytest.raises(ValueError, match="latency"):
            C.Config(channel_capacity=True,
                     control=C.ControlConfig(backpressure=True))
        with pytest.raises(ValueError, match="channel_capacity"):
            C.Config(latency=True,
                     control=C.ControlConfig(backpressure=True))
        with pytest.raises(ValueError, match="health"):
            C.Config(control=C.ControlConfig(healing=True))
        for bad in (dict(ring=0), dict(fanout_min=0), dict(press_max=0),
                    dict(heal_boost=-1), dict(fanout_lo_pct=40),
                    dict(fanout_every=0), dict(age_lo=4)):
            with pytest.raises(ValueError):
                all_cfg(C, C.ControlConfig(fanout=True, backpressure=True,
                                           healing=True, **bad))
        all_cfg(C, on_ctl(C))
    assert tconfig.Config().control == tconfig.ControlConfig()
    assert not tconfig.ControlConfig().any


def test_calm_closed_loop_bit_identical_and_inert():
    """On a settled overlay every plane and controller runs, leaf for
    leaf against JAX after every round; no threshold is crossed, so the
    flag-on run's non-control leaves equal the flag-off run's."""
    jcl_off, tcl_off = pair(lambda C: all_cfg(C, C.ControlConfig()),
                            JPlumtree(), TPlumtree())
    jcl_on, tcl_on = pair(lambda C: all_cfg(C, on_ctl(C)),
                          JPlumtree(), TPlumtree())
    js = join_all(jcl_off, jcl_off.init())
    for _ in range(3):
        js = jcl_off.steps(js, 20)
    js_on = js._replace(control=jcontrol.init(jcl_on.cfg))
    ts_on = carry(js_on)
    assert_same(js_on, ts_on._replace(
        control=tcontrol.init(tcl_on.cfg)), "fresh controllers")
    _, ts_on = lockstep(jcl_on, tcl_on, js_on, ts_on, 20, "calm on")
    ts_off = tcl_off.steps(carry(js), 20)
    k = ts_on.control
    assert int(k.fanout.eager_cap) == 6
    assert int(k.backpressure.press.max()) == 0
    assert int(k.healing.boost) == 0
    for (p, a), (_, b) in zip(
            state_io.flatten(state_io.state_to_numpy(ts_off)),
            state_io.flatten(state_io.state_to_numpy(
                ts_on._replace(control=())))):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_backpressure_arm_bit_identical():
    """Config 8's adaptive arm cut to n=32 and two waves: the stale
    sheds fire and the books equal the reference's."""
    j = jsc.config8_overload(n=32, waves=2, adaptive=True)
    t = tsc.config8_overload(n=32, waves=2, adaptive=True, device="cpu")
    assert j == t
    assert t["outbox_shed"] > 0


def test_readers_match_reference():
    """``shed_age``'s pressure map, ``decisions`` over a synthetic
    snapshot, and ``poll``/``snapshot`` on a fresh closed-loop state."""
    tcfg = all_cfg(tconfig, tconfig.ControlConfig(backpressure=True,
                                                  age_hi=8, press_max=5))
    jcfg = all_cfg(jconfig, jconfig.ControlConfig(backpressure=True,
                                                  age_hi=8, press_max=5))
    tbp = tcontrol.init(tcfg, device="cpu").backpressure
    jbp = jcontrol.init(jcfg).backpressure
    for press in range(6):
        a = tcontrol.shed_age(tcfg, tbp._replace(
            press=torch.full_like(tbp.press, press)))
        b = jcontrol.shed_age(jcfg, jbp._replace(
            press=jbp.press * 0 + press))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    snap = {
        "fanout": {"rounds": np.asarray([10, 11, 12, 13]),
                   "cap": np.asarray([6, 5, 5, 4])},
        "backpressure": {"rounds": np.asarray([10, 11, 12]),
                         "press": np.asarray([[0, 0], [0, 1], [0, 1]])},
        "healing": {"rounds": np.asarray([10, 11, 12]),
                    "boost": np.asarray([0, 2, 0])},
    }
    for ch in (None, ("default",), ("default", "bulk")):
        assert tcontrol.decisions(snap, channels=ch) \
            == jcontrol.decisions(snap, channels=ch)
    cl = TCluster(all_cfg(tconfig, on_ctl(tconfig)), model=TPlumtree(),
                  device="cpu")
    st = cl.init()
    jst = jax.tree_util.tree_map(np.asarray,
                                 state_io.state_to_numpy(st.control))
    assert tcontrol.poll(st.control) == jcontrol.poll(jst)
    a, b = tcontrol.snapshot(st.control), jcontrol.snapshot(jst)
    assert a.keys() == b.keys()
    for k in a:
        for f in a[k]:
            np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=k + f)
