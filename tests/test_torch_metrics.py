"""The metrics plane in the port against the JAX reference on the CPU:
every state leaf after every round of tests/test_metrics.py's setups
(the faulted HyParView + Plumtree run with a tight inbox, where every
hot drop cause fires; the 16-node full mesh through an 8-slot ring),
the cause books closing against ``Stats`` per round, the host readers
(``snapshot``, ``rows``, ``totals``, ``ring_order``) equal to the
reference's, the plane read-only against its off run, and the
configuration checks.  Tolerance 0 throughout.

``lockstep``, ``pair`` and ``carry`` here serve the other plane parity
files too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import partisan_tpu.config as jconfig
import partisan_tpu_torch.config as tconfig
from partisan_tpu import metrics as jmetrics
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.models.plumtree import Plumtree as JPlumtree
from partisan_tpu_torch import metrics as tmetrics
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree
from test_torch_cluster import assert_same

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def pair(make_cfg, jmodel=None, tmodel=None, **tkw):
    """The same configuration in both packages: ``make_cfg(config
    module)`` builds it; returns (JAX cluster, port cluster on the
    CPU)."""
    jcl = JCluster(make_cfg(jconfig), model=jmodel, **tkw)
    tcl = TCluster(make_cfg(tconfig), model=tmodel, device="cpu", **tkw)
    return jcl, tcl


def carry(js):
    """A JAX state carried into the port."""
    return state_io.state_from_numpy(jax.device_get(js), device="cpu")


def lockstep(jcl, tcl, js, ts, rounds, label):
    """``rounds`` rounds on both sides, every leaf compared after each."""
    for _ in range(rounds):
        js, ts = jcl.step(js), tcl.step(ts)
        assert_same(js, ts, f"{label} round {int(ts.rnd)}")
    return js, ts


def join_all(cl, st):
    n = cl.cfg.n_nodes
    return st._replace(manager=cl.manager.join_many(
        cl.cfg, st.manager, list(range(1, n)), [0] * (n - 1)))


def faulted_cfg(C, n=64, **kw):
    """tests/test_metrics.py's faulted HyParView + Plumtree config."""
    return C.Config(n_nodes=n, seed=5, peer_service_manager="hyparview",
                    msg_words=16, partition_mode="groups",
                    max_broadcasts=4, inbox_cap=8,
                    plumtree=C.PlumtreeConfig(push_slots=2, lazy_cap=4),
                    **kw)


def faulted_run(make_cfg, boot=20, rounds=40, label="faulted",
                with_jax=True):
    """Join-all boot, a broadcast from node 0, two crashes and 10% link
    drop, in lockstep; returns both final states (the JAX one None
    without ``with_jax``: the port alone, for the read-only checks)."""
    tcl = TCluster(make_cfg(tconfig), model=TPlumtree(), device="cpu")
    ts = join_all(tcl, tcl.init())
    if not with_jax:
        ts = tcl.steps(ts, boot)
        ts = ts._replace(model=tcl.model.broadcast(ts.model, 0, 0, 7))
        alive = ts.faults.alive.clone()
        alive[[5, 17]] = False
        ts = ts._replace(faults=ts.faults._replace(
            alive=alive, link_drop=torch.tensor(0.1)))
        return None, tcl.steps(ts, rounds)
    jcl = JCluster(make_cfg(jconfig), model=JPlumtree())
    js = join_all(jcl, jcl.init())
    assert_same(js, ts, f"{label} init")
    js, ts = lockstep(jcl, tcl, js, carry(js), boot, label)
    js = js._replace(model=jcl.model.broadcast(js.model, 0, 0, 7))
    ts = ts._replace(model=tcl.model.broadcast(ts.model, 0, 0, 7))
    alive = js.faults.alive.at[jnp.asarray([5, 17])].set(False)
    js = js._replace(faults=js.faults._replace(
        alive=alive, link_drop=jnp.float32(0.1)))
    ts = carry(js)
    return lockstep(jcl, tcl, js, ts, rounds, label)


_CACHE: dict = {}


def _faulted():
    if "faulted" not in _CACHE:
        _CACHE["faulted"] = faulted_run(
            lambda C: faulted_cfg(C, metrics=True, metrics_ring=256))
    return _CACHE["faulted"]


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

def test_faulted_run_bit_identical_and_books_close():
    js, ts = _faulted()
    jsnap = jmetrics.snapshot(js.metrics)
    tsnap = tmetrics.snapshot(ts.metrics)
    assert jsnap.keys() == tsnap.keys()
    for k in jsnap:
        np.testing.assert_array_equal(jsnap[k], tsnap[k], err_msg=k)
    tot = tmetrics.totals(tsnap)
    assert tot == jmetrics.totals(jsnap)
    assert tot["rounds"] == 60
    assert tot["emitted"] == int(ts.stats.emitted)
    assert tot["delivered"] == int(ts.stats.delivered)
    assert tot["dropped"] == int(ts.stats.dropped)
    assert tot["drops_by_cause"]["fault_cut"] > 0
    assert tot["drops_by_cause"]["inbox_overflow"] > 0
    assert tot["drops_by_cause"]["other"] == 0
    per_round = tsnap["emitted"].sum(axis=1) - tsnap["delivered"].sum(axis=1)
    assert (tsnap["drops"].sum(axis=1) == per_round).all()
    assert tsnap["alive"][-1] == 62


def test_rows_match_reference():
    js, ts = _faulted()
    names = ("default", "partisan_membership", "rpc", "broadcast")
    assert tmetrics.rows(tmetrics.snapshot(ts.metrics), channels=names) \
        == jmetrics.rows(jmetrics.snapshot(js.metrics), channels=names)


def test_ring_wraparound_bit_identical():
    """20 rounds through an 8-slot ring keep rounds 12..19, and a run
    shorter than the ring reports only what ran."""
    def mk(C):
        return C.Config(n_nodes=16, seed=1, metrics=True, metrics_ring=8)

    jcl, tcl = pair(mk)
    jm, tm = jcl.init().manager, tcl.init().manager
    for i in range(1, 16):
        jm = jcl.manager.join(jcl.cfg, jm, i, 0)
        tm = tcl.manager.join(tcl.cfg, tm, i, 0)
    js, ts = jcl.init()._replace(manager=jm), tcl.init()._replace(manager=tm)
    assert_same(js, ts, "ring init")
    js, ts = lockstep(jcl, tcl, js, ts, 20, "ring")
    assert tmetrics.snapshot(ts.metrics)["rounds"].tolist() \
        == list(range(12, 20))
    short = tcl.steps(tcl.init()._replace(manager=tm), 3)
    assert tmetrics.snapshot(short.metrics)["rounds"].tolist() == [0, 1, 2]
    rnd = np.array([5, -1, 3, 4, -1])
    assert tmetrics.ring_order(rnd).tolist() \
        == jmetrics.ring_order(rnd).tolist()


def test_metrics_plane_is_read_only():
    """Every leaf but the ring equals the plane-off run's."""
    js_on, ts_on = _faulted()
    _, ts_off = faulted_run(lambda C: faulted_cfg(C), with_jax=False)
    assert ts_off.metrics == ()
    for (p, a), (_, b) in zip(
            state_io.flatten(state_io.state_to_numpy(ts_off)),
            state_io.flatten(state_io.state_to_numpy(
                ts_on._replace(metrics=())))):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_config_checks_and_defaults():
    for C in (jconfig, tconfig):
        with pytest.raises(ValueError, match="metrics_ring"):
            C.Config(metrics=True, metrics_ring=0)
    cfg = tconfig.Config(n_nodes=16, seed=1)
    st = TCluster(cfg, device="cpu").init()
    assert st.metrics == () and st.latency == () and st.flight == ()
    assert st.provenance == () and st.control == ()
    assert tmetrics.CAUSE_NAMES == jmetrics.CAUSE_NAMES
    assert tmetrics.N_CAUSES == jmetrics.N_CAUSES
