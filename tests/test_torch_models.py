"""Model and small-manager parity: anti-entropy over the full mesh (the
README Quick start), rumor mongering over HyParView, and the static and
client-server managers (the cases of tests/test_static_client_server.py)
— the PyTorch port against the JAX reference on the CPU, every state
leaf bit for bit (tolerance 0) after every execution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.models.anti_entropy import AntiEntropy as JAntiEntropy
from partisan_tpu.models.rumor_mongering import RumorMongering as JRumor
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.models.anti_entropy import AntiEntropy as TAntiEntropy
from partisan_tpu_torch.models.rumor_mongering import RumorMongering as TRumor

from test_torch_cluster import assert_same

torch.set_num_threads(1)

K_PROG = 10


def pair(jmodel, tmodel, **kw):
    jcl = JCluster(JConfig(**kw), model=jmodel)
    tcl = TCluster(TConfig(**kw), model=tmodel, device="cpu")
    js = jcl.init()
    ts = state_io.state_from_numpy(jax.device_get(js), device="cpu")
    assert_same(js, tcl.init(), "port init")
    return jcl, tcl, js, ts


def lockstep(jcl, tcl, js, ts, execs, label, k=K_PROG):
    for i in range(execs):
        js, ts = jcl.steps(js, k), tcl.steps(ts, k)
        assert_same(js, ts, f"{label} exec {i}")
    return js, ts


def test_quick_start_anti_entropy_full_mesh():
    """The README Quick start at n=16: both ``run_until`` calls stop on
    the same round with identical states."""
    jm, tm = JAntiEntropy(), TAntiEntropy()
    jcl, tcl, js, ts = pair(jm, tm, n_nodes=16, seed=4)
    for i in range(1, 16):
        js = js._replace(manager=jcl.manager.join(jcl.cfg, js.manager, i, 0))
        ts = ts._replace(manager=tcl.manager.join(tcl.cfg, ts.manager, i, 0))
    assert_same(js, ts, "joined")
    js, jr = jcl.run_until(
        js, lambda s: bool(jnp.all(jcl.manager.members(jcl.cfg, s.manager))),
        300)
    ts, tr = tcl.run_until(
        ts, lambda s: bool(tcl.manager.members(tcl.cfg, s.manager).all()),
        300)
    assert jr == tr != -1
    assert_same(js, ts, "membership converged")
    js = js._replace(model=jm.broadcast(js.model, node=5, slot=0))
    ts = ts._replace(model=tm.broadcast(ts.model, node=5, slot=0))
    js, jr2 = jcl.run_until(
        js, lambda s: float(jm.coverage(s.model, s.faults.alive, 0)) == 1.0,
        100)
    ts, tr2 = tcl.run_until(
        ts, lambda s: float(tm.coverage(s.model, s.faults.alive, 0)) == 1.0,
        100)
    assert jr2 == tr2 > tr
    assert_same(js, ts, "broadcast covered")
    lockstep(jcl, tcl, js, ts, 2, "after coverage")


def test_anti_entropy_under_crash_and_drop():
    jm, tm = JAntiEntropy(), TAntiEntropy()
    jcl, tcl, js, ts = pair(jm, tm, n_nodes=24, seed=9, max_broadcasts=4)
    for i in range(1, 24):
        js = js._replace(manager=jcl.manager.join(jcl.cfg, js.manager, i,
                                                  i // 3))
        ts = ts._replace(manager=tcl.manager.join(tcl.cfg, ts.manager, i,
                                                  i // 3))
    js, ts = lockstep(jcl, tcl, js, ts, 2, "boot")
    from partisan_tpu import faults as jf
    from partisan_tpu_torch import faults as tf
    js = js._replace(faults=jf.crash_many(js.faults, [3, 11])._replace(
        link_drop=jnp.float32(0.2)),
        model=jm.broadcast(jm.broadcast(js.model, 0, 0), 17, 3))
    ts = ts._replace(faults=tf.set_link_drop(
        tf.crash_many(ts.faults, [3, 11]), 0.2),
        model=tm.broadcast(tm.broadcast(ts.model, 0, 0), 17, 3))
    lockstep(jcl, tcl, js, ts, 3, "faulted", k=7)


def test_rumor_mongering_over_hyparview():
    jm, tm = JRumor(), TRumor()
    n = 64
    jcl, tcl, js, ts = pair(jm, tm, n_nodes=n, seed=2,
                            peer_service_manager="hyparview", msg_words=16,
                            partition_mode="groups", max_broadcasts=8)
    nodes = np.arange(1, n, dtype=np.int32)
    tgts = (nodes // 4).astype(np.int32)
    js = js._replace(manager=jcl.manager.join_many(jcl.cfg, js.manager,
                                                   nodes, tgts))
    ts = ts._replace(manager=tcl.manager.join_many(tcl.cfg, ts.manager,
                                                   nodes, tgts))
    js, ts = lockstep(jcl, tcl, js, ts, 3, "boot")
    js = js._replace(model=jm.broadcast(jm.broadcast(
        jm.broadcast(js.model, 0, 0), 0, 1), 40, 2))
    ts = ts._replace(model=tm.broadcast(tm.broadcast(
        tm.broadcast(ts.model, 0, 0), 0, 1), 40, 2))
    js, ts = lockstep(jcl, tcl, js, ts, 3, "rumors")
    for slot in range(3):
        jc = float(jm.coverage(js.model, js.faults.alive, slot))
        tc = float(tm.coverage(ts.model, ts.faults.alive, slot))
        assert jc == tc > 0.0


def test_static_explicit_joins_and_leave():
    jcl, tcl, js, ts = pair(None, None, n_nodes=8, seed=1,
                            peer_service_manager="static")
    for a, b in ((1, 0), (2, 0), (5, 4), (6, 5)):
        js = js._replace(manager=jcl.manager.join(jcl.cfg, js.manager, a, b))
        ts = ts._replace(manager=tcl.manager.join(tcl.cfg, ts.manager, a, b))
    js, ts = lockstep(jcl, tcl, js, ts, 3, "static")
    js = js._replace(manager=jcl.manager.leave(jcl.cfg, js.manager, 5))
    ts = ts._replace(manager=tcl.manager.leave(tcl.cfg, ts.manager, 5))
    js, ts = lockstep(jcl, tcl, js, ts, 1, "static leave")
    for fn in ("members", "neighbors"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jcl.manager, fn)(jcl.cfg, js.manager)),
            getattr(tcl.manager, fn)(tcl.cfg, ts.manager).numpy())


def boot_star(cl, st, servers):
    """Servers full-mesh each other; client i joins server i % S; one
    refused client-client join."""
    m = st.manager
    for a in range(servers):
        for b in range(a + 1, servers):
            m = cl.manager.join(cl.cfg, m, a, b)
    for c in range(servers, cl.cfg.n_nodes):
        m = cl.manager.join(cl.cfg, m, c, c % servers)
    m = cl.manager.join(cl.cfg, m, 5, 7)
    return st._replace(manager=m)


@pytest.mark.parametrize("servers,seed", [(3, 7), (2, 19)])
def test_client_server_gossip_and_dissemination(servers, seed):
    """Membership gossip over the star, a client leave, then a client's
    anti-entropy broadcast reaching every client through the servers."""
    jm, tm = JAntiEntropy(), TAntiEntropy()
    jcl, tcl, js, ts = pair(jm, tm, n_nodes=12, seed=seed,
                            peer_service_manager="client_server",
                            cs_servers=servers)
    js, ts = boot_star(jcl, js, servers), boot_star(tcl, ts, servers)
    assert_same(js, ts, "star")
    js, ts = lockstep(jcl, tcl, js, ts, 4, "gossip")
    assert bool(tcl.manager.members(tcl.cfg, ts.manager).all())
    js = js._replace(manager=jcl.manager.leave(jcl.cfg, js.manager, 9),
                     model=jm.broadcast(js.model, 7, 0))
    ts = ts._replace(manager=tcl.manager.leave(tcl.cfg, ts.manager, 9),
                     model=tm.broadcast(ts.model, 7, 0))
    js, ts = lockstep(jcl, tcl, js, ts, 2, "broadcast", k=5)
    np.testing.assert_array_equal(
        np.asarray(jcl.manager.neighbors(jcl.cfg, js.manager)),
        tcl.manager.neighbors(tcl.cfg, ts.manager).numpy())
