"""The provenance plane in the port against the JAX reference on the CPU:
every state leaf after every round of tests/test_provenance.py's setups
(randomized join topologies with random origins, crashes, a recovery and
link drop, for the Plumtree spec with hop and epoch words and the
hop-less rumor-mongering spec; a slot recycle resetting the forest; both
planes on, the wire ``msg_words + 3`` wide), the host readers
(``snapshot``, ``redundancy``, ``tree``, ``rows``) equal to the
reference's, the Stack's spec, ``mark_origin`` returning new tensors,
and the plane read-only against its off run.  Tolerance 0 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from partisan_tpu import provenance as jprov
from partisan_tpu.models.p2p_chat import P2PChat as JP2PChat
from partisan_tpu.models.plumtree import Plumtree as JPlumtree
from partisan_tpu.models.rumor_mongering import RumorMongering as JRumor
from partisan_tpu.models.stack import Stack as JStack
from partisan_tpu_torch import provenance as tprov
from partisan_tpu_torch import state_io
from partisan_tpu_torch.models.p2p_chat import P2PChat as TP2PChat
from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree
from partisan_tpu_torch.models.rumor_mongering import RumorMongering as TRumor
from partisan_tpu_torch.models.stack import Stack as TStack
from test_torch_cluster import assert_same
from test_torch_metrics import carry, lockstep, pair

torch.set_num_threads(1)

K = 6
CHANNELS = ("default", "partisan_membership", "rpc", "broadcast")


def pt_cfg(C, n=14, **kw):
    """tests/test_provenance.py's ``_pt_cfg``."""
    kw.setdefault("seed", 13)
    kw.setdefault("provenance_ring", 128)
    kw.setdefault("plumtree", C.PlumtreeConfig(push_slots=2, lazy_cap=4))
    return C.Config(n_nodes=n, peer_service_manager="hyparview",
                    msg_words=16, partition_mode="groups",
                    max_broadcasts=4, inbox_cap=16, provenance=True,
                    monotonic_shed=False, **kw)


def rumor_cfg(C):
    return C.Config(n_nodes=12, seed=7, peer_service_manager="hyparview",
                    msg_words=16, partition_mode="groups",
                    max_broadcasts=4, inbox_cap=16, provenance=True,
                    provenance_ring=128, monotonic_shed=False)


_CLUSTERS: dict = {}


def _pair(key):
    if key not in _CLUSTERS:
        if key == "pt":
            _CLUSTERS[key] = pair(pt_cfg, JPlumtree(), TPlumtree())
        else:
            _CLUSTERS[key] = pair(rumor_cfg, JRumor(), TRumor())
    return _CLUSTERS[key]


def _both(fn, js, ts):
    """Apply a scripted action to both states and check they agree."""
    js, ts = fn(js, "j"), fn(ts, "t")
    assert_same(js, ts, "after an action")
    return js, ts


def random_trial(key, rng, inject):
    """The reference's randomized trial: a random join order through
    already-joined contacts, 1-2 broadcasts from random origins into
    random slots (origins marked), maybe link drop, up to 2 crashes,
    maybe one recovery; every round in lockstep."""
    jcl, tcl = _pair(key)
    cfg = tcl.cfg
    n = cfg.n_nodes
    js, ts = jcl.init(), tcl.init()
    assert_same(js, ts, "init")
    joined = [0]
    jm, tm = js.manager, ts.manager
    for i in rng.permutation(np.arange(1, n)):
        c = int(rng.choice(joined))
        jm = jcl.manager.join(jcl.cfg, jm, int(i), c)
        tm = tcl.manager.join(cfg, tm, int(i), c)
        joined.append(int(i))
    js, ts = js._replace(manager=jm), ts._replace(manager=tm)
    js, ts = lockstep(jcl, tcl, js, ts, 3 * K, key)
    slots = rng.choice(cfg.max_broadcasts, size=int(rng.integers(1, 3)),
                       replace=False)
    for b in slots:
        node = int(rng.integers(0, n))
        start = int(ts.rnd)
        js = js._replace(model=inject(jcl, js.model, node, int(b), start),
                         provenance=jprov.mark_origin(
                             js.provenance, node, int(b), rnd=start))
        ts = ts._replace(model=inject(tcl, ts.model, node, int(b), start),
                         provenance=tprov.mark_origin(
                             ts.provenance, node, int(b), rnd=start))
        assert_same(js, ts, "broadcast")
        js, ts = lockstep(jcl, tcl, js, ts, K, key)
    if rng.random() < 0.5:
        js = js._replace(faults=js.faults._replace(
            link_drop=jnp.float32(float(rng.uniform(0.05, 0.2)))))
    victims = rng.choice(n, size=int(rng.integers(0, 3)), replace=False)
    alive = js.faults.alive
    for v in victims:
        alive = alive.at[int(v)].set(False)
    js = js._replace(faults=js.faults._replace(alive=alive))
    js, ts = lockstep(jcl, tcl, js, carry(js), 2 * K, key)
    if victims.size and rng.random() < 0.5:
        js = js._replace(faults=js.faults._replace(
            alive=js.faults.alive.at[int(victims[0])].set(True)))
        js, ts = lockstep(jcl, tcl, js, carry(js), K, key)
    return js, ts


def assert_readers_agree(js, ts):
    jsnap, tsnap = jprov.snapshot(js.provenance), tprov.snapshot(
        ts.provenance)
    assert jsnap.keys() == tsnap.keys()
    for k in jsnap:
        np.testing.assert_array_equal(jsnap[k], tsnap[k], err_msg=k)
    assert tprov.redundancy(tsnap) == jprov.redundancy(jsnap)
    assert tprov.rows(tsnap, channels=CHANNELS) \
        == jprov.rows(jsnap, channels=CHANNELS)
    for slot in range(tsnap["parent"].shape[1]):
        a, b = tprov.tree(tsnap, slot), jprov.tree(jsnap, slot)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_plumtree_randomized_overlays_bit_identical():
    rng = np.random.default_rng(42)
    gossip = dup = 0
    for _ in range(2):
        js, ts = random_trial(
            "pt", rng, lambda cl, m, node, b, start:
            cl.model.broadcast(m, node, b, start))
        assert_readers_agree(js, ts)
        snap = tprov.snapshot(ts.provenance)
        gossip += snap["gossip_total"]
        dup += snap["dup_total"]
    assert gossip > 0 and dup > 0


def test_rumor_randomized_overlays_bit_identical():
    """The hop-less spec: every non-root claim lands at hop 1."""
    rng = np.random.default_rng(11)
    gossip = 0
    for _ in range(2):
        js, ts = random_trial(
            "rumor", rng, lambda cl, m, node, b, start:
            cl.model.broadcast(m, node, b))
        assert_readers_agree(js, ts)
        snap = tprov.snapshot(ts.provenance)
        gossip += snap["gossip_total"]
        claimed = snap["parent"] >= 0
        own = snap["parent"] == np.arange(12)[:, None]
        assert (snap["hop"][claimed & ~own] == 1).all()
    assert gossip > 0


def test_slot_recycle_epoch_resets_forest_entry():
    jcl, tcl = _pair("pt")
    js, ts = jcl.init(), tcl.init()
    jm, tm = js.manager, ts.manager
    for i in range(1, 14):
        jm = jcl.manager.join(jcl.cfg, jm, i, 0)
        tm = tcl.manager.join(tcl.cfg, tm, i, 0)
    js, ts = lockstep(jcl, tcl, js._replace(manager=jm),
                      ts._replace(manager=tm), 3 * K, "recycle boot")
    start = int(ts.rnd)

    def first(st, side):
        cl, pm = (jcl, jprov) if side == "j" else (tcl, tprov)
        return st._replace(model=cl.model.broadcast(st.model, 0, 0, start),
                           provenance=pm.mark_origin(st.provenance, 0, 0,
                                                     rnd=start))

    js, ts = _both(first, js, ts)
    js, ts = lockstep(jcl, tcl, js, ts, 3 * K, "recycle first")
    assert (tprov.snapshot(ts.provenance)["parent"][:, 0] >= 0).sum() > 1
    start = int(ts.rnd)
    js = js._replace(model=jcl.model.broadcast(js.model, 5, 0, start + 1,
                                               fresh=True))
    ts = ts._replace(model=tcl.model.broadcast(ts.model, 5, 0, start + 1,
                                               fresh=True))
    ep = int(ts.model.epoch[5, 0])
    assert ep > 0

    def remark(st, side):
        pm = jprov if side == "j" else tprov
        return st._replace(provenance=pm.mark_origin(
            st.provenance, 5, 0, rnd=start, epoch=ep))

    js, ts = _both(remark, js, ts)
    js, ts = lockstep(jcl, tcl, js, ts, 3 * K, "recycle second")
    assert_readers_agree(js, ts)
    snap = tprov.snapshot(ts.provenance)
    assert (snap["epoch"][:, 0] == ep).sum() > 1
    assert snap["parent"][5, 0] == 5 and snap["hop"][5, 0] == 0


def test_both_planes_wire_layout_bit_identical():
    """Provenance and latency on: the pair at msg_words and msg_words+1
    (int16 hop), the birth word last; the latency histograms still
    reconcile with the metrics ring."""
    from partisan_tpu_torch import latency as tlat
    from partisan_tpu_torch import metrics as tmet

    jcl, tcl = pair(lambda C: pt_cfg(C, latency=True, metrics=True,
                                     metrics_ring=64),
                    JPlumtree(), TPlumtree())
    cfg = tcl.cfg
    assert cfg.wire_words == cfg.msg_words + 3
    assert tprov.src_word(cfg) == 16 and tprov.hop_word(cfg) == 17
    assert cfg.wire_dtypes[17] == torch.int16
    js, ts = jcl.init(), tcl.init()
    jm, tm = js.manager, ts.manager
    for i in range(1, 14):
        jm = jcl.manager.join(jcl.cfg, jm, i, 0)
        tm = tcl.manager.join(cfg, tm, i, 0)
    js, ts = lockstep(jcl, tcl, js._replace(manager=jm),
                      ts._replace(manager=tm), 12, "wire")
    js = js._replace(model=jcl.model.broadcast(js.model, 0, 0, 12),
                     provenance=jprov.mark_origin(js.provenance, 0, 0,
                                                  rnd=12))
    js, ts = lockstep(jcl, tcl, js, carry(js), 12, "wire")
    assert len(ts.inbox.data) == 19
    lsnap, msnap = tlat.snapshot(ts.latency), tmet.snapshot(ts.metrics)
    assert (lsnap["deliver"].sum(axis=1)
            == msnap["delivered"].sum(axis=0)).all()
    assert tprov.snapshot(ts.provenance)["gossip_total"] > 0
    assert_readers_agree(js, ts)


def test_provenance_plane_is_read_only():
    """Every protocol leaf of a provenance run equals the off run's, and
    the inbox's first msg_words words agree."""
    from partisan_tpu_torch import config as tconfig
    from partisan_tpu_torch.cluster import Cluster as TCluster

    def drive(on):
        cl = TCluster(pt_cfg(tconfig, 18).replace(provenance=on),
                      model=TPlumtree(), device="cpu")
        st = cl.init()
        m = st.manager
        for i in range(1, 18):
            m = cl.manager.join(cl.cfg, m, i, 0)
        st = cl.steps(st._replace(manager=m), 12)
        st = st._replace(model=cl.model.broadcast(st.model, 0, 0, 12))
        al = st.faults.alive.clone()
        al[5] = False
        st = st._replace(faults=st.faults._replace(
            alive=al, link_drop=torch.tensor(0.1)))
        return cl.steps(st, 12)

    off, on = drive(False), drive(True)
    assert off.provenance == () and on.provenance != ()
    for name in ("rnd", "manager", "model", "stats", "faults", "delivery"):
        for (p, a), (_, b) in zip(
                state_io.flatten(state_io.state_to_numpy(
                    getattr(off, name)), name),
                state_io.flatten(state_io.state_to_numpy(
                    getattr(on, name)), name)):
            np.testing.assert_array_equal(a, b, err_msg=p)
    w = len(off.inbox.data)
    for a, b in zip(off.inbox.data, on.inbox.data[:w]):
        assert torch.equal(a, b)
    assert torch.equal(off.inbox.count, on.inbox.count)


def test_stack_spec_and_mark_origin_copies():
    """Stack takes its first sub-model's spec; ``mark_origin`` returns
    new tensors and leaves its input as it was."""
    assert tuple(TStack([TPlumtree(), TP2PChat()]).prov_spec) \
        == tuple(JStack([JPlumtree(), JP2PChat()]).prov_spec)
    assert TStack([TP2PChat()]).prov_spec is None
    assert tuple(TRumor().prov_spec) == tuple(JRumor().prov_spec)
    assert tprov.CTL_KINDS == jprov.CTL_KINDS
    _, tcl = _pair("pt")
    ps = tcl.init().provenance
    before = state_io.state_to_numpy(ps)
    out = tprov.mark_origin(ps, 3, 1, rnd=9, epoch=2)
    for (p, a), (_, b) in zip(state_io.flatten(before), state_io.flatten(
            state_io.state_to_numpy(ps))):
        np.testing.assert_array_equal(a, b, err_msg=p)
    j = jprov.mark_origin(
        jax.tree_util.tree_map(jnp.asarray, before), 3, 1, rnd=9, epoch=2)
    for (p, a), b in zip(state_io.flatten(state_io.state_to_numpy(out)),
                         jax.tree_util.tree_leaves(j)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=p)
