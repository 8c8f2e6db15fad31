"""Health-plane parity: the PyTorch port's graph kernels and snapshot
ring against the JAX reference on the CPU, bit for bit (tolerance 0),
and the component counts against the host BFS oracle
(tests/support.components)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import support
from partisan_tpu import faults as jf
from partisan_tpu import health as jh
from partisan_tpu import scenarios as jsc
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.config import Config as JConfig
from partisan_tpu.config import HyParViewConfig as JHyParView
from partisan_tpu.config import PlumtreeConfig as JPlumtreeCfg
from partisan_tpu.config import ScampConfig as JScampCfg
from partisan_tpu.models.plumtree import Plumtree as JPlumtree
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch import health as th
from partisan_tpu_torch import scenarios as tsc
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.config import HyParViewConfig as THyParView
from partisan_tpu_torch.config import PlumtreeConfig as TPlumtreeCfg
from partisan_tpu_torch.config import ScampConfig as TScampCfg
from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree

from test_torch_cluster import assert_same, bench_kwargs

torch.set_num_threads(1)

K_PROG = 10


def overlay(rng, kind, n, k):
    """A directed neighbor table int32[n, k] (no self edges), an alive
    mask and a partition (None, groups int32[n] or dense bool[n, n])."""
    if kind == "path":
        nbrs = np.full((n, k), -1, np.int32)
        order = rng.permutation(n)
        nbrs[order[1:], 0] = order[:-1]
        alive = np.ones(n, bool)
        alive[order[n // 3]] = False
        return nbrs, alive, None
    nbrs = rng.integers(-1, n, size=(n, k)).astype(np.int32)
    if kind == "symmetric":   # mostly mutual edges, a few half-open
        for i in range(n):
            for j in nbrs[i]:
                if j >= 0 and rng.random() < 0.9:
                    nbrs[j, rng.integers(k)] = i
    nbrs = np.where(nbrs == np.arange(n)[:, None], -1, nbrs)
    alive = np.ones(n, bool)
    if kind != "symmetric":
        alive = rng.random(n) > rng.uniform(0.05, 0.4)
    part = None
    if kind == "groups":
        part = rng.integers(0, 3, size=n).astype(np.int32)
    elif kind == "dense":
        part = np.zeros((n, n), bool)
        a = rng.random(n) < 0.4
        part[np.ix_(a, ~a)] = True
        part[np.ix_(~a, a)] = True
    return nbrs, alive, part


@pytest.mark.parametrize("kind,n,k", [
    ("random", 200, 3), ("random", 150, 7), ("symmetric", 120, 6),
    ("groups", 160, 4), ("dense", 96, 5), ("path", 200, 2),
    ("random", 4200, 64),
])
def test_graph_kernels_parity(kind, n, k, monkeypatch):
    """Component labels and count, out-degrees, the degree histogram and
    the symmetry count — one-shot and slot-wise — on random, faulted,
    partitioned and path overlays (the last one wide enough that both
    sides take the slot-wise symmetry branch on their own)."""
    rng = np.random.default_rng(n * 10 + k)
    for trial in range(3 if n < 1000 else 1):
        nbrs, alive, part = overlay(rng, kind, n, k)
        jargs = [jnp.asarray(nbrs), jnp.asarray(alive)] + (
            [] if part is None else [jnp.asarray(part)])
        targs = [torch.from_numpy(nbrs), torch.from_numpy(alive)] + (
            [] if part is None else [torch.from_numpy(part)])
        jl, jc = jh.component_count(*jargs)
        tl, tc = th.component_count(*targs)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        assert int(jc) == int(tc) == len(support.components(
            nbrs, alive, partition=part)), (kind, trial)
        deg = th.out_degrees(*targs)
        np.testing.assert_array_equal(np.asarray(jh.out_degrees(*jargs)),
                                      deg.numpy())
        np.testing.assert_array_equal(
            np.asarray(jh.degree_histogram(jnp.asarray(deg.numpy()),
                                           jnp.asarray(alive))),
            th.degree_histogram(deg, targs[1]).numpy())
        want = int(jh.symmetry_violations(*jargs))
        assert int(th.symmetry_violations(*targs)) == want
        monkeypatch.setattr(th, "SYM_ONESHOT_ELEMS", 0)
        assert int(th.symmetry_violations(*targs)) == want
        monkeypatch.undo()
        if kind == "symmetric":
            assert 0 < want < int(deg.sum())


def test_digest_helpers_parity():
    rng = np.random.default_rng(1)
    for _ in range(50):
        comps, iso, dmin, n_alive = (int(x) for x in rng.integers(
            0, [70000, 200, 8, 3]))
        cov = bool(rng.integers(2))
        w = int(jh.pack_digest(jnp.int32(comps), jnp.int32(iso),
                               jnp.int32(dmin), jnp.int32(n_alive), 3, cov))
        got = int(th.pack_digest(torch.tensor(comps, dtype=torch.int32),
                                 torch.tensor(iso, dtype=torch.int32),
                                 torch.tensor(dmin, dtype=torch.int32),
                                 torch.tensor(n_alive, dtype=torch.int32),
                                 3, cov))
        assert got == w
        assert th.decode_digest(w) == jh.decode_digest(w)
        for fn in ("healthy", "overlay_ok", "digest_converged",
                   "digest_components"):
            assert getattr(th, fn)(w) == getattr(jh, fn)(w), fn


def hv_pair(n, health, ring, manager="hyparview", model=True):
    kw = dict(n_nodes=n, seed=3, peer_service_manager=manager,
              msg_words=16, partition_mode="groups", health=health,
              health_ring=ring, max_broadcasts=4)
    jkw, tkw = dict(kw), dict(kw)
    if manager.startswith("scamp"):
        jkw["scamp"] = JScampCfg(partial_max=16, in_max=16)
        tkw["scamp"] = TScampCfg(partial_max=16, in_max=16)
    jm, tm = (JPlumtree(), TPlumtree()) if model else (None, None)
    jcl = JCluster(JConfig(**jkw), model=jm)
    tcl = TCluster(TConfig(**tkw), model=tm, device="cpu")
    return jcl, tcl, jm, tm


@pytest.mark.parametrize("manager,health,ring", [
    ("hyparview", K_PROG, 64), ("hyparview", 7, 4), ("scamp_v2", K_PROG, 8),
])
def test_ring_bit_identical_after_every_execution(manager, health, ring):
    """The ring at the K_PROG cadence, and at a cadence that does not
    divide it wrapping a 4-slot ring: bootstrap, a broadcast (the coverage
    bit), crashes and a groups partition (churn, components), heal —
    every leaf after every execution, then the host readers."""
    n = 48
    model = manager == "hyparview"
    jcl, tcl, jm, tm = hv_pair(n, health, ring, manager, model)
    js = jcl.init()
    ts = state_io.state_from_numpy(jax.device_get(js), device="cpu")
    assert_same(js, tcl.init(), "port init")
    nodes = np.arange(1, n, dtype=np.int32)
    tgts = (nodes // 3).astype(np.int32)
    js = js._replace(manager=jcl.manager.join_many(jcl.cfg, js.manager,
                                                   nodes, tgts))
    ts = ts._replace(manager=tcl.manager.join_many(tcl.cfg, ts.manager,
                                                   nodes, tgts))

    def run(js, ts, execs, label):
        for i in range(execs):
            js, ts = jcl.steps(js, K_PROG), tcl.steps(ts, K_PROG)
            assert_same(js, ts, f"{label} exec {i}")
            assert th.digest(ts) == jh.digest(js)
        return js, ts

    js, ts = run(js, ts, 3, "boot")
    if model:
        r0 = int(js.rnd)
        js = js._replace(model=jm.broadcast(js.model, 0, 0, r0))
        ts = ts._replace(model=tm.broadcast(ts.model, 0, 0, r0))
        js, ts = run(js, ts, 2, "broadcast")
    a, b = np.arange(0, 20), np.arange(20, n)
    js = js._replace(faults=jf.inject_partition(
        jf.crash_many(js.faults, [4, 33]), a, b))
    ts = ts._replace(faults=tf.inject_partition(
        tf.crash_many(ts.faults, [4, 33]), a, b))
    js, ts = run(js, ts, 2, "split")
    js = js._replace(faults=jf.resolve_partition(js.faults))
    ts = ts._replace(faults=tf.resolve_partition(ts.faults))
    js, ts = run(js, ts, 2, "healed")
    jsnap, tsnap = jh.snapshot(js.health), th.snapshot(ts.health)
    assert sorted(jsnap) == sorted(tsnap)
    for key in jsnap:
        np.testing.assert_array_equal(np.asarray(jsnap[key]), tsnap[key])
    assert th.rows(tsnap) == jh.rows(jsnap)
    assert th.transitions(tsnap, falling=True) == \
        jh.transitions(jsnap, falling=True)
    assert len(tsnap["rounds"]) == min(ring, int(ts.rnd) // health)


def test_width_operand_masks_inactive_rows():
    """The bench configuration with the plane on and the width operand:
    the snapshot reads the wire-stage alive (masked to the active
    prefix) through the ladder's rungs [32, 64]."""
    n = 64

    def kw(hv, pt):
        k = bench_kwargs(hv, pt, n=n)
        k.update(health=5, health_ring=16)
        return k

    jm, tm = JPlumtree(), TPlumtree()
    jcl = JCluster(JConfig(**kw(JHyParView, JPlumtreeCfg)), model=jm)
    tcl = TCluster(TConfig(**kw(THyParView, TPlumtreeCfg)), model=tm,
                   device="cpu")
    js0 = jcl.init()
    ts0 = state_io.state_from_numpy(jax.device_get(js0), device="cpu")
    jw, tw = [], []
    _, js = jsc._boot_ladder(
        lambda w: jcl, n, widths=[32, n], settle_execs=1,
        on_wave=lambda hi, s, w: jw.append(jax.device_get(s)),
        final_state=js0)
    _, ts = tsc._boot_ladder(
        lambda w: tcl, n, widths=[32, n], settle_execs=1,
        on_wave=lambda hi, s, w: tw.append(s), final_state=ts0)
    assert len(jw) == len(tw) >= 3
    for i, (a, b) in enumerate(zip(jw, tw)):
        assert_same(a, b, f"wave {i}")
    assert_same(js, ts, "ladder end")
    # the first rung's snapshots saw only the 32-node prefix alive
    assert int(jw[0].health.deg_hist[0].sum()) <= 32
