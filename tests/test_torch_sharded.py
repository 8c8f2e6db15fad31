"""The sharded cluster against the JAX reference on the CPU: the port's
``ShardedCluster`` on a mesh of S shard threads, held leaf for leaf
against the reference's ``ShardedCluster(cfg, make_mesh(S))`` on the
virtual CPU devices tests/conftest.py forces, and against the port's own
``Cluster`` — the ports of tests/test_sharded.py (all but the
plane-vs-legacy layout case, which needs ``plane_major=False``).  Same
seeds and ``Config``s as the reference cases.

The helpers here (``Side``, ``JAX``/``TORCH``, ``three_way``) serve the
other ``test_torch_sharded_*.py`` files too: a case is a ``drive(side,
cl)`` script written once against the package-neutral ``Side``, run on
the reference's sharded cluster, the port's sharded cluster and the
port's single-device cluster."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import partisan_tpu as jpkg
import partisan_tpu_torch as tpkg
from partisan_tpu import config as jconfig
from partisan_tpu import faults as jfaults
from partisan_tpu import parallel as jparallel
from partisan_tpu import provenance as jprovenance
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.cluster import activate as jactivate
from partisan_tpu_torch import config as tconfig
from partisan_tpu_torch import faults as tfaults
from partisan_tpu_torch import parallel as tparallel
from partisan_tpu_torch import provenance as tprovenance
from partisan_tpu_torch import state_io
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.cluster import activate as tactivate
from test_torch_cluster import assert_same

torch.set_num_threads(1)


class Side(types.SimpleNamespace):
    """One package's entry points, so a case script runs on either."""

    def models(self, name):
        return getattr(self.model_mods, name)


def _jset(faults, field, idx, value):
    x = getattr(faults, field)
    return faults._replace(**{field: x.at[jnp.asarray(idx)].set(value)})


def _tset(faults, field, idx, value):
    x = getattr(faults, field).clone()
    x[torch.as_tensor(idx, dtype=torch.int64)] = value
    return faults._replace(**{field: x})


def _jmodels():
    from partisan_tpu.models import (anti_entropy, causal_chat, p2p_chat,
                                     plumtree, rumor_mongering)
    return types.SimpleNamespace(
        AntiEntropy=anti_entropy.AntiEntropy, Plumtree=plumtree.Plumtree,
        RumorMongering=rumor_mongering.RumorMongering,
        P2PChat=p2p_chat.P2PChat, CausalChat=causal_chat.CausalChat)


def _tmodels():
    from partisan_tpu_torch.models import (anti_entropy, causal_chat,
                                           p2p_chat, plumtree,
                                           rumor_mongering)
    return types.SimpleNamespace(
        AntiEntropy=anti_entropy.AntiEntropy, Plumtree=plumtree.Plumtree,
        RumorMongering=rumor_mongering.RumorMongering,
        P2PChat=p2p_chat.P2PChat, CausalChat=causal_chat.CausalChat)


JAX = Side(
    name="jax", cfg=jconfig, faults=jfaults, model_mods=_jmodels(),
    provenance=jprovenance,
    set=_jset, activate=jactivate,
    link_drop=lambda f, p: f._replace(link_drop=jnp.float32(p)),
    sharded=lambda cfg, S, model=None: jparallel.ShardedCluster(
        cfg, jparallel.make_mesh(S), model=model),
    single=lambda cfg, model=None: JCluster(cfg, model=model),
    host=lambda st: jax.device_get(st),
    arr=jnp.asarray)

TORCH = Side(
    name="torch", cfg=tconfig, faults=tfaults, model_mods=_tmodels(),
    provenance=tprovenance,
    set=_tset, activate=tactivate,
    link_drop=tfaults.set_link_drop,
    sharded=lambda cfg, S, model=None: tparallel.ShardedCluster(
        cfg, tparallel.make_mesh(S, device="cpu"), model=model),
    single=lambda cfg, model=None: TCluster(cfg, model=model, device="cpu"),
    host=lambda st: st,
    arr=lambda x: torch.as_tensor(np.asarray(x)))

assert jpkg and tpkg


def join_all(side, cl, st, contact=0):
    m = st.manager
    for i in range(1, cl.cfg.n_nodes):
        if i != contact:
            m = cl.manager.join(cl.cfg, m, i, contact)
    return st._replace(manager=m)


def assert_port_equal(a, b, label=""):
    """Two port states equal leaf for leaf (dtype, shape, bits)."""
    la = state_io.flatten(state_io.state_to_numpy(a))
    lb = state_io.flatten(state_io.state_to_numpy(b))
    assert [p for p, _ in la] == [p for p, _ in lb], label
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, (label, path)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {path}")


def three_way(cfg_kw, drive, S, model=None, label=""):
    """``drive(side, cl)`` on the reference's S-shard cluster, the
    port's S-shard cluster and the port's one-device cluster; every leaf
    of the three final states must be equal.  ``cfg_kw(side)`` gives the
    ``Config`` keywords (nested configs from ``side.cfg``).  Returns the
    three final states (reference on the host)."""
    out = {}
    for key, side, make in (
            ("ref_sharded", JAX, lambda c, m: JAX.sharded(c, S, m)),
            ("sharded", TORCH, lambda c, m: TORCH.sharded(c, S, m)),
            ("single", TORCH, lambda c, m: TORCH.single(c, m))):
        cfg = side.cfg.Config(**cfg_kw(side))
        m = side.models(model)() if model else None
        out[key] = side.host(drive(side, make(cfg, m)))
    assert_port_equal(out["single"], out["sharded"], f"{label} port")
    assert_same(out["ref_sharded"], out["sharded"], f"{label} ref")
    return out


# ---------------------------------------------------------------------------
# tests/test_sharded.py
# ---------------------------------------------------------------------------

def _ae_drive(side, cl):
    st = join_all(side, cl, cl.init())
    st = st._replace(model=cl.model.broadcast(st.model, 0, 0))
    return cl.steps(st, 40)


def test_sharded_matches_local():
    three_way(lambda s: dict(n_nodes=16, seed=21), _ae_drive, 8,
              model="AntiEntropy", label="matches_local")


def test_mesh_size_invariance():
    """2-shard and 8-shard runs agree with each other and with the
    reference's 2-shard run."""
    def run(side, S):
        m = side.models("AntiEntropy")()
        cfg_s = side.cfg.Config(n_nodes=16, seed=55)
        cl = side.sharded(cfg_s, S, m)
        st = join_all(side, cl, cl.init())
        st = st._replace(model=m.broadcast(st.model, 1, 0))
        return side.host(cl.steps(st, 25))

    a, b = run(TORCH, 2), run(TORCH, 8)
    assert_port_equal(a, b, "2 vs 8 shards")
    assert_same(run(JAX, 2), a, "reference 2 shards")


def test_indivisible_nodes_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        tparallel.ShardedCluster(tconfig.Config(n_nodes=12),
                                 tparallel.make_mesh(8, device="cpu"))


def test_sharded_trace_matches_local():
    """The sharded record() gives the one-device TraceRound stream and
    the reference's sharded one."""
    def boot(side, cl):
        st = cl.steps(join_all(side, cl, cl.init()), 10)
        return st._replace(model=cl.model.broadcast(st.model, 0, 0))

    caps = {}
    for key, side, make in (
            ("ref", JAX, lambda c, m: JAX.sharded(c, 4, m)),
            ("sharded", TORCH, lambda c, m: TORCH.sharded(c, 4, m)),
            ("single", TORCH, lambda c, m: TORCH.single(c, m))):
        cfg = side.cfg.Config(n_nodes=16, seed=12, inbox_cap=32)
        cl = make(cfg, side.models("AntiEntropy")())
        st, tr = cl.record(boot(side, cl), 6)
        caps[key] = (side.host(st), side.host(tr))
    assert_port_equal(caps["single"][0], caps["sharded"][0], "state")
    assert_same(caps["ref"][0], caps["sharded"][0], "ref state")
    for f in ("rnd", "sent", "dropped"):
        t_s = getattr(caps["sharded"][1], f).numpy()
        np.testing.assert_array_equal(getattr(caps["single"][1], f).numpy(),
                                      t_s, err_msg=f)
        np.testing.assert_array_equal(
            np.asarray(getattr(caps["ref"][1], f)), t_s, err_msg=f)
    assert caps["sharded"][1].sent.shape[:2] == (6, 16)


def _quota_route(n, shards, E, W, cap, factor, dst_of):
    """Route synthetic APP emissions through the port's all-to-all
    ShardComm on a CPU mesh: ``dst_of(src)`` int32[n, 1] destinations
    (-1 none), payload P0 = emission slot.  Returns the global inbox."""
    from partisan_tpu_torch import types as T
    from partisan_tpu_torch.ops import msg as msg_ops
    from partisan_tpu_torch.parallel.sharded import ShardComm

    mesh = tparallel.make_mesh(shards, device="cpu")
    src = torch.arange(n, dtype=torch.int32)[:, None]
    dst = dst_of(src).expand(n, E)
    seqs = torch.arange(E, dtype=torch.int32)[None].expand(n, E)
    cfg = tconfig.Config(n_nodes=n, msg_words=W)
    emitted = msg_ops.build(cfg, T.MsgKind.APP, src.expand(n, E), dst,
                            payload=(seqs,))
    n_local = n // shards
    comms = [ShardComm(n_global=n, inbox_cap=cap, msg_words=W,
                       n_shards=shards, rank=r, mesh=mesh,
                       exchange_mode="all_to_all", a2a_factor=factor)
             for r in range(shards)]
    parts = [emitted.map(lambda w, r=r: w[r * n_local:(r + 1) * n_local])
             for r in range(shards)]
    outs = mesh.run(lambda r, e: comms[r].route(e), parts)
    shed = sum(int(c.shed[0]) for c in comms if c.shed)
    return (torch.cat([o.count for o in outs]),
            [torch.cat([o.data[i] for o in outs]) for i in range(W)], shed)


def test_all_to_all_quota_semantics():
    """Within the quota every record routes as the local exchange does;
    a shard pair over Q delivers the first Q in per-sender order and
    sheds the rest (n=16, 8 shards, E=6, a2a_factor 1: Q = 2)."""
    from partisan_tpu_torch import types as T

    count, data, shed = _quota_route(
        16, 8, 6, 12, 8, 1,
        lambda src: torch.where((src == 6) | (src == 7), 0, -1))
    assert int(count[0]) == 2
    assert data[T.W_SRC][0, :2].tolist() == [6, 6]
    assert data[T.P0][0, :2].tolist() == [0, 1]
    assert int(count[1:].sum()) == 0
    assert shed == 10


def test_all_to_all_quota_pressure_wide():
    """Shard 7's 512 nodes each aim a full emission row at shard 0:
    4096 records against a Q=2048 budget; exactly the quota survives."""
    n, shards = 4096, 8
    n_local = n // shards
    count, _, shed = _quota_route(
        n, shards, 8, 12, 16, 4,
        lambda src: torch.where(src >= 7 * n_local,
                                (src - 7 * n_local) % n_local, -1))
    assert int(count[:n_local].sum()) == 2048
    assert int(count[n_local:].sum()) == 0
    assert shed == 2048


# ---------------------------------------------------------------------------
# The mesh's rendezvous
# ---------------------------------------------------------------------------

def test_rendezvous_collectives_in_rank_order():
    """all_gather tiles axis 0 in rank order, all_to_all hands chunk r
    to rank r, the reductions agree on every shard."""
    mesh = tparallel.make_mesh(4, device="cpu")

    def body(r, x):
        g = mesh.all_gather(r, x)
        a = mesh.all_to_all(r, torch.arange(8) + 10 * r)
        s = mesh.psum(r, (x.sum(), {"m": x.max()}))
        return g, a, mesh.pmax(r, x.max()), mesh.pmin(r, x.min()), s

    outs = mesh.run(body, [torch.tensor([r, r + 10]) for r in range(4)])
    for r, (g, a, mx, mn, s) in enumerate(outs):
        assert g.tolist() == [0, 10, 1, 11, 2, 12, 3, 13]
        assert a.tolist() == [2 * r, 2 * r + 1, 10 + 2 * r, 11 + 2 * r,
                              20 + 2 * r, 21 + 2 * r, 30 + 2 * r,
                              31 + 2 * r]
        assert (int(mx), int(mn)) == (13, 0)
        assert int(s[0]) == 52 and int(s[1]["m"]) == 13 + 12 + 11 + 10


def test_rendezvous_results_are_private_per_rank():
    """Shards on one device share no tensor a collective returns: a
    shard writing into its result after the collective leaves every
    other shard's result as it was."""
    mesh = tparallel.make_mesh(3, device="cpu")

    def body(r, x):
        g = mesh.all_gather(r, x)
        s = mesh.psum(r, x)
        g += 100 * (r + 1)       # a write in place, after the collective
        s.mul_(r + 2)
        mesh.psum(r, torch.zeros(()))   # the other shards run on
        return g.clone(), s.clone(), g, s

    outs = mesh.run(body, [torch.tensor([r]) for r in range(3)])
    for r, (g, s, gt, st) in enumerate(outs):
        assert g.tolist() == [100 * (r + 1) + i for i in range(3)]
        assert s.tolist() == [3 * (r + 2)]
    ptrs = {t.data_ptr() for o in outs for t in o[2:]}
    assert len(ptrs) == 6


def test_round_writing_state_in_place_raises(monkeypatch):
    """The shards share views of the state they are handed; a round that
    writes into one in place is refused after the call, naming the
    leaf."""
    from partisan_tpu_torch import cluster as tcluster
    from partisan_tpu_torch.parallel import sharded as tsharded

    cfg = tconfig.Config(n_nodes=16, seed=3)
    cl = tparallel.ShardedCluster(cfg, tparallel.make_mesh(2, device="cpu"))
    st = cl.init()
    body = tcluster.round_body

    def writes_alive(*a, **kw):
        out = body(*a, **kw)
        a[4].faults.alive[0] = True      # into the handed state
        return out

    monkeypatch.setattr(tsharded, "round_body", writes_alive)
    with pytest.raises(RuntimeError, match="faults.alive"):
        cl.steps(st, 1)
    with pytest.raises(RuntimeError, match="faults.alive"):
        cl.record(st, 1)


def test_rendezvous_partial_collective_raises_not_hangs():
    """A collective only some shards reach raises within the timeout,
    naming it and the ranks that arrived; a shard's own error ends the
    run and is re-raised in the caller."""
    import time

    mesh = tparallel.Mesh(["cpu"] * 3, timeout=1.0)

    def skip(r, x):
        # a gate read differently on rank 2: only ranks 0 and 1 gather
        return mesh.all_gather(r, x) if r < 2 else x

    t0 = time.perf_counter()
    with pytest.raises(tparallel.RendezvousError,
                       match=r"'all_gather'.*\[0, 1\]"):
        mesh.run(skip, [torch.zeros(1)] * 3)
    assert time.perf_counter() - t0 < 30

    def mismatch(r, x):
        return mesh.psum(r, x) if r == 0 else mesh.pmax(r, x)

    with pytest.raises(tparallel.RendezvousError, match="different"):
        mesh.run(mismatch, [torch.zeros(1)] * 3)

    def boom(r, x):
        if r == 1:
            raise KeyError("shard 1 failed")
        return mesh.psum(r, x)

    with pytest.raises(KeyError, match="shard 1 failed"):
        mesh.run(boom, [torch.zeros(1)] * 3)
    def stuck(r, x):
        # a shard that holds its turn past the timeout: the waiting
        # shards raise instead of hanging
        if r == 0:
            time.sleep(1.5)
        return mesh.psum(r, x)

    t0 = time.perf_counter()
    with pytest.raises(tparallel.RendezvousError, match="waited"):
        mesh.run(stuck, [torch.zeros(1)] * 3)
    assert time.perf_counter() - t0 < 30

    # the mesh is usable again after a failed run
    assert [int(v) for v in mesh.run(lambda r, x: mesh.psum(r, x),
                                     [torch.ones(())] * 3)] == [3, 3, 3]


def test_mesh_defaults_to_the_card_and_shard_count(monkeypatch):
    """No default picks the CPU; the process-wide shard count comes from
    force_host_devices, else PARTISAN_SHARDS, else 1 on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tparallel.make_mesh(2)
    monkeypatch.delenv("PARTISAN_SHARDS", raising=False)
    assert tparallel.shard_count("cpu") == 1
    monkeypatch.setenv("PARTISAN_SHARDS", "5")
    assert tparallel.make_mesh(device="cpu").size == 5
    try:
        tparallel.force_host_devices(3)
        assert tparallel.shard_count("cpu") == 3
    finally:
        tparallel.force_host_devices(None)
    assert tparallel.make_mesh(2, device="cpu").devices == (
        torch.device("cpu"),) * 2
