"""The health plane's segment-local kernels on a shard mesh, against the
JAX reference and the host BFS oracle (tests/test_sharded_health.py):

- segment-local FastSV (the label halo over ``gather_vec``/``allmin``)
  on 8 shard threads vs the port's global kernel vs the reference's
  gathered and sharded kernels vs ``support.components``, on
  ``support.FASTSV_TRIALS`` random overlays (faulted, group-partitioned,
  and a path across every shard);
- the slot-column symmetry check, sharded vs global vs the reference;
- ``make_cluster_auto``'s choices;
- ``lint.cost.state_memory_rows``: sharded leaves divide by the shard
  count, replicated ones do not — equal to the reference's rows.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from partisan_tpu import health as jhealth
from partisan_tpu.parallel.sharded import AXIS
from partisan_tpu.parallel.sharded import ShardComm as JShardComm
from partisan_tpu.parallel.sharded import _shard_map
from partisan_tpu_torch import health as thealth
from partisan_tpu_torch import parallel as tparallel
from partisan_tpu_torch.parallel.sharded import ShardComm
from tests import support

torch.set_num_threads(1)

P = jax.sharding.PartitionSpec
_N, _K, _S = 256, 7, 8


def _random_overlay(rng, n, k):
    """tests/test_sharded_health.py's padded overlay: dead pad rows, -1
    pad slots."""
    nbrs = np.full((_N, _K), -1, np.int32)
    nbrs[:n, :k] = rng.integers(-1, n, size=(n, k))
    ids = np.arange(_N, dtype=np.int32)[:, None]
    nbrs = np.where(nbrs == ids, -1, nbrs)
    alive = np.zeros(_N, bool)
    alive[:n] = rng.random(n) > rng.uniform(0.0, 0.4)
    return nbrs, alive


@functools.lru_cache(maxsize=None)
def _port_mesh():
    mesh = tparallel.make_mesh(_S, device="cpu")
    comms = [ShardComm(n_global=_N, inbox_cap=8, msg_words=12, n_shards=_S,
                       rank=r, mesh=mesh) for r in range(_S)]
    return mesh, comms


def _port_sharded(kernel, nbrs, alive, part=None):
    """``kernel(nbrs_local, alive, comm, part)`` on every shard; returns
    rank 0's result (every shard's must agree)."""
    mesh, comms = _port_mesh()
    nb = torch.as_tensor(nbrs)
    al = torch.as_tensor(alive)
    pt = None if part is None else torch.as_tensor(part)
    nl = _N // _S
    outs = mesh.run(lambda r, x: kernel(x, al, comms[r], pt),
                    [nb[r * nl:(r + 1) * nl] for r in range(_S)])
    vals = [int(o[1] if isinstance(o, tuple) else o) for o in outs]
    assert len(set(vals)) == 1, vals
    return vals[0]


@functools.lru_cache(maxsize=None)
def _ref_sharded():
    from partisan_tpu.parallel import make_mesh

    mesh = make_mesh(_S)
    comm = JShardComm(n_global=_N, inbox_cap=8, msg_words=12, n_shards=_S)
    plain = jax.jit(_shard_map(
        lambda nb, al: jhealth.component_count_sharded(nb, al, comm)[1],
        mesh, in_specs=(P(AXIS), P()), out_specs=P()))
    parted = jax.jit(_shard_map(
        lambda nb, al, pt: jhealth.component_count_sharded(nb, al, comm,
                                                           pt)[1],
        mesh, in_specs=(P(AXIS), P(), P()), out_specs=P()))
    sym = jax.jit(_shard_map(
        lambda nb, al: jhealth.symmetry_violations_sharded(nb, al, comm),
        mesh, in_specs=(P(AXIS), P()), out_specs=P()))
    return plain, parted, sym


def test_fastsv_sharded_vs_gathered_vs_bfs_oracle():
    from support import FASTSV_TRIALS

    rng = np.random.default_rng(1302)
    ref_plain, ref_parted, _ = _ref_sharded()
    checked = 0

    def check(nbrs, alive, part=None):
        want = len(support.components(nbrs, alive, partition=part))
        targs = (torch.as_tensor(nbrs), torch.as_tensor(alive)) + (
            () if part is None else (torch.as_tensor(part),))
        got_g = int(thealth.component_count(*targs)[1])
        got_s = _port_sharded(thealth.component_count_sharded, nbrs, alive,
                              part)
        jargs = (jnp.asarray(nbrs), jnp.asarray(alive)) + (
            () if part is None else (jnp.asarray(part),))
        got_r = int((ref_plain if part is None else ref_parted)(*jargs))
        got_rg = int(jhealth.component_count(*jargs)[1])
        assert got_s == got_g == got_r == got_rg == want, \
            (got_s, got_g, got_r, got_rg, want)

    plain_trials = FASTSV_TRIALS - FASTSV_TRIALS // 3
    for _ in range(plain_trials):
        n = int(rng.integers(2, _N + 1))
        k = int(rng.integers(1, _K + 1))
        check(*_random_overlay(rng, n, k))
        checked += 1
    for _ in range(FASTSV_TRIALS // 3):
        n = int(rng.integers(4, _N + 1))
        k = int(rng.integers(1, _K + 1))
        nbrs, alive = _random_overlay(rng, n, k)
        part = rng.integers(0, int(rng.integers(2, 5)),
                            size=_N).astype(np.int32)
        check(nbrs, alive, part)
        checked += 1
    # a path across every shard: the min label crosses all boundaries
    for n in (2, 63, _N):
        nbrs = np.full((_N, _K), -1, np.int32)
        nbrs[1:n, 0] = np.arange(n - 1)
        alive = np.zeros(_N, bool)
        alive[:n] = True
        check(nbrs, alive)
        alive[n // 2] = False
        check(nbrs, alive)
        checked += 2
    assert checked >= FASTSV_TRIALS + 6


def test_sharded_symmetry_matches_reference():
    rng = np.random.default_rng(77)
    _, _, ref_sym = _ref_sharded()
    for trial in range(12):
        n = int(rng.integers(2, _N + 1))
        k = int(rng.integers(1, _K + 1))
        nbrs, alive = _random_overlay(rng, n, k)
        want = int(jhealth.symmetry_violations(jnp.asarray(nbrs),
                                               jnp.asarray(alive)))
        got_g = int(thealth.symmetry_violations(torch.as_tensor(nbrs),
                                                torch.as_tensor(alive)))
        got_s = _port_sharded(thealth.symmetry_violations_sharded, nbrs,
                              alive)
        got_r = int(ref_sym(jnp.asarray(nbrs), jnp.asarray(alive)))
        assert got_s == got_g == got_r == want, (trial, got_s, got_g,
                                                 got_r, want)


def test_make_cluster_auto_selects_sharded(monkeypatch):
    """At or above the threshold with a shard count above 1 the factory
    shards over the largest count that divides n (and the round runs);
    below it, or for a prime n, the one-device Cluster."""
    from partisan_tpu_torch import scenarios
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.parallel import ShardedCluster

    monkeypatch.setattr(scenarios, "SHARDED_N_MIN", 64)
    monkeypatch.delenv("PARTISAN_SHARDS", raising=False)
    # one shard (the CPU's default count): never sharded
    cl0 = scenarios.make_cluster_auto(Config(n_nodes=64, seed=1),
                                      device="cpu")
    assert isinstance(cl0, Cluster)
    monkeypatch.setenv("PARTISAN_SHARDS", "8")
    cl = scenarios.make_cluster_auto(Config(n_nodes=64, seed=1),
                                     device="cpu")
    assert isinstance(cl, ShardedCluster)
    assert cl.mesh.size == 8
    st = cl.step(cl.init())
    assert int(st.rnd) == 1
    cl2 = scenarios.make_cluster_auto(Config(n_nodes=100, seed=1),
                                      device="cpu")
    assert isinstance(cl2, ShardedCluster) and cl2.mesh.size == 5
    cl3 = scenarios.make_cluster_auto(Config(n_nodes=67, seed=1),
                                      device="cpu")
    assert isinstance(cl3, Cluster)          # prime n: no usable mesh
    cl4 = scenarios.make_cluster_auto(Config(n_nodes=32, seed=1),
                                      device="cpu")
    assert isinstance(cl4, Cluster)          # below the threshold


def test_state_memory_rows_exact():
    """Sharded leaves divide by the shard count, replicated ones do not,
    the rows sum to the total — and every row equals the reference's
    census of the same configuration."""
    from partisan_tpu.lint import cost as jcost
    from partisan_tpu.models.plumtree import Plumtree as JPlumtree
    from partisan_tpu.parallel import ShardedCluster as JSharded
    from partisan_tpu.parallel import make_mesh as jmake_mesh
    from partisan_tpu_torch import config as tconfig
    from partisan_tpu_torch import state_io
    from partisan_tpu_torch.lint import cost as tcost
    from partisan_tpu_torch.models.plumtree import Plumtree as TPlumtree
    from partisan_tpu.config import Config as JConfig

    kw = dict(n_nodes=64, seed=1, peer_service_manager="hyparview",
              msg_words=16, health=4, health_ring=8,
              partition_mode="groups")
    sc = tparallel.ShardedCluster(tconfig.Config(**kw),
                                  tparallel.make_mesh(8, device="cpu"),
                                  model=TPlumtree())
    state = sc.init()
    rows = tcost.state_memory_rows(state, sc._state_specs(state), 8)
    by = {r["plane"]: r["mib_per_device"] for r in rows}
    want = sum(x.numel() * x.element_size()
               for _, x in state_io.flatten(state.manager)) // 8 / 2**20
    assert abs(by["manager"] - want) < 1e-3
    assert abs(by["faults"] - (64 + 256 + 4) / 2**20) < 1e-3
    assert abs(by["total"] - sum(v for k, v in by.items()
                                 if k != "total")) < 1e-2
    js = JSharded(JConfig(**kw), jmake_mesh(8), model=JPlumtree())
    jstate = jax.eval_shape(js._build_init)
    jrows = jcost.state_memory_rows(jstate, js._state_specs(jstate), 8)
    assert {r["plane"]: r["mib_per_device"] for r in jrows} == by
    # the one-device form is the S=1 case
    one = {r["plane"]: r["mib_per_device"]
           for r in tcost.resident_memory_rows(state)}
    assert one["faults"] == by["faults"]
    assert abs(one["manager"] - 8 * by["manager"]) < 1e-2
