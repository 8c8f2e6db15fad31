"""The sharded cluster against the JAX reference on the CPU: the bench
stack (HyParView + Plumtree + the distance plane, aligned timers, the
all-to-all exchange) at tests/support.py's WIDE_N nodes through a
factor-8 wave bootstrap and broadcast convergence (tests/test_sharded.py;
helpers in test_torch_sharded.py), on two shards: each of the port's
shard threads runs a whole round's host work, so the wall grows with
the shard count (four shards take about 50 s here); the quota under
pressure runs on four shards in test_torch_sharded_quota.py."""

import numpy as np
import torch

from support import WIDE_N
from test_torch_sharded import three_way

torch.set_num_threads(1)


def wide_cfg(side, factor, n=WIDE_N):
    return dict(n_nodes=n, seed=91, peer_service_manager="hyparview",
                msg_words=16, partition_mode="groups", emit_compact=32,
                timer_stagger=False, sharded_exchange="all_to_all",
                a2a_factor=factor, distance_interval_ms=2_000,
                distance=side.cfg.DistanceConfig(enabled=True, model="ring"))


def wide_drive(side, cl):
    n = cl.cfg.n_nodes
    st = cl.init()
    rng = np.random.default_rng(3)
    base = 1
    while base < n:
        hi = min(base * 8, n)
        nodes = np.arange(base, hi, dtype=np.int32)
        tgts = rng.integers(0, base, size=nodes.shape[0]).astype(np.int32)
        st = st._replace(manager=cl.manager.join_many(
            cl.cfg, st.manager, nodes, tgts))
        st = cl.steps(st, 10)
        base = hi
    st = st._replace(model=cl.model.broadcast(st.model, 0, 0))
    return cl.steps(st, 30)


def test_wide_sharded_parity_through_convergence():
    out = three_way(lambda s: wide_cfg(s, 4), wide_drive, 2,
                    model="Plumtree", label="wide")
    st = out["sharded"]
    from partisan_tpu_torch.models.plumtree import Plumtree
    assert float(Plumtree().coverage(st.model, st.faults.alive, 0)) == 1.0
