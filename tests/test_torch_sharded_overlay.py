"""The sharded cluster against the JAX reference on the CPU: the
HyParView cases of tests/test_sharded.py — the traffic plane and the
distance plane (helpers in test_torch_sharded.py).  Four shards here
(the reference cases run eight) to keep the file's wall short: each
shard thread runs a whole round's host work."""

import torch

from test_torch_sharded import join_all, three_way

torch.set_num_threads(1)


def test_traffic_plane_sharded_parity():
    def cfg_kw(s):
        return dict(n_nodes=16, seed=27, peer_service_manager="hyparview",
                    msg_words=16, partition_mode="groups",
                    traffic=s.cfg.TrafficConfig(enabled=True, rate_x1000=900,
                                                hot_skew=1, ring=16))

    def drive(side, cl):
        st = cl.init()
        m = cl.manager.join_many(cl.cfg, st.manager, list(range(1, 16)),
                                 [0] * 15)
        return cl.steps(st._replace(manager=m), 24)

    out = three_way(cfg_kw, drive, 4, model="Plumtree", label="traffic")
    assert int(out["sharded"].traffic.sent) > 0


def test_distance_plane_sharded_parity():
    def cfg_kw(s):
        return dict(n_nodes=16, seed=9, peer_service_manager="hyparview",
                    msg_words=16, distance_interval_ms=2_000,
                    distance=s.cfg.DistanceConfig(enabled=True, model="ring",
                                                  max_latency_rounds=3))

    def drive(side, cl):
        return cl.steps(join_all(side, cl, cl.init()), 40)

    out = three_way(cfg_kw, drive, 4, label="distance")
    assert int((out["sharded"].manager.dist.rtt_node >= 0).sum()) > 0
