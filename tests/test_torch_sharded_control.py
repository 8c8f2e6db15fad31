"""The sharded cluster against the JAX reference on the CPU: the
closed-loop round (tests/test_control.py: every plane, channel capacity
and the three controllers) and the watchdog's injected breach
(tests/test_watchdog.py) under sharding.  Helpers in
test_torch_sharded.py."""

import torch

from test_torch_sharded import join_all, three_way

torch.set_num_threads(1)


def test_controllers_sharded_parity():
    def cfg_kw(s):
        return dict(n_nodes=32, seed=5, peer_service_manager="hyparview",
                    msg_words=16, partition_mode="groups",
                    provenance=True, provenance_ring=64,
                    latency=True, channel_capacity=True,
                    health=5, health_ring=32, max_broadcasts=8,
                    control=s.cfg.ControlConfig(fanout=True,
                                                backpressure=True,
                                                healing=True, ring=16))

    def drive(side, cl):
        n = cl.cfg.n_nodes
        st = cl.init()
        st = st._replace(manager=cl.manager.join_many(
            cl.cfg, st.manager, list(range(1, n)), [0] * (n - 1)))
        st = cl.steps(st, 20)
        st = st._replace(model=cl.model.broadcast(st.model, 0, 0, 2,
                                                  fresh=True))
        return cl.steps(st, 20)

    three_way(cfg_kw, drive, 4, model="Plumtree", label="control")


def test_watchdog_sharded_parity():
    from partisan_tpu_torch import watchdog as watchdog_mod

    boot = 15

    def cfg_kw(s):
        return dict(n_nodes=16, seed=21, inbox_cap=32, metrics=True,
                    metrics_ring=32,
                    watchdog=s.cfg.WatchdogConfig(
                        enabled=True, ring=16, inject_round=boot + 20,
                        inject_amount=2))

    def drive(side, cl):
        st = cl.steps(join_all(side, cl, cl.init()), boot)
        return cl.steps(st, 40)

    out = three_way(cfg_kw, drive, 8, label="watchdog")
    assert watchdog_mod.poll(out["sharded"].watchdog) == {
        "breaches": 1, "first_breach_rnd": boot + 20, "tripped": 0}
