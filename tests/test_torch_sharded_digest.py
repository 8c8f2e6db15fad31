"""The health plane on a sharded cluster against the JAX reference on
the CPU (tests/test_sharded_health.py): the whole health ring and its
digest on a HyParView overlay through crashes and a group partition,
and the width-operand prefix case (a sharded 2n-capacity run activated
to n snapshots the series of a native n-node run).  Four shards; helpers
in test_torch_sharded.py."""

import numpy as np
import torch

from test_torch_sharded import JAX, TORCH, three_way
from test_torch_cluster import assert_same

torch.set_num_threads(1)


def test_sharded_digest_bit_parity_under_faults():
    from partisan_tpu_torch import health as health_mod

    def cfg_kw(s):
        return dict(n_nodes=64, seed=13, peer_service_manager="hyparview",
                    msg_words=16, health=5, health_ring=32,
                    partition_mode="groups")

    def drive(side, cl):
        st = cl.init()
        m = st.manager
        for base in range(1, 64, 16):
            nodes = list(range(base, min(base + 16, 64)))
            m = cl.manager.join_many(cl.cfg, m, nodes, [0] * len(nodes))
            st = cl.steps(st._replace(manager=m), 10)
            m = st.manager
        f = side.faults.crash_many(st.faults, [7, 21, 40])
        f = side.set(f, "partition", list(range(24)), 1)
        st = cl.steps(st._replace(faults=f), 10)
        st = st._replace(faults=side.set(st.faults, "partition",
                                         list(range(64)), 0))
        st = cl.steps(st, 10)
        return cl.steps(st, 10)

    out = three_way(cfg_kw, drive, 4, label="digest")
    snap = health_mod.snapshot(out["sharded"].health)
    assert health_mod.digest(out["sharded"]) \
        == health_mod.digest(out["single"])
    assert snap["components"].max() > 1
    assert snap["downs"].sum() == 3


def test_width_operand_prefix_masking_sharded():
    from partisan_tpu_torch import health as health_mod

    def boot(side, cl, n):
        st = cl.init()
        if cl.cfg.width_operand:
            st = side.activate(st, n)
        for base in range(1, n, 8):
            nodes = list(range(base, min(base + 8, n)))
            m = cl.manager.join_many(cl.cfg, st.manager, nodes,
                                     [0] * len(nodes))
            st = cl.steps(st._replace(manager=m), 2)
        for _ in range(10):
            st = cl.steps(st, 2)
        return side.host(st)

    n = 24

    def cfg(side, nodes, **kw):
        return side.cfg.Config(n_nodes=nodes, seed=6,
                               peer_service_manager="hyparview",
                               msg_words=16, health=4, health_ring=16, **kw)

    st_n = boot(TORCH, TORCH.single(cfg(TORCH, n)), n)
    st_w = boot(TORCH, TORCH.sharded(cfg(TORCH, 2 * n, width_operand=True),
                                     4), n)
    st_wr = boot(JAX, JAX.sharded(cfg(JAX, 2 * n, width_operand=True), 4),
                 n)
    assert_same(st_wr, st_w, "reference width run")
    snap_n = health_mod.snapshot(st_n.health)
    snap_w = health_mod.snapshot(st_w.health)
    for name in ("rounds", "components", "isolated", "deg_min", "deg_max",
                 "sym_violations", "joins", "leaves", "ups", "downs",
                 "deg_hist"):
        np.testing.assert_array_equal(snap_n[name], snap_w[name],
                                      err_msg=name)
