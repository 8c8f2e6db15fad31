"""The sharded cluster against the JAX reference on the CPU: the
managers' sharded cases — tests/test_hyparview.py, tests/test_scamp.py
and tests/test_plumtree.py (Plumtree over the full mesh).  Four shards
(the reference cases run eight); helpers in test_torch_sharded.py."""

import torch

from test_torch_sharded import join_all, three_way

torch.set_num_threads(1)


def _joined(steps):
    return lambda side, cl: cl.steps(join_all(side, cl, cl.init()), steps)


def test_hyparview_sharded_parity():
    three_way(lambda s: dict(n_nodes=16, seed=77,
                             peer_service_manager="hyparview",
                             msg_words=16),
              _joined(50), 4, label="hyparview")


def test_scamp_sharded_parity():
    three_way(lambda s: dict(n_nodes=16, seed=77,
                             peer_service_manager="scamp_v2",
                             scamp=s.cfg.ScampConfig(partial_max=16,
                                                     in_max=16)),
              _joined(50), 4, label="scamp")


def test_plumtree_sharded_parity():
    def drive(side, cl):
        st = cl.steps(join_all(side, cl, cl.init()), 15)
        st = st._replace(model=cl.model.broadcast(st.model, 0, 0))
        return cl.steps(st, 30)

    three_way(lambda s: dict(n_nodes=16, seed=77, inbox_cap=32), drive, 4,
              model="Plumtree", label="plumtree")
