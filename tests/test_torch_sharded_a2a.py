"""The sharded cluster against the JAX reference on the CPU: the
all-to-all exchange on the bench workload, HyParView + Plumtree
(tests/test_sharded.py; helpers in test_torch_sharded.py), on four
shards."""

import torch

from test_torch_sharded import join_all, three_way

torch.set_num_threads(1)


def test_all_to_all_hyparview_plumtree_parity():
    def drive(side, cl):
        st = cl.steps(join_all(side, cl, cl.init()), 15)
        st = st._replace(model=cl.model.broadcast(st.model, 0, 0))
        return cl.steps(st, 25)

    out = three_way(lambda s: dict(n_nodes=16, seed=5,
                                   peer_service_manager="hyparview",
                                   msg_words=16,
                                   sharded_exchange="all_to_all"),
                    drive, 4, model="Plumtree", label="a2a_hv")
    st = out["sharded"]
    from partisan_tpu_torch.models.plumtree import Plumtree
    assert float(Plumtree().coverage(st.model, st.faults.alive, 0)) == 1.0
