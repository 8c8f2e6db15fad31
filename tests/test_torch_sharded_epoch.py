"""The sharded cluster against the JAX reference on the CPU: slot-epoch
recycling under sharding (tests/test_sharded.py; helpers in
test_torch_sharded.py), on four shards."""

import torch

from test_torch_sharded import join_all, three_way

torch.set_num_threads(1)


def test_slot_epoch_recycling_sharded_parity():
    def drive(side, cl):
        st = cl.steps(join_all(side, cl, cl.init()), 15)
        st = st._replace(model=cl.model.broadcast(st.model, 3, 0, 1))
        st = cl.steps(st, 15)
        # recycle slot 0 for a different root
        st = st._replace(model=cl.model.broadcast(st.model, 8, 0, 2,
                                                  fresh=True))
        return cl.steps(st, 20)

    out = three_way(lambda s: dict(n_nodes=16, seed=5,
                                   peer_service_manager="hyparview",
                                   msg_words=16, max_broadcasts=4),
                    drive, 4, model="Plumtree", label="epoch")
    st = out["sharded"]
    assert int((st.model.epoch[:, 0] == 1).sum()) == 16
    from partisan_tpu_torch.models.plumtree import Plumtree
    assert float(Plumtree().coverage(st.model, st.faults.alive, 0, 2)) == 1.0
