"""The sharded cluster against the JAX reference on the CPU, continued
(tests/test_sharded.py's cases under faults and over the all-to-all
exchange; helpers in test_torch_sharded.py)."""

import torch

from test_torch_sharded import _ae_drive, join_all, three_way

torch.set_num_threads(1)


def test_sharded_matches_local_under_faults():
    def drive(side, cl):
        st = cl.steps(join_all(side, cl, cl.init()), 20)
        st = st._replace(
            faults=side.faults.crash(side.link_drop(st.faults, 0.1), 7),
            model=cl.model.broadcast(st.model, 3, 2))
        return cl.steps(st, 30)

    three_way(lambda s: dict(n_nodes=16, seed=33), drive, 8,
              model="AntiEntropy", label="under_faults")


def test_all_to_all_exchange_matches_local():
    three_way(lambda s: dict(n_nodes=16, seed=21,
                             sharded_exchange="all_to_all"),
              _ae_drive, 8, model="AntiEntropy", label="a2a")
