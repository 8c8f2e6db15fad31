"""The sharded cluster against the JAX reference on the CPU: the
``n_active`` width operand under sharding (tests/test_program_budget.py's
sharded case: a 64-node capacity activated to 32 and booted in waves).
Helpers in test_torch_sharded.py."""

import numpy as np
import torch

from test_torch_sharded import three_way

torch.set_num_threads(1)


def test_width_operand_sharded_parity():
    def cfg_kw(s):
        return dict(n_nodes=64, seed=5, peer_service_manager="hyparview",
                    partition_mode="groups", max_broadcasts=8,
                    inbox_cap=16, timer_stagger=False, width_operand=True,
                    msg_words=16,
                    plumtree=s.cfg.PlumtreeConfig(push_slots=2, lazy_cap=4))

    def drive(side, cl):
        st = side.activate(cl.init(), 32)
        rng = np.random.default_rng(7)
        base = 1
        while base < 32:
            hi = min(base * 4, 32)
            nodes = np.arange(base, hi, dtype=np.int32)
            tgts = rng.integers(0, base,
                                size=nodes.shape[0]).astype(np.int32)
            st = st._replace(manager=cl.manager.join_many(
                cl.cfg, st.manager, nodes, tgts))
            st = cl.steps(st, 10)
            base = hi
        return cl.steps(st, 10)

    three_way(cfg_kw, drive, 4, label="width")
