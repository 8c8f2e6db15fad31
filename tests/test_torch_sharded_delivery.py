"""The sharded cluster against the JAX reference on the CPU: the
delivery layer's sharded cases (tests/test_delivery.py) — the p2p causal
lane over a static overlay and the causal broadcast lane with its actor
block on shard 0.  Helpers in test_torch_sharded.py."""

import numpy as np
import torch

from test_torch_sharded import join_all, three_way

torch.set_num_threads(1)


def test_p2p_single_and_sharded():
    """The reference case runs n=4096 with 48 senders; here n=256 with
    the same shape of plan (every sender to one random destination, two
    sends each at rounds 3 and 5, 12 rounds): each of the port's shard
    threads runs a whole round's host work, so 4096 nodes on 8 shards
    would take minutes on this CPU.  The p2p state is shard-local at any
    n, and the card runs the sharded round at n=32,768 (chip_smoke.py
    phase 41)."""
    n = 256
    rng = np.random.default_rng(9)
    senders = rng.choice(n, size=48, replace=False)
    plan = [(int(s), int((s + 1 + rng.integers(0, n - 2)) % n))
            for s in senders]

    def drive(side, cl):
        st = cl.init()
        m = st.model
        for s, dst in plan:
            m = cl.model.schedule(m, node=s, rnd=3, dst=dst)
            m = cl.model.schedule(m, node=s, rnd=5, dst=dst)
        return cl.steps(st._replace(model=m), 12)

    out = three_way(lambda s: dict(n_nodes=n, seed=7,
                                   causal_p2p_labels=("chat",),
                                   peer_service_manager="static"),
                    drive, 8, model="P2PChat", label="p2p")
    assert int(out["sharded"].model.log_len.sum()) == 96


def test_causal_sharded_parity():
    # actors must be resident on shard 0: n_actors <= n_nodes / shards
    def drive(side, cl):
        st = join_all(side, cl, cl.init())
        m = st.model
        for rnd in (18, 21):
            m = cl.model.schedule(m, node=0, rnd=rnd)
        m = cl.model.schedule(m, node=1, rnd=20)
        return cl.steps(st._replace(model=m), 40)

    three_way(lambda s: dict(n_nodes=16, seed=9, causal_labels=("chat",),
                             n_actors=2),
              drive, 8, model="CausalChat", label="causal")
