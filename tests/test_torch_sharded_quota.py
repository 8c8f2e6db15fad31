"""The all-to-all quota under pressure at WIDE_N nodes: with
``a2a_factor=1`` every (source shard, destination shard) budget shrinks
4x and the exchange sheds, so the run diverges from the one-device run
by design (tests/support.py) — but the port's sharded run still equals
the reference's sharded run leaf for leaf, sheds and all, and repair
converges the broadcast within four extra 10-round batches
(tests/test_sharded.py's quota soak; four shards)."""

import torch

from test_torch_sharded import JAX, TORCH
from test_torch_cluster import assert_same
from test_torch_sharded_wide import wide_cfg, wide_drive

torch.set_num_threads(1)


def test_quota_soak_sheds_identically_and_converges():
    out = {}
    for side in (JAX, TORCH):
        cfg = side.cfg.Config(**wide_cfg(side, 1))
        model = side.models("Plumtree")()
        cl = side.sharded(cfg, 4, model)
        st = wide_drive(side, cl)
        extra = 0
        for _ in range(12):
            if float(model.coverage(st.model, st.faults.alive, 0)) == 1.0:
                break
            st = cl.steps(st, 10)
            extra += 1
        assert extra <= 4, (side.name, extra)
        out[side.name] = (side.host(st), cl)
    assert_same(out["jax"][0], out["torch"][0], "quota soak")
    assert out["torch"][1].a2a_shed() > 0
