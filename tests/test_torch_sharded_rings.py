"""The sharded cluster against the JAX reference on the CPU: the health
ring (tests/test_health.py) and the provenance forest and rings
(tests/test_provenance.py) under sharding.  Helpers in
test_torch_sharded.py and test_torch_sharded_planes.py."""

import torch

from test_torch_sharded import join_all, three_way
from test_torch_sharded_planes import crash_and_drop

torch.set_num_threads(1)


def test_sharded_health_ring_matches_single_device():
    from partisan_tpu_torch import health as health_mod

    out = three_way(lambda s: dict(n_nodes=16, seed=3, inbox_cap=24,
                                   health=3, health_ring=32),
                    lambda side, cl: crash_and_drop(side, cl, False), 8,
                    model="AntiEntropy", label="health")
    snap = health_mod.snapshot(out["sharded"].health)
    assert health_mod.digest(out["sharded"]) \
        == health_mod.digest(out["single"])
    assert snap["rounds"].size > 0
    assert snap["downs"].sum() == 1


def test_sharded_forest_and_rings_match_single_device():
    from partisan_tpu_torch import provenance as prov_mod

    def drive(side, cl):
        st = cl.steps(join_all(side, cl, cl.init()), 4)
        st = st._replace(model=cl.model.broadcast(st.model, 0, 0),
                         provenance=side.provenance.mark_origin(
                             st.provenance, 0, 0, rnd=4))
        st = st._replace(faults=side.faults.crash(st.faults, 7))
        return cl.steps(st, 20)

    out = three_way(lambda s: dict(n_nodes=16, seed=3, inbox_cap=24,
                                   provenance=True, provenance_ring=64,
                                   monotonic_shed=False),
                    drive, 8, model="RumorMongering", label="provenance")
    snap = prov_mod.snapshot(out["sharded"].provenance)
    assert snap["gossip_total"] > 0
    assert (snap["parent"][:, 0] >= 0).sum() > 1
