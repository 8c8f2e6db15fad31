"""The sharded cluster against the JAX reference on the CPU: the planes'
sharded cases — tests/test_metrics.py's series and
tests/test_latency.py's histograms (every value reduced before it is
written).  Helpers in test_torch_sharded.py."""

import numpy as np
import torch

from test_torch_sharded import join_all, three_way

torch.set_num_threads(1)


def crash_and_drop(side, cl, link_drop):
    """tests/test_metrics.py's drive: boot, 10 rounds, a broadcast, node
    7 crashed (and a lossy link), 30 rounds."""
    st = cl.steps(join_all(side, cl, cl.init()), 10)
    st = st._replace(model=cl.model.broadcast(st.model, 0, 0))
    f = side.faults.crash(st.faults, 7)
    if link_drop:
        f = side.link_drop(f, 0.2)
    return cl.steps(st._replace(faults=f), 30)


def test_sharded_series_match_single_device():
    from partisan_tpu_torch import metrics as metrics_mod

    out = three_way(lambda s: dict(n_nodes=16, seed=3, metrics=True,
                                   metrics_ring=64, inbox_cap=24),
                    lambda side, cl: crash_and_drop(side, cl, True), 8,
                    model="AntiEntropy", label="metrics")
    tot = metrics_mod.totals(metrics_mod.snapshot(out["sharded"].metrics))
    assert tot["emitted"] > 0 and tot["dropped"] > 0


def test_sharded_histograms_match_single_device():
    from partisan_tpu_torch import latency as latency_mod

    out = three_way(lambda s: dict(n_nodes=16, seed=3, latency=True,
                                   inbox_cap=24),
                    lambda side, cl: crash_and_drop(side, cl, True), 8,
                    model="AntiEntropy", label="latency")
    snap = latency_mod.snapshot(out["sharded"].latency)
    assert np.asarray(snap["deliver"]).sum() > 0
