"""bench.py at n=2048 with the metrics, latency and provenance planes on,
in the port against the JAX reference on the CPU: ``bench.run(2048,
metrics=True, latency=True, provenance=True)`` and the port's
``scenarios.bench_broadcast`` with the same flags (bench's own width
ladder) converge on the same round, with the same ``Stats`` and the
same stderr lines (the metrics rows and totals, the latency
percentiles, the provenance headline).  The figures the JAX package
gives at this size are pinned too, and the planes-off run converges on
the same round with every protocol leaf equal.  Tolerance 0."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import bench
from partisan_tpu_torch import metrics as tmetrics
from partisan_tpu_torch import scenarios as tsc
from partisan_tpu_torch import state_io

torch.set_num_threads(1)

N = 2048
PLANES = dict(metrics=True, latency=True, provenance=True)


@pytest.fixture(scope="module")
def runs():
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        jres = bench.run(N, **PLANES)
    lines = [json.loads(x) for x in err.getvalue().splitlines()
             if x.startswith("{")]
    return jres, lines, tsc.bench_broadcast(N, device="cpu", **PLANES)


def test_lines_match_bench(runs):
    jres, lines, trun = runs
    st, cfg = trun["state"], trun["cluster"].cfg
    assert trun["converged_round"] == jres["converged_round"] == 60
    assert trun["start_round"] == 50
    assert int(st.stats.emitted) == jres["emitted"] == 65306
    assert int(st.stats.dropped) == jres["dropped"] == 1008
    names = tuple(c.name for c in cfg.channels)
    rows = [{"kind": "metrics", "n": N, **r} for r in tmetrics.rows(
        tmetrics.snapshot(st.metrics), channels=names)]
    mine = tsc.bench_planes_report(cfg, st)
    assert json.loads(json.dumps(rows + mine)) == lines


def test_reference_figures(runs):
    tot, lat, prov = tsc.bench_planes_report(runs[2]["cluster"].cfg,
                                             runs[2]["state"])
    assert (tot["emitted"], tot["delivered"], tot["dropped"]) \
        == (65306, 64298, 1008)
    assert tot["drops_by_cause"]["inbox_overflow"] == 1008
    assert lat["default"]["count"] == 64287
    assert lat["broadcast"]["count"] == 11
    assert all(lat[c]["p99"] in (0, None) for c in lat
               if isinstance(lat[c], dict))
    assert (prov["gossip_delivered"], prov["claimed"]) == (6, 7)
    assert (prov["coverage_round"], prov["tree_depth_max"]) == (-1, 2)


def test_planes_off_same_round_and_protocol_leaves(runs):
    on = runs[2]
    off = tsc.bench_broadcast(N, device="cpu")
    assert off["converged_round"] == on["converged_round"]
    a = dict(state_io.flatten(state_io.state_to_numpy(on["state"])))
    b = dict(state_io.flatten(state_io.state_to_numpy(off["state"])))
    words = [p for p in a if p.startswith("inbox.data.")]
    assert len(words) == len([p for p in b
                              if p.startswith("inbox.data.")]) + 3
    # every leaf of the off run, the inbox's word planes too: the
    # widened wire carries the planes' words after the record's
    assert set(b) <= set(a)
    for p in b:
        np.testing.assert_array_equal(a[p], b[p], err_msg=p)
