"""Scenario-suite parity: the PyTorch port's configs 1-4 and the
HyParView view-size check against the JAX reference on the CPU at small
n.  Every returned field must equal the reference's except
``rounds_per_sec`` (a wall-clock rate)."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from partisan_tpu import scenarios as jsc
from partisan_tpu_torch import scenarios as tsc

torch.set_num_threads(1)

CASES = {
    "config1": (lambda m, **kw: m.config1_anti_entropy(n=16, **kw)),
    "config2": (lambda m, **kw: m.config2_rumor(n=128, **kw)),
    "config3": (lambda m, **kw: m.config3_plumtree_drop(n=128, **kw)),
    "config4": (lambda m, **kw: m.config4_scamp_churn(n=64, rounds=40,
                                                      **kw)),
    "hyparview_views": (lambda m, **kw: m.hyparview_views(n=128, **kw)),
}


def strip(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "rounds_per_sec"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_scenario_dict_equals_reference(name):
    want = CASES[name](jsc)
    got = CASES[name](tsc, device="cpu")
    assert sorted(got) == sorted(want)
    assert strip(got) == strip(want)
    assert got.get("rounds_per_sec", 1) > 0
    if name == "config3":
        assert 0 <= got["repair_rounds"] <= got["expected_max_repair_rounds"]
    if name == "hyparview_views":
        assert got["components"] == 1 and got["healthy"]


def test_health_opt_in_digest_convergence(monkeypatch):
    """``--health`` (snapshots every K_PROG rounds): config 3 converges
    on the digest poll at the round the coverage poll finds, and equals
    the reference run with its plane on."""
    off = tsc.config3_plumtree_drop(n=64, device="cpu")
    monkeypatch.setattr(tsc, "HEALTH", True)
    monkeypatch.setattr(jsc, "HEALTH", True)
    on = tsc.config3_plumtree_drop(n=64, device="cpu")
    assert strip(on) == strip(off)
    assert strip(on) == strip(jsc.config3_plumtree_drop(n=64))


def test_scamp_ideal_mean_equals_reference():
    for n in (8, 150, 400):
        assert tsc.scamp_ideal_mean(n) == jsc.scamp_ideal_mean(n)
    assert tsc.scamp_ideal_mean(150, v2=False) == \
        jsc.scamp_ideal_mean(150, v2=False)
    assert tsc.rumor_fixed_point(2) == jsc.rumor_fixed_point(2)


def test_cli_prints_the_reference_line():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tsc.main(["--only", "1", "--scale", "1",
                         "--device", "cpu"]) == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    assert strip(json.loads(lines[0])) == strip(jsc.config1_anti_entropy())
    assert [strip(r) for r in tsc.run_all(scale=0.5, only=[1],
                                          device="cpu")] == \
        [strip(r) for r in jsc.run_all(scale=0.5, only=[1])]


@pytest.mark.parametrize("fn", [
    lambda: tsc.config1_anti_entropy(n=8),
    lambda: tsc.config2_rumor(n=8),
    lambda: tsc.config3_plumtree_drop(n=8),
    lambda: tsc.config4_scamp_churn(n=8),
    lambda: tsc.hyparview_views(n=8),
    lambda: tsc.run_all(only=[1]),
])
def test_entry_points_default_to_the_card(fn):
    if torch.cuda.is_available():
        assert tsc.make_cluster_auto(tsc.bench_config(8)).device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()
