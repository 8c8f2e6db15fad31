"""Scenario-suite parity: the PyTorch port's configs 1-6 and the
HyParView view-size check against the JAX reference on the CPU at small
n.  Every returned field must equal the reference's except the wall-clock
ones (``rounds_per_sec``, config 5's ``convergence_wall_sec``, each config
6 row's ``measured_wall_s``)."""

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
    "config5": (lambda m, **kw: m.config5_causal_crash(
        n=128, senders=8, crashes=4, **kw)),
    "config6": (lambda m, **kw: m.config6_echo(
        sizes_kb=(1024, 8192), concurrency=(1, 4), latencies_ms=(1, 100),
        num_messages=10, **kw)),
}

WALL_KEYS = ("rounds_per_sec", "convergence_wall_sec", "measured_wall_s")


def strip(d: dict) -> dict:
    """The dict without its wall-clock fields (config 6's rows too)."""
    return {k: [strip(r) for r in v] if k == "rows" else v
            for k, v in d.items() if k not in WALL_KEYS}


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
    if name == "config5":
        assert got["causal_deliveries"] == got["causal_expected"] == 16
        assert got["fifo_ok_receivers"] == got["n_receivers"]
        assert got["convergence_rounds"] > 0
        assert got["convergence_wall_sec"] > 0
    if name == "config6":
        assert got["cells"] == 8
        assert all(r["measured_wall_s"] > 0 for r in got["rows"])


def test_config6_orderings_and_csv(tmp_path):
    """tests/test_channels.py::test_echo_scenario_matrix_shape_and_scaling
    on the port, at its size (30 round trips): more concurrency over one
    lane costs rounds, payload size and latency scale time and not
    rounds, four lanes relieve four senders; and the CSV holds the
    reference's columns."""
    csv = tmp_path / "echo.csv"
    res = tsc.config6_echo(sizes_kb=(1024, 8192), concurrency=(1, 4),
                           latencies_ms=(1, 100), parallelism=1,
                           num_messages=30, csv_path=str(csv),
                           device="cpu")
    by = {(r["concurrency"], r["bytes"], r["latency"]): r
          for r in res["rows"]}
    mb = 1024 * 1024
    assert res["cells"] == 8
    assert by[(4, mb, 1)]["rounds"] > by[(1, mb, 1)]["rounds"]
    assert by[(1, 8 * mb, 1)]["time"] > by[(1, mb, 1)]["time"]
    assert by[(1, mb, 100)]["time"] > by[(1, mb, 1)]["time"]
    assert by[(1, 8 * mb, 1)]["rounds"] == by[(1, mb, 1)]["rounds"]
    res4 = tsc.config6_echo(sizes_kb=(1024,), concurrency=(4,),
                            latencies_ms=(1,), parallelism=4,
                            num_messages=30, device="cpu")
    assert res4["rows"][0]["rounds"] < by[(4, mb, 1)]["rounds"]
    lines = csv.read_text().splitlines()
    assert lines[0] == ("backend,concurrency,parallelism,bytes,"
                        "nummessages,latency,time,rounds,measured_wall_s,"
                        "measured")
    assert len(lines) == 9
    first = dict(zip(lines[0].split(","), lines[1].split(",")))
    row = res["rows"][0]
    assert first["time"] == str(row["time"])
    assert first["rounds"] == str(row["rounds"])


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


def test_run_all_sizes_configs_5_and_6(monkeypatch):
    """``run_all`` hands configs 5 and 6 the reference's arguments: n from
    ``DEFAULT_SIZES`` (100,000 for config 5) and, for config 6,
    ``num_messages=max(50, int(1000 * scale))``."""
    assert tsc.DEFAULT_SIZES == {k: v for k, v in jsc.DEFAULT_SIZES.items()
                                 if k in tsc.ALL}
    calls = {"j": [], "t": []}
    for side, mod in (("j", jsc), ("t", tsc)):
        monkeypatch.setattr(mod, "ALL", {
            i: (lambda i=i, side=side, **kw: calls[side].append(
                (i, {k: v for k, v in kw.items() if k != "device"})) or {})
            for i in (5, 6)})
    for scale in (0.00128, 0.2, 1.0):
        jsc.run_all(scale=scale, only=[5, 6])
        tsc.run_all(scale=scale, only=[5, 6], device="cpu")
    assert calls["t"] == calls["j"]
    assert calls["t"][-2:] == [(5, {"n": 100_000}),
                               (6, {"num_messages": 1000})]


@pytest.mark.parametrize("fn", [
    lambda: tsc.config1_anti_entropy(n=8),
    lambda: tsc.config2_rumor(n=8),
    lambda: tsc.config3_plumtree_drop(n=8),
    lambda: tsc.config4_scamp_churn(n=8),
    lambda: tsc.hyparview_views(n=8),
    lambda: tsc.config5_causal_crash(n=32),
    lambda: tsc.config6_echo(sizes_kb=(1024,), concurrency=(1,),
                             latencies_ms=(1,), num_messages=2),
    lambda: tsc.run_all(only=[1]),
])
def test_entry_points_default_to_the_card(fn):
    if torch.cuda.is_available():
        assert tsc.make_cluster_auto(tsc.bench_config(8)).device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()
