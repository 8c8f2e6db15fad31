"""Where a steady round of the PyTorch port spends its time on the card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_profile_round.py [--n 32768] [--rounds 10]

Brings the bench configuration (bench.py's, every plane off) to a
converged broadcast at ``--n`` nodes with ``scenarios.bench_broadcast``,
the same call chip_smoke.py's main path makes, then traces ``--rounds`` steady rounds with torch.profiler
and prints JSON lines: the window's wall time, the summed device time
of its kernels and the device idle share, kernel launches per round,
and the kernels with the most device time.  One more window traces
``record`` over ``--rounds`` rounds (the capture arm with the
interleave kernel), and a third the same ``record`` under an all-pass
``OmissionSchedule`` (the Filibuster path's round: the generic wire
arm with interposition).  With ``--planes`` two more windows follow:
the same steady rounds with metrics, latency and provenance on, and
with a 4-round flight ring as well (the generic arm, one interleave a
round).  The card's name and power limit ride every line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from partisan_tpu_torch import cluster as cluster_mod  # noqa: E402
from partisan_tpu_torch import interpose  # noqa: E402
from partisan_tpu_torch import scenarios as sc  # noqa: E402


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _dev_time(e) -> float:
    """Self device time of a profiler average, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def window(fn, rounds: int, label: str, top: int, tag: str) -> dict:
    """Time ``fn`` bare (its wall is the metric), then again under the
    profiler for device time per kernel; the idle share compares the
    device time against the bare wall (the profiler inflates the host
    side, not the kernels)."""
    wall = _wall(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = _wall(fn)
    kern = [e for e in prof.key_averages()
            if _dev_time(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(_dev_time(e) for e in kern)
    launches = sum(e.count for e in kern)
    kern.sort(key=_dev_time, reverse=True)
    return {"window": label, "card": tag, "rounds": rounds,
            "wall_ms_per_round": wall * 1e3 / rounds,
            "profiled_wall_ms_per_round": wall_prof * 1e3 / rounds,
            "device_ms_per_round": busy_us / 1e3 / rounds,
            "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
            "kernel_launches_per_round": launches / rounds,
            "top_kernels": [{"name": e.key[:90],
                             "ms_per_round": _dev_time(e) / 1e3 / rounds,
                             "calls_per_round": e.count / rounds}
                            for e in kern[:top]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--planes", action="store_true",
                    help="also profile the round with the planes on, and "
                         "with a flight ring")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_round: no CUDA device", file=sys.stderr)
        return 2
    tag = card()
    n = args.n
    run = sc.bench_broadcast(n)
    cl, st, conv = run["cluster"], run["state"], run["converged_round"]
    st = cl.steps(st, sc.K_PROG)                      # warm-up
    cl.record(st, 1)           # builds and loads the interleave kernel

    def steady():
        cl.steps(st, args.rounds)

    print(json.dumps({"n": n, "converged_round": conv,
                      **window(steady, args.rounds, "steady", args.top,
                               tag)}), flush=True)

    def rec():
        cl.record(st, args.rounds)

    print(json.dumps({"n": n, **window(rec, args.rounds, "record", args.top,
                                       tag)}), flush=True)

    sched = interpose.OmissionSchedule(
        np.zeros((1, n, 80), np.bool_), start=int(st.rnd))
    cl_om = cluster_mod.Cluster(cl.cfg, model=cl.model, interpose=sched)
    st_om = st._replace(interpose=sched.init(cl_om.cfg, cl_om.comm))
    cl_om.record(st_om, 1)

    def rec_om():
        cl_om.record(st_om, args.rounds)

    print(json.dumps({"n": n, **window(rec_om, args.rounds,
                                       "record_omission", args.top, tag)}),
          flush=True)
    if not args.planes:
        return 0
    from partisan_tpu_torch import latency

    run = sc.bench_broadcast(n, metrics=True, latency=True, provenance=True)
    cl_p, st_p = run["cluster"], run["cluster"].steps(run["state"],
                                                      sc.K_PROG)
    print(json.dumps({"n": n, **window(
        lambda: cl_p.steps(st_p, args.rounds), args.rounds,
        "steady_planes", args.top, tag)}), flush=True)
    cfg_f = cl_p.cfg.replace(flight_rounds=4)
    cl_f = cluster_mod.Cluster(cfg_f, model=cl_p.model)
    st_f = st_p._replace(flight=latency.flight_init(
        cfg_f, cl_f.flight_shape(st_p), device=st_p.rnd.device))
    print(json.dumps({"n": n, **window(
        lambda: cl_f.steps(st_f, args.rounds), args.rounds,
        "flight_planes", args.top, tag)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
