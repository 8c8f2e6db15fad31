"""Drive the PyTorch port (partisan_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. environment card: torch / CUDA / nvcc versions (and the installed
   Triton's, which the port does not use), the card's name and power
   limit;
2. build: one nvcc call compiles both CUDA kernels
   (partisan_tpu_torch/csrc/interleave.cu and minimal.cu) into one
   library under build/partisan_tpu_torch/; its seconds and the
   compiler's register, shared-memory and spill report;
3. kernel check: the interleave against its plain PyTorch version, bit
   for bit, at the main path's shape and a ragged one, then at ragged
   tails of each dtype, planes that are views at an odd element offset,
   W in {1, 12, 16, 32}, W=13 at the Paxos record's dtypes (flat, and
   at phase 16's [5, 7] planes into an out= slice of its [40, 5, 7, 13]
   trace buffer as Cluster.record writes it), W=19 at the bench path's
   dtypes with metrics, latency and provenance on (16 protocol planes,
   int32 source, int16 hop, int32 birth: the path's [32768, 77] planes
   flat, and into one slot of a [4, 32768, 77, 19] flight ring), an out=
   slice of a [3, ...] buffer and an output that is not 16-byte aligned.
   At the main shape and at W=19: its time by
   CUDA events (ms), its own device time per call from a torch.profiler
   window (device_ms), the host's wall per call of back-to-back calls
   with no synchronize (host_ms), the plain version's time, the time of
   one library call computing the same function (torch.stack on the
   mixed-dtype planes) and the least time the card could take;
4. GPU vs CPU parity at n=512: bootstrap ladder, broadcast, convergence
   and record(5) on the card and on the CPU — every state leaf and both
   trace leaves bit-identical (the CPU path is what the tests hold
   against the JAX reference);
5. the main path at n=32768 (bench.py's configuration, every plane
   off): init, the width-operand ladder [8192, 32768], one broadcast
   from node 0 slot 0 stepped to coverage 1.0, steady rounds/s, then
   record(10).  Kernel launch counts are reset just before and read
   just after; every kernel of the path must have launched;
6. the probe path (partisan_tpu_torch.probe: the minimal kernel at
   [256, 256], the interleave on int32 planes at n=8192 and 32768),
   counts reset just before and read just after, each interleave timed
   as in phase 3 beside permute(1, 2, 0).contiguous(); then the minimal
   kernel against its plain version and torch.mul, bit for bit, at
   [256, 256], a ragged [1000, 37] and on views at odd element offsets,
   with its times and bound;
7. Filibuster parity, small: the three checker setups of
   tests/test_filibuster.py (N=6 full mesh, direct mail unacked and
   acked, max_faults 1 and 2) on the card and on the CPU — every Result
   field identical — and the bench configuration at n=512 under a
   fixed OmissionSchedule, record(5): trace and every state leaf
   identical;
8. the Filibuster path at full width: the bench configuration at
   n=32768 booted by phase 5's ladder, the broadcast from node 0
   queued, a checker over node 0's PT_GOSSIP sends in the broadcast
   round (horizon 24, sched_width 80, max_faults 1, max_executions 4,
   assertion coverage 1.0); counts reset just before and read just
   after, and the interleave must have launched horizon times per
   record call;
9. scenario parity, small: the scenario suite's configs 1-4 and
   hyparview_views on the card and on the CPU (config 1 at n=16,
   configs 2 and 3 at n=128, config 4 at n=128 with rounds=40,
   hyparview_views at n=128): every returned field identical except
   rounds_per_sec; then config 3 at n=128 with the health plane on
   (snapshots every K_PROG rounds): the digest-polled convergence round
   equals the coverage-polled one, and the final health ring and every
   other state leaf are identical on card and CPU;
10. the scenario suite at the reference's default sizes on the card:
   config 1 at n=16, config 2 at n=1000, config 3 at n=10000, config 4
   at n=10000 (rounds=120) and hyparview_views at n=1000, each config's
   JSON line with its wall seconds split into boot and the rest; config
   3 must meet its repair-round bound, config 4 its in_band, and
   hyparview_views must report one component.  Kernel counts are reset
   just before and read just after (these paths launch neither kernel);
11. causal and channel parity, small: the scenario suite's config 5 at
   n=128 (senders 8, crashes 4) and config 6 over its test matrix
   (1 and 8 MiB, concurrency 1 and 4, 1 and 100 ms, 10 round trips) on
   the card and on the CPU — every returned field identical except the
   wall-clock ones — and one point-to-point lane setup (n=16, two-bucket
   tables, 30% loss) and one causal broadcast setup (n=8 full mesh, a
   partition healed) of tests/test_torch_delivery.py: every state leaf
   identical after every round;
12. config 5 at the reference's default n=100,000 on the card: it must
   deliver all 128 causal messages, FIFO at all 64 receivers, and
   converge; its wall split into boot, convergence, the throughput
   instrument and the rest (scripting, drain, the log check), its
   rounds/s, the peak of torch.cuda.max_memory_allocated, and a profiled
   K_PROG-round window from the scripted state (the sends and the
   broadcast in flight) and one from the drained state: kernel launches,
   host reads and device time per round;
13. config 6 at n=2 over the reference's 48-cell matrix (4 sizes x 4
   concurrencies x 3 latencies) at 50 round trips per sender (run_all's
   floor): every cell's echoes equal concurrency x 50; its rows, its
   seconds, and a profiled window of one cell's rounds.  Kernel counts
   are reset just before phases 11, 12 and 13 and read just after each
   (these paths launch neither kernel);
14. app parity, small: the setups of tests/test_paxos.py (n=5: one
   proposer; competing proposers), tests/test_commit.py (n=6, each
   variant: fault-free; a partitioned participant; two coordinators of
   one slot, so that every node takes two PREPAREs for it in one round
   and must keep the later inbox slot's) and
   tests/test_alsberg.py (n=5, acked and unacked: a write, then a
   same-round write collision) on the card and on the CPU, every state
   leaf identical after every round;
15. the property harness on the card and on the CPU: tests/test_paxos.py's
   two runs (PaxosSystem at the fault budget; the unsafe_adopt canary,
   which must fail and shrink to at most 3 proposals), tests/test_prop.py's
   ReliableBroadcast (acked) and PrimaryBackup runs and AtomicCommit CTP
   at seed 3: every RunResult field and render() identical, the cached
   boot state unchanged; per run on the card its wall and executions
   (runs and shrink trials) per second, and one more execution of its
   script profiled as phase 17's windows are (launches, host reads,
   copies, device time, idle share);
16. Filibuster over Paxos (tests/test_paxos.py's checker: n=5, seed 11,
   horizon 40, max_faults 1, max_executions 60) on the card and on the
   CPU: the Result identical (PASSED, 60 executions, 0 pruned, 95
   candidates) and every record call's [40, 5, 7, 13] trace identical,
   the card's written by the interleave kernel and the CPU's by its
   plain version; counts reset just before and read just after the card's
   search, the interleave launched 40 times per record call;
   executions per second split into device rounds, trace copy and host
   decode;
17. the traffic suite's app models at n=48 (scenarios.app_model: Paxos,
   Lampson 2PC, Alsberg-Day with the reference's Config extras and app
   script, seed 29, 240 rounds, no traffic plane) on the card, each
   final state identical to the CPU's: Paxos decides both decrees at 48
   of 48 nodes with agreement, 2PC commits 96 (node, slot) pairs with
   agreement, Alsberg-Day acks both writes and replicates key 0; each
   model's wall, ms per round, and a K_PROG-round window from its first
   app event under torch.profiler (launches, host reads, device time,
   idle share).  Kernel counts are reset just before phases 14, 15 and
   17 and read just after each.  Phase 15 profiles one extra execution
   of its first run only;
18. the planes, small, on the card and on the CPU, every state leaf
   identical after every round: the bench configuration at n=512 with
   metrics, latency and provenance on (fast wire arm); the same with a
   4-round flight ring (generic arm), whose decoded Trace must equal
   Cluster.record's last 4 of 6 rounds; config 8 at n=48, both arms, 3
   waves; the fanout governor's arm at n=64 (4 waves) and the healing
   arm at n=64, both adaptive;
19. the bench path at n=32768 with metrics, latency and provenance on
   (scenarios.bench_broadcast): it must converge on phase 5's round at
   coverage 1.0, the metrics books must close (causes sum to emitted -
   delivered, equal to Stats) and the latency counts per channel must
   equal the metrics ring's delivered per channel; bench.py's metrics
   totals, latency percentiles and provenance lines; ms per round with
   the planes on and off (one call), K_PROG-round profiled windows
   (launches and host reads per round: the planes add no host read),
   the launches each plane adds alone, the peak memory;
20. the flight ring at full width: phase 19's booted state with a
   4-round ring, the broadcast queued, 20 rounds by steps (the
   interleave must launch once a round) and the same 20 by record; the
   ring's Trace equals record's last 4 rounds bit for bit, both final
   states identical; ms per round with the ring against without it, the
   kernel's device time per launch, the peak memory;
21. the controllers' A/B (scenarios.control_ab at scale 1.0) on the card:
   every arm's dict equal to the JAX package's (JAX_CONTROL_AB) and
   all_win true; each arm's wall, ms per round and, over its first 3
   rounds after the boot under torch.profiler, launches, host reads and
   device time per round.  Kernel counts are
   reset just before phases 18-21 and read just after each;
22. the kernels line, the card line, and last the result line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
N_MAIN = 32768
N_PARITY = 512
FB_N = 6                    # tests/test_filibuster.py's checker setups
FB_HORIZON = 12
FULL_HORIZON = 24           # the full-width Filibuster phase
FULL_SCHED_WIDTH = 80       # >= the bench path's 77-slot emission width
FULL_MAX_EXECUTIONS = 4
N_CONFIG5 = 100_000         # the reference's DEFAULT_SIZES[5]
ECHO_MESSAGES = 50          # run_all's floor for config 6
PAXOS_FB_HORIZON = 40       # tests/test_paxos.py's Filibuster checker
PAXOS_FB_SENT = (5, 7)      # its record's [n, emitted slots] per round
N_APP = 48                  # the traffic suite's app-model size
APP_ROUNDS = 240
FLIGHT_K = 4                # flight_rounds of phases 18 and 20
FLIGHT_ROUNDS = 20          # phase 20's rounds after the broadcast
PROFILED_ROUNDS = 3         # rounds profiled per arm in phase 21
PLANES = dict(metrics=True, latency=True, provenance=True)

# scenarios.control_ab(scale=1.0) of the JAX package on the CPU (jax
# 0.9.0), every arm's dict with the state handle stripped: phase 21 holds
# the port on the card to these values.
JAX_CONTROL_AB = {
    "fanout": {
        "metric": "steady_redundancy_ratio", "n": 128,
        "static": {"redundancy_ratio": 0.8124,
                   "steady_redundancy_ratio": 0.8326, "coverage": 1.0},
        "adaptive": {"redundancy_ratio": 0.7416,
                     "steady_redundancy_ratio": 0.7282, "coverage": 1.0,
                     "eager_cap": 2, "fanout_adjustments": 12},
        "win": True, "coverage_ok": True},
    "fanout_calm": {
        "static": {"redundancy_ratio": 0.6595, "coverage": 0.9844},
        "adaptive": {"redundancy_ratio": 0.6595, "coverage": 0.9844,
                     "eager_cap": 5, "fanout_adjustments": 1,
                     "quiet_adjustments": 0},
        "no_regression": True},
    "backpressure": {
        "metric": "p99_delivery_age", "n": 96,
        "static": {
            "config": 8, "n": 96, "adaptive": False, "waves": 10,
            "wave_len": 12, "coverage": 1.0, "outbox_shed": 2,
            "p99": {"default": 7, "partisan_membership": None,
                    "rpc": None, "broadcast": 7},
            "age_max": {"default": 11, "partisan_membership": 0, "rpc": 0,
                        "broadcast": 9},
            "delivered": {"default": 8625, "partisan_membership": 0,
                          "rpc": 0, "broadcast": 24695}},
        "adaptive": {
            "config": 8, "n": 96, "adaptive": True, "waves": 10,
            "wave_len": 12, "coverage": 1.0, "outbox_shed": 324,
            "p99": {"default": 3, "partisan_membership": None,
                    "rpc": None, "broadcast": 3},
            "age_max": {"default": 4, "partisan_membership": 0, "rpc": 0,
                        "broadcast": 4},
            "delivered": {"default": 8171, "partisan_membership": 0,
                          "rpc": 0, "broadcast": 24091},
            "control": {"press": [0, 0, 0, 1]}},
        "win": True, "coverage_ok": True},
    "healing": {
        "metric": "rounds_to_heal", "n": 128,
        "static": {"rounds_to_heal": 70},
        "adaptive": {"rounds_to_heal": 15, "heal_boost": 2},
        "win": True},
    "all_win": True,
}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def nvcc_version() -> str:
    from partisan_tpu_torch import kernels

    out = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[-1] if out.stdout else "?"


def time_ms(fn, reps: int = 20) -> float:
    """Mean time of one call, from CUDA events over ``reps`` calls after a
    warm-up (the inputs exceed the 50 MB L2 at the main shape, so every
    call reads device memory).  Where the host takes longer to launch a
    call than the card to run it, this is the host's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def window_counts(prof) -> dict:
    """One pass over a finished torch.profiler window's raw events:
    the card's kernels and copies (how many, their summed device
    microseconds, both also per name), the copies each way, and the host
    reads (``aten::_local_scalar_dense``: every ``bool()``/``int()`` of a
    card tensor).  ``key_averages`` gives the same counts but builds an
    event tree first, about 2 s a round at bench's 3500 launches."""
    from torch._C._autograd import DeviceType

    out = {"launches": 0, "device_us": 0.0, "host_reads": 0, "dtoh": 0,
           "htod": 0, "by_name": {}}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            us = e.duration_ns() / 1e3
            if us <= 0:
                continue
            out["launches"] += 1
            out["device_us"] += us
            n, t = out["by_name"].get(name, (0, 0.0))
            out["by_name"][name] = (n + 1, t + us)
            out["dtoh"] += "DtoH" in name
            out["htod"] += "HtoD" in name
        elif name == "aten::_local_scalar_dense":
            out["host_reads"] += 1
    return out


def device_host_ms(fn, reps: int = 20) -> tuple:
    """``(device_ms, host_ms)`` per call: the summed self device time of
    the kernels ``fn`` runs, from a torch.profiler window over ``reps``
    calls, and the host's wall per call over ``reps`` back-to-back calls
    with no synchronize inside (the launch path's cost)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return window_counts(prof)["device_us"] / 1e3 / reps, host


def timed(fn, reps: int = 20) -> dict:
    device, host = device_host_ms(fn, reps)
    return {"ms": time_ms(fn, reps), "device_ms": device, "host_ms": host}


def cuda_random(shape, dt, gen, offset: int = 0) -> torch.Tensor:
    """Random values over ``dt``'s whole range on the card; with
    ``offset`` a view that starts that many elements into its buffer,
    so not 16-byte aligned."""
    info = torch.iinfo(dt)
    vals = torch.randint(info.min, info.max, shape, generator=gen,
                         device="cuda", dtype=torch.int64).to(dt)
    buf = torch.empty(math.prod(shape) + offset, dtype=dt, device="cuda")
    view = buf[offset:].view(shape)
    view.copy_(vals)
    return view


def interleave_exact(ws, out=None) -> dict:
    """One interleave launch against the plain version, bit for bit."""
    from partisan_tpu_torch import kernels
    from partisan_tpu_torch.ops import plane as plane_ops

    before = kernels.launches["interleave"]
    got = plane_ops.interleave(plane_ops.Planes(ws), out=out)
    torch.cuda.synchronize()
    if kernels.launches["interleave"] != before + 1:
        raise AssertionError("interleave wrapper did not launch its kernel")
    want = plane_ops.interleave_plain(ws)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"interleave kernel disagrees on "
                             f"{len(ws)} planes of {tuple(ws[0].shape)}: "
                             f"max abs err {err}")
    return {"records": ws[0].numel(), "words": len(ws), "max_abs_err": err,
            "got": got}


def kernel_check(shape, dtypes, seed: int) -> dict:
    """The interleave kernel against its plain version on the card, with
    its times beside the plain version's, the library call's and the
    bound."""
    from partisan_tpu_torch.ops import plane as plane_ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ws = [cuda_random(shape, dt, gen) for dt in dtypes]
    planes = plane_ops.Planes(ws)
    res = interleave_exact(ws)
    got = res.pop("got")
    # the library call: torch.stack promotes the mixed-dtype planes itself
    if not torch.equal(torch.stack(ws, dim=-1), got):
        raise AssertionError(f"torch.stack disagrees at {shape}")
    del got
    nbytes = sum(w.numel() * w.element_size() for w in ws) \
        + math.prod(shape) * len(ws) * 4
    lib_dev, _ = device_host_ms(lambda: torch.stack(ws, dim=-1))
    return {
        "shape": list(shape), **res,
        **timed(lambda: plane_ops.interleave(planes)),
        "plain_ms": time_ms(lambda: plane_ops.interleave_plain(ws)),
        "library_ms": time_ms(lambda: torch.stack(ws, dim=-1)),
        "library_device_ms": lib_dev,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bytes": nbytes,
    }


def interleave_edges(bench_dtypes, paxos_dtypes, plane_dtypes,
                     seed: int) -> list:
    """The interleave, bit for bit, where its edge paths run: ragged
    tails of each dtype, planes that are views at an odd element offset,
    W in {1, 12, 16, 32}, W=13 at the Paxos record's dtypes (flat, and
    at phase 16's shape into one round's slice of its [40, 5, 7, 13]
    trace buffer), W=19 at the bench path's dtypes with every plane on
    (the path's [n, 77] planes flat, and into one slot of a
    [4, n, 77, 19] flight ring), an out= slice of a [3, ...] buffer (as
    Cluster.record passes) and an output that is not 16-byte
    aligned."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mixed = [torch.int8, torch.int16, torch.int32]
    out = []
    for dt in mixed:
        for m in (1, 15, 513, 65553):
            ws = [cuda_random((m,), dt, gen) for _ in range(16)]
            out.append({"case": f"ragged {dt}", **interleave_exact(ws)})
        ws = [cuda_random((1541,), dt, gen, offset=1) for _ in range(16)]
        out.append({"case": f"unaligned {dt}", **interleave_exact(ws)})
    ws = [cuda_random((N_MAIN, 7), dt, gen, offset=i % 2)
          for i, dt in enumerate(bench_dtypes)]
    out.append({"case": "half unaligned, bench dtypes",
                **interleave_exact(ws)})
    for W in (1, 12, 16, 32):
        ws = [cuda_random((70001,), mixed[i % 3], gen) for i in range(W)]
        out.append({"case": f"W={W}", **interleave_exact(ws)})
    ws = [cuda_random((70001,), dt, gen) for dt in paxos_dtypes]
    out.append({"case": "W=13, Paxos dtypes", **interleave_exact(ws)})
    ws = [cuda_random(PAXOS_FB_SENT, dt, gen) for dt in paxos_dtypes]
    buf = torch.full((PAXOS_FB_HORIZON,) + PAXOS_FB_SENT + (13,), -7,
                     dtype=torch.int32, device="cuda")
    res = interleave_exact(ws, out=buf[7])
    if not bool((buf[:7] == -7).all() & (buf[8:] == -7).all()):
        raise AssertionError("interleave into out=buf[7] wrote elsewhere")
    out.append({"case": f"W=13, Paxos dtypes, out=buf[7] of "
                        f"{list(buf.shape)}", **res})
    ws = [cuda_random((N_MAIN, 77), dt, gen) for dt in plane_dtypes]
    out.append({"case": "W=19, bench dtypes with the planes, "
                        f"[{N_MAIN}, 77]", **interleave_exact(ws)})
    ring = torch.full((FLIGHT_K, N_MAIN, 77, 19), -7, dtype=torch.int32,
                      device="cuda")
    res = interleave_exact(ws, out=ring[2])
    if not bool((ring[:2] == -7).all() & (ring[3:] == -7).all()):
        raise AssertionError("interleave into out=ring[2] wrote elsewhere")
    out.append({"case": f"W=19, out=ring[2] of {list(ring.shape)}", **res})
    del ring, ws, res
    shape = (1000, 77)
    ws = [cuda_random(shape, dt, gen) for dt in bench_dtypes]
    buf = torch.full((3,) + shape + (16,), -7, dtype=torch.int32,
                     device="cuda")
    res = interleave_exact(ws, out=buf[1])
    if res["got"].data_ptr() != buf[1].data_ptr() \
            or not bool((buf[0] == -7).all() & (buf[2] == -7).all()):
        raise AssertionError("interleave into out=buf[1] wrote elsewhere")
    out.append({"case": "out=buf[1] of [3, 1000, 77, 16]", **res})
    flat = torch.full((math.prod(shape) * 16 + 1,), -7, dtype=torch.int32,
                      device="cuda")
    res = interleave_exact(ws, out=flat[1:].view(shape + (16,)))
    if int(flat[0]) != -7:
        raise AssertionError("interleave into an unaligned out wrote before "
                             "it")
    out.append({"case": "out not 16-byte aligned", **res})
    for r in out:
        del r["got"]
    return out


def minimal_check(shape, seed: int, offset: int = 0, timing: bool = True
                  ) -> dict:
    """The minimal kernel against its plain version and torch.mul on
    random int32 inputs (``x * 2`` wraps the same way in all three); with
    ``offset`` on a view that starts that many elements into its
    buffer."""
    from partisan_tpu_torch import kernels, probe

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = cuda_random(shape, torch.int32, gen, offset=offset)
    before = kernels.launches["minimal"]
    got = probe.minimal(x)
    torch.cuda.synchronize()
    if kernels.launches["minimal"] != before + 1:
        raise AssertionError("minimal wrapper did not launch its kernel")
    want = probe.minimal_plain(x)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want) or not torch.equal(torch.mul(x, 2), got):
        raise AssertionError(f"minimal kernel disagrees at {shape}: max abs "
                             f"err {err}")
    res = {"shape": list(shape), "offset": offset, "max_abs_err": err}
    if timing:
        nbytes = 2 * x.numel() * 4
        lib_dev, lib_host = device_host_ms(lambda: torch.mul(x, 2), 200)
        res.update(**timed(lambda: probe.minimal(x), reps=200),
                   plain_ms=time_ms(lambda: probe.minimal_plain(x), 200),
                   library_ms=time_ms(lambda: torch.mul(x, 2), 200),
                   library_device_ms=lib_dev, library_host_ms=lib_host,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
    return res


def ptxas_report() -> list:
    """The compiler's register / shared memory / spill lines for each
    kernel of the library."""
    from partisan_tpu_torch import kernels

    text = kernels.lib_path().with_suffix(".log").read_text()
    return [ln.split(":", 1)[1].strip() for ln in text.splitlines()
            if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln)] \
        + [ln.strip() for ln in text.splitlines() if "spill" in ln]


def state_leaves(tree):
    from partisan_tpu_torch import state_io

    return state_io.flatten(state_io.state_to_numpy(tree))


def assert_leaves_identical(la, lb, label: str) -> int:
    if len(la) != len(lb):
        raise AssertionError(f"{label}: {len(la)} vs {len(lb)} leaves")
    for (pa, xa), (_, xb) in zip(la, lb):
        if xa.dtype != xb.dtype or xa.shape != xb.shape \
                or not np.array_equal(xa, xb):
            raise AssertionError(f"{label}: leaf {pa} differs between the "
                                 "card and the CPU")
    return len(la)


def assert_identical(a, b, label: str) -> int:
    return assert_leaves_identical(state_leaves(a), state_leaves(b), label)


def drive_small(device: str):
    """The parity run: ladder, broadcast, convergence, record(5)."""
    from partisan_tpu_torch import scenarios as sc

    run = sc.bench_broadcast(N_PARITY, device=device,
                             widths=[N_PARITY // 2, N_PARITY])
    st, tr = run["cluster"].record(run["state"], 5)
    return run["boot_state"], st, tr, run["converged_round"]


def fb_setups(device: str) -> list:
    """tests/test_filibuster.py's three checker setups on ``device``:
    N=6 full mesh, every node joined via node 0 and 15 rounds settled,
    a direct-mail broadcast from node 0 queued."""
    from partisan_tpu_torch import filibuster
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.models.direct_mail import DirectMail

    results = []
    for acked, max_faults, max_exec in ((False, 1, 200), (True, 1, 200),
                                        (False, 2, 30)):
        model = DirectMail(acked=acked)

        def build(interp, model=model, acked=acked):
            cfg = Config(n_nodes=FB_N, seed=17, inbox_cap=max(32, FB_N + 8),
                         ack_cap=8 if acked else 0)
            cl = Cluster(cfg, model=model, interpose=interp, device=device)
            st = cl.init()
            m = st.manager
            for i in range(1, FB_N):
                m = cl.manager.join(cfg, m, i, 0)
            st = cl.steps(st._replace(manager=m), 15)
            return cl, st._replace(model=model.broadcast(st.model, 0, 0))

        def covered(cl, st, model=model):
            return float(model.coverage(st.model, st.faults.alive, 0)) == 1.0

        results.append(filibuster.Checker(
            build=build, horizon=FB_HORIZON, assertion=covered,
            candidate=filibuster.app_messages, max_faults=max_faults,
            max_executions=max_exec).run())
    return results


def result_fields(res) -> dict:
    return {"passed": res.passed, "executions": res.executions,
            "pruned": res.pruned, "candidates": res.candidates,
            "counterexample": None if res.counterexample is None
            else sorted(res.counterexample.schedule),
            "render": res.render()}


def omission_record(device: str, boot_state):
    """The bench configuration at n=512 under a fixed OmissionSchedule
    (5% of the slots of five rounds, from a seeded numpy draw): a
    broadcast from node 7, then record(5)."""
    from partisan_tpu_torch import interpose, scenarios as sc
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    start = int(boot_state.rnd)
    drops = np.random.default_rng(5).random((5, N_PARITY, 77)) < 0.05
    sched = interpose.OmissionSchedule(drops, start=start)
    model = Plumtree()
    cl = Cluster(sc.bench_config(N_PARITY), model=model, interpose=sched,
                 device=device)
    st = boot_state._replace(interpose=sched.init(cl.cfg, cl.comm),
                             model=model.broadcast(boot_state.model, 7, 0,
                                                   start))
    return cl.record(st, 5)


def timed_cluster(timing: dict, dev, traces: list | None = None):
    """A Cluster class whose ``record`` counts its calls and times the
    device rounds (ending in a synchronize) apart from the trace's copy to
    the host, into ``timing`` (keys records, record_s, copy_s); with
    ``traces``, each call's trace (on the host) is appended to it."""
    from partisan_tpu_torch import cluster as cluster_mod

    class TimedCluster(cluster_mod.Cluster):
        def record(self, state, k):
            t0 = time.perf_counter()
            st, tr = super().record(state, k)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            tr = tr._replace(sent=tr.sent.cpu(), dropped=tr.dropped.cpu(),
                             rnd=tr.rnd.cpu())
            timing["records"] += 1
            timing["record_s"] += t1 - t0
            timing["copy_s"] += time.perf_counter() - t1
            if traces is not None:
                traces.append(tr)
            return st, tr

    return TimedCluster


def filibuster_full(boot_state) -> dict:
    """The Filibuster path (phase 8) on the booted state's device and
    width."""
    from partisan_tpu_torch import filibuster
    from partisan_tpu_torch import kernels, scenarios as sc
    from partisan_tpu_torch.models.plumtree import Plumtree
    from partisan_tpu_torch.types import MsgKind

    dev = boot_state.rnd.device
    n = boot_state.faults.alive.shape[0]
    start = int(boot_state.rnd)
    model = Plumtree()
    timing = {"records": 0, "record_s": 0.0, "copy_s": 0.0}
    TimedCluster = timed_cluster(timing, dev)

    def build(interp):
        cl = TimedCluster(sc.bench_config(n), model=model, interpose=interp,
                          device=dev)
        return cl, boot_state._replace(
            model=model.broadcast(boot_state.model, 0, 0, start))

    def covered(cl, st):
        return float(model.coverage(st.model, st.faults.alive, 0)) == 1.0

    def gossip_of_root(ev):
        return ev.kind == MsgKind.PT_GOSSIP and ev.src == 0 \
            and ev.rnd == start

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = filibuster.Checker(
        build=build, horizon=FULL_HORIZON, assertion=covered,
        candidate=gossip_of_root, max_faults=1,
        max_executions=FULL_MAX_EXECUTIONS,
        sched_width=FULL_SCHED_WIDTH).run()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    if not res.passed and not res.counterexample.schedule:
        raise AssertionError(f"n={n} Filibuster: the base execution (no "
                             "omission) failed the coverage assertion")
    want = FULL_HORIZON * timing["records"] if dev.type == "cuda" else 0
    if counts["interleave"] != want:
        raise AssertionError(
            f"n={n} Filibuster: {counts['interleave']} interleave "
            f"launches, want {FULL_HORIZON} x {timing['records']} records")
    return {"n": n, "broadcast_round": start, "horizon": FULL_HORIZON,
            "verdict": res.render().splitlines()[0], "passed": res.passed,
            "executions": res.executions, "pruned": res.pruned,
            "candidates": res.candidates,
            "record_calls": timing["records"], "launches": counts,
            "wall_s": wall, "device_rounds_s": timing["record_s"],
            "trace_copy_s": timing["copy_s"],
            "host_decode_s": wall - timing["record_s"] - timing["copy_s"],
            "trace_gb_per_execution": FULL_HORIZON * n * 77 * 16 * 4 / 1e9,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None}


SCENARIO_SMALL = {"config1": ("config1_anti_entropy", dict(n=16)),
                  "config2": ("config2_rumor", dict(n=128)),
                  "config3": ("config3_plumtree_drop", dict(n=128)),
                  "config4": ("config4_scamp_churn", dict(n=128, rounds=40)),
                  "hyparview_views": ("hyparview_views", dict(n=128))}
CAUSAL_SMALL = {"config5": ("config5_causal_crash",
                                dict(n=128, senders=8, crashes=4)),
                "config6": ("config6_echo",
                            dict(sizes_kb=(1024, 8192), concurrency=(1, 4),
                                 latencies_ms=(1, 100), num_messages=10))}
SCENARIO_FULL = {"config1": ("config1_anti_entropy", dict(n=16)),
                 "config2": ("config2_rumor", dict(n=1000)),
                 "config3": ("config3_plumtree_drop", dict(n=10_000)),
                 "config4": ("config4_scamp_churn",
                             dict(n=10_000, rounds=120)),
                 "hyparview_views": ("hyparview_views", dict(n=1000))}


def run_scenario(name: str, kwargs: dict, device=None,
                 seen=None) -> tuple:
    """One scenario function of partisan_tpu_torch.scenarios, with its
    wall seconds split into the bootstrap (the scenario's
    ``_boot_fullmesh`` / ``_boot_overlay`` / ``_boot_ladder`` calls), the
    convergence loop (``_converge``), the throughput instrument
    (``_throughput``), each ended by a synchronize, and the rest.  When
    ``seen`` is a dict, each wrapped function's last arguments are kept
    there under its name."""
    from partisan_tpu_torch import scenarios as sc

    spent = {"boot": 0.0, "converge": 0.0, "throughput": 0.0}
    phase = {"_boot_fullmesh": "boot", "_boot_overlay": "boot",
             "_boot_ladder": "boot", "_converge": "converge",
             "_throughput": "throughput"}
    originals = {k: getattr(sc, k) for k in phase}

    state_of = {"_converge": lambda o: o[0], "_boot_ladder": lambda o: o[1],
                "_boot_fullmesh": lambda o: o, "_boot_overlay": lambda o: o}

    def timed(key, orig):
        def fn(*a, **kw):
            if seen is not None:
                seen[key] = a
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            if key in state_of:
                sc._sync(state_of[key](out))
            spent[phase[key]] += time.perf_counter() - t0
            return out
        return fn

    for k, fn in originals.items():
        setattr(sc, k, timed(k, fn))
    try:
        t0 = time.perf_counter()
        res = getattr(sc, name)(device=device, **kwargs)
        wall = time.perf_counter() - t0
    finally:
        for k, fn in originals.items():
            setattr(sc, k, fn)
    return res, {"wall_s": wall, "boot_s": spent["boot"],
                 "rest_s": wall - spent["boot"],
                 "converge_s": spent["converge"],
                 "throughput_s": spent["throughput"]}


WALL_KEYS = ("rounds_per_sec", "convergence_wall_sec", "measured_wall_s")


def strip_rate(d: dict) -> dict:
    """A scenario dict without its wall-clock fields (config 6's rows
    too)."""
    return {k: [strip_rate(r) for r in v] if k == "rows" else v
            for k, v in d.items() if k not in WALL_KEYS}


def round_profile(fn, rounds: int, kernel: str | None = None) -> dict:
    """Per round of ``fn`` (which runs ``rounds`` rounds): the wall of a
    bare call, then under torch.profiler the kernels' summed device time,
    the kernel launches (the copies among them), the host reads and the
    copies device -> host and host -> device (each a ``.cpu()``, or a
    Python number turned into a card tensor).  With ``kernel``, also the
    launches and device ms per launch of the kernels whose name holds
    it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    c = window_counts(prof)
    busy = c["device_us"] / 1e6
    out = {"rounds": rounds, "wall_ms_per_round": wall * 1e3 / rounds,
           "device_ms_per_round": busy * 1e3 / rounds,
           "device_idle_share": max(0.0, 1.0 - busy / wall),
           "launches_per_round": c["launches"] / rounds,
           "host_reads_per_round": c["host_reads"] / rounds,
           "copies_dtoh_per_round": c["dtoh"] / rounds,
           "copies_htod_per_round": c["htod"] / rounds}
    if kernel is not None:
        hits = [v for k, v in c["by_name"].items() if kernel in k]
        n_k = sum(n for n, _ in hits)
        out[f"{kernel}_launches"] = n_k
        out[f"{kernel}_device_ms_per_launch"] = \
            sum(us for _, us in hits) / 1e3 / max(n_k, 1)
    return out


def lane_setups(device: str) -> dict:
    """Two setups of tests/test_torch_delivery.py on ``device``, with the
    state after every round: the point-to-point lane with two-bucket
    tables under 30% loss (n=16: six senders into node 0, node 0 into
    six destinations), and the causal broadcast lane through CausalChat
    (n=8 full mesh; node 0's broadcast cut from node 2, node 1 answers,
    the cut heals)."""
    from partisan_tpu_torch import faults
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.models.causal_chat import CausalChat
    from partisan_tpu_torch.models.p2p_chat import P2PChat

    out = {}
    model = P2PChat()
    cl = Cluster(Config(n_nodes=16, seed=7, causal_p2p_labels=("chat",),
                        peer_service_manager="static", p2p_dst_cap=2,
                        p2p_src_cap=2), model=model, device=device)
    st = cl.init()
    m = st.model
    for node, rnd, dst in [(s, r, 0) for s in range(1, 7) for r in (3, 5)] \
            + [(0, 3 + k, 1 + k) for k in range(6)]:
        m = model.schedule(m, node=node, rnd=rnd, dst=dst)
    st = st._replace(model=m, faults=faults.set_link_drop(st.faults, 0.3))
    states = []
    for r in range(24):
        if r == 16:
            st = st._replace(faults=faults.set_link_drop(st.faults, 0.0))
        st = cl.step(st)
        states.append(st)
    out["p2p"] = states

    chat = CausalChat()
    cl = Cluster(Config(n_nodes=8, seed=13, causal_labels=("chat",),
                        n_actors=8), model=chat, device=device)
    st = cl.init()
    m = st.manager
    for i in range(1, 8):
        m = cl.manager.join(cl.cfg, m, i, 0)
    st = cl.steps(st._replace(manager=m), 15)
    st = st._replace(faults=faults.inject_partition(st.faults, [0], [2]))
    states = []
    for r in range(10):
        if r in (0, 3):
            st = st._replace(model=chat.schedule(
                st.model, node=0 if r == 0 else 1, rnd=int(st.rnd) + 1))
        if r == 6:
            st = st._replace(faults=faults.resolve_partition(st.faults))
        st = cl.step(st)
        states.append(st)
    out["causal"] = states
    return out


def lane_parity() -> dict:
    """Phase 11: configs 5 and 6 small, and the two lane setups, card
    against CPU."""
    from partisan_tpu_torch import delivery

    out = {}
    for label, (name, kw) in CAUSAL_SMALL.items():
        g, g_t = run_scenario(name, kw, device="cuda")
        c, c_t = run_scenario(name, kw, device="cpu")
        if strip_rate(g) != strip_rate(c):
            raise AssertionError(f"{label}: card {g} != CPU {c}")
        out[label] = {"result": g, "card_wall_s": g_t["wall_s"],
                      "cpu_wall_s": c_t["wall_s"]}
    if out["config5"]["result"]["causal_deliveries"] != 16:
        raise AssertionError(f"config 5 small: {out['config5']}")
    g, c = lane_setups("cuda"), lane_setups("cpu")
    for label in g:
        n_leaves = 0
        for r, (a, b) in enumerate(zip(g[label], c[label])):
            n_leaves = assert_identical(a, b, f"{label} round {r}")
        last = g[label][-1].delivery
        out[label] = {"rounds": len(g[label]), "leaves": n_leaves,
                      "overflow_total": int(delivery.overflow_total(last))}
        if label == "p2p":
            lane = last.p2p[0]
            out[label].update(resets=int(lane.resets),
                              aborted=int(lane.aborted))
    return out


def config5_full(card: str) -> dict:
    """Phase 12: config 5 at n=100,000 on the card."""
    from partisan_tpu_torch import scenarios as sc

    seen = {}
    torch.cuda.reset_peak_memory_stats()
    res, t = run_scenario("config5_causal_crash", dict(n=N_CONFIG5),
                          seen=seen)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (res["causal_deliveries"] == res["causal_expected"] == 128
            and res["fifo_ok_receivers"] == res["n_receivers"] == 64
            and res["convergence_rounds"] > 0):
        raise AssertionError(f"config 5 at n={N_CONFIG5}: {res}")
    cl, st = seen["_converge"][:2]
    scripted = round_profile(lambda: cl.steps(st, sc.K_PROG), sc.K_PROG)
    cl, st = seen["_throughput"][:2]
    steady = round_profile(lambda: cl.steps(st, sc.K_PROG), sc.K_PROG)
    return {"result": res, **t,
            "rest_s": t["wall_s"] - t["boot_s"] - t["converge_s"]
            - t["throughput_s"],
            "peak_mem_gib": peak, "window_scripted": scripted,
            "window_drained": steady, "card": card}


def config6_full(card: str) -> dict:
    """Phase 13: config 6's 48-cell matrix at n=2 on the card."""
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import DEFAULT_CHANNEL, ChannelSpec, \
        Config
    from partisan_tpu_torch.models.echo import Echo

    t0 = time.perf_counter()
    res = sc.config6_echo(num_messages=ECHO_MESSAGES)
    wall = time.perf_counter() - t0
    if res["cells"] != 48:
        raise AssertionError(f"config 6: {res['cells']} cells")
    rounds = sum(r["rounds"] for r in res["rows"])
    # one cell's rounds under the profiler: concurrency 8 on one lane
    model = Echo(concurrency=8, num_messages=ECHO_MESSAGES)
    cl = Cluster(Config(n_nodes=2, seed=11, peer_service_manager="static",
                        channel_capacity=True, lane_rate=1, outbox_cap=32,
                        channels=(ChannelSpec(DEFAULT_CHANNEL),)),
                 model=model)
    st = cl.steps(cl.init(), sc.K_PROG)
    window = round_profile(lambda: cl.steps(st, sc.K_PROG), sc.K_PROG)
    # the round's per-node threefry keys alone (static + Echo read none)
    keys = node_keys_profile(cl, st)
    return {"result": res, "wall_s": wall, "rounds": rounds,
            "s_per_round": wall / rounds, "window_c8": window,
            "window_node_keys": keys, "card": card}


def health_convergence(device: str, n: int):
    """Config 3 at ``n`` with the health plane on (snapshots every
    K_PROG rounds): the same booted state driven to convergence twice,
    polling the digest and polling coverage.  Returns both rounds and
    the digest-polled final state."""
    from partisan_tpu_torch import faults, scenarios as sc
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.models.plumtree import Plumtree

    cfg = Config(n_nodes=n, seed=3, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups", health=sc.K_PROG,
                 health_ring=512)
    model = Plumtree()
    cl = Cluster(cfg, model=model, device=device)
    st = sc._boot_overlay(cl, n)
    st = st._replace(faults=faults.set_link_drop(st.faults, 0.05))
    start = int(st.rnd)
    st = st._replace(model=model.broadcast(st.model, 0, 0, start))

    def cov(s):
        return model.coverage(s.model, s.faults.alive, 0)

    st_d, r_d = sc._converge(cl, st, cov, 400, use_digest=True)
    _, r_c = sc._converge(cl, st, cov, 400, use_digest=False)
    return r_d, r_c, st_d


def scenario_parity() -> dict:
    """Phase 9: the scenario functions at small n, card against CPU."""
    from partisan_tpu_torch import health

    out = {}
    for label, (name, kw) in SCENARIO_SMALL.items():
        g, g_t = run_scenario(name, kw, device="cuda")
        c, c_t = run_scenario(name, kw, device="cpu")
        if strip_rate(g) != strip_rate(c):
            raise AssertionError(f"{label}: card {g} != CPU {c}")
        out[label] = {"result": g, "card_wall_s": g_t["wall_s"],
                      "cpu_wall_s": c_t["wall_s"]}
    g_d, g_c, g_st = health_convergence("cuda", 128)
    c_d, c_c, c_st = health_convergence("cpu", 128)
    if not g_d == g_c == c_d == c_c or g_d < 0:
        raise AssertionError(f"health convergence: card digest {g_d} / "
                             f"coverage {g_c}, CPU {c_d} / {c_c}")
    n_leaves = assert_identical(g_st, c_st, "config 3 n=128 with health")
    snap = health.snapshot(g_st.health)
    out["config3_health"] = {
        "converged_round": g_d, "leaves": n_leaves,
        "snapshots": len(snap["rounds"]),
        "last_digest": health.decode_digest(snap["digests"][-1])}
    return out


def scenario_suite(card: str) -> list:
    """Phase 10: the suite at the reference's default sizes on the card,
    with each config's band."""
    out = []
    for label, (name, kw) in SCENARIO_FULL.items():
        res, t = run_scenario(name, kw)
        row = {"phase": "scenario", "label": label, "card": card, **t,
               "result": res}
        log(row)
        if label == "config3" and not (
                0 <= res["repair_rounds"]
                <= res["expected_max_repair_rounds"]):
            raise AssertionError(f"config 3 outside its band: {res}")
        if label == "config4" and not res["in_band"]:
            raise AssertionError(f"config 4 outside its band: {res}")
        if label == "hyparview_views" and res["components"] != 1:
            raise AssertionError(f"hyparview_views: {res}")
        out.append(row)
    return out


def app_setups(device: str) -> dict:
    """Setups of tests/test_paxos.py, tests/test_commit.py and
    tests/test_alsberg.py on ``device``, with the state after every
    round: Paxos (n=5, seed 7, msg_words 13: one proposer, 5 + 12 rounds;
    two competing proposers, 5 + 60 rounds), the commit engine (n=6, seed
    11, each variant: fault-free, 12 rounds; node 5 partitioned from the
    coordinator, 25 rounds; nodes 1 and 4 coordinating one slot, so that
every node gets two PREPAREs for it in one round, 12 rounds) and
Alsberg-Day (n=5, seed 5, acked and
    unacked: a write, 8 rounds, then two clients writing one key in one
    round, 12 rounds)."""
    from partisan_tpu_torch import faults
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.models import alsberg_day, commit, paxos

    def run(cfg, model, plan):
        cl = Cluster(cfg, model=model, device=device)
        st = cl.init()
        m = st.manager
        for i in range(1, cfg.n_nodes):
            m = cl.manager.join(cfg, m, i, 0)
        st = st._replace(manager=m)
        states = []
        for item in plan:
            if callable(item):
                st = item(st)
                continue
            for _ in range(item):
                st = cl.step(st)
                states.append(st)
        return states

    out = {}
    for label, props, rounds in (("paxos_single", [(2, 0, 111)], 12),
                                 ("paxos_competing",
                                  [(1, 0, 100), (3, 0, 300)], 60)):
        model = paxos.Paxos(slots=2)
        out[label] = run(
            Config(n_nodes=5, seed=7, msg_words=13, inbox_cap=64), model,
            [5] + [lambda s, p=p, m=model: s._replace(model=m.propose(
                s.model, *p, int(s.rnd), 5)) for p in props] + [rounds])
    members = torch.ones(6, dtype=torch.bool, device=device)
    for variant in commit.CommitProtocol.VARIANTS:
        for label, cut, begins, rounds in (
                ("fault_free", False, [(2, 77)], 12),
                ("partitioned", True, [(2, 4)], 25),
                ("two_prepares", False, [(1, 10), (4, 20)], 12)):
            model = commit.CommitProtocol(variant, slots=2)

            def start(s, m=model, cut=cut, begins=begins):
                if cut:
                    s = s._replace(faults=faults.inject_partition(
                        s.faults, [2], [5]))
                mm = s.model
                for coord, value in begins:
                    mm = m.begin(mm, coord, 0, value, members, s.rnd)
                return s._replace(model=mm)

            out[f"{variant}_{label}"] = run(
                Config(n_nodes=6, seed=11, inbox_cap=64, emit_cap=16),
                model, [start, rounds])
    for acked in (False, True):
        model = alsberg_day.AlsbergDay(acked=acked, keys=4)

        def write(c, k, v, m=model):
            return lambda s: s._replace(model=m.write(s.model, c, k, v))

        out[f"alsberg_{'acked' if acked else 'plain'}"] = run(
            Config(n_nodes=5, seed=5, inbox_cap=64, emit_cap=16,
                   ack_cap=32 if acked else 0), model,
            [write(3, 1, 42), 8, write(1, 2, 5), write(3, 2, 9), 12])
    return out


def last_prepares(st) -> list:
    """Per node, ``[sender, value]`` of the last PREPARE for slot 0 in its
    inbox; each node must hold two, so that the scatter has a duplicate."""
    from partisan_tpu_torch import types as T
    from partisan_tpu_torch.models import commit

    d = st.inbox.data
    prep = ((d[T.W_KIND] == int(T.MsgKind.APP))
            & (d[T.P0] == commit.OP_PREPARE) & (d[T.P1] == 0)).cpu()
    out = []
    for node in range(prep.shape[0]):
        idx = prep[node].nonzero().flatten().tolist()
        if len(idx) != 2:
            raise AssertionError(f"node {node}: PREPAREs at {idx}")
        out.append([int(d[T.W_SRC][node, idx[-1]]),
                    int(d[T.P2][node, idx[-1]])])
    return out


def app_parity() -> dict:
    """Phase 14: the app-model setups, card against CPU, every leaf after
    every round."""
    from partisan_tpu_torch.models import commit, paxos

    g, c = app_setups("cuda"), app_setups("cpu")
    out = {}
    for label in g:
        for r, (a, b) in enumerate(zip(g[label], c[label])):
            n_leaves = assert_identical(a, b, f"{label} round {r}")
        m = g[label][-1].model
        facts = {"rounds": len(g[label]), "leaves": n_leaves}
        if label.startswith("paxos"):
            facts["decided_0"] = paxos.Paxos.decided_nodes(m, 0)
            ok = facts["decided_0"] == list(range(5))
        elif label.startswith("alsberg"):
            facts["store_key2"] = int(m.store[0, 2])
            ok = bool(m.req_ok[3, 1]) and bool((m.store[:, 1] == 42).all())
        elif label.endswith("two_prepares"):
            facts["prepare_winners"] = last_prepares(g[label][0])
            m1 = g[label][1].model          # the round the PREPAREs land
            got = [[int(m1.p_coord[i, 0]), int(m1.p_value[i, 0])]
                   for i in range(6)]
            ok = facts["prepare_winners"] == got
        else:
            facts["outcome"] = int(m.c_outcome[2, 0])
            ok = facts["outcome"] == (2 if "partitioned" in label else 1)
            ok = ok and bool(commit.CommitProtocol.agreement(m))
        if not ok:
            raise AssertionError(f"{label}: {facts}")
        out[label] = facts
    return out


def harness_specs(pm, pr) -> list:
    """The harness runs of phase 15: ``(label, system, fault model,
    Harness keywords)``."""
    return [
        ("paxos_fault_budget", pm.PaxosSystem(n_nodes=5, slots=2, seed=3),
         pr.CrashFaultModel(tolerance=1),
         dict(scheduler="finite_fault", n_runs=4, n_commands=5, seed=21)),
        ("paxos_unsafe_adopt",
         pm.PaxosSystem(n_nodes=5, slots=1, seed=3, unsafe_adopt=True,
                        check_termination=False), None,
         dict(n_runs=8, n_commands=6, seed=5)),
        ("reliable_broadcast_acked",
         pm.ReliableBroadcastSystem(seed=7, acked=True),
         pr.CrashFaultModel(tolerance=2, allow_crash=False),
         dict(scheduler="finite_fault", n_runs=3, n_commands=6, seed=101)),
        ("primary_backup", pm.PrimaryBackupSystem(seed=5, acked=True), None,
         dict(scheduler="default", n_runs=2, n_commands=5, seed=40)),
        ("atomic_commit_ctp",
         pm.AtomicCommitSystem(variant="bernstein_ctp", seed=3),
         pr.CrashFaultModel(tolerance=1, allow_crash=False),
         dict(scheduler="finite_fault", n_runs=4, n_commands=5, seed=900)),
    ]


def harness_runs(device: str) -> dict:
    """The harness runs on ``device``: each run's RunResult fields, and on
    the card its wall, executions and host reads; the cached boot state
    must be unchanged by the run."""
    from partisan_tpu_torch import prop, prop_models

    out = {}
    for label, system, fm, kw in harness_specs(prop_models, prop):
        system.device = device
        before = state_leaves(system.build()[1])
        calls = [0]

        class Counting(prop.Harness):
            def _execute(self, script):
                calls[0] += 1
                return super()._execute(script)

        h = Counting(system=system, fault_model=fm, **kw)
        t0 = time.perf_counter()
        res = h.run()
        wall = time.perf_counter() - t0
        execs = calls[0]
        for (p, a), (_, b) in zip(before, state_leaves(system._st0)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{label}: the run wrote into the "
                                     f"cached boot state ({p})")
        fields = {"ok": res.ok, "seed": res.seed,
                  "commands": [repr(c) for c in res.commands],
                  "shrunk": None if res.shrunk is None
                  else [repr(c) for c in res.shrunk],
                  "render": res.render()}
        out[label] = {"result": fields, "wall_s": wall,
                      "executions": execs, "executions_per_s": execs / wall}
        if device == "cuda" and len(out) == 1:
            # one more execution of the first run's script, profiled as a
            # round (the other runs' repeat it: PERF.md §5)
            out[label]["per_execution"] = round_profile(
                lambda: h._execute(res.commands), 1)
    return out


def harness_phase(card: str) -> dict:
    """Phase 15: the harness runs, card against CPU."""
    g, c = harness_runs("cuda"), harness_runs("cpu")
    for label in g:
        if g[label]["result"] != c[label]["result"]:
            raise AssertionError(f"{label}: card {g[label]['result']} != "
                                 f"CPU {c[label]['result']}")
        g[label]["cpu_wall_s"] = c[label]["wall_s"]
    for label, res in g.items():
        r = res["result"]
        if label == "paxos_unsafe_adopt":
            if r["ok"] or not r["shrunk"] or len(r["shrunk"]) > 3 \
                    or not all(x.startswith("propose") for x in r["shrunk"]):
                raise AssertionError(f"the unsafe_adopt canary: {r}")
        elif not r["ok"]:
            raise AssertionError(f"{label}: {r['render']}")
    return {"runs": g, "card": card}


def filibuster_paxos(device: str) -> dict:
    """Phase 16 on ``device``: tests/test_paxos.py's Filibuster search
    over the proposal exchange, with the record calls timed and every
    record call's trace kept (key ``traces``)."""
    from partisan_tpu_torch import filibuster, kernels
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.models.paxos import Paxos
    from partisan_tpu_torch.types import MsgKind

    dev = torch.device(device)
    model = Paxos(slots=1, retry_rounds=6)
    timing = {"records": 0, "record_s": 0.0, "copy_s": 0.0}
    traces = []
    TimedCluster = timed_cluster(timing, dev, traces)
    built = []

    def build(interp):
        cfg = Config(n_nodes=5, seed=11, msg_words=13, inbox_cap=64)
        cl = TimedCluster(cfg, model=model, interpose=interp, device=dev)
        st = cl.init()
        m = st.manager
        for i in range(1, 5):
            m = cl.manager.join(cfg, m, i, 0)
        st = cl.steps(st._replace(manager=m), 5)
        built.append((cl, st._replace(model=model.propose(
            st.model, 2, 0, 55, int(st.rnd), 5))))
        return built[-1]

    def assertion(cl, st):
        return model.agreement(st.model) \
            and len(model.decided_nodes(st.model, 0)) == 5

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = filibuster.Checker(
        build=build, horizon=PAXOS_FB_HORIZON, assertion=assertion,
        candidate=lambda e: e.kind == MsgKind.APP, max_faults=1,
        max_executions=60).run()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    timing = dict(timing)          # the windows below record again
    traces = list(traces)
    windows = {}
    if dev.type == "cuda":
        # one execution's record path (the golden run's state and
        # zeroed schedule) and the round's per-node keys alone
        cl, st = built[0]
        windows = {"window": round_profile(
            lambda: cl.record(st, sc.K_PROG), sc.K_PROG),
            "window_node_keys": node_keys_profile(cl, st)}
    return {"result": result_fields(res), "launches": counts,
            "traces": traces,
            **windows, "record_calls": timing["records"],
            "trace_shape": list(res.base_trace.sent.shape), "wall_s": wall,
            "executions_per_s": res.executions / wall,
            "device_rounds_s": timing["record_s"],
            "trace_copy_s": timing["copy_s"],
            "host_decode_s": wall - timing["record_s"] - timing["copy_s"]}


def filibuster_paxos_phase(card: str) -> dict:
    """Phase 16: the card's search against the CPU's, and every record
    call's trace (the card's through the interleave kernel, the CPU's
    through its plain version, from equal states) bit for bit."""
    g, c = filibuster_paxos("cuda"), filibuster_paxos("cpu")
    gt, ct = g.pop("traces"), c.pop("traces")
    if len(gt) != len(ct) or len(gt) != g["record_calls"]:
        raise AssertionError(f"Filibuster over Paxos: {len(gt)} traces on "
                             f"the card, {len(ct)} on the CPU")
    for i, (a, b) in enumerate(zip(gt, ct)):
        for f in ("rnd", "sent", "dropped"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"Filibuster over Paxos: record call "
                                     f"{i}'s {f} differs, card vs CPU")
    if g["result"] != c["result"]:
        raise AssertionError(f"Filibuster over Paxos: card {g['result']} "
                             f"!= CPU {c['result']}")
    want = "filibuster: PASSED — 60 executions, 0 pruned, 95 candidates"
    if g["result"]["render"] != want:
        raise AssertionError(f"Filibuster over Paxos: {g['result']}")
    if g["launches"]["interleave"] != PAXOS_FB_HORIZON * g["record_calls"] \
            or g["trace_shape"] != [PAXOS_FB_HORIZON, *PAXOS_FB_SENT, 13]:
        raise AssertionError(
            f"Filibuster over Paxos: {g['launches']} launches over "
            f"{g['record_calls']} record calls, trace {g['trace_shape']}")
    return {**g, "traces_equal": len(gt), "cpu_wall_s": c["wall_s"],
            "card": card}


def app_models_full(card: str) -> dict:
    """Phase 17: the three app models at n=48 on the card, each final
    state against the CPU's, with a profiled window from the first app
    event."""
    from partisan_tpu_torch import scenarios as sc

    out = {}
    for name in sc.APP_MODELS:
        run = sc.app_model(name, n=N_APP, rounds=APP_ROUNDS)
        cpu = sc.app_model(name, n=N_APP, rounds=APP_ROUNDS, device="cpu")
        n_leaves = assert_identical(run["state"], cpu["state"],
                                    f"{name} n={N_APP}")
        facts = {k: v for k, v in run.items()
                 if k not in ("cluster", "state")}
        want = {"paxos": {"decided_0": N_APP, "decided_1": N_APP},
                "commit": {"agreement": True, "commits": 2 * N_APP},
                "alsberg_day": {"acked": True, "replicated": True}}[name]
        if not facts["app_ok"] or any(facts[k] != v for k, v in want.items()):
            raise AssertionError(f"{name} at n={N_APP}: {facts}")
        cl = run["cluster"]
        _, _, boot, drive, _ = sc._traffic_build(name, N_APP)
        st = boot(cl)
        start = int(st.rnd)
        st, events = drive(st, start, APP_ROUNDS)
        off, first = events[0]
        st = first(cl, sc.run_script(cl, st, events, start, off), start + off)
        out[name] = {**facts, "leaves": n_leaves,
                     "wall_s": facts["boot_s"] + facts["run_s"],
                     "ms_per_round": facts["run_s"] * 1e3 / APP_ROUNDS,
                     "cpu_run_s": cpu["run_s"],
                     "window": round_profile(lambda: cl.steps(st, sc.K_PROG),
                                             sc.K_PROG),
                     "window_node_keys": node_keys_profile(cl, st),
                     "card": card}
    return out


def node_keys_profile(cl, st) -> dict:
    """The round's per-node threefry keys alone (``rng.node_keys``), which
    none of the app models reads."""
    from partisan_tpu_torch.ops import rng

    gids = cl.comm.local_ids()
    return round_profile(lambda: rng.node_keys(cl.cfg.seed, st.rnd, gids),
                         1)


class RoundLog:
    """While active, ``Cluster.steps`` runs its rounds one at a time and
    keeps every round's state leaves (numpy), so two devices' runs of a
    driver can be compared after every round."""

    def __enter__(self):
        from partisan_tpu_torch import cluster as cluster_mod

        self.states = []
        self._orig = orig = cluster_mod.Cluster.steps
        states = self.states

        def steps(cl, st, k):
            for _ in range(k):
                st = orig(cl, st, 1)
                states.append(state_leaves(st))
            return st

        cluster_mod.Cluster.steps = steps
        return self

    def __exit__(self, *exc):
        from partisan_tpu_torch import cluster as cluster_mod

        cluster_mod.Cluster.steps = self._orig
        return False


def assert_rounds_identical(a: list, b: list, label: str) -> int:
    """Two RoundLogs' states, round by round, leaf for leaf."""
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} vs {len(b)} rounds")
    for r, (la, lb) in enumerate(zip(a, b)):
        assert_leaves_identical(la, lb, f"{label} round {r}")
    return len(a)


def planes_setups(device: str) -> dict:
    """Phase 18's runs on ``device``, each under a RoundLog: the bench
    path at n=512 with metrics, latency and provenance on (fast arm), its
    broadcast again from the boot state on a cluster with a 4-round
    flight ring (generic arm), which must converge on the same round and
    whose decoded Trace must equal ``Cluster.record``'s last 4 of 6
    rounds from the broadcast, config 8 at n=48 (both arms, 3 waves),
    the fanout arm at n=64 (4 waves) and the healing arm at n=64."""
    from partisan_tpu_torch import latency, provenance, trace
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster

    out = {}
    with RoundLog() as rl:
        run = sc.bench_broadcast(N_PARITY, device=device,
                                 widths=[N_PARITY // 2, N_PARITY], **PLANES)
    out["bench_planes"] = {"rounds": rl.states,
                           "converged_round": run["converged_round"]}
    # the flight ring: a cluster with a 4-round ring stepped from the
    # planes run's boot state (as phase 20 builds it), to coverage, then
    # record and steps from the broadcast round, so the ring holds live
    # traffic
    model, boot, start = run["model"], run["boot_state"], run["start_round"]
    cfg = run["cluster"].cfg.replace(flight_rounds=FLIGHT_K)
    cl = Cluster(cfg, model=model, device=device)
    st0 = boot._replace(
        flight=latency.flight_init(cfg, cl.flight_shape(boot),
                                   device=boot.rnd.device),
        provenance=provenance.mark_origin(boot.provenance, 0, 0, rnd=start),
        model=model.broadcast(boot.model, 0, 0, start))
    with RoundLog() as rl:
        _, conv = sc._converge(
            cl, st0, lambda s: model.coverage(s.model, s.faults.alive, 0),
            300)
    if conv != run["converged_round"]:
        raise AssertionError(f"{device}: with a flight ring the broadcast "
                             f"converged on round {conv}, without on "
                             f"{run['converged_round']}")
    st_r, tr = cl.record(st0, 6)
    st_s = cl.steps(st0, 6)
    ring = latency.flight_trace(st_s.flight)
    cap = trace.from_capture(tr).tail(FLIGHT_K)
    if not (np.array_equal(ring.sent, cap.sent)
            and np.array_equal(ring.dropped, cap.dropped)
            and np.array_equal(ring.rounds, cap.rounds)) \
            or not any(True for _ in ring.events()):
        raise AssertionError(f"{device}: the flight ring != record's last "
                             f"{FLIGHT_K} rounds, or it holds no send")
    assert_identical(st_r, st_s, f"{device}: record vs steps with a ring")
    out["flight"] = {"rounds": rl.states + [state_leaves(st_s)],
                     "converged_round": conv,
                     "ring_sends": sum(1 for _ in ring.events()),
                     "ring": ring.sent}
    for adaptive in (False, True):
        with RoundLog() as rl:
            d = sc.config8_overload(n=48, waves=3, adaptive=adaptive,
                                    device=device)
        out[f"config8_{'adaptive' if adaptive else 'static'}"] = {
            "rounds": rl.states, "dict": d}
    with RoundLog() as rl:
        d = sc._strip_state(sc.fanout_ab_arm(True, n=64, waves=4,
                                             device=device))
    out["fanout_arm"] = {"rounds": rl.states, "dict": d}
    with RoundLog() as rl:
        d = sc._strip_state(sc.healing_ab_arm(True, n=64, device=device))
    out["healing_arm"] = {"rounds": rl.states, "dict": d}
    return out


def planes_parity() -> dict:
    """Phase 18: every setup's state after every round, card == CPU, and
    the returned facts equal."""
    g, c = planes_setups("cuda"), planes_setups("cpu")
    out = {}
    for label in g:
        n = assert_rounds_identical(g[label]["rounds"], c[label]["rounds"],
                                    label)
        facts = {k: v for k, v in g[label].items()
                 if k not in ("rounds", "ring")}
        if facts != {k: v for k, v in c[label].items()
                     if k not in ("rounds", "ring")}:
            raise AssertionError(f"{label}: card {facts} != CPU")
        out[label] = {"rounds_compared": n,
                      "leaves": len(g[label]["rounds"][-1]), **facts}
    if not np.array_equal(g["flight"]["ring"], c["flight"]["ring"]):
        raise AssertionError("the flight ring differs card vs CPU")
    return out


def strip_planes(st, keep: tuple):
    """The bench state with only the planes in ``keep`` (metrics,
    latency, provenance): the other planes' leaves dropped and the inbox
    cut to the kept trailing words (16 protocol words, the provenance
    pair, the birth word)."""
    from partisan_tpu_torch.ops import exchange
    from partisan_tpu_torch.ops.plane import Planes

    d = list(st.inbox.data)
    words = d[:16] + (d[16:18] if "provenance" in keep else []) \
        + ([d[18]] if "latency" in keep else [])
    return st._replace(
        inbox=exchange.Inbox(data=Planes(words), count=st.inbox.count,
                             drops=st.inbox.drops),
        metrics=st.metrics if "metrics" in keep else (),
        latency=st.latency if "latency" in keep else (),
        provenance=st.provenance if "provenance" in keep else ())


def bench_planes_full(card: str, cl_off, st_off, conv_off: int) -> dict:
    """Phase 19: the bench path at n=32768 with metrics, latency and
    provenance on.  It must converge on phase 5's round at coverage 1.0,
    the metrics books must close (causes sum to emitted - delivered and
    equal Stats) and the latency counts per channel equal metrics'
    delivered per channel.  Then ms per round planes on and off (the
    throughput instrument, one call), K_PROG-round profiled windows
    (launches, host reads: the planes add none) with every plane and
    with each alone, and the peak memory."""
    from partisan_tpu_torch import kernels, latency, metrics
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    run = sc.bench_broadcast(N_MAIN, **PLANES)
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    cl, st = run["cluster"], run["state"]
    if run["converged_round"] != conv_off:
        raise AssertionError(f"planes on converge at round "
                             f"{run['converged_round']}, phase 5 at "
                             f"{conv_off}")
    coverage = float(run["model"].coverage(st.model, st.faults.alive, 0))
    if coverage != 1.0:
        raise AssertionError(f"planes on: coverage {coverage}")
    msnap = metrics.snapshot(st.metrics)
    tot = metrics.totals(msnap)
    if tot["rounds"] != int(st.rnd) or tot["emitted"] \
            != int(st.stats.emitted) or tot["delivered"] \
            != int(st.stats.delivered) or tot["dropped"] \
            != int(st.stats.dropped) or tot["dropped"] \
            != tot["emitted"] - tot["delivered"]:
        raise AssertionError(f"the metrics books do not close: {tot}")
    lsnap = latency.snapshot(st.latency)
    if not (lsnap["deliver"].sum(axis=1)
            == msnap["delivered"].sum(axis=0)).all():
        raise AssertionError("latency counts != metrics delivered per "
                             "channel")
    lines = sc.bench_planes_report(cl.cfg, st)
    rps_on = sc._throughput(cl, st)
    rps_off = sc._throughput(cl_off, st_off)
    prof_on = round_profile(lambda: cl.steps(st, sc.K_PROG), sc.K_PROG)
    prof_off = round_profile(lambda: cl_off.steps(st_off, sc.K_PROG),
                             sc.K_PROG)
    if prof_on["host_reads_per_round"] != prof_off["host_reads_per_round"]:
        raise AssertionError(f"the planes add host reads: "
                             f"{prof_on['host_reads_per_round']} vs "
                             f"{prof_off['host_reads_per_round']}")
    alone = {}
    for plane in ("metrics", "latency", "provenance"):
        pcl = Cluster(sc.bench_config(N_MAIN).replace(**{plane: True}),
                      model=run["model"])
        pst = strip_planes(st, (plane,))
        prof = round_profile(lambda: pcl.steps(pst, sc.K_PROG), sc.K_PROG)
        alone[plane] = {
            "launches_added_per_round": prof["launches_per_round"]
            - prof_off["launches_per_round"],
            "ms_per_round": prof["wall_ms_per_round"],
            "host_reads_per_round": prof["host_reads_per_round"]}
    return {"card": card, "n": N_MAIN, "wall_s": wall,
            "bootstrap_s": run["bootstrap_s"],
            "convergence_s": run["convergence_s"],
            "converged_round": run["converged_round"],
            "start_round": run["start_round"], "coverage": coverage,
            "bench_lines": lines,
            "ms_per_round_on": 1e3 / rps_on, "ms_per_round_off": 1e3 / rps_off,
            "window_on": prof_on, "window_off": prof_off, "alone": alone,
            "launches": counts,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "_run": run}


def flight_full(card: str, run: dict) -> dict:
    """Phase 20: phase 19's booted state with a 4-round flight ring, the
    broadcast marked and queued, then FLIGHT_ROUNDS rounds by ``steps``
    (the interleave must launch once a round) and the same rounds by
    ``record``; the ring's Trace equals record's last 4 rounds bit for
    bit and both final states are identical.  Then ms per round with the
    ring against the same state without it (one call each, K_PROG
    rounds), the kernel's device time per launch, and the peak memory."""
    from partisan_tpu_torch import kernels, latency, provenance, trace
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster

    torch.cuda.reset_peak_memory_stats()
    model, boot, start = run["model"], run["boot_state"], run["start_round"]
    cfg = run["cluster"].cfg.replace(flight_rounds=FLIGHT_K)
    fcl = Cluster(cfg, model=model)
    shape = fcl.flight_shape(boot)
    if shape != (N_MAIN, 77, 19):
        raise AssertionError(f"flight shape {shape}")
    st0 = boot._replace(
        flight=latency.flight_init(cfg, shape, device=boot.rnd.device),
        provenance=provenance.mark_origin(boot.provenance, 0, 0, rnd=start),
        model=model.broadcast(boot.model, 0, 0, start))
    kernels.reset_launches()
    t0 = time.perf_counter()
    st_s = fcl.steps(st0, FLIGHT_ROUNDS)
    sc._sync(st_s)
    t_steps = time.perf_counter() - t0
    steps_launches = kernels.launches["interleave"]
    if steps_launches != FLIGHT_ROUNDS:
        raise AssertionError(f"{steps_launches} interleave launches in "
                             f"{FLIGHT_ROUNDS} flight rounds")
    kernels.reset_launches()
    t0 = time.perf_counter()
    st_r, tr = fcl.record(st0, FLIGHT_ROUNDS)
    sc._sync(st_r)
    t_rec = time.perf_counter() - t0
    rec_launches = kernels.launches["interleave"]
    ring = latency.flight_trace(st_s.flight)
    cap = trace.from_capture(tr).tail(FLIGHT_K)
    if not (np.array_equal(ring.sent, cap.sent)
            and np.array_equal(ring.dropped, cap.dropped)
            and np.array_equal(ring.rounds, cap.rounds)):
        raise AssertionError("the flight ring != record's last rounds")
    n_leaves = assert_identical(st_s, st_r, "steps vs record with a ring")
    del tr, st_r
    plain = st_s._replace(flight=())
    kernels.reset_launches()
    prof_ring = round_profile(lambda: fcl.steps(st_s, sc.K_PROG), sc.K_PROG,
                              kernel="interleave")
    prof_plain = round_profile(
        lambda: run["cluster"].steps(plain, sc.K_PROG), sc.K_PROG)
    win_launches = kernels.launches["interleave"]
    return {"card": card, "n": N_MAIN, "flight_rounds": FLIGHT_K,
            "ring_shape": list(st_s.flight.sent.shape),
            "ring_gib": st_s.flight.sent.numel() * 4 / 2 ** 30,
            "rounds": FLIGHT_ROUNDS, "steps_s": t_steps, "record_s": t_rec,
            "interleave_launches": {"steps": steps_launches,
                                    "record": rec_launches,
                                    "profiled_windows": win_launches},
            "leaves": n_leaves, "events_in_ring": sum(1 for _ in
                                                     ring.events()),
            "window_ring": prof_ring, "window_no_ring": prof_plain,
            "kernel_device_ms_per_launch":
            prof_ring["interleave_device_ms_per_launch"],
            "kernel_launches_profiled": prof_ring["interleave_launches"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {"interleave": steps_launches + rec_launches
                         + win_launches, "minimal": 0}}


def control_ab_full(card: str) -> dict:
    """Phase 21: ``scenarios.control_ab(scale=1.0)`` on the card; every
    arm's dict must equal the JAX package's (``JAX_CONTROL_AB``) and
    ``all_win`` must hold.  Each arm's wall and rounds, and the first
    PROFILED_ROUNDS rounds of its second ``steps`` call (the first after
    its boot) under torch.profiler: launches, host reads and device time
    per round.  The profiled rounds and their profiler's time are left
    out of the arm's ms per round."""
    from torch.profiler import ProfilerActivity, profile

    from partisan_tpu_torch import cluster as cluster_mod
    from partisan_tpu_torch import scenarios as sc

    arms: dict = {}
    cur = {"arm": None}
    orig_steps = cluster_mod.Cluster.steps

    def steps(cl, st, k):
        a = arms[cur["arm"]]
        a["rounds"] += k
        a["steps_calls"] += 1
        if a["steps_calls"] != 2:
            return orig_steps(cl, st, k)
        r = min(k, PROFILED_ROUNDS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st = orig_steps(cl, st, r)
            torch.cuda.synchronize()
        c = window_counts(prof)
        a["profiled_rounds"] = r
        a["launches_per_round"] = c["launches"] / r
        a["host_reads_per_round"] = c["host_reads"] / r
        a["device_ms_per_round"] = c["device_us"] / 1e3 / r
        a["_profiled_s"] = time.perf_counter() - t0
        return orig_steps(cl, st, k - r) if k > r else st

    def timed_arm(name, fn):
        def run(*args, **kw):
            adaptive = args[0] if args else kw.get("adaptive", True)
            label = f"{name}_{'adaptive' if adaptive else 'static'}"
            cur["arm"] = label
            arms[label] = {"rounds": 0, "steps_calls": 0}
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            a = arms[label]
            a["wall_s"] = time.perf_counter() - t0
            a["ms_per_round"] = (a["wall_s"] - a.pop("_profiled_s")) \
                * 1e3 / (a["rounds"] - a["profiled_rounds"])
            return out
        return run

    names = ("fanout_ab_arm", "fanout_calm_arm", "config8_overload",
             "healing_ab_arm")
    saved = {k: getattr(sc, k) for k in names}
    cluster_mod.Cluster.steps = steps
    for k in names:
        setattr(sc, k, timed_arm(k, saved[k]))
    try:
        t0 = time.perf_counter()
        res = sc.control_ab(scale=1.0)
        wall = time.perf_counter() - t0
    finally:
        cluster_mod.Cluster.steps = orig_steps
        for k in names:
            setattr(sc, k, saved[k])
    for key, want in JAX_CONTROL_AB.items():
        if res[key] != want:
            raise AssertionError(f"control_ab {key}: card {res[key]} != "
                                 f"JAX {want}")
    if res["all_win"] is not True:
        raise AssertionError("control_ab: all_win is not true")
    return {"card": card, "wall_s": wall, "all_win": res["all_win"],
            "arms": arms, "result": res}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from partisan_tpu_torch import kernels, probe
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.ops import plane as plane_ops

    t_all = time.perf_counter()
    card = smi_line()
    kind = torch.cuda.get_device_name(0)

    # 1. environment card (Triton's version is reported, not used)
    from importlib import metadata

    try:
        triton_version = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton_version = None
    log({"phase": "env", "python": sys.version.split()[0],
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "nvcc": nvcc_version(), "triton": triton_version,
         "device": kind, "count": torch.cuda.device_count(), "card": card})

    # 2. build both kernels with one nvcc call; the launch path's reads
    t0 = time.perf_counter()
    compiled = kernels.build()
    log({"phase": "build", "sources": [str(p) for p in kernels.sources()],
         "library": str(kernels.lib_path()), "compiled": compiled,
         "seconds": time.perf_counter() - t0, "ptxas": ptxas_report()})

    # 3. kernel checks against the plain version
    bench_dtypes = list(sc.bench_config(8).wire_dtypes)
    main_check = kernel_check((N_MAIN, 77), bench_dtypes, seed=1)
    log({"phase": "kernel_check", "kernel": "interleave", "card": card,
         **main_check})
    ragged = kernel_check((4099, 13), bench_dtypes[:12], seed=2)
    log({"phase": "kernel_check", "kernel": "interleave", "card": card,
         **ragged})
    plane_dtypes = list(sc.bench_config(8).replace(**PLANES).wire_dtypes)
    planes_check = kernel_check((N_MAIN, 77), plane_dtypes, seed=7)
    log({"phase": "kernel_check", "kernel": "interleave", "card": card,
         **planes_check})
    paxos_dtypes = list(Config(n_nodes=5, msg_words=13).wire_dtypes)
    edges = interleave_edges(bench_dtypes, paxos_dtypes, plane_dtypes,
                             seed=6)
    log({"phase": "kernel_edges", "kernel": "interleave", "cases": edges})

    # 4. GPU vs CPU parity at n=512
    t0 = time.perf_counter()
    g_boot, g_st, g_tr, g_conv = drive_small("cuda")
    c_boot, c_st, c_tr, c_conv = drive_small("cpu")
    n_leaves = assert_identical(g_boot, c_boot, "n=512 after the ladder")
    assert_identical(g_st, c_st, "n=512 after record")
    assert_identical(g_tr, c_tr, "n=512 trace")
    if g_conv != c_conv or g_conv < 0:
        raise AssertionError(f"n=512 convergence: card {g_conv}, "
                             f"CPU {c_conv}")
    log({"phase": "parity", "n": N_PARITY, "leaves": n_leaves,
         "converged_round": g_conv, "trace_shape": list(g_tr.sent.shape),
         "seconds": time.perf_counter() - t0})
    del g_st, g_tr, c_st, c_tr

    # 5. the main path at n=32768, kernel counts reset just before
    kernels.reset_launches()
    run = sc.bench_broadcast(N_MAIN)
    cl, model, st = run["cluster"], run["model"], run["state"]
    conv = run["converged_round"]
    coverage = float(model.coverage(st.model, st.faults.alive, 0))
    if coverage != 1.0:
        raise AssertionError(f"n={N_MAIN}: coverage {coverage}, not 1.0")
    rps = sc._throughput(cl, st)
    t0 = time.perf_counter()
    st2, tr = cl.record(st, 10)
    sc._sync(st2)
    t_rec = time.perf_counter() - t0
    counts = dict(kernels.launches)
    want = (10, N_MAIN, 77, 16)
    if tuple(tr.sent.shape) != want:
        raise AssertionError(f"trace shape {tuple(tr.sent.shape)} != {want}")
    if not bool((tr.sent[..., 0] != 0).any()):
        raise AssertionError("record(10) captured no emission")
    missing = [k for k in ("interleave",) if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    log({"phase": "main_path", "n": N_MAIN, "card": card,
         "init_s": run["init_s"], "bootstrap_s": run["bootstrap_s"],
         "converged_round": conv,
         "convergence_rounds": conv - run["start_round"],
         "convergence_wall_s": run["convergence_s"], "coverage": coverage,
         "rounds_per_sec": rps, "record10_s": t_rec,
         "stats": {"emitted": int(st.stats.emitted),
                   "delivered": int(st.stats.delivered),
                   "dropped": int(st.stats.dropped)},
         "launches": counts, "peak_mem_gib":
         torch.cuda.max_memory_allocated() / 2 ** 30})
    del tr, st2
    cl5, st5 = cl, st
    boot_main = run["boot_state"]
    del run

    # 6. the probe path, counts reset just before and read just after
    kernels.reset_launches()
    t0 = time.perf_counter()
    probes = [probe.probe_minimal()] + [probe.probe_interleave(n)
                                        for n in (8192, N_MAIN)]
    probe_counts = dict(kernels.launches)
    if not all(r["ok"] for r in probes):
        raise AssertionError(f"probe failed: {probes}")
    if probe_counts != {"interleave": 2, "minimal": 1}:
        raise AssertionError(f"probe path launches {probe_counts}, want "
                             "one minimal and two interleave")
    for n in (8192, N_MAIN):
        planes = torch.arange(probe.W * n * probe.S, dtype=torch.int32,
                              device="cuda").reshape(probe.W, n, probe.S)
        ws = list(planes.unbind(0))
        # host-bound calls: 200 of them, so one slow host moment does not
        # set the mean
        lib_dev, lib_host = device_host_ms(
            lambda: planes.permute(1, 2, 0).contiguous(), 200)
        log({"phase": "probe_interleave", "n": n, "card": card,
             **timed(lambda: plane_ops.interleave(plane_ops.Planes(ws)),
                     200),
             "plain_ms": time_ms(lambda: plane_ops.interleave_plain(ws),
                                 200),
             "library_ms": time_ms(lambda: planes.permute(1, 2, 0)
                                   .contiguous(), 200),
             "library_device_ms": lib_dev, "library_host_ms": lib_host,
             "bound_ms": 2 * planes.numel() * 4 / HBM_BYTES_PER_S * 1e3})
    min_main = minimal_check((256, 256), seed=3)
    min_ragged = minimal_check((1000, 37), seed=4)
    min_edges = [minimal_check(shape, seed=5, offset=off, timing=False)
                 for shape, off in (((1000, 37), 1), ((5,), 3), ((1,), 0),
                                    ((4099,), 2))]
    log({"phase": "probe", "card": card, "probes": probes,
         "launches": probe_counts,
         "minimal": [min_main, min_ragged] + min_edges,
         "seconds": time.perf_counter() - t0})

    # 7. Filibuster parity, small: the card against the CPU
    t0 = time.perf_counter()
    g_res = [result_fields(r) for r in fb_setups("cuda")]
    c_res = [result_fields(r) for r in fb_setups("cpu")]
    if g_res != c_res:
        raise AssertionError(f"Filibuster results differ: card {g_res}, "
                             f"CPU {c_res}")
    g_st, g_tr = omission_record("cuda", g_boot)
    c_st, c_tr = omission_record("cpu", c_boot)
    n_leaves = assert_identical(g_st, c_st, "n=512 omission record state")
    assert_identical(g_tr, c_tr, "n=512 omission record trace")
    log({"phase": "filibuster_parity", "results": [
        {k: v for k, v in r.items() if k != "render"} for r in g_res],
        "omission_record": {
            "n": N_PARITY, "leaves": n_leaves,
            "sent_records": int((g_tr.sent[..., 0] != 0).sum())},
        "seconds": time.perf_counter() - t0})
    del g_boot, c_boot, g_st, c_st, g_tr, c_tr

    # 8. the Filibuster path at n=32768
    fb = filibuster_full(boot_main)
    log({"phase": "filibuster_full", "card": card, **fb})
    del boot_main

    # 9. scenario parity, small: card against CPU
    t0 = time.perf_counter()
    par = scenario_parity()
    log({"phase": "scenario_parity", **par,
         "seconds": time.perf_counter() - t0})

    # 10. the scenario suite at the default sizes, counts reset just before
    kernels.reset_launches()
    t0 = time.perf_counter()
    suite = scenario_suite(card)
    suite_counts = dict(kernels.launches)
    log({"phase": "scenario_suite", "card": card, "launches": suite_counts,
         "seconds": time.perf_counter() - t0,
         "wall_s": {r["label"]: r["wall_s"] for r in suite}})

    # 11. causal and channel parity, small: card against CPU
    kernels.reset_launches()
    t0 = time.perf_counter()
    lp = lane_parity()
    lp_counts = dict(kernels.launches)
    log({"phase": "causal_parity", **lp, "launches": lp_counts,
         "seconds": time.perf_counter() - t0})

    # 12. config 5 at n=100,000, counts reset just before
    kernels.reset_launches()
    c5 = config5_full(card)
    c5_counts = dict(kernels.launches)
    log({"phase": "config5", "n": N_CONFIG5, **c5, "launches": c5_counts})

    # 13. config 6's 48 cells, counts reset just before
    kernels.reset_launches()
    c6 = config6_full(card)
    c6_counts = dict(kernels.launches)
    log({"phase": "config6", "num_messages": ECHO_MESSAGES, **c6,
         "launches": c6_counts})

    # 14. app parity, small: card against CPU
    kernels.reset_launches()
    t0 = time.perf_counter()
    ap = app_parity()
    ap_counts = dict(kernels.launches)
    log({"phase": "app_parity", **ap, "launches": ap_counts,
         "seconds": time.perf_counter() - t0})

    # 15. the property harness, card against CPU
    kernels.reset_launches()
    t0 = time.perf_counter()
    hp = harness_phase(card)
    hp_counts = dict(kernels.launches)
    log({"phase": "harness", **hp, "launches": hp_counts,
         "seconds": time.perf_counter() - t0})

    # 16. Filibuster over Paxos, counts reset inside around the card's run
    t0 = time.perf_counter()
    fp = filibuster_paxos_phase(card)
    log({"phase": "filibuster_paxos", **fp,
         "seconds": time.perf_counter() - t0})

    # 17. the app models at n=48, counts reset just before
    kernels.reset_launches()
    t0 = time.perf_counter()
    am = app_models_full(card)
    am_counts = dict(kernels.launches)
    log({"phase": "app_models", "n": N_APP, "rounds": APP_ROUNDS, **am,
         "launches": am_counts, "seconds": time.perf_counter() - t0})

    # 18. the planes, small: card against CPU after every round
    kernels.reset_launches()
    t0 = time.perf_counter()
    pp = planes_parity()
    pp_counts = dict(kernels.launches)
    log({"phase": "planes_parity", "card": card, **pp,
         "launches": pp_counts, "seconds": time.perf_counter() - t0})

    # 19. the bench path with the planes at n=32768, counts reset inside
    t0 = time.perf_counter()
    bp = bench_planes_full(card, cl5, st5, conv)
    run19 = bp.pop("_run")
    log({"phase": "bench_planes", **bp,
         "seconds": time.perf_counter() - t0})
    del cl5, st5

    # 20. the flight ring at full width, counts reset inside
    t0 = time.perf_counter()
    fl = flight_full(card, run19)
    log({"phase": "flight", **fl, "seconds": time.perf_counter() - t0})
    del run19

    # 21. the controllers' A/B at the reference's sizes
    kernels.reset_launches()
    ca = control_ab_full(card)
    ca_counts = dict(kernels.launches)
    log({"phase": "control_ab", **ca, "launches": ca_counts})

    new_paths = {"causal_parity": lp_counts, "config5": c5_counts,
                 "config6": c6_counts, "app_parity": ap_counts,
                 "harness": hp_counts, "filibuster_paxos": fp["launches"],
                 "app_models": am_counts, "planes_parity": pp_counts,
                 "bench_planes": bp["launches"], "flight": fl["launches"],
                 "control_ab": ca_counts}

    # 22. kernels line, card line, result line
    timing_keys = ("ms", "device_ms", "host_ms", "plain_ms", "library_ms",
                   "bound_ms")
    log({"kernels": [{
        "name": "interleave", "route": "cuda",
        "source": "partisan_tpu_torch/csrc/interleave.cu",
        "replaces": "tools/pallas_probe.py:54",
        "launches": counts["interleave"] + probe_counts["interleave"]
        + fb["launches"]["interleave"] + suite_counts["interleave"]
        + sum(c["interleave"] for c in new_paths.values()),
        "launches_by_path": {"bench_record": counts["interleave"],
                             "probe": probe_counts["interleave"],
                             "filibuster": fb["launches"]["interleave"],
                             "scenarios": suite_counts["interleave"],
                             **{k: c["interleave"]
                                for k, c in new_paths.items()}},
        "matches_plain": main_check["max_abs_err"] == 0
        and ragged["max_abs_err"] == 0
        and planes_check["max_abs_err"] == 0
        and all(r["max_abs_err"] == 0 for r in edges),
        "max_abs_err": max([main_check["max_abs_err"], ragged["max_abs_err"],
                            planes_check["max_abs_err"]]
                           + [r["max_abs_err"] for r in edges]),
        "w19": {k: planes_check[k] for k in timing_keys},
        **{k: main_check[k] for k in timing_keys}, "bound_by": "bytes",
    }, {
        "name": "minimal", "route": "cuda",
        "source": "partisan_tpu_torch/csrc/minimal.cu",
        "replaces": "tools/pallas_probe.py:59",
        "launches": probe_counts["minimal"] + suite_counts["minimal"]
        + sum(c["minimal"] for c in new_paths.values()),
        "launches_by_path": {"probe": probe_counts["minimal"],
                             "scenarios": suite_counts["minimal"],
                             **{k: c["minimal"]
                                for k, c in new_paths.items()}},
        "matches_plain": all(r["max_abs_err"] == 0
                             for r in [min_main, min_ragged] + min_edges),
        "max_abs_err": max(r["max_abs_err"]
                           for r in [min_main, min_ragged] + min_edges),
        **{k: min_main[k] for k in timing_keys}, "bound_by": "bytes",
    }]})
    print(f"chip_smoke wall {time.perf_counter() - t_all:.1f}s",
          file=sys.stderr)
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
