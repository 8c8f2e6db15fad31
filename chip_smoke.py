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
   W in {1, 12, 16, 32}, an out= slice of a [3, ...] buffer and an
   output that is not 16-byte aligned.  At the main shape: its time by
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
14. the kernels line, the card line, and last the result line
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


def _self_device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


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
    busy = sum(_self_device_us(e) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return busy / 1e3 / reps, host


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


def interleave_edges(bench_dtypes, seed: int) -> list:
    """The interleave, bit for bit, where its edge paths run: ragged
    tails of each dtype, planes that are views at an odd element offset,
    W in {1, 12, 16, 32}, an out= slice of a [3, ...] buffer (as
    Cluster.record passes) and an output that is not 16-byte aligned."""
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


def assert_identical(a, b, label: str) -> int:
    la, lb = state_leaves(a), state_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{label}: {len(la)} vs {len(lb)} leaves")
    for (pa, xa), (_, xb) in zip(la, lb):
        if xa.dtype != xb.dtype or xa.shape != xb.shape \
                or not np.array_equal(xa, xb):
            raise AssertionError(f"{label}: leaf {pa} differs between the "
                                 "card and the CPU")
    return len(la)


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


def filibuster_full(boot_state) -> dict:
    """The Filibuster path (phase 8) on the booted state's device and
    width."""
    from partisan_tpu_torch import cluster as cluster_mod, filibuster
    from partisan_tpu_torch import kernels, scenarios as sc
    from partisan_tpu_torch.models.plumtree import Plumtree
    from partisan_tpu_torch.types import MsgKind

    dev = boot_state.rnd.device
    n = boot_state.faults.alive.shape[0]
    start = int(boot_state.rnd)
    model = Plumtree()
    timing = {"records": 0, "record_s": 0.0, "copy_s": 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    class TimedCluster(cluster_mod.Cluster):
        """Counts record calls and times the device rounds (ending in a
        synchronize) apart from the trace's copy to the host."""

        def record(self, state, k):
            t0 = time.perf_counter()
            st, tr = super().record(state, k)
            sync()
            t1 = time.perf_counter()
            tr = tr._replace(sent=tr.sent.cpu(), dropped=tr.dropped.cpu(),
                             rnd=tr.rnd.cpu())
            timing["records"] += 1
            timing["record_s"] += t1 - t0
            timing["copy_s"] += time.perf_counter() - t1
            return st, tr

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


def round_profile(fn, rounds: int) -> dict:
    """Per round of ``fn`` (which runs ``rounds`` rounds): the wall of a
    bare call, then under torch.profiler the kernels' summed device time,
    the kernel launches and the host reads (``aten::_local_scalar_dense``:
    every ``bool()``/``int()`` of a card tensor)."""
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
    ev = prof.key_averages()
    kern = [e for e in ev if _self_device_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(_self_device_us(e) for e in kern) / 1e6
    return {"rounds": rounds, "wall_ms_per_round": wall * 1e3 / rounds,
            "device_ms_per_round": busy * 1e3 / rounds,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "launches_per_round": sum(e.count for e in kern) / rounds,
            "host_reads_per_round": sum(
                e.count for e in ev if e.key == "aten::_local_scalar_dense")
            / rounds}


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
    from partisan_tpu_torch.ops import rng

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
    gids = cl.comm.local_ids()
    keys = round_profile(lambda: rng.node_keys(cl.cfg.seed, st.rnd, gids), 1)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from partisan_tpu_torch import kernels, probe
    from partisan_tpu_torch import scenarios as sc
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
    edges = interleave_edges(bench_dtypes, seed=6)
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
    del tr, st2, st
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
    new_paths = {"causal_parity": lp_counts, "config5": c5_counts,
                 "config6": c6_counts}

    # 14. kernels line, card line, result line
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
        and all(r["max_abs_err"] == 0 for r in edges),
        "max_abs_err": max([main_check["max_abs_err"], ragged["max_abs_err"]]
                           + [r["max_abs_err"] for r in edges]),
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
