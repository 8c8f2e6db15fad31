"""bench.py's entry for the port: HyParView + Plumtree at bench.py's
configuration on one card, with bench.py's structure, names and JSON.

    python -m partisan_tpu_torch.bench                 # the size ladder
    python -m partisan_tpu_torch.bench --one 100000    # one size
    python -m partisan_tpu_torch.bench --one 256 --device cpu

The scenario is bench.py's: an n-node HyParView overlay booted by the
width-operand ladder (``scenarios._boot_ladder``), one Plumtree
broadcast from node 0 slot 0 stepped to full coverage in ``K_PROG``-round
executions, and the steady rounds/s read off those executions (the best
one; each is synchronized by the coverage check anyway).  ``--metrics``,
``--latency``, ``--health`` and ``--provenance`` turn bench.py's planes
on; their series go to stderr as JSON lines (``metrics``,
``metrics_totals``, ``latency``, ``health``, ``health_digest``,
``provenance``), and with ``--health`` convergence is polled through the
health digest.  ``--one N`` prints the run's dict as one JSON line;
``--extras PATH`` also writes the final state's leaf hashes, the run's
kernel launches and, on the card, its peak memory and a profiled window
(:func:`one_extras`).

``main()`` runs bench.py's ladder (100,000 then 32,768 nodes, 4,096 as
the fallback), each size ``WARM_RUNS`` times in fresh processes within
``TIME_BUDGET_S`` and ``PER_SIZE_CAP_S``, then one COLD run of the top
size, and prints one JSON document: ``metric``, ``value`` (rounds/s),
``unit``, ``vs_baseline``, ``convergence_rounds``,
``convergence_wall_s``, ``all_sizes`` with warm and cold spreads,
``validation``, a ``kernels`` card (the interleave kernel against its
plain version at the bench round's plane shape, with the card's name
and power limit), and bench.py's ``cost``, ``lint`` and
``bench_history`` cards: the census of bench's round at the top size
(``lint/cost.py``: ``[n, ., .]`` intermediate MiB, ops, gathers,
scatters and host reads per ``round.*`` phase, and the superstep
guard's verdict), the quick lint matrix's verdict (``lint.run``, on the
CPU, where its budgets were pinned), and the run's rows folded into the
port's ledger ``TORCH_BENCH_LEDGER.jsonl`` with their deltas
(``perfwatch``).  None of the three can sink the run.  bench.py's TPU
cards (``pallas_probe``, ``memory``) and its ``north_star`` targets have
no meaning here and are left out.

**Cold** here means a fresh process whose kernel build directory is a
fresh temporary directory (``--build-dir``): the run's ``backend`` phase
then pays the nvcc build of ``csrc/`` and the card's first launches, as
bench.py's cold run pays XLA's program build.  Warm runs load the built
library.

The device defaults to the card; ``--device cpu`` runs on the CPU (the
tests hold this entry against bench.py there).  ``--fleet W n`` prints
the fleet sweep's distribution card (``fleet``); ``--dry-1m`` is not
ported (it needs the census of a sharded round).

The cluster comes from ``scenarios.make_cluster_auto``, as bench.py's
does: at ``n >= SHARDED_N_MIN`` with a shard count above 1 (say
``PARTISAN_SHARDS=4``, four shards on one card) the run is sharded; a
verbose run prints the cluster's type and shard count to stderr as a
``{"kind": "cluster", ...}`` line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from partisan_tpu_torch import device as device_mod
from partisan_tpu_torch import kernels
from partisan_tpu_torch import scenarios as sc
from partisan_tpu_torch.cluster import Cluster
from partisan_tpu_torch.models.plumtree import Plumtree

TIME_BUDGET_S = 560.0          # hard self-imposed wall budget
PER_SIZE_CAP_S = 340.0         # no single rung may eat the whole budget
WARM_RUNS = 3                  # warm median-of-N target per size
STALL_MARGIN_S = 30.0          # a run this far above the fastest run's
#                                total is counted as stalled (counted,
#                                never filtered out)
PLANE_SLOTS = 77               # the bench round's emission slots a node
#                                (Cluster.record's [rounds, n, 77, 16])

_ROOT = Path(__file__).resolve().parent.parent


def make_cfg(width: int, metrics: bool = False, latency: bool = False,
             health: bool = False, provenance: bool = False,
             superstep: int = 1):
    """bench.py's Config (``bench.py:96-140``) at ``width`` nodes."""
    return sc.bench_config(width).replace(
        metrics=metrics, latency=latency,
        health=(sc.K_PROG if health else 0), provenance=provenance,
        superstep=superstep)


def _components(act: np.ndarray) -> tuple:
    """Host label propagation over the active views: (sorted component
    sizes, nodes with an empty active view)."""
    n = act.shape[0]
    lbl = np.arange(n)
    src = np.repeat(np.arange(n), act.shape[1])
    dst = act.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    for _ in range(64):
        new = lbl.copy()
        np.minimum.at(new, dst, lbl[src])
        np.minimum.at(new, src, lbl[dst])
        if (new == lbl).all():
            break
        lbl = new
    sizes = np.bincount(lbl)
    return np.sort(sizes[sizes > 0]), int((act.max(axis=1) < 0).sum())


def report_lines(cfg, st) -> list[dict]:
    """bench.py's stderr rows for the planes ``cfg`` turns on, from the
    final state ``st``: the metrics rows and totals, the latency
    percentiles, the health rows and digest, the provenance headline."""
    from partisan_tpu_torch import health as health_mod
    from partisan_tpu_torch import latency as latency_mod
    from partisan_tpu_torch import metrics as metrics_mod
    from partisan_tpu_torch import provenance as provenance_mod

    n = cfg.n_nodes
    names = tuple(c.name for c in cfg.channels)
    out = []
    if cfg.metrics:
        snap = metrics_mod.snapshot(st.metrics)
        out += [{"kind": "metrics", "n": n, **row}
                for row in metrics_mod.rows(snap, channels=names)]
        out.append({"kind": "metrics_totals", "n": n,
                    **metrics_mod.totals(snap)})
    if cfg.latency:
        out.append({"kind": "latency", "n": n,
                    **latency_mod.percentiles(st.latency, channels=names)})
    if cfg.health:
        out += [{"kind": "health", "n": n, **row}
                for row in health_mod.rows(health_mod.snapshot(st.health))]
        dig = health_mod.digest(st)
        out.append({"kind": "health_digest", "n": n, "word": dig,
                    **health_mod.decode_digest(dig)})
    if cfg.provenance:
        snap = provenance_mod.snapshot(st.provenance)
        tr = provenance_mod.tree(snap, 0)
        out.append({"kind": "provenance", "n": n,
                    **provenance_mod.redundancy(snap),
                    "tree_depth_mean": tr["depth_mean"],
                    "tree_depth_max": tr["depth_max"],
                    "branching_mean": tr["branching_mean"],
                    "branching_max": tr["branching_max"],
                    "claimed": tr["claimed"],
                    "coverage_round": tr["cover_round"]})
    return out


def run(n: int, verbose: bool = False, metrics: bool = False,
        latency: bool = False, health: bool = False,
        provenance: bool = False, superstep: int = 1, device=None,
        widths=None, handles: bool = False) -> dict:
    """One bench run at ``n`` nodes; returns bench.py's result dict (and,
    with ``handles``, the cluster, model, booted and final states and
    the broadcast round, for an in-process caller).  ``widths`` are the
    ladder's rungs (default ``[8192, n]``, 8192 only below ``n``)."""
    from partisan_tpu_torch import health as health_mod
    from partisan_tpu_torch import provenance as provenance_mod

    phases: dict[str, float] = {}
    t_all = time.perf_counter()

    def mark(name: str, t0: float) -> None:
        phases[name] = round(time.perf_counter() - t0, 3)
        if verbose:
            print(f"n={n} phase {name}: {phases[name]}s", file=sys.stderr,
                  flush=True)

    # backend: the card's first allocation and the kernel library (built
    # here unless its build directory holds it: the cold run's cost)
    t0 = time.perf_counter()
    dev = device_mod.resolve(device)
    torch.zeros(8, device=dev).cpu()
    if dev.type == "cuda":
        kernels.build()
    mark("backend", t0)

    cfg = make_cfg(n, metrics, latency, health, provenance, superstep)
    model = Plumtree()
    cl = sc.make_cluster_auto(cfg, model=model, device=dev)
    if verbose:
        print(json.dumps({"kind": "cluster", "n": n,
                          "type": type(cl).__name__,
                          "shards": getattr(cl, "n_shards", 1)}),
              file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    st = cl.init()
    sc._sync(st)
    mark("init", t0)

    # the width ladder: first_exec is the wall to the end of the first
    # execution, smallw_boot the wall below full activation
    t0 = time.perf_counter()
    full_w = {}

    def on_wave(hi, wave_st, width):
        if "first_exec" not in phases:
            sc._sync(wave_st)
            phases["first_exec"] = round(time.perf_counter() - t0, 3)
        if width < n:
            sc._sync(wave_st)
            full_w["smallw_end"] = time.perf_counter()
        if verbose:
            t1 = time.perf_counter()
            sc._sync(wave_st)
            print(f"n={n} wave ->{hi} (width {width}): "
                  f"{time.perf_counter() - t1:.2f}s", file=sys.stderr,
                  flush=True)

    _, st = sc._boot_ladder(lambda w: cl, n, widths=widths,
                            settle_execs=1, on_wave=on_wave, final_state=st)
    phases["smallw_boot"] = round(full_w.get("smallw_end", t0) - t0, 3)
    mark("bootstrap", t0)
    boot = st

    if verbose:
        sizes, iso = _components(st.manager.active.cpu().numpy())
        print(f"n={n} overlay: {len(sizes)} components, sizes tail "
              f"{sizes[-4:].tolist()}, smalls {sizes[:-1].tolist()[:12]}, "
              f"empty-active nodes {iso}", file=sys.stderr, flush=True)

    # broadcast convergence; the steady rate is K_PROG over the best
    # timed execution of this loop
    start_rnd = int(st.rnd)
    if provenance:
        st = st._replace(provenance=provenance_mod.mark_origin(
            st.provenance, 0, 0, rnd=start_rnd))
        sc._sync(st)
    t0 = time.perf_counter()
    st = st._replace(model=model.broadcast(st.model, 0, 0, start_rnd))
    max_rounds = max(300, 2 * int(np.log2(n)) * 20)
    conv = -1
    best = float("inf")
    for _ in range(0, max_rounds + sc.K_PROG, sc.K_PROG):
        if health:
            word = health_mod.digest(st)
            done = health_mod.digest_converged(word)
            if verbose:
                print(f"n={n} rnd {int(st.rnd)}: digest "
                      f"{health_mod.decode_digest(word)}",
                      file=sys.stderr, flush=True)
        else:
            cov = float(model.coverage(st.model, st.faults.alive, 0))
            done = cov == 1.0
            if verbose:
                print(f"n={n} rnd {int(st.rnd)}: coverage {cov:.6f}",
                      file=sys.stderr, flush=True)
        if done:
            conv = int(st.rnd)
            break
        t1 = time.perf_counter()
        st = cl.steps(st, sc.K_PROG)
        sc._sync(st)
        best = min(best, time.perf_counter() - t1)
    mark("converge", t0)
    conv_rounds = conv - start_rnd if conv >= 0 else -1
    if conv < 0:
        raise AssertionError(f"n={n}: plumtree broadcast did not converge")
    rps = sc.K_PROG / best
    phases["total"] = round(time.perf_counter() - t_all, 3)
    result = {"n": n, "rounds_per_sec": rps, "converged_round": conv,
              "convergence_rounds": conv_rounds,
              "convergence_wall_s": phases["converge"],
              "steady_k": sc.K_PROG,
              "dropped": int(st.stats.dropped),
              "emitted": int(st.stats.emitted),
              "phases": phases}
    if superstep > 1:
        result["superstep"] = superstep
    for line in report_lines(cfg, st):
        print(json.dumps(line), file=sys.stderr)
    if verbose:
        print(f"n={n}: {rps:.1f} rounds/s, broadcast converged in "
              f"{conv_rounds} rounds ({phases['converge']:.1f}s wall), "
              f"phases={phases}", file=sys.stderr)
    if handles:
        result.update(cluster=cl, model=model, boot_state=boot, state=st,
                      start_round=start_rnd)
    return result


def state_hashes(state) -> dict:
    """One sha256 (16 hex digits) per state leaf, in the reference's
    leaf order, each over the leaf's little-endian bytes as the JAX
    package holds it, and one over them all (``state_sha``):
    tools/jax_reference_values.py's hashes of the same state."""
    from partisan_tpu_torch import state_io

    hashes = [hashlib.sha256(np.ascontiguousarray(x).tobytes())
              .hexdigest()[:16]
              for _, x in state_io.flatten(state_io.state_to_numpy(state))]
    return {"leaf_hashes": hashes,
            "state_sha": hashlib.sha256("".join(hashes).encode())
            .hexdigest()[:16]}


def one_extras(res: dict) -> dict:
    """What a ``--one`` caller asks beside the result line: the final
    coverage, the state's hashes, the run's kernel launches and, on the
    card, the peak memory, a ``K_PROG``-round profiled window from the
    final state (ms, launches, host reads and copies per round, the idle
    share) and its phase table (:func:`phase_table`)."""
    from partisan_tpu_torch import perfwatch

    cl, st, model = res["cluster"], res["state"], res["model"]
    out = {"coverage": float(model.coverage(st.model, st.faults.alive, 0)),
           "launches": dict(kernels.launches), **state_hashes(st)}
    if st.rnd.is_cuda:
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if isinstance(cl, Cluster):
            # the profiled window and the phase table census one
            # device's round; a sharded cluster's shard threads are out
            # of the profiler's host view, so it reports neither
            out["window"] = perfwatch.round_profile(
                lambda: cl.steps(st, sc.K_PROG), sc.K_PROG)
            out["phase_table"] = phase_table(cl, st, sc.K_PROG)
    return out


def phase_table(cl, st, rounds: int, names: bool = False) -> dict:
    """Where ``rounds`` rounds from ``st`` go, per ``round.*`` phase: a
    census of one round on ``st`` (``lint/cost.py``), a torch.profiler
    capture of the rounds attributed to the phases
    (``perfwatch.capture``, ``attribute``) and the two reconciled
    (``perfwatch.reconcile``), per round: device ms and launches
    measured, ``[n, ., .]`` MiB, gathers, scatters, ops and host reads
    priced.  ``device_ms`` is the capture's whole device time a round;
    the capture's process must be the only one that has profiled the
    card.  With ``names``, also the capture's records per kernel
    name."""
    from partisan_tpu_torch import perfwatch
    from partisan_tpu_torch.lint import cost

    cens = cost.census_program(cost.bench_round_program(cluster=cl,
                                                        state=st))
    with tempfile.TemporaryDirectory(prefix="ptt_phases_") as td:
        with perfwatch.capture(td):
            cl.steps(st, rounds)
        measured = perfwatch.attribute(td)
        window = perfwatch.capture_window(td)
    rows = perfwatch.reconcile(measured, cens, rounds=rounds)
    phases = {}
    for r in rows:
        pc = cens.phases.get(r["phase"], cost.PhaseCost())
        phases[r["phase"]] = {
            "device_ms": r["measured_ms"] / rounds,
            "launches": r["events"] / rounds,
            "host_reads": pc.host_reads, "gathers": pc.gathers,
            "scatters": pc.scatters, "ops": pc.eqns,
            "interm_mib": round(pc.interm_bytes / 2**20, 2),
            "time_share": r["time_share"], "outlier": r["outlier"]}
    return {"n": cl.cfg.n_nodes, "rounds": rounds, "phases": phases,
            "device_ms": sum(m["ms"] for m in measured.values()) / rounds,
            "launches": sum(m["events"] for m in measured.values())
            / rounds,
            "window_device_ms": window.get("device_us", 0.0) / 1e3 / rounds,
            "window_launches": window.get("launches", 0) / rounds,
            "records_lost": max(0, window.get("kernel_launch_calls", 0)
                                - window.get("kernel_records", 0)),
            "records_orphaned": window.get("orphans", 0),
            "census": {k: v for k, v in cens.rows()[-1].items()
                       if k != "phase"},
            "outliers": [r["phase"] for r in rows if r["outlier"]],
            **({"by_name": window.get("names", {})} if names else {})}


def _run_one_subprocess(n: int, timeout_s: float,
                        cache_dir: str | None = None, superstep: int = 1,
                        device: str | None = None) -> dict | None:
    """One size in a fresh interpreter; ``cache_dir`` is its kernel build
    directory (a fresh temporary directory = a cold run)."""
    cmd = [sys.executable, "-m", "partisan_tpu_torch.bench", "--one",
           str(n)]
    if cache_dir is not None:
        cmd += ["--build-dir", cache_dir]
    if superstep > 1:
        cmd += ["--superstep", str(superstep)]
    if device is not None:
        cmd += ["--device", device]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout_s, cwd=_ROOT)
    except subprocess.TimeoutExpired as e:
        print(f"n={n}: timed out after {timeout_s:.0f}s", file=sys.stderr)
        for stream in (e.stderr, e.stdout):
            if stream:
                text = stream.decode() if isinstance(stream, bytes) \
                    else stream
                sys.stderr.write(text[-2000:])
        return None
    sys.stderr.write(out.stderr[-2000:])
    for line in reversed(out.stdout.strip().splitlines()):
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(d, dict) and "rounds_per_sec" in d:
            return d
    return None


def _spread(vals) -> dict:
    vals = sorted(vals)
    return {"median": round(statistics.median(vals), 3),
            "min": round(vals[0], 3), "max": round(vals[-1], 3)}


def _aggregate_warm(runs: list[dict]) -> dict:
    """Warm median-of-N section: spread and stall count over every run
    that produced a result."""
    totals = [r["phases"]["total"] for r in runs]
    stalls = sum(1 for t in totals if t > min(totals) + STALL_MARGIN_S)
    return {
        "runs": len(runs),
        "rounds_per_sec": _spread([r["rounds_per_sec"] for r in runs]),
        "total_s": _spread(totals),
        "bootstrap_s": _spread([r["phases"].get("bootstrap", 0.0)
                                for r in runs]),
        "first_exec_s": _spread([r["phases"].get("first_exec", 0.0)
                                 for r in runs]),
        "convergence_rounds": [r["convergence_rounds"] for r in runs],
        "convergence_wall_s": _spread([r["convergence_wall_s"]
                                       for r in runs]),
        "stalls": stalls,
        "run_phases": [r["phases"] for r in runs],
    }


def _cold_section(cold: dict | None, warm: dict | None,
                  skipped: str | None = None) -> dict:
    """Cold section: the first-execution wall of a fresh process with a
    fresh kernel build directory, and the build (cold first_exec)
    against load (warm median first_exec) split."""
    if skipped:
        return {"skipped": skipped}
    if cold is None:
        return {"skipped": "cold run produced no result"}
    out = {
        "total_s": cold["phases"]["total"],
        "bootstrap_s": cold["phases"].get("bootstrap"),
        "first_exec_s": cold["phases"].get("first_exec"),
        "program_build_s": cold["phases"].get("first_exec"),
        "phases": cold["phases"],
    }
    if warm is not None:
        out["program_load_s"] = warm["first_exec_s"]["median"]
        out["build_vs_load_s"] = [out["program_build_s"],
                                  out["program_load_s"]]
    return out


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return out.stdout.strip().splitlines()[0]


def _kernels_card(n: int, device=None) -> dict:
    """The interleave kernel against its plain version at the bench
    round's plane shape ``[n, PLANE_SLOTS]`` x ``msg_words`` (bench's
    wire dtypes, seeded random words), bit for bit, with the times of
    both by CUDA events and the card's name and power limit.  On the
    CPU the kernel does not run, and the card says so."""
    from partisan_tpu_torch.ops import plane as plane_ops

    dev = device_mod.resolve(device)
    if dev.type != "cuda":
        return {"skipped": "the kernel runs on the card only"}
    gen = torch.Generator(device=dev).manual_seed(1)
    ws = []
    for dt in sc.bench_config(8).wire_dtypes:
        info = torch.iinfo(dt)
        ws.append(torch.randint(info.min, info.max, (n, PLANE_SLOTS),
                                generator=gen, device=dev, dtype=torch.int64)
                  .to(dt))
    got = plane_ops.interleave(plane_ops.Planes(ws))
    want = plane_ops.interleave_plain(ws)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    return {"name": "interleave", "shape": [n, PLANE_SLOTS, len(ws)],
            "max_abs_err": err, "matches_plain": err == 0,
            "ms": ms(lambda: plane_ops.interleave(plane_ops.Planes(ws))),
            "plain_ms": ms(lambda: plane_ops.interleave_plain(ws)),
            "card": card_line()}


def _cost_card(n: int, device=None) -> dict:
    """The census of bench's round at ``n`` nodes on its init state
    (``lint/cost.py``), per phase, with the superstep guard's verdict
    against ``cost_budgets.SUPERSTEP_INTERM_BUDGET_MIB``."""
    try:
        from partisan_tpu_torch.lint import cost, cost_budgets

        cl = Cluster(make_cfg(n), model=Plumtree(), device=device)
        prog = cost.bench_round_program(cluster=cl)
        c = cost.census_program(prog)
        rows = c.rows()
        budget = cost_budgets.SUPERSTEP_INTERM_BUDGET_MIB
        mib = c.total.interm_bytes / 2**20
        return {"n": n, **{k: v for k, v in rows[-1].items()
                           if k != "phase"},
                "phases": {r["phase"]: {k: v for k, v in r.items()
                                        if k != "phase"}
                           for r in rows[:-1]},
                "kernels": c.kernels,
                "superstep_budget_mib": budget,
                "superstep_admits": mib <= budget}
    except Exception as exc:   # the census must never sink the bench
        return {"verdict": "SKIP", "reason": repr(exc)[:200]}


def _lint_card() -> dict:
    """The quick lint matrix's verdict (``lint.run``), on the CPU."""
    try:
        from partisan_tpu_torch import lint

        return lint.run(quick=True, device="cpu")
    except Exception as exc:   # lint must never sink the bench
        return {"verdict": "SKIP", "reason": repr(exc)[:200]}


def _history_card(doc: dict, ledger: str | None = None) -> dict:
    """Fold this run into the port's bench-history ledger: one row per
    measured size keyed by (n, config, host fingerprint), deltas against
    the best prior comparable row.  It reports regressions and never
    fails the bench (``tools/torch_bench_history.py --check`` does)."""
    try:
        from partisan_tpu_torch import perfwatch

        ledger = ledger or str(_ROOT / perfwatch.LEDGER_DEFAULT)
        source = time.strftime("bench_%Y%m%d_%H%M%S")
        rows = perfwatch.doc_rows(doc, source)
        prior = perfwatch.read_ledger(ledger)
        fresh = perfwatch.append_rows(ledger, rows)
        deltas = perfwatch.ledger_deltas(fresh, prior)
        return {"ledger": Path(ledger).name, "rows": len(fresh),
                "deltas": deltas,
                "regressions": sum(1 for d in deltas if d.get("regression"))}
    except Exception as exc:   # bookkeeping must never sink the bench
        return {"verdict": "SKIP", "reason": repr(exc)[:200]}


def main(device=None) -> None:
    """bench.py's ladder: the headline size first with the full per-size
    cap, then its cold run, and 32,768 with what remains; 4,096 is the
    fallback."""
    t_start = time.time()
    results: dict[int, dict] = {}

    def remaining() -> float:
        return TIME_BUDGET_S - (time.time() - t_start) - 10

    for n in (100_000, 32_768):
        if 100_000 in results and remaining() < 220:
            break
        if results and remaining() < 90:
            break
        runs: list[dict] = []
        for attempt in range(1, WARM_RUNS + 1):
            if runs and remaining() < 90:
                break
            if not runs and remaining() < (60 if results else 120):
                break
            got = _run_one_subprocess(
                n, timeout_s=max(60.0, min(PER_SIZE_CAP_S, remaining())),
                device=device)
            if got is not None:
                runs.append(got)
            else:
                print(f"n={n} warm run {attempt} produced no result",
                      file=sys.stderr)
        if not runs:
            continue
        mid = sorted(x["phases"]["total"] for x in runs)[len(runs) // 2]
        results[n] = {"n": n, "warm": _aggregate_warm(runs),
                      "rep": min(runs, key=lambda r: abs(
                          r["phases"]["total"] - mid))}
    if results:
        top_n = max(results)
        if remaining() > 240:
            with tempfile.TemporaryDirectory(prefix="ptt_cold_") as cold_dir:
                cold = _run_one_subprocess(
                    top_n, timeout_s=max(60.0, remaining()),
                    cache_dir=cold_dir, device=device)
            results[top_n]["cold"] = _cold_section(
                cold, results[top_n]["warm"])
        else:
            results[top_n]["cold"] = _cold_section(None, None,
                                                   skipped="budget")
    if not results:
        got = _run_one_subprocess(
            4_096, timeout_s=max(60.0, min(120.0, remaining())),
            device=device)
        if got is not None:
            results[4_096] = {"n": 4_096, "warm": _aggregate_warm([got]),
                              "rep": got}
    if not results:
        raise SystemExit("bench failed at every size")
    top = results[max(results)]
    warm = top["warm"]
    doc = {
        "kernels": _kernels_card(top["n"], device),
        "metric": (f"simulated gossip rounds/sec "
                   f"({top['n']}-node hyparview+plumtree)"),
        "value": warm["rounds_per_sec"]["median"],
        "unit": "rounds/sec",
        # a live cluster advances one round (round_ms = 1 s) a second
        "vs_baseline": warm["rounds_per_sec"]["median"],
        "convergence_rounds": top["rep"]["convergence_rounds"],
        "convergence_wall_s": warm["convergence_wall_s"]["median"],
        "all_sizes": {
            str(k): {"warm": v["warm"],
                     **({"cold": v["cold"]} if "cold" in v else {})}
            for k, v in results.items()},
        "validation": ("leaf-for-leaf parity with the JAX package on the "
                       "CPU (tests/test_torch_bench.py)"),
        "cost": _cost_card(top["n"], device),
        "lint": _lint_card(),
    }
    doc["bench_history"] = _history_card(doc)
    print(json.dumps(doc))


def fleet(sizes, device=None) -> int:
    """``--fleet [W [n]]``: ``scenarios.fleet_sweep``'s card, W members
    of n nodes in one batched round (defaults 8 and 256); 0 when every
    member converged, else 1."""
    from partisan_tpu_torch import scenarios

    width = sizes[0] if sizes else 8
    n = sizes[1] if len(sizes) > 1 else 256
    card = scenarios.fleet_sweep(width=width, n=n, device=device)
    print(json.dumps(card))
    return 0 if card["converged"] == card["width"] else 1


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m partisan_tpu_torch.bench",
        description="bench.py's scenario on the port")
    ap.add_argument("--one", type=int, metavar="N",
                    help="run one size and print its dict")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--build-dir", default=None,
                    help="kernel build directory (a fresh one = cold)")
    ap.add_argument("--superstep", type=int, default=1)
    ap.add_argument("--extras", default=None, metavar="PATH",
                    help="with --one: write the state's hashes, the "
                    "launches and (on the card) a profiled window there")
    for flag in ("metrics", "latency", "health", "provenance"):
        ap.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--fleet", type=int, nargs="*", metavar="W_N",
                    default=None,
                    help="the fleet sweep's distribution card: W members "
                    "(default 8) of n nodes (default 256); exit 1 unless "
                    "every member converged")
    ap.add_argument("--dry-1m", action="store_true",
                    help="not ported (the sharded census, ROADMAP §A)")
    return ap.parse_known_args(argv)[0]


if __name__ == "__main__":
    args = _parse(sys.argv[1:])
    if args.dry_1m:
        raise NotImplementedError(
            "--dry-1m is not ported: it needs the census of a sharded "
            "round (lint/cost.device_memory_census over ShardedCluster, "
            "ROADMAP §A)")
    if args.fleet is not None:
        sys.exit(fleet(args.fleet, device=args.device))
    if args.build_dir is not None:
        kernels.BUILD_DIR = Path(args.build_dir)
    if args.one is not None:
        kernels.reset_launches()
        r = run(args.one, verbose=True, metrics=args.metrics,
                latency=args.latency, health=args.health,
                provenance=args.provenance, superstep=args.superstep,
                device=args.device, handles=args.extras is not None)
        if args.extras is not None:
            Path(args.extras).write_text(json.dumps(one_extras(r)))
            for key in ("cluster", "model", "boot_state", "state",
                        "start_round"):
                r.pop(key)
        print(json.dumps({"size_phases": {str(r["n"]): r["phases"]}}),
              file=sys.stderr)
        print(json.dumps(r))
    else:
        main(args.device)
