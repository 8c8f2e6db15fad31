"""Drive the PyTorch port (partisan_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

0. the sidecars: the CPU side of every card == CPU phase (4, 7, 9,
   11, 14-18, 22, 26, 29, 33, 35, 36, 39) runs in a second process
   (``chip_smoke.py --cpu-halves``), started first and pinned to the CPU
   with CPU_THREADS threads, which saves each result under
   build/chip_smoke_cpu/ as it is done; phases 21, 23 and 36's card
   half, and 41b and 41c, run on the card in a third process
   (``chip_smoke.py --card-worker``,
   results under
   build/chip_smoke_card/), started after phase 6's kernel timings, beside
   phases 7-20 (their rounds are host-bound and the card idle most of the
   time, so their walls are measured beside those phases).  Each phase
   reads its result there (waiting for it); a failure of either process
   fails the script.  Only the main process profiles, and phase 31's
   process after the main process's last window: a process loses device
   records in most torch.profiler windows after another process has
   started one on the card.  perfwatch.profile_window measures a window
   that lost a hand-written kernel's record, or all its device time,
   again and raises after three such windows in a row; the windows
   measured again and the records lost from kept windows are logged
   before the kernels line;

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
   CUDA events (ms), its own device time per call from a CUDA event pair
   around each call, queued while a spin kernel holds the stream
   (device_ms), the host's wall per call of back-to-back calls
   with no synchronize (host_ms), the plain version's time, the time of
   one library call computing the same function (torch.stack on the
   mixed-dtype planes) and the least time the card could take;
4. GPU vs CPU parity at n=512: bootstrap ladder, broadcast, convergence
   and record(5) on the card and on the CPU — every state leaf and both
   trace leaves bit-identical (the CPU path is what the tests hold
   against the JAX reference);
5. the main path at n=32768 (bench.py's configuration, every plane
   off) through the bench entry's ``run(32768)`` in this process: init,
   the width-operand ladder [8192, 32768], one broadcast from node 0
   slot 0 stepped to coverage 1.0 (the converged round, counts and final
   state equal to the JAX package's, JAX_BENCH_MAIN), steady rounds/s,
   then record(10).  Kernel launch counts are reset just before and read
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
   at n=10000 (rounds=60: 60 churn rounds, not the reference's 120, cut
   for the script's time limit; its band reads the views before the
   churn) and hyparview_views at n=1000, each config's
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
   concurrencies x 3 latencies) at 10 round trips per sender (run_all's
   floor is 50; cut to 20 because the whole script ran past 1100 s at 50
   on a slow host, then to 10 for phases 30-33): every cell's echoes
   equal concurrency x 10; its rows, its seconds, and a profiled window of one cell's rounds.  Kernel counts
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
   horizon 40, max_faults 1, max_executions 30, the test's 60 cut for the
   script's time limit) on the card and on the CPU: the Result identical
   and equal to the JAX package's (JAX_FILIBUSTER_PAXOS: PASSED, 30
   executions, 0 pruned, 95 candidates) and every record call's [40, 5,
   7, 13] trace identical, the card's written by the interleave kernel and the CPU's by its
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
   (partisan_tpu_torch.bench.run): it must converge on phase 5's round at
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
   all_win true; each arm's wall and ms per round.  Kernel counts are
   reset just before phases 18-21 and read just after each;
22. traffic, watchdog and soak parity, small, on the card and on the
   CPU: scenarios.traffic_scenario("paxos", n=24, rounds=80) and
   ("p2p_chat", n=32, rounds=80), every field but wall_s and every state
   leaf identical; tests/test_watchdog.py's trip setup (N=16 full mesh,
   metrics, a 16-round flight ring, the watchdog in trip mode, a ledger
   breach injected 20 rounds after the boot, 45 rounds) with an
   anti-entropy model so that the ring records wire traffic, every leaf
   after every round, the ring holding rounds inject-15 ... inject and
   the interleave launched once a round up to the breach and never
   after; a storm soak of a 32-node cluster with every plane at
   chunk_fixed 7 and K_PROG, each equal to soak.reference_run; host
   reads per round with the traffic plane and the watchdog on (rate 0,
   no breach) against off: equal;
23. scenarios.traffic_slo(1.0) on the card with the ops journal on
   (scenarios.OPS): every scenario dict, both arms, its ops counts and
   verdict included, equal to the JAX package's (JAX_TRAFFIC_SLO), pass
   true; per run its wall and ms per round;
24. config 7 at the reference's width (n=10,000, 400 rounds: two
   periods of the storm every 200 rounds; cut from the default 2000 to
   1000 to make room for phases 26-28, to 600 for phases 30-33, then
   to 400 for phase 41) on
   the card with the ops journal on: no
   breach, no retry, and the rounds, health, components, the ops counts
   and verdict, Stats, digest and every leaf (by hash) equal to the JAX
   package's (JAX_CONFIG7); chunks, programs, rounds/s,
   storm and calm chunks' ms per round, a profiled storm round, the peak
   memory;
25. the black box at n=10,000: config 7's Config with the metrics plane,
   a 16-round flight ring and the watchdog in trip mode (health off), a
   breach injected 100 rounds after the boot, through Soak for one storm
   period: the breach logged at the inject round, the interleave
   launched once a round up to it and never after, the dumped flight
   trace holding rounds inject-15 ... inject; the interleave kernel
   against its plain version, bit for bit, at the ring's per-round shape
   [10000, E'] x 16 words (E' read off Cluster.flight_shape) with its
   times, the plain version's, torch.stack's and the bound; ms per round
   with the ring and the watchdog against neither, the ring's bytes, the
   kernel's device time per launch.  Kernel counts are reset just before
   phases 22-25 and read just after each;
26. elastic and ingress parity, small: config 9 at n=256 on the card,
   every field but wall_s and chunks and every leaf (by hash) equal to
   the JAX package's (JAX_CONFIG9_SMALL); tests/test_elastic.py's
   redirect setup (n=32, ScaleIn(8, drain=200), record(12)) on the card
   and on the CPU, trace and leaves identical, the interleave launched
   12 times, no traffic record from or to a draining row; the
   delivery-equivalence setup of tests/test_ingress.py (n=24, in-round
   arrivals against a recorded trace through the ring) on both, Stats and
   the per-channel series identical across devices and modes; a
   record(6) of the ingress-armed cluster with requests due inside it
   (the interleave at the wider E), identical on both, and the kernel
   against its plain version at that shape; a checkpoint taken mid-drain
   on the card and restored, the deactivation firing at the same round
   and the final leaves equal to the uninterrupted run's;
27. config 9 at its default n=8192 on the card (what --elastic --ops
   runs) with a telemetry spool armed: every field but wall_s and chunks,
   the ops counts and verdict, every leaf (by hash), the chunk lengths
   and the spool's sha256 equal to the JAX package's (JAX_CONFIG9: widths
   [4096, 8192, 2048], overlay_ok and pass false as there); the spool's
   host seconds per boundary and in all; the wall split into boot and
   soak, ms per round
   of the scale-out, crash, drain and calm chunks, a K_PROG-round window
   under torch.profiler before the scale-out and one inside the drain,
   each beside the same state on a cluster without the elastic carry
   (the elastic stage adds no host read), the peak memory;
28. ingress at full width: the delivery-equivalence setup at config 9's
   width and overlay (n=8192, 60 rounds, chunk_fixed K_PROG, slots 16, no
   quota, no emission compaction), in-round arrivals with SetRate(300) at
   the window's start against trace_arrivals offered to a ring and
   drained by IngressFeed(window=K_PROG): Stats and the metrics plane's
   emitted and delivered series equal, no shed; the request count, the
   host seconds of stage per boundary, ms per round of each mode.  Kernel
   counts are reset just before phases 26-28 and read just after each;
29. the spool and pipelined dispatch: tests/test_spool.py's storm soak
   (n=16) spooled uninterrupted, killed and resumed on the same file, and
   at pipeline depth 2, on the card and on the CPU, all six spool files
   byte for byte equal and the final states identical; then config 7's
   Config at n=10,000 with a 4-round flight ring for half a storm period
   (100 rounds, chunk_fixed K_PROG, checkpoints every 100; 200 until PR
   11, cut for the script's time limit) at depth 1 and depth 2, each
   with a spool: final states identical leaf for leaf, spools byte for
   byte, both equal to the JAX package's (JAX_PHASE29);
   per depth the pipelined rows' busy_s against wall_s and
   decompose_chunks' gap_share and spool_s.  Kernel counts are reset
   just before its full-width boot and read just after;
30. the legacy ladder (run right after phase 5): bench's Config without
   the width operand at n=32768, one Cluster per rung [8192, 32768] and
   the state re-embedded between them, prefix-equal on every leaf to
   phase 5's width-operand boot state; counts reset just before and read
   just after;
31. (run after phase 33) the bench entry at n=100,000: ``python -m
   partisan_tpu_torch.bench
   --one 100000`` in its own process, as a user runs it: one JSON line
   with bench.py's ``--one`` keys, coverage 1.0, the converged round,
   counts and final state's leaf hashes equal to the JAX package's
   (JAX_BENCH); its rounds/s, convergence, boot and process walls, peak
   memory, the process's kernel launches and a profiled K_PROG-round
   window (launches, host reads and copies per round, idle share), and
   its phase table: a K_PROG-round capture from the final state
   attributed to the round.* phases and reconciled with a census of one
   round (bench.phase_table), its keys the census's and its device time
   the capture window's within 2%;
32. X-BOT with the distance plane at n=10,000: bench's Config with
   X-BOT and the measured-RTT oracle, booted by the width ladder, then
   100 rounds (10 X-BOT cycles; cut from 200 for phase 41), and the same
   with X-BOT off: the X-BOT
   run's final state and mean modeled link latency equal the JAX
   package's (JAX_XBOT), its latency below the off run's, one component;
   per arm the walls and a profiled K_PROG window;
33. X-BOT and distance parity, small: tests/test_xbot.py's overlay (N=24,
   seed 6) recorded for 40 rounds and tests/test_distance.py's n=8 mesh
   with a DistanceService recorded for 16, card against CPU: states and
   traces bit for bit, the card's traces through the interleave kernel
   (56 launches), the handshake's kinds and PING/PONG in them;
34. (run after phase 33) the OTP layer at full width: bench's Config at
   n=10,000 with inbox_cap 48 and the stack Stack([RpcService (the three
   functions of tests/test_otp.py), MonitorService, GenServerService,
   StatemService (tests/test_statem_sim.py's table)]) in place of
   Plumtree, booted by the width ladder; 100 owners monitor drawn targets
   (process, edge and node monitors; half the targets among the nodes
   that crash), then four waves K_PROG rounds apart of 1,000 drawn
   callers, each with one gen_server FN_INCR call, one RPC call and one
   statem call to drawn destinations with an 8-round timeout, 100 nodes
   crashed before wave 3, 60 rounds in all: each service's final call
   statuses, the counters' digest, the monitor events' counts and every
   leaf (by hash) equal to the JAX package's (JAX_OTP), DOWN, badrpc
   timeouts and nodedown all fired; the walls (boot, each wave's calls,
   each chunk), ms per round, a profiled K_PROG window from the final
   state, the peak memory;
35. the same storm at n=64 on the card and on the CPU, its first two
   chunks through otp.sys.trace and otp.sys.statistics: the rendered
   trace's and the statistics' digests, the captured wires (written by
   the interleave kernel on the card, 20 launches) and every leaf
   identical, and equal to the JAX package's (JAX_OTP_SMALL);
36. the Erlang bridge on the card (in the card worker): ``python -m
   partisan_tpu_torch.bridge.server`` on the card as the open_port
   subprocess, fed tests/test_bridge_conformance.py's session, its
   replies equal to the JAX server's (JAX_BRIDGE); the 16-node trace
   (bridge.trace16) over the socket server on the card, its rows and
   convergence rounds equal to the CPU's, and to
   tools/traces/trace16.json's when this host's numpy is the capture's;
37. (run after phase 36) the fleet sweep at full width:
   scenarios.fleet_sweep with W=64 members of n=1024 (65,536 node rows;
   HyParView + Plumtree with the health, provenance and latency planes,
   salts 0..63, one batched round) on the card: its distribution card
   (converged, rounds to converge, redundancy, per-channel p99, the
   members lists) and final state (every leaf by hash) equal to the JAX
   package's (JAX_FLEET), every member converged; member 5 re-run
   unbatched at seed + 5 equal to its slice leaf for leaf; ms per fleet
   round, a profiled K_PROG window (launches per round, device time, idle
   share), the peak memory and the sweep's wall; the same at W=8 (the
   reference's default width), its sweep cut to 100 rounds after the
   broadcast (the default 300 ran 170);
38. the batched schedule search of tests/test_fleet.py (W=64, n=16,
   horizon 10, settle 30, AAE off; the golden trace from the unbatched
   twin's Cluster.record through the interleave kernel, 10 launches): the
   population, verdicts, oracle values, counterexample (member 63, the
   seed, coverage 1/16) and booted and final fleet states equal to the
   JAX package's (JAX_FLEET_SEARCH), the counterexample replayed
   unbatched leaf for leaf, 2 round programs;
39. the fleet's member storms (W=4, n=24, dense partitions, traffic:
   member 1 a crash + partition storm, member 2 a flash crowd) through
   Soak at chunk_fixed 6 on the card and on the CPU: every leaf
   identical and equal to the JAX package's (JAX_FLEET_PARITY); then
   fleet.tune at n=64, 3 waves on the card: the winner and every member's
   scores equal to the JAX package's.  Kernel counts are reset just
   before phases 37-39 and read just after each;
40. (run after phase 19, in this process) the round-cost census and the
   superstep cap lift: the census of one bench round (lint/cost.py, both
   branches of every quiet gate) on phase 5's state at n=32,768 and the
   engine's guard on an init state at n=100,000, their verdicts against
   SUPERSTEP_INTERM_BUDGET_MIB equal to the JAX guard's (JAX_SUPERSTEP:
   admit, refuse); the census's [n, ., .] bytes at least one round's
   measured rise in max_memory_allocated; its host reads a round equal
   to a K_PROG window's (each scalar read is itself one DtoH copy, so
   host_reads + (copies_dtoh - host_reads)); the phase table of 10 rounds
   (bench.phase_table: capture, attribute, reconcile), its keys a subset
   of the census's, its device ms within 2% of the capture window's, its
   launches the capture's and, a round, those of the window above
   (records lost or handed over late by the profiler aside; the window
   and the table measured again, up to three pairs, while they disagree
   there, every pair logged);
   then bench's Config at n=32,768 through Soak at superstep 8,
   chunk_cap 30 and chunk_fixed 240 in ONE execution (the cap lifted),
   equal leaf for leaf to the superstep-1 run's 8 chunks.  Phases 32, 34
   and 37 also split their profiled windows per round.* phase
   (perfwatch.phase_window: X-BOT on and off, the OTP storm, the W=64
   fleet round);
41. the sharded cluster (parallel/sharded.py) on SHARDS=4 shard threads
   over the one card: (a, after phase 40, in this process) bench's round
   at n=32,768 from phase 5's converged state, 20 rounds with the
   all-gather exchange and 20 with the all-to-all exchange, each equal
   leaf for leaf to the card's Cluster on the same state (the
   all-to-all's quota must shed nothing), record(10) equal in state and
   trace, its 40 interleave launches held against the plain version on
   the same planes (a second record with the plain version in the
   kernel's place), then ms, launches, host reads (device->host copies),
   device ms and collective bytes per round of Cluster, a 1-shard mesh
   and the 4-shard mesh; (b, in the card worker, after 41a) the health
   plane at n=4,096 (tests/test_sharded_health.py's digest case scaled):
   4 shards, 1 shard and Cluster give equal digests, rings and states;
   (c, in the card worker, after 41b) ``python -m partisan_tpu_torch.bench --one
   100000`` with PARTISAN_SHARDS=4 takes the sharded arm and its
   converged round, counts, coverage and state equal JAX_BENCH, phase
   31's oracle, and phase 31's converged round;

the kernels line, then (main) the card line, and last the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from partisan_tpu_torch import perfwatch
from partisan_tpu_torch.bench import state_hashes
from partisan_tpu_torch.perfwatch import round_profile

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
N_MAIN = 32768
N_PARITY = 512
FB_N = 6                    # tests/test_filibuster.py's checker setups
FB_HORIZON = 12
FULL_HORIZON = 24           # the full-width Filibuster phase
FULL_SCHED_WIDTH = 80       # >= the bench path's 77-slot emission width
FULL_MAX_EXECUTIONS = 4
N_CONFIG5 = 100_000         # the reference's DEFAULT_SIZES[5]
ECHO_MESSAGES = 10          # config 6's round trips a sender (run_all's
#                             floor is 50: cut to 20, then to 10, for the
#                             script's time limit)
PAXOS_FB_HORIZON = 40       # tests/test_paxos.py's Filibuster checker
PAXOS_FB_SENT = (5, 7)      # its record's [n, emitted slots] per round
PAXOS_FB_EXECUTIONS = 30    # its execution cap (the test's 60; cut for
#                             the script's time limit)
N_APP = 48                  # the traffic suite's app-model size
APP_ROUNDS = 240
FLIGHT_K = 4                # flight_rounds of phases 18 and 20
FLIGHT_ROUNDS = 20          # phase 20's rounds after the broadcast
PLANES = dict(metrics=True, latency=True, provenance=True)
WD_N, WD_BOOT, WD_ROUNDS = 16, 15, 45   # tests/test_watchdog.py's trip
BLACKBOX_RING = 16          # phase 25's flight rounds
TRAFFIC_SMALL = (("paxos", 24), ("p2p_chat", 32))   # phase 22's runs
CPU_DIR = "build/chip_smoke_cpu"   # the CPU halves' results (phase 0)
CARD_DIR = "build/chip_smoke_card"  # the card worker's (phases 21, 23)
CPU_THREADS = 3             # torch threads of the CPU-halves process
XBOT_SMALL_RECORD = 40      # phase 33's record rounds of the X-BOT overlay
DIST_SMALL_RECORD = 16      # ... and of the n=8 distance mesh
BENCH_ONE_KEYS = {"n", "rounds_per_sec", "converged_round",
                  "convergence_rounds", "convergence_wall_s", "steady_k",
                  "dropped", "emitted", "phases"}

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


# the JAX package's values on the CPU (jax 0.9.0), printed by
# tools/jax_reference_values.py: scenarios.traffic_slo(1.0) with every
# wall_s stripped (phase 23); scenarios.config7_soak at n=10,000 for 400
# rounds (``config7 --rounds 400 --ops``; phase 24) and config9_elastic at
# n=256 and its default n=8192 (``config9 --n 256``, ``config9``; phases
# 26 and 27), each without its wall-clock keys and chunk count, with the
# final state's round, Stats, health digest and leaf hashes
JAX_TRAFFIC_SLO = json.loads("""
{"bound": 4, "isolation_scenarios": 3, "pass": true, "scale": 1.0,
"scenarios": {"alsberg_day": {"adaptive": {"adaptive": true, "age_max":
{"broadcast": 0, "bulk": 4, "default": 2, "partisan_membership": 0,
"rpc": 0}, "app": {"acked": true, "replicated": true}, "app_ok": true,
"bound": 4, "breaches": 0, "bulk_p99": 3, "chunks": 24, "control":
{"press": [0, 0, 0, 0, 0]}, "control_ok": true, "crowd_chunks": 6,
"crowd_isolation_chunks": 0, "delivered": {"broadcast": 0, "bulk":
12884, "default": 192, "partisan_membership": 0, "rpc": 0}, "model":
"alsberg_day", "n": 48, "ops": {"closed": 1, "ok": true, "open": 0,
"orphans": 0, "spans": 3, "undetected": 0, "unobservable": 2},
"outbox_shed": 578, "p99": {"broadcast": null, "bulk": 3, "default": 2,
"partisan_membership": null, "rpc": null}, "retries": 0, "rounds": 240,
"slo_windows": 0, "traffic": {"churn_x1e6": 0, "rate_x1000": 600,
"sent": 14557}}, "ok": true}, "causal_chat": {"adaptive": {"adaptive":
true, "age_max": {"broadcast": 0, "bulk": 4, "default": 4,
"partisan_membership": 0, "rpc": 0}, "app": {"bcast_coverage": [1.0,
1.0], "causal_delivered": 504}, "app_ok": true, "bound": 4, "breaches":
0, "broadcast": {"crowd_dup": 0, "crowd_gossip": 6, "crowd_redundancy":
0.0, "duplicates": 0, "gossip_delivered": 12, "redundancy_ratio": 0.0},
"broadcast_ok": true, "bulk_p99": 3, "chunks": 24, "control":
{"eager_cap": 6, "fanout_adjustments": 0, "heal_boost": 0, "press": [0,
0, 0, 0, 0]}, "control_ok": true, "crowd_chunks": 6,
"crowd_isolation_chunks": 0, "delivered": {"broadcast": 18, "bulk":
15628, "default": 8962, "partisan_membership": 0, "rpc": 0}, "model":
"causal_chat", "n": 64, "ops": {"closed": 3, "ok": true, "open": 0,
"orphans": 0, "spans": 3, "undetected": 0, "unobservable": 0},
"outbox_shed": 770, "overlay_ok": true, "p99": {"broadcast": 0, "bulk":
3, "default": 3, "partisan_membership": null, "rpc": null}, "retries":
0, "rounds": 240, "slo_windows": 0, "traffic": {"churn_x1e6": 0,
"rate_x1000": 600, "sent": 20166}}, "isolation": true, "ok": true,
"static": {"adaptive": false, "age_max": {"broadcast": 0, "bulk": 23,
"default": 9, "partisan_membership": 0, "rpc": 0}, "app":
{"bcast_coverage": [1.0, 1.0], "causal_delivered": 504}, "app_ok": true,
"bound": 4, "breaches": 0, "broadcast": {"crowd_dup": 0, "crowd_gossip":
6, "crowd_redundancy": 0.0, "duplicates": 0, "gossip_delivered": 12,
"redundancy_ratio": 0.0}, "broadcast_ok": true, "bulk_p99": 15,
"chunks": 24, "control_ok": false, "crowd_chunks": 6,
"crowd_isolation_chunks": 5, "delivered": {"broadcast": 18, "bulk":
15889, "default": 4315, "partisan_membership": 0, "rpc": 0}, "model":
"causal_chat", "n": 64, "ops": {"closed": 3, "ok": true, "open": 0,
"orphans": 0, "spans": 3, "undetected": 0, "unobservable": 0},
"outbox_shed": 0, "overlay_ok": true, "p99": {"broadcast": 0, "bulk":
15, "default": 7, "partisan_membership": null, "rpc": null}, "retries":
0, "rounds": 240, "slo_windows": 1, "traffic": {"churn_x1e6": 0,
"rate_x1000": 600, "sent": 20166}}, "win": true}, "commit": {"adaptive":
{"adaptive": true, "age_max": {"broadcast": 0, "bulk": 4, "default": 2,
"partisan_membership": 0, "rpc": 0}, "app": {"agreement": true,
"commits": 96}, "app_ok": true, "bound": 4, "breaches": 0, "bulk_p99":
3, "chunks": 24, "control": {"press": [0, 0, 0, 0, 0]}, "control_ok":
true, "crowd_chunks": 6, "crowd_isolation_chunks": 0, "delivered":
{"broadcast": 0, "bulk": 12884, "default": 384, "partisan_membership":
0, "rpc": 0}, "model": "commit", "n": 48, "ops": {"closed": 1, "ok":
true, "open": 0, "orphans": 0, "spans": 3, "undetected": 0,
"unobservable": 2}, "outbox_shed": 578, "p99": {"broadcast": null,
"bulk": 3, "default": 2, "partisan_membership": null, "rpc": null},
"retries": 0, "rounds": 240, "slo_windows": 0, "traffic": {"churn_x1e6":
0, "rate_x1000": 600, "sent": 14557}}, "ok": true}, "p2p_chat":
{"adaptive": {"adaptive": true, "age_max": {"broadcast": 0, "bulk": 4,
"default": 4, "partisan_membership": 0, "rpc": 0}, "app":
{"bcast_coverage": [1.0, 1.0], "causal_delivered": 8, "causal_expected":
8}, "app_ok": true, "bound": 4, "breaches": 0, "broadcast":
{"crowd_dup": 0, "crowd_gossip": 6, "crowd_redundancy": 0.0,
"duplicates": 0, "gossip_delivered": 12, "redundancy_ratio": 0.0},
"broadcast_ok": true, "bulk_p99": 3, "chunks": 24, "control":
{"eager_cap": 6, "fanout_adjustments": 0, "heal_boost": 0, "press": [0,
0, 0, 0, 0]}, "control_ok": true, "crowd_chunks": 6,
"crowd_isolation_chunks": 0, "delivered": {"broadcast": 18, "bulk":
15628, "default": 8996, "partisan_membership": 0, "rpc": 0}, "model":
"p2p_chat", "n": 64, "ops": {"closed": 3, "ok": true, "open": 0,
"orphans": 0, "spans": 3, "undetected": 0, "unobservable": 0},
"outbox_shed": 770, "overlay_ok": true, "p99": {"broadcast": 0, "bulk":
3, "default": 3, "partisan_membership": null, "rpc": null}, "retries":
0, "rounds": 240, "slo_windows": 0, "traffic": {"churn_x1e6": 0,
"rate_x1000": 600, "sent": 20166}}, "isolation": true, "ok": true,
"static": {"adaptive": false, "age_max": {"broadcast": 0, "bulk": 23,
"default": 9, "partisan_membership": 0, "rpc": 0}, "app":
{"bcast_coverage": [1.0, 1.0], "causal_delivered": 8, "causal_expected":
8}, "app_ok": true, "bound": 4, "breaches": 0, "broadcast":
{"crowd_dup": 0, "crowd_gossip": 6, "crowd_redundancy": 0.0,
"duplicates": 0, "gossip_delivered": 12, "redundancy_ratio": 0.0},
"broadcast_ok": true, "bulk_p99": 15, "chunks": 24, "control_ok": false,
"crowd_chunks": 6, "crowd_isolation_chunks": 5, "delivered":
{"broadcast": 18, "bulk": 15889, "default": 4347, "partisan_membership":
0, "rpc": 0}, "model": "p2p_chat", "n": 64, "ops": {"closed": 3, "ok":
true, "open": 0, "orphans": 0, "spans": 3, "undetected": 0,
"unobservable": 0}, "outbox_shed": 0, "overlay_ok": true, "p99":
{"broadcast": 0, "bulk": 15, "default": 7, "partisan_membership": null,
"rpc": null}, "retries": 0, "rounds": 240, "slo_windows": 1, "traffic":
{"churn_x1e6": 0, "rate_x1000": 600, "sent": 20166}}, "win": true},
"paxos": {"adaptive": {"adaptive": true, "age_max": {"broadcast": 0,
"bulk": 4, "default": 2, "partisan_membership": 0, "rpc": 0}, "app":
{"decided_0": 48, "decided_1": 48}, "app_ok": true, "bound": 4,
"breaches": 0, "bulk_p99": 3, "chunks": 24, "control": {"press": [0, 0,
0, 0, 0]}, "control_ok": true, "crowd_chunks": 6,
"crowd_isolation_chunks": 0, "delivered": {"broadcast": 0, "bulk":
12882, "default": 52074, "partisan_membership": 0, "rpc": 0}, "model":
"paxos", "n": 48, "ops": {"closed": 1, "ok": true, "open": 0, "orphans":
0, "spans": 3, "undetected": 0, "unobservable": 2}, "outbox_shed": 580,
"p99": {"broadcast": null, "bulk": 3, "default": 1,
"partisan_membership": null, "rpc": null}, "retries": 0, "rounds": 240,
"slo_windows": 0, "traffic": {"churn_x1e6": 0, "rate_x1000": 600,
"sent": 14557}}, "isolation": true, "ok": true, "static": {"adaptive":
false, "age_max": {"broadcast": 0, "bulk": 32, "default": 2,
"partisan_membership": 0, "rpc": 0}, "app": {"decided_0": 48,
"decided_1": 48}, "app_ok": true, "bound": 4, "breaches": 0, "bulk_p99":
31, "chunks": 24, "control_ok": true, "crowd_chunks": 6,
"crowd_isolation_chunks": 6, "delivered": {"broadcast": 0, "bulk":
13327, "default": 52074, "partisan_membership": 0, "rpc": 0}, "model":
"paxos", "n": 48, "ops": {"closed": 1, "ok": true, "open": 0, "orphans":
0, "spans": 3, "undetected": 0, "unobservable": 2}, "outbox_shed": 0,
"p99": {"broadcast": null, "bulk": 31, "default": 1,
"partisan_membership": null, "rpc": null}, "retries": 0, "rounds": 240,
"slo_windows": 1, "traffic": {"churn_x1e6": 0, "rate_x1000": 600,
"sent": 14557}}, "win": true}}, "wins": 3}
""")

# The JAX package's values on the CPU (jax 0.9.0) for phases 5, 31 and
# 32, printed by tools/jax_reference_values.py: ``bench --n 32768`` and
# ``bench --n 100000`` (bench.run(n) with every plane off: the converged
# round, counts and final state's leaf hashes) and ``xbot --n 10000
# --rounds 100`` (xbot_cfg booted by the width ladder, then 100 rounds).
JAX_BENCH_MAIN = json.loads("""
{"converged_round": 100, "convergence_rounds": 20, "dropped": 3876,
"emitted": 1163000, "leaf_hashes": ["40e736c02a102a05",
"bfa5a24faa8ddf57", "df3f619804a92fdb", "fa43239bcee7b97c",
"17209e5392736a38", "32fe9df0fe96eeec", "7db3709a4d625134",
"07854d2fef297a06", "30e14955ebf13522", "5647f05ec1895894",
"5647f05ec1895894", "07854d2fef297a06", "173b007ad832462a",
"5647f05ec1895894", "5647f05ec1895894", "5647f05ec1895894",
"5647f05ec1895894", "5647f05ec1895894", "5647f05ec1895894",
"5647f05ec1895894", "8b01d8569a2d3d37", "fa43239bcee7b97c",
"ef5ae63084c1a879", "d896d1d8bf7da083", "b5a41c3758763bbe",
"c35020473aed1b46", "c35020473aed1b46", "fa43239bcee7b97c",
"bfa5a24faa8ddf57", "1349e3e88ffab616", "af1ea0bc7518a903",
"ddc5b7127cba68b2", "30e14955ebf13522", "106f0647ae10a651",
"106f0647ae10a651", "8a39d2abd3999ab7", "f5fb04aa5b882706",
"ef5ae63084c1a879", "30e14955ebf13522", "fa43239bcee7b97c",
"9819f3801f89f65a", "e9259e91bef105ca", "9b312151233badea",
"94751be059d25844"], "n": 32768, "rnd": 100, "state_sha":
"1b097e07700d4681"}
""")

JAX_BENCH = json.loads("""
{"converged_round": 120, "convergence_rounds": 20, "dropped": 3963,
"emitted": 3523409, "leaf_hashes": ["66a0b53312c1d72c",
"7afaec9db2d1f347", "df3f619804a92fdb", "946cc2661d32ad83",
"301d7ce622a12000", "4842473aec886421", "33a9e40cec5f2b11",
"58e0a2f7c0e88d03", "98f0d343e21e0f8f", "56e3cc9fbdfedf1a",
"56e3cc9fbdfedf1a", "58e0a2f7c0e88d03", "d74ca1d8f77e56b9",
"56e3cc9fbdfedf1a", "56e3cc9fbdfedf1a", "56e3cc9fbdfedf1a",
"56e3cc9fbdfedf1a", "56e3cc9fbdfedf1a", "56e3cc9fbdfedf1a",
"56e3cc9fbdfedf1a", "57edf6c2564a02ce", "946cc2661d32ad83",
"4e6503755117a8fc", "eff28e3d6954aaf9", "676e1db9007d4de2",
"9192c25b734fcbad", "9192c25b734fcbad", "946cc2661d32ad83",
"7afaec9db2d1f347", "12a0d5097e03f007", "ad11c61a5f92d8dc",
"eeadd6911edcc46c", "98f0d343e21e0f8f", "58db5d87ffe2173b",
"58db5d87ffe2173b", "8568d6b117678d53", "d637e226141bebf8",
"4e6503755117a8fc", "98f0d343e21e0f8f", "946cc2661d32ad83",
"9bd447018b0d65ca", "685326d2921b9079", "8167ed2b38929175",
"1fce70c028536c62"], "n": 100000, "rnd": 120, "state_sha":
"868027a8cbec7a4a"}
""")

JAX_XBOT = json.loads("""
{"boot_mean_latency": 1.6351231088697715, "leaf_hashes":
["eed72f47b9a4ba7d", "684ad25fdc2bbb80", "df3f619804a92fdb",
"e7e2dcff542de953", "5634e4c31b8bff3d", "4953af19a5880714",
"5c8abfebbd783bf9", "b9ce164d30e4101b", "ac2878215ad33205",
"3d00ed86b663cd1b", "3d00ed86b663cd1b", "b9ce164d30e4101b",
"4129549f25a0c42f", "3d00ed86b663cd1b", "3d00ed86b663cd1b",
"3d00ed86b663cd1b", "3d00ed86b663cd1b", "3d00ed86b663cd1b",
"3d00ed86b663cd1b", "3d00ed86b663cd1b", "abc00e952dde867d",
"e7e2dcff542de953", "8db73fe0aabaa84c", "5cecb256599248db",
"e2ce7238a89a97ff", "95b532cc4381affd", "95b532cc4381affd",
"e7e2dcff542de953", "684ad25fdc2bbb80", "9363b41212643713",
"17b7b043899b974f", "059101525f00237d", "1e822373abababc7",
"5fc0abda6ed5dade", "8a1fe00a387bf36e", "f9d2997e2db57bfc",
"ac2878215ad33205", "ac2878215ad33205", "baf1862a3e57a773",
"baf1862a3e57a773", "f8c784aa6b57396e", "49458293c99a760a",
"8db73fe0aabaa84c", "ac2878215ad33205", "e7e2dcff542de953",
"0f3b303c499d5bcf", "e8efd4f793807555", "abffc59a3479ef39",
"85884be0c0b39bef"], "mean_latency": 0.9600008183975776, "n": 10000,
"rnd": 170, "rounds": 100, "state_sha": "325ff1da5b529867"}
""")

# ``filibuster_paxos --max-executions 30`` (phase 16)
JAX_FILIBUSTER_PAXOS = {
    "candidates": 95, "executions": 30, "passed": True, "pruned": 0,
    "render": "filibuster: PASSED — 30 executions, 0 pruned, 95 candidates"}

JAX_CONFIG7 = json.loads("""
{"breaches": 0, "components": 1, "digest": 275, "healthy": false,
"leaf_hashes": ["518e535b44efdc5d", "684ad25fdc2bbb80",
"df3f619804a92fdb", "e7e2dcff542de953", "a8e0e114083dc4ee",
"cacb4251caa08ddb", "73f9ed3cb9dcdcbc", "ac2878215ad33205",
"4cb24a42e997499e", "ac8ced7a23a8f82a", "ac8ced7a23a8f82a",
"ac2878215ad33205", "cad464199b81a6d8", "7112bbac1b339c31",
"49734bf790ddb0f9", "76a3ae4b4f3fb18c", "39e1399cf161fe2e",
"a6248d57ced5a185", "a0be91e363d25d1a", "0972c54ebbc02bb0",
"a32de7c270a19472", "e7e2dcff542de953", "6cc570e4d919c696",
"f7a2381d418241a7", "e2ce7238a89a97ff", "95b532cc4381affd",
"95b532cc4381affd", "e7e2dcff542de953", "684ad25fdc2bbb80",
"d3bc46f98f63d576", "fdce58b42dd70f0c", "02fadde899612bcd",
"02fadde899612bcd", "81beb57ba94e8afb", "81beb57ba94e8afb",
"3d00ed86b663cd1b", "47d23dadd0f8a03d", "6cc570e4d919c696",
"02fadde899612bcd", "e7e2dcff542de953", "0fc00330e368c08a",
"41bbb76f458fbfe0", "b2c8cc22b1566e48", "3fcc74c2176f6048",
"d5c04a8659567599", "b46872df1e695c8a", "1e06ee90f20c51c6",
"61c5f3282c09ee87", "03b57b5262fc4c2e", "d9990a03e7e286fb",
"4f4bb99fda7a31f5", "3b26ba2f133bfa5c", "75e00fe1c5eda23d",
"e6fece7bd98f5b61", "c60449ee74850741", "2b13698ef3c0d844",
"684ad25fdc2bbb80", "684ad25fdc2bbb80"], "n": 10000, "ops": {"closed":
6, "ok": true, "open": 0, "orphans": 0, "spans": 7, "undetected": 0,
"unobservable": 1}, "retries": 0, "rnd": 500, "rounds": 400,
"state_sha": "67d0cdf774cf4142", "stats": {"delivered": 1057656,
"dropped": 69148, "emitted": 1126804}, "storm_period": 200}
""")

JAX_CONFIG9_SMALL = json.loads("""
{"breaches": 0, "components": 1, "config": 9, "digest": 279,
"leaf_hashes": ["45e29d14686bc2b9", "2661920f2409dd6c",
"df3f619804a92fdb", "5f70bf18a0860070", "043fb021f5dca215",
"862ffc500988959e", "6e286c4639f9e8a1", "380f9b20e0cc9c6d",
"d49dca92a67a734a", "c35020473aed1b46", "c35020473aed1b46",
"9f1dcbc35c350d60", "921514755d9074c6", "adbad1e648c6145a",
"de081fd33615cfef", "1c6434af01bedd22", "9bf1766a536abd21",
"759f01f4140ad858", "4471641968c81c36", "c7227fe83e71846f",
"a0ef45ed6a1d7ed0", "acc76c7e0055e75f", "5f70bf18a0860070",
"2a5b20938bfd7390", "b925f9f4fc177b37", "5f4ecdb7b71c3e40",
"aadd0d330b329cac", "5cdc501772fd502b", "5f70bf18a0860070",
"2661920f2409dd6c", "22c267ae02700d84", "8ae1c6bef87ddf62",
"de2f256064a0af79", "de2f256064a0af79", "3a3ed164e42500a1",
"3a3ed164e42500a1", "4fe7b59af6de3b66", "71189f7fb6aed638",
"2a5b20938bfd7390", "de2f256064a0af79", "5f70bf18a0860070",
"b8ad3588979559ef", "f687f3cbdfc0f230", "1cf26833657471fa",
"e5f315e017d8e1ea", "ae0221f5d6532333", "7f890a3503531d59",
"e5a00aa9991ac8a5", "e5a00aa9991ac8a5", "f4ce05ca4706eee0",
"eaac06aa508f1ff0", "ddba8875624ca806", "a6f5ca27e6284e5f",
"838b7044fba7f83e", "f8548f36e5988b93", "49ad84d8da9f487d",
"e5a00aa9991ac8a5", "825304d73477d498", "4daca3ce66c661a0",
"374708fff7719dd5", "c31425b44a7ed682", "527d268c89f54c1b",
"2654be18bf108a3f", "0f86bea887b74d86", "95ced6d93bec2083",
"eab9f4ac1e07804c", "0ab9cf7b7becf048", "a091f6187eb846e6",
"60cb0a462cfeab0a", "666e19e4f5e7e216", "0c61e7425b20ac49",
"7bbd6130bdaaa331", "92c8140bb7fde2ae", "df45056ea2b22d55",
"b8a63a62f6097f15", "b8a63a62f6097f15", "f2dadabeae2223ad",
"df3f619804a92fdb", "bfde18473d8550ff", "9c8f6e05490a8653",
"dda69a2c007d46d3", "ad95131bc0b799c0", "eed72f47b9a4ba7d",
"c31425b44a7ed682", "05e13fa7549bb274", "4281535ed5ff218f",
"0e390915cb5e0986", "9d9f290527a6be62"], "n": 256, "n_active": 64,
"overlay_ok": true, "p99": {"broadcast": 0, "default": 0,
"partisan_membership": null, "rpc": null}, "pass": true, "resizes": 3,
"retries": 0, "rnd": 230, "rounds": 170, "slo_bound": 8, "state_sha":
"cf2aadd91e4a1985", "stats": {"delivered": 40058, "dropped": 177,
"emitted": 40235}, "traffic": {"churn_x1e6": 0, "rate_x1000": 300,
"sent": 25989}, "widths": [128, 256, 64]}
""")

JAX_CONFIG9 = json.loads("""
{"breaches": 0, "chunk_k": [10, 10, 20, 30, 10, 20, 20, 50],
"components": 1, "config": 9, "digest": 275, "leaf_hashes":
["e6bfd42cb3ef4c11", "6ba042a6672c6427", "df3f619804a92fdb",
"c35020473aed1b46", "249fd022e6c12ead", "429b11147d3b414f",
"a2fb9205d6979712", "01fb7b6063be308d", "4239eb0ef29aafc1",
"30e14955ebf13522", "30e14955ebf13522", "8a39d2abd3999ab7",
"74672aa901d2f35b", "b5894a4dd7ac72e0", "a0da310e1c83135c",
"f88f7d0887b053ff", "0798a9cefd1acf19", "3f88229ccbd5de3e",
"e6b64cf8fdd7a454", "2b2a067a29267783", "d4971bc4d6d8e09c",
"26b57fd15c68bdca", "c35020473aed1b46", "f288a0167d75a946",
"93942b626b6e6a73", "2d864c0b789a4321", "80616131420727c7",
"56de405d65e7dad8", "c35020473aed1b46", "6ba042a6672c6427",
"a91da0bec7aee96d", "bef7f6489f0c2d5b", "5647f05ec1895894",
"5647f05ec1895894", "bbd05cf6097ac9b1", "bbd05cf6097ac9b1",
"07854d2fef297a06", "4bda3a28f4ffe603", "f288a0167d75a946",
"5647f05ec1895894", "c35020473aed1b46", "9c5d1b99d5221827",
"d41a5ce9459083d6", "f35dc2e144507648", "16a80f7bdacce90f",
"ddc2b00bba184c80", "fff53914e7749f31", "e5a00aa9991ac8a5",
"e5a00aa9991ac8a5", "43c0ca3a45a5a673", "68f4baad5d4a3faf",
"12da07fbdd334070", "c1a4182229c00833", "4391037ed3f31124",
"3d16b96016d659fc", "26aa072f05757831", "e5a00aa9991ac8a5",
"486a277eae30d788", "fd4f55419450a7a2", "374708fff7719dd5",
"cbfd218787df784c", "f32effe37fabfe66", "07c4d47ebc463514",
"3da2914500aea876", "b913b8507ab016ad", "62d829641d5680cc",
"73c374da39c92e30", "af595bbe3b920b00", "c1a763aa522699b9",
"d47b4aed80f5fa9f", "56f52d93e0f7c665", "e640a7c65363768b",
"c44949f89806baa5", "2b13698ef3c0d844", "11de957a836f51f3",
"11de957a836f51f3", "f2dadabeae2223ad", "df3f619804a92fdb",
"690579505c3e12f1", "b37ac88ff9ce01af", "84410e39be496605",
"ad95131bc0b799c0", "5cdec5d34b5e22aa", "cbfd218787df784c",
"5bf9bec6b624f375", "f55c801946fa84b7", "55914cfb36f71e41",
"9d9f290527a6be62"], "n": 8192, "n_active": 2048, "ops": {"closed": 4,
"ok": true, "open": 0, "orphans": 0, "spans": 4, "undetected": 0,
"unobservable": 0}, "overlay_ok": false, "p99": {"broadcast": 0,
"default": 0, "partisan_membership": null, "rpc": null}, "pass": false,
"resizes": 3, "retries": 0, "rnd": 240, "rounds": 170, "slo_bound": 8,
"spool_lines": 500, "spool_sha":
"676b57c445f599915290b760a4e7af6875da07793ba47cf99dbd8a95a9fba160",
"state_sha": "6979553347bd793d", "stats": {"delivered": 1300793,
"dropped": 16191, "emitted": 1316984}, "traffic": {"churn_x1e6": 0,
"rate_x1000": 300, "sent": 844490}, "widths": [4096, 8192, 2048]}
""")

# ``phase29 --rounds 100`` (phase 29)
JAX_PHASE29 = json.loads("""
{"breaches": 0, "chunks": 10, "flight_rounds": 4, "leaf_hashes":
["a77802d8305178be", "756085cd34348d5d", "df3f619804a92fdb",
"e7e2dcff542de953", "a11108970bf84f67", "214c4f3a9b1e53df",
"aceb10981675c3fe", "ac2878215ad33205", "ca080eb2d6618998",
"ac8ced7a23a8f82a", "ac8ced7a23a8f82a", "ac2878215ad33205",
"214c4f3a9b1e53df", "49fc8d6cc106262f", "f21ac584a4dfdc49",
"72b6c9a70d699c7c", "3a3afa4c321bb457", "a20002f3a16a2e55",
"6d8836711da811fd", "d0114fcaf8eb3eda", "e03243c731ee71b4",
"e7e2dcff542de953", "1e0c9f5771a7d956", "1b50dc0a6d22eb87",
"e2ce7238a89a97ff", "95b532cc4381affd", "95b532cc4381affd",
"e7e2dcff542de953", "684ad25fdc2bbb80", "1291cf030eb84261",
"efbd2568614edb97", "02fadde899612bcd", "02fadde899612bcd",
"81beb57ba94e8afb", "81beb57ba94e8afb", "3d00ed86b663cd1b",
"47d23dadd0f8a03d", "1e0c9f5771a7d956", "02fadde899612bcd",
"e7e2dcff542de953", "576214c4d3d858ca", "2328f6c666f47c50",
"fc8faa13fa06f608", "4d2a4808c122819c", "3df4d74be91725a1",
"b39781589c4403fb", "00e5361b1b2331ca", "3460fad55db84f69",
"4dc77223867ea277", "b0793cade3a2e514", "7b486bbf09c4d683",
"5eb3c8aac62dcd38", "a06bfc7207e8ebaa", "cc5d876ac89c28a2",
"5447a386ce143777", "e5a00aa9991ac8a5", "e1386671d8a0a6eb",
"956600725cde0678", "df45056ea2b22d55", "756085cd34348d5d",
"756085cd34348d5d"], "n": 10000, "rnd": 200, "rounds": 100,
"spool_lines": 21, "spool_sha":
"5e6e8a0cd2efa61f58cd61626af874628952ee3da3a16ca6df2b3c94726818b3",
"start": 100, "state_sha": "b0391db14554d1a5"}
""")


# tools/jax_reference_values.py otp --n 64 and bridge (phases 35, 36); otp
# --n 10000 (phase 34) below
JAX_OTP_SMALL = json.loads("""
{"boot_rnd": 30, "callers": 8, "counters_sha": "45a03f60509be514",
"crashes": 1, "leaf_hashes": ["a962c99ae0666415", "0b6f7181c211aae5",
"df3f619804a92fdb", "5341e6b2646979a7", "e80232b4d18d0bb7",
"f3cc103136423a57", "f3cc103136423a57", "e80232b4d18d0bb7",
"fd9243e1ba57263e", "f3cc103136423a57", "f3cc103136423a57",
"e80232b4d18d0bb7", "f3cc103136423a57", "f3cc103136423a57",
"f3cc103136423a57", "f3cc103136423a57", "f3cc103136423a57",
"f3cc103136423a57", "f3cc103136423a57", "f3cc103136423a57",
"5341e6b2646979a7", "5341e6b2646979a7", "d565f6b5f6299070",
"2dfdc690890fd14e", "3d6876a0146de857", "f5a5fd42d16a2030",
"f5a5fd42d16a2030", "5341e6b2646979a7", "7c8975e1e60a5c83",
"61ed22855e333180", "8443d24389600333", "069c475b61f16d3b",
"808f96d95d89fc96", "05da7d28f2ac0246", "0cfd92c3ccbac6b4",
"ed44407f99b024a8", "40875012016e7540", "e7341088d8879159",
"3f9608885477d130", "56dabdee7d85194f", "dbfc876d0b59419d",
"0b6f7181c211aae5", "fc3d3a6d46f2ed5e", "01216d9bd3b0435b",
"ad7facb2586fc6e9", "40180193220583a7", "d1edcc3cd3527c78",
"fc3d3a6d46f2ed5e", "ad7facb2586fc6e9", "e3933bf77849263c",
"77b05ad2b16d25d3", "46607a0e7e9ce89f", "05f2cdae5924e000",
"30b0d83d2b9944d8", "b373374271b8a78a", "ed44407f99b024a8",
"40875012016e7540", "5ba69abc9350dc1e", "3f9608885477d130",
"72ecfe9c9e04efcb", "7c8975e1e60a5c83", "3d6876a0146de857",
"3d6876a0146de857", "c260b7d1338653c3", "cc9ee0d8b1f44740",
"5341e6b2646979a7", "232e70496900fce4", "0afb49302e1688ad",
"241e1c549fc4e358", "ec67ef4dd9cd42e0", "ed44407f99b024a8",
"40875012016e7540", "f83c4e5c4b99564d", "3f9608885477d130",
"b49f8a7612e367b2", "b6ac6b6041432907", "26b25d457597a7b0",
"c31425b44a7ed682"], "messages_out": 164, "monitor_counts": {"down_sig":
1, "edge_down": 1, "edge_up": 0, "monitors": 3, "nodedown": 4, "nodeup":
0}, "n": 64, "owners": 4, "rnd": 90, "seed": 34, "state_sha":
"e37d15f042bf988b", "statistics_sha": "063bf85778f3d453", "stats":
{"delivered": 2645, "dropped": 2, "emitted": 2647}, "status_counts":
{"gen_server": [480, 0, 0, 31, 0, 1], "gen_statem": [480, 0, 0, 32, 0,
0], "rpc": [480, 0, 0, 31, 1, 0]}, "trace_sha": "8ef48412283b3f67",
"trace_shape": [[10, 64, 247, 16], [10, 64, 247, 16]], "trace_text_sha":
"3d11487f04f917ee", "unprocessed": 0}
""")
JAX_BRIDGE = json.loads("""
{"replies": [[1, "ok"], [2, "ok"], [3, "ok"], [4, "ok"], [5, "ok"], [6,
"ok"], [7, "ok"], [8, "ok"], [9, "ok"], [10, ["ok", 20]], [11, ["ok",
[0, 1, 2, 3, 4, 5, 6, 7]]], [12, "ok"], [13, ["ok", 21]], [14, ["ok",
[[0, [42, 0, 0, 0]]]]], [15, "ok"], [16, "ok"], [17, "ok"], [18, ["ok",
[["emitted", 0], ["delivered", 0], ["dropped", 0], ["round", 21]]]],
[19, "ok"]]}
""")
JAX_OTP = json.loads("""
{"boot_rnd": 70, "callers": 1000, "counters_sha": "08cca269ec47d3a8",
"crashes": 100, "leaf_hashes": ["775be457774803ff", "418fe388800597d8",
"df3f619804a92fdb", "e7e2dcff542de953", "baf1862a3e57a773",
"124617c1f65e92d3", "124617c1f65e92d3", "baf1862a3e57a773",
"b9163d03c43083a1", "124617c1f65e92d3", "124617c1f65e92d3",
"baf1862a3e57a773", "124617c1f65e92d3", "124617c1f65e92d3",
"124617c1f65e92d3", "124617c1f65e92d3", "124617c1f65e92d3",
"124617c1f65e92d3", "124617c1f65e92d3", "124617c1f65e92d3",
"e7e2dcff542de953", "e7e2dcff542de953", "0fe40740b528ec6e",
"24d159018e199402", "e2ce7238a89a97ff", "95b532cc4381affd",
"95b532cc4381affd", "e7e2dcff542de953", "684ad25fdc2bbb80",
"06a4998e75b78e87", "1a606233acb3b10a", "dbd577c9538d18a4",
"11ccc75e5ec9918b", "eeb1fce1f7886dcd", "6b5ca26bc05ce8f8",
"2f61201b8135e252", "3ff607a1d87bb660", "b8077b8042d8baad",
"145aa6074c791c56", "8f7e5ab476a22eb6", "e6cbf68307170b21",
"418fe388800597d8", "b5a0ac6212c5e79f", "18964d5eb86af749",
"a993f8c574e0fea8", "799bd4b559f5d931", "211e73eae7b81746",
"b5a0ac6212c5e79f", "a993f8c574e0fea8", "a7c9ca808d63edd0",
"ca2a90c4af75b984", "924233dbd6579c6f", "10230a1d3d23dec5",
"3c083febe9248f82", "6e3733d43786855e", "2f61201b8135e252",
"3ff607a1d87bb660", "b6e8588d57042ea6", "145aa6074c791c56",
"8c57d9aef187078a", "684ad25fdc2bbb80", "e2ce7238a89a97ff",
"e2ce7238a89a97ff", "cf03c1ffe83690c8", "6ce9aeac6c85d194",
"965cbd604c9b8359", "51dafde426964677", "a2b1b0a7bf9284c3",
"3913833640c131a6", "4b7ec506956473d9", "2f61201b8135e252",
"3ff607a1d87bb660", "b765b11514321c3a", "145aa6074c791c56",
"03928648fbba8b98", "25044e9f90d26404", "cff611e6fecb2649",
"85884be0c0b39bef"], "monitor_counts": {"down_sig": 49, "edge_down": 49,
"edge_up": 0, "monitors": 51, "nodedown": 9900, "nodeup": 0}, "n":
10000, "owners": 100, "rnd": 130, "seed": 34, "state_sha":
"797ecff28707a542", "stats": {"delivered": 439943, "dropped": 79,
"emitted": 440022}, "status_counts": {"gen_server": [76000, 18, 0, 3952,
8, 22], "gen_statem": [76000, 18, 0, 3956, 7, 19], "rpc": [76000, 18, 0,
3971, 11, 0]}, "unprocessed": 2}
""")

# tools/jax_reference_values.py fleet --width 64 --n 1024 (jax 0.9.0 on
# the CPU): scenarios.fleet_sweep's card without wall_s, and the final
# fleet state's round and hashes; phase 37 holds the card to them.
JAX_FLEET = json.loads("""
{"config": "fleet_sweep", "converged": 64,
"leaf_hashes": ["e6bfd42cb3ef4c11", "916b144867c34061",
"5341e6b2646979a7", "8a39d2abd3999ab7", "1adea3761adbd170",
"654ee51c71d03c6a", "896bad9fa6ffdb13", "5647f05ec1895894",
"92726437a5c7b54e", "2daeb1f36095b44b", "2daeb1f36095b44b",
"5647f05ec1895894", "1d3f926b6f1be37c", "e8ed9fb105f96afb",
"bf7280aba05cabb7", "bdeac15d0088398f", "65d5d45ff2117de1",
"7e08495a72186f21", "29e4cf544c157193", "099559af904cfb00",
"654ee51c71d03c6a", "bb9f8df61474d25e", "dd9bac115f445a31",
"1e893c2cb4ad44ff", "a4671344635305e8", "3315ac1a7bdb337b",
"4eb0d2e4f4c5dc8b", "40b7ee11a87932de", "de2f256064a0af79",
"de2f256064a0af79", "8a39d2abd3999ab7", "916b144867c34061",
"fe25a053e3d1ccb2", "da9413ea291f06d6", "0a049460242325cf",
"069fc8f06f5d997d", "bbd05cf6097ac9b1", "bbd05cf6097ac9b1",
"07854d2fef297a06", "ab20971ad5783f4b", "3315ac1a7bdb337b",
"5647f05ec1895894", "8a39d2abd3999ab7", "1eaebae8aa6fb6b0",
"60d3aa3828d79d56", "b227dbb009e6c136", "b6739a189904c993",
"747327a0bf031a74", "5f70bf18a0860070", "c9bb4a2a3c6f3830",
"3c63569701dfc939", "4fe7b59af6de3b66", "3758d696080f9085",
"00334e7955294ec5", "05f6a18bd68fa370", "6dbffe34f59fe476",
"4fe7b59af6de3b66", "4fe7b59af6de3b66", "4fe7b59af6de3b66",
"4fe7b59af6de3b66", "61ba230dada8edfa", "84a9afe75b945b5c",
"916b144867c34061", "916b144867c34061", "3fa37fdbaf9919e0",
"8238bd2a4c38bc85", "03dbc4c4a8767fe9", "5647f05ec1895894",
"c83c00b1ad39247d", "f7ea248321176ef4", "e667e9dcd4c38dbb",
"99311f872d0b8ad0", "c6f2e134bc99c335", "c7fdb8d5d0770fcb",
"d0ff1b294b5288d1", "428ee6125b123b33", "a60f9cbbb56a7f34",
"fea7b32778ecbdd7"], "members": {"redundancy_ratio": [0.0, 0.0, 0.0,
0.0625, 0.0, 0.0, 0.0, 0.0476, 0.0667, 0.0, 0.125, 0.0, 0.0, 0.0,
0.2727, 0.0455, 0.0, 0.0, 0.2941, 0.1053, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
0.0, 0.0, 0.0, 0.1429, 0.0, 0.2105, 0.0, 0.0, 0.0, 0.0, 0.1818, 0.0,
0.0, 0.0, 0.0, 0.0, 0.1667, 0.0, 0.0, 0.0625, 0.1875, 0.2, 0.0, 0.0,
0.0, 0.0, 0.1667, 0.0, 0.0, 0.0, 0.0, 0.0, 0.1316, 0.0, 0.05, 0.0,
0.1176, 0.1053], "rounds_to_converge": [169, 139, 139, 149, 139, 169,
149, 139, 119, 149, 129, 159, 139, 139, 129, 149, 149, 129, 139, 129,
149, 139, 139, 139, 129, 159, 119, 139, 159, 139, 139, 119, 129, 179,
139, 129, 149, 139, 149, 149, 139, 119, 159, 159, 159, 129, 119, 169,
149, 129, 129, 129, 179, 149, 129, 139, 159, 149, 159, 129, 139, 199,
159, 149]}, "n": 1024, "p99": {"broadcast": {"count": 64, "max": 0.0,
"mean": 0.0, "min": 0.0, "missing": 0, "p5": 0.0, "p50": 0.0,
"p95": 0.0}, "default": {"count": 64, "max": 0.0, "mean": 0.0,
"min": 0.0, "missing": 0, "p5": 0.0, "p50": 0.0, "p95": 0.0}},
"programs": 2, "redundancy_ratio": {"count": 64, "max": 0.2941,
"mean": 0.0429, "min": 0.0, "missing": 0, "p5": 0.0, "p50": 0.0,
"p95": 0.1981}, "rnd": 240, "rounds": 200,
"rounds_to_converge": {"count": 64, "max": 199.0, "mean": 143.8438,
"min": 119.0, "missing": 0, "p5": 119.0, "p50": 139.0, "p95": 169.0},
"seed": 0, "state_sha": "7fc25aa3baf8ddbe", "width": 64}
""")

# tools/jax_reference_values.py fleet_search (jax 0.9.0 on the CPU): the
# W=64 search's population digest, verdicts, oracles, counterexample and
# fleet state hashes; phase 38 holds the card to them.
JAX_FLEET_SEARCH = json.loads("""
{"boot": 30, "counterexamples": [{"member": 63,
"oracle": {"conservation": true, "coverage": false,
"coverage_value": 0.0625}, "replayed": true, "salt": 0,
"schedule": [[30, 0, 0], [30, 0, 1], [30, 0, 2], [30, 0, 3], [30, 0, 4],
[30, 0, 5], [30, 0, 6], [30, 0, 7], [30, 0, 8], [30, 0, 9], [30, 0, 10],
[30, 0, 11], [30, 0, 12], [30, 0, 13], [30, 0, 14], [30, 0, 15], [30, 0,
16], [30, 0, 17], [30, 0, 18], [30, 0, 19], [30, 0, 20], [30, 0, 21],
[30, 0, 22], [30, 0, 23], [30, 0, 24], [30, 0, 25], [30, 0, 26], [30, 0,
27], [30, 0, 28], [30, 0, 29], [30, 0, 30], [30, 0, 31], [30, 0, 32],
[30, 0, 33], [30, 0, 34], [30, 0, 35], [30, 0, 36], [30, 0, 37], [30, 0,
38], [30, 0, 39], [30, 0, 40], [30, 0, 41], [30, 0, 42], [30, 0, 43],
[30, 0, 44], [30, 0, 45], [30, 0, 46], [30, 0, 47], [30, 0, 48], [30, 0,
49], [30, 0, 50], [30, 0, 51], [30, 0, 52], [30, 0, 53], [30, 0, 54],
[30, 0, 55], [30, 0, 56], [30, 0, 57], [30, 0, 58], [30, 0, 59], [30, 0,
60], [30, 0, 61], [30, 0, 62], [30, 0, 63], [30, 0, 64], [30, 0, 65],
[30, 0, 66], [30, 0, 67], [30, 0, 68], [30, 0, 69], [30, 0, 70], [30, 0,
71], [30, 0, 72], [30, 0, 73], [30, 0, 74], [30, 0, 75], [30, 0, 76],
[30, 0, 77], [30, 0, 78], [30, 0, 79], [30, 0, 80], [30, 0, 81], [30, 0,
82], [30, 0, 83], [30, 0, 84], [30, 0, 85], [30, 0, 86], [30, 0, 87],
[30, 0, 88], [30, 0, 89], [30, 0, 90], [30, 0, 91], [30, 0, 92], [30, 0,
93], [30, 0, 94], [30, 0, 95], [30, 0, 96], [30, 0, 97], [30, 0, 98],
[30, 0, 99], [30, 0, 100], [30, 0, 101], [30, 0, 102], [30, 0, 103],
[30, 0, 104], [30, 0, 105], [30, 0, 106], [30, 0, 107], [30, 0, 108],
[30, 0, 109], [30, 0, 110], [30, 0, 111], [30, 0, 112], [30, 0, 113],
[30, 0, 114], [30, 0, 115], [30, 0, 116], [30, 0, 117], [30, 0, 118],
[30, 0, 119], [30, 0, 120], [30, 0, 121], [30, 0, 122], [30, 0, 123],
[30, 0, 124], [31, 0, 0], [31, 0, 1], [31, 0, 2], [31, 0, 3], [31, 0,
4], [31, 0, 5], [31, 0, 6], [31, 0, 7], [31, 0, 8], [31, 0, 9], [31, 0,
10], [31, 0, 11], [31, 0, 12], [31, 0, 13], [31, 0, 14], [31, 0, 15],
[31, 0, 16], [31, 0, 17], [31, 0, 18], [31, 0, 19], [31, 0, 20], [31, 0,
21], [31, 0, 22], [31, 0, 23], [31, 0, 24], [31, 0, 25], [31, 0, 26],
[31, 0, 27], [31, 0, 28], [31, 0, 29], [31, 0, 30], [31, 0, 31], [31, 0,
32], [31, 0, 33], [31, 0, 34], [31, 0, 35], [31, 0, 36], [31, 0, 37],
[31, 0, 38], [31, 0, 39], [31, 0, 40], [31, 0, 41], [31, 0, 42], [31, 0,
43], [31, 0, 44], [31, 0, 45], [31, 0, 46], [31, 0, 47], [31, 0, 48],
[31, 0, 49], [31, 0, 50], [31, 0, 51], [31, 0, 52], [31, 0, 53], [31, 0,
54], [31, 0, 55], [31, 0, 56], [31, 0, 57], [31, 0, 58], [31, 0, 59],
[31, 0, 60], [31, 0, 61], [31, 0, 62], [31, 0, 63], [31, 0, 64], [31, 0,
65], [31, 0, 66], [31, 0, 67], [31, 0, 68], [31, 0, 69], [31, 0, 70],
[31, 0, 71], [31, 0, 72], [31, 0, 73], [31, 0, 74], [31, 0, 75], [31, 0,
76], [31, 0, 77], [31, 0, 78], [31, 0, 79], [31, 0, 80], [31, 0, 81],
[31, 0, 82], [31, 0, 83], [31, 0, 84], [31, 0, 85], [31, 0, 86], [31, 0,
87], [31, 0, 88], [31, 0, 89], [31, 0, 90], [31, 0, 91], [31, 0, 92],
[31, 0, 93], [31, 0, 94], [31, 0, 95], [31, 0, 96], [31, 0, 97], [31, 0,
98], [31, 0, 99], [31, 0, 100], [31, 0, 101], [31, 0, 102], [31, 0,
103], [31, 0, 104], [31, 0, 105], [31, 0, 106], [31, 0, 107], [31, 0,
108], [31, 0, 109], [31, 0, 110], [31, 0, 111], [31, 0, 112], [31, 0,
113], [31, 0, 114], [31, 0, 115], [31, 0, 116], [31, 0, 117], [31, 0,
118], [31, 0, 119], [31, 0, 120], [31, 0, 121], [31, 0, 122], [31, 0,
123], [31, 0, 124], [32, 0, 0], [32, 0, 1], [32, 0, 2], [32, 0, 3], [32,
0, 4], [32, 0, 5], [32, 0, 6], [32, 0, 7], [32, 0, 8], [32, 0, 9], [32,
0, 10], [32, 0, 11], [32, 0, 12], [32, 0, 13], [32, 0, 14], [32, 0, 15],
[32, 0, 16], [32, 0, 17], [32, 0, 18], [32, 0, 19], [32, 0, 20], [32, 0,
21], [32, 0, 22], [32, 0, 23], [32, 0, 24], [32, 0, 25], [32, 0, 26],
[32, 0, 27], [32, 0, 28], [32, 0, 29], [32, 0, 30], [32, 0, 31], [32, 0,
32], [32, 0, 33], [32, 0, 34], [32, 0, 35], [32, 0, 36], [32, 0, 37],
[32, 0, 38], [32, 0, 39], [32, 0, 40], [32, 0, 41], [32, 0, 42], [32, 0,
43], [32, 0, 44], [32, 0, 45], [32, 0, 46], [32, 0, 47], [32, 0, 48],
[32, 0, 49], [32, 0, 50], [32, 0, 51], [32, 0, 52], [32, 0, 53], [32, 0,
54], [32, 0, 55], [32, 0, 56], [32, 0, 57], [32, 0, 58], [32, 0, 59],
[32, 0, 60], [32, 0, 61], [32, 0, 62], [32, 0, 63], [32, 0, 64], [32, 0,
65], [32, 0, 66], [32, 0, 67], [32, 0, 68], [32, 0, 69], [32, 0, 70],
[32, 0, 71], [32, 0, 72], [32, 0, 73], [32, 0, 74], [32, 0, 75], [32, 0,
76], [32, 0, 77], [32, 0, 78], [32, 0, 79], [32, 0, 80], [32, 0, 81],
[32, 0, 82], [32, 0, 83], [32, 0, 84], [32, 0, 85], [32, 0, 86], [32, 0,
87], [32, 0, 88], [32, 0, 89], [32, 0, 90], [32, 0, 91], [32, 0, 92],
[32, 0, 93], [32, 0, 94], [32, 0, 95], [32, 0, 96], [32, 0, 97], [32, 0,
98], [32, 0, 99], [32, 0, 100], [32, 0, 101], [32, 0, 102], [32, 0,
103], [32, 0, 104], [32, 0, 105], [32, 0, 106], [32, 0, 107], [32, 0,
108], [32, 0, 109], [32, 0, 110], [32, 0, 111], [32, 0, 112], [32, 0,
113], [32, 0, 114], [32, 0, 115], [32, 0, 116], [32, 0, 117], [32, 0,
118], [32, 0, 119], [32, 0, 120], [32, 0, 121], [32, 0, 122], [32, 0,
123], [32, 0, 124], [33, 0, 0], [33, 0, 1], [33, 0, 2], [33, 0, 3], [33,
0, 4], [33, 0, 5], [33, 0, 6], [33, 0, 7], [33, 0, 8], [33, 0, 9], [33,
0, 10], [33, 0, 11], [33, 0, 12], [33, 0, 13], [33, 0, 14], [33, 0, 15],
[33, 0, 16], [33, 0, 17], [33, 0, 18], [33, 0, 19], [33, 0, 20], [33, 0,
21], [33, 0, 22], [33, 0, 23], [33, 0, 24], [33, 0, 25], [33, 0, 26],
[33, 0, 27], [33, 0, 28], [33, 0, 29], [33, 0, 30], [33, 0, 31], [33, 0,
32], [33, 0, 33], [33, 0, 34], [33, 0, 35], [33, 0, 36], [33, 0, 37],
[33, 0, 38], [33, 0, 39], [33, 0, 40], [33, 0, 41], [33, 0, 42], [33, 0,
43], [33, 0, 44], [33, 0, 45], [33, 0, 46], [33, 0, 47], [33, 0, 48],
[33, 0, 49], [33, 0, 50], [33, 0, 51], [33, 0, 52], [33, 0, 53], [33, 0,
54], [33, 0, 55], [33, 0, 56], [33, 0, 57], [33, 0, 58], [33, 0, 59],
[33, 0, 60], [33, 0, 61], [33, 0, 62], [33, 0, 63], [33, 0, 64], [33, 0,
65], [33, 0, 66], [33, 0, 67], [33, 0, 68], [33, 0, 69], [33, 0, 70],
[33, 0, 71], [33, 0, 72], [33, 0, 73], [33, 0, 74], [33, 0, 75], [33, 0,
76], [33, 0, 77], [33, 0, 78], [33, 0, 79], [33, 0, 80], [33, 0, 81],
[33, 0, 82], [33, 0, 83], [33, 0, 84], [33, 0, 85], [33, 0, 86], [33, 0,
87], [33, 0, 88], [33, 0, 89], [33, 0, 90], [33, 0, 91], [33, 0, 92],
[33, 0, 93], [33, 0, 94], [33, 0, 95], [33, 0, 96], [33, 0, 97], [33, 0,
98], [33, 0, 99], [33, 0, 100], [33, 0, 101], [33, 0, 102], [33, 0,
103], [33, 0, 104], [33, 0, 105], [33, 0, 106], [33, 0, 107], [33, 0,
108], [33, 0, 109], [33, 0, 110], [33, 0, 111], [33, 0, 112], [33, 0,
113], [33, 0, 114], [33, 0, 115], [33, 0, 116], [33, 0, 117], [33, 0,
118], [33, 0, 119], [33, 0, 120], [33, 0, 121], [33, 0, 122], [33, 0,
123], [33, 0, 124], [34, 0, 0], [34, 0, 1], [34, 0, 2], [34, 0, 3], [34,
0, 4], [34, 0, 5], [34, 0, 6], [34, 0, 7], [34, 0, 8], [34, 0, 9], [34,
0, 10], [34, 0, 11], [34, 0, 12], [34, 0, 13], [34, 0, 14], [34, 0, 15],
[34, 0, 16], [34, 0, 17], [34, 0, 18], [34, 0, 19], [34, 0, 20], [34, 0,
21], [34, 0, 22], [34, 0, 23], [34, 0, 24], [34, 0, 25], [34, 0, 26],
[34, 0, 27], [34, 0, 28], [34, 0, 29], [34, 0, 30], [34, 0, 31], [34, 0,
32], [34, 0, 33], [34, 0, 34], [34, 0, 35], [34, 0, 36], [34, 0, 37],
[34, 0, 38], [34, 0, 39], [34, 0, 40], [34, 0, 41], [34, 0, 42], [34, 0,
43], [34, 0, 44], [34, 0, 45], [34, 0, 46], [34, 0, 47], [34, 0, 48],
[34, 0, 49], [34, 0, 50], [34, 0, 51], [34, 0, 52], [34, 0, 53], [34, 0,
54], [34, 0, 55], [34, 0, 56], [34, 0, 57], [34, 0, 58], [34, 0, 59],
[34, 0, 60], [34, 0, 61], [34, 0, 62], [34, 0, 63], [34, 0, 64], [34, 0,
65], [34, 0, 66], [34, 0, 67], [34, 0, 68], [34, 0, 69], [34, 0, 70],
[34, 0, 71], [34, 0, 72], [34, 0, 73], [34, 0, 74], [34, 0, 75], [34, 0,
76], [34, 0, 77], [34, 0, 78], [34, 0, 79], [34, 0, 80], [34, 0, 81],
[34, 0, 82], [34, 0, 83], [34, 0, 84], [34, 0, 85], [34, 0, 86], [34, 0,
87], [34, 0, 88], [34, 0, 89], [34, 0, 90], [34, 0, 91], [34, 0, 92],
[34, 0, 93], [34, 0, 94], [34, 0, 95], [34, 0, 96], [34, 0, 97], [34, 0,
98], [34, 0, 99], [34, 0, 100], [34, 0, 101], [34, 0, 102], [34, 0,
103], [34, 0, 104], [34, 0, 105], [34, 0, 106], [34, 0, 107], [34, 0,
108], [34, 0, 109], [34, 0, 110], [34, 0, 111], [34, 0, 112], [34, 0,
113], [34, 0, 114], [34, 0, 115], [34, 0, 116], [34, 0, 117], [34, 0,
118], [34, 0, 119], [34, 0, 120], [34, 0, 121], [34, 0, 122], [34, 0,
123], [34, 0, 124], [35, 0, 0], [35, 0, 1], [35, 0, 2], [35, 0, 3], [35,
0, 4], [35, 0, 5], [35, 0, 6], [35, 0, 7], [35, 0, 8], [35, 0, 9], [35,
0, 10], [35, 0, 11], [35, 0, 12], [35, 0, 13], [35, 0, 14], [35, 0, 15],
[35, 0, 16], [35, 0, 17], [35, 0, 18], [35, 0, 19], [35, 0, 20], [35, 0,
21], [35, 0, 22], [35, 0, 23], [35, 0, 24], [35, 0, 25], [35, 0, 26],
[35, 0, 27], [35, 0, 28], [35, 0, 29], [35, 0, 30], [35, 0, 31], [35, 0,
32], [35, 0, 33], [35, 0, 34], [35, 0, 35], [35, 0, 36], [35, 0, 37],
[35, 0, 38], [35, 0, 39], [35, 0, 40], [35, 0, 41], [35, 0, 42], [35, 0,
43], [35, 0, 44], [35, 0, 45], [35, 0, 46], [35, 0, 47], [35, 0, 48],
[35, 0, 49], [35, 0, 50], [35, 0, 51], [35, 0, 52], [35, 0, 53], [35, 0,
54], [35, 0, 55], [35, 0, 56], [35, 0, 57], [35, 0, 58], [35, 0, 59],
[35, 0, 60], [35, 0, 61], [35, 0, 62], [35, 0, 63], [35, 0, 64], [35, 0,
65], [35, 0, 66], [35, 0, 67], [35, 0, 68], [35, 0, 69], [35, 0, 70],
[35, 0, 71], [35, 0, 72], [35, 0, 73], [35, 0, 74], [35, 0, 75], [35, 0,
76], [35, 0, 77], [35, 0, 78], [35, 0, 79], [35, 0, 80], [35, 0, 81],
[35, 0, 82], [35, 0, 83], [35, 0, 84], [35, 0, 85], [35, 0, 86], [35, 0,
87], [35, 0, 88], [35, 0, 89], [35, 0, 90], [35, 0, 91], [35, 0, 92],
[35, 0, 93], [35, 0, 94], [35, 0, 95], [35, 0, 96], [35, 0, 97], [35, 0,
98], [35, 0, 99], [35, 0, 100], [35, 0, 101], [35, 0, 102], [35, 0,
103], [35, 0, 104], [35, 0, 105], [35, 0, 106], [35, 0, 107], [35, 0,
108], [35, 0, 109], [35, 0, 110], [35, 0, 111], [35, 0, 112], [35, 0,
113], [35, 0, 114], [35, 0, 115], [35, 0, 116], [35, 0, 117], [35, 0,
118], [35, 0, 119], [35, 0, 120], [35, 0, 121], [35, 0, 122], [35, 0,
123], [35, 0, 124], [36, 0, 0], [36, 0, 1], [36, 0, 2], [36, 0, 3], [36,
0, 4], [36, 0, 5], [36, 0, 6], [36, 0, 7], [36, 0, 8], [36, 0, 9], [36,
0, 10], [36, 0, 11], [36, 0, 12], [36, 0, 13], [36, 0, 14], [36, 0, 15],
[36, 0, 16], [36, 0, 17], [36, 0, 18], [36, 0, 19], [36, 0, 20], [36, 0,
21], [36, 0, 22], [36, 0, 23], [36, 0, 24], [36, 0, 25], [36, 0, 26],
[36, 0, 27], [36, 0, 28], [36, 0, 29], [36, 0, 30], [36, 0, 31], [36, 0,
32], [36, 0, 33], [36, 0, 34], [36, 0, 35], [36, 0, 36], [36, 0, 37],
[36, 0, 38], [36, 0, 39], [36, 0, 40], [36, 0, 41], [36, 0, 42], [36, 0,
43], [36, 0, 44], [36, 0, 45], [36, 0, 46], [36, 0, 47], [36, 0, 48],
[36, 0, 49], [36, 0, 50], [36, 0, 51], [36, 0, 52], [36, 0, 53], [36, 0,
54], [36, 0, 55], [36, 0, 56], [36, 0, 57], [36, 0, 58], [36, 0, 59],
[36, 0, 60], [36, 0, 61], [36, 0, 62], [36, 0, 63], [36, 0, 64], [36, 0,
65], [36, 0, 66], [36, 0, 67], [36, 0, 68], [36, 0, 69], [36, 0, 70],
[36, 0, 71], [36, 0, 72], [36, 0, 73], [36, 0, 74], [36, 0, 75], [36, 0,
76], [36, 0, 77], [36, 0, 78], [36, 0, 79], [36, 0, 80], [36, 0, 81],
[36, 0, 82], [36, 0, 83], [36, 0, 84], [36, 0, 85], [36, 0, 86], [36, 0,
87], [36, 0, 88], [36, 0, 89], [36, 0, 90], [36, 0, 91], [36, 0, 92],
[36, 0, 93], [36, 0, 94], [36, 0, 95], [36, 0, 96], [36, 0, 97], [36, 0,
98], [36, 0, 99], [36, 0, 100], [36, 0, 101], [36, 0, 102], [36, 0,
103], [36, 0, 104], [36, 0, 105], [36, 0, 106], [36, 0, 107], [36, 0,
108], [36, 0, 109], [36, 0, 110], [36, 0, 111], [36, 0, 112], [36, 0,
113], [36, 0, 114], [36, 0, 115], [36, 0, 116], [36, 0, 117], [36, 0,
118], [36, 0, 119], [36, 0, 120], [36, 0, 121], [36, 0, 122], [36, 0,
123], [36, 0, 124], [37, 0, 0], [37, 0, 1], [37, 0, 2], [37, 0, 3], [37,
0, 4], [37, 0, 5], [37, 0, 6], [37, 0, 7], [37, 0, 8], [37, 0, 9], [37,
0, 10], [37, 0, 11], [37, 0, 12], [37, 0, 13], [37, 0, 14], [37, 0, 15],
[37, 0, 16], [37, 0, 17], [37, 0, 18], [37, 0, 19], [37, 0, 20], [37, 0,
21], [37, 0, 22], [37, 0, 23], [37, 0, 24], [37, 0, 25], [37, 0, 26],
[37, 0, 27], [37, 0, 28], [37, 0, 29], [37, 0, 30], [37, 0, 31], [37, 0,
32], [37, 0, 33], [37, 0, 34], [37, 0, 35], [37, 0, 36], [37, 0, 37],
[37, 0, 38], [37, 0, 39], [37, 0, 40], [37, 0, 41], [37, 0, 42], [37, 0,
43], [37, 0, 44], [37, 0, 45], [37, 0, 46], [37, 0, 47], [37, 0, 48],
[37, 0, 49], [37, 0, 50], [37, 0, 51], [37, 0, 52], [37, 0, 53], [37, 0,
54], [37, 0, 55], [37, 0, 56], [37, 0, 57], [37, 0, 58], [37, 0, 59],
[37, 0, 60], [37, 0, 61], [37, 0, 62], [37, 0, 63], [37, 0, 64], [37, 0,
65], [37, 0, 66], [37, 0, 67], [37, 0, 68], [37, 0, 69], [37, 0, 70],
[37, 0, 71], [37, 0, 72], [37, 0, 73], [37, 0, 74], [37, 0, 75], [37, 0,
76], [37, 0, 77], [37, 0, 78], [37, 0, 79], [37, 0, 80], [37, 0, 81],
[37, 0, 82], [37, 0, 83], [37, 0, 84], [37, 0, 85], [37, 0, 86], [37, 0,
87], [37, 0, 88], [37, 0, 89], [37, 0, 90], [37, 0, 91], [37, 0, 92],
[37, 0, 93], [37, 0, 94], [37, 0, 95], [37, 0, 96], [37, 0, 97], [37, 0,
98], [37, 0, 99], [37, 0, 100], [37, 0, 101], [37, 0, 102], [37, 0,
103], [37, 0, 104], [37, 0, 105], [37, 0, 106], [37, 0, 107], [37, 0,
108], [37, 0, 109], [37, 0, 110], [37, 0, 111], [37, 0, 112], [37, 0,
113], [37, 0, 114], [37, 0, 115], [37, 0, 116], [37, 0, 117], [37, 0,
118], [37, 0, 119], [37, 0, 120], [37, 0, 121], [37, 0, 122], [37, 0,
123], [37, 0, 124], [38, 0, 0], [38, 0, 1], [38, 0, 2], [38, 0, 3], [38,
0, 4], [38, 0, 5], [38, 0, 6], [38, 0, 7], [38, 0, 8], [38, 0, 9], [38,
0, 10], [38, 0, 11], [38, 0, 12], [38, 0, 13], [38, 0, 14], [38, 0, 15],
[38, 0, 16], [38, 0, 17], [38, 0, 18], [38, 0, 19], [38, 0, 20], [38, 0,
21], [38, 0, 22], [38, 0, 23], [38, 0, 24], [38, 0, 25], [38, 0, 26],
[38, 0, 27], [38, 0, 28], [38, 0, 29], [38, 0, 30], [38, 0, 31], [38, 0,
32], [38, 0, 33], [38, 0, 34], [38, 0, 35], [38, 0, 36], [38, 0, 37],
[38, 0, 38], [38, 0, 39], [38, 0, 40], [38, 0, 41], [38, 0, 42], [38, 0,
43], [38, 0, 44], [38, 0, 45], [38, 0, 46], [38, 0, 47], [38, 0, 48],
[38, 0, 49], [38, 0, 50], [38, 0, 51], [38, 0, 52], [38, 0, 53], [38, 0,
54], [38, 0, 55], [38, 0, 56], [38, 0, 57], [38, 0, 58], [38, 0, 59],
[38, 0, 60], [38, 0, 61], [38, 0, 62], [38, 0, 63], [38, 0, 64], [38, 0,
65], [38, 0, 66], [38, 0, 67], [38, 0, 68], [38, 0, 69], [38, 0, 70],
[38, 0, 71], [38, 0, 72], [38, 0, 73], [38, 0, 74], [38, 0, 75], [38, 0,
76], [38, 0, 77], [38, 0, 78], [38, 0, 79], [38, 0, 80], [38, 0, 81],
[38, 0, 82], [38, 0, 83], [38, 0, 84], [38, 0, 85], [38, 0, 86], [38, 0,
87], [38, 0, 88], [38, 0, 89], [38, 0, 90], [38, 0, 91], [38, 0, 92],
[38, 0, 93], [38, 0, 94], [38, 0, 95], [38, 0, 96], [38, 0, 97], [38, 0,
98], [38, 0, 99], [38, 0, 100], [38, 0, 101], [38, 0, 102], [38, 0,
103], [38, 0, 104], [38, 0, 105], [38, 0, 106], [38, 0, 107], [38, 0,
108], [38, 0, 109], [38, 0, 110], [38, 0, 111], [38, 0, 112], [38, 0,
113], [38, 0, 114], [38, 0, 115], [38, 0, 116], [38, 0, 117], [38, 0,
118], [38, 0, 119], [38, 0, 120], [38, 0, 121], [38, 0, 122], [38, 0,
123], [38, 0, 124], [39, 0, 0], [39, 0, 1], [39, 0, 2], [39, 0, 3], [39,
0, 4], [39, 0, 5], [39, 0, 6], [39, 0, 7], [39, 0, 8], [39, 0, 9], [39,
0, 10], [39, 0, 11], [39, 0, 12], [39, 0, 13], [39, 0, 14], [39, 0, 15],
[39, 0, 16], [39, 0, 17], [39, 0, 18], [39, 0, 19], [39, 0, 20], [39, 0,
21], [39, 0, 22], [39, 0, 23], [39, 0, 24], [39, 0, 25], [39, 0, 26],
[39, 0, 27], [39, 0, 28], [39, 0, 29], [39, 0, 30], [39, 0, 31], [39, 0,
32], [39, 0, 33], [39, 0, 34], [39, 0, 35], [39, 0, 36], [39, 0, 37],
[39, 0, 38], [39, 0, 39], [39, 0, 40], [39, 0, 41], [39, 0, 42], [39, 0,
43], [39, 0, 44], [39, 0, 45], [39, 0, 46], [39, 0, 47], [39, 0, 48],
[39, 0, 49], [39, 0, 50], [39, 0, 51], [39, 0, 52], [39, 0, 53], [39, 0,
54], [39, 0, 55], [39, 0, 56], [39, 0, 57], [39, 0, 58], [39, 0, 59],
[39, 0, 60], [39, 0, 61], [39, 0, 62], [39, 0, 63], [39, 0, 64], [39, 0,
65], [39, 0, 66], [39, 0, 67], [39, 0, 68], [39, 0, 69], [39, 0, 70],
[39, 0, 71], [39, 0, 72], [39, 0, 73], [39, 0, 74], [39, 0, 75], [39, 0,
76], [39, 0, 77], [39, 0, 78], [39, 0, 79], [39, 0, 80], [39, 0, 81],
[39, 0, 82], [39, 0, 83], [39, 0, 84], [39, 0, 85], [39, 0, 86], [39, 0,
87], [39, 0, 88], [39, 0, 89], [39, 0, 90], [39, 0, 91], [39, 0, 92],
[39, 0, 93], [39, 0, 94], [39, 0, 95], [39, 0, 96], [39, 0, 97], [39, 0,
98], [39, 0, 99], [39, 0, 100], [39, 0, 101], [39, 0, 102], [39, 0,
103], [39, 0, 104], [39, 0, 105], [39, 0, 106], [39, 0, 107], [39, 0,
108], [39, 0, 109], [39, 0, 110], [39, 0, 111], [39, 0, 112], [39, 0,
113], [39, 0, 114], [39, 0, 115], [39, 0, 116], [39, 0, 117], [39, 0,
118], [39, 0, 119], [39, 0, 120], [39, 0, 121], [39, 0, 122], [39, 0,
123], [39, 0, 124]], "seed": 5}], "emit_width": 125,
"leaf_hashes": ["1a00f51f3029fa4b", "5a648d8015900d89",
"5341e6b2646979a7", "ad7facb2586fc6e9", "b58869e0b6710dec",
"69943d85ce89357a", "60d2231c8db39bb6", "c35020473aed1b46",
"40cdcc08d3d4a64d", "fa43239bcee7b97c", "fa43239bcee7b97c",
"c35020473aed1b46", "69943d85ce89357a", "376e7111dc3eccf8",
"72c95eef66c14a62", "cec06235c7f14787", "3358d845b55c7997",
"d5217070a900e877", "6c94358ac4d0ce89", "6a52b20206f7dece",
"faee06e9435b94ba", "ad7facb2586fc6e9", "4fe24a55279e3a69",
"5c3853e5cf487a86", "f47a8ec3e9aff231", "5f70bf18a0860070",
"5f70bf18a0860070", "ad7facb2586fc6e9", "5a648d8015900d89",
"e04c5a3b8fdb00c5", "d6f0c9ddc8646f45", "5e372f1e4a7c35da",
"1bc8577893a68152", "a6619f482fee91a3", "a6619f482fee91a3",
"de2f256064a0af79", "4440496395b0e70f", "4fe24a55279e3a69",
"8a39d2abd3999ab7", "ad7facb2586fc6e9", "48f20527dd10acaf",
"48f20527dd10acaf", "5341e6b2646979a7", "9c5e0d85d9a6b6b8",
"5341e6b2646979a7"], "n": 16, "oracle": {"conservation": [true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true], "coverage": [true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, false],
"coverage_value": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0625]},
"passed": false, "programs": 2, "schedules_sha": "c61647c726b85f41",
"state0_sha": "b565b8df85a79558", "state_sha": "80b9fd229d6e0323",
"verdicts": [true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, true, true, true, true, true, true, true,
true, true, true, true, true, false], "width": 64}
""")

# tools/jax_reference_values.py fleet_parity (jax 0.9.0 on the CPU): the
# member storms' chunk rounds and final state hashes, and fleet.tune's
# dict; phase 39 holds the card to them.
JAX_FLEET_PARITY = json.loads("""
{"breaches": 0, "chunk_k": [6, 2, 2, 2, 6, 2, 4, 6, 6],
"chunk_rounds": [0, 6, 8, 10, 12, 18, 20, 24, 30],
"leaf_hashes": ["de6d696c194fb883", "413aaf88f995cebb",
"374708fff7719dd5", "cfc335996cfae29f", "93ed48372e4a713c",
"4e843a3197da72fc", "fb75716f34d2347e", "caaa5735e0f40e02",
"282c68257d3f7b9f", "f3cc103136423a57", "f3cc103136423a57",
"e80232b4d18d0bb7", "0e3b11bd5d683074", "a0b296ea5cfecb63",
"11fc945f3f395aa4", "31e69dabe79f9d36", "2c3fe96630fbf727",
"ab0411c14552ff37", "2ad4dcc791e6d3a8", "c233a08f72ecefe1",
"5da9f682d714144f", "a1a4f5721c1c4610", "08c76ffdfa9322e2",
"debf2d74040f7376", "aa41e8768deb25c2", "2ea9ab9198d16380",
"2ea9ab9198d16380", "a1a4f5721c1c4610", "8b3274a4709a50d0",
"62ebbeeab9f62dc2", "127010b64e9e70c1", "de676bae28a48001",
"de676bae28a48001", "1c02730953829883", "1c02730953829883",
"fd9243e1ba57263e", "1df8949b2e345ab8", "08c76ffdfa9322e2",
"de676bae28a48001", "a1a4f5721c1c4610", "fcee7cff1993fa68",
"7c2690b9153fe552", "660f69eb795f3673", "af08efc13471e0ee",
"374708fff7719dd5", "c13fb2641e914616", "5a4c1f79a26ee200",
"d5770f0d1ada1aa0", "baed642339816aff"], "n": 24,
"state_sha": "fa4912b8f6807a0c",
"tune": {"members": [{"bands": {"fanout_hi_pct": 200}, "coverage": 1.0,
"redundancy_ratio": 0.7985, "steady_redundancy_ratio": 0.8037},
{"bands": {}, "coverage": 1.0, "redundancy_ratio": 0.7956,
"steady_redundancy_ratio": 0.7994}],
"metric": "steady_redundancy_ratio", "n": 64, "programs": 2, "waves": 3,
"width": 2, "winner": 1, "winner_bands": {}}, "width": 4}
""")
# tests/test_statem_sim.py's table module (the tool's OTP_STATEM): 3 states
# x (4 external + state timeout + event timeout) columns
JAX_SUPERSTEP = json.loads("""
{"100000": {"budget_mib": 2048.0, "interm_mib": 4957.29, "lifted": false},
"16": {"budget_mib": 2048.0, "interm_mib": 0.79, "lifted": true},
"32768": {"budget_mib": 2048.0, "interm_mib": 1624.41, "lifted": true}}
""")

OTP_STATEM = dict(
    n_states=3, n_events=4, init_state=0,
    trans=[[1, -1, -1, -1, -1, 2], [2, -1, -1, -1, 0, 2],
           [0, 0, -1, -1, -1, -1]],
    reply=[[100, -1, 5, 1, -1, -1], [200, 10, 5, 1, -1, -1],
           [300, 20, 5, 1, -1, -1]],
    postpone=[[False, True, False, False, False, False],
              [False] * 6, [False] * 6],
    event_timeout=[[-1, -1, 3, -1, -1, -1]] * 3,
    state_timeout=[-1, 4, -1])
OTP_N, OTP_SMALL_N = 10_000, 64
FLEET_W, FLEET_N = 64, 1024     # phase 37's sweep: 65,536 node rows
FLEET_SMALL_W = 8               # the reference's default width
FLEET_SMALL_ROUNDS = 100        # its sweep's rounds after the broadcast
#                                 (the default 300 ran 170 to converge:
#                                 cut for the new phases' 90 s)
FLEET_SETTLE = 40               # fleet_sweep's default settle rounds
FLEET_REPLAY_MEMBER = 5         # re-run unbatched at seed + 5
FLEET_SEARCH_W = 64             # tests/support.py's FLEET_SEARCH_W
FLEET_PAR_W = 4                 # ... FLEET_PAR_W (tier-1)
FLEET_TUNE_N, FLEET_TUNE_WAVES = 64, 3   # ... FLEET_TUNE_N/_WAVES
OTP_SYS_MAX_N = 1024        # at or below: the first two chunks via otp.sys
OTP_WAVES, OTP_ROUNDS, OTP_TIMEOUT, OTP_SEED = 4, 60, 8, 34

T_START = time.perf_counter()


def log(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds
    so far (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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


def device_host_ms(fn, reps: int = 20) -> tuple:
    """``(device_ms, host_ms)`` per call.  The card's time per call is the
    mean of ``reps`` CUDA event pairs, one pair around each call, queued
    behind a spin kernel (``torch.cuda._sleep``) that holds the stream
    until every call is queued, so no pair waits on the host; the spin is
    lengthened until it outlasts the queuing.  The host's is its wall per
    call over ``reps`` back-to-back calls with no synchronize inside (the
    launch path's cost)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    held = torch.cuda.Event()
    # about 2e6 spin cycles a millisecond; twice the queuing time at first
    cycles = int(4e6 * reps * (host + 0.05))
    for _ in range(4):
        torch.cuda._sleep(cycles)
        held.record()
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        queued_in_time = not held.query()
        torch.cuda.synchronize()
        if queued_in_time:
            break
        cycles *= 4
    else:
        raise RuntimeError("the spin ended before the host queued its calls")
    device = sum(a.elapsed_time(b) for a, b in pairs) / reps
    if device <= 0:
        raise AssertionError(f"no device time over {reps} calls")
    return device, host


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
    from partisan_tpu_torch import bench

    run = bench.run(N_PARITY, device=device,
                    widths=[N_PARITY // 2, N_PARITY], handles=True)
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
                 # 60 churn rounds, not the reference's 120: cut for the
                 # script's time limit (the band reads the pre-churn views)
                 "config4": ("config4_scamp_churn",
                             dict(n=10_000, rounds=60)),
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
        c, c_t = cpu_half(f"causal_{label}")
        if strip_rate(g) != strip_rate(c):
            raise AssertionError(f"{label}: card {g} != CPU {c}")
        out[label] = {"result": g, "card_wall_s": g_t["wall_s"],
                      "cpu_wall_s": c_t["wall_s"]}
    if out["config5"]["result"]["causal_deliveries"] != 16:
        raise AssertionError(f"config 5 small: {out['config5']}")
    g, c = lane_setups("cuda"), cpu_half("lane_setups")
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
        c, c_t = cpu_half(f"scenario_{label}")
        if strip_rate(g) != strip_rate(c):
            raise AssertionError(f"{label}: card {g} != CPU {c}")
        out[label] = {"result": g, "card_wall_s": g_t["wall_s"],
                      "cpu_wall_s": c_t["wall_s"]}
    g_d, g_c, g_st = health_convergence("cuda", 128)
    c_d, c_c, c_st = cpu_half("health_convergence")
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

    g, c = app_setups("cuda"), cpu_half("app_setups")
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
    g, c = harness_runs("cuda"), cpu_half("harness_runs")
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
        max_executions=PAXOS_FB_EXECUTIONS).run()
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
    g, c = filibuster_paxos("cuda"), cpu_half("filibuster_paxos")
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
    want = JAX_FILIBUSTER_PAXOS
    if any(g["result"][k] != v for k, v in want.items()):
        raise AssertionError(f"Filibuster over Paxos: card {g['result']}, "
                             f"JAX {want}")
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
        cpu = cpu_half(f"app_model_{name}")
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
    from partisan_tpu_torch import bench, latency, provenance, trace
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster

    out = {}
    with RoundLog() as rl:
        run = bench.run(N_PARITY, device=device,
                        widths=[N_PARITY // 2, N_PARITY], handles=True,
                        **PLANES)
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
    g, c = planes_setups("cuda"), cpu_half("planes_setups")
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
    from partisan_tpu_torch import bench, kernels, latency, metrics
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    run = bench.run(N_MAIN, handles=True, **PLANES)
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
    lines = [x for x in bench.report_lines(cl.cfg, st)
             if x["kind"] != "metrics"]
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
            "bootstrap_s": run["phases"]["bootstrap"],
            "convergence_s": run["convergence_wall_s"],
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
    ``all_win`` must hold.  Each arm's wall, rounds and ms per round (it
    runs in the card worker, which profiles nothing)."""
    from partisan_tpu_torch import cluster as cluster_mod
    from partisan_tpu_torch import scenarios as sc

    arms: dict = {}
    cur = {"arm": None}
    orig_steps = cluster_mod.Cluster.steps

    def steps(cl, st, k):
        arms[cur["arm"]]["rounds"] += k
        return orig_steps(cl, st, k)

    def timed_arm(name, fn):
        def run(*args, **kw):
            adaptive = args[0] if args else kw.get("adaptive", True)
            label = f"{name}_{'adaptive' if adaptive else 'static'}"
            cur["arm"] = label
            arms[label] = {"rounds": 0}
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            a = arms[label]
            a["wall_s"] = time.perf_counter() - t0
            a["ms_per_round"] = a["wall_s"] * 1e3 / a["rounds"]
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


# ---------------------------------------------------------------------------
# Phases 22-25: the traffic plane, the watchdog and the soak engine
# ---------------------------------------------------------------------------

def traffic_run(name: str, n: int, device: str) -> tuple:
    """``traffic_scenario(name, n, rounds=80)`` on ``device``: its dict
    (the wall clock stripped) and final state."""
    from partisan_tpu_torch import scenarios as sc

    out, res, _ = sc._traffic_run(name, n=n, rounds=80, device=device)
    return {k: v for k, v in out.items() if k != "wall_s"}, res.state


def watchdog_trip(device: str) -> dict:
    """tests/test_watchdog.py's trip setup on ``device`` (N=16 full mesh,
    metrics, a 16-round flight ring, the watchdog in trip mode with a
    ledger breach injected 20 rounds after the boot) with an
    anti-entropy model and a broadcast from node 0, so that the ring
    records wire traffic (without a model the full mesh sends nothing on
    the wire: its ring is [16, 16, 0, 12] and nothing is launched), one
    round a call: every round's leaves and the interleave launches of
    each round."""
    from partisan_tpu_torch import kernels
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config, WatchdogConfig
    from partisan_tpu_torch.models.anti_entropy import AntiEntropy

    inject = WD_BOOT + 20
    cfg = Config(n_nodes=WD_N, seed=7, inbox_cap=max(32, WD_N + 8),
                 metrics=True, metrics_ring=32, flight_rounds=16,
                 watchdog=WatchdogConfig(enabled=True, ring=16,
                                         trip_flight=True,
                                         inject_round=inject,
                                         inject_amount=3))
    model = AntiEntropy()
    cl = Cluster(cfg, model=model, device=device)
    st = cl.init()
    m = st.manager
    for i in range(1, WD_N):
        m = cl.manager.join(cfg, m, i, 0)
    st = cl.steps(st._replace(manager=m), WD_BOOT)
    st = st._replace(model=model.broadcast(st.model, 0, 0))
    leaves, launches = [], []
    for _ in range(WD_ROUNDS):
        before = kernels.launches["interleave"]
        st = cl.steps(st, 1)
        launches.append(kernels.launches["interleave"] - before)
        leaves.append(state_leaves(st))
    return {"leaves": leaves, "launches": launches, "state": st,
            "inject": inject}


def soak_cfg(n: int = 32):
    """tests/test_torch_soak.py's cluster: every plane the soak engine
    polls."""
    from partisan_tpu_torch.config import (Config, ControlConfig,
                                           PlumtreeConfig, TrafficConfig,
                                           WatchdogConfig)

    return Config(n_nodes=n, seed=4, peer_service_manager="hyparview",
                  msg_words=16, partition_mode="groups", max_broadcasts=4,
                  plumtree=PlumtreeConfig(push_slots=2, lazy_cap=4),
                  metrics=True, metrics_ring=64, latency=True,
                  flight_rounds=4, health=5, health_ring=32, provenance=True,
                  provenance_ring=64,
                  control=ControlConfig(fanout=True, healing=True),
                  traffic=TrafficConfig(enabled=True, rate_x1000=300,
                                        ring=32),
                  watchdog=WatchdogConfig(enabled=True, ring=64))


def storm_soaks(device: str) -> list:
    """A 42-round storm soak of the soak-engine cluster at chunk_fixed 7
    and K_PROG, each equal to ``soak.reference_run`` (each storm gap one
    ``steps`` call); returns the reference run's leaves."""
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch import soak
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    cl = Cluster(soak_cfg(), model=Plumtree(), device=device)
    n = cl.cfg.n_nodes
    st = cl.init()
    st = cl.steps(st._replace(manager=cl.manager.join_many(
        cl.cfg, st.manager, list(range(1, n)), [0] * (n - 1))), 10)
    r0 = int(st.rnd)
    storm = sc.config7_storm(r0, 40)
    ref = soak.reference_run(cl, st, r0 + 42, storm)
    for chunk in (7, sc.K_PROG):
        res = soak.Soak(make_cluster=lambda: cl, storm=storm,
                        invariants=[soak.conservation()],
                        cfg=soak.SoakConfig(chunk_fixed=chunk)).run(
            st, rounds=42)
        assert_identical(res.state, ref, f"soak at chunk {chunk} on "
                                         f"{device}")
    return state_leaves(ref)


def hook_reads(card: str) -> dict:
    """Host reads and launches per round of the soak-engine cluster
    without its traffic plane and watchdog against the same state with
    both on (the traffic rate 0 and no breach, so the protocol runs the
    same branches) and the flight ring's trip gate armed: the hooks add
    no host read."""
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch import watchdog, workload
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import TrafficConfig, WatchdogConfig
    from partisan_tpu_torch.models.plumtree import Plumtree

    from partisan_tpu_torch import latency

    on_cfg = soak_cfg(512).replace(
        traffic=TrafficConfig(enabled=True, rate_x1000=0, churn=True),
        watchdog=WatchdogConfig(enabled=True, trip_flight=True))
    off_cfg = on_cfg.replace(traffic=TrafficConfig(),
                             watchdog=WatchdogConfig())
    model = Plumtree()
    off = Cluster(off_cfg, model=model)
    on = Cluster(on_cfg, model=model)
    n = off_cfg.n_nodes
    st = off.init()
    st = off.steps(st._replace(manager=off.manager.join_many(
        off_cfg, st.manager, list(range(1, n)), [0] * (n - 1))), 20)
    dev = st.rnd.device
    st_on = st._replace(traffic=workload.init(on_cfg, device=dev),
                        watchdog=watchdog.init(on_cfg, device=dev))
    # the arrival block widens the wire stack the ring records
    st_on = st_on._replace(flight=latency.flight_init(
        on_cfg, on.flight_shape(st_on), device=dev))
    w_off = round_profile(lambda: off.steps(st, sc.K_PROG), sc.K_PROG)
    w_on = round_profile(lambda: on.steps(st_on, sc.K_PROG), sc.K_PROG)
    if w_on["host_reads_per_round"] != w_off["host_reads_per_round"]:
        raise AssertionError(f"the traffic and watchdog hooks add host "
                             f"reads: {w_on} vs {w_off}")
    return {"card": card, "n": n, "window_off": w_off, "window_on": w_on}


def traffic_parity(card: str) -> dict:
    """Phase 22: the traffic plane, the watchdog's trip mode and the soak
    engine, small, on the card and on the CPU."""
    from partisan_tpu_torch import kernels, latency

    out: dict = {"card": card}
    for name, n in TRAFFIC_SMALL:
        t0 = time.perf_counter()
        g, gst = traffic_run(name, n, "cuda")
        t_card = time.perf_counter() - t0
        c, cst = cpu_half(f"traffic_{name}")
        if g != c:
            raise AssertionError(f"traffic_scenario({name!r}, n={n}): card "
                                 f"{g} != CPU {c}")
        if not (g["app_ok"] and g["control_ok"] and g["breaches"] == 0):
            raise AssertionError(f"traffic_scenario({name!r}): {g}")
        out[name] = {"n": n, "leaves": assert_identical(gst, cst, name),
                     "card_s": t_card, "sent": g["traffic"]["sent"],
                     "bulk_p99": g["bulk_p99"]}
    k0 = dict(kernels.launches)
    g = watchdog_trip("cuda")
    c = cpu_half("watchdog_trip")
    assert_rounds_identical(g["leaves"], c["leaves"], "watchdog trip")
    inject = g["inject"]
    want = [1 if WD_BOOT + i <= inject else 0 for i in range(WD_ROUNDS)]
    if g["launches"] != want:
        raise AssertionError(f"trip mode: interleave launches {g['launches']}"
                             f" per round, want {want}")
    ring = [int(r) for r in latency.flight_trace(g["state"].flight).rounds]
    if ring != list(range(inject - 15, inject + 1)):
        raise AssertionError(f"trip mode: the ring holds rounds {ring}")
    out["watchdog_trip"] = {"rounds": WD_ROUNDS, "inject": inject,
                            "ring_rounds": [ring[0], ring[-1]],
                            "interleave_launches": sum(g["launches"])}
    k1 = kernels.launches["interleave"]
    assert_leaves_identical(storm_soaks("cuda"), cpu_half("storm_soaks"),
                            "storm soak")
    out["storm_soak"] = {"rounds": 42, "chunks": [7, 10],
                         "interleave_launches":
                         kernels.launches["interleave"] - k1}
    out["hook_reads"] = hook_reads(card)
    out["launches"] = {k: kernels.launches[k] - k0[k] for k in k0}
    return out


def strip_wall(obj):
    if isinstance(obj, dict):
        return {k: strip_wall(v) for k, v in obj.items() if k != "wall_s"}
    return obj


def traffic_slo_full(card: str) -> dict:
    """Phase 23: ``scenarios.traffic_slo(1.0)`` on the card with the ops
    journal on (``scenarios.OPS``).  Every scenario dict (both arms where
    the suite runs two), its ``ops`` counts and verdict included, must
    equal the JAX package's (``JAX_TRAFFIC_SLO``) and ``pass`` must
    hold.  Per run: its wall and the chunks' ms per round (it runs in the
    card worker, which profiles nothing)."""
    from partisan_tpu_torch import scenarios as sc

    runs: dict = {}

    def on_run(name, arm, d, res, cl):
        chunk_s = sum(row["wall_s"] for row in res.chunks)
        runs[f"{name}_{arm}"] = {
            "n": d["n"], "rounds": d["rounds"], "wall_s": d["wall_s"],
            "chunk_ms_per_round": chunk_s * 1e3 / d["rounds"]}

    t0 = time.perf_counter()
    sc.OPS = True
    suite = sc.traffic_slo(1.0, on_run=on_run)
    sc.OPS = False
    wall = time.perf_counter() - t0
    got = json.loads(json.dumps(strip_wall(suite)))
    for name, entry in JAX_TRAFFIC_SLO["scenarios"].items():
        for key, want in entry.items():
            have = got["scenarios"][name].get(key)
            if key in ("adaptive", "static"):
                have = strip_wall(have)
            if have != want:
                raise AssertionError(f"traffic_slo {name} {key}: card "
                                     f"{have} != JAX {want}")
    for key in ("bound", "scale", "wins", "isolation_scenarios", "pass"):
        if got[key] != JAX_TRAFFIC_SLO[key]:
            raise AssertionError(f"traffic_slo {key}: card {got[key]} != "
                                 f"JAX {JAX_TRAFFIC_SLO[key]}")
    if got["pass"] is not True:
        raise AssertionError("traffic_slo: pass is not true")
    return {"card": card, "wall_s": wall, "pass": got["pass"],
            "wins": got["wins"],
            "isolation_scenarios": got["isolation_scenarios"],
            "runs": runs}


def config7_full(card: str) -> dict:
    """Phase 24: config 7 at the reference's width on the card (n=10,000,
    400 rounds: two storm periods, the storm every 200) with the ops
    journal on.  No breach, no retry; the rounds, health, components, the
    ops journal's counts and verdict (ok: every span closed), final
    Stats, digest and every leaf (by hash) equal the JAX package's
    (``JAX_CONFIG7``).  Its chunks,
    programs, rounds/s, the wall per round of storm chunks (rounds 60-140
    of a period: a crash batch, then the partition) and of calm ones
    (rounds 180-200, healed and revived), a profiled storm round (the
    partition and link drop applied to the final state) and a calm
    window, and the peak memory."""
    from partisan_tpu_torch import health
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch import soak

    want = JAX_CONFIG7
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc.OPS = True
    out, res, cl = sc._config7_run(n=want["n"], rounds=want["rounds"],
                                   storm_period=want["storm_period"])
    sc.OPS = False
    wall = time.perf_counter() - t0
    st = res.state
    got = {k: out[k] for k in ("n", "rounds", "storm_period", "breaches",
                               "retries", "components", "healthy", "ops")}
    got.update(rnd=int(st.rnd), digest=health.digest(st),
               stats={k: int(v) for k, v in st.stats._asdict().items()})
    got["state_sha"] = hold_to(want, got, st, "config 7")
    if got["breaches"] or got["retries"]:
        raise AssertionError(f"config 7: {got}")
    p, start = want["storm_period"], res.start

    def per_round(lo, hi):
        rows = [r for r in res.chunks
                if lo <= (r["round"] - start) % p < hi]
        return {"chunks": len(rows),
                "ms_per_round": sum(r["wall_s"] for r in rows) * 1e3
                / max(1, sum(r["k"] for r in rows))}

    r = int(st.rnd)
    stormy = soak.Partition().apply(cl, soak.LinkDrop(0.2).apply(
        cl, st, r), r)
    return {"card": card, **got, "chunks": out["chunks"],
            "programs": out["programs"], "wall_s": wall,
            "soak_wall_s": out["wall_s"],
            "rounds_per_s": out["rounds_per_sec"],
            "chunk_k": sorted({row["k"] for row in res.chunks}),
            "storm_chunks": per_round(60, 140),
            "calm_chunks": per_round(180, 200),
            "window_storm": round_profile(lambda: cl.steps(stormy, 1), 1),
            "window_calm": round_profile(lambda: cl.steps(st, sc.K_PROG),
                                         sc.K_PROG),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def blackbox_full(card: str) -> dict:
    """Phase 25: config 7's Config at n=10,000 with the metrics plane, a
    BLACKBOX_RING-round flight ring and the watchdog in trip mode, a
    ledger breach injected 100 rounds after the boot, through ``Soak``
    for one storm period with a dump directory.  The health plane is off
    here: config 7's overlay runs below its min-degree target, so the
    watchdog's digest bit would latch before the injected breach.  The
    breach must be logged at the inject round, the interleave must
    launch once a round up to it and never after, and the dumped flight
    trace must load and hold rounds inject-15 ... inject.  The kernel is
    held against its plain version, bit for bit, at the ring's per-round
    shape and dtypes.  Then ms per round with the ring and the watchdog
    against neither (no breach; in turns), the ring's bytes and the
    kernel's device time per launch."""
    import shutil

    from partisan_tpu_torch import kernels, latency
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch import soak, trace, watchdog
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import WatchdogConfig
    from partisan_tpu_torch.models.plumtree import Plumtree

    n = JAX_CONFIG7["n"]
    p = JAX_CONFIG7["storm_period"]
    base = sc.config7_cfg(n).replace(health=0, metrics=True)
    model = Plumtree()
    plain = Cluster(base, model=model)
    boot = sc._boot_overlay(plain, n)
    start = int(boot.rnd)
    inject = start + 100

    def armed(cfg):
        cl = Cluster(cfg, model=model)
        dev = boot.rnd.device
        st = boot._replace(watchdog=watchdog.init(cfg, device=dev))
        return cl, st._replace(flight=latency.flight_init(
            cfg, cl.flight_shape(st), device=dev))

    cfg = base.replace(flight_rounds=BLACKBOX_RING, watchdog=WatchdogConfig(
        enabled=True, ring=64, trip_flight=True, inject_round=inject))
    cl, st = armed(cfg)
    dump = "build/blackbox"
    shutil.rmtree(dump, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = soak.Soak(make_cluster=lambda: cl,
                    storm=sc.config7_storm(start, p),
                    invariants=[soak.conservation()],
                    cfg=soak.SoakConfig(checkpoint_every=10 * sc.K_PROG,
                                        dump_dir=dump)).run(st, rounds=p)
    wall = time.perf_counter() - t0
    soak_launches = kernels.launches["interleave"]
    breaches = [e for e in res.log if e["kind"] == "invariant_breach"]
    if [(e["round"], e["invariant"]) for e in breaches] \
            != [(inject, "watchdog")]:
        raise AssertionError(f"black box: breaches {breaches}")
    if soak_launches != inject - start + 1:
        raise AssertionError(f"black box: {soak_launches} interleave "
                             f"launches for {inject - start + 1} rounds up "
                             "to the breach")
    flight = [x for x in breaches[0]["dumps"] if x.endswith("_flight.npz")]
    tr = trace.Trace.load(flight[0])
    ring = [int(r) for r in tr.rounds]
    if ring != list(range(inject - BLACKBOX_RING + 1, inject + 1)):
        raise AssertionError(f"black box: the dump holds rounds {ring}")
    shape = list(st.flight.sent.shape)
    ring_bytes = st.flight.sent.numel() * 4 + st.flight.dropped.numel()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the kernel against its plain version at the ring's per-round shape
    # and the planes' dtypes (these launches are not the path's: the
    # counts are reset below)
    _, edges, words = cl.flight_shape(boot)
    if words != len(cfg.wire_dtypes) or shape[1:] != [n, edges, words]:
        raise AssertionError(f"black box: ring {shape}, flight_shape "
                             f"{(n, edges, words)}, {len(cfg.wire_dtypes)} "
                             "wire dtypes")
    ring_check = kernel_check((n, edges), list(cfg.wire_dtypes), seed=25)
    # the ring and the watchdog (no breach) against neither, in turns
    rw, st_rw = armed(base.replace(
        flight_rounds=BLACKBOX_RING,
        watchdog=WatchdogConfig(enabled=True, ring=64, trip_flight=True)))
    kernels.reset_launches()
    w_plain = [round_profile(lambda: plain.steps(boot, sc.K_PROG),
                             sc.K_PROG)]
    w_ring = [round_profile(lambda: rw.steps(st_rw, sc.K_PROG), sc.K_PROG,
                            kernel="interleave") for _ in range(2)]
    w_plain.append(round_profile(lambda: plain.steps(boot, sc.K_PROG),
                                 sc.K_PROG))
    win_launches = kernels.launches["interleave"]
    return {"card": card, "n": n, "start": start, "inject": inject,
            "breach_round": breaches[0]["round"], "soak_wall_s": wall,
            "soak_rounds": res.rounds, "chunks": len(res.chunks),
            "ring_rounds": [ring[0], ring[-1]], "ring_shape": shape,
            "ring_mib": ring_bytes / 2 ** 20, "peak_mem_gib": peak,
            "soak_interleave_launches": soak_launches,
            "window_plain": w_plain, "window_ring_watchdog": w_ring,
            "kernel_device_ms_per_launch":
            [w["interleave_device_ms_per_launch"] for w in w_ring],
            "ring_kernel_check": ring_check,
            "launches": {"interleave": soak_launches + win_launches,
                         "minimal": 0}}


def elastic_cfg(n: int, rate: int, ring: int = 256):
    """tests/test_elastic.py's configuration with the metrics plane and
    traffic at ``rate``."""
    from partisan_tpu_torch.config import (Config, PlumtreeConfig,
                                           TrafficConfig)

    return Config(n_nodes=n, seed=5, peer_service_manager="hyparview",
                  msg_words=16, partition_mode="groups", max_broadcasts=8,
                  inbox_cap=16, timer_stagger=False, width_operand=True,
                  elastic=True, metrics=True, metrics_ring=ring,
                  plumtree=PlumtreeConfig(push_slots=2, lazy_cap=4),
                  traffic=TrafficConfig(enabled=True, rate_x1000=rate,
                                        burst_max=2))


def elastic_boot(cl, w: int, k: int = 20):
    """tests/test_elastic.py's prefix boot: activate the w-prefix, join
    it in waves of factor 4 (default_rng(7) contacts), 10 rounds a wave,
    then k rounds."""
    from partisan_tpu_torch.cluster import activate

    st = activate(cl.init(), w)
    rng = np.random.default_rng(7)
    base = 1
    while base < w:
        hi = min(base * 4, w)
        nodes = np.arange(base, hi, dtype=np.int32)
        tgts = rng.integers(0, base, size=nodes.shape[0]).astype(np.int32)
        st = cl.steps(st._replace(manager=cl.manager.join_many(
            cl.cfg, st.manager, nodes, tgts)), 10)
        base = hi
    return cl.steps(st, k)


def file_sha(path: str) -> dict:
    """A spool file's sha256 and line count (the tool's keys)."""
    import hashlib

    with open(path, "rb") as f:
        data = f.read()
    return {"spool_sha": hashlib.sha256(data).hexdigest(),
            "spool_lines": data.count(b"\n")}


def hold_to(want: dict, got: dict, st, label: str) -> str:
    """Every key of ``want`` (a JAX_CONFIG* constant) but the leaf hashes
    equals ``got``'s; the leaf hashes by their digest, naming the leaves
    that differ.  Returns the digest."""
    import hashlib

    hashes = state_hashes(st)["leaf_hashes"]
    got = dict(got, state_sha=hashlib.sha256("".join(hashes).encode())
               .hexdigest()[:16])
    for key, w in want.items():
        if key == "leaf_hashes":
            continue
        if got.get(key) != w:
            bad = [p for (p, _), h, x in zip(state_leaves(st), hashes,
                                             want["leaf_hashes"]) if h != x]
            raise AssertionError(f"{label} {key}: card {got.get(key)} != "
                                 f"JAX {w} (leaves differing: {bad})")
    return got["state_sha"]


def config9_got(out: dict, st) -> dict:
    """Config 9's dict in the tool's terms: no wall or chunk count, plus
    the final round, Stats and digest."""
    from partisan_tpu_torch import health

    got = {k: v for k, v in out.items() if k not in ("wall_s", "chunks")}
    got = json.loads(json.dumps(got))
    got.update(rnd=int(st.rnd), digest=health.digest(st),
               stats={k: int(v) for k, v in st.stats._asdict().items()})
    return got


def redirect_run(device: str):
    """tests/test_elastic.py's redirect setup on ``device``: n=32 booted
    at full width, ScaleIn(8, drain=200), record(12)."""
    from partisan_tpu_torch import elastic
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    cl = Cluster(elastic_cfg(32, 800, ring=128), model=Plumtree(),
                 device=device)
    st = elastic_boot(cl, 32)
    st = elastic.ScaleIn(8, drain=200).apply(cl, st, int(st.rnd))
    return cl.record(st, 12)


def equivalence_modes(device: str, rounds: int, rate: int, make_cfg, boot,
                      slots: int, window: int, timing: dict | None = None):
    """The delivery-equivalence setup on ``device``; ``make_cfg(traffic_on,
    ingress)`` builds the config with the traffic plane on or off (at rate
    0).  (A) in-round arrivals at rate 0 through the boot, SetRate(rate)
    at the window's start; (B) the traffic plane off and the ingress lane
    on, the same arrivals
    mirrored on the host by trace_arrivals, offered to a ring and drained
    by IngressFeed(window).  Both arms through Soak at chunk_fixed
    ``window``.  Returns (state A, state B, requests, chunk rows A, chunk
    rows B, cluster A, cluster B); with ``timing``, the host seconds of
    each boundary's stage land in ``timing["stage_s"]``."""
    from partisan_tpu_torch import ingress, soak, workload
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import IngressConfig
    from partisan_tpu_torch.models.plumtree import Plumtree

    cfg_a = make_cfg(True, IngressConfig(enabled=False))
    cfg_b = make_cfg(False, IngressConfig(enabled=True, slots=slots,
                                          quota=0))
    cl_a = Cluster(cfg_a, model=Plumtree(), device=device)
    cl_b = Cluster(cfg_b, model=Plumtree(), device=device)
    st_a, st_b = boot(cl_a), boot(cl_b)
    r0 = int(st_a.rnd)
    if int(st_b.rnd) != r0:
        raise AssertionError("the two arms' boots end on different rounds")
    res_a = soak.Soak(
        make_cluster=lambda: cl_a,
        storm=soak.Storm(events=((0, workload.SetRate(rate)),), start=r0),
        cfg=soak.SoakConfig(chunk_fixed=window)).run(st_a, rounds=rounds)
    reqs = workload.trace_arrivals(cfg_a, r0, r0 + rounds, rate_x1000=rate,
                                   alive=st_b.faults.alive.cpu().numpy())
    ring = ingress.IngressRing(cap=len(reqs) + 1)
    ring.offer(reqs)
    stage = ingress.stage
    if timing is not None:
        timing["stage_s"] = []

        def timed_stage(*a, **kw):
            t0 = time.perf_counter()
            out = stage(*a, **kw)
            timing["stage_s"].append(time.perf_counter() - t0)
            return out

        ingress.stage = timed_stage
    try:
        res_b = soak.Soak(
            make_cluster=lambda: cl_b,
            ingress=ingress.IngressFeed(ring=ring, window=window),
            cfg=soak.SoakConfig(chunk_fixed=window)).run(st_b, rounds=rounds)
    finally:
        ingress.stage = stage
    return (res_a.state, res_b.state, reqs, res_a.chunks, res_b.chunks,
            cl_a, cl_b)


def check_modes(st_a, st_b, label: str) -> dict:
    """The two arrival modes agree: Stats and the metrics plane's emitted
    and delivered series; nothing shed."""
    from partisan_tpu_torch import ingress, metrics

    sa = [int(x) for x in st_a.stats]
    sb = [int(x) for x in st_b.stats]
    if sa != sb:
        raise AssertionError(f"{label}: Stats in-round {sa} != ring {sb}")
    ma, mb = metrics.snapshot(st_a.metrics), metrics.snapshot(st_b.metrics)
    for key in ("rounds", "emitted", "delivered"):
        if not np.array_equal(ma[key], mb[key]):
            raise AssertionError(f"{label}: the metrics {key} series differ "
                                 "between the arrival modes")
    shed = ingress.poll(st_b.ingress)["shed"]
    if shed:
        raise AssertionError(f"{label}: {shed} requests shed")
    return {"stats": dict(zip(("emitted", "delivered", "dropped"), sa)),
            "injected": ingress.poll(st_b.ingress)["injected"]}


def ingress_small_cfg(traffic_on: bool, ing):
    """tests/test_ingress.py's configuration (n=24) with the metrics
    plane, the traffic plane on or off at rate 0."""
    from partisan_tpu_torch.config import (Config, PlumtreeConfig,
                                           TrafficConfig)

    return Config(n_nodes=24, seed=5, peer_service_manager="hyparview",
                  msg_words=16, partition_mode="groups", max_broadcasts=8,
                  inbox_cap=24, timer_stagger=False, metrics=True,
                  metrics_ring=128,
                  plumtree=PlumtreeConfig(push_slots=2, lazy_cap=4),
                  traffic=TrafficConfig(enabled=traffic_on, rate_x1000=0,
                                        burst_max=2), ingress=ing)


def staggered_boot(cl, settle: int = 20):
    """tests/support.py's boot_hyparview: each node joins via node 0,
    four a round pair, then ``settle`` rounds."""
    st = cl.init()
    for base in range(1, cl.cfg.n_nodes, 4):
        m = st.manager
        for i in range(base, min(base + 4, cl.cfg.n_nodes)):
            m = cl.manager.join(cl.cfg, m, i, 0)
        st = cl.steps(st._replace(manager=m), 2)
    return cl.steps(st, settle)


EQUIVALENCE_SMALL = (24, 400, ingress_small_cfg, staggered_boot, 16, 6)


def ingress_record(device: str):
    """The ingress-armed cluster (n=24, 8 slots) booted, three requests
    staged for two and four rounds ahead, then record(6)."""
    from partisan_tpu_torch import ingress
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import IngressConfig
    from partisan_tpu_torch.models.plumtree import Plumtree

    cfg = ingress_small_cfg(False, IngressConfig(enabled=True, slots=8))
    cl = Cluster(cfg, model=Plumtree(), device=device)
    st = staggered_boot(cl)
    r = int(st.rnd)
    st, _, _ = ingress.stage(cfg, st, [(r + 2, 1, 5, 0, 91),
                                       (r + 2, 2, 6, 0, 91),
                                       (r + 4, 3, 7, 3, 91)], r)
    return cl, st, cl.record(st, 6)


def drain_checkpoint(device: str, path: str):
    """A drain interrupted by a checkpoint: n=48 booted at 32,
    ScaleIn(16, drain=20), 10 rounds, saved and restored into a fresh
    template, 31 more rounds; and the same 41 rounds uninterrupted.
    Returns (restored run, uninterrupted run)."""
    from partisan_tpu_torch import checkpoint, elastic
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    cl = Cluster(elastic_cfg(48, 400), model=Plumtree(), device=device)
    st = elastic_boot(cl, 32)
    st = elastic.ScaleIn(16, drain=20).apply(cl, st, int(st.rnd))
    mid = cl.steps(st, 10)
    checkpoint.save(mid, path, cfg=cl.cfg)
    back = checkpoint.restore(path, cl.init(), cfg=cl.cfg,
                              expect_rnd=int(mid.rnd))
    return cl.steps(back, 31), cl.steps(st, 41)


def elastic_parity(card: str) -> dict:
    """Phase 26: elasticity and ingress, small, on the card (against the
    JAX values or the CPU)."""
    import os

    from partisan_tpu_torch import elastic, kernels, workload
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch import types as T

    out: dict = {"card": card}
    k0 = dict(kernels.launches)
    # (a) config 9 at n=256 against the JAX package
    t0 = time.perf_counter()
    small, res, _ = sc._config9_run(n=JAX_CONFIG9_SMALL["n"])
    hold_to(JAX_CONFIG9_SMALL, config9_got(small, res.state), res.state,
            "config 9 at n=256")
    out["config9_small"] = {"n": small["n"], "pass": small["pass"],
                            "widths": small["widths"],
                            "wall_s": time.perf_counter() - t0}
    # (b) the redirect setup, card against CPU
    k1 = kernels.launches["interleave"]
    g_st, g_tr = redirect_run("cuda")
    rec_launches = kernels.launches["interleave"] - k1
    c_st, c_tr = cpu_half("redirect_run")
    assert_identical(g_st, c_st, "redirect state")
    assert_identical(g_tr, c_tr, "redirect trace")
    if rec_launches != 12:
        raise AssertionError(f"redirect record(12): {rec_launches} "
                             "interleave launches")
    sent = g_tr.sent.cpu().numpy()
    traffic = (sent[..., 0] == int(T.MsgKind.APP)) \
        & (sent[..., T.P0] == workload.TRAFFIC_OP)
    srcs = np.broadcast_to(np.arange(32)[None, :, None], traffic.shape)
    if not traffic.any() or np.any(traffic & (srcs >= 8)) \
            or np.any(traffic & (sent[..., 2] >= 8)):
        raise AssertionError("redirect: a draining row sourced or received "
                             "a traffic record")
    out["redirect"] = {"n": 32, "trace_shape": list(g_tr.sent.shape),
                       "traffic_records": int(traffic.sum()),
                       "interleave_launches": rec_launches}
    # (c) the ingress setups, card against CPU and mode against mode
    modes = {"cuda": equivalence_modes("cuda", *EQUIVALENCE_SMALL),
             "cpu": cpu_half("equivalence_modes")}
    for dev, (st_a, st_b, *_rest) in modes.items():
        check_modes(st_a, st_b, f"n=24 on {dev}")
    assert_identical(modes["cuda"][0], modes["cpu"][0], "in-round arm")
    assert_identical(modes["cuda"][1], modes["cpu"][1], "ring arm")
    out["equivalence"] = {"n": 24, "requests": len(modes["cuda"][2]),
                          **check_modes(*modes["cuda"][:2], "n=24")}
    del modes
    k1 = kernels.launches["interleave"]
    g_cl, g_st, (g_st2, g_tr) = ingress_record("cuda")
    rec_launches = kernels.launches["interleave"] - k1
    c_st2, c_tr = cpu_half("ingress_record")
    assert_identical(g_st2, c_st2, "ingress record state")
    assert_identical(g_tr, c_tr, "ingress record trace")
    if rec_launches != 6:
        raise AssertionError(f"ingress record(6): {rec_launches} "
                             "interleave launches")
    out["ingress_record"] = {"trace_shape": list(g_tr.sent.shape),
                             "interleave_launches": rec_launches}
    # (d) a checkpoint taken mid-drain on the card
    os.makedirs("build", exist_ok=True)
    back, whole = drain_checkpoint("cuda", "build/drain_mid.npz")
    assert_identical(back, whole, "mid-drain restore")
    sb, sw = elastic.snapshot(back.elastic), elastic.snapshot(whole.elastic)
    if not np.array_equal(sb["rounds"], sw["rounds"]) \
            or [int(w) for w in sb["widths"]] != [32, 16]:
        raise AssertionError(f"mid-drain restore: timeline {sb} vs {sw}")
    out["drain_checkpoint"] = {"widths": [int(w) for w in sb["widths"]],
                               "deactivated_round": int(sb["rounds"][-1])}
    out["launches"] = {k: kernels.launches[k] - k0[k] for k in k0}
    # the kernel against its plain version at the ingress record's
    # per-round shape (not the path's launches: counted above)
    _, edges, _ = g_cl.flight_shape(g_st)
    out["ingress_record"]["kernel_check"] = kernel_check(
        (24, edges), list(g_cl.cfg.wire_dtypes), seed=26)
    return out


def config9_full(card: str) -> dict:
    """Phase 27: config 9 at n=8192 on the card with the ops journal on
    and a telemetry spool armed, against ``JAX_CONFIG9`` (the ops counts
    and verdict, the spool's sha256 and the chunk lengths included); its
    boot and soak walls, the spool's host seconds per boundary and in
    all, ms per round of the chunk classes, profiled windows before the
    scale-out and inside the drain (each beside the same state without
    the elastic carry), the peak memory."""
    import os

    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch import spool
    from partisan_tpu_torch.cluster import Cluster

    want = JAX_CONFIG9
    held: dict = {}
    P = sc.K_PROG

    def step_fn(c, s, k):
        # the states entering the first chunk (calm, before the crowd and
        # the scale-out) and the drain's first chunk (ScaleIn applied)
        off = int(s.rnd) - held.setdefault("start", int(s.rnd))
        if off in (0, 8 * P):
            held[off] = s
        return c.steps(s, k)

    path = "build/config9.spool.jsonl"
    if os.path.exists(path):
        os.remove(path)
    sp = spool.Spool(path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc.OPS = True
    out, res, cl = sc._config9_run(n=want["n"], step_fn=step_fn, spool=sp)
    sc.OPS = False
    wall = time.perf_counter() - t0
    sp.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # pass and overlay_ok included: both false, as in the JAX package.
    # The spool's bytes depend on where chunks end: the card's chunk
    # lengths are held to the tool's (chunks end only where they must)
    got = config9_got(out, res.state)
    got.update(file_sha(path), chunk_k=[r["k"] for r in res.chunks])
    hold_to(want, got, res.state, "config 9")
    start = res.start
    spool_s = [r["spool_s"] for r in res.chunks]

    def per_round(lo, hi):
        rows = [r for r in res.chunks if lo <= r["round"] - start < hi]
        return {"chunks": len(rows), "rounds": sum(r["k"] for r in rows),
                "ms_per_round": sum(r["wall_s"] for r in rows) * 1e3
                / max(1, sum(r["k"] for r in rows))}

    no_elastic = Cluster(cl.cfg.replace(elastic=False), model=cl.model)
    windows = {}
    for name, off in (("calm", 0), ("drain", 8 * P)):
        st = held[off]
        w_on = round_profile(lambda st=st: cl.steps(st, P), P)
        w_off = round_profile(
            lambda st=st: no_elastic.steps(st._replace(elastic=()), P), P)
        if w_on["host_reads_per_round"] != w_off["host_reads_per_round"]:
            raise AssertionError(f"the elastic stage adds host reads in "
                                 f"the {name} window: {w_on} vs {w_off}")
        windows[name] = {"elastic": w_on, "without_elastic": w_off}
    return {"card": card, "n": out["n"], "rounds": out["rounds"],
            "widths": out["widths"], "n_active": out["n_active"],
            "pass": out["pass"], "overlay_ok": out["overlay_ok"],
            "traffic": out["traffic"], "breaches": out["breaches"],
            "chunks": out["chunks"], "wall_s": wall,
            "soak_s": out["wall_s"], "boot_and_report_s": wall - out["wall_s"],
            "chunk_k": [r["k"] for r in res.chunks],
            "ops": out["ops"], "spool_lines": got["spool_lines"],
            "spool_s_per_boundary": spool_s, "spool_s": sum(spool_s),
            "scale_out_chunks": per_round(2 * P, 4 * P),
            "crash_chunks": per_round(4 * P, 8 * P),
            "drain_chunks": per_round(8 * P, 11 * P),
            "calm_chunks": per_round(11 * P, 17 * P),
            "windows": windows, "peak_mem_gib": peak}


def ingress_full(card: str) -> dict:
    """Phase 28: the delivery-equivalence setup at config 9's width and
    overlay (n=8192 booted by config 9's join waves at full width, 60
    rounds, chunk_fixed K_PROG, slots 16, no quota, no compaction)."""
    import dataclasses

    from partisan_tpu_torch import scenarios as sc

    n, rounds, P = JAX_CONFIG9["n"], 60, sc.K_PROG
    base = sc.config9_cfg(n)

    def make_cfg(traffic_on, ing):
        return base.replace(
            traffic=dataclasses.replace(base.traffic, enabled=traffic_on,
                                        rate_x1000=0),
            ingress=ing, emit_compact=0)

    timing: dict = {}
    t0 = time.perf_counter()
    st_a, st_b, reqs, rows_a, rows_b, cl_a, cl_b = equivalence_modes(
        "cuda", rounds, base.traffic.rate_x1000, make_cfg,
        lambda cl: sc.config9_boot(cl, n), 16, P, timing=timing)
    wall = time.perf_counter() - t0
    got = check_modes(st_a, st_b, f"n={n}")
    # K_PROG rounds on from each final state: the traffic plane at the
    # window's rate against the ingress lane with nothing staged (its
    # release block still built: the copies it adds)
    windows = {"in_round": round_profile(lambda: cl_a.steps(st_a, P), P),
               "ring": round_profile(lambda: cl_b.steps(st_b, P), P)}

    def ms(rows):
        return sum(r["wall_s"] for r in rows) * 1e3 \
            / max(1, sum(r["k"] for r in rows))

    return {"card": card, "n": n, "rounds": rounds, "requests": len(reqs),
            **got, "stage_s": timing["stage_s"],
            "ms_per_round_in_round": ms(rows_a),
            "ms_per_round_ring": ms(rows_b), "windows": windows,
            "wall_s": wall}


SPOOL_N = 16                # tests/test_spool.py's storm soak
SPOOL_ROUNDS = 60
SPOOL_KILL_AT = 30
PHASE29_FLIGHT = 4          # phase 29's flight ring rounds


def spool_fixture(device: str) -> dict:
    """tests/test_spool.py's storm soak on ``device`` (n=16, 16-row rings,
    a partition at +4 healed at +10, 60 rounds at chunk_fixed 10), spooled
    three ways: uninterrupted, killed at +30 and resumed by a fresh
    engine and cluster on the same file, pipelined at depth 2.  Returns
    each regime's spool bytes and final state."""
    import os
    import shutil

    from partisan_tpu_torch import soak, spool
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config, ControlConfig
    from partisan_tpu_torch.models.plumtree import Plumtree

    cfg = Config(n_nodes=SPOOL_N, seed=5, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups", metrics=True,
                 metrics_ring=16, latency=True, health=1, health_ring=16,
                 control=ControlConfig(healing=True))

    def mk():
        return Cluster(cfg, model=Plumtree(), device=device)

    cl = mk()
    st = cl.init()
    st = cl.steps(st._replace(manager=cl.manager.join_many(
        cfg, st.manager, list(range(1, SPOOL_N)), [0] * (SPOOL_N - 1))), 20)
    st = cl.steps(st._replace(model=cl.model.broadcast(
        st.model, 0, 0, int(st.rnd))), 5)
    r0 = int(st.rnd)

    def storm():
        return soak.Storm(events=((4, soak.Partition()), (10, soak.Heal())),
                          start=r0, period=0)

    def scfg(**kw):
        return soak.SoakConfig(chunk_fixed=10, poll_latency=True, **kw)

    root = f"build/spool_fixture_{device}"
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}

    def spooled(name, runs):
        path = os.path.join(root, f"{name}.jsonl")
        res = None
        for make, kw, run_kw in runs:
            sp = spool.Spool(path)
            res = soak.Soak(make_cluster=make, storm=storm(), cfg=scfg(**kw),
                            spool=sp).run(**run_kw)
            sp.close()
        with open(path, "rb") as f:
            out[name] = (f.read(), res.state)

    spooled("ref", [(lambda: cl, {}, dict(state=st, rounds=SPOOL_ROUNDS))])
    ckpt = os.path.join(root, "ckpt")
    spooled("kill_restore", [
        (lambda: cl, dict(checkpoint_dir=ckpt),
         dict(state=st, until_round=r0 + SPOOL_KILL_AT)),
        (mk, dict(checkpoint_dir=ckpt),
         dict(resume=True, until_round=r0 + SPOOL_ROUNDS))])
    spooled("pipelined", [(lambda: cl,
                           dict(pipeline_depth=2, checkpoint_every=20),
                           dict(state=st, rounds=SPOOL_ROUNDS))])
    return out


def spool_pipeline(card: str) -> dict:
    """Phase 29: the spool and pipelined dispatch.  (a) The spool fixture
    on the card and on the CPU: all six files byte for byte equal, the
    final states identical.  (b) Config 7's Config at n=10,000 with a
    PHASE29_FLIGHT-round flight ring, booted as config 7 boots, for
    JAX_PHASE29's rounds (half a storm period) through Soak at chunk_fixed
    K_PROG with checkpoints every 10 * K_PROG, at depth 1 and at depth 2, each with a spool: the final
    states identical leaf for leaf, the spools byte for byte, both equal
    to the JAX package's (``JAX_PHASE29``).  Per depth: the wall, the
    pipelined rows' busy_s against wall_s, perfwatch.decompose_chunks'
    gap_share and spool_s."""
    import hashlib
    import os

    from partisan_tpu_torch import kernels, perfwatch, soak, spool
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    t0 = time.perf_counter()
    fx = {"cuda": spool_fixture("cuda"), "cpu": cpu_half("spool_fixture")}
    want = fx["cpu"]["ref"][0]
    for dev, regimes in fx.items():
        for name, (data, st) in regimes.items():
            if data != want:
                raise AssertionError(f"spool fixture: {dev} {name} spool "
                                     "differs from the CPU's uninterrupted")
            assert_identical(st, fx["cpu"]["ref"][1],
                             f"spool fixture {dev} {name}")
    fixture = {"n": SPOOL_N, "rounds": SPOOL_ROUNDS,
               "spool_sha": hashlib.sha256(want).hexdigest(),
               "spool_lines": want.count(b"\n"),
               "seconds": time.perf_counter() - t0}
    del fx

    want = JAX_PHASE29
    n, rounds, P = want["n"], want["rounds"], sc.K_PROG
    cfg = sc.config7_cfg(n).replace(flight_rounds=PHASE29_FLIGHT)
    cl = Cluster(cfg, model=Plumtree())
    kernels.reset_launches()
    t0 = time.perf_counter()
    boot = sc._boot_overlay(cl, n)
    sc._sync(boot)
    boot_s = time.perf_counter() - t0
    start = int(boot.rnd)
    runs = {}
    for depth in (1, 2):
        path = f"build/phase29_depth{depth}.spool.jsonl"
        if os.path.exists(path):
            os.remove(path)
        sp = spool.Spool(path)
        t0 = time.perf_counter()
        res = soak.Soak(
            make_cluster=lambda: cl, storm=sc.config7_storm(start, 200),
            invariants=[soak.conservation()], spool=sp,
            cfg=soak.SoakConfig(chunk_fixed=P, checkpoint_every=10 * P,
                                pipeline_depth=depth)).run(boot,
                                                           rounds=rounds)
        sc._sync(res.state)
        wall = time.perf_counter() - t0
        sp.close()
        got = {"n": n, "rounds": res.rounds, "start": start,
               "flight_rounds": PHASE29_FLIGHT, "chunks": len(res.chunks),
               "breaches": res.breaches, "rnd": int(res.state.rnd),
               **file_sha(path)}
        sha = hold_to(want, got, res.state, f"phase 29 depth {depth}")
        piped = [r for r in res.chunks if r.get("pipelined")]
        if (depth == 2) != bool(piped):
            raise AssertionError(f"phase 29 depth {depth}: {len(piped)} "
                                 "pipelined rows")
        if sum(r["k"] for r in res.chunks) != res.rounds:
            raise AssertionError(f"phase 29 depth {depth}: rows do not "
                                 "reconcile")
        dec = perfwatch.decompose_chunks(res.chunks)
        runs[depth] = {"state": res.state, "report": {
            "wall_s": wall, "ms_per_round": wall * 1e3 / rounds,
            "state_sha": sha, "spool_lines": got["spool_lines"],
            "pipelined_rows": len(piped),
            "busy_s": sum(r["busy_s"] for r in piped),
            "wall_s_pipelined_rows": sum(r["wall_s"] for r in piped),
            "chunk_wall_s": sum(r["wall_s"] for r in res.chunks),
            "spool_s": sum(r["spool_s"] for r in res.chunks),
            "decompose": dec}}
    assert_identical(runs[1]["state"], runs[2]["state"],
                     "phase 29 depth 1 vs depth 2")
    launches = dict(kernels.launches)
    return {"card": card, "fixture": fixture, "n": n, "rounds": rounds,
            "flight_rounds": PHASE29_FLIGHT, "boot_s": boot_s,
            "spool_sha": want["spool_sha"],
            "depth1": runs[1]["report"], "depth2": runs[2]["report"],
            "launches": launches}


# ---------------------------------------------------------------------------
# Phase 0: the CPU halves of the card == CPU phases, in a second process
# ---------------------------------------------------------------------------

class Sidecar:
    """A second process of this script (``chip_smoke.py FLAG``) that saves
    each result it computes to ``out_dir/<key>.pt`` (written aside, then
    renamed); :meth:`get` waits for a key and raises if the process ended
    without it, :meth:`stop` checks its exit (or ends it when the main
    process is failing)."""

    def __init__(self, flag: str, out_dir: str) -> None:
        self.flag, self.out_dir, self.proc = flag, out_dir, None

    def start(self) -> None:
        import shutil

        shutil.rmtree(self.out_dir, ignore_errors=True)
        os.makedirs(self.out_dir)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.flag],
            stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(self.out_dir, "stderr.log"), "w"))

    def get(self, key: str):
        path = os.path.join(self.out_dir, f"{key}.pt")
        while not os.path.exists(path):
            rc = self.proc.poll()
            if rc is not None and not os.path.exists(path):
                with open(os.path.join(self.out_dir, "stderr.log")) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"{self.flag} exited {rc} without "
                                   f"{key!r}:\n{tail}")
            time.sleep(0.05)
        return torch.load(path, weights_only=False)

    def go(self, key: str) -> None:
        """Let the process start ``key`` (see :func:`wait_go`)."""
        open(os.path.join(self.out_dir, f"{key}.go"), "w").close()

    def stop(self, check: bool) -> None:
        if self.proc is None:
            return
        if not check:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()
            return
        rc = self.proc.wait()
        if rc != 0:
            raise RuntimeError(f"{self.flag} exited {rc}")


CPU = Sidecar("--cpu-halves", CPU_DIR)
CARD = Sidecar("--card-worker", CARD_DIR)


def wait_go(out_dir: str, key: str) -> None:
    """Wait until the main process lets a sidecar start ``key``."""
    while not os.path.exists(os.path.join(out_dir, f"{key}.go")):
        time.sleep(0.2)


def saver(out_dir: str):
    os.makedirs(out_dir, exist_ok=True)

    def put(key, obj):
        tmp = os.path.join(out_dir, f"{key}.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, os.path.join(out_dir, f"{key}.pt"))

    return put


def cpu_halves() -> int:
    """The CPU-halves process (``chip_smoke.py --cpu-halves``, phase 0):
    every CPU half of the card == CPU parity phases, pinned to the CPU,
    in the order the main process reads them.  It uses no card."""
    from partisan_tpu_torch import scenarios as sc

    torch.set_num_threads(CPU_THREADS)
    put = saver(CPU_DIR)
    small = drive_small("cpu")
    put("drive_small", small)
    put("fb_setups", [result_fields(r) for r in fb_setups("cpu")])
    put("omission_record", omission_record("cpu", small[0]))
    del small
    for label, (name, kw) in SCENARIO_SMALL.items():
        put(f"scenario_{label}", run_scenario(name, kw, device="cpu"))
    put("health_convergence", health_convergence("cpu", 128))
    for label, (name, kw) in CAUSAL_SMALL.items():
        put(f"causal_{label}", run_scenario(name, kw, device="cpu"))
    put("lane_setups", lane_setups("cpu"))
    put("app_setups", app_setups("cpu"))
    put("harness_runs", harness_runs("cpu"))
    put("filibuster_paxos", filibuster_paxos("cpu"))
    for name in sc.APP_MODELS:
        run = sc.app_model(name, n=N_APP, rounds=APP_ROUNDS, device="cpu")
        put(f"app_model_{name}", {"state": run["state"],
                                  "run_s": run["run_s"]})
    put("planes_setups", planes_setups("cpu"))
    for name, n in TRAFFIC_SMALL:
        put(f"traffic_{name}", traffic_run(name, n, "cpu"))
    put("watchdog_trip", watchdog_trip("cpu"))
    put("storm_soaks", storm_soaks("cpu"))
    put("redirect_run", redirect_run("cpu"))
    put("equivalence_modes",
        equivalence_modes("cpu", *EQUIVALENCE_SMALL)[:3])
    put("ingress_record", ingress_record("cpu")[2])
    put("spool_fixture", spool_fixture("cpu"))
    put("xbot_small", xbot_small("cpu"))
    put("otp_small", otp_small("cpu"))
    put("trace16", trace16_run("cpu"))
    put("fleet_storm", fleet_storm("cpu"))
    return 0


def card_worker() -> int:
    """The card worker (``chip_smoke.py --card-worker``, started after
    phase 6): phases 21 and 23, the controllers' A/B and the traffic SLO
    suite, then phase 36's bridge runs, then (once the main process
    lets it, after phase 41a) phase 41b's health plane and 41c's
    sharded bench entry, on the card beside the main
    process's phases 7-20 (each round is host-bound and the card idle
    most of the time); each phase's dict and kernel launches saved as it
    is done.  It starts no torch.profiler
    window: that would spoil every later window of the main process."""
    from partisan_tpu_torch import kernels

    card = smi_line()
    put = saver(CARD_DIR)
    for key, fn in (("control_ab", control_ab_full),
                    ("traffic_slo", traffic_slo_full),
                    ("bridge", lambda card: bridge_card()),
                    ("sharded_health", sharded_health),
                    ("sharded_entry", lambda card: sharded_entry())):
        if key == "sharded_health":
            # after the main process's phase 41a measurements
            wait_go(CARD_DIR, "sharded")
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn(card)
        put(key, (out, dict(kernels.launches), time.perf_counter() - t0))
    return 0


def cpu_half(key: str):
    """The CPU half ``key`` from the CPU-halves process."""
    return CPU.get(key)


# ---------------------------------------------------------------------------
# Phases 30-33: the legacy ladder, the bench entry, X-BOT and distance
# ---------------------------------------------------------------------------

def legacy_ladder_full(card: str, boot_wo) -> dict:
    """Phase 30: bench's Config without the width operand at n=32768,
    booted by the legacy ladder (one Cluster per rung [8192, 32768], the
    state re-embedded between rungs), prefix-equal to phase 5's
    width-operand boot state on every leaf (its n_active stripped)."""
    from partisan_tpu_torch import kernels
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    made = []

    def make(w):
        made.append(w)
        return Cluster(sc.bench_config(w).replace(width_operand=False),
                       model=Plumtree())

    kernels.reset_launches()
    t0 = time.perf_counter()
    cl, st = sc._boot_ladder(make, N_MAIN, widths=[8192, N_MAIN],
                             settle_execs=1)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if sorted(made) != [8192, N_MAIN] or st.n_active != ():
        raise AssertionError(f"legacy ladder: clusters {made}")
    n_leaves = assert_identical(st, boot_wo._replace(n_active=()),
                                "legacy ladder vs phase 5's ladder")
    return {"card": card, "n": N_MAIN, "widths": [8192, N_MAIN],
            "clusters": made, "rnd": int(st.rnd), "leaves": n_leaves,
            "wall_s": wall, "launches": launches}


def bench_entry_full(card: str) -> dict:
    """Phase 31: ``python -m partisan_tpu_torch.bench --one 100000`` as a
    user runs it, with ``--extras``: one JSON line with bench.py's
    ``--one`` keys, coverage 1.0, and the converged round, counts and
    final state (every leaf by hash) equal to the JAX package's
    (``JAX_BENCH``); its rounds/s, convergence, boot and process walls,
    peak memory and a profiled K_PROG-round window from the final
    state."""
    want = JAX_BENCH
    extras = "build/bench_entry_extras.json"
    if os.path.exists(extras):
        os.remove(extras)
    cmd = [sys.executable, "-m", "partisan_tpu_torch.bench", "--one",
           str(want["n"]), "--extras", extras]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench --one {want['n']}: exit "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    if len(lines) != 1 or set(res) != BENCH_ONE_KEYS:
        raise AssertionError(f"bench --one {want['n']} printed {lines}")
    with open(extras) as f:
        ex = json.load(f)
    if ex["coverage"] != 1.0:
        raise AssertionError(f"bench --one {want['n']}: coverage "
                             f"{ex['coverage']}")
    got = {k: res[k] for k in ("n", "converged_round", "convergence_rounds",
                               "dropped", "emitted")}
    got.update(rnd=res["converged_round"], state_sha=ex["state_sha"])
    for key, w in want.items():
        if key != "leaf_hashes" and got.get(key) != w:
            bad = [i for i, (h, x) in enumerate(zip(ex["leaf_hashes"],
                                                    want["leaf_hashes"]))
                   if h != x]
            raise AssertionError(f"bench n={want['n']} {key}: card "
                                 f"{got.get(key)} != JAX {w} (leaves "
                                 f"{bad} differ)")
    table = ex["phase_table"]
    extra = set(table["phases"]) - set(JAX_BENCH_PHASES)
    if extra or abs(table["device_ms"] - table["window_device_ms"]) \
            > 0.02 * table["window_device_ms"]:
        raise AssertionError(f"bench n={want['n']} phase table: keys "
                             f"{sorted(table['phases'])}, {table['device_ms']}"
                             f" ms against the window's "
                             f"{table['window_device_ms']}")
    return {"card": card, "command": " ".join(cmd[1:]), **got,
            "phase_table": table,
            "rounds_per_sec": res["rounds_per_sec"],
            "convergence_wall_s": res["convergence_wall_s"],
            "bootstrap_s": res["phases"]["bootstrap"],
            "phases": res["phases"], "process_wall_s": wall,
            "peak_mem_gib": ex["peak_mem_gib"], "window": ex["window"],
            "launches": ex["launches"]}


def xbot_cfg(n: int, xbot: bool = True):
    """tools/jax_reference_values.py's ``xbot_cfg``: bench's Config with
    X-BOT on and the distance plane feeding it measured RTTs."""
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.config import DistanceConfig, HyParViewConfig

    return sc.bench_config(n).replace(
        hyparview=HyParViewConfig(isolation_window_ms=25_000, xbot=xbot),
        distance=DistanceConfig(enabled=True, xbot_oracle=True))


def mean_latency(cfg, active) -> float:
    """Mean modeled one-way latency (rounds) over the active edges."""
    from partisan_tpu_torch import distance

    act = active.cpu().numpy()
    i = np.repeat(np.arange(act.shape[0]), act.shape[1])
    j = act.reshape(-1)
    ok = j >= 0
    lat = distance.latency_rounds(cfg, torch.as_tensor(i[ok]),
                                  torch.as_tensor(j[ok])).numpy()
    return float(lat.mean()) if lat.size else 0.0


def xbot_full(card: str) -> dict:
    """Phase 32: X-BOT with the distance plane at n=10,000 (the scenario
    suite's DEFAULT_SIZES[3]): bench's Config with X-BOT and
    ``DistanceConfig(enabled=True, xbot_oracle=True)``, booted by the
    width ladder, then ROUNDS rounds in K_PROG executions, and the same
    with X-BOT off.  The X-BOT run's final state (every leaf by hash) and
    mean modeled link latency equal the JAX package's (``JAX_XBOT``), its
    latency is below the X-BOT-off run's, and its overlay is one
    component.  Per arm its boot and run walls and a profiled K_PROG
    window from the final state."""
    from partisan_tpu_torch import bench as tbench
    from partisan_tpu_torch import kernels
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    want = JAX_XBOT
    n, rounds = want["n"], want["rounds"]
    kernels.reset_launches()
    arms = {}
    for on in (True, False):
        cfg = xbot_cfg(n, on)
        cl = Cluster(cfg, model=Plumtree())
        t0 = time.perf_counter()
        _, st = sc._boot_ladder(lambda w: cl, n, settle_execs=1)
        boot_s = time.perf_counter() - t0
        boot_lat = mean_latency(cfg, st.manager.active)
        t0 = time.perf_counter()
        for _ in range(rounds // sc.K_PROG):
            st = cl.steps(st, sc.K_PROG)
        sc._sync(st)
        run_s = time.perf_counter() - t0
        arms[on] = {"cl": cl, "st": st, "report": {
            "boot_s": boot_s, "run_s": run_s,
            "ms_per_round": run_s * 1e3 / rounds,
            "boot_mean_latency": boot_lat,
            "mean_latency": mean_latency(cfg, st.manager.active)}}
    launches = dict(kernels.launches)
    on, off = arms[True], arms[False]
    st = on["st"]
    got = {"n": n, "rounds": rounds, "rnd": int(st.rnd),
           "boot_mean_latency": on["report"]["boot_mean_latency"],
           "mean_latency": on["report"]["mean_latency"]}
    sha = hold_to(want, got, st, f"X-BOT n={n}")
    if not on["report"]["mean_latency"] < off["report"]["mean_latency"]:
        raise AssertionError(f"X-BOT did not lower the mean link latency: "
                             f"{on['report']} vs off {off['report']}")
    sizes, _ = tbench._components(st.manager.active.cpu().numpy())
    if len(sizes) != 1:
        raise AssertionError(f"X-BOT overlay: {len(sizes)} components")
    for arm in arms.values():
        cl, st = arm["cl"], arm["st"]
        arm["report"]["window"] = round_profile(
            lambda: cl.steps(st, sc.K_PROG), sc.K_PROG)
        arm["report"]["phases"] = perfwatch.phase_window(
            lambda: cl.steps(st, sc.K_PROG), sc.K_PROG)
    return {"card": card, "n": n, "rounds": rounds, "state_sha": sha,
            "components": 1, "xbot_on": on["report"],
            "xbot_off": off["report"], "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def xbot_small(device: str) -> dict:
    """tests/test_xbot.py's X-BOT overlay (N=24, seed 6: a staggered boot,
    30 settle rounds) then ``record(XBOT_SMALL_RECORD)``, and
    tests/test_distance.py's n=8 full mesh with a stacked DistanceService
    (hash geometry, pings every 2 rounds: every node joined via node 0, 5
    rounds) then ``record(DIST_SMALL_RECORD)``: each final state and
    trace, on ``device``."""
    from partisan_tpu_torch import distance
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config, DistanceConfig, \
        HyParViewConfig
    from partisan_tpu_torch.models.stack import Stack

    out = {}
    cfg = Config(n_nodes=24, seed=6, peer_service_manager="hyparview",
                 msg_words=16, hyparview=HyParViewConfig(xbot=True))
    cl = Cluster(cfg, device=device)
    st = staggered_boot(cl, settle=30)
    out["xbot"] = cl.record(st, XBOT_SMALL_RECORD)
    cfg = Config(n_nodes=8, seed=5, inbox_cap=48,
                 distance_interval_ms=2_000,
                 distance=DistanceConfig(enabled=True, model="hash"))
    cl = Cluster(cfg, model=Stack([distance.DistanceService()]),
                 device=device)
    st = cl.init()
    m = st.manager
    for i in range(1, 8):
        m = cl.manager.join(cfg, m, i, 0)
    st = cl.steps(st._replace(manager=m), 5)
    out["distance"] = cl.record(st, DIST_SMALL_RECORD)
    return out


def xbot_parity(card: str) -> dict:
    """Phase 33: ``xbot_small`` on the card against the CPU: both final
    states and both traces bit for bit, the card's traces written by the
    interleave kernel (once a recorded round); the X-BOT trace carries
    the handshake's kinds, the distance trace PING and PONG."""
    from partisan_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    g = xbot_small("cuda")
    card_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    c = cpu_half("xbot_small")
    out = {"card": card, "card_s": card_s, "launches": launches}
    for label, kinds in (("xbot", {18, 19, 24, 25, 26, 27}),
                         ("distance", {1, 2})):
        (gst, gtr), (cst, ctr) = g[label], c[label]
        n_leaves = assert_identical(gst, cst, f"{label} state")
        assert_identical(gtr, ctr, f"{label} trace")
        seen = set(np.unique(gtr.sent[..., 0].cpu().numpy()).tolist())
        if not kinds & seen:
            raise AssertionError(f"{label}: no {sorted(kinds)} in the "
                                 f"trace's kinds {sorted(seen)}")
        out[label] = {"leaves": n_leaves, "trace_shape":
                      list(gtr.sent.shape),
                      "kinds": sorted(kinds & seen)}
    want = XBOT_SMALL_RECORD + DIST_SMALL_RECORD
    if launches["interleave"] != want:
        raise AssertionError(f"X-BOT / distance records: {launches} "
                             f"launches, want {want} interleaves")
    return out


# ---------------------------------------------------------------------------
# Phases 34-36: the OTP layer and the Erlang bridge
# ---------------------------------------------------------------------------

def otp_sizes(n: int) -> dict:
    """The storm's counts at ``n`` nodes (the tool's ``otp_sizes``)."""
    return {"callers": max(n // 10, 8), "owners": max(n // 100, 4),
            "crashes": max(n // 100, 1)}


def draw(rng, n: int, k: int) -> np.ndarray:
    """``k`` distinct node ids: the order of ``n`` uniform doubles."""
    return np.argsort(rng.random(n), kind="stable")[:k]


def otp_cluster(n: int, device):
    """Bench's Config with ``inbox_cap=48`` (tests/test_otp.py's value) and
    the OTP stack in place of Plumtree: RPC with tests/test_otp.py's three
    functions, monitors, the counter gen_server and the table statem."""
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.stack import Stack
    from partisan_tpu_torch.otp import gen_sim, monitor, rpc, statem_sim

    fns = (lambda x: x + 1, lambda x: x * 2, lambda x: 42)
    stack = Stack([rpc.RpcService(fns), monitor.MonitorService(),
                   gen_sim.GenServerService(),
                   statem_sim.StatemService(
                       statem_sim.TableStatem(**OTP_STATEM))])
    return Cluster(sc.bench_config(n).replace(inbox_cap=48), model=stack,
                   device=device)


def otp_gate(st) -> dict:
    """The storm's gate values (the tool's ``otp_gate``): each service's
    call-status counts, the servers' counter digest and the monitor
    events' counts."""
    import hashlib

    from partisan_tpu_torch import state_io

    rs, ms, gs, ss = state_io.state_to_numpy(st.model)

    def sha(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()[:16]

    return {
        "status_counts": {
            name: np.bincount(s.status.reshape(-1), minlength=6).tolist()
            for name, s in (("rpc", rs), ("gen_server", gs),
                            ("gen_statem", ss))},
        "counters_sha": sha(np.ascontiguousarray(gs.counter).tobytes()
                            + np.ascontiguousarray(gs.stopped).tobytes()
                            + np.ascontiguousarray(ss.sm).tobytes()),
        "unprocessed": int(ss.unprocessed.sum()),
        "monitor_counts": {f: int(getattr(ms, f).sum())
                           for f in ("monitors", "down_sig", "nodedown",
                                     "nodeup", "edge_down", "edge_up")}}


def otp_storm(n: int, device) -> dict:
    """The OTP call storm (tools/jax_reference_values.py's ``otp``, the
    same sequence): boot by bench's width ladder; owners monitor drawn
    targets (process, edge and node monitors; half the targets among
    the nodes that crash); four waves K_PROG rounds apart, each caller
    one gen_server FN_INCR call, one RPC call and one statem call to
    drawn destinations with an 8-round timeout, through the services'
    ``call``; 1% of the nodes crashed before wave 3; 60 rounds in all.
    At ``n <= OTP_SYS_MAX_N`` the first two chunks run through
    ``otp.sys.trace`` and ``otp.sys.statistics`` and the captured wires
    are kept.  Returns the gate values in the tool's keys (``out``), the
    cluster, the final state, the captures and the walls."""
    import hashlib

    from partisan_tpu_torch import faults
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch import trace as trace_mod
    from partisan_tpu_torch.otp import gen_sim
    from partisan_tpu_torch.otp import sys as psys

    def sha(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()[:16]

    cl = otp_cluster(n, device)
    stack = cl.model
    t0 = time.perf_counter()
    _, st = sc._boot_ladder(lambda w: cl, n, settle_execs=1)
    sc._sync(st)
    boot_s = time.perf_counter() - t0
    sizes = otp_sizes(n)
    rng = np.random.default_rng(OTP_SEED)
    rs, mon, gs, ss = stack.models
    out = {"n": n, "seed": OTP_SEED, "boot_rnd": int(st.rnd), **sizes}
    t0 = time.perf_counter()
    crashed = draw(rng, n, sizes["crashes"])
    owners = draw(rng, n, sizes["owners"]).tolist()
    half = crashed[:sizes["owners"] // 2].tolist()
    targets = half + rng.integers(0, n, size=len(owners)
                                  - len(half)).tolist()
    ms = stack.sub(st.model, 1)
    for o, t in zip(owners, targets):
        ms = mon.monitor(ms, o, t)
        ms = mon.monitor_edge(ms, o, t)
        ms = mon.monitor_nodes(ms, o)
    st = st._replace(model=stack.replace_sub(st.model, 1, ms))
    monitor_s = time.perf_counter() - t0
    captures = []
    orig_record = cl.record

    def record(state, k):
        state, cap = orig_record(state, k)
        captures.append(cap)
        return state, cap

    cl.record = record
    call_s, chunk_s = [], []
    for w in range(OTP_WAVES):
        if w == 2:
            st = st._replace(faults=faults.crash_many(st.faults, crashed))
        callers = draw(rng, n, sizes["callers"]).tolist()
        dst = rng.integers(0, n, size=(len(callers), 3)).tolist()
        arg = rng.integers(0, 1000, size=(len(callers), 3)).tolist()
        fn = rng.integers(0, len(rs.fns), size=len(callers)).tolist()
        ev = rng.integers(0, 4, size=len(callers)).tolist()
        sc._sync(st)
        t0 = time.perf_counter()
        now = int(st.rnd)
        subs = [stack.sub(st.model, i) for i in range(4)]
        for i, c in enumerate(callers):
            subs[2], _ = gs.call(subs[2], c, dst[i][0], gen_sim.FN_INCR,
                                 arg[i][0], OTP_TIMEOUT, now)
            subs[0], _ = rs.call(subs[0], c, dst[i][1], fn[i], arg[i][1],
                                 OTP_TIMEOUT, now)
            subs[3], _ = ss.call(subs[3], c, dst[i][2], ev[i], arg[i][2],
                                 OTP_TIMEOUT, now)
        st = st._replace(model=tuple(subs))
        sc._sync(st)
        call_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        if n <= OTP_SYS_MAX_N and w == 0:
            st, text = psys.trace(cl, st, sc.K_PROG, node=callers[0],
                                  limit=None)
            out["trace_text_sha"] = sha(text.encode())
        elif n <= OTP_SYS_MAX_N and w == 1:
            st, stats = psys.statistics(cl, st, sc.K_PROG)
            out["statistics_sha"] = sha(json.dumps(
                stats, sort_keys=True).encode())
            out["messages_out"] = sum(v["messages_out"]
                                      for v in stats.values())
        else:
            st = cl.steps(st, sc.K_PROG)
        sc._sync(st)
        chunk_s.append(time.perf_counter() - t0)
    for _ in range((OTP_ROUNDS - OTP_WAVES * sc.K_PROG) // sc.K_PROG):
        t0 = time.perf_counter()
        st = cl.steps(st, sc.K_PROG)
        sc._sync(st)
        chunk_s.append(time.perf_counter() - t0)
    if captures:
        tr = [trace_mod.from_capture(c) for c in captures]
        out["trace_sha"] = sha(b"".join(
            np.ascontiguousarray(t.sent).tobytes()
            + np.ascontiguousarray(t.dropped).tobytes() for t in tr))
        out["trace_shape"] = [list(t.sent.shape) for t in tr]
    out.update(otp_gate(st), rnd=int(st.rnd),
               stats={k: int(v) for k, v in st.stats._asdict().items()})
    return {"out": out, "cluster": cl, "state": st, "captures": captures,
            "boot_s": boot_s, "monitor_s": monitor_s,
            "call_s_per_wave": call_s, "chunk_s": chunk_s}


def otp_small(device: str) -> dict:
    """Phase 35's run on ``device``: the storm at n=64 (its first two
    chunks through otp.sys), the final state, the captured wires and the
    gate values."""
    from partisan_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    run = otp_storm(OTP_SMALL_N, device)
    return {"out": run["out"], "state": run["state"],
            "captures": run["captures"], "launches": dict(kernels.launches),
            "seconds": time.perf_counter() - t0}


def otp_full(card: str) -> dict:
    """Phase 34: the OTP storm at n=10,000 on the card, its gate values
    and final state (every leaf by hash) equal to the JAX package's
    (``JAX_OTP``, whose statem budget leaves 2 events unprocessed, as
    the port's does); DOWN, badrpc timeouts and nodedown must have
    fired.
    Its walls (boot, each wave's calls, each chunk), a profiled K_PROG
    window from the final state and the peak memory."""
    from partisan_tpu_torch import kernels
    from partisan_tpu_torch import scenarios as sc

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    run = otp_storm(OTP_N, None)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    st, out = run["state"], run["out"]
    sha = hold_to(JAX_OTP, out, st, f"OTP storm n={OTP_N}")
    counts = out["status_counts"]
    fired = {"down": counts["gen_server"][5] + counts["gen_statem"][5],
             "badrpc_timeout": counts["rpc"][4],
             "nodedown": out["monitor_counts"]["nodedown"],
             "DOWN_signals": out["monitor_counts"]["down_sig"]}
    if not all(fired.values()):
        raise AssertionError(f"OTP storm: not every signal fired: {fired}")
    cl = run["cluster"]
    window = round_profile(lambda: cl.steps(st, sc.K_PROG), sc.K_PROG)
    phases = perfwatch.phase_window(lambda: cl.steps(st, sc.K_PROG),
                                    sc.K_PROG)
    return {"card": card, "n": OTP_N, "state_sha": sha, "fired": fired,
            "phases": phases,
            "status_counts": counts, "stats": out["stats"],
            "unprocessed": out["unprocessed"],
            "wall_s": wall, "boot_s": run["boot_s"],
            "monitor_s": run["monitor_s"],
            "call_s_per_wave": run["call_s_per_wave"],
            "calls_per_wave": 3 * out["callers"],
            "chunk_s": run["chunk_s"],
            "ms_per_round": sum(run["chunk_s"]) * 1e3 / OTP_ROUNDS,
            "window": window, "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def otp_parity(card: str) -> dict:
    """Phase 35: the storm at n=64 on the card against the CPU half: the
    gate values, the rendered trace's and the statistics' digests, the
    captured wires and every state leaf equal, and equal to the JAX
    package's (``JAX_OTP_SMALL``); the card's captures written by the
    interleave kernel, once a recorded round (20)."""
    g = otp_small("cuda")
    c = cpu_half("otp_small")
    n_leaves = assert_identical(g["state"], c["state"], "OTP n=64 state")
    for i, (a, b) in enumerate(zip(g["captures"], c["captures"])):
        assert_identical(a, b, f"OTP n=64 capture {i}")
    if g["out"] != c["out"]:
        raise AssertionError(f"OTP n=64: card {g['out']} != CPU {c['out']}")
    sha = hold_to(JAX_OTP_SMALL, g["out"], g["state"],
                  f"OTP storm n={OTP_SMALL_N}")
    want = 2 * 10
    if g["launches"]["interleave"] != want:
        raise AssertionError(f"OTP n=64 records: {g['launches']}, want "
                             f"{want} interleaves")
    return {"card": card, "n": OTP_SMALL_N, "leaves": n_leaves,
            "state_sha": sha, "trace_sha": g["out"]["trace_sha"],
            "trace_shape": g["out"]["trace_shape"],
            "messages_out": g["out"]["messages_out"],
            "launches": g["launches"], "card_s": g["seconds"],
            "cpu_s": c["seconds"]}


def bridge_session() -> list:
    """tests/test_bridge_conformance.py's recorded session: what
    partisan_sim_peer_service_manager.erl sends over its port for a boot
    + join + forward + fault cycle."""
    from partisan_tpu_torch.bridge.etf import Atom as A

    reqs = [(1, (A("init"), {A("n_nodes"): 8, A("seed"): 3})),
            (2, (A("set_self"), 0))]
    reqs += [(2 + i, (A("join"), i, 0)) for i in range(1, 8)]
    return reqs + [
        (10, (A("step"), 20)), (11, (A("members"), 0)),
        (12, (A("forward_message"), 0, 5, [42])), (13, (A("step"), 1)),
        (14, (A("drain"), 5)), (15, (A("reserve"), 0, 1)),
        (16, (A("inject_partition"), [0], [])),
        (17, (A("resolve_partition"),)), (18, (A("stats"),)),
        (19, (A("stop"),))]


def jsonable(t):
    """A bridge reply as JSON (the tool's ``jsonable``): atoms as strings,
    tuples as lists."""
    if isinstance(t, (tuple, list)):
        return [jsonable(x) for x in t]
    if isinstance(t, dict):
        return [[jsonable(k), jsonable(v)] for k, v in t.items()]
    if isinstance(t, bytes):
        return t.decode("latin-1")
    return t if isinstance(t, (bool, int, float)) else str(t)


def bridge_pipe() -> dict:
    """``python -m partisan_tpu_torch.bridge.server`` (no ``--device``:
    the card) as the ``open_port`` subprocess, fed the conformance
    session frame by frame: its replies, its exit code and walls."""
    from partisan_tpu_torch.bridge import etf

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "partisan_tpu_torch.bridge.server"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        replies, per_req = [], []
        for req in bridge_session():
            t1 = time.perf_counter()
            proc.stdin.write(etf.frame(req))
            proc.stdin.flush()
            replies.append(jsonable(etf.read_frame(proc.stdout)))
            per_req.append(time.perf_counter() - t1)
        rc = proc.wait(timeout=120)
        err = proc.stderr.read().decode()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in (proc.stdin, proc.stdout, proc.stderr):
            f.close()
    return {"replies": replies, "rc": rc, "stderr": err,
            "process_s": time.perf_counter() - t0,
            "first_reply_s": per_req[0], "rest_s": sum(per_req[1:])}


def trace16_run(device) -> dict:
    """The 16-node bridge trace over the socket server on ``device`` and
    the in-simulator convergence round."""
    from partisan_tpu_torch.bridge import trace16

    t0 = time.perf_counter()
    run = trace16.run_trace16(device=device)
    run_s = time.perf_counter() - t0
    return {"run": run, "sim_rounds": trace16.sim_convergence_rounds(
        device=device), "run_s": run_s}


def bridge_card() -> dict:
    """Phase 36's card half (in the card worker): the port server on the
    card through its pipe, then trace16 on the card."""
    return {"pipe": bridge_pipe(), "trace16": trace16_run(None)}


def bridge_phase(card: str, got: dict) -> dict:
    """Phase 36: the card worker's bridge run held to the JAX server's
    replies (``JAX_BRIDGE``) and the trace16 rows and convergence rounds
    to the CPU half's; the rows to tools/traces/trace16.json's when this
    host's numpy is the capture's."""
    pipe, t16 = got["pipe"], got["trace16"]
    if pipe["rc"] != 0:
        raise AssertionError(f"bridge server exited {pipe['rc']}: "
                             f"{pipe['stderr']}")
    if pipe["replies"] != JAX_BRIDGE["replies"]:
        raise AssertionError(f"bridge replies {pipe['replies']} != JAX "
                             f"{JAX_BRIDGE['replies']}")
    cpu = cpu_half("trace16")
    if t16["run"] != cpu["run"] or t16["sim_rounds"] != cpu["sim_rounds"]:
        raise AssertionError(
            f"trace16 on the card ({t16['run']['convergence_rounds']}, sim "
            f"{t16['sim_rounds']}) differs from the CPU's "
            f"({cpu['run']['convergence_rounds']}, sim {cpu['sim_rounds']})")
    with open("tools/traces/trace16.json") as f:
        committed = json.load(f)
    if committed["numpy_version"] == np.__version__:
        if committed["rows"] != t16["run"]["rows"]:
            raise AssertionError("trace16 rows differ from "
                                 "tools/traces/trace16.json")
        artifact = "equal"
    else:
        artifact = (f"not compared: numpy {np.__version__} here, "
                    f"{committed['numpy_version']} in the capture")
    return {"card": card, "replies": len(pipe["replies"]),
            "pipe_process_s": pipe["process_s"],
            "pipe_first_reply_s": pipe["first_reply_s"],
            "pipe_rest_s": pipe["rest_s"],
            "trace16_rows": len(t16["run"]["rows"]),
            "trace16_convergence_rounds":
                t16["run"]["convergence_rounds"],
            "sim_convergence_rounds": t16["sim_rounds"],
            "trace16_s": t16["run_s"], "trace16_cpu_s": cpu["run_s"],
            "artifact": artifact}


# ---------------------------------------------------------------------------
# Phases 37-39: the fleet runner
# ---------------------------------------------------------------------------

def capture_fleet_steps(keep: list):
    """Wrap ``fleet.Fleet.steps`` so ``keep`` holds the fleet and the
    state of its latest call (scenarios.fleet_sweep returns only its
    card); returns the undo callable."""
    from partisan_tpu_torch import fleet as tfleet

    orig = tfleet.Fleet.steps

    def steps(self, st, k):
        out = orig(self, st, k)
        keep[:] = [self, out]
        return out

    tfleet.Fleet.steps = steps
    return lambda: setattr(tfleet.Fleet, "steps", orig)


def fleet_sweep_run(width: int, n: int, max_rounds: int = 300) -> dict:
    """scenarios.fleet_sweep(width, n, max_rounds) on the card: its card,
    the fleet and final state, the interleave's launches, the wall and
    the peak memory."""
    from partisan_tpu_torch import kernels
    from partisan_tpu_torch import scenarios as sc

    torch.cuda.reset_peak_memory_stats()
    keep: list = []
    undo = capture_fleet_steps(keep)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = sc.fleet_sweep(width=width, n=n, max_rounds=max_rounds)
    finally:
        undo()
    wall = time.perf_counter() - t0
    return {"card": out, "fleet": keep[0], "state": keep[1],
            "launches": dict(kernels.launches), "wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def fleet_replay(fl, st, j: int) -> int:
    """Member ``j`` of a fleet_sweep state re-run unbatched on the card
    at ``seed + salt``, the sweep's script round for round (join, settle,
    broadcast, the rest), equal to its slice leaf for leaf."""
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    salt = int(st.salt[j])
    cfg = fl.member_cfg.replace(seed=fl.member_cfg.seed + salt,
                                salt_operand=False)
    n = cfg.n_nodes
    cl = Cluster(cfg, model=Plumtree(), device=fl.device)
    s = cl.init()
    s = s._replace(manager=cl.manager.join_many(
        cfg, s.manager, list(range(1, n)), [0] * (n - 1)))
    s = cl.steps(s, FLEET_SETTLE)
    s = s._replace(model=cl.model.broadcast(s.model, 0, 0, 2))
    s = cl.steps(s, int(st.rnd) - FLEET_SETTLE)
    return assert_identical(s, fl.member_state(st, j)._replace(salt=()),
                            f"fleet member {j} replay")


def fleet_full(card: str) -> dict:
    """Phase 37: scenarios.fleet_sweep at W=64 members of n=1024 on the
    card, its card and final state (every leaf by hash) equal to the JAX
    package's (``JAX_FLEET``), every member converged; member 5 re-run
    unbatched equal to its slice; ms per fleet round, launches per round,
    device time and idle share from a profiled K_PROG window, the peak
    memory and the sweep's wall; the same at W=8."""
    from partisan_tpu_torch import scenarios as sc

    big = fleet_sweep_run(FLEET_W, FLEET_N)
    c, fl, st = big["card"], big["fleet"], big["state"]
    got = {k: v for k, v in c.items() if k != "wall_s"}
    got["rnd"] = int(st.rnd)
    sha = hold_to(JAX_FLEET, got, st, f"fleet sweep {FLEET_W}x{FLEET_N}")
    if c["converged"] != FLEET_W:
        raise AssertionError(f"fleet sweep: {c['converged']} of {FLEET_W} "
                             "members converged")
    t0 = time.perf_counter()
    leaves = fleet_replay(fl, st, FLEET_REPLAY_MEMBER)
    replay_s = time.perf_counter() - t0
    window = round_profile(lambda: fl.steps(st, sc.K_PROG), sc.K_PROG)
    phases = perfwatch.phase_window(lambda: fl.steps(st, sc.K_PROG),
                                    sc.K_PROG)
    small = fleet_sweep_run(FLEET_SMALL_W, FLEET_N, FLEET_SMALL_ROUNDS)
    window8 = round_profile(
        lambda: small["fleet"].steps(small["state"], sc.K_PROG), sc.K_PROG)
    rounds = got["rnd"]
    return {"card": card, "width": FLEET_W, "n": FLEET_N,
            "node_rows": FLEET_W * FLEET_N, "state_sha": sha,
            "rounds": rounds, "converged": c["converged"],
            "rounds_to_converge": c["rounds_to_converge"],
            "redundancy_ratio": c["redundancy_ratio"], "p99": c["p99"],
            "programs": c["programs"], "sweep_wall_s": big["wall_s"],
            "ms_per_round_sweep": big["wall_s"] * 1e3 / rounds,
            "window": window, "phases": phases,
            "peak_mem_gib": big["peak_mem_gib"],
            "replay_member": FLEET_REPLAY_MEMBER, "replay_leaves": leaves,
            "replay_s": replay_s,
            "w8": {"width": FLEET_SMALL_W, "sweep_wall_s": small["wall_s"],
                   "max_rounds": FLEET_SMALL_ROUNDS,
                   "converged": small["card"]["converged"],
                   "rounds": int(small["state"].rnd),
                   "ms_per_round_sweep": small["wall_s"] * 1e3
                   / int(small["state"].rnd),
                   "window": window8, "peak_mem_gib":
                   small["peak_mem_gib"]},
            "launches": {k: big["launches"].get(k, 0)
                         + small["launches"].get(k, 0)
                         for k in set(big["launches"])
                         | set(small["launches"])}}


def fleet_search_run(device) -> dict:
    """tests/test_fleet.py's batched search (W=64, n=16, horizon 10,
    settle 30, AAE off), the golden trace from the unbatched twin's
    Cluster.record: the values tools/jax_reference_values.py prints."""
    import hashlib

    from partisan_tpu_torch import fleet as tfleet
    from partisan_tpu_torch import interpose, trace
    from partisan_tpu_torch.bench import state_hashes
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config, PlumtreeConfig
    from partisan_tpu_torch.models.plumtree import Plumtree

    n, W, horizon, settle = 16, FLEET_SEARCH_W, 10, 30
    cfg = Config(n_nodes=n, seed=5, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="groups", salt_operand=True,
                 plumtree=PlumtreeConfig(aae=False))
    joins, contacts = list(range(1, n)), [0] * (n - 1)

    def build(sched):
        fl = tfleet.Fleet(cfg, width=W, model=Plumtree(), interpose=sched,
                          device=device)
        st = fl.init(salts=np.zeros(W, np.uint32))
        st = st._replace(manager=fl.map_members(
            lambda m: fl.manager.join_many(cfg, m, joins, contacts),
            st.manager))
        st = fl.steps(st, settle)
        st = st._replace(model=fl.map_members(
            lambda m: fl.model.broadcast(m, 0, 0, 3), st.model))
        return fl, st

    t0 = time.perf_counter()
    cl = Cluster(cfg.replace(fleet_width=0), model=Plumtree(),
                 interpose=interpose.OmissionSchedule(
                     np.zeros((1, 1, 1), np.bool_), start=0), device=device)
    st = cl.init()
    st = st._replace(manager=cl.manager.join_many(cfg, st.manager, joins,
                                                  contacts))
    st = cl.steps(st, settle)
    st = st._replace(model=cl.model.broadcast(st.model, 0, 0, 3))
    _, capture = cl.record(st, horizon)
    emit_w = capture.sent.shape[2]
    tr = trace.from_capture(capture)
    boot = int(st.rnd)
    scheds = tfleet.population(tr, lambda e: e.kind_name.startswith("PT_"),
                               width=W - 1, max_faults=2, seed=1)
    scheds.append(frozenset((r, 0, e) for r in range(boot, boot + horizon)
                            for e in range(emit_w)))
    golden_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = tfleet.search(build, scheds, horizon, sched_width=emit_w,
                        coverage_slot=0, coverage_version=3)
    search_s = time.perf_counter() - t0
    blob = json.dumps([sorted(list(c) for c in s) for s in scheds])
    return {
        "width": W, "n": n, "emit_width": emit_w, "boot": boot,
        "schedules_sha": hashlib.sha256(blob.encode()).hexdigest()[:16],
        "passed": res.passed, "verdicts": res.verdicts,
        "oracle": {k: np.asarray(v).tolist() for k, v in res.oracle.items()},
        "counterexamples": [
            {"member": c.member, "salt": c.salt, "seed": c.seed,
             "schedule": sorted(list(x) for x in c.schedule),
             "oracle": c.oracle, "replayed": c.replayed}
            for c in res.counterexamples],
        "programs": res.programs,
        "state0_sha": state_hashes(res.state0)["state_sha"],
        "_state": res.state, "golden_s": golden_s, "search_s": search_s,
        "render": res.render()}


def fleet_search_full(card: str) -> dict:
    """Phase 38: the W=64 search on the card, its population, verdicts,
    oracle values, counterexample (member 63, the seed, coverage 1/16),
    booted and final fleet states equal to the JAX package's
    (``JAX_FLEET_SEARCH``), the counterexample replayed unbatched leaf
    for leaf, 2 round programs; the golden trace's record through the
    interleave kernel (10 launches)."""
    from partisan_tpu_torch import kernels

    kernels.reset_launches()
    got = fleet_search_run(None)
    launches = dict(kernels.launches)
    st = got.pop("_state")
    timing = {k: got.pop(k) for k in ("golden_s", "search_s", "render")}
    sha = hold_to(JAX_FLEET_SEARCH, got, st, "fleet search")
    [cex] = got["counterexamples"]
    if not (cex["replayed"] and cex["member"] == FLEET_SEARCH_W - 1
            and got["programs"] == 2):
        raise AssertionError(f"fleet search: {cex}, programs "
                             f"{got['programs']}")
    if launches.get("interleave") != 10:
        raise AssertionError(f"fleet search golden trace: {launches}, "
                             "want 10 interleaves")
    return {"card": card, "width": FLEET_SEARCH_W, "n": got["n"],
            "state_sha": sha, "failed": sum(not v for v in got["verdicts"]),
            "counterexample": {k: cex[k] for k in ("member", "seed", "salt",
                                                   "oracle", "replayed")},
            "programs": got["programs"], **timing,
            "ms_per_round": timing["search_s"] * 1e3 / (30 + 10 + 10),
            "launches": launches}


def fleet_storm(device) -> dict:
    """tests/test_fleet.py's member storms (W=4, n=24, dense partitions,
    traffic: member 1 a crash + partition storm, member 2 a flash crowd)
    through Soak at chunk_fixed 6 with the conservation invariant."""
    from partisan_tpu_torch import fleet as tfleet
    from partisan_tpu_torch import soak, workload
    from partisan_tpu_torch.config import Config, TrafficConfig
    from partisan_tpu_torch.models.plumtree import Plumtree

    n, W, horizon = 24, FLEET_PAR_W, 36
    cfg = Config(n_nodes=n, seed=9, peer_service_manager="hyparview",
                 msg_words=16, partition_mode="dense", salt_operand=True,
                 traffic=TrafficConfig(enabled=True, rate_x1000=300,
                                       ring=16))
    t0 = time.perf_counter()
    fl = tfleet.Fleet(cfg, width=W, model=Plumtree(), device=device)
    st = fl.init()
    st = st._replace(manager=fl.map_members(
        lambda m: fl.manager.join_many(cfg, m, list(range(1, n)),
                                       [0] * (n - 1)), st.manager))
    member1 = ((8, soak.CrashBatch(nodes=(3, 5))),
               (12, soak.Partition(at=n // 2)), (24, soak.Heal()))
    member2 = tuple(workload.flash_crowd(10, 10, 3000, 300))
    events = tuple((off, tfleet.Member(1, a)) for off, a in member1)
    events += tuple((off, tfleet.Member(2, a)) for off, a in member2)
    res = soak.Soak(make_cluster=lambda: fl, storm=soak.Storm(
        events=tuple(sorted(events, key=lambda e: e[0]))),
        invariants=[soak.conservation()],
        cfg=soak.SoakConfig(chunk_fixed=6)).run(st, rounds=horizon)
    return {"state": res.state, "breaches": res.breaches,
            "chunk_rounds": [r["round"] for r in res.chunks],
            "chunk_k": [r["k"] for r in res.chunks],
            "seconds": time.perf_counter() - t0}


def fleet_parity(card: str) -> dict:
    """Phase 39: the member storms on the card against the CPU half, every
    leaf identical, and equal to the JAX package's (``JAX_FLEET_PARITY``:
    chunk rounds, no breach, every leaf by hash); then fleet.tune at the
    tier-1 FLEET_TUNE_N and FLEET_TUNE_WAVES on the card, its dict (the
    winner, each member's scores) equal to the JAX package's."""
    from partisan_tpu_torch import fleet as tfleet
    from partisan_tpu_torch import kernels

    kernels.reset_launches()
    g = fleet_storm(None)
    c = cpu_half("fleet_storm")
    leaves = assert_identical(g["state"], c["state"], "fleet storm state")
    got = {k: g[k] for k in ("breaches", "chunk_rounds", "chunk_k")}
    got.update(width=FLEET_PAR_W, n=24)
    want = {k: v for k, v in JAX_FLEET_PARITY.items() if k != "tune"}
    sha = hold_to(want, got, g["state"], "fleet storm")
    t0 = time.perf_counter()
    tuned = tfleet.tune([{"fanout_hi_pct": 200}, {}], n=FLEET_TUNE_N,
                        waves=FLEET_TUNE_WAVES)
    tune_s = time.perf_counter() - t0
    if tuned != JAX_FLEET_PARITY["tune"]:
        raise AssertionError(f"fleet.tune: card {tuned} != JAX "
                             f"{JAX_FLEET_PARITY['tune']}")
    return {"card": card, "width": FLEET_PAR_W, "leaves": leaves,
            "state_sha": sha, "chunks": len(g["chunk_k"]),
            "storm_card_s": g["seconds"], "storm_cpu_s": c["seconds"],
            "tune_winner": tuned["winner"], "tune_members": tuned["members"],
            "tune_s": tune_s, "launches": dict(kernels.launches)}


# the reference census's phase keys of bench's round
# (partisan_tpu.lint.cost.census_program(bench_round_program(n)))
JAX_BENCH_PHASES = ("-", "round.manager", "round.model", "round.wire_fast")
SS_ROUNDS = 240                 # phase 40's lifted soak: one execution
SS_CAP = 30                     # its chunk_cap (superstep 1: 8 chunks)
SS_R = 8


PT_ROUNDS = 10                  # phase 40's phase table: rounds captured


def census_window_faults(cens, window: dict, table: dict) -> list[str]:
    """Phase 40's checks of one K_PROG window (``round_profile``) and one
    phase table of PT_ROUNDS rounds against the census; raises on what
    does not hang on which records a profiler window got, returns the
    disagreements that do."""
    extra = set(table["phases"]) - set(cens.phases)
    if extra:
        raise AssertionError(f"phase table keys {extra} not in the census")
    if abs(table["device_ms"] - table["window_device_ms"]) \
            > 0.02 * table["window_device_ms"]:
        raise AssertionError(f"phases sum to {table['device_ms']} ms, the "
                             f"window {table['window_device_ms']} ms")
    if table["launches"] != table["window_launches"]:
        raise AssertionError(f"phases hold {table['launches']} launches a "
                             f"round, the capture "
                             f"{table['window_launches']}")
    bad = []
    reads, dtoh = (window["host_reads_per_round"],
                   window["copies_dtoh_per_round"])
    if cens.total.host_reads != reads + (dtoh - reads):
        bad.append(f"census host reads {cens.total.host_reads} != the "
                   f"window's {reads} scalar reads + {dtoh - reads} other "
                   f"DtoH copies a round")
    slack = (table["records_lost"] + window["records_lost"]
             + table["records_orphaned"] + window["records_orphaned"])
    if abs(round(table["launches"] * PT_ROUNDS)
           - round(window["launches_per_round"] * window["rounds"])) > slack:
        bad.append(f"capture {table['launches']} launches a round, window "
                   f"{window['launches_per_round']}")
    return bad


def census_full(card: str, cl, st) -> dict:
    """Phase 40 (docstring above): the census, the guard's verdicts, the
    phase table and the lifted soak, on phase 5's cluster and state."""
    from partisan_tpu_torch import bench as tbench
    from partisan_tpu_torch import perfwatch
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch import soak
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.lint import cost, cost_budgets
    from partisan_tpu_torch.models.plumtree import Plumtree

    t0 = time.perf_counter()
    budget = cost_budgets.SUPERSTEP_INTERM_BUDGET_MIB
    prog = cost.bench_round_program(cluster=cl, state=st)
    cens = cost.census_program(prog)
    census_s = time.perf_counter() - t0
    mib = cens.total.interm_bytes / 2**20
    if set(cens.phases) != set(JAX_BENCH_PHASES):
        raise AssertionError(f"census phase keys {sorted(cens.phases)} != "
                             f"the reference's {JAX_BENCH_PHASES}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nxt = cl.step(st)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    del nxt
    if cens.total.interm_bytes < rise:
        raise AssertionError(f"census {cens.total.interm_bytes} B of "
                             f"[n, ., .] intermediates under the round's "
                             f"measured rise {rise} B")
    # the window and the capture, measured again (up to PROFILE_ATTEMPTS
    # pairs) while they disagree on device records: a profiler window now
    # and then holds records of an earlier one, handed over late
    attempts = []
    for _ in range(perfwatch.PROFILE_ATTEMPTS):
        window = round_profile(lambda: cl.steps(st, sc.K_PROG), sc.K_PROG,
                               names=True)
        table = tbench.phase_table(cl, st, PT_ROUNDS, names=True)
        bad = census_window_faults(cens, window, table)
        names = sorted(set(window["by_name"]) | set(table["by_name"]))
        diff = {k: [window["by_name"].get(k, 0), table["by_name"].get(k, 0)]
                for k in names
                if window["by_name"].get(k, 0) != table["by_name"].get(k, 0)}
        del window["by_name"], table["by_name"]
        attempts.append({"faults": bad, "records_by_name_differ": diff})
        if not bad:
            break
    else:
        raise AssertionError(f"{len(attempts)} window/capture pairs in a "
                             f"row disagree: {attempts}")
    t1 = time.perf_counter()
    guard100 = soak.Soak(make_cluster=lambda: Cluster(
        tbench.make_cfg(100_000, superstep=SS_R), model=Plumtree()))
    lift100, info100 = guard100._superstep_guard()
    guard100_s = time.perf_counter() - t1
    del guard100
    verdicts = {"32768": mib <= budget, "100000": bool(lift100)}
    want = {n: JAX_SUPERSTEP[n]["lifted"] for n in verdicts}
    if verdicts != want:
        raise AssertionError(f"superstep guard verdicts {verdicts} != "
                             f"JAX {want}")
    runs = {}
    for R in (SS_R, 1):
        eng = soak.Soak(
            make_cluster=lambda R=R: Cluster(cl.cfg.replace(superstep=R),
                                             model=Plumtree()),
            cfg=soak.SoakConfig(chunk_cap=SS_CAP, chunk_fixed=SS_ROUNDS,
                                checkpoint_every=SS_ROUNDS))
        t1 = time.perf_counter()
        res = eng.run(st, rounds=SS_ROUNDS)
        sc._sync(res.state)
        runs[R] = (res, time.perf_counter() - t1)
    fused, plain = runs[SS_R][0], runs[1][0]
    lift = [e for e in fused.log if e["kind"] == "superstep_cap"]
    if [c["k"] for c in fused.chunks] != [SS_ROUNDS] \
            or not lift or not lift[0]["lifted"]:
        raise AssertionError(f"superstep {SS_R}: chunks "
                             f"{[c['k'] for c in fused.chunks]}, {lift}")
    if [c["k"] for c in plain.chunks] != [SS_CAP] * (SS_ROUNDS // SS_CAP):
        raise AssertionError(f"superstep 1: chunks "
                             f"{[c['k'] for c in plain.chunks]}")
    leaves = assert_identical(fused.state, plain.state,
                              f"superstep {SS_R} vs 1 at n={N_MAIN}")
    return {"card": card, "n": N_MAIN, "budget_mib": budget,
            "census": {k: v for k, v in cens.rows()[-1].items()
                       if k != "phase"},
            "census_phases": {r["phase"]: {k: v for k, v in r.items()
                                           if k != "phase"}
                              for r in cens.rows()[:-1]},
            "census_s": census_s, "round_mem_rise_mib": rise / 2**20,
            "verdicts": verdicts, "jax": JAX_SUPERSTEP,
            "guard_100k": info100, "guard_100k_s": guard100_s,
            "window": window, "phase_table": table,
            "window_attempts": attempts,
            "soak": {"superstep": SS_R, "chunk_cap": SS_CAP,
                     "chunk_fixed": SS_ROUNDS, "lift": lift[0],
                     "fused_s": runs[SS_R][1], "plain_s": runs[1][1],
                     "plain_chunks": len(plain.chunks), "leaves": leaves,
                     "state_sha": state_hashes(fused.state)["state_sha"]},
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 41: the sharded cluster
# ---------------------------------------------------------------------------

SHARDS = 4                  # phase 41's shard count (one card, 4 threads)
SHARD_ROUNDS = 20           # rounds of each exchange's parity run
SHARD_RECORD = 10           # record() rounds (SHARDS launches each)
SHARD_HEALTH_N = 4096       # phase 41b's overlay
SHARD_PROFILE_ROUNDS = 10   # each three-way measurement's window


def shard_measure(label: str, cl, st, mesh=None) -> dict:
    """Per round of ``cl.steps(st, SHARD_PROFILE_ROUNDS)``: the wall, and
    from a torch.profiler window the card's launches, device ms and
    device->host copies (each a host read: the shard threads' own reads
    are out of the profiler's host view, so a sharded run's reads are
    counted as the copies they cause), and the bytes the shards received
    from one another at collectives (``Mesh.stats``)."""
    k = SHARD_PROFILE_ROUNDS
    b0 = dict(mesh.stats) if mesh is not None else None
    w = round_profile(lambda: cl.steps(st, k), k)
    out = {"cluster": label, "ms_per_round": w["wall_ms_per_round"],
           "launches_per_round": w["launches_per_round"],
           "device_ms_per_round": w["device_ms_per_round"],
           "device_idle_share": w["device_idle_share"],
           "host_reads_per_round": w["copies_dtoh_per_round"],
           "records_lost": w["records_lost"],
           "collective_bytes_per_round": 0.0,
           "collectives_per_round": 0.0}
    if mesh is not None:
        # round_profile runs the k rounds twice: the bare wall, the window
        out["collective_bytes_per_round"] = \
            (mesh.stats["bytes"] - b0["bytes"]) / (2 * k)
        out["collectives_per_round"] = \
            (mesh.stats["collectives"] - b0["collectives"]) / (2 * k)
    if out["launches_per_round"] <= 0 or out["device_ms_per_round"] <= 0:
        raise AssertionError(f"{label}: the window holds no device work")
    return out


def sharded_main(card: str, cl, st) -> dict:
    """Phase 41a: bench's round at n=32768 on a SHARDS-shard mesh over
    one card, from phase 5's converged state, against the card's
    ``Cluster`` on the same state: SHARD_ROUNDS rounds with the
    all-gather exchange (every leaf equal), the same with the all-to-all
    exchange (every leaf equal, its quota shed nothing), and
    ``record(SHARD_RECORD)`` (state and trace equal; its SHARDS *
    SHARD_RECORD interleave launches held against the plain version on
    the same planes by recording again with the plain version in the
    kernel's place).  Then ms, launches, host reads, device ms and
    collective bytes per round for the Cluster, a 1-shard mesh and the
    SHARDS-shard mesh."""
    from partisan_tpu_torch import kernels
    from partisan_tpu_torch.ops import plane as plane_ops
    from partisan_tpu_torch.parallel import ShardedCluster, make_mesh

    t0 = time.perf_counter()

    def sharded(cfg, S):
        return ShardedCluster(cfg, make_mesh(S, device="cuda:0"),
                              manager=cl.manager, model=cl.model)

    ref = cl.steps(st, SHARD_ROUNDS)
    sc4 = sharded(cl.cfg, SHARDS)
    t1 = time.perf_counter()
    got = sc4.steps(st, SHARD_ROUNDS)
    torch.cuda.synchronize()
    ag_s = time.perf_counter() - t1
    leaves = assert_identical(ref, got, f"{SHARDS} shards all_gather vs "
                              f"Cluster, {SHARD_ROUNDS} rounds")
    del got
    a2a = sharded(cl.cfg.replace(sharded_exchange="all_to_all"), SHARDS)
    t1 = time.perf_counter()
    got = a2a.steps(st, SHARD_ROUNDS)
    torch.cuda.synchronize()
    a2a_s = time.perf_counter() - t1
    shed = a2a.a2a_shed()
    if shed:
        raise AssertionError(f"all_to_all shed {shed} records at "
                             f"n={N_MAIN} on {SHARDS} shards: the oracle is "
                             "then the JAX package's sharded run")
    assert_identical(ref, got, f"{SHARDS} shards all_to_all vs Cluster")
    del got, ref, a2a

    # record: the kernel's launches, counted from 0
    kernels.reset_launches()
    st_s, tr_s = sc4.record(st, SHARD_RECORD)
    torch.cuda.synchronize()
    rec_launches = dict(kernels.launches)
    if rec_launches["interleave"] != SHARDS * SHARD_RECORD:
        raise AssertionError(f"sharded record({SHARD_RECORD}) launched "
                             f"{rec_launches}, want {SHARDS * SHARD_RECORD}"
                             " interleave")
    st_l, tr_l = cl.record(st, SHARD_RECORD)
    assert_identical(st_l, st_s, "sharded record state vs Cluster")
    assert_identical(tr_l, tr_s, "sharded record trace vs Cluster")
    del st_l, tr_l
    # the plain twin: the same record with the plain version in place
    kernel_interleave = plane_ops.interleave
    plane_ops.interleave = lambda p, out=None: \
        plane_ops.interleave_plain(list(p), out=out)
    try:
        base = dict(kernels.launches)
        _, tr_p = sc4.record(st, SHARD_RECORD)
        torch.cuda.synchronize()
        if dict(kernels.launches) != base:
            raise AssertionError("the plain twin launched a kernel")
    finally:
        plane_ops.interleave = kernel_interleave
    err = int((tr_p.sent.to(torch.int64) - tr_s.sent.to(torch.int64))
              .abs().max())
    if err != 0 or not torch.equal(tr_p.dropped, tr_s.dropped):
        raise AssertionError(f"sharded record: kernel vs plain max abs "
                             f"error {err}")
    trace_shape = list(tr_s.sent.shape)
    del st_s, tr_s, tr_p

    sc1 = sharded(cl.cfg, 1)
    runs = [shard_measure("Cluster", cl, st),
            shard_measure("1 shard", sc1, st, sc1.mesh),
            shard_measure(f"{SHARDS} shards", sc4, st, sc4.mesh)]
    return {"card": card, "n": N_MAIN, "shards": SHARDS,
            "rounds": SHARD_ROUNDS, "leaves": leaves,
            "all_gather_s": ag_s, "all_to_all_s": a2a_s,
            "all_to_all_shed": shed,
            "record": {"rounds": SHARD_RECORD, "trace_shape": trace_shape,
                       "launches": rec_launches, "max_abs_err": err},
            "runs": runs, "seconds": time.perf_counter() - t0}


def sharded_health(card: str) -> dict:
    """Phase 41b: tests/test_sharded_health.py's digest case (HyParView,
    ``health=5``, ``health_ring=32``, groups partitions) scaled to
    n=SHARD_HEALTH_N: four join waves of n/4 nodes via node 0 (10 rounds
    each), three crashes and the first 3/8 of the nodes partitioned off
    for 10 rounds, healed, 20 more rounds — on SHARDS shards, on 1 shard
    and on the card's ``Cluster``: the digests, the health rings and
    every other leaf equal."""
    from partisan_tpu_torch import faults, health
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.parallel import ShardedCluster, make_mesh

    n = SHARD_HEALTH_N
    cfg = Config(n_nodes=n, seed=13, peer_service_manager="hyparview",
                 msg_words=16, health=5, health_ring=32,
                 partition_mode="groups")

    def drive(cl):
        st = cl.init()
        for base in range(1, n, n // 4):
            nodes = list(range(base, min(base + n // 4, n)))
            st = st._replace(manager=cl.manager.join_many(
                cfg, st.manager, nodes, [0] * len(nodes)))
            st = cl.steps(st, 10)
        f = faults.crash_many(st.faults, [7, n // 3, n // 2 + 40])
        part = f.partition.clone()
        part[: 3 * n // 8] = 1
        st = cl.steps(st._replace(faults=f._replace(partition=part)), 10)
        st = st._replace(faults=st.faults._replace(
            partition=torch.zeros_like(part)))
        st = cl.steps(st, 10)
        return cl.steps(st, 10)

    out, walls = {}, {}
    for label, make in (
            ("Cluster", lambda: Cluster(cfg)),
            ("1 shard", lambda: ShardedCluster(cfg, make_mesh(1, "cuda:0"))),
            (f"{SHARDS} shards",
             lambda: ShardedCluster(cfg, make_mesh(SHARDS, "cuda:0")))):
        t0 = time.perf_counter()
        out[label] = drive(make())
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
    digests = {k: health.digest(v) for k, v in out.items()}
    if len(set(digests.values())) != 1:
        raise AssertionError(f"health digests differ: {digests}")
    ref = out["Cluster"]
    leaves = 0
    for label, st in out.items():
        leaves = assert_identical(ref, st, f"health n={n}: {label}")
    snap = health.snapshot(ref.health)
    if int(snap["components"].max()) <= 1 or int(snap["downs"].sum()) != 3:
        raise AssertionError(f"health n={n}: the ring shows no split or "
                             f"not the 3 downs: {snap['components']}, "
                             f"{snap['downs']}")
    return {"card": card, "n": n, "shards": SHARDS, "digest": digests,
            "decoded": health.decode_digest(digests["Cluster"]),
            "components_max": int(snap["components"].max()),
            "downs": int(snap["downs"].sum()), "leaves": leaves,
            "wall_s": walls}


def sharded_entry() -> dict:
    """Phase 41c (in the card worker): ``python -m
    partisan_tpu_torch.bench --one 100000 --extras PATH`` with
    ``PARTISAN_SHARDS=SHARDS``: it must take the sharded arm (its
    ``cluster`` line: ``ShardedCluster``, SHARDS shards), and its
    converged round, counts, coverage and final state (every leaf by
    hash) equal the JAX package's (``JAX_BENCH``, phase 31's oracle)."""
    want = JAX_BENCH
    extras = "build/bench_entry_sharded_extras.json"
    if os.path.exists(extras):
        os.remove(extras)
    cmd = [sys.executable, "-m", "partisan_tpu_torch.bench", "--one",
           str(want["n"]), "--extras", extras]
    env = dict(os.environ, PARTISAN_SHARDS=str(SHARDS))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"sharded bench --one {want['n']}: exit "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    arm = [json.loads(line) for line in proc.stderr.splitlines()
           if line.startswith('{"kind": "cluster"')]
    if arm != [{"kind": "cluster", "n": want["n"],
                "type": "ShardedCluster", "shards": SHARDS}]:
        raise AssertionError(f"sharded bench --one {want['n']}: arm {arm}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if set(res) != BENCH_ONE_KEYS:
        raise AssertionError(f"sharded bench --one printed {sorted(res)}")
    with open(extras) as f:
        ex = json.load(f)
    got = {k: res[k] for k in ("n", "converged_round", "convergence_rounds",
                               "dropped", "emitted")}
    got.update(rnd=res["converged_round"], state_sha=ex["state_sha"])
    if ex["coverage"] != 1.0:
        raise AssertionError(f"sharded bench: coverage {ex['coverage']}")
    for key, w in want.items():
        if key != "leaf_hashes" and got.get(key) != w:
            bad = [i for i, (h, x) in enumerate(zip(ex["leaf_hashes"],
                                                    want["leaf_hashes"]))
                   if h != x]
            raise AssertionError(f"sharded bench n={want['n']} {key}: card "
                                 f"{got.get(key)} != JAX {w} (leaves {bad} "
                                 "differ)")
    return {"command": "PARTISAN_SHARDS=%d " % SHARDS + " ".join(cmd[1:]),
            "arm": arm[0], **got, "coverage": ex["coverage"],
            "rounds_per_sec": res["rounds_per_sec"],
            "convergence_wall_s": res["convergence_wall_s"],
            "bootstrap_s": res["phases"]["bootstrap"],
            "phases": res["phases"], "process_wall_s": wall,
            "peak_mem_gib": ex["peak_mem_gib"], "launches": ex["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    # 0. the CPU halves of the parity phases run beside the card's
    CPU.start()
    done = False
    try:
        run_phases(card, kind)
        done = True
    finally:
        CPU.stop(check=done)
        CARD.stop(check=done)
    print(f"chip_smoke wall {time.perf_counter() - t_all:.1f}s",
          file=sys.stderr)
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


def run_phases(card: str, kind: str) -> None:
    """Phases 1-41 and the kernels line (main prints the last two
    lines)."""
    from partisan_tpu_torch import bench as tbench
    from partisan_tpu_torch import kernels, probe
    from partisan_tpu_torch import scenarios as sc
    from partisan_tpu_torch.config import Config
    from partisan_tpu_torch.ops import plane as plane_ops
    from torch.profiler import ProfilerActivity, profile

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

    # the process's first torch.profiler session starts CUPTI: kept out of
    # the measured windows
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda").add_(1)
        torch.cuda.synchronize()

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
    c_boot, c_st, c_tr, c_conv = cpu_half("drive_small")
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

    # 5. the main path at n=32768 through the bench entry's run, kernel
    # counts reset just before
    kernels.reset_launches()
    run = tbench.run(N_MAIN, handles=True)
    cl, model, st = run["cluster"], run["model"], run["state"]
    conv = run["converged_round"]
    coverage = float(model.coverage(st.model, st.faults.alive, 0))
    if coverage != 1.0:
        raise AssertionError(f"n={N_MAIN}: coverage {coverage}, not 1.0")
    got = {k: run[k] for k in ("n", "converged_round", "convergence_rounds",
                               "dropped", "emitted")}
    got["rnd"] = int(st.rnd)
    main_sha = hold_to(JAX_BENCH_MAIN, got, st, f"bench n={N_MAIN}")
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
         "init_s": run["phases"]["init"],
         "bootstrap_s": run["phases"]["bootstrap"],
         "converged_round": conv,
         "convergence_rounds": conv - run["start_round"],
         "convergence_wall_s": run["convergence_wall_s"],
         "coverage": coverage, "state_sha": main_sha,
         "rounds_per_sec": rps, "bench_rounds_per_sec":
         run["rounds_per_sec"], "record10_s": t_rec,
         "stats": {"emitted": int(st.stats.emitted),
                   "delivered": int(st.stats.delivered),
                   "dropped": int(st.stats.dropped)},
         "launches": counts, "peak_mem_gib":
         torch.cuda.max_memory_allocated() / 2 ** 30})
    del tr, st2
    cl5, st5 = cl, st
    boot_main = run["boot_state"]
    del run

    # 30. the legacy ladder at n=32768 against phase 5's boot state
    ll = legacy_ladder_full(card, boot_main)
    log({"phase": "legacy_ladder", **ll})

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

    # phases 21 and 23 run in the card worker from here on, after the
    # kernel timings of phases 3 and 6; it profiles nothing, since this
    # process profiles to the end
    CARD.start()

    # 7. Filibuster parity, small: the card against the CPU
    t0 = time.perf_counter()
    g_res = [result_fields(r) for r in fb_setups("cuda")]
    c_res = cpu_half("fb_setups")
    if g_res != c_res:
        raise AssertionError(f"Filibuster results differ: card {g_res}, "
                             f"CPU {c_res}")
    g_st, g_tr = omission_record("cuda", g_boot)
    c_st, c_tr = cpu_half("omission_record")
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

    # 40. the round-cost census, the phase table and the superstep cap
    # lift on phase 5's state, in this process (it profiles and captures)
    cf = census_full(card, cl5, st5)
    log({"phase": "census", **cf})

    # 41a. the sharded cluster on phase 5's state, counts reset just
    # before the sharded runs and read just after; 41b and 41c then run
    # in the card worker
    kernels.reset_launches()
    sh = sharded_main(card, cl5, st5)
    del cl5, st5
    sh_counts = dict(kernels.launches)
    log({"phase": "sharded", **sh, "launches": sh_counts})
    CARD.go("sharded")

    # 20. the flight ring at full width, counts reset inside
    t0 = time.perf_counter()
    fl = flight_full(card, run19)
    log({"phase": "flight", **fl, "seconds": time.perf_counter() - t0})
    del run19

    # 21. the controllers' A/B at the reference's sizes (card worker)
    ca, ca_counts, ca_s = CARD.get("control_ab")
    log({"phase": "control_ab", **ca, "launches": ca_counts,
         "seconds": ca_s})

    # 22. traffic, watchdog and soak parity, small: card against CPU
    kernels.reset_launches()
    t0 = time.perf_counter()
    tp = traffic_parity(card)
    log({"phase": "traffic_parity", **tp,
         "seconds": time.perf_counter() - t0})

    # 23. the traffic SLO suite at scale 1.0 (card worker)
    ts, ts_counts, ts_s = CARD.get("traffic_slo")
    log({"phase": "traffic_slo", **ts, "launches": ts_counts,
         "seconds": ts_s})

    # 24. config 7 at its defaults
    kernels.reset_launches()
    c7 = config7_full(card)
    c7_counts = dict(kernels.launches)
    log({"phase": "config7", **c7, "launches": c7_counts})

    # 25. the black box at full width, counts reset inside
    t0 = time.perf_counter()
    bb = blackbox_full(card)
    log({"phase": "blackbox", **bb, "seconds": time.perf_counter() - t0})

    # 26. elastic and ingress parity, small, counts reset just before
    kernels.reset_launches()
    t0 = time.perf_counter()
    ep = elastic_parity(card)
    log({"phase": "elastic_parity", **ep,
         "seconds": time.perf_counter() - t0})

    # 27. config 9 at n=8192 (what --elastic runs), counts reset just before
    kernels.reset_launches()
    c9 = config9_full(card)
    c9_counts = dict(kernels.launches)
    log({"phase": "config9", **c9, "launches": c9_counts})

    # 28. ingress at full width, counts reset just before
    kernels.reset_launches()
    ig = ingress_full(card)
    ig_counts = dict(kernels.launches)
    log({"phase": "ingress_full", **ig, "launches": ig_counts})

    # 29. the spool and pipelined dispatch, counts reset inside
    sp29 = spool_pipeline(card)
    log({"phase": "spool_pipeline", **sp29})

    # 32. X-BOT with the distance plane at n=10,000, counts reset inside
    xb = xbot_full(card)
    log({"phase": "xbot", **xb})

    # 33. X-BOT and distance parity, small, counts reset inside
    t0 = time.perf_counter()
    xp = xbot_parity(card)
    log({"phase": "xbot_parity", **xp, "seconds": time.perf_counter() - t0})

    # 34. the OTP storm at n=10,000, counts reset inside
    of = otp_full(card)
    log({"phase": "otp", **of})

    # 35. the OTP storm at n=64 through otp.sys, card against CPU and JAX
    t0 = time.perf_counter()
    op = otp_parity(card)
    log({"phase": "otp_parity", **op, "seconds": time.perf_counter() - t0})

    # 36. the bridge on the card (card worker): the port server's pipe and
    # trace16
    br, br_counts, br_s = CARD.get("bridge")
    log({"phase": "bridge", **bridge_phase(card, br), "launches": br_counts,
         "seconds": br_s})

    # 37. the fleet sweep at W=64 x n=1024, counts reset inside
    t0 = time.perf_counter()
    ff = fleet_full(card)
    log({"phase": "fleet_sweep", **ff, "seconds": time.perf_counter() - t0})

    # 38. the W=64 schedule search, counts reset inside
    t0 = time.perf_counter()
    fs = fleet_search_full(card)
    log({"phase": "fleet_search", **fs,
         "seconds": time.perf_counter() - t0})

    # 39. the member storms card == CPU == JAX, and fleet.tune
    t0 = time.perf_counter()
    fp39 = fleet_parity(card)
    log({"phase": "fleet_parity", **fp39,
         "seconds": time.perf_counter() - t0})

    # 31. the bench entry at n=100,000 in its own process, after this
    # process's last profiled window (its profiler would spoil later ones)
    be = bench_entry_full(card)
    log({"phase": "bench_entry", **be})

    # 41b. the health plane's segment-local kernels at n=4096 (card worker)
    shh, shh_counts, shh_s = CARD.get("sharded_health")
    log({"phase": "sharded_health", **shh, "launches": shh_counts,
         "seconds": shh_s})

    # 41c. the sharded-by-default bench entry at n=100,000 (card worker)
    se, _, se_s = CARD.get("sharded_entry")
    if se["converged_round"] != be["converged_round"]:
        raise AssertionError(f"sharded entry converged at "
                             f"{se['converged_round']}, phase 31 at "
                             f"{be['converged_round']}")
    log({"phase": "sharded_entry", "card": card, **se, "seconds": se_s})

    new_paths = {"causal_parity": lp_counts, "config5": c5_counts,
                 "config6": c6_counts, "app_parity": ap_counts,
                 "harness": hp_counts, "filibuster_paxos": fp["launches"],
                 "app_models": am_counts, "planes_parity": pp_counts,
                 "bench_planes": bp["launches"], "flight": fl["launches"],
                 "control_ab": ca_counts, "traffic_parity": tp["launches"],
                 "traffic_slo": ts_counts, "config7": c7_counts,
                 "blackbox": bb["launches"], "elastic_parity": ep["launches"],
                 "config9": c9_counts, "ingress_full": ig_counts,
                 "spool_pipeline": sp29["launches"],
                 "legacy_ladder": ll["launches"],
                 "bench_entry_100k": be["launches"],
                 "xbot_10k": xb["launches"], "xbot_parity": xp["launches"],
                 "otp_10k": of["launches"], "otp_parity": op["launches"],
                 "bridge": br_counts, "fleet_sweep": ff["launches"],
                 "fleet_search": fs["launches"],
                 "fleet_parity": fp39["launches"],
                 "sharded": sh_counts, "sharded_health": shh_counts,
                 "sharded_entry_100k": se["launches"]}
    ingress_check = ep["ingress_record"]["kernel_check"]

    log({"phase": "profiler", "windows_measured_again":
         perfwatch.incomplete_windows,
         "records_lost_in_kept_windows": perfwatch.records_lost})

    # the kernels line (main prints the card line and the result)
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
        and bb["ring_kernel_check"]["max_abs_err"] == 0
        and ingress_check["max_abs_err"] == 0
        and all(r["max_abs_err"] == 0 for r in edges),
        "max_abs_err": max([main_check["max_abs_err"], ragged["max_abs_err"],
                            planes_check["max_abs_err"],
                            bb["ring_kernel_check"]["max_abs_err"],
                            ingress_check["max_abs_err"]]
                           + [r["max_abs_err"] for r in edges]),
        "w19": {k: planes_check[k] for k in timing_keys},
        "config7_ring": {k: bb["ring_kernel_check"][k]
                         for k in ("shape", "words") + timing_keys},
        "ingress_record": {k: ingress_check[k]
                           for k in ("shape", "words") + timing_keys},
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


if __name__ == "__main__":
    sys.exit({"--cpu-halves": cpu_halves, "--card-worker": card_worker}
             .get(" ".join(sys.argv[1:]), main)())
