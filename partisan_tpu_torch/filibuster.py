"""Filibuster: counterexample-guided omission-fault model checking (port
of ``partisan_tpu/filibuster.py``; the search is the reference's, line
for line, so execution and prune counts match).

Mirrors the reference's fault-injection pipeline (test/filibuster_SUITE.erl,
driven by bin/check-model.sh:17-28 / bin/filibuster.sh:31-33):

1. record a passing execution (the golden trace),
2. generate schedules of send omissions against the observed messages,
   bounded by a fault-tolerance budget (``FAULT_TOLERANCE``,
   prop_partisan_crash_fault_model.erl:33-37),
3. prune invalid/equivalent schedules: an omission is only meaningful for
   a message that was actually sent in the parent execution — the dynamic
   analogue of the reference's causality-annotation pruning
   (schedule_valid_causality, filibuster_SUITE.erl:1023;
   classify_schedule :1155-1192),
4. execute each schedule by preloading it as an interposition
   (partisan_trace_orchestrator.erl:598-650 → interpose.OmissionSchedule),
5. on failure, shrink the counterexample by greedily re-executing with
   omissions removed (the SHRINKING/REPLAY loop,
   partisan_config.erl:593-607).

Determinism makes each execution a pure function of its schedule, so the
checker needs no replay machinery beyond re-running (SURVEY.md §5.3:
"omissions/crashes = boolean masks over the ... message tensors per
round"; the north star explicitly requires replaying filibuster schedules
against the simulated manager).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Iterable

from partisan_tpu_torch import interpose, trace as trace_mod

Coord = tuple[int, int, int]          # (absolute round, sender, emit slot)


@dataclasses.dataclass
class Execution:
    """One executed schedule and its outcome."""

    schedule: frozenset[Coord]
    trace: trace_mod.Trace
    passed: bool


@dataclasses.dataclass
class Result:
    passed: bool                      # no counterexample within budget
    executions: int                   # schedules actually run
    pruned: int                       # schedules skipped by pruning
    counterexample: Execution | None  # minimal failing schedule (shrunk)
    candidates: int                   # distinct omission candidates seen
    base_trace: trace_mod.Trace | None = None

    def render(self) -> str:
        """Human-readable verdict (the counterexample print of
        bin/counterexample-find.sh; omitted messages are described from
        the fault-free golden trace since they never hit the wire in the
        failing one)."""
        if self.passed:
            return (f"filibuster: PASSED — {self.executions} executions, "
                    f"{self.pruned} pruned, {self.candidates} candidates")
        by_coord = {}
        if self.base_trace is not None:
            by_coord = {(e.rnd, e.src, e.slot): e
                        for e in self.base_trace.events()}
        lines = [f"filibuster: FAILED — minimal counterexample "
                 f"({len(self.counterexample.schedule)} omissions, "
                 f"{self.executions} executions):"]
        for coord in sorted(self.counterexample.schedule):
            ev = by_coord.get(coord)
            if ev is not None:
                lines.append(f"  omit r={ev.rnd} {ev.src} => {ev.dst} "
                             f"{ev.kind_name} payload={list(ev.payload)}")
            else:
                lines.append(f"  omit (rnd={coord[0]}, src={coord[1]}, "
                             f"slot={coord[2]})")
        return "\n".join(lines)


@dataclasses.dataclass
class Checker:
    """``build(interposition) -> (cluster, initial_state)`` constructs the
    system under test — called ONCE with a zeroed
    ``interpose.OmissionSchedule``; every schedule execution then swaps
    the schedule into the initial state and re-runs the same cluster
    (the reference re-boots its ct fixture per schedule; determinism
    lets us reuse the booted state).  ``assertion(cluster, final_state) -> bool`` is the
    system model's postcondition.  ``candidate(TraceEvent) -> bool`` marks
    messages eligible for omission (the annotation files' message classes,
    annotations/partisan-annotations-*)."""

    build: Callable[[Any], tuple[Any, Any]]
    horizon: int
    assertion: Callable[[Any, Any], bool]
    candidate: Callable[[trace_mod.TraceEvent], bool]
    max_faults: int = 1
    max_executions: int = 200
    sched_width: int = 64   # >= emission width (OmissionSchedule clips)
    # OPT-IN causality-annotation pruning (analysis.reaction_graph /
    # analysis.ensemble_reaction): omissions of kinds whose closure
    # cannot reach any ``target_kinds`` are skipped (the reference feeds
    # partisan_analysis output into schedule_valid_causality the same
    # way, filibuster_SUITE.erl:1023).  SOUNDNESS CAVEAT: the reference
    # derives its graph from STATIC source analysis, which
    # over-approximates and is sound; trace-derived graphs
    # UNDER-approximate — a reaction no trace exercised (in particular
    # any ABSENCE-triggered reaction, which never appears as a receipt
    # edge) is invisible, and pruning against it can skip the very
    # schedule that triggers a bug.  The default (None) prunes nothing
    # and is exhaustive within the budget; pass a graph only as a
    # search-cost optimization, preferably an ensemble union with a
    # saturating coverage report, and never for protocols with
    # absence-triggered behavior outside the built-in ack lane.
    reaction: dict | None = None
    target_kinds: tuple = ()

    def __post_init__(self) -> None:
        import numpy as np

        self._np = np
        self._closure = None   # transitive closure of `reaction`, cached
        # Probe shape-free: build with a 1-round zero schedule to learn n
        # and the boot round, then rebuild the canonical-size schedule
        # state directly (same cluster — only state is remade).
        self._cl, self._st0 = self.build(interpose.OmissionSchedule(
            np.zeros((1, 1, 1), np.bool_), start=0))
        n = self._cl.cfg.n_nodes
        self._total = int(self._st0.rnd) + self.horizon
        zeros = np.zeros((self._total, n, self.sched_width), np.bool_)
        self._st0 = self._st0._replace(interpose=self._sched_state(zeros))

    def _sched_state(self, drops):
        """Build the schedule state through OmissionSchedule.init — the
        single source of truth for the compiled apply()'s state layout."""
        return interpose.OmissionSchedule(drops, start=0).init(
            self._cl.cfg, self._cl.comm)

    # ---- one execution -------------------------------------------------
    def _execute(self, schedule: frozenset[Coord]) -> Execution:
        drops = schedule_drops(schedule, self._total,
                               self._cl.cfg.n_nodes, self.sched_width)
        st = self._st0._replace(interpose=self._sched_state(drops))
        st, cap = self._cl.record(st, self.horizon)
        tr = trace_mod.from_capture(cap)
        return Execution(schedule=schedule, trace=tr,
                         passed=bool(self.assertion(self._cl, st)))

    def _relevant_kind(self, kind_name: str) -> bool:
        if self.reaction is None or not self.target_kinds:
            return True
        if self._closure is None:
            from partisan_tpu_torch import analysis

            self._closure = analysis.closure(self.reaction)
        reach = self._closure.get(kind_name, set())
        return any(t == kind_name or t in reach for t in self.target_kinds)

    def _candidates(self, tr: trace_mod.Trace) -> list[Coord]:
        return [(e.rnd, e.src, e.slot) for e in tr.events()
                if not e.dropped and self.candidate(e)
                and self._relevant_kind(e.kind_name)]

    # ---- shrinking (counterexample-replay.sh / SHRINKING) --------------
    def _shrink(self, cex: Execution) -> Execution:
        current = cex
        for om in sorted(cex.schedule):
            if om not in current.schedule or len(current.schedule) == 1:
                continue
            trial = self._execute(current.schedule - {om})
            if not trial.passed:
                current = trial
        return current

    # ---- the search ----------------------------------------------------
    def run(self, *, verbose: bool = False) -> Result:
        base = self._execute(frozenset())
        if not base.passed:
            return Result(passed=False, executions=1, pruned=0,
                          counterexample=base, candidates=0,
                          base_trace=base.trace)

        seen: set[frozenset[Coord]] = {frozenset()}
        all_candidates: set[Coord] = set(self._candidates(base.trace))
        executions, pruned = 1, 0
        # Worklist of (schedule, parent-observed candidates): extend each
        # passing execution's schedule with one more omission drawn from
        # messages observed IN THAT execution (causality-valid schedules
        # only — an omission of a never-sent message is equivalent to its
        # parent, filibuster_SUITE.erl:1155-1192).
        work: list[tuple[frozenset[Coord], list[Coord]]] = [
            (frozenset(), self._candidates(base.trace))]
        while work and executions < self.max_executions:
            schedule, cands = work.pop(0)
            if len(schedule) >= self.max_faults:
                continue
            for om in cands:
                nxt = schedule | {om}
                if nxt in seen:
                    pruned += 1
                    continue
                seen.add(nxt)
                ex = self._execute(nxt)
                executions += 1
                if verbose:
                    print(f"  schedule {sorted(nxt)} -> "
                          f"{'pass' if ex.passed else 'FAIL'}")
                if not ex.passed:
                    cex = self._shrink(ex)
                    return Result(passed=False, executions=executions,
                                  pruned=pruned, counterexample=cex,
                                  candidates=len(all_candidates),
                                  base_trace=base.trace)
                obs = self._candidates(ex.trace)
                all_candidates.update(obs)
                # Only extend with omissions at/after the newest one to
                # avoid permuted duplicates (schedules are sets; ordering
                # by coordinate canonicalizes the enumeration).
                newest = max(nxt)
                later = [c for c in obs if c > newest and c not in nxt]
                if later and len(nxt) < self.max_faults:
                    work.append((nxt, later))
                if executions >= self.max_executions:
                    break
        return Result(passed=True, executions=executions, pruned=pruned,
                      counterexample=None, candidates=len(all_candidates),
                      base_trace=base.trace)


def schedule_drops(schedule, total: int, n: int, width: int):
    """Compile omission coordinates into the drops tensor an
    ``interpose.OmissionSchedule`` executes.

    ONE schedule (an iterable of ``(absolute round, sender, emit slot)``
    coordinates) compiles to ``bool[total, n, width]``; a BATCH of ``W``
    schedules (an iterable of schedules) to the stacked
    ``bool[W, total, n, width]``.  Row ``t`` applies at absolute round
    ``t``; rounds at or past ``total`` pass everything.  Out-of-range
    coordinates raise: a silently clipped omission would make the checker
    report a schedule "tolerated" that it never actually ran.
    """
    import numpy as np

    sched = list(schedule)

    def is_coord(c):
        # a coordinate is any 3-sequence of ints (tuples from the
        # trace, lists from JSON) — anything else is a nested schedule
        return (isinstance(c, (tuple, list)) and len(c) == 3
                and all(isinstance(x, (int, np.integer)) for x in c))

    if sched and not is_coord(sched[0]):
        # batch of schedules -> stacked [W, total, n, width]
        return np.stack([schedule_drops(s, total, n, width)
                         for s in sched])
    drops = np.zeros((total, n, width), np.bool_)
    for (r, s, e) in sched:
        if e >= width:
            raise ValueError(f"emit slot {e} >= sched_width {width}; "
                             "raise sched_width")
        if not 0 <= r < total:
            raise ValueError(
                f"omission round {r} outside the schedule window "
                f"[0, {total}) — size the schedule to cover the "
                "execution horizon")
        drops[r, s, e] = True
    return drops


def app_messages(ev: trace_mod.TraceEvent) -> bool:
    """Default candidate class: application-lane messages (the reference
    omits protocol messages of the system under test, not membership
    gossip — annotations/partisan-annotations-* background sets)."""
    from partisan_tpu_torch import types as T
    return ev.kind in (T.MsgKind.APP, T.MsgKind.RPC_CALL,
                       T.MsgKind.RPC_RESPONSE)


def iter_schedules(candidates: Iterable[Coord], k: int):
    """Exhaustive ≤k-subset enumeration (the static schedule generator;
    the Checker uses the dynamic trace-guided variant instead)."""
    cands = sorted(set(candidates))
    for r in range(1, k + 1):
        yield from (frozenset(c) for c in itertools.combinations(cands, r))
