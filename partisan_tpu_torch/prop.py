"""Property-based distributed testing harness (port of
``partisan_tpu/prop.py``, line for line).

Mirrors the reference's PropEr state-machine harness ``prop_partisan.erl``
(1162 LoC): a generic runner is parameterized by a **system model**
(node_commands / node_initial_state / node_postconditions —
prop_partisan.erl:1097-1113) and a **fault model** (fault_commands with a
tolerance budget — :1038-1040; crash + omission commands,
prop_partisan_crash_fault_model.erl:33-37, :158-190), under one of three
**schedulers** (default / finite_fault / single_success — :66-108).

Commands are host-side scenario actions between round batches;
randomness is a seeded ``random.Random`` so every run replays from its
seed (the PropEr shrink-replay loop).  On failure the harness greedily
shrinks the command sequence (SHRINKING mode) and reports the minimal
failing script.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Protocol

from partisan_tpu_torch import faults as faults_mod


@dataclasses.dataclass(frozen=True)
class Command:
    """One scripted action: ``apply(cluster, state) -> state``.
    ``kind`` is "node" (system model) or "fault" (fault model)."""

    name: str
    args: tuple
    apply: Callable[[Any, Any], Any]
    kind: str = "node"

    def __repr__(self) -> str:  # readable counterexamples
        return f"{self.name}{self.args}"


class SystemModel(Protocol):
    """The node_commands/node_initial_state/node_postconditions triple."""

    name: str

    def build(self) -> tuple[Any, Any]:
        """Boot the system; returns (cluster, booted state)."""
        ...

    def gen_command(self, rng: random.Random, cl: Any, st: Any) -> Command:
        ...

    def postcondition(self, cl: Any, st: Any,
                      script: list["Command"]) -> bool:
        """Checked after the run settles (node_postconditions).  ``script``
        is the executed command list, so the model can derive which
        operations were issued (the PropEr symbolic-state analogue)."""
        ...

    def settle_rounds(self) -> int:
        ...


class FaultModel(Protocol):
    tolerance: int

    def gen_fault(self, rng: random.Random, cl: Any, st: Any) -> Command:
        ...


# ---------------------------------------------------------------------------
# Fault models
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CrashFaultModel:
    """Crash-stop + omission faults with a tolerance bound
    (prop_partisan_crash_fault_model.erl:33-37: begin/end send+receive
    omissions, crash/stop, bounded by FAULT_TOLERANCE)."""

    tolerance: int = 1
    allow_crash: bool = True
    allow_omission: bool = True
    protect: frozenset = frozenset()   # nodes that must stay up (e.g. primary)

    def gen_fault(self, rng: random.Random, cl: Any, st: Any) -> Command:
        n = cl.cfg.n_nodes
        choices = []
        victims = [i for i in range(n) if i not in self.protect]
        if self.allow_crash and victims:
            choices.append("crash")
        if self.allow_omission:
            choices.append("omission")
        if not choices:
            raise ValueError(
                "CrashFaultModel: no fault kind available (crash disabled "
                "or all nodes protected, and omission disabled)")
        kind = rng.choice(choices)
        if kind == "crash":
            node = rng.choice(victims)
            return Command(
                name="crash", args=(node,), kind="fault",
                apply=lambda c, s, _node=node: s._replace(
                    faults=faults_mod.crash(s.faults, _node)))
        src = rng.randrange(n)
        dst = rng.choice([i for i in range(n) if i != src])
        return Command(
            name="omit_edge", args=(src, dst), kind="fault",
            apply=lambda c, s, _s=src, _d=dst: s._replace(
                faults=faults_mod.inject_partition(s.faults, [_s], [_d])))


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    ok: bool
    seed: int
    commands: list[Command]
    shrunk: list[Command] | None = None

    def render(self) -> str:
        if self.ok:
            return f"prop: PASSED (seed={self.seed}, " \
                   f"{len(self.commands)} commands)"
        script = self.shrunk if self.shrunk is not None else self.commands
        lines = [f"prop: FAILED (seed={self.seed}); minimal script:"]
        lines += [f"  {c}" for c in script]
        return "\n".join(lines)


@dataclasses.dataclass
class Harness:
    """``n_runs`` random command sequences; each run boots fresh, applies
    ``n_commands`` commands (node and — under the finite_fault scheduler —
    fault commands up to the tolerance budget), settles, and checks the
    postcondition (prop_partisan.erl run loop; Makefile:80-81 runs 10)."""

    system: SystemModel
    fault_model: FaultModel | None = None
    scheduler: str = "default"   # default | finite_fault | single_success
    n_runs: int = 10
    n_commands: int = 8
    rounds_between: int = 2
    seed: int = 0
    heal_before_settle: bool = True   # omissions are transient windows:
    # partitions injected by fault commands resolve before the settle
    # phase (the end_omission command of the crash fault model,
    # prop_partisan_crash_fault_model.erl:158-190)

    def _one_run(self, seed: int) -> RunResult:
        script = self._gen_script(seed)
        ok = self._execute(script)
        if ok:
            return RunResult(ok=True, seed=seed, commands=script)
        return RunResult(ok=False, seed=seed, commands=script,
                         shrunk=self._shrink(script))

    def _gen_script(self, seed: int) -> list[Command]:
        rng = random.Random(seed)
        cl, st = self.system.build()     # only for generator context
        faults_left = (self.fault_model.tolerance
                       if (self.fault_model is not None
                           and self.scheduler == "finite_fault") else 0)
        script: list[Command] = []
        for _ in range(self.n_commands):
            if faults_left and rng.random() < 0.3:
                script.append(self.fault_model.gen_fault(rng, cl, st))
                faults_left -= 1
            else:
                script.append(self.system.gen_command(rng, cl, st))
        return script

    def _execute(self, script: list[Command]) -> bool:
        cl, st = self.system.build()
        for cmd in script:
            st = cmd.apply(cl, st)
            st = cl.steps(st, self.rounds_between)
        if self.heal_before_settle:
            st = st._replace(
                faults=faults_mod.resolve_partition(st.faults))
        st = cl.steps(st, self.system.settle_rounds())
        return bool(self.system.postcondition(cl, st, script))

    def _shrink(self, script: list[Command]) -> list[Command]:
        """Greedy delta-debugging: drop commands that aren't needed for
        the failure (the reference shrinks via PropEr + the SHRINKING
        replay flag, partisan_config.erl:593-607)."""
        current = list(script)
        changed = True
        while changed:
            changed = False
            for i in range(len(current)):
                trial = current[:i] + current[i + 1:]
                if trial and not self._execute(trial):
                    current = trial
                    changed = True
                    break
        return current

    def run(self) -> RunResult:
        last = None
        for i in range(self.n_runs):
            res = self._one_run(self.seed + i)
            if not res.ok:
                return res
            last = res
            if self.scheduler == "single_success":
                return res
        return last
