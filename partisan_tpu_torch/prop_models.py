"""System models for the property harness (port of
``partisan_tpu/prop_models.py``).

Mirrors the reference's model zoo: ``prop_partisan_noop.erl`` (78 LoC),
``prop_partisan_reliable_broadcast.erl`` (389), ``prop_partisan_
primary_backup.erl`` (388); the application-under-test models (hbbft,
paxoid, zraft, riak_ensemble, lashup) are external apps and out of scope
— the corpus equivalents here run against models/ protocols.

Every system takes ``device`` (default ``None``: the card); its Cluster
and every tensor it builds live there.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any

import torch

from partisan_tpu_torch.cluster import Cluster
from partisan_tpu_torch.config import Config
from partisan_tpu_torch.models.alsberg_day import AlsbergDay
from partisan_tpu_torch.models.commit import CommitProtocol
from partisan_tpu_torch.models.direct_mail import DirectMail
from partisan_tpu_torch.models.paxos import Paxos
from partisan_tpu_torch.prop import Command


def _boot_fullmesh(cl: Cluster, settle: int = 15):
    st = cl.init()
    m = st.manager
    for i in range(1, cl.cfg.n_nodes):
        m = cl.manager.join(cl.cfg, m, i, 0)
    st = st._replace(manager=m)
    return cl.steps(st, settle)


def _cached_build(self, make):
    """Boot once, reuse the (immutable) booted state for every run —
    determinism makes re-booting equivalent to state reuse (no step
    writes into a state tensor), and the Cluster is shared across
    runs/shrinks."""
    if not hasattr(self, "_cl"):
        self._cl = make()
        self._st0 = _boot_fullmesh(self._cl)
    return self._cl, self._st0


@dataclasses.dataclass
class NoopSystem:
    """prop_partisan_noop.erl: no commands beyond sync; vacuous
    postcondition — exercises the harness itself."""

    n_nodes: int = 4
    seed: int = 0
    name: str = "noop"
    device: Any = None

    def build(self):
        return _cached_build(self, lambda: Cluster(
            Config(n_nodes=self.n_nodes, seed=self.seed,
                   inbox_cap=max(32, self.n_nodes + 8)),
            device=self.device))

    def gen_command(self, rng: random.Random, cl, st) -> Command:
        return Command(name="sync", args=(), apply=lambda c, s: s)

    def postcondition(self, cl, st, script) -> bool:
        return True

    def settle_rounds(self) -> int:
        return 2


@dataclasses.dataclass
class ReliableBroadcastSystem:
    """prop_partisan_reliable_broadcast.erl: random nodes broadcast; the
    property is agreement — every alive node delivers every broadcast
    message.  ``acked=True`` (retransmission) satisfies it under transient
    omissions; the unacked variant is the harness's canary."""

    n_nodes: int = 6
    seed: int = 0
    acked: bool = True
    name: str = "reliable_broadcast"
    device: Any = None

    def __post_init__(self):
        self.model = DirectMail(acked=self.acked)
        self._next_slot = 0

    def build(self):
        return _cached_build(self, lambda: Cluster(
            Config(n_nodes=self.n_nodes, seed=self.seed,
                   inbox_cap=max(32, self.n_nodes + 8),
                   ack_cap=16 if self.acked else 0),
            model=self.model, device=self.device))

    def gen_command(self, rng: random.Random, cl, st) -> Command:
        node = rng.randrange(self.n_nodes)
        slot = self._next_slot % cl.cfg.max_broadcasts
        self._next_slot += 1
        return Command(
            name="broadcast", args=(node, slot),
            apply=lambda c, s, _n=node, _sl=slot: s._replace(
                model=self.model.broadcast(s.model, _n, _sl)))

    def postcondition(self, cl, st, script) -> bool:
        # Delivery is asserted for broadcasts whose origin stayed correct
        # (never crashed): a crashed origin may not even have sent, and
        # the reference model likewise only constrains correct nodes
        # (prop_partisan_reliable_broadcast.erl postconditions).
        issued = [c.args for c in script if c.name == "broadcast"]
        alive = st.faults.alive
        for (node, slot) in issued:
            if not bool(alive[node]):
                continue
            if float(self.model.coverage(st.model, alive, slot)) != 1.0:
                return False
        return True

    def settle_rounds(self) -> int:
        return 12


@dataclasses.dataclass
class LinearizabilitySystem:
    """prop_partisan_linearizability.erl over a single replicated
    register (Alsberg-Day key 0): clients write distinct values, commands
    are issued sequentially, and the property is that the final
    replicated value is the value of the LAST acknowledged write — any
    earlier value surfacing at the end would be a non-linearizable
    history (a lost or reordered overwrite)."""

    n_nodes: int = 5
    seed: int = 0
    name: str = "linearizability"
    device: Any = None

    def __post_init__(self):
        self.model = AlsbergDay(acked=True, keys=1)
        self._next = 0

    def build(self):
        return _cached_build(self, lambda: Cluster(
            Config(n_nodes=self.n_nodes, seed=self.seed,
                   inbox_cap=max(48, 8 * self.n_nodes),
                   emit_cap=16, ack_cap=32),
            model=self.model, device=self.device))

    def gen_command(self, rng: random.Random, cl, st) -> Command:
        client = rng.randrange(1, self.n_nodes)
        val = 1000 + self._next
        self._next += 1
        return Command(
            name="write", args=(client, 0, val),
            apply=lambda c, s, _c=client, _v=val: s._replace(
                model=self.model.write(s.model, _c, 0, _v)))

    def postcondition(self, cl, st, script) -> bool:
        alive = st.faults.alive
        writes = [c.args for c in script if c.name == "write"]
        if not writes:
            return True
        if not bool(self.model.replicated(st.model, 0, alive)):
            return False
        # Final-state evidence is lossy: req_ok reflects only each
        # client's LATEST write (an earlier acked write's evidence is
        # reset by a later one), so the value check is made only when it
        # is sound — when the GLOBALLY LAST issued write is acked, it is
        # the unique linearization winner and must be the final value.
        last_client, _k, last_val = writes[-1]
        if bool(self.model.acked_ok(st.model, last_client, 0)):
            final = int(st.model.store[0, 0])
            return final == last_val
        # Last write unacked: require liveness for correct clients —
        # a surviving client's latest write must eventually ack.
        for (cl_, _k, _v) in writes:
            latest = [w for w in writes if w[0] == cl_][-1]
            if latest[2] != _v:
                continue                     # superseded by a later write
            if bool(alive[cl_]) and \
                    not bool(self.model.acked_ok(st.model, cl_, 0)):
                return False
        return True

    def settle_rounds(self) -> int:
        return 15


@dataclasses.dataclass
class PrimaryBackupSystem:
    """prop_partisan_primary_backup.erl over the Alsberg-Day protocol:
    random clients write; the property is that every write is acked to
    its client AND replicated identically on every alive node."""

    n_nodes: int = 5
    seed: int = 0
    acked: bool = True
    keys: int = 8
    name: str = "primary_backup"
    device: Any = None

    def __post_init__(self):
        self.model = AlsbergDay(acked=self.acked, keys=self.keys)
        self._next = 0

    def build(self):
        return _cached_build(self, lambda: Cluster(
            Config(n_nodes=self.n_nodes, seed=self.seed,
                   inbox_cap=max(48, 8 * self.n_nodes),
                   emit_cap=16,
                   ack_cap=32 if self.acked else 0),
            model=self.model, device=self.device))

    def gen_command(self, rng: random.Random, cl, st) -> Command:
        client = rng.randrange(1, self.n_nodes)   # node 0 is the primary
        key = self._next % self.keys
        val = 100 + self._next
        self._next += 1
        return Command(
            name="write", args=(client, key, val),
            apply=lambda c, s, _c=client, _k=key, _v=val: s._replace(
                model=self.model.write(s.model, _c, _k, _v)))

    def postcondition(self, cl, st, script) -> bool:
        # Last write per (client, key) must be acked; every written key
        # must be identically replicated across alive nodes.
        alive = st.faults.alive
        last: dict[tuple, Any] = {}
        for c in script:
            if c.name == "write":
                client, key, _ = c.args
                last[(client, key)] = c.args
        # Only writes from clients that stayed correct are constrained
        # (a crashed client cannot receive its ok).
        surviving = {(cl_, k) for (cl_, k) in last if bool(alive[cl_])}
        for (client, key) in surviving:
            if not bool(self.model.acked_ok(st.model, client, key)):
                return False
        for key in {k for (_cl, k) in surviving}:
            if not bool(self.model.replicated(st.model, key, alive)):
                return False
        return True

    def settle_rounds(self) -> int:
        return 15


@dataclasses.dataclass
class AtomicCommitSystem:
    """Application-under-test model (the role test/prop_partisan_hbbft.erl
    :703 plays for the reference — proving the harness hosts a NON-TOY
    system): the atomic-commit ENGINE (models/commit.py — Lampson 2PC,
    Bernstein CTP, Skeen 3PC) under the crash fault model, checked
    against atomic commitment's real safety properties:

    - AGREEMENT: no transaction ends with both a committed and an
      aborted participant (AC1),
    - UNIFORMITY: a coordinator-reported ok implies every alive
      participant delivered (the blocking hole 2PC is famous for — an
      omission in the commit fan-out strands a prepared participant,
      which Bernstein CTP's cooperative termination repairs and plain
      2PC cannot).
    """

    variant: str = "bernstein_ctp"
    n_nodes: int = 6
    slots: int = 4
    seed: int = 1
    name: str = "atomic_commit"
    device: Any = None

    def __post_init__(self) -> None:
        self.model = CommitProtocol(self.variant, slots=self.slots,
                                    coordinator_timeout_rounds=10,
                                    participant_timeout_rounds=5)
        self._next_slot = 0

    def build(self):
        self._next_slot = 0
        return _cached_build(self, lambda: Cluster(
            Config(n_nodes=self.n_nodes, seed=self.seed,
                   inbox_cap=max(32, self.n_nodes + 8)),
            model=self.model, device=self.device))

    def begin_command(self, coord: int, slot: int, value: int) -> Command:
        def apply(c, s):
            members = torch.ones((self.n_nodes,), dtype=torch.bool,
                                 device=s.rnd.device)
            return s._replace(model=self.model.begin(
                s.model, coord, slot, value, members, s.rnd))

        return Command(name="begin", args=(coord, slot, value), apply=apply)

    def gen_command(self, rng: random.Random, cl, st) -> Command:
        slot = self._next_slot % self.slots
        self._next_slot += 1
        return self.begin_command(rng.randrange(self.n_nodes), slot,
                                  rng.randrange(1, 1000))

    def postcondition(self, cl, st, script) -> bool:
        if not bool(self.model.agreement(st.model)):
            return False
        begun = {c.args[1] for c in script if c.name == "begin"}
        return all(
            bool(self.model.committed_implies_all(
                st.model, slot, st.faults.alive))
            for slot in begun)

    def settle_rounds(self) -> int:
        # covers the coordinator timeout (10) + CTP's decision-request
        # repair cycle after the heal
        return 30


@dataclasses.dataclass
class PaxosSystem:
    """Consensus application-under-test (the prop_partisan_paxoid.erl:385
    role): vectorized single-decree Paxos (models/paxos.py) under the
    crash fault model, with linearizability-grade postconditions:

    - AGREEMENT: across every node (alive or crashed), at most one
      value is ever learned per decree,
    - VALIDITY: a learned value was proposed for that decree,
    - conditional TERMINATION: with a majority alive and partitions
      healed, a decree somebody proposed and some surviving proposer
      still owns must be decided by settle time.

    ``unsafe_adopt`` forwards to the model — it plants the broken
    Synod adoption rule (ignore promises' highest-accepted value) the
    harness must catch and shrink (tests/test_paxos.py).
    """

    n_nodes: int = 5
    slots: int = 2
    seed: int = 3
    quorum: int | None = None
    unsafe_adopt: bool = False
    check_termination: bool = True
    name: str = "paxos"
    device: Any = None

    def __post_init__(self) -> None:
        self.model = Paxos(slots=self.slots, quorum=self.quorum,
                           retry_rounds=8,
                           unsafe_adopt=self.unsafe_adopt)
        self._next_val = 0

    def build(self):
        return _cached_build(self, lambda: Cluster(
            Config(n_nodes=self.n_nodes, seed=self.seed,
                   msg_words=13,
                   inbox_cap=max(48, 8 * self.n_nodes),
                   emit_cap=16),
            model=self.model, device=self.device))

    def propose_command(self, node: int, slot: int, value: int) -> Command:
        def apply(c, s, _n=node, _sl=slot, _v=value):
            return s._replace(model=self.model.propose(
                s.model, _n, _sl, _v, int(s.rnd), self.n_nodes))

        return Command(name="propose", args=(node, slot, value),
                       apply=apply)

    def gen_command(self, rng: random.Random, cl, st) -> Command:
        self._next_val += 1
        return self.propose_command(rng.randrange(self.n_nodes),
                                    rng.randrange(self.slots),
                                    100 + self._next_val)

    def postcondition(self, cl, st, script) -> bool:
        proposed: dict[int, set] = {}
        proposers: dict[int, list] = {}
        for c in script:
            if c.name == "propose":
                node, slot, val = c.args
                proposed.setdefault(slot, set()).add(val)
                proposers.setdefault(slot, []).append(node)
        if not self.model.agreement(st.model):
            return False
        if not self.model.validity(st.model, proposed):
            return False
        if not self.check_termination:
            return True
        alive = st.faults.alive.cpu().numpy()
        if alive.sum() <= self.n_nodes // 2:
            return True                    # no quorum: liveness waived
        for slot, nodes in proposers.items():
            if any(alive[p] for p in nodes) and \
                    not self.model.decided_nodes(st.model, slot):
                return False
        return True

    def settle_rounds(self) -> int:
        # several retry windows: dueling proposers need a few ballots
        return 60
