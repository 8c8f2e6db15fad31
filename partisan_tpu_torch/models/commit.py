"""Atomic broadcast via commit protocols: Lampson 2PC, Bernstein CTP,
Skeen 3PC (port of ``partisan_tpu/models/commit.py``).

One vectorized engine over ``[n, slots]`` transaction state serves all
three protocols.  A coordinator's ``begin`` captures the participant set
and fans out PREPARE; participants answer PREPARED; a full vote set
moves the coordinator to commit (3PC inserts a PRECOMMIT round) and an
expired vote collection to abort.  Coordinator fan-outs are
edge-triggered (``c_sent`` records the last phase fanned out), so
omissions have the reference's blocking/abort consequences.  3PC's
participant timeout is non-blocking (prepared -> abort, precommit ->
commit); CTP's asks the overlay neighbours for the decision
(DECISION_REQ carries the coordinator id), and peers answering
uncertain are notified once the decision is learned.

Scatters that carry values (the participant's coordinator and value on
PREPARE) pick their winner explicitly, the last inbox slot of a row that
addresses a slot (``ops.scatter.last_writer``), on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.ops import select
from partisan_tpu_torch.ops.scatter import (fold_true, last_writer,
                                           set_at, take_last)

# APP payload layout: [op, slot, value, aux]
OP_PREPARE = 10
OP_PREPARED = 11
OP_COMMIT = 12
OP_COMMIT_ACK = 13
OP_ABORT = 14
OP_ABORT_ACK = 15
OP_PRECOMMIT = 16
OP_PRECOMMIT_ACK = 17
OP_DECISION_REQ = 18
OP_DECISION = 19

# decision_request answers (payload aux word)
DEC_ABORT = 1
DEC_COMMIT = 2
DEC_UNCERTAIN = 3

# Coordinator phases (c_phase)
C_IDLE = 0
C_PREPARING = 1      # collecting prepared votes
C_PRECOMMIT = 2      # 3PC only: collecting precommit_acks
C_COMMITTING = 3     # collecting commit_acks
C_ABORTING = 4       # collecting abort_acks
C_DONE = 5

# Participant statuses (p_status)
P_NONE = 0
P_PREPARED = 1
P_PRECOMMIT = 2
P_COMMIT = 3
P_ABORT = 4

_FANOUT_OP = {C_PREPARING: OP_PREPARE, C_PRECOMMIT: OP_PRECOMMIT,
              C_COMMITTING: OP_COMMIT, C_ABORTING: OP_ABORT}


class CommitState(NamedTuple):
    # Coordinator side: [n, S] (+ participant axis P = n_global)
    c_phase: torch.Tensor     # int32[n, S]
    c_sent: torch.Tensor      # int32[n, S] — last phase fanned out
    c_mask: torch.Tensor      # bool[n, S, P] — participant set at begin
    c_acks: torch.Tensor      # bool[n, S, P] — acks for the current phase
    c_t0: torch.Tensor        # int32[n, S] — round of phase entry
    c_value: torch.Tensor     # int32[n, S] — broadcast payload
    c_outcome: torch.Tensor   # int32[n, S] — 0 pending, 1 ok, 2 error
    # Participant side
    p_status: torch.Tensor    # int32[n, S]
    p_coord: torch.Tensor     # int32[n, S] — -1 until a prepare is seen
    p_value: torch.Tensor     # int32[n, S]
    p_last: torch.Tensor      # int32[n, S] — round of last progress
    p_uncertain: torch.Tensor  # bool[n, S, P] — CTP: uncertain repliers
    delivered: torch.Tensor   # bool[n, S] — payload handed to the app


class CommitProtocol:
    """variant: 'lampson_2pc' | 'bernstein_ctp' | 'skeen_3pc'."""

    VARIANTS = ("lampson_2pc", "bernstein_ctp", "skeen_3pc")

    def __init__(self, variant: str = "lampson_2pc", slots: int = 4,
                 coordinator_timeout_rounds: int = 10,
                 participant_timeout_rounds: int = 5) -> None:
        if variant not in self.VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.name = variant
        self.variant = variant
        self.slots = slots
        self.c_timeout = coordinator_timeout_rounds
        self.p_timeout = participant_timeout_rounds

    @property
    def three_phase(self) -> bool:
        return self.variant == "skeen_3pc"

    @property
    def ctp(self) -> bool:
        return self.variant == "bernstein_ctp"

    # ------------------------------------------------------------------
    def init(self, cfg, comm) -> CommitState:
        n, s, p, dev = comm.n_local, self.slots, comm.n_global, comm.device

        def zi():
            return torch.zeros((n, s), dtype=torch.int32, device=dev)

        def zb():
            return torch.zeros((n, s, p), dtype=torch.bool, device=dev)

        return CommitState(
            c_phase=zi(), c_sent=zi(), c_mask=zb(), c_acks=zb(), c_t0=zi(),
            c_value=zi(), c_outcome=zi(),
            p_status=zi(),
            p_coord=torch.full((n, s), -1, dtype=torch.int32, device=dev),
            p_value=zi(), p_last=zi(), p_uncertain=zb(),
            delivered=torch.zeros((n, s), dtype=torch.bool, device=dev))

    # ------------------------------------------------------------------
    def step(self, cfg, comm, st: CommitState, ctx, nbrs):
        n, s, p = st.c_mask.shape
        gids = comm.local_ids()
        dev = gids.device
        rows = torch.arange(n, device=dev)
        alive = ctx.alive
        live = alive[:, None]

        inb = ctx.inbox.data                          # planes of [n, cap]
        cap = inb[T.W_KIND].shape[1]
        is_app = inb[T.W_KIND] == T.MsgKind.APP
        op = torch.where(is_app, inb[T.P0], 0)
        slot = torch.where(is_app, inb[T.P1], 0).clamp(0, s - 1)
        val, aux, src = inb[T.P2], inb[T.P3], inb[T.W_SRC]
        # dead receivers never process (their inbox is already empty)
        op = torch.where(live, op, 0)
        slot64 = slot.to(torch.int64)
        r2 = rows[:, None].expand(n, cap)
        src_p = src.clamp(0, p - 1).to(torch.int64)

        def at_slot(x):
            """x[n, S] read at each inbox message's slot."""
            return torch.gather(x, 1, slot64)

        def any_at(m):
            return fold_true(torch.zeros((n, s), dtype=torch.bool,
                                         device=dev),
                             (r2, torch.where(m, slot64, s)))

        # ---- participant: process coordinator fan-outs ----------------
        m_prep = op == OP_PREPARE
        fresh = st.p_status == P_NONE
        # record the tx on prepare (coordinator, value): the last PREPARE
        # in a row's inbox for a slot wins
        win = last_writer(slot, m_prep, s)
        p_coord = take_last(st.p_coord, win, src)
        p_value = take_last(st.p_value, win, val)
        p_status = torch.where((win >= 0) & fresh, P_PREPARED, st.p_status)

        if self.three_phase:
            got_pc = any_at(op == OP_PRECOMMIT)
            p_status = torch.where(got_pc & (p_status == P_PREPARED),
                                   P_PRECOMMIT, p_status)

        got_commit = any_at(op == OP_COMMIT)
        got_abort = any_at(op == OP_ABORT)

        def undecided(ps):
            return (ps != P_COMMIT) & (ps != P_ABORT)

        p_status = torch.where(got_commit & undecided(p_status), P_COMMIT,
                               p_status)
        p_status = torch.where(got_abort & undecided(p_status), P_ABORT,
                               p_status)

        p_uncertain = st.p_uncertain
        if self.ctp:
            # decision answers: only same-tx participants (P2 carries the
            # tx coordinator) adopt the decision
            coord_here = at_slot(p_coord)
            m_dec = (op == OP_DECISION) & (coord_here >= 0) \
                & (coord_here == val)
            got_dc = any_at(m_dec & (aux == DEC_COMMIT))
            got_da = any_at(m_dec & (aux == DEC_ABORT))
            p_status = torch.where(got_dc & undecided(p_status), P_COMMIT,
                                   p_status)
            p_status = torch.where(got_da & undecided(p_status), P_ABORT,
                                   p_status)
            # remember peers that answered uncertain (notified later)
            m_unc = m_dec & (aux == DEC_UNCERTAIN)
            p_uncertain = fold_true(
                p_uncertain, (r2, torch.where(m_unc, slot64, s), src_p),
                dim=1)

        progressed = p_status != st.p_status
        p_last = torch.where(progressed, ctx.rnd, st.p_last)

        # delivery: payload handed to the app on first commit
        delivered = st.delivered | ((p_status == P_COMMIT) & live)

        # ---- coordinator: accumulate acks for the current phase -------
        ack_phase = select(
            [op == OP_PREPARED, op == OP_PRECOMMIT_ACK,
             op == OP_COMMIT_ACK, op == OP_ABORT_ACK],
            [C_PREPARING, C_PRECOMMIT, C_COMMITTING, C_ABORTING],
            torch.zeros_like(op))
        m_ack = (ack_phase > 0) & (ack_phase == at_slot(st.c_phase))
        c_acks = fold_true(
            st.c_acks, (r2, torch.where(m_ack, slot64, s), src_p), dim=1)

        # ---- coordinator transitions ----------------------------------
        have_all = (~st.c_mask | c_acks).all(dim=-1)          # [n, S]
        timed_out = (ctx.rnd - st.c_t0) >= self.c_timeout
        c_phase, c_outcome = st.c_phase, st.c_outcome

        def to(phase_from, phase_to, cond):
            # guarded on the ROUND-START phase, so chained transitions
            # cannot cascade within one round
            nonlocal c_phase
            c_phase = torch.where(
                (st.c_phase == phase_from) & (c_phase == phase_from)
                & cond & live, phase_to, c_phase)

        if self.three_phase:
            to(C_PREPARING, C_PRECOMMIT, have_all)
            to(C_PRECOMMIT, C_COMMITTING, have_all)
        else:
            to(C_PREPARING, C_COMMITTING, have_all)
        # the ok reply to the caller goes out when commit is decided
        c_outcome = torch.where(
            (st.c_phase != C_COMMITTING) & (c_phase == C_COMMITTING)
            & (c_outcome == 0), 1, c_outcome)
        to(C_COMMITTING, C_DONE, have_all)
        to(C_ABORTING, C_DONE, have_all)
        # timeouts while undecided -> abort + error reply
        aborting = torch.zeros((n, s), dtype=torch.bool, device=dev)
        for ph in ((C_PREPARING, C_PRECOMMIT) if self.three_phase
                   else (C_PREPARING,)):
            hit = (st.c_phase == ph) & (c_phase == ph) & timed_out & live
            aborting = aborting | hit
            c_phase = torch.where(hit, C_ABORTING, c_phase)
        c_outcome = torch.where(aborting & (c_outcome == 0), 2, c_outcome)

        changed = c_phase != st.c_phase
        c_t0 = torch.where(changed, ctx.rnd, st.c_t0)
        c_acks = c_acks & ~changed[..., None]

        # ---- participant timeouts -------------------------------------
        waiting = (p_status == P_PREPARED) | (p_status == P_PRECOMMIT)
        p_expired = waiting & (p_coord >= 0) & \
            ((ctx.rnd - p_last) >= self.p_timeout) & live
        if self.three_phase:
            # non-blocking termination rule
            p_status = torch.where(p_expired & (p_status == P_PREPARED),
                                   P_ABORT, p_status)
            p_status = torch.where(p_expired & (p_status == P_PRECOMMIT),
                                   P_COMMIT, p_status)
            delivered = delivered | ((p_status == P_COMMIT) & live)
            p_last = torch.where(p_expired, ctx.rnd, p_last)
        elif self.ctp:
            # ask for the decision; one slot per round bounds the fan-out
            dreq_fire = p_expired.any(dim=1)
            dreq_slot = p_expired.to(torch.int8).argmax(dim=1)
            p_last = torch.where(
                p_expired & (torch.arange(s, device=dev)[None, :]
                             == dreq_slot[:, None]), ctx.rnd, p_last)

        # ---- emissions ------------------------------------------------
        blocks = []
        kind = int(T.MsgKind.APP)
        sid = torch.arange(s, dtype=torch.int32, device=dev)
        pid = torch.arange(p, dtype=torch.int32, device=dev)

        # (1) coordinator fan-out, edge-triggered per phase entry
        do_fan = (c_phase != st.c_sent) & live
        fan_op = select([c_phase == k for k in _FANOUT_OP],
                        list(_FANOUT_OP.values()), torch.zeros_like(c_phase))
        do_fan = do_fan & (fan_op > 0)
        c_sent = torch.where(do_fan | (c_phase == C_DONE), c_phase,
                             st.c_sent)
        fan_dst = torch.where(do_fan[..., None] & st.c_mask, pid, -1)
        blocks.append(msg_ops.build(
            cfg, kind, gids[:, None, None], fan_dst,
            payload=(fan_op[..., None], sid[None, :, None],
                     st.c_value[..., None], 0),
        ).map(lambda w: w.reshape(n, s * p)))

        # (2) replies to this round's inbox messages, gated on the
        # participant's POST-processing status (an aborted participant
        # acks nothing)
        stat_now = at_slot(p_status)
        rep_op = select(
            [(op == OP_PREPARE) & (stat_now >= P_PREPARED)
             & (stat_now != P_ABORT),
             (op == OP_PRECOMMIT) & ((stat_now == P_PRECOMMIT)
                                     | (stat_now == P_COMMIT)),
             (op == OP_COMMIT) & (stat_now == P_COMMIT),
             (op == OP_ABORT) & (stat_now == P_ABORT)],
            [OP_PREPARED, OP_PRECOMMIT_ACK, OP_COMMIT_ACK, OP_ABORT_ACK],
            torch.zeros_like(op))
        rep_aux = torch.zeros_like(op)
        if self.ctp:
            # answer decision requests: a participant of the SAME tx
            # (matching coordinator) or the coordinator itself answers
            # with the decision; everyone else answers uncertain
            m_req = op == OP_DECISION_REQ
            coord_here = at_slot(p_coord)
            same_tx = (coord_here >= 0) & (coord_here == val)
            self_coord = gids[:, None] == val
            oc_here = at_slot(st.c_outcome)
            know_commit = (same_tx & (stat_now == P_COMMIT)) | \
                (self_coord & (oc_here == 1))
            know_abort = (same_tx & (stat_now == P_ABORT)) | \
                (self_coord & (oc_here == 2))
            dec = select([know_commit, know_abort], [DEC_COMMIT, DEC_ABORT],
                         torch.full_like(op, DEC_UNCERTAIN))
            rep_op = torch.where(m_req, OP_DECISION, rep_op)
            rep_aux = torch.where(m_req, dec, rep_aux)
        rep_dst = torch.where((rep_op > 0) & live, src, -1)
        blocks.append(msg_ops.build(
            cfg, kind, gids[:, None], rep_dst,
            payload=(rep_op, slot, val, rep_aux)))

        if self.ctp:
            # (3) decision requests on participant timeout; P2 carries the
            # tx coordinator id
            req_dst = torch.where(dreq_fire[:, None], nbrs, -1)
            dreq_coord = p_coord[rows, dreq_slot]
            blocks.append(msg_ops.build(
                cfg, kind, gids[:, None], req_dst,
                payload=(OP_DECISION_REQ, dreq_slot[:, None],
                         dreq_coord[:, None], 0)))
            # (4) notify peers that answered uncertain once decided
            decided_now = ~undecided(p_status) & undecided(st.p_status)
            note = decided_now[..., None] & p_uncertain & live[..., None]
            note_dec = torch.where(p_status == P_COMMIT, DEC_COMMIT,
                                   DEC_ABORT)
            blocks.append(msg_ops.build(
                cfg, kind, gids[:, None, None],
                torch.where(note, pid, -1),
                payload=(OP_DECISION, sid[None, :, None],
                         p_coord[..., None], note_dec[..., None]),
            ).map(lambda w: w.reshape(n, s * p)))
            p_uncertain = p_uncertain & ~decided_now[..., None]

        emitted = plane_ops.concat(blocks, dim=1)
        new = CommitState(
            c_phase=c_phase, c_sent=c_sent, c_mask=st.c_mask, c_acks=c_acks,
            c_t0=c_t0, c_value=st.c_value, c_outcome=c_outcome,
            p_status=p_status, p_coord=p_coord, p_value=p_value,
            p_last=p_last, p_uncertain=p_uncertain, delivered=delivered)
        return new, emitted

    # ---- scenario helpers --------------------------------------------
    def begin(self, st: CommitState, coordinator: int, slot: int, value: int,
              members: torch.Tensor, rnd) -> CommitState:
        """Start transaction ``slot`` at ``coordinator`` with participant
        set ``members`` (bool[n_global]).  Distinct transactions must use
        distinct slots."""
        at = (coordinator, slot)
        return st._replace(
            c_phase=set_at(st.c_phase, at, C_PREPARING),
            c_sent=set_at(st.c_sent, at, C_IDLE),
            c_mask=set_at(st.c_mask, at, members.to(st.c_mask.device)),
            c_acks=set_at(st.c_acks, at, False),
            c_t0=set_at(st.c_t0, at, rnd),
            c_value=set_at(st.c_value, at, value),
            c_outcome=set_at(st.c_outcome, at, 0))

    # ---- invariants (the Filibuster model's postconditions) ----------
    @staticmethod
    def agreement(st: CommitState) -> torch.Tensor:
        """True iff no transaction slot has both a committed and an
        aborted participant."""
        committed = (st.p_status == P_COMMIT).any(dim=0)
        aborted = (st.p_status == P_ABORT).any(dim=0)
        return ~(committed & aborted).any()

    @staticmethod
    def committed_implies_all(st: CommitState, slot: int,
                              alive: torch.Tensor) -> torch.Tensor:
        """If the coordinator reported ok, every alive participant
        delivered (checked after quiescence)."""
        ok = (st.c_outcome[:, slot] == 1).any()
        part = st.c_mask[:, slot].any(dim=0) & alive
        alldel = (~part | (st.p_status[:, slot] == P_COMMIT) | ~alive).all()
        return ~ok | alldel
