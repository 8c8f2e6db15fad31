"""Single-decree Paxos, vectorized (port of ``partisan_tpu/models/paxos.py``).

The in-repo consensus application-under-test: classic single-decree
Paxos (Synod), every node a proposer + acceptor + learner, stepped for
all nodes at once over ``[n, slots]`` decree state (one slot per
independent decree).

- ``propose`` starts phase 1 with a ballot unique to the proposer
  (``attempt * n + id + 1``) and fans out PREPARE;
- an acceptor answers PREPARE(b > promised) with PROMISE(b) carrying its
  highest accepted (ballot, value), and accepts ACCEPT(b >= promised);
  within a round ACCEPTs are processed before PREPAREs, so a promise
  covers every accept its acceptor performed;
- a quorum of promises moves the proposer to phase 2 with the value of
  the highest accepted ballot seen (or its own); a quorum of ACCEPTED
  decides and fans out DECIDE; a proposer stuck past its id-jittered
  retry window re-runs phase 1 with a higher ballot.

Fan-outs are edge-triggered.  ``quorum`` defaults to majority; a smaller
value, or ``unsafe_adopt`` (ignore the promises' highest accepted value),
plants the bug the property harness must catch and shrink.

Ties: every ``argmax`` below picks the first maximal inbox slot, as the
reference's does.  The proposer's promise/accept bits are set with
``True`` only (``ops.scatter.fold_true``), so their scatters are
order-free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.ops.scatter import fold_true, set_at

# APP payload layout: [op, slot, ballot, value, aux]
OP_PREPARE = 30
OP_PROMISE = 31     # aux = accepted ballot; value = accepted value (-1)
OP_ACCEPT = 32
OP_ACCEPTED = 33
OP_DECIDE = 34

# proposer phases
P_IDLE = 0
P_PREPARING = 1
P_ACCEPTING = 2

NEG = -2 ** 31      # int32 min: "no message" in the max-reductions


class PaxosState(NamedTuple):
    # acceptor [n, S]
    a_promised: torch.Tensor   # int32 — highest promised ballot (0 = none)
    a_ballot: torch.Tensor     # int32 — accepted ballot (0 = none)
    a_value: torch.Tensor      # int32 — accepted value (-1 = none)
    # proposer [n, S]
    p_phase: torch.Tensor      # int32 — P_IDLE / P_PREPARING / P_ACCEPTING
    p_ballot: torch.Tensor     # int32 — current ballot
    p_value: torch.Tensor      # int32 — own proposed value
    p_chosen: torch.Tensor     # int32 — phase-2 value
    p_prom: torch.Tensor       # bool[n, S, NG] — acceptors who PROMISEd
    p_hib: torch.Tensor        # int32 — highest accepted ballot in promises
    p_hiv: torch.Tensor        # int32 — its value
    p_acc: torch.Tensor        # bool[n, S, NG] — acceptors who ACCEPTED
    p_t0: torch.Tensor         # int32 — round of phase entry (retry base)
    p_sent: torch.Tensor       # bool — current phase's fan-out emitted
    p_won: torch.Tensor        # int32 — value this node chose as winner
    won_conflict: torch.Tensor  # bool — won twice with different values
    decided: torch.Tensor      # int32 — learned decree value (-1 = none)


class Paxos:
    """``slots`` independent decrees; quorum defaults to majority."""

    name = "paxos"

    def __init__(self, slots: int = 2, quorum: int | None = None,
                 retry_rounds: int = 8, unsafe_adopt: bool = False) -> None:
        self.slots = slots
        self.quorum = quorum
        self.retry_rounds = retry_rounds
        self.unsafe_adopt = unsafe_adopt

    def _quorum(self, cfg) -> int:
        return self.quorum if self.quorum is not None \
            else cfg.n_nodes // 2 + 1

    def init(self, cfg, comm) -> PaxosState:
        if cfg.msg_words - T.HDR_WORDS < 5:
            raise ValueError("paxos needs msg_words >= 13 "
                             "(payload [op, slot, ballot, value, aux])")
        n, s, dev = comm.n_local, self.slots, comm.device
        zi = torch.zeros((n, s), dtype=torch.int32, device=dev)
        zb = torch.zeros((n, s, comm.n_global), dtype=torch.bool, device=dev)
        neg1 = torch.full((n, s), -1, dtype=torch.int32, device=dev)
        return PaxosState(
            a_promised=zi, a_ballot=zi.clone(), a_value=neg1,
            p_phase=zi.clone(), p_ballot=zi.clone(), p_value=zi.clone(),
            p_chosen=zi.clone(), p_prom=zb, p_hib=zi.clone(),
            p_hiv=zi.clone(), p_acc=zb.clone(), p_t0=zi.clone(),
            p_sent=torch.zeros((n, s), dtype=torch.bool, device=dev),
            p_won=neg1.clone(),
            won_conflict=torch.zeros((n, s), dtype=torch.bool, device=dev),
            decided=neg1.clone())

    # ------------------------------------------------------------------
    def step(self, cfg, comm, st: PaxosState, ctx, nbrs):
        n, S = st.p_phase.shape
        NG = comm.n_global
        Q = self._quorum(cfg)
        gids = comm.local_ids()
        dev = gids.device
        alive = ctx.alive
        inb = ctx.inbox.data
        cap = inb[T.W_KIND].shape[1]
        is_app = (inb[T.W_KIND] == T.MsgKind.APP) & alive[:, None]
        op = torch.where(is_app, inb[T.P0], -1)              # [n, cap]
        mslot, mbal, mval = inb[T.P1], inb[T.P2], inb[T.P3]
        maux = inb[T.P3 + 1]
        msrc = inb[T.W_SRC]
        # decree-aligned masks: [n, S, cap]
        sl = torch.arange(S, dtype=torch.int32, device=dev)
        on_slot = mslot[:, None, :] == sl[None, :, None]

        def per_slot(opk):
            return (op[:, None, :] == opk) & on_slot

        def pick(vals, who):
            """vals[n, cap] at the inbox slot ``who[n, S]``."""
            return torch.gather(vals, 1, who)

        # ---- acceptor: ACCEPT(b >= promised) -> accept + ACCEPTED -----
        m_acc = per_slot(OP_ACCEPT) \
            & (mbal[:, None, :] >= st.a_promised[:, :, None])
        acc_bal = torch.where(m_acc, mbal[:, None, :], NEG)
        acc_max = acc_bal.amax(dim=2)
        acc_any = acc_max > NEG
        awho = acc_bal.argmax(dim=2)
        acc_src, acc_val = pick(msrc, awho), pick(mval, awho)
        accepted_msg = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None],
            torch.where(acc_any, acc_src, -1),
            payload=(OP_ACCEPTED, sl[None, :], acc_max.clamp(min=0),
                     acc_val, 0))
        promised_mid = torch.maximum(st.a_promised, acc_max.clamp(min=0))
        a_ballot = torch.where(acc_any, acc_max, st.a_ballot)
        a_value = torch.where(acc_any, acc_val, st.a_value)

        # ---- acceptor: PREPARE -> re-promise + PROMISE the max --------
        prep_bal = torch.where(per_slot(OP_PREPARE), mbal[:, None, :], NEG)
        prep_max = prep_bal.amax(dim=2)
        prep_win = prep_max > promised_mid
        prep_src = pick(msrc, prep_bal.argmax(dim=2))
        promise = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None],
            torch.where(prep_win, prep_src, -1),
            payload=(OP_PROMISE, sl[None, :], prep_max.clamp(min=0),
                     a_value, a_ballot))
        a_promised = torch.maximum(promised_mid, prep_max.clamp(min=0))

        # ---- proposer: collect PROMISE / ACCEPTED ---------------------
        # message sources fold into per-acceptor bits, so a quorum counts
        # DISTINCT acceptors (duplicate delivery cannot inflate it)
        m_prom = per_slot(OP_PROMISE) \
            & (mbal[:, None, :] == st.p_ballot[:, :, None]) \
            & (st.p_phase == P_PREPARING)[:, :, None]
        r3 = torch.arange(n, device=dev)[:, None, None].expand(n, S, cap)
        s3 = sl.to(torch.int64)[None, :, None].expand(n, S, cap)
        src3 = msrc[:, None, :].expand(n, S, cap)

        def fold_bits(bits, mask):
            return fold_true(bits, (r3, s3, torch.where(mask, src3, NG)))

        p_prom = fold_bits(st.p_prom, m_prom)
        nprom = p_prom.sum(dim=2, dtype=torch.int32)
        # highest accepted (ballot, value) among this round's promises
        pr_ab = torch.where(m_prom, maux[:, None, :], NEG)
        pr_hib = pr_ab.amax(dim=2)
        pr_hiv = pick(mval, pr_ab.argmax(dim=2))
        upd = pr_hib > st.p_hib
        p_hib = torch.where(upd, pr_hib, st.p_hib)
        p_hiv = torch.where(upd, pr_hiv, st.p_hiv)

        m_accd = per_slot(OP_ACCEPTED) \
            & (mbal[:, None, :] == st.p_ballot[:, :, None]) \
            & (st.p_phase == P_ACCEPTING)[:, :, None]
        p_acc = fold_bits(st.p_acc, m_accd)
        nacc = p_acc.sum(dim=2, dtype=torch.int32)

        # phase transitions
        to_accept = (st.p_phase == P_PREPARING) & (nprom >= Q)
        adopt = st.p_value if self.unsafe_adopt else \
            torch.where(p_hib > 0, p_hiv, st.p_value)
        p_chosen = torch.where(to_accept, adopt, st.p_chosen)
        win = (st.p_phase == P_ACCEPTING) & (nacc >= Q)
        p_phase = torch.where(to_accept, P_ACCEPTING, st.p_phase)
        p_phase = torch.where(win, P_IDLE, p_phase)
        p_sent = st.p_sent & ~to_accept                      # re-arm fan-out
        p_t0 = torch.where(to_accept, ctx.rnd, st.p_t0)

        # ---- learner: DECIDE ------------------------------------------
        dec_val = torch.where(per_slot(OP_DECIDE), mval[:, None, :],
                              NEG).amax(dim=2)
        got_dec = dec_val > NEG
        undecided = st.decided < 0
        decided = torch.where(undecided & got_dec, dec_val, st.decided)
        decided = torch.where(undecided & win, p_chosen, decided)
        p_won = torch.where((st.p_won < 0) & win, p_chosen, st.p_won)
        won_conflict = st.won_conflict | \
            (win & (st.p_won >= 0) & (st.p_won != p_chosen))

        # ---- retry: jittered per-proposer window ----------------------
        retry_at = self.retry_rounds + (gids % 3)[:, None]
        stuck = (p_phase != P_IDLE) & ~win & (ctx.rnd - p_t0 >= retry_at)
        p_ballot = torch.where(stuck, st.p_ballot + NG, st.p_ballot)
        p_phase = torch.where(stuck, P_PREPARING, p_phase)
        p_prom = p_prom & ~(stuck | to_accept)[:, :, None]
        p_acc = p_acc & ~(stuck | win)[:, :, None]
        p_hib = torch.where(stuck, 0, p_hib)
        p_hiv = torch.where(stuck, 0, p_hiv)
        p_sent = p_sent & ~stuck
        p_t0 = torch.where(stuck, ctx.rnd, p_t0)

        # ---- edge-triggered fan-outs ----------------------------------
        # one [n, S, NG] block, op by the proposer's phase; DECIDE is also
        # re-broadcast from every decided node on a slow stagger (the
        # learner anti-entropy that heals an omitted DECIDE fan-out)
        live = alive[:, None]
        fan_now = (p_phase != P_IDLE) & ~p_sent & live
        dec_now = win & live
        dec_rebc = (decided >= 0) & ~win & live \
            & ((ctx.rnd + gids[:, None]) % (2 * self.retry_rounds) == 0)
        dec_all = dec_now | dec_rebc
        any_fan = fan_now | dec_all
        fan_op = torch.where(
            dec_all, OP_DECIDE,
            torch.where(p_phase == P_PREPARING, OP_PREPARE, OP_ACCEPT))
        fan_val = torch.where(p_phase == P_ACCEPTING, p_chosen, st.p_value)
        fan_val = torch.where(dec_now, p_chosen, fan_val)
        fan_val = torch.where(dec_rebc, decided, fan_val)
        all_ids = torch.arange(NG, dtype=torch.int32, device=dev)
        fan = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None, None],
            torch.where(any_fan[:, :, None], all_ids[None, None, :], -1),
            payload=(fan_op[:, :, None], sl[None, :, None],
                     p_ballot[:, :, None], fan_val[:, :, None], 0))
        p_sent = p_sent | fan_now

        def keep(new, old):
            return torch.where(live if new.dim() == 2 else live[:, :, None],
                               new, old)

        out = PaxosState(
            a_promised=keep(a_promised, st.a_promised),
            a_ballot=keep(a_ballot, st.a_ballot),
            a_value=keep(a_value, st.a_value),
            p_phase=keep(p_phase, st.p_phase),
            p_ballot=keep(p_ballot, st.p_ballot),
            p_value=st.p_value,
            p_chosen=keep(p_chosen, st.p_chosen),
            p_prom=keep(p_prom, st.p_prom),
            p_hib=keep(p_hib, st.p_hib),
            p_hiv=keep(p_hiv, st.p_hiv),
            p_acc=keep(p_acc, st.p_acc),
            p_t0=keep(p_t0, st.p_t0),
            p_sent=keep(p_sent, st.p_sent),
            p_won=keep(p_won, st.p_won),
            won_conflict=keep(won_conflict, st.won_conflict),
            decided=keep(decided, st.decided))
        emitted = plane_ops.concat(
            [promise, accepted_msg,
             fan.map(lambda w: w.reshape(n, S * NG))], dim=1)
        return out, emitted

    # ---- host-side API -----------------------------------------------
    def propose(self, st: PaxosState, node: int, slot: int, value: int,
                now: int, n_global: int) -> PaxosState:
        """Start (or restart) a proposal.  Ballots stay unique to the
        proposer: attempt * n + id + 1."""
        cur = int(st.p_ballot[node, slot])
        nxt = node + 1 if cur <= 0 else cur + n_global
        at = (node, slot)
        return st._replace(
            p_phase=set_at(st.p_phase, at, P_PREPARING),
            p_ballot=set_at(st.p_ballot, at, nxt),
            p_value=set_at(st.p_value, at, value),
            p_prom=set_at(st.p_prom, at, False),
            p_hib=set_at(st.p_hib, at, 0),
            p_hiv=set_at(st.p_hiv, at, 0),
            p_acc=set_at(st.p_acc, at, False),
            p_t0=set_at(st.p_t0, at, int(now)),
            p_sent=set_at(st.p_sent, at, False))

    # ---- invariants (the prop-model postconditions) -------------------
    @staticmethod
    def _slot_values(st: PaxosState, s: int) -> set:
        """Values observed as chosen for decree ``s``: learned (decided)
        and chosen-as-proposer (p_won)."""
        d = st.decided[:, s].cpu().numpy()
        w = st.p_won[:, s].cpu().numpy()
        return {int(v) for v in d if v >= 0} | \
               {int(v) for v in w if v >= 0}

    @classmethod
    def agreement(cls, st: PaxosState) -> bool:
        """At most one value is ever chosen per decree, across all nodes
        (crashed ones included) and both observations."""
        if bool(st.won_conflict.any()):
            return False
        return all(len(cls._slot_values(st, s)) <= 1
                   for s in range(st.decided.shape[1]))

    @classmethod
    def validity(cls, st: PaxosState, proposed: dict) -> bool:
        """Every chosen value was proposed for that decree."""
        return all(
            cls._slot_values(st, s) <= set(proposed.get(s, ()))
            for s in range(st.decided.shape[1]))

    @staticmethod
    def decided_nodes(st: PaxosState, slot: int) -> list:
        d = st.decided[:, slot].cpu().numpy()
        return [i for i, v in enumerate(d) if v >= 0]
