"""SCAMP membership strategies, v1 and v2 (port of
``partisan_tpu/managers/scamp.py``; see its module docstring for the
protocol and its documented deviations from the Erlang reference).

Each node keeps a partial (out) view and, in v2, an in-view.  A joiner
subscribes through a contact, which fans the subscription out to its
partial view plus ``c`` (v1) or ``c - 1`` (v2) extra copies; each copy
is kept with probability 1/(2 + |view|) or walks on.  Pings ride the
monotonic gossip lane, an isolated node re-subscribes, v2 keeps
in-views with KEEP notes and rebalances on a graceful leave, and
removals walk as UNSUBSCRIBE messages.

Port notes:

- The reference handles the inbox with a per-node ``lax.scan`` over its
  slots and a five-way ``lax.switch`` on the kind.  Here one host loop
  runs over the slots, each step batched over every node, every branch
  computed and selected by masks.  The loop stops after the last slot
  that holds a message anywhere (one host read): a later slot's
  handler is the no-op branch, which leaves the carry as it is and
  replies an empty record, and each slot draws from its own subkey
  (``_TAG_SLOT + slot``), so the skipped slots change nothing.
  ``Scamp(full_slot_loop=True)`` runs all of them (the tests hold the
  two equal).
- The slot subkeys and every draw made from them (the keep dice, the
  forward pick's gumbel mantissas, ``views.add``'s random slots) depend
  only on the node's round key, so they are drawn for all slots at once
  before the loop.
- Draws whose result no record or state can read are skipped when a
  host read shows no node needs them (the join add, the contact
  fanout's extra copies, the isolation target).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.managers.base import RoundCtx
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.ops import rng, views

# rng subkey tags (the reference's): 42x, and the per-slot streams
_TAG_JOIN = 421
_TAG_ISOLATION = 422
_TAG_FANOUT = 423
_TAG_SLOT = 1000

_PING_EDGE_TAG = 424
_WALK_TTL = 32  # forwarded-subscription hop budget

K = T.MsgKind


class ScampState(NamedTuple):
    partial: torch.Tensor      # int32[n, partial_max] — out-edges (no self)
    in_view: torch.Tensor      # int32[n, in_max] — in-edges (v2)
    last_heard: torch.Tensor   # int32[n] — round of last ping heard + 1
    join_target: torch.Tensor  # int32[n] — pending scripted join (-1 none)
    join_round: torch.Tensor   # int32[n] — admission round of that join
    leaving: torch.Tensor      # bool[n]
    left: torch.Tensor         # bool[n]


def _slot_draws(keys: torch.Tensor, slots: int, p_width: int,
                iv_width: int, v2: bool):
    """Every draw the inbox handler makes, for slots [0, slots): the keep
    dice ``uniform(k1)`` float32[n, S], the forward pick's gumbel
    mantissas ``random_bits(k2, P) >> 9`` int64[n, S, P], the partial
    view's ``randint(k3, 0, P)`` and (v2) the in-view's
    ``randint(k1, 0, IV)``, int32[n, S] — where ``k1..k3`` fold 1..3
    into the slot's subkey ``fold_in(key, _TAG_SLOT + slot)``."""
    dev = keys.device
    skey = rng.fold_in(keys[:, None, :], torch.arange(
        _TAG_SLOT, _TAG_SLOT + slots, dtype=torch.int64, device=dev))
    k = rng.fold_in(skey[:, :, None, :],
                    torch.arange(1, 4, dtype=torch.int64, device=dev))
    k1, k2, k3 = k[:, :, 0], k[:, :, 1], k[:, :, 2]
    halves = rng.split2(torch.stack([k1, k3], dim=2))   # [n, S, 2, 2, 2]
    bits = rng.random_bits(torch.cat([k1[:, :, None],
                                      halves.flatten(2, 3)], dim=2),
                           1)[..., 0]                  # [n, S, 5]
    dice = (bits[:, :, 0] >> 9).to(torch.float32) * (2.0 ** -23)
    mant = rng.random_bits(k2, p_width) >> 9
    p_slot = rng.randint_bits(bits[:, :, 3:5], 0, p_width)
    iv_slot = rng.randint_bits(bits[:, :, 1:3], 0, iv_width) if v2 else None
    return dice, mant, p_slot, iv_slot


class Scamp:
    """Both SCAMP versions; ``v2`` toggles in-view tracking, keep
    notifications, the graceful-unsubscription rebalance and the c-1
    join fanout."""

    def __init__(self, version: int = 1, full_slot_loop: bool = False
                 ) -> None:
        if version not in (1, 2):
            raise ValueError(f"scamp version must be 1 or 2, got {version}")
        self.v2 = version == 2
        self.name = f"scamp_v{version}"
        self.full_slot_loop = full_slot_loop

    # ------------------------------------------------------------------
    def init(self, cfg, comm) -> ScampState:
        n, dev = comm.n_local, comm.device
        i32 = dict(dtype=torch.int32, device=dev)
        return ScampState(
            partial=views.empty_batch(n, cfg.scamp.partial_max, dev),
            in_view=views.empty_batch(n, cfg.scamp.in_max, dev),
            last_heard=torch.zeros(n, **i32),
            join_target=torch.full((n,), -1, **i32),
            join_round=torch.zeros(n, **i32),
            leaving=torch.zeros(n, dtype=torch.bool, device=dev),
            left=torch.zeros(n, dtype=torch.bool, device=dev))

    # ------------------------------------------------------------------
    def _handle_inbox(self, cfg, me, keys, inb, slots, partial, in_view):
        """The reference's per-node inbox scan over slots [0, slots),
        batched over nodes.  Returns (partial, in_view, fan_sub,
        gossip_rm, replies as a list of per-word columns)."""
        v2 = self.v2
        P = partial.shape[1]
        W = cfg.msg_words
        fan_sub = torch.full_like(me, -1)
        gossip_rm = torch.full_like(me, -1)
        cols = [[] for _ in range(W)]
        if slots == 0:
            return partial, in_view, fan_sub, gossip_rm, cols
        dice, mant, p_slot, iv_slot = _slot_draws(keys, slots, P,
                                                  in_view.shape[1], v2)
        p, iv = partial, in_view
        for s in range(slots):
            msg = [w[:, s] for w in inb]
            k = msg[T.W_KIND]
            ttl = msg[T.W_TTL]
            sub = msg[T.P0]
            p1 = msg[T.P1]
            is_sub = k == K.SCAMP_SUBSCRIPTION
            is_uns = k == K.SCAMP_UNSUBSCRIBE

            # forward target (both walks): one random member, not `sub`
            nxt = views.sample_mant(p, mant[:, s], 1, sub[:, None])[:, 0]
            present = views.contains(p, sub[:, None])[:, 0]

            # SUBSCRIPTION: a direct first hop takes the round's one
            # fanout (extras re-queue to self); else keep w.p.
            # 1/(2 + |view|) or forward
            direct = p1 == 1
            fs_busy = fan_sub >= 0
            requeue_s = direct & fs_busy
            dice_s = dice[:, s] < 1.0 / (2.0 + views.size(p).to(
                torch.float32))
            known = present | (sub == me) | (sub < 0)
            expired = ttl <= 0
            keep = ~known & (dice_s | expired | (nxt < 0)) & ~requeue_s
            fwd_s = ~direct & ~keep & ~requeue_s & ~expired & (nxt >= 0)
            p_sub = views.add_at(p, torch.where(keep, sub, -1),
                                 p_slot[:, s])[0]
            fan_sub = torch.where(is_sub & direct & ~fs_busy, sub, fan_sub)

            # UNSUBSCRIBE: a holder takes the round's one removal (extras
            # re-queue); a non-holder forwards the walk
            take = present & (gossip_rm < 0)
            requeue_u = present & (gossip_rm >= 0)
            fwd_u = ~present & (ttl > 0) & (nxt >= 0)
            p_uns = torch.where(take[:, None], views.remove(p, sub), p)
            gossip_rm = torch.where(is_uns & take, sub, gossip_rm)

            p_new = torch.where(is_sub[:, None], p_sub,
                                torch.where(is_uns[:, None], p_uns, p))
            # the reply: a copy of the message (self-requeue or forward)
            # or a KEEP note (v2: to a kept subscriber, or to a REPLACE's
            # replacement — empty, but from me, when that id is < 0)
            is_req = (is_sub & requeue_s) | (is_uns & requeue_u)
            is_copy = is_req | (is_sub & fwd_s) | (is_uns & fwd_u)
            from_me = is_copy
            if v2:
                is_keep = k == K.SCAMP_KEEP
                is_rep = k == K.SCAMP_REPLACE
                src = msg[T.W_SRC]
                iv_keep = views.add_at(iv, src, iv_slot[:, s])[0]
                iv = torch.where((is_uns & present)[:, None],
                                 views.remove(iv, sub),
                                 torch.where(is_keep[:, None], iv_keep, iv))
                # REPLACE (node=sub, repl=p1): swap the edge, or drop it
                # when the replacement is already an out-edge
                have_repl = views.contains(p, p1[:, None])[:, 0] | (p1 == me)
                did = present & ~have_repl
                hit = (p == sub[:, None]) & (sub >= 0)[:, None]
                p_rep = torch.where(
                    hit, torch.where(have_repl, -1, p1)[:, None], p)
                p_new = torch.where(is_rep[:, None], p_rep, p_new)
                note_dst = torch.where(is_rep & did, p1,
                                       torch.where(is_sub & keep, sub, -1))
                is_note = note_dst >= 0
                from_me = is_copy | (is_sub & keep) | (is_rep & did)
            p = p_new
            for i in range(W):
                w = msg[i]
                if i == T.W_KIND:
                    out = torch.where(is_copy, w, 0)
                    if v2:
                        out = torch.where(is_note, int(K.SCAMP_KEEP), out)
                elif i == T.W_SRC:
                    out = torch.where(from_me, me, 0)
                elif i == T.W_DST:
                    out = torch.where(is_copy, torch.where(is_req, me, nxt),
                                      0)
                    if v2:
                        out = torch.where(is_note, note_dst, out)
                elif i == T.W_TTL:
                    out = torch.where(is_copy,
                                      torch.where(is_req, w, w - 1), 0)
                else:
                    out = torch.where(is_copy, w, 0)
                cols[i].append(out.to(w.dtype))
        return p, iv, fan_sub, gossip_rm, cols

    # ------------------------------------------------------------------
    def step(self, cfg, comm, state: ScampState, ctx: RoundCtx):
        sc = cfg.scamp
        v2 = self.v2
        n = state.partial.shape[0]
        dev = state.partial.device
        me = comm.local_ids()
        keys = ctx.keys
        inb = ctx.inbox.data
        cap = inb[0].shape[1]

        admitted = (state.join_target >= 0) & (ctx.rnd >= state.join_round)
        # one host read: the last slot holding a message anywhere, and
        # whether any node joins now
        col = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
        last = torch.where((inb[T.W_KIND] != 0).any(dim=0), col, 0)
        bound, any_join = torch.stack([
            last.max(), admitted.any().to(torch.int32)]).tolist()
        slots = cap if self.full_slot_loop else bound

        # ---- scripted join, gated on the admission round --------------
        partial = state.partial
        if any_join:
            added = views.add(partial, state.join_target,
                              rng.subkey(keys, _TAG_JOIN))[0]
            partial = torch.where(admitted[:, None], added, partial)
        join_tgt = torch.where(admitted, state.join_target, -1)
        join_msg = msg_ops.build(cfg, K.SCAMP_SUBSCRIPTION, me, join_tgt,
                                 ttl=_WALK_TTL, payload=(me, 1))
        join_msg = plane_ops.where(admitted, join_msg, 0)
        # v2: the joiner holds the contact as an out-edge, so the
        # contact gains an in-edge
        join_keep = plane_ops.where(
            admitted, msg_ops.build(cfg, K.SCAMP_KEEP, me, join_tgt), 0) \
            if v2 else msg_ops.zero_stack(cfg, (n,), device=dev)

        # ---- inbox handling -------------------------------------------
        partial2, in_view2, fan_sub, gossip_rm, cols = self._handle_inbox(
            cfg, me, keys, inb, slots, partial, state.in_view)
        replies = plane_ops.Planes(
            torch.cat([torch.stack(c, dim=1), torch.zeros(
                (n, cap - len(c)), dtype=w.dtype, device=dev)], dim=1)
            if c else torch.zeros_like(w) for c, w in zip(cols, inb))
        partial_scan = partial2

        # ---- graceful leave -------------------------------------------
        leaving = state.leaving
        if v2:
            L = views.size(in_view2)
            n_replace = torch.clamp(L - (sc.c - 1), min=0)
            occ = torch.cumsum((in_view2 >= 0).to(torch.int32), dim=1) - 1
            psize = torch.clamp(views.size(partial2), min=1)
            porder = torch.sort((partial2 < 0).to(torch.int8), dim=1,
                                stable=True)[1]
            packed = partial2.gather(1, porder)
            repl = packed.gather(1, (occ % psize[:, None]).to(torch.int64))
            do_repl = (in_view2 >= 0) & (occ < n_replace[:, None]) \
                & (repl >= 0)
            kind_lv = torch.where(do_repl, int(K.SCAMP_REPLACE),
                                  int(K.SCAMP_UNSUBSCRIBE))
            fanout_lv = msg_ops.build(
                cfg, kind_lv, me[:, None],
                torch.where(leaving[:, None], in_view2, -1),
                payload=(me[:, None], repl))
        else:
            fanout_lv = msg_ops.build(
                cfg, K.SCAMP_UNSUBSCRIBE, me[:, None],
                torch.where(leaving[:, None], partial2, -1), ttl=_WALK_TTL,
                payload=(me[:, None],))
        partial2 = torch.where(leaving[:, None], -1, partial2)
        in_view2 = torch.where(leaving[:, None], -1, in_view2)

        # ---- removal gossip to the pre-scan view ----------------------
        rm_dst = torch.where((gossip_rm >= 0)[:, None], partial, -1)
        fanout_rm = msg_ops.build(cfg, K.SCAMP_UNSUBSCRIBE, me[:, None],
                                  rm_dst, ttl=_WALK_TTL,
                                  payload=(gossip_rm[:, None],))

        # ---- periodic pings on the monotonic gossip lane --------------
        fires = ((ctx.rnd + me) % cfg.gossip_every == 0) & ctx.alive \
            & ~state.left
        ping_dst = torch.where(fires[:, None], partial2, -1)
        ping_dst = faults_mod.filter_edges(ctx.faults, me, ping_dst,
                                           ctx.seed, ctx.rnd,
                                           _PING_EDGE_TAG)
        stamp = (ctx.rnd + 1).to(torch.int32).expand(n, 1)
        heard = comm.push_max(stamp, ping_dst)[:, 0]
        last_heard = torch.maximum(state.last_heard, heard)
        joined_now = admitted & ctx.alive
        last_heard = torch.maximum(
            last_heard, torch.where(joined_now, ctx.rnd + 1, 0))
        window = cfg.gossip_every * sc.message_window
        isolated = fires & (last_heard + window < ctx.rnd + 1) \
            & (ctx.rnd >= window)

        # ---- contact fanout and isolation re-subscription -------------
        copies = sc.c - 1 if v2 else sc.c
        any_fan, any_iso = torch.stack([(fan_sub >= 0).any(),
                                        isolated.any()]).tolist()
        if any_fan and copies > 0:
            extra_slots = rng.choice_slots(rng.subkey(keys, _TAG_FANOUT),
                                           partial_scan >= 0, copies)
            extra = torch.where(extra_slots >= 0, partial_scan.gather(
                1, extra_slots.clamp(min=0).to(torch.int64)), -1)
        else:
            extra = torch.full((n, max(copies, 0)), -1, dtype=torch.int32,
                               device=dev)
        fan_dst = torch.cat([partial_scan, extra], dim=1)
        fan_dst = torch.where((fan_sub >= 0)[:, None]
                              & (fan_dst != fan_sub[:, None]), fan_dst, -1)
        fanout_sub = msg_ops.build(cfg, K.SCAMP_SUBSCRIPTION, me[:, None],
                                   fan_dst, ttl=_WALK_TTL,
                                   payload=(fan_sub[:, None], 0))
        iso_dst = torch.full_like(me, -1)
        if any_iso:
            iso_dst = torch.where(isolated, views.pick_one(
                partial2, rng.subkey(keys, _TAG_ISOLATION)), -1)
        iso_msg = msg_ops.build(cfg, K.SCAMP_SUBSCRIPTION, me, iso_dst,
                                ttl=_WALK_TTL, payload=(me, 0))

        emitted = plane_ops.concat([
            replies, fanout_sub, fanout_rm, fanout_lv,
            plane_ops.stack_records([join_msg, join_keep], dim=1),
            iso_msg.map(lambda w: w[:, None])], dim=1)

        # crash-stopped and left nodes are frozen and silent
        live = ctx.alive & (~state.left | admitted)
        partial2 = torch.where(live[:, None], partial2, state.partial)
        in_view2 = torch.where(live[:, None], in_view2, state.in_view)
        emitted = plane_ops.set_word(
            emitted, T.W_KIND,
            torch.where(live[:, None], emitted[T.W_KIND], 0))

        return ScampState(
            partial=partial2, in_view=in_view2, last_heard=last_heard,
            join_target=torch.where(ctx.alive & admitted, -1,
                                    state.join_target),
            join_round=state.join_round,
            leaving=torch.where(live, False, state.leaving),
            left=(state.left | (state.leaving & live)) & ~admitted,
        ), emitted

    # ---- views -------------------------------------------------------
    def neighbors(self, cfg, state: ScampState, comm=None) -> torch.Tensor:
        return state.partial

    def members(self, cfg, state: ScampState, comm=None) -> torch.Tensor:
        """Self + partial view, bool[n, n_global]."""
        n = state.partial.shape[0]
        dev = state.partial.device
        if comm is not None:
            n_global, gids = comm.n_global, comm.local_ids()
        else:
            n_global = n
            gids = torch.arange(n, dtype=torch.int32, device=dev)
        cols = torch.where(state.partial >= 0, state.partial, n_global)
        out = torch.zeros((n, n_global + 1), dtype=torch.bool, device=dev)
        out[torch.arange(n, device=dev), gids.to(torch.int64)] = True
        out.scatter_(1, cols.to(torch.int64), True)
        return out[:, :n_global]

    # ---- scenario scripting (host-side) ------------------------------
    def _set(self, state: ScampState, field: str, idx, val) -> ScampState:
        x = getattr(state, field).clone()
        x[torch.as_tensor(idx, dtype=torch.int64, device=x.device)] = \
            torch.as_tensor(val, dtype=x.dtype, device=x.device)
        return state._replace(**{field: x})

    def join(self, cfg, state: ScampState, node: int, target: int
             ) -> ScampState:
        st = self._set(state, "join_target", node, target)
        return self._set(st, "join_round", node, 0)

    def join_many(self, cfg, state: ScampState, nodes, targets,
                  rounds=None) -> ScampState:
        """Batched scripted joins; ``rounds`` optionally staggers
        admission (node i's subscription enters at round >= rounds[i])."""
        nodes = torch.as_tensor(nodes, dtype=torch.int64)
        st = self._set(state, "join_target", nodes, targets)
        return self._set(st, "join_round", nodes,
                         0 if rounds is None else rounds)

    def leave(self, cfg, state: ScampState, node: int) -> ScampState:
        return self._set(state, "leaving", node, True)

    def leave_many(self, cfg, state: ScampState, nodes) -> ScampState:
        return self._set(state, "leaving", nodes, True)
