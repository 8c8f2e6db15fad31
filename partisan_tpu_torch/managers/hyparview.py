"""HyParView partial-view overlay manager.

Port of ``partisan_tpu/managers/hyparview.py``.  Each node keeps a
small symmetric active view and an id-keyed passive bucket cache,
maintained by JOIN / FORWARD_JOIN random walks, NEIGHBOR requests,
DISCONNECTs, periodic SHUFFLE walks and promotions, a liveness heartbeat
and auto-rejoin; the whole inbox is handled batched (see the reference's
module docstring for the protocol mapping).

X-BOT (``HyParViewConfig.xbot``, reference
partisan_hyparview_peer_service_manager.erl:1880-2050) runs the full
4-party replace handshake: initiator i (worst peer o) -> candidate c; a
full c delegates to its worst peer d (REPLACE); d switches to o (SWITCH),
so the swap i-o, c-d -> i-c, o-d keeps every degree.  Its cost oracle is
the synthetic per-pair hash (:func:`link_cost`), or, with
``DistanceConfig.xbot_oracle``, the distance plane's measured RTTs
(``distance.measured_or_modeled``).  With ``Config.distance.enabled``
the manager state carries a ``distance.DistanceState`` and step 8 runs
the ping/pong plane over the active view plus a passive sample.
Reserved slots (:meth:`HyParView.reserve`) hold active capacity back from
ordinary admission.

Port notes:

- The reference's ``lax.cond`` quiet gates (prune, busy, fj_go,
  cad_busy) are evaluated on the host here (``bool(flag)``) and run
  exactly the branch the reference runs; the skip branches return what
  its skip branches return.
- ``lax.top_k`` is a stable descending sort cut to k (lowest index first
  on ties); ``argmax``/``argmin`` take the first extremum, as jnp does.
- The ``fori_loop`` walks are Python loops over hops; the vmapped
  ``views.admit``/``views.bucket_merge`` take a leading batch axis.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from partisan_tpu_torch import distance as distance_mod
from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.managers.base import RoundCtx
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.ops import gate, rng, scope, select, views

_TAG_XBOT_COST = 307
_TAG_XCAND = 319
_TAG_DPROBE = 324
_TAG_JOINSLOT = 314
_TAG_ADMIT = 308
_TAG_PMERGE = 309
_TAG_MINE = 312
_TAG_CANDSEL = 313
_TAG_SHSAMP_A = 315
_TAG_SHSAMP_P = 316
_TAG_SHTGT = 317
_TAG_PRTGT = 318
_TAG_PSEL = 320
_TAG_REJOIN = 321
_TAG_HBSEED = 322
_TAG_HBJIT = 323
_TAG_HBFALL = 325
_TAG_FJWALK = 330
_TAG_SHWALK = 340

K = T.MsgKind


def _shuffle_sample(cfg) -> int:
    return cfg.hyparview.shuffle_k_active + cfg.hyparview.shuffle_k_passive


def link_cost(seed: int, a, b) -> torch.Tensor:
    """Synthetic symmetric link-latency oracle for X-BOT: a deterministic
    uniform hash per unordered pair, stable across rounds (the reference
    measures live RTTs, :2978-3000), as float32."""
    dev = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)),
               None)
    a = torch.as_tensor(a, dtype=torch.int32, device=dev)
    b = torch.as_tensor(b, dtype=torch.int32, device=dev)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    return faults_mod.edge_hash(
        seed, torch.zeros((), dtype=torch.int32, device=lo.device),
        _TAG_XBOT_COST, lo, hi).to(torch.float32)


class HyParViewState(NamedTuple):
    active: torch.Tensor       # int32[n, active_max]
    passive: torch.Tensor      # int32[n, passive_max]
    join_target: torch.Tensor  # int32[n] — pending scripted JOIN (-1 none)
    leaving: torch.Tensor      # bool[n]
    left: torch.Tensor         # bool[n]
    reserved: torch.Tensor     # int32[n]
    joined: torch.Tensor       # bool[n]
    hb_epoch: torch.Tensor     # int32[n]
    hb_rnd: torch.Tensor       # int32[n]
    dist: Any = ()             # distance.DistanceState when
    #                            Config.distance.enabled, else ()


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[:, None], axis=1)[:, 0]``."""
    return x.gather(1, idx[:, None].to(torch.int64))[:, 0]


def _healed(cfg, ctx, rounds: int):
    """A repair interval under the healing controller: ``rounds >>
    boost`` (at least 1) with the round-start boost, else ``rounds``."""
    if not cfg.control.healing:
        return rounds
    with scope.phase("round.control.healing"):
        boost = ctx.control.healing.boost
        return torch.clamp(torch.full_like(boost, rounds) >> boost, min=1)


class HyParView:
    name = "hyparview"

    def init(self, cfg, comm) -> HyParViewState:
        need = T.HDR_WORDS + 1 + _shuffle_sample(cfg)
        if cfg.msg_words < need:
            raise ValueError(
                f"hyparview needs msg_words >= {need} "
                f"(shuffle sample wire format), got {cfg.msg_words}")
        n, dev = comm.n_local, comm.device
        i32 = dict(dtype=torch.int32, device=dev)
        b = dict(dtype=torch.bool, device=dev)
        return HyParViewState(
            active=views.empty_batch(n, cfg.hyparview.active_max, dev),
            passive=views.empty_batch(n, cfg.hyparview.passive_max, dev),
            join_target=torch.full((n,), -1, **i32),
            leaving=torch.zeros(n, **b), left=torch.zeros(n, **b),
            reserved=torch.zeros(n, **i32), joined=torch.zeros(n, **b),
            hb_epoch=torch.zeros(n, **i32), hb_rnd=torch.zeros(n, **i32),
            dist=(distance_mod.init(cfg, comm)
                  if cfg.distance.enabled else ()))

    def step(self, cfg, comm, state: HyParViewState, ctx: RoundCtx):
        hv = cfg.hyparview
        W = cfg.msg_words
        SAMPLE = _shuffle_sample(cfg)
        A = hv.active_max
        n_local = state.active.shape[0]
        dev = state.active.device
        gids = comm.local_ids()
        inb = ctx.inbox.data
        cap = inb[0].shape[1]
        ph = cfg.timer_phase(gids)

        # failure detector: prune crash-stopped and left peers (identity
        # while everyone is reachable, so only run when someone is not)
        reachable = ctx.faults.alive & ~comm.gather_vec(state.left)

        def prune():
            both = torch.cat([state.active, state.passive], dim=1)
            ok = (both >= 0) & reachable[both.clamp(min=0)]
            cleaned = torch.where(ok, both, -1)
            return cleaned[:, :A], cleaned[:, A:]

        active, passive_in = gate.cond(
            (~reachable).any(), prune, lambda: (state.active, state.passive))

        active0, passive0 = active, passive_in
        me2 = gids[:, None]
        asize0 = (active0 >= 0).sum(dim=1)
        acap = A - state.reserved
        join_tgt = state.join_target

        kind = inb[T.W_KIND]
        src = inb[T.W_SRC]
        p0 = inb[T.P0]
        p1 = inb[T.P1]
        dep_w = inb[T.P2]
        is_join = kind == K.HPV_JOIN
        is_fj = kind == K.HPV_FORWARD_JOIN
        is_nb = kind == K.HPV_NEIGHBOR
        is_acc = kind == K.HPV_NEIGHBOR_ACCEPTED
        is_disc = kind == K.HPV_DISCONNECT
        is_sh = kind == K.HPV_SHUFFLE
        is_shr = kind == K.HPV_SHUFFLE_REPLY
        xbot = hv.xbot
        if xbot:
            is_xo = kind == K.HPV_XBOT_OPT
            is_xr = kind == K.HPV_XBOT_OPT_REPLY
        else:
            is_xo = is_xr = torch.zeros_like(is_join)

        slot_col = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
        arangeA = torch.arange(A, dtype=torch.int32, device=dev)

        def ranked(tag, *coords):
            return rng.rank32(ctx.seed, ctx.rnd, tag, *coords)

        def row_ranked(view, tag, k, exclude=None):
            r = ranked(tag, gids[:, None], torch.arange(
                view.shape[1], dtype=torch.int32, device=dev)[None, :])
            okv = view >= 0
            if exclude is not None:
                okv = okv & ~(view[:, :, None] == exclude[:, None, :]).any(2)
            vals, t = rng.topk(torch.where(okv, r | 1, 0), k)
            return torch.where(vals > 0, view.gather(1, t), -1)

        def compact(ids2d, score2d, k):
            v, b = rng.topk(score2d, k)
            ids = torch.where(v > 0, ids2d.gather(1, b), -1)
            col = torch.where(v > 0, b.to(torch.int32), -1)
            return ids, col

        # X-BOT's latency oracle: the synthetic per-pair hash, or with
        # the distance plane's xbot_oracle the measured RTTs of the
        # round-start cache (the modeled expectation for unprobed peers)
        use_measured = xbot and cfg.distance.enabled \
            and cfg.distance.xbot_oracle

        def cost(a2, b2):
            if not use_measured:
                return link_cost(cfg.seed, a2, b2)
            if b2.dim() == 1:
                return distance_mod.measured_or_modeled(
                    cfg, state.dist, a2.reshape(-1, 1), b2[:, None])[:, 0]
            return distance_mod.measured_or_modeled(cfg, state.dist, a2, b2)

        def worst_peer():
            """The active member with the highest cost (-1 if none)."""
            costs0 = torch.where(
                active0 >= 0,
                cost(me2.expand(active0.shape), active0.clamp(min=0)),
                -torch.inf)
            z = _take(active0, torch.argmax(costs0, dim=1))
            return torch.where((active0 >= 0).any(dim=1), z, -1)

        # ---- timer fire masks + the BUSY predicates ------------------
        # self-healing: while the digest shows a degraded overlay the
        # repair cadences run at interval >> boost
        sh_every = _healed(cfg, ctx, cfg.shuffle_every)
        pr_every = _healed(cfg, ctx, cfg.promotion_every)
        sh_fire = (torch.remainder(ctx.rnd + ph, sh_every) == 0) \
            & (asize0 > 0) & ctx.alive
        pr_fire = (torch.remainder(ctx.rnd + gids, pr_every) == 0) \
            & (asize0 < hv.active_min) & ctx.alive
        is_ctl = (is_join | is_fj | is_nb | is_acc | is_disc | is_sh | is_shr
                  | is_xo | is_xr | (kind == K.HPV_NEIGHBOR_REJECTED))
        cad = sh_fire.any() | pr_fire.any()
        if xbot:
            x_timer = (torch.remainder(ctx.rnd + ph, cfg.xbot_every) == 0) \
                & (asize0 >= acap) & (acap > 0) & ctx.alive
            is_ctl = is_ctl | ((kind >= K.HPV_XBOT_REPLACE)
                               & (kind <= K.HPV_XBOT_REPLACE_REPLY))
            cad = cad | x_timer.any()
        busy = is_ctl.any() | (join_tgt >= 0).any() | state.leaving.any()
        # both bodies hold collectives on a sharded cluster: the gates
        # read the whole cluster
        busy, cad = comm.allmax(busy), comm.allmax(cad)

        BUSY_SHAPES = [cap, A, A, A, A, 1, 1] + ([cap] if xbot else [])
        CAD_SHAPES = [1, 1] + ([1] if xbot else [])

        def busy_branch():
            in_active0 = views.contains(active0, src)
            # ---- 1. removals ---------------------------------------------
            disc_src = torch.where(is_disc, src, -1)
            removed = ((active0[:, :, None] == disc_src[:, None, :])
                       & (active0 >= 0)[:, :, None]).any(dim=2)
            if xbot:
                p2w, p3w, p4w = inb[T.P2], inb[T.P3], inb[T.P3 + 1]
                is_xrep = kind == K.HPV_XBOT_REPLACE         # at d
                is_xsw = kind == K.HPV_XBOT_SWITCH           # at o
                is_xswr = kind == K.HPV_XBOT_SWITCH_REPLY    # at d
                is_xrepr = kind == K.HPV_XBOT_REPLACE_REPLY
                z = worst_peer()
                have_room = (asize0 < acap) & (acap > 0)
                # candidate side (OPT at c): room -> take the initiator
                # now; full -> delegate to the worst peer d via REPLACE
                xo_take = is_xo & have_room[:, None] & ~in_active0
                xo_dup = is_xo & in_active0
                xo_full = is_xo & ~have_room[:, None] & ~in_active0 \
                    & (z >= 0)[:, None]
                # d side (REPLACE): switch to o only if o beats c for me
                xrep_sw = is_xrep & (p0 >= 0) \
                    & (cost(me2, p0.clamp(min=0))
                       < cost(me2, p2w.clamp(min=0)))
                xrep_no = is_xrep & ~xrep_sw
                # o side (SWITCH): accept iff the initiator is ours
                xsw_acc = is_xsw & views.contains(active0, p1)
                xswr_ok = is_xswr & (p4w == 1)
                xrepr_ok = is_xrepr & (p4w == 1)
                # i side (OPT_REPLY): swap out o once c committed
                ok_xr = is_xr & (p1 == 1)
                swap_xr = ok_xr & views.contains(active0, p0)
                # demotions: o at i, i at o, c at d, d at c
                xrm = select([swap_xr, xsw_acc, xswr_ok, xrepr_ok],
                             [p0, p1, p2w, p3w], -1)
                removed = removed | (
                    (active0[:, :, None] == xrm[:, None, :])
                    & (active0 >= 0)[:, :, None]
                    & (xrm >= 0)[:, None, :]).any(dim=2)
            active1 = torch.where(removed, -1, active0)

            # ---- 2. per-kind slot decisions (round-start views) ----------
            fjj = p0
            j_in_act = views.contains(active0, fjj)
            is_dep = is_fj & (dep_w == 1)
            stop_ok = is_fj & ~is_dep & (fjj != me2) & ~j_in_act
            deposit = is_dep & (fjj != me2)

            fresh = is_join & ~in_active0
            slot_idx = torch.arange(cap, device=dev)[None, :]
            first_slot = torch.argmin(torch.where(fresh, slot_idx, cap), dim=1)
            has_fresh = fresh.any(dim=1)
            first = fresh & (slot_idx == first_slot[:, None])

            want_nb = is_nb & ((p0 == 1) | (asize0 < acap)[:, None])
            origin = p0
            sh_ids = plane_ops.Planes(inb[T.P1:T.P1 + SAMPLE])

            # ---- 3. scripted-join pre-insert + central admission ---------
            inview_j = ((active1 == join_tgt[:, None])
                        & (join_tgt >= 0)[:, None]).any(dim=1)
            has_empty = (active1 < 0).any(dim=1)
            first_empty = torch.argmax((active1 < 0).to(torch.int8), dim=1)
            rslot = (ranked(_TAG_JOINSLOT, gids) % A).to(torch.int32)
            slot_j = torch.where(has_empty, first_empty.to(torch.int32), rslot)
            do_pre = (join_tgt >= 0) & ~inview_j & (join_tgt != gids)
            occupant = _take(active1, slot_j)
            evicted_j = torch.where(do_pre & ~has_empty, occupant, -1)
            oh_j = arangeA[None, :] == slot_j[:, None]
            active1 = torch.where(do_pre[:, None] & oh_j, join_tgt[:, None],
                                  active1)

            x_steps = [xo_take, ok_xr, xsw_acc, xswr_ok, xrepr_ok] \
                if xbot else []
            cand_slot = select([first, stop_ok, want_nb, is_acc] + x_steps,
                               [src, fjj, src, src]
                               + ([src, src, p3w, p0, p1] if xbot else []),
                               -1)
            # confirmations rank above requests: an accept or an X-BOT
            # chain step has already committed (or demoted) its side
            commit_prio = is_acc
            for m in x_steps:
                commit_prio = commit_prio | m
            prio_slot = torch.where(commit_prio, 2, 1).to(torch.int32)
            CAND = min(A, cap)
            csc = torch.where(
                cand_slot >= 0,
                (prio_slot.to(torch.int64) << 28)
                | (ranked(_TAG_CANDSEL, gids[:, None], slot_col) >> 4) | 1,
                0)
            cands, cand_col = compact(cand_slot, csc, CAND)
            prios = torch.where(cand_col >= 0,
                                prio_slot.gather(1, cand_col.clamp(min=0)
                                                 .to(torch.int64)), 0)
            adscores = ranked(_TAG_ADMIT, gids[:, None], torch.arange(
                A + CAND, dtype=torch.int32, device=dev)[None, :])
            new_active, _admitted, evicted = views.admit(
                active1, cands, prios, adscores, acap)

            in_new = views.contains(new_active, src)
            j_in_new = views.contains(new_active, fjj)

            # ---- 4. per-slot replies -------------------------------------
            sh_slot = torch.argmax(is_sh.to(torch.int8), dim=1)
            sh_any = is_sh.any(dim=1)
            shr_slot = torch.argmax(is_shr.to(torch.int8), dim=1)
            shr_any = is_shr.any(dim=1)
            origin1 = _take(origin, sh_slot)
            both_ids = plane_ops.stack_words(plane_ops.take_along(
                sh_ids, torch.stack([sh_slot, shr_slot], dim=1), dim=1))
            ids1 = both_ids[:, 0]
            shr_ids1 = both_ids[:, 1]
            mine1 = row_ranked(passive0, _TAG_MINE, SAMPLE)
            shreply_msgs = msg_ops.build(
                cfg, K.HPV_SHUFFLE_REPLY, gids,
                torch.where(sh_any & (origin1 != gids) & (origin1 >= 0),
                            origin1, -1),
                payload=(gids, *mine1.unbind(dim=1)))

            m_acc_join = is_join & in_new
            m_acc_fj = stop_ok & j_in_new
            m_nb_acc = is_nb & in_new
            m_nb_rej = is_nb & ~in_new
            m_acc_fix = is_acc & ~in_new
            x_conds, x_kinds, x_dsts = [], [], []
            if xbot:
                # an X-BOT candidate that committed its accept but lost
                # the central admission is torn down (no one-way link)
                xr_fix = ok_xr & ~in_new
                i_in_new = views.contains(new_active, p1)
                o_in_new = views.contains(new_active, p0)
                d_in_new = views.contains(new_active, p3w)
                xo_acc = xo_take | xo_dup    # OPT_REPLY (flag below)
                x_conds = [xo_acc, xo_full, xrep_sw, xrep_no, is_xsw,
                           is_xswr, is_xrepr, xr_fix]
                x_kinds = [int(k) for k in (
                    K.HPV_XBOT_OPT_REPLY, K.HPV_XBOT_REPLACE,
                    K.HPV_XBOT_SWITCH, K.HPV_XBOT_REPLACE_REPLY,
                    K.HPV_XBOT_SWITCH_REPLY, K.HPV_XBOT_REPLACE_REPLY,
                    K.HPV_XBOT_OPT_REPLY, K.HPV_DISCONNECT)]
                x_dsts = [src, z[:, None].expand(src.shape), p0, src, src,
                          p2w, p1]
            rkind = select(
                [m_acc_join, m_acc_fj, m_nb_acc, m_nb_rej, m_acc_fix]
                + x_conds,
                [int(K.HPV_NEIGHBOR_ACCEPTED)] * 3
                + [int(K.HPV_NEIGHBOR_REJECTED), int(K.HPV_DISCONNECT)]
                + x_kinds, 0)
            rdst = select([m_acc_fj] + x_conds[:-1], [fjj] + x_dsts, src)
            rdst = torch.where(rkind > 0, rdst, -1)
            w0 = select([m_acc_join, m_acc_fj,
                         m_nb_acc | m_nb_rej | m_acc_fix],
                        [me2.expand(p0.shape), p1, -1], p0)
            payload = [w0] + [inb[T.HDR_WORDS + wi]
                              for wi in range(1, W - T.HDR_WORDS)]
            if xbot:
                # P1: the accepted flag on OPT_REPLY, the initiator on a
                # delegated REPLACE; P2, P3: c and d on a REPLACE; P4:
                # the chain's commit flag
                payload[1] = torch.where(xo_acc, in_new.to(torch.int32),
                                         payload[1])
                payload[1] = torch.where(xo_full, src, payload[1])
                payload[1] = torch.where(
                    is_xrepr, (xrepr_ok & i_in_new).to(torch.int32),
                    payload[1])
                payload[2] = torch.where(xo_full, me2, payload[2])
                payload[3] = torch.where(xo_full, z[:, None], payload[3])
                payload[4] = torch.where(
                    is_xsw, (xsw_acc & d_in_new).to(torch.int32), payload[4])
                payload[4] = torch.where(
                    is_xswr, (xswr_ok & o_in_new).to(torch.int32),
                    payload[4])
                payload[4] = torch.where(xrep_no, 0, payload[4])
            replies = msg_ops.build(cfg, rkind, me2.expand(rdst.shape), rdst,
                                    payload=tuple(payload))
            ev_disc = msg_ops.build(cfg, K.HPV_DISCONNECT,
                                    me2.expand(evicted.shape), evicted)

            # ---- 5. join fan-out: in-round forward-join walks ------------
            joiner = torch.where(has_fresh, _take(src, first_slot), -1)
            fj_tgt = torch.where((active0 >= 0) & (active0 != joiner[:, None])
                                 & (joiner >= 0)[:, None], active0, -1)
            me2b = me2.expand(fj_tgt.shape)
            fanout_fj, fanout_dep = gate.cond(
                comm.allmax(has_fresh.any()),
                lambda: self._fj_walk(cfg, comm, ranked, gids, active0,
                                      asize0, joiner, fj_tgt, me2b),
                lambda: (msg_ops.zero_stack(cfg, (n_local, A), dev),
                         msg_ops.zero_stack(cfg, (n_local, A), dev)))
            lv_tgt = torch.where(state.leaving[:, None], active0, -1)
            fanout_lv = msg_ops.build(cfg, K.HPV_DISCONNECT,
                                      me2.expand(lv_tgt.shape), lv_tgt)
            ev_join_disc = msg_ops.build(cfg, K.HPV_DISCONNECT, gids,
                                         evicted_j)

            # ---- 6. passive merge (id-keyed bucket cache) ----------------
            # passive-bound ids: disconnect sources, walk deposits and
            # the X-BOT swap's demotions
            pw0 = select([is_disc, deposit] + ([swap_xr, xsw_acc, xswr_ok,
                                                xrepr_ok] if xbot else []),
                         [src, fjj] + ([p0, p1, p2w, p3w] if xbot else []),
                         -1)
            PSEL = min(A, cap)
            psc = torch.where(
                pw0 >= 0,
                (ranked(_TAG_PSEL, gids[:, None], slot_col) >> 1) | 1, 0)
            p_slotborne, _ = compact(pw0, psc, PSEL)
            pcands = torch.cat([
                p_slotborne,
                torch.where(sh_any[:, None], ids1, -1),
                torch.where((sh_any & (origin1 != gids))[:, None],
                            origin1[:, None], -1),
                torch.where(shr_any[:, None], shr_ids1, -1),
                evicted,
                evicted_j[:, None],
            ], dim=1)
            pranks = ranked(_TAG_PMERGE, gids[:, None], torch.arange(
                pcands.shape[1], dtype=torch.int32, device=dev)[None, :])
            promoted = ((passive0[:, :, None] == new_active[:, None, :])
                        & (passive0 >= 0)[:, :, None]).any(dim=2)
            passive1 = torch.where(promoted, -1, passive0)
            new_passive = views.bucket_merge(passive1, pcands, pranks, gids,
                                             new_active)

            new_active = torch.where(state.leaving[:, None], -1, new_active)
            new_passive = torch.where(state.leaving[:, None], -1, new_passive)
            emitted_hv = (replies, ev_disc, fanout_fj, fanout_dep, fanout_lv,
                          ev_join_disc.map(lambda w: w[:, None]),
                          shreply_msgs.map(lambda w: w[:, None]))
            if xbot:
                # the swap's disconnects: o at i, i at o, c at d, d at c
                xdst = select([swap_xr, xsw_acc, xswr_ok, xrepr_ok],
                              [p0, p1, p2w, p3w], -1)
                emitted_hv += (msg_ops.build(cfg, K.HPV_DISCONNECT,
                                             me2.expand(xdst.shape), xdst),)
            return new_active, new_passive, emitted_hv

        def idle():
            return active0, passive0, tuple(
                msg_ops.zero_stack(cfg, (n_local, k), dev)
                for k in BUSY_SHAPES)

        new_active, new_passive, emitted_hv = gate.cond(busy, busy_branch,
                                                        idle)

        # ---- cadenced sends: shuffle walk, promotion ---------------------
        def cadenced():
            glob_act = comm.gather_vec(active0)              # [n_global, A]
            sh_tgt = row_ranked(active0, _TAG_SHTGT, 1)[:, 0]
            curs, prevs = sh_tgt, gids
            for h in range(hv.arwl - 1):
                vc = glob_act[curs.clamp(0, comm.n_global - 1)
                              .to(torch.int64)]
                r = ranked(_TAG_SHWALK, gids[:, None], h * A + arangeA[None, :])
                okm = (vc >= 0) & (vc != gids[:, None]) \
                    & (vc != prevs[:, None]) & (vc != curs[:, None])
                sc = torch.where(okm, r | 1, 0)
                nxt = _take(vc, torch.argmax(sc, dim=1))
                ok = (curs >= 0) & (sc.max(dim=1).values > 0)
                curs, prevs = (torch.where(ok, nxt, curs),
                               torch.where(ok, curs, prevs))
            smp = torch.cat([
                row_ranked(active0, _TAG_SHSAMP_A, hv.shuffle_k_active),
                row_ranked(passive0, _TAG_SHSAMP_P, hv.shuffle_k_passive),
            ], dim=1)[:, :SAMPLE]
            shuffle_msgs = msg_ops.build(
                cfg, K.HPV_SHUFFLE, gids,
                torch.where(sh_fire & (curs >= 0), curs, -1), ttl=1,
                payload=(gids, *smp.unbind(dim=1)))
            pr_tgt = row_ranked(passive0, _TAG_PRTGT, 1, exclude=active0)[:, 0]
            promote_msgs = msg_ops.build(
                cfg, K.HPV_NEIGHBOR, gids,
                torch.where(pr_fire & (pr_tgt >= 0), pr_tgt, -1),
                payload=((asize0 == 0).to(torch.int32),))
            emitted_cad = (shuffle_msgs.map(lambda w: w[:, None]),
                           promote_msgs.map(lambda w: w[:, None]))
            if xbot:
                z = worst_peer()
                cand = row_ranked(passive0, _TAG_XCAND, 1,
                                  exclude=active0)[:, 0]
                x_fire = x_timer & (cand >= 0) & (z >= 0) \
                    & (cost(gids, cand.clamp(min=0))
                       < cost(gids, z.clamp(min=0)))
                emitted_cad += (msg_ops.build(
                    cfg, K.HPV_XBOT_OPT, gids, torch.where(x_fire, cand, -1),
                    payload=(z,)).map(lambda w: w[:, None]),)
            return emitted_cad

        def no_cadence():
            return tuple(msg_ops.zero_stack(cfg, (n_local, k), dev)
                         for k in CAD_SHAPES)

        emitted_cad = gate.cond(cad, cadenced, no_cadence)

        # ---- 7. timers: heartbeat, auto-rejoin, scripted join --------
        stale_hb = torch.zeros_like(ctx.alive)
        hb_epoch, hb_rnd = state.hb_epoch, state.hb_rnd
        if hv.heartbeat:
            H = cfg.rounds(hv.heartbeat_every_ms)
            # the escalated isolation window: stale nodes re-join sooner
            # while the overlay is degraded
            window = _healed(cfg, ctx, cfg.rounds(hv.isolation_window_ms))
            root = torch.argmax(ctx.faults.alive.to(torch.int8)).to(torch.int32)
            own = torch.where(gids == root,
                              torch.div(ctx.rnd, H, rounding_mode="floor"), 0)
            rows = torch.maximum(hb_epoch, own)
            tgts = torch.where(active0 >= 0, active0, -1)
            pulled = comm.push_max(rows[:, None], tgts)[:, 0]
            new_epoch = torch.maximum(rows, pulled)
            first_join = ctx.alive & ~state.joined & (new_active >= 0).any(1)
            jit = (ranked(_TAG_HBJIT, gids, 0) % max(H, 1)).to(torch.int32)
            stale_hb = ctx.alive & ~state.left & state.joined \
                & (ctx.rnd - hb_rnd > window + jit)
            hb_epoch = new_epoch
            hb_rnd = torch.where((new_epoch > state.hb_epoch) | first_join
                                 | stale_hb, ctx.rnd, hb_rnd)

        if isinstance(ctx.n_active, tuple):
            n_eff = torch.tensor(comm.n_global, dtype=torch.int32, device=dev)
        else:
            n_eff = ctx.n_active
        ng_eff = torch.clamp(n_eff - 1, min=1).to(torch.int64)
        join_dst = join_tgt
        if hv.auto_rejoin:
            isolated = ctx.alive & ~state.left & state.joined \
                & (asize0 == 0) & ~(passive0 >= 0).any(dim=1) & (join_tgt < 0)
            contact = (ranked(_TAG_REJOIN, gids) % ng_eff).to(torch.int32)
            contact = contact + (contact >= gids).to(torch.int32)
            join_dst = torch.where(isolated, contact, join_tgt)
        if hv.heartbeat and comm.n_global > 1:
            sc = torch.clamp(n_eff, min=2).clamp(
                max=min(max(hv.seed_count, 2), comm.n_global)).to(torch.int64)
            seedc = (ranked(_TAG_HBSEED, gids) % sc).to(torch.int32)
            seedc = torch.where(seedc == gids,
                                torch.remainder(seedc + 1, sc.to(torch.int32)),
                                seedc)
            fallb = (ranked(_TAG_HBFALL, gids) % ng_eff).to(torch.int32)
            fallb = fallb + (fallb >= gids).to(torch.int32)
            seed_dead = ~ctx.faults.alive[
                seedc.clamp(0, comm.n_global - 1).to(torch.int64)]
            seedc = torch.where(seed_dead, fallb, seedc)
            join_dst = torch.where(stale_hb & (join_dst < 0), seedc, join_dst)
        join_msgs = msg_ops.build(cfg, K.HPV_JOIN, gids,
                                  torch.where(join_dst >= 0, join_dst, -1))

        blocks = [*emitted_hv, *emitted_cad,
                  join_msgs.map(lambda w: w[:, None])]

        # ---- 8. distance/RTT plane: probe the active view plus a
        # passive sample (X-BOT's candidate pool gathers measurements)
        new_dist = state.dist
        if cfg.distance.enabled:
            psamp = row_ranked(passive0, _TAG_DPROBE,
                               cfg.distance.probe_passive)
            new_dist, dist_emit = distance_mod.step(
                cfg, comm, state.dist, ctx, torch.cat([active0, psamp], 1))
            blocks.append(dist_emit)

        # crash-stopped and left nodes are frozen and silent
        live = ctx.alive & (~state.left | (state.join_target >= 0))
        new_active = torch.where(live[:, None], new_active, state.active)
        new_passive = torch.where(live[:, None], new_passive, state.passive)
        blocks = [plane_ops.set_word(
            b, T.W_KIND, torch.where(live[:, None], b[T.W_KIND], 0))
            for b in blocks]

        confirmed = ((kind == K.HPV_NEIGHBOR_ACCEPTED)
                     & ((src == join_tgt[:, None]) | (p0 == join_tgt[:, None]))
                     ).any(dim=1) & (join_tgt >= 0)
        new_state = HyParViewState(
            active=new_active,
            passive=new_passive,
            join_target=torch.where(ctx.alive & confirmed, -1,
                                    state.join_target),
            leaving=torch.where(live, False, state.leaving),
            left=(state.left | (state.leaving & live))
            & ~(state.join_target >= 0),
            reserved=state.reserved,
            joined=state.joined | (live & (new_active >= 0).any(dim=1)),
            hb_epoch=torch.where(live, hb_epoch, state.hb_epoch),
            hb_rnd=torch.where(live, hb_rnd, state.hb_rnd),
            dist=(distance_mod.DistanceState(*(
                torch.where(live[:, None], new, old)
                for new, old in zip(new_dist, state.dist)))
                if cfg.distance.enabled else state.dist),
        )
        return new_state, tuple(blocks)

    def _fj_walk(self, cfg, comm, ranked, gids, active0, asize0, joiner,
                 fj_tgt, me2b):
        """The contact fans one FORWARD_JOIN per active member and walks
        each copy ARWL hops over the round-start views; the endpoint gets
        the stop copy, the PRWL-hop node a deposit copy."""
        hv = cfg.hyparview
        A = hv.active_max
        dev = active0.device
        arangeA = torch.arange(A, dtype=torch.int32, device=dev)
        jb = joiner[:, None].expand(fj_tgt.shape)
        # the walk reads remote views: the round-start views, gathered
        glob_act = comm.gather_vec(active0)                  # [n_global, A]
        glob_asz = comm.gather_vec(asize0)                   # [n_global]
        curf, prevf = fj_tgt, me2b
        stopped = fj_tgt < 0
        endpoint = torch.full_like(fj_tgt, -1)
        depnode = torch.full_like(fj_tgt, -1)
        for h in range(hv.arwl):
            cc = curf.clamp(0, comm.n_global - 1).to(torch.int64)
            vc = glob_act[cc]                                  # [n, A, A]
            j_in = ((vc == jb[:, :, None]) & (vc >= 0)).any(dim=2)
            small = glob_asz[cc] <= 1
            r = ranked(_TAG_FJWALK, gids[:, None, None],
                       arangeA[None, :, None], h * A + arangeA[None, None, :])
            okm = (vc >= 0) & (vc != jb[:, :, None]) \
                & (vc != prevf[:, :, None]) & (vc != curf[:, :, None])
            sc = torch.where(okm, r | 1, 0)
            bi = torch.argmax(sc, dim=2)
            nxt = vc.gather(2, bi[:, :, None])[:, :, 0]
            has_nxt = sc.max(dim=2).values > 0
            live_w = (curf >= 0) & ~stopped
            stop_here = live_w & (small | j_in | ~has_nxt)
            endpoint = torch.where(stop_here, curf, endpoint)
            if h == hv.arwl - hv.prwl:
                depnode = torch.where(live_w & ~stop_here, curf, depnode)
            stopped = stopped | stop_here
            go = live_w & ~stop_here
            prevf = torch.where(go, curf, prevf)
            curf = torch.where(go, nxt, curf)
        endpoint = torch.where(stopped, endpoint, curf)
        return (msg_ops.build(cfg, K.HPV_FORWARD_JOIN, me2b, endpoint,
                              payload=(jb, me2b)),
                msg_ops.build(cfg, K.HPV_FORWARD_JOIN, me2b, depnode,
                              payload=(jb, me2b, torch.ones_like(jb))))

    # ---- views -------------------------------------------------------
    def neighbors(self, cfg, state: HyParViewState, comm=None):
        return state.active

    def members(self, cfg, state: HyParViewState, comm=None):
        """bool[n_local, n_global]: itself + its active view (a whole
        state without ``comm``)."""
        n_local = state.active.shape[0]
        dev = state.active.device
        if comm is not None:
            n = comm.n_global
            gids = comm.local_ids().to(torch.int64)
        else:
            n = n_local
            gids = torch.arange(n, device=dev)
        out = torch.zeros((n_local, n + 1), dtype=torch.bool, device=dev)
        rows = torch.arange(n_local, device=dev)
        out[rows, gids] = True
        cols = torch.where(state.active >= 0, state.active, n).to(torch.int64)
        out[rows[:, None].expand_as(cols), cols] = True
        return out[:, :n]

    # ---- scenario scripting ------------------------------------------
    def join(self, cfg, state: HyParViewState, node: int, target: int):
        """Script ``node``'s join via ``target`` (a new state)."""
        jt = state.join_target.clone()
        jt[node] = target
        return state._replace(join_target=jt)

    def reserve(self, cfg, state: HyParViewState, node: int,
                count: int = 1):
        """Hold back ``count`` active slots on ``node`` from ordinary
        admission (reserve/1); raises if the reservation exceeds the
        active-view width."""
        if count < 0:
            raise ValueError("count must be >= 0")
        new = int(state.reserved[node]) + count
        if new > cfg.hyparview.active_max:
            raise ValueError(
                f"reserving {new} > active_max={cfg.hyparview.active_max}")
        rs = state.reserved.clone()
        rs[node] += count
        return state._replace(reserved=rs)

    def join_many(self, cfg, state: HyParViewState, nodes, targets):
        dev = state.join_target.device
        jt = state.join_target.clone()
        jt[torch.as_tensor(nodes, dtype=torch.int64, device=dev)] = \
            torch.as_tensor(targets, dtype=torch.int32, device=dev)
        return state._replace(join_target=jt)

    def leave(self, cfg, state: HyParViewState, node: int):
        """Script ``node``'s graceful leave (the round's disconnect
        fan-out)."""
        return self.leave_many(cfg, state, [node])

    def leave_many(self, cfg, state: HyParViewState, nodes):
        """Batched graceful leave: one scatter (the elastic scale-in marks
        thousands of rows at once)."""
        dev = state.leaving.device
        lv = state.leaving.clone()
        lv[torch.as_tensor(nodes, dtype=torch.int64, device=dev)] = True
        return state._replace(leaving=lv)
