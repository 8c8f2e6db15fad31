"""Plumtree epidemic broadcast trees (port of
``partisan_tpu/models/plumtree.py``).

Per-root eager/lazy link flags carve a spanning tree out of the overlay;
duplicates prune to lazy, lazy links carry I_HAVE adverts, a receiver
missing an advertised payload GRAFTs, and anti-entropy pushes the store
to a random peer every exchange tick.  One batched program per round:
the inbox folds with scatter reductions (max for the store and epochs,
min for the per-tree winner, add for the packed flag counts), all
order-free, so the card gives the same bits on every run.

Port notes: the ``lax.cond`` gates (pt_go, aae_go, hand_go) are
evaluated on the host; ``lax.top_k`` is a stable descending sort; the
vmapped AAE peer pick (``rng.choice_slots``) takes a leading batch axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import managers as managers_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.config import BROADCAST_CHANNEL
from partisan_tpu_torch.managers.base import RoundCtx
from partisan_tpu_torch.models import handlers as handlers_mod
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.ops import gate, rng, scatter, scope, select

_TAG_AAE = 401
_AAE_EDGE_TAG = 402

K = T.MsgKind


class PlumtreeState(NamedTuple):
    data: torch.Tensor          # int32[n, B, PW] — handler store per slot
    rround: torch.Tensor        # int32[n, B] — tree hop distance of our copy
    pruned: torch.Tensor        # bool[n, B, K] — link k lazy for tree b
    lazy_pending: torch.Tensor  # bool[n, B, K] — outstanding i_have
    need_push: torch.Tensor     # bool[n, B] — fresh slot awaiting push
    push_src: torch.Tensor      # int32[n, B] — eager parent
    tree_nbrs: torch.Tensor     # int32[n, K] — link occupants flags refer to
    epoch: torch.Tensor         # int32[n, B] — slot-recycle generation
    nonmono: torch.Tensor       # int32[n] — monotone-recycle violations


class Plumtree:
    name = "plumtree"

    def __init__(self, handler: handlers_mod.BroadcastHandler | None = None):
        self.handler = handler if handler is not None \
            else handlers_mod.VersionHandler()

    @property
    def prov_spec(self):
        """Provenance descriptor: PT_GOSSIP records carry [slot,
        payload×PW, hop, epoch] after the header; the hop word is the
        sender's tree depth, the epoch word the slot-recycle
        generation."""
        from partisan_tpu_torch import provenance as provenance_mod

        PW = self.handler.payload_words
        return provenance_mod.ProvSpec(
            kind=int(K.PT_GOSSIP), slot_word=T.P0,
            hop_word=T.P1 + PW, epoch_word=T.P1 + PW + 1)

    def init(self, cfg, comm) -> PlumtreeState:
        n, B = comm.n_local, cfg.max_broadcasts
        dev = comm.device
        PW = self.handler.payload_words
        Kw = managers_mod.neighbor_width(cfg)
        need = T.HDR_WORDS + 3 + PW
        if cfg.msg_words < need:
            raise ValueError(
                f"plumtree with a {PW}-word handler payload needs "
                f"msg_words >= {need}, got {cfg.msg_words}")
        if cfg.inbox_cap > 1023:
            raise ValueError(
                f"plumtree needs inbox_cap <= 1023, got {cfg.inbox_cap}")
        i32 = dict(dtype=torch.int32, device=dev)
        return PlumtreeState(
            data=self.handler.bottom(dev).expand(n, B, PW).clone(),
            rround=torch.zeros((n, B), **i32),
            pruned=torch.zeros((n, B, Kw), dtype=torch.bool, device=dev),
            lazy_pending=torch.zeros((n, B, Kw), dtype=torch.bool,
                                     device=dev),
            need_push=torch.zeros((n, B), dtype=torch.bool, device=dev),
            push_src=torch.full((n, B), -1, **i32),
            tree_nbrs=torch.full((n, Kw), -1, **i32),
            epoch=torch.zeros((n, B), **i32),
            nonmono=torch.zeros(n, **i32))

    # ------------------------------------------------------------------
    def step(self, cfg, comm, state: PlumtreeState, ctx: RoundCtx,
             nbrs: torch.Tensor):
        pt = cfg.plumtree
        hd = self.handler
        PW = hd.payload_words
        n_local, B = state.data.shape[:2]
        Kn = nbrs.shape[1]
        S, L = pt.push_slots, pt.lazy_cap
        CH = cfg.channel_id(BROADCAST_CHANNEL)
        dev = state.data.device
        gids = comm.local_ids()
        bottom = hd.bottom(dev)

        changed = nbrs != state.tree_nbrs                       # [n, K]
        pruned = state.pruned & ~changed[:, None, :]
        lazyp = state.lazy_pending & ~changed[:, None, :]
        data, rr = state.data, state.rround
        npu, psrc = state.need_push, state.push_src

        inb = ctx.inbox.data
        cap = inb[0].shape[1]
        kind = inb[T.W_KIND]
        src = inb[T.W_SRC]
        b = inb[T.P0].clamp(0, B - 1)
        pay = plane_ops.stack_words(inb, T.P1, T.P1 + PW)       # [n, cap, PW]
        mr = inb[T.P1 + PW]
        ep_w = inb[T.P1 + PW + 1]
        is_g = kind == K.PT_GOSSIP
        is_ih = kind == K.PT_IHAVE
        is_gr = kind == K.PT_GRAFT
        is_pr = kind == K.PT_PRUNE
        is_ak = kind == K.PT_IHAVE_ACK

        # the gates read the whole cluster (allmax), since their branches
        # hold collectives on a sharded cluster
        pt_go = comm.allmax(
            (is_g | is_ih | is_gr | is_pr | is_ak).any() | npu.any()
            | (lazyp & (nbrs >= 0)[:, None, :]).any())
        PT_SHAPES = (cap, S * Kn, L)
        tgt_ep, nonmono = state.epoch, state.nonmono
        carried = (data, rr, pruned, lazyp, npu, psrc, tgt_ep, nonmono)
        kinds = (is_g, is_ih, is_gr, is_pr, is_ak)

        def pt_body():
            data, rr, pruned, lazyp, npu, psrc, tgt_ep, nonmono = carried
            is_g, is_ih, is_gr, is_pr, is_ak = kinds
            # epoch guard, gossip fold, flag updates, replies, eager push
            # and lazy flush (the reference's pt_body)
            b64 = b.to(torch.int64)
            # ---- slot-epoch guard -------------------------------------------
            tgt_ep = scatter.reduce_drop(
                state.epoch, torch.where(is_g | is_ih, b64, B), ep_w, "amax")
            bumped = tgt_ep > state.epoch                           # [n, B]
            pre = torch.cat([data, state.rround[:, :, None],
                             state.epoch[:, :, None]], dim=-1)      # [n, B, PW+2]
            pre_b = pre.gather(1, b64[:, :, None].expand(-1, -1, PW + 2))
            data_b = pre_b[..., :PW]
            rr_b = pre_b[..., PW]
            old_ep_b = pre_b[..., PW + 1]
            bump_g = is_g & (ep_w > old_ep_b)
            pruned = pruned & ~bumped[:, :, None]
            lazyp = lazyp & ~bumped[:, :, None]
            rr = torch.where(bumped, 0, rr)
            psrc = torch.where(bumped, -1, psrc)
            ep_b = tgt_ep.gather(1, b64)
            cur_ep = ep_w == ep_b
            is_g, is_ih, is_gr = is_g & cur_ep, is_ih & cur_ep, is_gr & cur_ep
            is_pr, is_ak = is_pr & cur_ep, is_ak & cur_ep

            hit = (nbrs[:, None, :] == src[:, :, None]) & (src >= 0)[:, :, None]
            ks_ok = hit.any(dim=-1)
            ki = torch.argmax(hit.to(torch.int8), dim=-1)

            nonmono = state.nonmono + (bump_g & ~hd.leq(data_b, pay)).sum(
                dim=1).to(torch.int32)

            # ---- gossip merge (handler join fold) ---------------------------
            stale_g = is_g & hd.leq(pay, data_b)
            if isinstance(hd, handlers_mod.MaxJoinHandler):
                base = bottom.expand(n_local, B, PW).clone()
                tgt = torch.where(is_g, b64, B)[:, :, None].expand(-1, -1, PW)
                ext = torch.cat([base, bottom.expand(n_local, 1, PW)], dim=1)
                joined_in = ext.scatter_reduce(1, tgt, pay, "amax",
                                               include_self=True)[:, :B]
            else:
                oh_b = b[:, :, None] == torch.arange(B, device=dev)
                gmask = oh_b & is_g[:, :, None]
                expanded = torch.where(gmask[..., None], pay[:, :, None, :],
                                       bottom)
                joined_in = handlers_mod.tree_fold(hd, expanded, dim=1)
            fresh_any = ~hd.leq(joined_in, data)                    # [n, B]

            joined_b = joined_in.gather(1, b64[:, :, None].expand(-1, -1, PW))
            eq_fold = (pay == joined_b).all(dim=-1)
            win_ns = is_g & ~stale_g
            slot_c = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
            keyp = slot_c + torch.where(eq_fold, 0, cap).to(torch.int32)
            packed = torch.full((n_local, B + 1), 2 * cap, dtype=torch.int32,
                                device=dev).scatter_reduce(
                1, torch.where(win_ns, b64, B), keyp.expand(n_local, cap),
                "amin", include_self=True)[:, :B]
            got = packed < 2 * cap
            chosen_c = torch.clamp(torch.where(packed >= cap, packed - cap,
                                               packed), max=cap - 1)
            chosen = torch.where(got, chosen_c, cap)
            chosen_b = chosen.gather(1, b64)
            win = win_ns & (slot_c == chosen_b)
            win_pay = pay.gather(1, torch.clamp(chosen_b, max=cap - 1)
                                 .to(torch.int64)[:, :, None].expand(-1, -1, PW))
            after_win = hd.join(data_b, torch.where(
                (chosen_b < cap)[:, :, None], win_pay, bottom))
            stale_g = stale_g | (is_g & ~win & hd.leq(pay, after_win))
            ms_win = torch.stack([mr, src], dim=-1).gather(
                1, chosen_c.to(torch.int64)[:, :, None].expand(-1, -1, 2))
            mr_win = torch.where(got, ms_win[..., 0], -1)
            src_win = torch.where(got, ms_win[..., 1], -1)
            data = hd.join(data, joined_in)
            rr = torch.where(fresh_any, mr_win + 1, rr)
            npu = npu | fresh_any
            psrc = torch.where(fresh_any, src_win, psrc)

            # ---- per-(tree, link) flags: packed 10-bit count fields ---------
            missing_ih = is_ih & ~hd.leq(pay, data_b)
            c_pr = is_pr | stale_g
            c_un = is_gr | missing_ih | (is_g & ~stale_g)
            c_ak = is_gr | is_ak
            packed_c = (c_pr.to(torch.int32) + (c_un.to(torch.int32) << 10)
                        + (c_ak.to(torch.int32) << 20))
            rows_c = torch.arange(n_local, device=dev)[:, None]
            flat = (rows_c * B + b64) * (Kn + 1) + torch.where(ks_ok, ki, Kn)
            acc = torch.zeros(n_local * B * (Kn + 1), dtype=torch.int32,
                              device=dev).scatter_add(
                0, flat.reshape(-1), packed_c.reshape(-1)
            ).reshape(n_local, B, Kn + 1)[:, :, :Kn]
            prune_req = (acc & 1023) > 0
            unprune = (acc & (1023 << 10)) != 0
            pruned = (pruned | prune_req) & ~unprune
            lazyp = lazyp & ~((acc >> 20) > 0)

            # ---- per-slot replies (against the round-start store) -----------
            present_b = hd.present(data_b)
            rep_kind = select(
                [stale_g, missing_ih, is_ih & ~missing_ih, is_gr & present_b],
                [int(K.PT_PRUNE), int(K.PT_GRAFT), int(K.PT_IHAVE_ACK),
                 int(K.PT_GOSSIP)], 0)
            rep_pay = torch.where(is_ih[..., None], pay, data_b)
            replies = msg_ops.build(
                cfg, rep_kind, gids[:, None], torch.where(rep_kind > 0, src, -1),
                channel=CH,
                payload=(b, *rep_pay.unbind(dim=-1),
                         torch.where(is_gr, rr_b, 0), ep_b))

            # ---- eager push: up to S carried-over fresh slots ---------------
            arangeB = torch.arange(B, dtype=torch.int32, device=dev)
            pend = npu & hd.present(data)
            prio = torch.where(pend, B - arangeB[None, :], 0)
            pv, sel = rng.topk(prio, S)                              # [n, S]
            sel_ok = pv > 0
            rows = torch.arange(n_local, device=dev)[:, None]
            pruned_sel = pruned[rows, sel]                           # [n, S, K]
            live_k = (nbrs >= 0)[:, None, :]
            post = torch.cat([data, rr[:, :, None], tgt_ep[:, :, None],
                              psrc[:, :, None]], dim=-1)             # [n, B, PW+3]
            post_sel = post[rows, sel]                               # [n, S, PW+3]
            psrc_sel = post_sel[..., PW + 2]
            eager = live_k & ~pruned_sel & (nbrs[:, None, :]
                                            != psrc_sel[:, :, None])
            lazy_sel = pruned_sel
            if cfg.control.fanout:
                # fanout governor: links beyond the round-start budget
                # take the lazy I_HAVE path for this push
                with scope.phase("round.control.fanout"):
                    erank = torch.cumsum(eager, dim=-1) - 1
                    gov_cut = eager & (erank >= ctx.control.fanout.eager_cap)
                    eager = eager & ~gov_cut
                    lazy_sel = pruned_sel | gov_cut
            dst = torch.where(sel_ok[:, :, None] & eager, nbrs[:, None, :], -1)
            data_sel = post_sel[..., :PW]
            sel32 = sel.to(torch.int32)
            push_msgs = msg_ops.build(
                cfg, K.PT_GOSSIP, gids[:, None, None], dst, channel=CH,
                payload=(sel32[:, :, None],
                         *(w[:, :, None] for w in data_sel.unbind(dim=-1)),
                         post_sel[..., PW][:, :, None],
                         post_sel[..., PW + 1][:, :, None]),
            ).map(lambda w: w.reshape(n_local, S * Kn))
            lazy_new = sel_ok[:, :, None] & live_k & lazy_sel         # [n, S, K]
            oh_sel = sel[:, :, None] == arangeB[None, None, :]       # [n, S, B]
            lazyp = lazyp | (oh_sel[:, :, :, None]
                             & lazy_new[:, :, None, :]).any(dim=1)
            pushed_b = (oh_sel & sel_ok[:, :, None]).any(dim=1)
            npu = npu & ~pushed_b

            # ---- lazy tick: flush up to L outstanding i_haves ---------------
            fire = torch.remainder(ctx.rnd + gids, cfg.lazy_tick_every) == 0
            flat_l = (lazyp & (nbrs >= 0)[:, None, :]).reshape(n_local, B * Kn)
            lprio = torch.where(flat_l & fire[:, None], B * Kn - torch.arange(
                B * Kn, dtype=torch.int32, device=dev)[None, :], 0)
            lv, li = rng.topk(lprio, L)
            bi, kix = li // Kn, li % Kn
            adv_pack = post.gather(1, bi[:, :, None].expand(-1, -1, PW + 3))
            bi32 = bi.to(torch.int32)
            ihave_msgs = msg_ops.build(
                cfg, K.PT_IHAVE, gids[:, None],
                torch.where(lv > 0, nbrs.gather(1, kix), -1), channel=CH,
                payload=(bi32, *adv_pack[..., :PW].unbind(dim=-1),
                         torch.zeros_like(bi32), adv_pack[..., PW + 1]))

            return (data, rr, pruned, lazyp, npu, psrc, tgt_ep, nonmono), (
                replies, push_msgs, ihave_msgs)

        def pt_quiet():
            return carried, tuple(msg_ops.zero_stack(cfg, (n_local, k), dev)
                                  for k in PT_SHAPES)

        carried, emitted = gate.cond(pt_go, pt_body, pt_quiet)
        data, rr, pruned, lazyp, npu, psrc, tgt_ep, nonmono = carried

        # ---- AAE exchange tick -------------------------------------------
        if pt.aae and hd.supports_exchange:
            hand_any = (changed & (nbrs >= 0)).any()
            go_local = hand_any
            if pt.exchange_limit > 0:
                fires = (torch.remainder(ctx.rnd + gids,
                                         cfg.exchange_tick_every) == 0) \
                    & ctx.alive
                go_local = go_local | fires.any()
            aae_in = (data, rr, pruned, lazyp, psrc, tgt_ep)

            def aae_body():
                data, rr, pruned, lazyp, psrc, tgt_ep = aae_in

                def hand_pull():
                    tgt = torch.where(changed & (nbrs >= 0)
                                      & ctx.alive[:, None], nbrs, -1)
                    tgt = faults_mod.filter_edges(
                        ctx.faults, gids, tgt, ctx.seed, ctx.rnd,
                        _AAE_EDGE_TAG)
                    return hd.exchange_with_epochs(comm, data, tgt_ep, tgt)

                def no_pull():
                    return (bottom.expand(data.shape).clone(),
                            torch.zeros_like(tgt_ep))

                if pt.exchange_limit == 0:
                    pulled, pulled_ep = hand_pull()
                else:
                    pulled, pulled_ep = gate.cond(comm.allmax(hand_any),
                                                  hand_pull, no_pull)
                if pt.exchange_limit > 0:
                    slots = rng.choice_slots(rng.subkey(ctx.keys, _TAG_AAE),
                                             nbrs >= 0, pt.exchange_limit)
                    t = torch.where(slots >= 0, nbrs.gather(
                        1, torch.remainder(slots, Kn).to(torch.int64)), -1)
                    tick_tgt = torch.where(fires[:, None], t, -1)
                    tick_tgt = faults_mod.filter_edges(
                        ctx.faults, gids, tick_tgt, ctx.seed, ctx.rnd,
                        _AAE_EDGE_TAG)
                    p_t, ep_t = hd.exchange_with_epochs(comm, data, tgt_ep,
                                                        tick_tgt)
                    pulled = hd.join(pulled, p_t)
                    pulled_ep = torch.maximum(pulled_ep, ep_t)
                alive3 = ctx.alive[:, None, None]
                data = hd.join(data, torch.where(alive3, pulled, bottom))
                aae_bump = ctx.alive[:, None] & (pulled_ep > tgt_ep)
                pruned = pruned & ~aae_bump[:, :, None]
                lazyp = lazyp & ~aae_bump[:, :, None]
                rr = torch.where(aae_bump, 0, rr)
                psrc = torch.where(aae_bump, -1, psrc)
                tgt_ep = torch.maximum(
                    tgt_ep, torch.where(ctx.alive[:, None], pulled_ep, 0))
                return data, rr, pruned, lazyp, psrc, tgt_ep

            data, rr, pruned, lazyp, psrc, tgt_ep = gate.cond(
                comm.allmax(go_local), aae_body, lambda: aae_in)

        # crash-stopped nodes are frozen and silent
        dead = ~ctx.alive

        def keep(new, old):
            return torch.where(dead.reshape((-1,) + (1,) * (new.dim() - 1)),
                               old, new)

        emitted = tuple(plane_ops.set_word(
            blk, T.W_KIND, torch.where(dead[:, None], 0, blk[T.W_KIND]))
            for blk in emitted)
        new_state = PlumtreeState(
            data=keep(data, state.data),
            rround=keep(rr, state.rround),
            pruned=keep(pruned, state.pruned),
            lazy_pending=keep(lazyp, state.lazy_pending),
            need_push=keep(npu, state.need_push),
            push_src=keep(psrc, state.push_src),
            tree_nbrs=keep(nbrs, state.tree_nbrs),
            epoch=keep(tgt_ep, state.epoch),
            nonmono=keep(nonmono, state.nonmono),
        )
        return new_state, emitted

    # ---- scenario helpers --------------------------------------------
    def broadcast(self, state: PlumtreeState, node: int, slot: int,
                  version=1, *, fresh: bool = False) -> PlumtreeState:
        """Inject a broadcast at (node, slot)."""
        dev = state.data.device
        vec = self.handler.payload(version, dev)
        merged = self.handler.join(state.data[node, slot], vec)
        data = state.data.clone()
        data[node, slot] = merged
        need = state.need_push.clone()
        need[node, slot] = True
        psrc = state.push_src.clone()
        psrc[node, slot] = -1
        st = state._replace(data=data, need_push=need, push_src=psrc)
        if fresh:
            # on the card, as in the reference: no host read, so a
            # fleet's map_members can broadcast into every member
            dom = self.handler.leq(state.data[node, slot], vec)
            epoch = st.epoch.clone()
            epoch[node, slot] += 1
            pruned = st.pruned.clone()
            pruned[node, slot] = False
            lazyp = st.lazy_pending.clone()
            lazyp[node, slot] = False
            rround = st.rround.clone()
            rround[node, slot] = 0
            nonmono = st.nonmono.clone()
            nonmono[node] += (~dom).to(nonmono.dtype)
            st = st._replace(epoch=epoch, pruned=pruned, lazy_pending=lazyp,
                             rround=rround, nonmono=nonmono)
        return st

    def coverage(self, state: PlumtreeState, alive: torch.Tensor, slot: int,
                 version=1) -> torch.Tensor:
        """Fraction of live nodes whose store dominates the target payload
        for ``slot`` (float32 scalar)."""
        target = self.handler.payload(version, state.data.device)
        have = self.handler.leq(target, state.data[:, slot]) & alive
        return have.sum().to(torch.float32) / torch.clamp(
            alive.sum(), min=1).to(torch.float32)

    def eager_degree(self, state: PlumtreeState, slot: int) -> torch.Tensor:
        """Mean eager out-degree for a tree (float32 scalar): flood = the
        overlay degree, a converged tree ~ the spanning tree's
        (debug_get_tree analogue)."""
        eager = (state.tree_nbrs >= 0) & ~state.pruned[:, slot, :]
        return eager.sum().to(torch.float32) / float(state.data.shape[0])
