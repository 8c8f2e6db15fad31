"""Delivery semantics: the acked lane and the causal lanes (port of
``partisan_tpu/delivery.py``).

- **Acked delivery.**  A message sent with ``F_ACK_REQUIRED`` is stamped
  with the sender's next per-sender clock and stored in the sender's
  ack store; every ``retransmit_every`` rounds the whole store is re-sent
  (flagged ``F_RETRANSMISSION``) until the matching ``ACK`` arrives.
  Receivers ack everything that arrives flagged, so delivery is
  at-least-once.
- **Causal broadcast lanes** (``CausalLane``, one per
  ``Config.causal_labels`` entry): exact vector-clock causal broadcast
  from the bounded actor space (``gid < n_actors``) to every node.  A
  send becomes one wide record (the wire words, then the sender's clock
  as ``n_actors`` int32 planes); each round every actor's records form
  one shared candidate table, and ``CAUSAL_SWEEPS`` dense sweeps decide
  deliverability for every (node, candidate) pair at once.  Out-of-order
  arrivals buffer; a sender-side history ring replays on the retransmit
  cadence and receivers drop covered counters, so app-visible delivery
  is exactly-once in causal order.
- **Point-to-point causal lanes** (``P2PLane``, one per
  ``Config.causal_p2p_labels`` entry): ANY node sends; per-(sender,
  destination) FIFO with exactly-once delivery, kept by per-edge
  sequence numbers and stream epochs in bounded id-keyed bucket tables
  on both ends, go-back-N replay from a bounded unacked store until the
  receiver's cumulative ``P2P_ACK`` covers it, and stream-reset requests
  when a receiver lost its watermark.  Stamped records ride the event
  lane; ``inbound`` pulls them back out of the inbox and re-inserts the
  deliverable ones in stream order.

The reference's ``lax.cond`` gates are host reads here: one per p2p
lane on the send side (``outbound``) and one per p2p lane on the receive
side (``inbound``), each running exactly the reference's branch.

Where the reference materialises the p2p receive sweep's ``[n, SC, C]``
bucket-winner matrices, the port scatters each candidate's key onto its
bucket with ``scatter_reduce("amin")`` (min is order-free, so the result
is the same on every device) and ranks the winners with one ``[n, C,
C]`` comparison; no ``[n, SC, C]`` tensor is built.  The uint32 clocks
are int64 held (``ops/vclock.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import latency as latency_mod
from partisan_tpu_torch import provenance as provenance_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import exchange, rng, vclock, views
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.ops.plane import Planes

CAUSAL_SWEEPS = 3     # in-round delivery passes (chain depth per round)
_CAUSAL_SALT = 21     # fault-filter call-site salt for causal lanes
_P2P_EPOCH_TAG = 330  # rank32 tag base for p2p stream epochs
_P2P_REOPEN_TAG = 340  # rank32 tag base for reset-reopened epochs
_P2P_RESET_SLOTS = 4  # pending stream-reset requests per node per lane
_EPOCH_MASK = (1 << 22) - 1   # 22-bit stream epochs (W_LANE bits 8..29)
_I32 = torch.int32
_INF2 = 2 ** 31 - 1


class AckState(NamedTuple):
    outstanding: Planes            # [n, ack_cap] records — kind 0 = free
    next_clock: torch.Tensor       # int32[n] — next per-sender clock
    overflow: torch.Tensor         # int32 — acked sends dropped: store full


class CausalLane(NamedTuple):
    clock: torch.Tensor     # int64[n, A] (uint32 values) — delivered vclock
    buf: Planes             # [n, B] wide records — out-of-order arrivals
    hist: Planes            # [n, H] wide records — sent-record replay ring
    hist_ptr: torch.Tensor  # int32[n] — ring write position
    overflow: torch.Tensor  # int32 — records dropped: emit/buffer full


class P2PLane(NamedTuple):
    dst_ids: torch.Tensor    # int32[n, DC] — sender table: destination ids
    dst_seq: torch.Tensor    # int32[n, DC] — messages sent to it
    dst_ep: torch.Tensor     # int32[n, DC] — stream epoch
    src_ids: torch.Tensor    # int32[n, SC] — receiver table: sender ids
    src_seq: torch.Tensor    # int32[n, SC] — last delivered seq
    src_ep: torch.Tensor     # int32[n, SC] — stream epoch
    src_acked: torch.Tensor  # int32[n, SC] — highest seq cumulatively acked
    reack: torch.Tensor      # bool[n, SC] — duplicate seen: re-send the ack
    reset_req: torch.Tensor  # int32[n, R] — senders to ask for a reopen
    reset_seq: torch.Tensor  # int32[n, R] — the orphan seq observed
    buf: Planes              # [n, B] records — out-of-order arrivals
    hist: Planes             # [n, H] records — unacked sent records
    overflow: torch.Tensor   # int32 — sends dropped + future-buffer sheds
    resets: torch.Tensor     # int32 — bucket evictions (tracking resets)
    aborted: torch.Tensor    # int32 — unacked records dropped: stream gone


class DeliveryState(NamedTuple):
    ack: Any                       # AckState, or () when ack_cap is 0
    lanes: tuple                   # one CausalLane per causal label
    p2p: tuple                     # one P2PLane per p2p label
    invalid_causal: torch.Tensor   # int32 — F_CAUSAL sends dropped


def enabled(cfg) -> bool:
    return cfg.ack_cap > 0 or bool(cfg.causal_labels) \
        or bool(cfg.causal_p2p_labels)


def needs_inbound(cfg) -> bool:
    return bool(cfg.causal_labels) or bool(cfg.causal_p2p_labels)


def _zero_wide(cfg, shape: tuple, device) -> Planes:
    """All-empty wide causal records: the wire words, then the clock as
    ``n_actors`` int32 planes."""
    return plane_ops.zero_planes(
        tuple(shape), cfg.wire_dtypes + (_I32,) * cfg.n_actors,
        device=device)


def init(cfg, comm) -> DeliveryState:
    n, dev = comm.n_local, comm.device
    zero = torch.zeros((), dtype=_I32, device=dev)

    def full(shape, v, dtype=_I32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    ack = AckState(
        outstanding=msg_ops.zero_wire(cfg, (n, cfg.ack_cap), device=dev),
        next_clock=full((n,), 1),
        overflow=zero) if cfg.ack_cap > 0 else ()
    lanes = tuple(CausalLane(
        clock=vclock.fresh_matrix(n, cfg.n_actors, device=dev),
        buf=_zero_wide(cfg, (n, cfg.causal_buf_cap), dev),
        hist=_zero_wide(cfg, (n, cfg.causal_hist_cap), dev),
        hist_ptr=full((n,), 0),
        overflow=zero) for _ in cfg.causal_labels)
    DC, SC, R = cfg.p2p_dst_cap, cfg.p2p_src_cap, _P2P_RESET_SLOTS
    p2p = tuple(P2PLane(
        dst_ids=full((n, DC), -1), dst_seq=full((n, DC), 0),
        dst_ep=full((n, DC), 0),
        src_ids=full((n, SC), -1), src_seq=full((n, SC), 0),
        src_ep=full((n, SC), 0), src_acked=full((n, SC), 0),
        reack=full((n, SC), False, torch.bool),
        reset_req=full((n, R), -1), reset_seq=full((n, R), 0),
        buf=msg_ops.zero_wire(cfg, (n, cfg.p2p_buf_cap), device=dev),
        hist=msg_ops.zero_wire(cfg, (n, cfg.p2p_hist_cap), device=dev),
        overflow=zero, resets=zero, aborted=zero)
        for _ in cfg.causal_p2p_labels)
    return DeliveryState(ack=ack, lanes=lanes, p2p=p2p, invalid_causal=zero)


def _free_slot_of_rank(free: torch.Tensor) -> torch.Tensor:
    """``out[i, r]`` is the index of row i's r-th free slot (``S`` =
    none).  free: bool[n, S]."""
    n, S = free.shape
    free_rank = torch.cumsum(free, dim=1) - 1
    slots = torch.arange(S, dtype=_I32, device=free.device)
    out = torch.full((n, S + 1), S, dtype=_I32, device=free.device)
    return out.scatter_(1, torch.where(free, free_rank, S),
                        slots.expand(n, S))[:, :S]


def _compact(recs: Planes, mask: torch.Tensor, cap: int):
    """Per row: the records where ``mask`` packed into ``cap`` slots in
    slot order.  Returns (packed [n, cap], records dropped)."""
    n, e = mask.shape
    ar = torch.arange(e, dtype=_I32, device=mask.device)
    idxs = torch.sort(torch.where(mask, ar, e), dim=1)[0]
    if cap <= e:
        pos = idxs[:, :cap]
    else:   # more slots than sources: the tail stays empty
        pos = torch.cat([idxs, idxs.new_full((n, cap - e), e)], dim=1)
    dropped = (mask.sum(dim=1) - cap).clamp(min=0).sum().to(_I32)
    return plane_ops.take_rows(recs, pos, fill=True), dropped


def _flag(x: torch.Tensor, bit: int) -> torch.Tensor:
    return (x & bit) != 0


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.sum().to(_I32)


def _records(like: Planes, on: torch.Tensor, words: dict) -> Planes:
    """Records shaped like ``like``: the given header words where ``on``,
    zero everywhere else."""
    return Planes(
        torch.where(on, words[i], 0).to(w.dtype) if i in words
        else torch.zeros_like(w) for i, w in enumerate(like))


def _born_now(cfg, msgs: Planes, rnd) -> Planes:
    """Control records built mid-round from zeroed wire-width records
    carry their builder as provenance source and this round as birth."""
    msgs = provenance_mod.stamp_fresh(cfg, msgs)
    return latency_mod.stamp_fresh(cfg, msgs, rnd)


def _epoch(seed, rnd, tag, gids, ids) -> torch.Tensor:
    """A fresh nonzero 22-bit stream epoch per (node, destination)."""
    h = rng.rank32(seed, rnd, tag, gids[:, None], ids.clamp(min=0))
    return (h % _EPOCH_MASK + 1).to(_I32)


def _lane_epoch(lane_word: torch.Tensor) -> torch.Tensor:
    return (lane_word >> 8) & _EPOCH_MASK


def _sel(cond, a, b) -> torch.Tensor:
    """``torch.where`` kept at int32 (bool sums promote to int64)."""
    return torch.where(cond, a, b).to(_I32)


# ---------------------------------------------------------------------------
# Outbound
# ---------------------------------------------------------------------------

def outbound(cfg, comm, st: DeliveryState, emitted: Planes, ctx):
    """The send path.  Returns (state', emitted', wides): ack,
    retransmission and p2p records are appended to ``emitted``; causal
    broadcast sends are removed from it and returned as one wide record
    stack per lane."""
    gids = comm.local_ids()
    inb = ctx.inbox.data
    kind_in = inb[T.W_KIND]
    alive = ctx.alive
    refire = ((ctx.rnd + gids) % cfg.retransmit_every == 0) & alive
    extra = []
    ack = st.ack
    if cfg.ack_cap > 0:
        # 1. Ack everything that arrived flagged; duplicates re-ack.
        need = (kind_in != 0) & _flag(inb[T.W_FLAGS], T.F_ACK_REQUIRED) \
            & alive[:, None]
        extra.append(_born_now(cfg, _records(inb, need, {
            T.W_KIND: int(T.MsgKind.ACK), T.W_SRC: gids[:, None],
            T.W_DST: inb[T.W_SRC], T.W_CLOCK: inb[T.W_CLOCK]}), ctx.rnd))

        # 2. Consume arriving ACKs: clear the store slots they match
        #    (clock, and the acker being the stored destination).
        out = ack.outstanding
        hit = ((out[T.W_CLOCK][:, :, None] == inb[T.W_CLOCK][:, None, :])
               & (out[T.W_DST][:, :, None] == inb[T.W_SRC][:, None, :])
               & (kind_in == T.MsgKind.ACK)[:, None, :]
               & (out[T.W_KIND] != 0)[:, :, None]).any(dim=2)
        out = plane_ops.set_word(out, T.W_KIND,
                                 torch.where(hit, 0, out[T.W_KIND]))

        # 3. Stamp and store fresh acked sends: the k-th fresh send of a
        #    row takes the row's k-th free store slot.
        e_kind, e_flags = emitted[T.W_KIND], emitted[T.W_FLAGS]
        fresh = (e_kind != 0) & _flag(e_flags, T.F_ACK_REQUIRED) \
            & ~_flag(e_flags, T.F_RETRANSMISSION) \
            & ~_flag(e_flags, T.F_CAUSAL) & (e_kind != T.MsgKind.ACK)
        rank = torch.cumsum(fresh, dim=1) - 1
        emitted = plane_ops.set_word(emitted, T.W_CLOCK, torch.where(
            fresh, ack.next_clock[:, None] + rank, emitted[T.W_CLOCK]))
        C = cfg.ack_cap
        free = out[T.W_KIND] == 0
        n_free = free.sum(dim=1)
        tgt = torch.gather(_free_slot_of_rank(free), 1,
                           rank.clamp(0, C - 1))
        store = fresh & (rank < n_free[:, None])
        out = plane_ops.scatter_rows(out, torch.where(store, tgt, C),
                                     emitted)
        n_fresh = fresh.sum(dim=1)
        # counters are this shard's: reduced so they stay replicated
        overflow = comm.allsum((n_fresh - n_free).clamp(min=0).sum()
                               .to(_I32))
        next_clock = ack.next_clock + n_fresh.to(_I32)

        # 4. Retransmit tick: re-emit the whole store, flagged.
        re = plane_ops.set_word(out, T.W_FLAGS,
                                out[T.W_FLAGS] | T.F_RETRANSMISSION)
        extra.append(plane_ops.set_word(
            re, T.W_KIND, torch.where(refire[:, None], out[T.W_KIND], 0)))

        # Crashed senders freeze their store.
        ack = AckState(
            outstanding=plane_ops.where(alive[:, None], out,
                                        ack.outstanding),
            next_clock=torch.where(alive, next_clock, ack.next_clock),
            overflow=ack.overflow + overflow)

    # 5. Causal broadcast stamping: pull each lane's sends off the event
    #    lane into wide records carrying the sender's clock.
    lanes_out, wide_out = [], []
    for li, lane in enumerate(st.lanes):
        lane, wide, emitted = _causal_send(cfg, comm, lane, li, emitted,
                                           gids, alive, refire)
        lanes_out.append(lane)
        wide_out.append(wide)

    # 6. Point-to-point lanes, send side: one host read of the lane's
    #    gate, then the reference's branch.
    p2p_out = []
    for pi, lane in enumerate(st.p2p):
        lid = len(cfg.causal_labels) + pi
        is_ack_in = (kind_in == T.MsgKind.P2P_ACK) \
            & ((inb[T.W_LANE] & 0xFF) == lid)
        is_p = _p2p_fresh(emitted, lid, alive)
        go = torch.stack([
            (lane.hist[T.W_KIND] != 0).any(), is_ack_in.any(), is_p.any(),
            (lane.reset_req >= 0).any(), lane.reack.any(),
            ((lane.src_seq > lane.src_acked) & (lane.src_ids >= 0)).any()
        ]).any()
        # the branch holds collectives: the gate reads the whole cluster
        if bool(comm.allmax(go)):
            lane, blocks, emitted = _p2p_send(cfg, comm, ctx, lane, lid, pi,
                                              emitted, is_ack_in, is_p,
                                              gids, refire)
        else:
            n = gids.shape[0]
            blocks = [msg_ops.zero_wire(cfg, (n, k), device=gids.device)
                      for k in (cfg.p2p_emit_cap, cfg.p2p_hist_cap,
                                cfg.p2p_src_cap, _P2P_RESET_SLOTS)]
        p2p_out.append(lane)
        extra += blocks

    # Any send still flagged F_CAUSAL (and not a stamped p2p record) came
    # from a non-actor or names an unconfigured lane: drop and count it.
    invalid = 0
    if st.lanes or st.p2p:
        e_flags = emitted[T.W_FLAGS]
        leak = (emitted[T.W_KIND] != 0) & _flag(e_flags, T.F_CAUSAL) \
            & ~_flag(e_flags, T.F_P2P_STAMPED)
        invalid = comm.allsum(_count(leak))
        emitted = plane_ops.set_word(emitted, T.W_KIND, torch.where(
            leak, 0, emitted[T.W_KIND]))
    if extra:
        emitted = plane_ops.concat([emitted] + extra, dim=1)
    return (DeliveryState(ack=ack, lanes=tuple(lanes_out),
                          p2p=tuple(p2p_out),
                          invalid_causal=st.invalid_causal + invalid),
            emitted, tuple(wide_out))


def _causal_send(cfg, comm, lane: CausalLane, li: int, emitted: Planes,
                 gids, alive, refire):
    """Step 5 for one broadcast lane: (lane', wide records, emitted')."""
    A, EC, H = cfg.n_actors, cfg.causal_emit_cap, cfg.causal_hist_cap
    is_c = (emitted[T.W_KIND] != 0) & _flag(emitted[T.W_FLAGS], T.F_CAUSAL) \
        & (emitted[T.W_LANE] == li) & ((gids < A) & alive)[:, None]
    # The k-th logical message this round carries the clock advanced k
    # times at the sender's entry; emit-cap overflow drops the tail, so
    # the clock advances by the kept prefix only.
    n_sent = is_c.sum(dim=1)
    rank1 = torch.cumsum(is_c, dim=1)
    n_kept = n_sent.clamp(max=EC)
    is_c_all = is_c
    is_c = is_c & (rank1 <= EC)
    me = torch.where(gids < A, gids, 0)
    onehot = (torch.arange(A, device=gids.device)[None, :]
              == me[:, None]).to(vclock.DTYPE)
    msg_clocks = (lane.clock[:, None, :]
                  + onehot[:, None, :] * rank1[:, :, None]) & vclock.MASK32
    new_clock = (lane.clock + onehot * n_kept[:, None]) & vclock.MASK32
    packed, _ = _compact(plane_ops.append_tail(emitted, msg_clocks), is_c,
                         EC)
    dropped = comm.allsum((n_sent - n_kept).sum().to(_I32))

    # Sender-side loss recovery: history ring + cadenced replay.
    valid_p = packed[T.W_KIND] != 0
    k_idx = torch.cumsum(valid_p, dim=1) - 1
    pos = torch.where(valid_p, (lane.hist_ptr[:, None] + k_idx) % H, H)
    hist = plane_ops.scatter_rows(lane.hist, pos, packed)
    hist_ptr = (lane.hist_ptr + valid_p.sum(dim=1, dtype=_I32)) % H
    live_slot = refire[:, None] & (hist[T.W_KIND] != 0)
    replay = plane_ops.set_word(hist, T.W_FLAGS,
                                hist[T.W_FLAGS] | T.F_RETRANSMISSION)
    replay = plane_ops.where(live_slot, replay, 0)
    alive1 = alive[:, None]
    lane = lane._replace(
        clock=torch.where(alive1, new_clock, lane.clock),
        hist=plane_ops.where(alive1, hist, lane.hist),
        hist_ptr=torch.where(alive, hist_ptr, lane.hist_ptr),
        overflow=lane.overflow + dropped)
    # Off the event lane, overflow tail included (dropped and counted).
    emitted = plane_ops.set_word(emitted, T.W_KIND, torch.where(
        is_c_all, 0, emitted[T.W_KIND]))
    return lane, plane_ops.concat([packed, replay], dim=1), emitted


def _p2p_fresh(emitted: Planes, lid: int, alive) -> torch.Tensor:
    """This round's unstamped sends on p2p lane ``lid``."""
    flags = emitted[T.W_FLAGS]
    return (emitted[T.W_KIND] != 0) & _flag(flags, T.F_CAUSAL) \
        & ~_flag(flags, T.F_P2P_STAMPED) & (emitted[T.W_LANE] == lid) \
        & alive[:, None] & (emitted[T.W_DST] >= 0)


def _p2p_send(cfg, comm, ctx, lane: P2PLane, lid: int, pi: int,
              emitted: Planes, is_ack_in, is_p, gids, refire):
    """Step 6 for one p2p lane (the gate's open branch): (lane', [fresh
    sends, replays, acks, reset requests], emitted')."""
    DC, EC, H = cfg.p2p_dst_cap, cfg.p2p_emit_cap, cfg.p2p_hist_cap
    n, dev = gids.shape[0], gids.device
    inb = ctx.inbox.data
    in_src, in_clk = inb[T.W_SRC], inb[T.W_CLOCK]
    alive1 = ctx.alive[:, None]

    # 6a. Consume arriving P2P_ACKs: free unacked records covered by the
    # cumulative (dst, epoch, seq) ack.  A negative ack clock asks for a
    # stream reopen.
    hist = lane.hist
    is_cum = is_ack_in & (in_clk >= 0)
    is_rst = is_ack_in & (in_clk < 0)
    h_dst, h_seq = hist[T.W_DST], hist[T.W_CLOCK]
    same_src = h_dst[:, :, None] == in_src[:, None, :]          # [n, H, I]
    covered = (is_cum[:, None, :] & same_src
               & (_lane_epoch(hist[T.W_LANE])[:, :, None]
                  == _lane_epoch(inb[T.W_LANE])[:, None, :])
               & (h_seq[:, :, None] <= in_clk[:, None, :])).any(dim=2) \
        & (hist[T.W_KIND] != 0)
    hist = plane_ops.set_word(hist, T.W_KIND,
                              torch.where(covered, 0, hist[T.W_KIND]))

    # Stream reopen: a request naming orphan seq k acts only when nothing
    # below k is still unacked here; then every unacked record to that
    # destination is re-stamped seq 1.. in order under a fresh epoch.
    h_valid = hist[T.W_KIND] != 0
    below = (h_valid[:, :, None] & same_src
             & (h_seq[:, :, None] < (-in_clk)[:, None, :])).any(dim=1)
    is_rst = is_rst & ~below
    rec_rst = h_valid & (is_rst[:, None, :] & same_src).any(dim=2)  # [n, H]
    reopen_ep = _epoch(ctx.seed, ctx.rnd, _P2P_REOPEN_TAG + pi, gids, h_dst)
    h_idx = torch.arange(H, device=dev)
    same_d = (h_dst[:, :, None] == h_dst[:, None, :]) \
        & rec_rst[:, :, None] & rec_rst[:, None, :]
    before = same_d & (
        (h_seq[:, None, :] < h_seq[:, :, None])
        | ((h_seq[:, None, :] == h_seq[:, :, None])
           & (h_idx[None, None, :] < h_idx[None, :, None])))
    new_seq_r = (before.sum(dim=2) + 1).to(_I32)
    hist = plane_ops.set_word(hist, T.W_CLOCK,
                              torch.where(rec_rst, new_seq_r, h_seq))
    hist = plane_ops.set_word(hist, T.W_LANE, torch.where(
        rec_rst, lid | (reopen_ep << 8), hist[T.W_LANE]))
    # dst-table reopen: clear every requested entry, then re-point the
    # entries that still have records at (count, fresh epoch).
    tbl_rst = (is_rst[:, None, :]
               & (lane.dst_ids[:, :, None] == in_src[:, None, :])
               ).any(dim=2) & (lane.dst_ids >= 0)
    dst_ids0 = _sel(tbl_rst, -1, lane.dst_ids)
    dst_seq0 = _sel(tbl_rst, 0, lane.dst_seq)
    dst_ep0 = _sel(tbl_rst, 0, lane.dst_ep)
    dc_idx = torch.arange(DC, device=dev)[None, :, None]
    hb = views.bucket_slot(h_dst.clamp(min=0), DC)
    is_last_r = rec_rst & ~(
        same_d & (new_seq_r[:, None, :] > new_seq_r[:, :, None])).any(dim=2)
    hit_r = is_last_r[:, None, :] & (hb[:, None, :] == dc_idx)  # [n, DC, H]
    anyhit_r = hit_r.any(dim=2)
    wslot_r = hit_r.to(torch.int8).argmax(dim=2)
    dst_ids0 = _sel(anyhit_r, h_dst.gather(1, wslot_r), dst_ids0)
    dst_seq0 = _sel(anyhit_r, new_seq_r.gather(1, wslot_r), dst_seq0)
    dst_ep0 = _sel(anyhit_r, reopen_ep.gather(1, wslot_r), dst_ep0)

    # A dead destination ends its streams (a recovered one gets a fresh
    # stream); both liveness reads ride one gather.
    alive_both = ctx.faults.alive[
        torch.cat([dst_ids0, h_dst], dim=1).clamp(min=0).to(torch.int64)]
    tbl_dead = (dst_ids0 >= 0) & ~alive_both[:, :DC]
    dst_ids0 = _sel(tbl_dead, -1, dst_ids0)
    dst_seq0 = _sel(tbl_dead, 0, dst_seq0)
    dst_ep0 = _sel(tbl_dead, 0, dst_ep0)

    # Abort unacked records whose stream the table no longer tracks.
    stream_live = (dst_ids0.gather(1, hb) == h_dst) \
        & (dst_ep0.gather(1, hb) == _lane_epoch(hist[T.W_LANE])) \
        & alive_both[:, DC:]
    aborted = (hist[T.W_KIND] != 0) & ~stream_live
    n_aborted = comm.allsum(_count(aborted))
    hist = plane_ops.set_word(hist, T.W_KIND,
                              torch.where(aborted, 0, hist[T.W_KIND]))

    # Our own pending stream-reset requests (as a receiver).
    rr = lane.reset_req
    rst_on = rr >= 0
    like_r = msg_ops.zero_wire(cfg, rr.shape, device=dev)
    rst_msgs = _records(like_r, rst_on, {
        T.W_KIND: int(T.MsgKind.P2P_ACK), T.W_SRC: gids[:, None],
        T.W_DST: rr, T.W_CLOCK: -lane.reset_seq.clamp(min=1),
        T.W_LANE: lid})
    rst_msgs = _born_now(cfg, rst_msgs, ctx.rnd)

    # 6b. Compact and admit this round's fresh sends against the free
    # store slots (dropped visibly when full).
    packed, cap_dropped = _compact(emitted, is_p, EC)
    emitted = plane_ops.set_word(emitted, T.W_KIND,
                                 torch.where(is_p, 0, emitted[T.W_KIND]))
    free = hist[T.W_KIND] == 0
    n_free = free.sum(dim=1)
    valid0 = packed[T.W_KIND] != 0
    vrank = torch.cumsum(valid0, dim=1) - 1
    kept = valid0 & (vrank < n_free[:, None])
    n_backpressured = comm.allsum(_count(valid0 & ~kept))
    packed = plane_ops.set_word(packed, T.W_KIND,
                                torch.where(kept, packed[T.W_KIND], 0))
    valid = kept

    # 6c. Stamp per-edge seq and stream epoch on the kept sends.
    d = packed[T.W_DST]
    b = views.bucket_slot(d.clamp(min=0), DC)                   # [n, EC]
    tracked = (dst_ids0.gather(1, b) == d) & valid
    cur_seq = _sel(tracked, dst_seq0.gather(1, b), 0)
    cur_ep = _sel(tracked, dst_ep0.gather(1, b), 0)
    ep = _sel(tracked, cur_ep,
              _epoch(ctx.seed, ctx.rnd, _P2P_EPOCH_TAG + pi, gids, d))
    ec_idx = torch.arange(EC, device=dev)
    samem = (d[:, :, None] == d[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    rank = (samem & (ec_idx[None, None, :] < ec_idx[None, :, None])
            ).sum(dim=2)
    seq = (cur_seq + rank + 1).to(_I32)
    packed = plane_ops.set_word(packed, T.W_CLOCK,
                                torch.where(valid, seq, packed[T.W_CLOCK]))
    packed = plane_ops.set_word(packed, T.W_LANE, torch.where(
        valid, lid | (ep << 8), packed[T.W_LANE]))
    packed = plane_ops.set_word(packed, T.W_FLAGS, torch.where(
        valid, packed[T.W_FLAGS] | T.F_P2P_STAMPED, packed[T.W_FLAGS]))
    # Table update: the LAST kept send per destination this round.
    is_last = valid & ~(
        samem & (ec_idx[None, None, :] > ec_idx[None, :, None])).any(dim=2)
    hit = is_last[:, None, :] & (b[:, None, :] == dc_idx)     # [n, DC, EC]
    anyhit = hit.any(dim=2)
    wslot = hit.to(torch.int8).argmax(dim=2)
    new_id = d.gather(1, wslot)
    resets = comm.allsum(_count(anyhit & (dst_ids0 >= 0)
                                & (dst_ids0 != new_id)))
    dst_ids = _sel(anyhit, new_id, dst_ids0)
    dst_seq = _sel(anyhit, seq.gather(1, wslot), dst_seq0)
    dst_ep = _sel(anyhit, ep.gather(1, wslot), dst_ep0)

    # 6d. Store kept sends into free slots; replay the whole unacked
    # store on the retransmit cadence, except the slots just written.
    tgt = _free_slot_of_rank(free).gather(1, vrank.clamp(0, H - 1))
    store_slot = torch.where(kept, tgt, H).to(torch.int64)
    hist = plane_ops.scatter_rows(hist, store_slot, packed)
    just_written = torch.zeros((n, H + 1), dtype=torch.bool, device=dev) \
        .scatter_(1, store_slot, True)[:, :H]
    live_slot = refire[:, None] & (hist[T.W_KIND] != 0) & ~just_written
    replay = plane_ops.set_word(hist, T.W_FLAGS,
                                hist[T.W_FLAGS] | T.F_RETRANSMISSION)
    replay = plane_ops.where(live_slot, replay, 0)

    # 6e. Receiver-side cumulative acks: on the retransmit cadence, or at
    # once when a duplicate signalled a lost ack.
    tracked_src = lane.src_ids >= 0
    ack_now = ((lane.src_seq > lane.src_acked) & tracked_src
               & refire[:, None]) | (lane.reack & tracked_src)
    like_a = msg_ops.zero_wire(cfg, lane.src_ids.shape, device=dev)
    ack_msgs = _records(like_a, ack_now, {
        T.W_KIND: int(T.MsgKind.P2P_ACK), T.W_SRC: gids[:, None],
        T.W_DST: lane.src_ids, T.W_CLOCK: lane.src_seq,
        T.W_LANE: lid | (lane.src_ep << 8)})
    ack_msgs = _born_now(cfg, ack_msgs, ctx.rnd)
    src_acked = torch.where(ack_now, lane.src_seq, lane.src_acked)

    lane = lane._replace(
        dst_ids=torch.where(alive1, dst_ids, lane.dst_ids),
        dst_seq=torch.where(alive1, dst_seq, lane.dst_seq),
        dst_ep=torch.where(alive1, dst_ep, lane.dst_ep),
        src_acked=torch.where(alive1, src_acked, lane.src_acked),
        reack=torch.where(alive1, lane.reack & ~ack_now, lane.reack),
        reset_req=torch.where(alive1, -1, lane.reset_req),
        hist=plane_ops.where(alive1, hist, lane.hist),
        overflow=lane.overflow + comm.allsum(cap_dropped)
        + n_backpressured,
        resets=lane.resets + resets,
        aborted=lane.aborted + n_aborted)
    return lane, [packed, replay, ack_msgs, rst_msgs], emitted


# ---------------------------------------------------------------------------
# Inbound
# ---------------------------------------------------------------------------

def _fetch(buf: Planes, shared: Planes, idx: torch.Tensor) -> Planes:
    """Per-node record fetch over the combined candidate index space:
    ``idx < B`` reads the node's buffer row, ``B <= idx < B + G`` the
    shared table, anything else an empty record.  buf [n, B], shared
    [G], idx [n, D] -> [n, D]."""
    n, B = buf[0].shape
    G = shared[0].shape[0]
    rows = torch.arange(n, device=idx.device)[:, None]
    in_b = idx < B
    in_s = (idx >= B) & (idx < B + G)
    pos_b = torch.where(in_b, idx.clamp(0, B - 1) + rows * B, n * B)
    pos_s = torch.where(in_s, idx - B, G)
    gb = plane_ops.take_flat(buf.map(lambda w: w.reshape(-1)), pos_b,
                             fill=True)
    gs = plane_ops.take_flat(shared, pos_s, fill=True)
    return Planes(x + y for x, y in zip(gb, gs))


def _signed32(x: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 values reinterpreted as int32 values."""
    x = x & vclock.MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def _clock_words(p: Planes, W: int) -> torch.Tensor:
    """The clock planes of wide records as uint32 values, int64 held."""
    return plane_ops.stack_words(p, W).to(vclock.DTYPE) & vclock.MASK32


def inbound(cfg, comm, st: DeliveryState, inbox: exchange.Inbox,
            wides: tuple, ctx):
    """The causal receive path: deliver each lane's deliverable records
    into the model-visible inbox in causal (broadcast) or stream (p2p)
    order, buffering out-of-order futures.  Returns (state', inbox',
    the count of causal deliveries this round, net of p2p arrivals the
    event lane already counted)."""
    n_causal = torch.zeros((), dtype=_I32, device=ctx.alive.device)
    lanes_out = []
    for li, (lane, payload) in enumerate(zip(st.lanes, wides)):
        lane, inbox, k = _causal_recv(cfg, comm, lane, li, payload, inbox,
                                      ctx)
        lanes_out.append(lane)
        n_causal = n_causal + k
    p2p_out = []
    for pi, lane in enumerate(st.p2p):
        lid = len(cfg.causal_labels) + pi
        msgs = inbox.data
        flags = msgs[T.W_FLAGS]
        is_p = (msgs[T.W_KIND] != 0) & _flag(flags, T.F_CAUSAL) \
            & _flag(flags, T.F_P2P_STAMPED) \
            & ((msgs[T.W_LANE] & 0xFF) == lid)
        # one host read: an idle receive side passes everything through
        # the branch holds collectives: the gate reads the whole cluster
        if bool(comm.allmax(is_p.any() | (lane.buf[T.W_KIND] != 0).any())):
            lane, inbox, k = _p2p_recv(cfg, comm, lane, lid, is_p, inbox,
                                       ctx)
            n_causal = n_causal + k
        p2p_out.append(lane)
    return st._replace(lanes=tuple(lanes_out), p2p=tuple(p2p_out)), \
        inbox, n_causal


def _causal_recv(cfg, comm, lane: CausalLane, li: int, payload: Planes,
                 inbox: exchange.Inbox, ctx):
    W, A, B = cfg.wire_words, cfg.n_actors, cfg.causal_buf_cap
    alive = ctx.alive
    n = alive.shape[0]
    dev = alive.device
    gids = comm.local_ids()

    # Shared candidate table: every actor's records this round.
    shared = comm.actor_gather(payload, A).map(lambda w: w.reshape(-1))
    G = shared[0].shape[0]
    s_clk = _clock_words(shared, W)                              # [G, A]
    s_src = shared[T.W_SRC].clamp(0, A - 1).to(torch.int64)
    g_idx = torch.arange(G, device=dev)
    s_cnt = s_clk[g_idx, s_src]
    s_dep = s_clk.clone()
    s_dep[g_idx, s_src] = 0                       # deps without the sender
    s_valid = shared[T.W_KIND] != 0
    # Per-receiver transmission faults on each (src -> node) edge.
    cut = faults_mod.edge_cut(
        ctx.faults, shared[T.W_SRC][None, :].expand(n, G),
        torch.where(s_valid[None, :], gids[:, None], -1),
        ctx.seed, ctx.rnd, _CAUSAL_SALT + li)
    arr_ok = s_valid[None, :] & ~cut & alive[:, None]

    # Buffered candidates (arrived in earlier rounds).
    b_clk = _clock_words(lane.buf, W)                            # [n, B, A]
    b_src = lane.buf[T.W_SRC].clamp(0, A - 1).to(torch.int64)
    b_cnt = b_clk.gather(2, b_src[..., None])[..., 0]
    b_dep = torch.where(torch.arange(A, device=dev)[None, None, :]
                        == b_src[..., None], 0, b_clk)
    b_valid = lane.buf[T.W_KIND] != 0

    clock0 = lane.clock
    INF = B + G + 1
    D = min(B + G, cfg.causal_deliver_cap)
    # The quota is bounded by the inbox space left after the event lane.
    quota = (cfg.inbox_cap - inbox.count).clamp(min=0).clamp(max=D)
    ib_idx = torch.arange(B, device=dev)[None, :]
    is_idx = B + g_idx[None, :]
    s_src_n = s_src[None, :].expand(n, G)

    clock, b_avail, s_avail = clock0, b_valid & alive[:, None], arr_ok
    dels = []
    for _ in range(CAUSAL_SWEEPS):
        loc_b = clock.gather(1, b_src)
        loc_s = clock[:, s_src]                                  # [n, G]
        ok_b = b_avail & (b_cnt == (loc_b + 1) & vclock.MASK32) \
            & (b_dep <= clock[:, None, :]).all(dim=2)
        ok_s = s_avail & (s_cnt[None, :] == (loc_s + 1) & vclock.MASK32) \
            & (s_dep[None] <= clock[:, None, :]).all(dim=2)
        # One winner per (node, sender): lowest combined index (buffered
        # records are older, so they come first).
        ib = torch.where(ok_b, ib_idx, INF)
        is_ = torch.where(ok_s, is_idx, INF)
        win = torch.full((n, A), INF, dtype=torch.int64, device=dev)
        win = win.scatter_reduce(1, b_src, ib, "amin")
        win = win.scatter_reduce(1, s_src_n, is_, "amin")
        # Quota cut: winners beyond the remaining quota stay undelivered
        # (their clocks do not advance); rank winners by index.
        rank = (win[:, None, :] < win[:, :, None]).sum(dim=2)
        deliver = (win < INF) & (rank < quota[:, None])
        del_b = ok_b & (ib == win.gather(1, b_src)) \
            & deliver.gather(1, b_src)
        del_s = ok_s & (is_ == win[:, s_src]) & deliver[:, s_src]
        mb = torch.where(del_b[..., None], b_clk, 0).amax(dim=1)
        ms = torch.where(del_s[..., None], s_clk[None], 0).amax(dim=1)
        clock = torch.maximum(clock, torch.maximum(mb, ms))
        quota = quota - deliver.sum(dim=1, dtype=_I32)
        b_avail, s_avail = b_avail & ~del_b, s_avail & ~del_s
        dels.append((del_b, del_s))
    clock_f = torch.where(alive[:, None], clock, clock0)

    # Delivery order = (sweep, combined index).
    big = 2 ** 30
    key_b = torch.full((n, B), big, dtype=torch.int64, device=dev)
    key_s = torch.full((n, G), big, dtype=torch.int64, device=dev)
    for s_i, (d_b, d_s) in enumerate(dels):
        key_b = torch.minimum(key_b, torch.where(
            d_b, s_i * (B + G) + ib_idx, big))
        key_s = torch.minimum(key_s, torch.where(
            d_s, s_i * (B + G) + is_idx, big))
    keys = torch.cat([key_b, key_s], dim=1)                     # [n, B+G]
    topv, topi = rng.topk(-keys, D)
    recs = _fetch(lane.buf, shared, torch.where(-topv < big, topi, INF))
    n_deliv = (keys < big).sum(dim=1, dtype=_I32)
    inbox = exchange.merge_inboxes(inbox, exchange.Inbox(
        data=Planes(recs[:W]), count=n_deliv.clamp(max=D),
        drops=torch.zeros_like(inbox.drops)))

    # Buffer the undelivered futures, one copy per (sender, counter
    # offset), nearest offsets first; stale ones vanish.
    off_b = _signed32(b_cnt - clock_f.gather(1, b_src))
    off_s = _signed32(s_cnt[None, :] - clock_f[:, s_src])
    fut_b = b_valid & b_avail & (off_b >= 1) & (off_b <= B)
    fut_s = arr_ok & s_avail & (off_s >= 1) & (off_s <= B)
    cell_b = b_src * B + (off_b - 1).clamp(0, B - 1)
    cell_s = s_src_n * B + (off_s - 1).clamp(0, B - 1)
    tab = torch.full((n, A * B), INF, dtype=torch.int64, device=dev)
    tab = tab.scatter_reduce(1, cell_b, torch.where(fut_b, ib_idx, INF),
                             "amin")
    tab = tab.scatter_reduce(1, cell_s, torch.where(fut_s, is_idx, INF),
                             "amin")
    keep_b = fut_b & (ib_idx == tab.gather(1, cell_b))
    keep_s = fut_s & (is_idx == tab.gather(1, cell_s))
    fkeys = torch.cat([torch.where(keep_b, ib_idx, INF),
                       torch.where(keep_s, is_idx, INF)], dim=1)
    ftop, fidx = rng.topk(-fkeys, B)
    new_buf = _fetch(lane.buf, shared, torch.where(-ftop < INF, fidx, INF))
    n_fut = (fkeys < INF).sum(dim=1)
    buf_overflow = comm.allsum((n_fut - B).clamp(min=0).sum().to(_I32))
    lane = lane._replace(
        clock=clock_f,
        buf=plane_ops.where(alive[:, None], new_buf, lane.buf),
        overflow=lane.overflow + buf_overflow)
    return lane, inbox, comm.allsum(n_deliv.sum().to(_I32))


def _p2p_recv(cfg, comm, lane: P2PLane, lid: int, is_p,
              inbox: exchange.Inbox, ctx):
    """The receive side of one p2p lane (the gate's open branch):
    candidates are this round's stamped arrivals plus the buffer; a
    record delivers when its stream is in order (seq == last + 1) or
    opens a new or re-epoched stream at seq 1; covered seqs drop as
    replay duplicates; futures re-buffer."""
    SC, B2, R = cfg.p2p_src_cap, cfg.p2p_buf_cap, _P2P_RESET_SLOTS
    alive = ctx.alive
    dev = alive.device
    msgs = inbox.data
    cmsg = plane_ops.concat([plane_ops.where(is_p, msgs, 0), lane.buf],
                            dim=1)
    n, C = cmsg[T.W_KIND].shape
    if C > 2048:
        # the keys below pack (sweep, clamped seq, slot) into int32
        raise ValueError(f"p2p causal lanes need inbox_cap + p2p_buf_cap "
                         f"<= 2048 (got {C})")
    cvalid = cmsg[T.W_KIND] != 0
    csrc, cseq = cmsg[T.W_SRC], cmsg[T.W_CLOCK]
    cep = _lane_epoch(cmsg[T.W_LANE])
    sb = views.bucket_slot(csrc.clamp(min=0), SC).to(torch.int64)  # [n, C]
    c_idx = torch.arange(C, device=dev)
    # Sort keys clamp the seq so they stay below the sentinel; within one
    # sender only one record is in-order-eligible at a time.  Keys are
    # distinct per row (the slot index is their low part).
    ckey = (cseq.clamp(max=1 << 18) * C + c_idx).to(_I32)

    # The quota: inbox space left after the event lane, before any table
    # advance (a winner beyond it stays buffered, stream intact).
    base = exchange.Inbox(
        data=plane_ops.where(is_p, 0, msgs),
        count=((msgs[T.W_KIND] != 0) & ~is_p).sum(dim=1, dtype=_I32),
        drops=inbox.drops)
    D2 = min(C, cfg.causal_deliver_cap)
    quota = (cfg.inbox_cap - base.count).clamp(min=0).clamp(max=D2)

    def per_bucket(key):
        """min of ``key`` over each bucket's candidates: int32[n, SC]."""
        out = torch.full((n, SC), _INF2, dtype=_I32, device=dev)
        return out.scatter_reduce(1, sb, key, "amin")

    s_ids, s_seq, s_ep = lane.src_ids, lane.src_seq, lane.src_ep
    avail, reack = cvalid & alive[:, None], lane.reack
    dels = []
    for _ in range(CAUSAL_SWEEPS):
        t_id, t_seq = s_ids.gather(1, sb), s_seq.gather(1, sb)
        tracked = (t_id == csrc) & cvalid
        same_ep = tracked & (s_ep.gather(1, sb) == cep)
        dup = same_ep & (cseq <= t_seq) & avail
        inorder = same_ep & (cseq == t_seq + 1)
        # A stream opens only at seq 1: an untracked mid-sequence arrival
        # buffers and triggers a reset request below.
        newstream = cvalid & ~same_ep & (cseq == 1)
        elig = avail & (inorder | newstream) & ~dup
        # One winner per sender bucket: the lowest key.
        key = torch.where(elig, ckey, _INF2)
        win = elig & (key == per_bucket(key).gather(1, sb))
        # Quota cut: rank winners by key, keep the first `quota`.
        wkey = torch.where(win, key, _INF2)
        wrank = (wkey[:, None, :] < wkey[:, :, None]).sum(dim=2)
        deliver = win & (wrank < quota[:, None])
        # Tables advance only for buckets whose winner delivered: each
        # delivering record writes its bucket (one per bucket).
        slot = torch.where(deliver, sb, SC)

        def put(old, v, slot=slot):
            pad = torch.cat([old, old[:, :1]], dim=1)
            return pad.scatter(1, slot, v.to(old.dtype))[:, :SC]

        dup_hit = torch.zeros((n, SC + 1), dtype=torch.int8, device=dev) \
            .scatter_reduce(1, torch.where(dup, sb, SC), dup.to(torch.int8),
                            "amax")[:, :SC] > 0
        reack = reack | (dup_hit & (s_ids >= 0))
        s_ids, s_seq, s_ep = put(s_ids, csrc), put(s_seq, cseq), \
            put(s_ep, cep)
        quota = quota - deliver.sum(dim=1, dtype=_I32)
        avail = avail & ~deliver & ~dup
        dels.append(deliver)
    resets = comm.allsum(_count((lane.src_ids >= 0)
                                & (s_ids != lane.src_ids)))

    # Delivery order = (sweep, key); the epoch bits leave W_LANE.
    okey = torch.full((n, C), _INF2, dtype=_I32, device=dev)
    for s_i, d in enumerate(dels):
        okey = torch.minimum(okey, torch.where(
            d, s_i * (C * ((1 << 18) + 1)) + ckey, _INF2))
    topv, topi = rng.topk(-okey, D2)
    drecs = plane_ops.take_rows(cmsg, torch.where(-topv < _INF2, topi, C),
                                fill=True)
    drecs = plane_ops.set_word(drecs, T.W_LANE, torch.where(
        drecs[T.W_KIND] != 0, lid, drecs[T.W_LANE]))
    n_deliv = (okey < _INF2).sum(dim=1, dtype=_I32)
    # The event lane already counted the routed arrivals: this lane's net
    # contribution is its deliveries minus the arrivals it pulled out.
    n_causal = comm.allsum((n_deliv.sum() - is_p.sum()).to(_I32))
    inbox = exchange.merge_inboxes(base, exchange.Inbox(
        data=drecs, count=n_deliv.clamp(max=D2),
        drops=torch.zeros_like(inbox.drops)))

    # Futures re-buffer by key order; overflow sheds (the sender's
    # unacked store recovers them).
    fkey = torch.where(avail & cvalid, ckey, _INF2)
    ftop, fidx = rng.topk(-fkey, B2)
    new_buf = plane_ops.take_rows(cmsg, torch.where(-ftop < _INF2, fidx, C),
                                  fill=True)
    n_fut = (fkey < _INF2).sum(dim=1)
    shed = comm.allsum((n_fut - B2).clamp(min=0).sum().to(_I32))

    # Stream-reset requests: pending candidates whose stream we cannot
    # place (untracked or re-epoched, mid-sequence), first per sender.
    orphan = avail & cvalid & (cseq > 1) & (
        (s_ids.gather(1, sb) != csrc) | (s_ep.gather(1, sb) != cep))
    earlier = (csrc[:, :, None] == csrc[:, None, :]) \
        & orphan[:, :, None] & orphan[:, None, :] \
        & (c_idx[None, None, :] < c_idx[None, :, None])
    orphan = orphan & ~earlier.any(dim=2)
    rst_pack, _ = _compact(Planes((csrc + 1, cseq)), orphan, R)

    alive1 = alive[:, None]
    # A reassigned bucket's ack watermark belongs to the old stream.
    src_acked = torch.where(s_ids != lane.src_ids, 0, lane.src_acked)
    lane = lane._replace(
        src_ids=torch.where(alive1, s_ids, lane.src_ids),
        src_seq=torch.where(alive1, s_seq, lane.src_seq),
        src_ep=torch.where(alive1, s_ep, lane.src_ep),
        src_acked=torch.where(alive1, src_acked, lane.src_acked),
        reack=torch.where(alive1, reack, lane.reack),
        reset_req=torch.where(alive1, rst_pack[0] - 1, lane.reset_req),
        reset_seq=torch.where(alive1, rst_pack[1], lane.reset_seq),
        buf=plane_ops.where(alive1, new_buf, lane.buf),
        overflow=lane.overflow + shed,
        resets=lane.resets + resets)
    return lane, inbox, n_causal


def overflow_total(st) -> torch.Tensor | int:
    """Every cumulative drop counter of the delivery plane summed: ack
    store overflow, causal emit/buffer overflow, p2p overflow and aborted
    records, invalid causal sends (0 when delivery is off)."""
    if st == ():
        return 0
    total = st.invalid_causal
    if st.ack != ():
        total = total + st.ack.overflow
    for lane in st.lanes:
        total = total + lane.overflow
    for lane in st.p2p:
        total = total + lane.overflow + lane.aborted
    return total
