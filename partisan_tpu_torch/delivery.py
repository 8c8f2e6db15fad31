"""Delivery semantics: the acked-delivery lane (port of the ack lane of
``partisan_tpu/delivery.py``).

A message sent with ``F_ACK_REQUIRED`` is stamped with the sender's
next per-sender clock and stored in the sender's ack store; every
``retransmit_every`` rounds the whole store is re-sent (flagged
``F_RETRANSMISSION``) until the matching ``ACK`` arrives.  Receivers ack
everything that arrives flagged, duplicates included, so delivery is
at-least-once.

The causal broadcast and point-to-point lanes are not ported
(``Config`` refuses ``causal_labels`` and ``causal_p2p_labels``), so
``DeliveryState.lanes`` and ``.p2p`` are always ``()``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops


class AckState(NamedTuple):
    outstanding: plane_ops.Planes  # [n, ack_cap] records — kind 0 = free
    next_clock: torch.Tensor       # int32[n] — next per-sender clock
    overflow: torch.Tensor         # int32 — acked sends dropped: store full


class DeliveryState(NamedTuple):
    ack: Any                       # AckState, or () when ack_cap is 0
    lanes: tuple                   # causal broadcast lanes: not ported
    p2p: tuple                     # point-to-point causal lanes: not ported
    invalid_causal: torch.Tensor   # int32 — F_CAUSAL sends dropped


def enabled(cfg) -> bool:
    return cfg.ack_cap > 0 or bool(cfg.causal_labels) \
        or bool(cfg.causal_p2p_labels)


def needs_inbound(cfg) -> bool:
    return bool(cfg.causal_labels) or bool(cfg.causal_p2p_labels)


def init(cfg, comm) -> DeliveryState:
    n, dev = comm.n_local, comm.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ack = AckState(
        outstanding=msg_ops.zero_wire(cfg, (n, cfg.ack_cap), device=dev),
        next_clock=torch.ones(n, dtype=torch.int32, device=dev),
        overflow=zero) if cfg.ack_cap > 0 else ()
    return DeliveryState(ack=ack, lanes=(), p2p=(), invalid_causal=zero)


def _free_slot_of_rank(free: torch.Tensor) -> torch.Tensor:
    """``out[i, r]`` is the index of row i's r-th free slot (``S`` =
    none).  free: bool[n, S]."""
    n, S = free.shape
    free_rank = torch.cumsum(free, dim=1) - 1
    slots = torch.arange(S, dtype=torch.int32, device=free.device)
    out = torch.full((n, S + 1), S, dtype=torch.int32, device=free.device)
    return out.scatter_(1, torch.where(free, free_rank, S),
                        slots.expand(n, S))[:, :S]


def _flag(x: torch.Tensor, bit: int) -> torch.Tensor:
    return (x & bit) != 0


def outbound(cfg, comm, st: DeliveryState, emitted: plane_ops.Planes, ctx):
    """The send path: returns (state', emitted') with this round's acks
    and retransmissions appended to ``emitted``."""
    gids = comm.local_ids()
    inb = ctx.inbox.data
    kind_in = inb[T.W_KIND]
    extra = []
    ack = st.ack
    if cfg.ack_cap > 0:
        alive = ctx.alive
        # 1. Ack everything that arrived flagged; duplicates re-ack.
        need = (kind_in != 0) & _flag(inb[T.W_FLAGS], T.F_ACK_REQUIRED) \
            & alive[:, None]
        ack_words = {T.W_KIND: int(T.MsgKind.ACK), T.W_SRC: gids[:, None],
                     T.W_DST: inb[T.W_SRC], T.W_CLOCK: inb[T.W_CLOCK]}
        extra.append(plane_ops.Planes(
            torch.where(need, ack_words[i], 0).to(w.dtype)
            if i in ack_words else torch.zeros_like(w)
            for i, w in enumerate(inb)))

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
        overflow = (n_fresh - n_free).clamp(min=0).sum().to(torch.int32)
        next_clock = ack.next_clock + n_fresh.to(torch.int32)

        # 4. Retransmit tick: re-emit the whole store, flagged.
        refire = ((ctx.rnd + gids) % cfg.retransmit_every == 0) & alive
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
    if extra:
        emitted = plane_ops.concat([emitted] + extra, dim=1)
    return st._replace(ack=ack), emitted


def overflow_total(st) -> torch.Tensor | int:
    """Every cumulative drop counter of the delivery plane summed (0 when
    delivery is off)."""
    if st == ():
        return 0
    total = st.invalid_causal
    if st.ack != ():
        total = total + st.ack.overflow
    return total
