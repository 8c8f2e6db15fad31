"""Demers direct-mail broadcast and its acked variant (port of
``partisan_tpu/models/direct_mail.py``).

A node with pending broadcast slots mails its lowest pending slot to
every neighbor once, as APP messages (flagged ``F_ACK_REQUIRED`` in the
acked variant, so the delivery layer stores, acks and retransmits
them).  Received mails set bits of a seen-bitmap; there is no repair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops

OP_MAIL = 2   # APP payload[0] opcode


class DirectMailState(NamedTuple):
    store: torch.Tensor    # bool[n, max_broadcasts] — received slots
    pending: torch.Tensor  # bool[n, max_broadcasts] — queued to mail


class DirectMail:
    name = "demers_direct_mail"

    def __init__(self, acked: bool = False) -> None:
        self.acked = acked
        if acked:
            self.name = "demers_direct_mail_acked"

    def init(self, cfg, comm) -> DirectMailState:
        z = torch.zeros((comm.n_local, cfg.max_broadcasts), dtype=torch.bool,
                        device=comm.device)
        return DirectMailState(store=z, pending=z.clone())

    def step(self, cfg, comm, state: DirectMailState, ctx, nbrs):
        gids = comm.local_ids()
        B = cfg.max_broadcasts
        n = state.store.shape[0]

        # Receive: APP/OP_MAIL messages set store bits (retransmitted
        # duplicates are idempotent).  Slot indices wrap once when
        # negative; out-of-range ones land in a dropped pad column.
        inb = ctx.inbox.data
        is_mail = (inb[T.W_KIND] == T.MsgKind.APP) & (inb[T.P0] == OP_MAIL)
        slots = torch.where(is_mail, inb[T.P1], 0).to(torch.int64)
        slots = torch.where(slots < 0, slots + B, slots)
        idx = torch.where(is_mail & (slots >= 0) & (slots < B), slots, B)
        hits = torch.zeros((n, B + 1), dtype=torch.int32,
                           device=gids.device).scatter_add_(
            1, idx, torch.ones_like(idx, dtype=torch.int32))[:, :B]
        alive = ctx.alive[:, None]
        store = torch.where(alive, state.store | ((hits > 0) & alive),
                            state.store)

        # Send: mail the lowest pending slot to every neighbor.
        has = state.pending & alive
        slot = has.to(torch.int8).argmax(dim=1).to(torch.int32)
        any_p = has.any(dim=1)
        dst = torch.where(any_p[:, None], nbrs, -1)
        emitted = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None], dst,
            flags=T.F_ACK_REQUIRED if self.acked else 0,
            payload=(OP_MAIL, slot[:, None]))
        sent = (torch.arange(B, device=gids.device)[None, :]
                == slot[:, None]) & any_p[:, None]
        return DirectMailState(store=store,
                               pending=state.pending & ~sent), emitted

    # ---- scenario helpers --------------------------------------------
    def broadcast(self, state: DirectMailState, node: int,
                  slot: int) -> DirectMailState:
        store, pending = state.store.clone(), state.pending.clone()
        store[node, slot] = True
        pending[node, slot] = True
        return DirectMailState(store=store, pending=pending)

    def coverage(self, state: DirectMailState, alive: torch.Tensor,
                 slot: int) -> torch.Tensor:
        have = state.store[:, slot] & alive
        return have.sum().to(torch.float32) / \
            alive.sum().clamp(min=1).to(torch.float32)
