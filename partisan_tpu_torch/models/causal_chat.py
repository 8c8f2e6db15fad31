"""Causal broadcast workload (port of
``partisan_tpu/models/causal_chat.py``).

Each sender emits causally-ordered broadcasts — one logical record,
fanned to every node by the delivery layer's causal broadcast lane — and
receivers log delivery order (``sender * 1000 + seq``); the logs must
respect happened-before.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.models.p2p_chat import log_deliveries, log_lists
from partisan_tpu_torch.ops import msg as msg_ops


class ChatState(NamedTuple):
    log: torch.Tensor      # int32[n, LOG] — delivered tokens in order
    log_len: torch.Tensor  # int32[n]
    seq: torch.Tensor      # int32[n] — next send sequence number
    send_at: torch.Tensor  # int32[n, SLOTS] — scripted rounds (-1 empty)


class CausalChat:
    """Scripted causal broadcasts + delivery-order logging."""

    name = "causal_chat"

    def __init__(self, log_cap: int = 32, slots: int = 8) -> None:
        self.LOG = log_cap
        self.SLOTS = slots

    def init(self, cfg, comm) -> ChatState:
        n, dev = comm.n_local, comm.device

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.int32, device=dev)

        return ChatState(log=full((n, self.LOG), 0), log_len=full((n,), 0),
                         seq=full((n,), 1),
                         send_at=full((n, self.SLOTS), -1))

    def step(self, cfg, comm, state: ChatState, ctx, nbrs):
        gids = comm.local_ids()
        # the delivery layer already enforced causal order
        log, log_len = log_deliveries(ctx.inbox.data, state.log,
                                      state.log_len, 1000)
        # ONE causal record per logical broadcast
        fire = (state.send_at == ctx.rnd).any(dim=1) & ctx.alive
        dst = torch.where(fire, gids, -1)
        emitted = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None], dst[:, None],
            flags=T.F_CAUSAL, payload=(state.seq[:, None],))
        seq = state.seq + fire.to(torch.int32)
        return state._replace(log=log, log_len=log_len, seq=seq), emitted

    # ---- scenario helpers --------------------------------------------
    def schedule(self, state: ChatState, node: int, rnd: int) -> ChatState:
        row = state.send_at[node].cpu()
        free = int((row < 0).to(torch.int8).argmax())
        if row[free] >= 0:
            raise ValueError(f"no free send slot on node {node}")
        send_at = state.send_at.clone()
        send_at[node, free] = rnd
        return state._replace(send_at=send_at)

    @staticmethod
    def logs(state: ChatState) -> list[list[int]]:
        return log_lists(state)
